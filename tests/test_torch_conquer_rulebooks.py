"""Port parity: the integer structures of ConQueR's sparse trunk.

The port's SparseResNet-18 runs the tiny ConQueR cloud of
tests/test_torch_conquer.py (stage caps above occupancy); every rulebook it
builds, SubM and strided (the stem, res2-res4 and the three (3,1,1) out
convs), is held bit for bit against efg_tpu's packed-rulebook builders on
the same sparse tensor, and every strided conv's output sites against
efg_tpu's `spconv_downsample` on its input. The builders rank their
queries with `merge_rank_flags`, here its contract in jnp (searchsorted
count, membership flags): the Pallas rank kernel in interpret mode costs
7-8 s a shape, and it is held bit for bit against that contract by
tests/test_torch_sparse_kernels.py and tests/test_torch_rank_block.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops import sparse as JS
from efg_tpu.ops.pallas import sparse_kernels as PK
from efg_tpu_torch.models import voxel_detr as TVD
from efg_tpu_torch.ops.cuda import sparse_kernels as K

from test_torch_conquer import KW, _cloud

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)



def _rank_contract(keys, queries, **_):
    """efg_tpu's `merge_rank_flags` contract: count(keys < q)·8 +
    (q−1 ∈ keys)·4 + (q ∈ keys)·2 + (q+1 ∈ keys), padding (≥ INVALID_Q) at
    CLAMP_Q."""
    kc = jnp.minimum(keys, PK._CLAMP_Q)
    qc = jnp.where(queries >= PK.INVALID_Q, PK._CLAMP_Q, queries).astype(jnp.int32)
    pos = jax.vmap(lambda q: jnp.searchsorted(kc, q, side="left"))(qc).astype(jnp.int32)
    vk = kc.shape[0]

    def at(i):
        return kc[jnp.clip(i, 0, vk - 1)]

    fm = (pos > 0) & (at(pos - 1) == qc - 1)
    f0 = (pos < vk) & (at(pos) == qc)
    ip = pos + f0.astype(jnp.int32)
    fp = (ip < vk) & (at(ip) == qc + 1)
    return pos * 8 + fm * 4 + f0 * 2 + fp.astype(jnp.int32)


@pytest.fixture(autouse=True)
def _ranked_by_contract(monkeypatch):
    monkeypatch.setattr(PK, "merge_rank_flags", _rank_contract)


_rule9 = jax.jit(PK.build_monotone_rule9, static_argnums=1)


def _jax_tensor(st):
    return JS.SparseTensor(jnp.asarray(st.features.float().numpy()), jnp.asarray(st.coords.numpy()),
                           jnp.asarray(st.keys.numpy()), jnp.asarray(st.valid.numpy()),
                           st.spatial_shape, st.batch_size)


@pytest.fixture(scope="module")
def trunk_calls():
    """Every rulebook build of one trunk forward: ("subm", st, packed) and
    ("strided", st, (ob, oz, oy, ox, out_valid, ks, stride, pad), packed)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    calls = []
    rule9, strided = K.build_monotone_rule9, K.build_monotone_rule_strided

    def cap9(st, kernel_size=3):
        out = rule9(st, kernel_size)
        calls.append(("subm", st, (kernel_size,), out))
        return out

    def cap_strided(st, *args):
        out = strided(st, *args)
        calls.append(("strided", st, args, out))
        return out

    model = TVD.VoxelDETR(**KW, device="cpu").eval()
    pts, mask = _cloud(0)
    K.build_monotone_rule9, K.build_monotone_rule_strided = cap9, cap_strided
    try:
        with torch.no_grad():
            model.encode(torch.from_numpy(pts), torch.from_numpy(mask))
    finally:
        K.build_monotone_rule9, K.build_monotone_rule_strided = rule9, strided
        torch.set_num_threads(n)
    return calls


def test_rulebook_calls(trunk_calls):
    """11 rulebooks: the stem's strided conv and SubM set, each res stage's
    strided conv and SubM set, and the three out convs."""
    kinds = [c[0] for c in trunk_calls]
    assert kinds == ["strided", "subm"] * 4 + ["strided"] * 3
    assert [c[3].shape[0] for c in trunk_calls] == [9] * 11  # (3,1,1): 3 pairs in groups of 3
    # every stage's capacity above its occupancy: nothing is truncated
    assert all(bool(c[1].valid.sum() < c[1].valid.numel()) for c in trunk_calls), \
        [(int(c[1].valid.sum()), c[1].valid.numel()) for c in trunk_calls]


@pytest.mark.parametrize("i", range(11))
def test_rulebook_matches_pallas(trunk_calls, i):
    kind, st, args, got = trunk_calls[i]
    st_j = _jax_tensor(st)
    if kind == "subm":
        want = _rule9(st_j, *args)
    else:
        ob, oz, oy, ox, ov, ks, stride, pad = args
        # the sites do not depend on the features: narrow them to 16 channels
        narrow = st_j.replace_features(jnp.zeros((st_j.capacity, 16), jnp.float32))
        out = jax.jit(lambda t: JS.spconv_downsample(
            t, jnp.zeros((int(np.prod(ks)), 16, 16)), kernel_size=ks, stride=stride,
            padding=pad, max_out=ov.shape[0], backend="xla"))(narrow)
        np.testing.assert_array_equal(torch.stack([ob, oz, oy, ox], -1).numpy(),
                                      np.asarray(out.coords))
        np.testing.assert_array_equal(ov.numpy(), np.asarray(out.valid))
        want = jax.jit(lambda t, *a: PK.build_monotone_rule_strided(t, *a, ks, stride, pad))(
            st_j, *(jnp.asarray(a.numpy()) for a in args[:5]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() & 7).any()
