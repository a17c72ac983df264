"""Pretrained-backbone import: torchvision-style ResNet-50 → flax ResNet.

Builds a torch ResNet-50 oracle with EXACT torchvision naming (torchvision
itself isn't installed), randomly initialised incl. running stats, and
asserts per-stage feature parity after `import_torchvision_resnet`.
Capability twin of the reference's d2/C2 weight conversion
(`efg/utils/d2_model_loading.py:11`, `checkpoint.py:58-157`).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
from torch import nn as tnn

from efg_tpu.modeling.backbones.resnet import ResNet
from efg_tpu.utils.torch_import import import_torchvision_resnet

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)


class _Bottleneck(tnn.Module):
    def __init__(self, cin, mid, cout, stride):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(mid)
        self.conv2 = tnn.Conv2d(mid, mid, 3, stride=stride, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(mid)
        self.conv3 = tnn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(cout)
        self.relu = tnn.ReLU(inplace=True)
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                tnn.BatchNorm2d(cout),
            )
        else:
            self.downsample = None

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + idt)


class _TorchResNet50(tnn.Module):
    """Stage naming identical to torchvision.models.resnet50."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU(inplace=True)
        self.maxpool = tnn.MaxPool2d(3, stride=2, padding=1)
        cfg = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2), (512, 2048, 3, 2)]
        cin = 64
        for i, (mid, cout, n, stride) in enumerate(cfg):
            blocks = []
            for b in range(n):
                blocks.append(_Bottleneck(cin, mid, cout, stride if b == 0 else 1))
                cin = cout
            setattr(self, f"layer{i + 1}", tnn.Sequential(*blocks))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = {}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            outs[f"res{i + 1}"] = x
        return outs


def test_resnet50_import_feature_parity():
    torch.manual_seed(0)
    tm = _TorchResNet50()
    # randomize running stats so BN conversion is actually exercised
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.normal_(1.0, 0.2)
                mod.bias.normal_(0, 0.2)
    tm.eval()

    rs = np.random.RandomState(1)
    x = rs.randn(1, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        want = {k: v.numpy() for k, v in tm(torch.from_numpy(x)).items()}

    model = ResNet(depth=50, norm="FrozenBN", out_features=("res2", "res3", "res4", "res5"))
    variables = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), False)

    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    new_vars, n_assigned, skipped = import_torchvision_resnet(sd, dict(variables))
    # every non-num_batches_tracked tensor must land
    expect = sum(1 for k in sd if "num_batches_tracked" not in k)
    assert n_assigned == expect, (n_assigned, expect, skipped[:10])

    got = model.apply(
        {k: new_vars[k] for k in ("params", "batch_stats")},
        jnp.asarray(x.transpose(0, 2, 3, 1)), False,
    )
    for name in ("res2", "res3", "res4", "res5"):
        g = np.asarray(got[name]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=1e-3)
