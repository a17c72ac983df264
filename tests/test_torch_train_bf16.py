"""Port parity: the CenterPoint-VoxelNet training step in the flagship's
bf16 numerics (efg_tpu_torch vs efg_tpu): the bfloat16 case of
`tests/test_torch_train.py::test_train_steps_match_jax`, in a file of its
own so that the two cases, each a few minutes under the parallel test run,
go to different workers. The run and the checks are that file's."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_train import _check_train_steps, _jax_run


@pytest.fixture(scope="module", params=["bfloat16"])
def jax_run(request):
    return _jax_run(request.param)


def test_train_steps_match_jax(jax_run, monkeypatch):
    _check_train_steps(jax_run, monkeypatch)
