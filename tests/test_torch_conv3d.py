"""The port's standalone ``conv3d_3x3`` (ops/cuda_kernels.py) against the
JAX package's Pallas ``conv3d_3x3`` in interpret mode: values for f32 and
bf16 inputs, and the gradients for x, w and b against ``jax.grad``.  On the
CPU the op runs its plain version through the same autograd Function whose
forward is the kernel on the card (``tests/test_torch_kernels.py``)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.ops.pallas_kernels import conv3d_3x3 as j_conv3d_3x3
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck

REPO_ROOT = Path(__file__).resolve().parent.parent
# f32 inputs: both round x and w to bf16 and accumulate the exact products in
# f32, in another order (measured max abs difference 2.9e-6 at outputs up
# to 9.5).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs: the f32 sums round to bf16 at the end, where an order
# difference can flip one bf16 step (tests/test_pallas_kernels.py:132).
BF16_TOL = dict(rtol=0.06, atol=0.03)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_pallas_kernels.py:80


def _inputs(batch, shape, cin, cout, seed=0):
    """The scales of tests/test_pallas_kernels.py::TestPallasConv3d."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cin,cout", [((5, 7, 6), 4, 8), ((6, 10, 13), 12, 16)])
def test_matches_jax_pallas_conv(shape, cin, cout, dtype):
    x, w, b = _inputs(2, shape, cin, cout)
    want = j_conv3d_3x3(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b))
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ck.conv3d_3x3(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype and got.shape == (2, *shape, cout)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_jax(weighted):
    """Backward: the plain conv's gradients, as the JAX custom_vjp takes the
    XLA conv's (tests/test_pallas_kernels.py:62-80); ``weighted`` uses a
    random upstream gradient instead of a plain sum."""
    x, w, _ = _inputs(1, (4, 5, 6), 3, 4, seed=1)
    b = np.zeros(4, np.float32)
    g = np.random.default_rng(2).normal(size=(1, 4, 5, 6, 4)).astype(np.float32) if weighted else None

    def j_loss(x_, w_, b_):
        out = j_conv3d_3x3(x_, w_, b_)
        return (out * g).sum() if weighted else out.sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = ck.conv3d_3x3(*leaves)
    loss = (out * torch.from_numpy(g)).sum() if weighted else out.sum()
    loss.backward()
    for name, leaf, ref in zip("xwb", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


def test_cpu_path_launches_no_kernel():
    ck.reset_launch_counts()
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, (3, 4, 5), 8, 8))
    ck.conv3d_3x3(x, w, b)
    assert ck.LAUNCH_COUNTS["conv3d_3x3"] == 0


def test_no_model_graph_dispatch():
    """As in the JAX package (tests/test_pallas_kernels.py:82-93), the
    standalone conv op is no model path: nothing in the port's models or
    training calls it."""
    pkg = REPO_ROOT / "generative_turbulence_tpu_torch"
    users = [
        f"{path.relative_to(REPO_ROOT)}:{i}"
        for sub in ("models", "training")
        for path in sorted((pkg / sub).rglob("*.py"))
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if "conv3d_3x3" in line
    ]
    assert users == [], f"unexpected model-graph use: {users}"
