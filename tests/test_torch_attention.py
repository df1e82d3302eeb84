"""The port's ``flash_attention`` (ops/cuda_kernels.py) and the attention
dispatch (ops/attention.py) against the JAX package: on the CPU the wrapper
runs its plain version, held against the Pallas ``flash_attention`` in
interpret mode (blocks of 64, so N = 300 and N = 100 exercise the padded
tail) and against ``_xla_attention``.  The kernel itself runs only on the
card (``tests/test_torch_kernels.py``, marker ``gpu``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.ops.attention import _xla_attention
from generative_turbulence_tpu.ops.pallas_kernels import flash_attention as j_flash_attention
from generative_turbulence_tpu_torch.ops import attention as tattention
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck

F32_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_kernels.py:29
BF16_TOL = dict(rtol=0.06, atol=0.03)  # tests/test_pallas_kernels.py:132, plus corr > 0.999


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [64, 256, 300])
def test_plain_matches_jax_flash_f32(n):
    q, k, v = _qkv((2, 2, n, 32), seed=n)
    want = np.asarray(j_flash_attention(q, k, v, block_q=64, block_k=64))
    got = ck.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (2, 2, n, 32)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_padded_tokens_do_not_leak():
    """n = 100 with blocks of 64: the JAX kernel pads to 128 with a -1e9
    key-bias channel; the port's result must match it and the exact XLA
    attention."""
    q, k, v = _qkv((1, 1, 100, 16), seed=1)
    got = ck.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, np.asarray(j_flash_attention(q, k, v, block_q=64, block_k=64)), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(_xla_attention(q, k, v)), **F32_TOL)


def test_plain_matches_jax_flash_bf16():
    """bf16 inputs: output in bf16.  The JAX kernel scales q in bf16 before
    its f32 matmuls; the plain version scales the f32 scores: bf16
    tolerance."""
    q, k, v = _qkv((2, 2, 300, 32), seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash_attention(jq, jk, jv, block_q=64, block_k=64).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ck.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("n", [tattention.FLASH_MIN_TOKENS - 1, tattention.FLASH_MIN_TOKENS])
def test_multihead_attention_dispatch_on_cpu(n, monkeypatch):
    """From FLASH_MIN_TOKENS tokens up, multihead_attention goes through
    flash_attention, which on a CPU tensor runs its plain version and
    launches nothing; below it, the einsum path.  Both match the JAX
    package's XLA attention, which is what it runs off the TPU."""
    q, k, v = _qkv((1, 2, n, 16), seed=3)
    calls = []
    real = ck._flash_attention_plain

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(ck, "_flash_attention_plain", spy)
    ck.reset_launch_counts()
    got = tattention.multihead_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert calls == ([(1, 2, n, 16)] if n >= tattention.FLASH_MIN_TOKENS else [])
    assert ck.LAUNCH_COUNTS["flash_attention"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(_xla_attention(q, k, v)), **F32_TOL)


def test_flash_attention_takes_strided_views():
    """The U-Net passes ``qkv[:, :, i].transpose(1, 2)`` views; the plain
    version reads them as they are."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 70, 3, 2, 8)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    got = ck.flash_attention(q, k, v)
    want = _xla_attention(*(np.ascontiguousarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_flash_attention_gradients_match_jax(strided):
    """flash_attention is differentiable: on the CPU its gradients are
    autograd of the plain version, bit-equal to differentiating
    ``_flash_attention_plain`` itself, and at the f32 tolerance of
    ``jax.vjp`` of the JAX package's ``_xla_attention`` (its path off the
    TPU).  ``strided`` differentiates through the U-Net's qkv views."""
    import jax

    rng = np.random.default_rng(11)
    B, H, N, D = 2, 2, 130, 16
    qkv = rng.normal(size=(B, N, 3, H, D)).astype(np.float32)
    cot = rng.normal(size=(B, H, N, D)).astype(np.float32)

    def grads(fn):
        if strided:
            leaf = torch.tensor(qkv, requires_grad=True)
            q, k, v = (leaf[:, :, i].transpose(1, 2) for i in range(3))
            leaves = [leaf]
        else:
            leaves = [torch.tensor(np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3)), requires_grad=True)
                      for i in range(3)]
            q, k, v = leaves
        out = fn(q, k, v)
        assert out.grad_fn is not None
        out.backward(torch.from_numpy(cot))
        return [t.grad for t in leaves]

    got = grads(ck.flash_attention)
    assert all(torch.equal(g, w) for g, w in zip(got, grads(ck._flash_attention_plain)))
    jq, jk, jv = (np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    _, vjp = jax.vjp(_xla_attention, jq, jk, jv)
    want = [np.asarray(g) for g in vjp(cot)]
    if strided:
        want = [np.stack([w.transpose(0, 2, 1, 3) for w in want], axis=2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)


def test_multihead_attention_at_flash_size_keeps_the_graph():
    """From FLASH_MIN_TOKENS tokens up, multihead_attention's output has a
    grad_fn when its inputs require grad, and none under no_grad."""
    n = tattention.FLASH_MIN_TOKENS
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv((1, 1, n, 8), seed=4))
    out = tattention.multihead_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))
    with torch.no_grad():
        assert tattention.multihead_attention(q, k, v).grad_fn is None
