"""The port's ``flash_attention_plain`` against the reference's Pallas
``flash_attention`` (interpret mode) and its oracle ``attention_ref``, on
the sweeps of ``tests/test_kernels.py``.  The CUDA kernel itself is held
against this plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402

_J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"fp32": torch.float32, "bf16": torch.bfloat16}
_TOL = {"fp32": 2e-5, "bf16": 3e-2}           # tests/test_kernels.py


def _inputs(seed, B, H, K, S, dh, dt):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh))]
    return ([jnp.asarray(a, _J[dt]) for a in arrs],
            [torch.as_tensor(a).to(_T[dt]) for a in arrs])


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(jnp.asarray(want, jnp.float32))).max())


@pytest.mark.parametrize("B,H,K,S,dh,causal,win,dt", [
    (1, 4, 2, 256, 64, True, 0, "fp32"),
    (2, 4, 1, 256, 128, True, 0, "bf16"),     # MQA (granite/rg)
    (1, 8, 8, 128, 64, False, 0, "fp32"),     # encoder (hubert)
    (1, 4, 2, 512, 64, True, 128, "fp32"),    # local window (rg)
    (1, 16, 16, 128, 80, False, 0, "bf16"),   # MHA, non-pow2 dh
])
def test_flash_plain_vs_pallas(B, H, K, S, dh, causal, win, dt):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, B, H, K, S, dh, dt)
    want = j_flash(jq, jk, jv, causal=causal, window=win, interpret=True)
    got = fak.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert got.dtype == _T[dt] and got.shape == (B, H, S, dh)
    assert _err(got, want) < _TOL[dt]


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128),
                                   (256, 256)])
def test_flash_plain_vs_pallas_block_shapes(bq, bk):
    """The reference kernel's block-shape sweep: every Pallas block shape
    agrees with the plain version run over query blocks of ``bq``."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 1, 2, 2, 256, 64, "fp32")
    want = j_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                   interpret=True)
    got = fak.flash_attention_plain(tq, tk, tv, causal=True, block_q=bq)
    assert _err(got, want) < 2e-5


@pytest.mark.parametrize("dt,causal,win", [("fp32", True, 0),
                                           ("bf16", True, 0),
                                           ("fp32", True, 48),
                                           ("fp32", False, 0)])
def test_flash_plain_partial_tile_vs_ref(dt, causal, win):
    """S = 192 is no multiple of the Pallas kernel's 128-row block (it
    asserts); the port takes it (the CUDA kernel masks the last tile)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 4, 2, 192, 64, dt)
    want = attention_ref(jq, jk, jv, causal=causal, window=win)
    got = fak.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert _err(got, want) < _TOL[dt]


def test_row_scaled_error_flags_a_stale_tile():
    """The row-scaled bf16 check: the plain version is within
    ``BF16_ROW_TOL`` of the reference's oracle, while an output whose last
    query tile read one K/V tile stale (the previous tile's rows) is far
    outside it."""
    S, t0 = 1024, 448
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, 1, 4, 2, S, 64, "bf16")
    want = fak.flash_attention(tq, tk, tv, causal=True)
    ref = torch.as_tensor(np.array(jnp.asarray(
        attention_ref(jq, jk, jv, causal=True), jnp.float32)))
    assert fak.row_scaled_error(want, ref) < fak.BF16_ROW_TOL
    sk, sv = tk.clone(), tv.clone()
    sk[:, :, t0:t0 + 64] = tk[:, :, t0 - 64:t0]
    sv[:, :, t0:t0 + 64] = tv[:, :, t0 - 64:t0]
    stale = want.clone()
    stale[:, :, S - 64:] = fak.flash_attention(tq, sk, sv)[:, :, S - 64:]
    assert fak.row_scaled_error(stale, want) > 4 * fak.BF16_ROW_TOL


def test_flash_wrapper_checks():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError):
        fak.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                            torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError):
        fak.flash_attention(q, q.double(), q.double())
    # since the backward kernel landed the wrapper is an autograd
    # Function: on the CPU the gradient flows through the plain backward
    qg = torch.randn((1, 4, 8, 16), requires_grad=True)
    kg = torch.randn((1, 2, 8, 16), requires_grad=True)
    out = fak.flash_attention(qg, kg, kg.detach())
    out.square().sum().backward()
    assert qg.grad is not None and kg.grad is not None
    assert float(qg.grad.abs().sum()) > 0 and float(kg.grad.abs().sum()) > 0


@pytest.mark.parametrize("dt,dh,variant", [
    (torch.bfloat16, 128, "wgmma"),     # qwen2.5-32b: the main path
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"),      # hubert-xlarge: dh 128's layout
    (torch.bfloat16, 16, "mma_sync"),
    (torch.bfloat16, 112, "mma_sync"),
    (torch.bfloat16, 144, "mma_sync"),  # Q in shared memory from here
    (torch.bfloat16, 192, "wgmma"),     # nemotron-4-340b: 64-key tiles
    (torch.bfloat16, 256, "wgmma"),     # recurrentgemma-9b
    (torch.bfloat16, 240, "mma_sync"),
    (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"),
    (torch.float32, 192, "fma"),
    (torch.float32, 256, "fma"),
])
def test_flash_variant_by_dtype_and_head_dim(dt, dh, variant):
    """The wrapper picks the kernel by dtype and head_dim alone."""
    assert fak.flash_variant(dt, dh) == variant


@pytest.mark.parametrize("dt,dh,err", [
    (torch.bfloat16, 72, ValueError),
    (torch.bfloat16, 272, ValueError),  # past 256
    (torch.bfloat16, 200, ValueError),  # not a multiple of 16
    (torch.float32, 272, ValueError),
    (torch.bfloat16, 0, ValueError),
    (torch.float16, 64, TypeError),
])
def test_flash_variant_refuses(dt, dh, err):
    with pytest.raises(err):
        fak.flash_variant(dt, dh)
