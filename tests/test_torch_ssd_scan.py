"""The port's ``ssd_scan_plain`` and ``ssd_chunked`` against the
reference's Pallas ``ssd_scan`` (interpret mode), its oracle
``ssd_scan_ref`` and the reference layer's ``ssd_chunked``, on the sweep
of ``tests/test_kernels.py``.  The CUDA kernel itself is held against the
plain version on the card (``test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro.layers import ssd as jssd  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssk  # noqa: E402
from repro_torch.layers import ssd as tssd  # noqa: E402


def _inputs(seed, Bz, H, S, P, N):
    """The sweep's scales: xdt ~ 0.1 N(0,1), loga = -0.1 |N(0,1)|,
    B/C ~ 0.3 N(0,1)."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((Bz, H, S, P)).astype(np.float32) * 0.1
    loga = -np.abs(rng.standard_normal((Bz, H, S))).astype(np.float32) * 0.1
    B = rng.standard_normal((Bz, S, N)).astype(np.float32) * 0.3
    C = rng.standard_normal((Bz, S, N)).astype(np.float32) * 0.3
    return (xdt, loga, B, C)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()) / \
        (float(np.abs(want).max()) + 1e-9)


@pytest.mark.parametrize("Bz,H,S,P,N", [
    (2, 2, 256, 64, 32),
    (1, 4, 128, 32, 64),
    (2, 1, 512, 64, 128),     # full mamba2-370m state width
])
def test_ssd_plain_vs_pallas(Bz, H, S, P, N):
    arrs = _inputs(3, Bz, H, S, P, N)
    want = j_ssd(*map(jnp.asarray, arrs), interpret=True)
    got = ssk.ssd_scan(*map(torch.as_tensor, arrs))
    assert got.dtype == torch.float32 and got.shape == (Bz, H, S, P)
    assert _rel(got, want) < 1e-4
    # the CUDA kernel's chunk (64): the same function up to rounding
    got64 = ssk.ssd_scan_plain(*map(torch.as_tensor, arrs), chunk=64)
    assert _rel(got64, want) < 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_ssd_plain_partial_chunk_vs_ref(dt):
    """S = 192 is legal in the layer (chunk 64) but not in the Pallas
    kernel (chunk 128); the port pads the last chunk.  bf16 inputs give an
    fp32 output equal to the fp32 scan of the rounded inputs."""
    arrs = _inputs(4, 2, 3, 192, 64, 128)
    tin = [torch.as_tensor(a).to(dt) for a in arrs]
    rounded = [t.float().numpy() for t in tin]
    want = ssd_scan_ref(*map(jnp.asarray, rounded), chunk=64)
    got = ssk.ssd_scan(*tin)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-4


def test_ssd_chunked_vs_reference_layer():
    """The port's ``ssd_chunked`` (the layer's CPU path) against the
    reference's: outputs and the final state, from a nonzero state."""
    rng = np.random.default_rng(5)
    Bsz, nc, Q, H, P, N = 2, 3, 8, 4, 16, 16
    xdt = rng.standard_normal((Bsz, nc, Q, H, P)).astype(np.float32) * 0.1
    loga = -np.abs(rng.standard_normal((Bsz, nc, Q, H))).astype(
        np.float32) * 0.1
    Bc = rng.standard_normal((Bsz, nc, Q, N)).astype(np.float32) * 0.3
    Cc = rng.standard_normal((Bsz, nc, Q, N)).astype(np.float32) * 0.3
    h0 = rng.standard_normal((Bsz, H, P, N)).astype(np.float32) * 0.1
    jy, jh = jssd.ssd_chunked(None, *map(jnp.asarray,
                                         (xdt, loga, Bc, Cc, h0)))
    ty, th = tssd.ssd_chunked(None, *map(torch.as_tensor,
                                         (xdt, loga, Bc, Cc, h0)))
    assert _rel(ty, jy) < 1e-5
    assert _rel(th, jh) < 1e-5


def test_ssd_chunked_large_decay_is_finite():
    """Strong decay makes cums[i] - cums[j] large and positive above the
    diagonal; exp is taken only below it, so nothing overflows to NaN."""
    arrs = list(_inputs(6, 1, 2, 128, 16, 16))
    arrs[1] = arrs[1] * 2000.0            # loga down to about -600
    got = ssk.ssd_scan_plain(*map(torch.as_tensor, arrs))
    assert bool(torch.isfinite(got).all())
    want = ssd_scan_ref(*map(jnp.asarray, arrs))
    assert _rel(got, want) < 1e-4


def test_ssd_wrapper_checks():
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        ssk.ssd_scan(x, torch.zeros((1, 2, 7)), torch.zeros((1, 8, 4)),
                     torch.zeros((1, 8, 4)))
    with pytest.raises(RuntimeError, match="forward-only"):
        ssk.ssd_scan(x.requires_grad_(), torch.zeros((1, 2, 8)),
                     torch.zeros((1, 8, 4)), torch.zeros((1, 8, 4)))


def _pallas_padded(arrs, S):
    """The Pallas kernel (chunk 128, S a multiple of it) on the inputs
    zero-padded to the next multiple of 128, cut back to S: zero steps
    after S cannot change the causal outputs before it."""
    pad = -S % 128
    xdt, loga, B, C = arrs
    xdt = np.pad(xdt, ((0, 0), (0, 0), (0, pad), (0, 0)))
    loga = np.pad(loga, ((0, 0), (0, 0), (0, pad)))
    B = np.pad(B, ((0, 0), (0, pad), (0, 0)))
    C = np.pad(C, ((0, 0), (0, pad), (0, 0)))
    out = j_ssd(*map(jnp.asarray, (xdt, loga, B, C)), interpret=True)
    return np.asarray(out)[:, :, :S]


@pytest.mark.parametrize("Bz,H,S,P,N,decay", [
    (1, 2, 1024, 64, 128, None),     # 16 chunks of the kernel's 64
    (2, 3, 200, 64, 128, None),      # a partial last chunk; H not 8k
    (1, 2, 64, 32, 64, None),        # one chunk
    (1, 2, 512, 64, 128, -5.0),      # strong decay: exp(cums) underflows
])
def test_ssd_phases_vs_pallas(Bz, H, S, P, N, decay):
    """The plain version, which runs the kernel's phases (chunk-local
    states, the state pass, the outputs) at its chunk of 64, against the
    Pallas kernel in interpret mode at 1e-4 relative."""
    arrs = list(_inputs(7, Bz, H, S, P, N))
    if decay is not None:
        arrs[1] = np.full_like(arrs[1], decay)
    got = ssk.ssd_scan_plain(*map(torch.as_tensor, arrs))
    assert got.shape == (Bz, H, S, P) and bool(torch.isfinite(got).all())
    assert _rel(got, _pallas_padded(arrs, S)) < 1e-4


def test_ssd_phases_state_matches_sequential_recurrence():
    """``ssd_phases``' final state equals the step-by-step recurrence
    h_t = exp(loga_t) h_{t-1} + xdt_t^T B_t, from a nonzero h0, over a
    partial last chunk."""
    Bz, H, S, P, N = 1, 2, 150, 8, 16
    xdt, loga, B, C = map(torch.as_tensor, _inputs(8, Bz, H, S, P, N))
    h0 = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (Bz, H, P, N)).astype(np.float32) * 0.1)
    y, h = ssk.ssd_phases(xdt, loga, B, C, h0=h0)
    ref = h0.double()
    ys = []
    for t in range(S):
        ref = ref * torch.exp(loga[:, :, t].double())[..., None, None] + \
            xdt[:, :, t, :, None].double() * B[:, None, t, None, :].double()
        ys.append(torch.einsum("bhpn,bn->bhp", ref, C[:, t].double()))
    want_y = torch.stack(ys, dim=2)
    assert float((h.double() - ref).abs().max()) < 1e-5
    assert float((y.double() - want_y).abs().max()) < 1e-5
