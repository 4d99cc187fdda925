"""The port's ``ssd_scan_plain`` and ``ssd_phases`` against the
reference's Pallas ``ssd_scan`` (interpret mode), its oracle
``ssd_scan_ref`` and the reference layer's ``ssd_chunked``, on the sweep
of ``tests/test_kernels.py``; the plain backward ``ssd_scan_bwd_plain``
against ``jax.vjp`` of the reference's ``ssd_chunked``, and the ``SSDScan``
Function's gradient against autograd through ``ssd_phases``.  The CUDA
kernels themselves are held against the plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro.layers import ssd as jssd  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssk  # noqa: E402


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
    """The port's chunked scan (``ssd_phases``, the layer's CPU path, fed
    through the reference layer's [B, nc, Q, H, P] layout) against the
    reference's ``ssd_chunked``: outputs and the final state, from a
    nonzero state."""
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
    S = nc * Q
    ty, th = ssk.ssd_phases(
        torch.as_tensor(xdt).permute(0, 3, 1, 2, 4).reshape(Bsz, H, S, P),
        torch.as_tensor(loga).permute(0, 3, 1, 2).reshape(Bsz, H, S),
        torch.as_tensor(Bc).reshape(Bsz, S, N),
        torch.as_tensor(Cc).reshape(Bsz, S, N), chunk=Q,
        h0=torch.as_tensor(h0))
    ty = ty.reshape(Bsz, H, nc, Q, P).permute(0, 2, 3, 1, 4)
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
    """Shapes that do not fit raise; the backward takes fp32 only, so a
    bf16 input that requires grad is refused (on the CPU too, so the card
    and the CPU refuse alike) while the same input without grad scans."""
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        ssk.ssd_scan(x, torch.zeros((1, 2, 7)), torch.zeros((1, 8, 4)),
                     torch.zeros((1, 8, 4)))
    bc = torch.zeros((1, 8, 4))
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        ssk.ssd_scan(xb.clone().requires_grad_(), torch.zeros((1, 2, 8)),
                     bc, bc)
    assert ssk.ssd_scan(xb, torch.zeros((1, 2, 8)).to(torch.bfloat16),
                        bc.to(torch.bfloat16),
                        bc.to(torch.bfloat16)).dtype == torch.float32
    y = ssk.ssd_scan(x.requires_grad_(), torch.zeros((1, 2, 8)), bc, bc)
    assert y.requires_grad and y.dtype == torch.float32


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


@pytest.mark.parametrize("S,chunk", [(150, 64), (150, 8), (64, 64)])
def test_ssd_phases_h_in_matches_sequential_recurrence(S, chunk):
    """The h_in that ``ssd_phases`` returns (the state entering each chunk,
    what the forward kernel stores for the backward) equals the step-by-
    step recurrence's state before each chunk's first step, a partial last
    chunk included; chunk 0's is zero."""
    Bz, H, P, N = 1, 2, 8, 16
    xdt, loga, B, C = map(torch.as_tensor, _inputs(10, Bz, H, S, P, N))
    y, h, h_in = ssk.ssd_phases(xdt, loga, B, C, chunk=chunk,
                                with_h_in=True)
    nc = -(-S // chunk)
    assert h_in.dtype == torch.float32 and h_in.shape == (Bz, H, nc, P, N)
    assert torch.equal(y, ssk.ssd_phases(xdt, loga, B, C, chunk=chunk)[0])
    ref = torch.zeros((Bz, H, P, N), dtype=torch.float64)
    for t in range(S):
        if t % chunk == 0:
            assert float((h_in[:, :, t // chunk].double() - ref).abs().max()) \
                < 1e-5, t
        ref = ref * torch.exp(loga[:, :, t].double())[..., None, None] + \
            xdt[:, :, t, :, None].double() * B[:, None, t, None, :].double()
    assert not h_in[:, :, 0].any()
    assert float((h.double() - ref).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------
def _bwd_inputs(seed, Bz, H, S, P, N, decay):
    arrs = list(_inputs(seed, Bz, H, S, P, N))
    if decay is not None:
        arrs[1] = np.full_like(arrs[1], decay)
    dy = np.random.default_rng(seed + 100).standard_normal(
        (Bz, H, S, P)).astype(np.float32)
    return arrs, dy


@pytest.mark.parametrize("S,chunk,ref_chunk", [
    (64, 64, 16),        # one kernel chunk; the reference at 4 chunks
    (64, 16, 16),
    (200, 64, 8),        # a partial last chunk (200 = 3 x 64 + 8)
    (200, 8, 8),
])
@pytest.mark.parametrize("decay", [None, -5.0])
def test_ssd_bwd_plain_vs_reference_vjp(S, chunk, ref_chunk, decay):
    """dxdt, dloga, dB and dC of ``ssd_scan_bwd_plain`` (the backward
    kernel's phases, no autograd) against ``jax.vjp`` of the reference's
    ``ssd_chunked`` through ``ssd_scan_ref``'s layout, within 1e-4 of each
    output's max |ref|: Bz 2, H 3, P 16, N 16, random or strong decay."""
    Bz, H, P, N = 2, 3, 16, 16
    arrs, dy = _bwd_inputs(20, Bz, H, S, P, N, decay)
    y, vjp = jax.vjp(lambda *a: ssd_scan_ref(*a, chunk=ref_chunk),
                     *map(jnp.asarray, arrs))
    want = vjp(jnp.asarray(dy))
    got = ssk.ssd_scan_bwd_plain(*map(torch.as_tensor, arrs),
                                 torch.as_tensor(dy), chunk=chunk)
    for name, g, w in zip(("dxdt", "dloga", "dB", "dC"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < 1e-4, (name, _rel(g, w))


@pytest.mark.parametrize("S,chunk,ref_chunk", [
    (200, 64, 8),        # a partial last chunk
    (200, 8, 8),
    (128, 64, 16),
])
@pytest.mark.parametrize("decay", [None, -5.0])
def test_ssd_bwd_plain_with_h_in_handed_over(S, chunk, ref_chunk, decay):
    """``ssd_scan_bwd_plain`` with the forward's h_in handed over (the h_in
    ``ssd_phases`` returns) equals its recomputing form bit for bit, and
    ``jax.vjp`` of the reference's ``ssd_chunked`` within 1e-4 of each
    gradient's max, at a partial chunk and under strong decay."""
    Bz, H, P, N = 2, 3, 16, 16
    arrs, dy = _bwd_inputs(25, Bz, H, S, P, N, decay)
    ins = list(map(torch.as_tensor, arrs))
    dy_t = torch.as_tensor(dy)
    h_in = ssk.ssd_phases(*ins, chunk=chunk, with_h_in=True)[2]
    got = ssk.ssd_scan_bwd_plain(*ins, dy_t, chunk=chunk, h_in=h_in)
    again = ssk.ssd_scan_bwd_plain(*ins, dy_t, chunk=chunk)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    _, vjp = jax.vjp(lambda *a: ssd_scan_ref(*a, chunk=ref_chunk),
                     *map(jnp.asarray, arrs))
    for name, g, w in zip(("dxdt", "dloga", "dB", "dC"), got,
                          vjp(jnp.asarray(dy))):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < 1e-4, (name, _rel(g, w))
    # the wrapper takes the same h_in on CPU tensors, and refuses one of
    # another chunk's shape
    wrapped = ssk.ssd_scan_bwd(*ins, dy_t, chunk=chunk, h_in=h_in)
    assert all(torch.equal(g, w) for g, w in zip(got, wrapped))
    with pytest.raises(ValueError, match="h_in"):
        ssk.ssd_scan_bwd(*ins, dy_t, chunk=chunk, h_in=h_in[:, :, :1])


def test_ssd_scan_keeps_h_in_only_when_a_gradient_is_wanted(monkeypatch):
    """``SSDScan`` asks the forward for h_in, and saves it beside the
    inputs, only when an input needs a gradient: under ``torch.no_grad()``
    (a leaf that requires grad included) and for inputs that need none,
    no state is built and nothing is saved; the same y either way."""
    asked = []
    real = ssk.ssd_phases

    def spy(*a, **kw):
        asked.append(kw.get("with_h_in", False))
        return real(*a, **kw)
    monkeypatch.setattr(ssk, "ssd_phases", spy)
    Bz, H, S, P, N = 1, 2, 40, 8, 16
    ins = list(map(torch.as_tensor, _inputs(11, Bz, H, S, P, N)))
    y0 = ssk.ssd_scan(*ins, chunk=16)
    assert asked == [False] and y0.grad_fn is None
    leaf = ins[0].clone().requires_grad_()
    with torch.no_grad():
        y1 = ssk.ssd_scan(leaf, *ins[1:], chunk=16)
    assert asked == [False, False] and y1.grad_fn is None
    y2 = ssk.ssd_scan(leaf, *ins[1:], chunk=16)
    assert asked == [False, False, True]
    saved = y2.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[-1].shape == (Bz, H, 3, P, N)
    assert torch.equal(y0, y1) and torch.equal(y0, y2.detach())


def test_mamba2_layer_under_checkpoint_matches_without():
    """A Mamba-2 layer (mamba2-370m's smoke widths, fp32) under
    ``torch.utils.checkpoint`` (non-reentrant, as the unit remat runs it)
    gives the gradients it gives without: the first forward's saved h_in
    is dropped and the recomputed forward's is the one the backward
    reads.  Within 1e-6 of each gradient's max."""
    import dataclasses

    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_smoke_config
    from repro_torch.layers.ssd import mamba2_forward
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import _unbind
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    p = _unbind(params["units"], cfg.full_units)[0]["l0"]["ssd"]
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn((2, 64, cfg.d_model), generator=g)
    w = torch.randn((2, 64, cfg.d_model), generator=g)
    grads = []
    for remat in (False, True):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in p.items()}
        x = x0.clone().requires_grad_()

        def layer(x, leaves):
            return mamba2_forward(cfg, leaves, x)
        out = checkpoint(layer, x, leaves, use_reentrant=False) if remat \
            else layer(x, leaves)
        (out * w).sum().backward()
        grads.append([x.grad] + [leaves[k].grad for k in sorted(leaves)])
    for a, b in zip(*grads):
        assert a is not None and b is not None
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("S,chunk", [(64, 8), (200, 64), (37, 8)])
def test_ssd_scan_function_grad_vs_autograd(S, chunk):
    """The Function's CPU gradient (``ssd_scan_bwd_plain`` at the caller's
    chunk) against torch.autograd through ``ssd_phases``, within 1e-5 of
    each gradient's max; the forward equals ``ssd_phases``' y exactly."""
    Bz, H, P, N = 2, 3, 16, 16
    arrs, dy = _bwd_inputs(21, Bz, H, S, P, N, None)
    dy = torch.as_tensor(dy)
    ins = [torch.as_tensor(a).requires_grad_() for a in arrs]
    want_y = ssk.ssd_phases(*ins, chunk=chunk)[0]
    want = torch.autograd.grad(want_y, ins, dy)
    ins = [t.detach().clone().requires_grad_() for t in ins]
    y = ssk.ssd_scan(*ins, chunk=chunk)
    assert torch.equal(y, want_y.detach())
    got = torch.autograd.grad(y, ins, dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_ssd_bwd_plain_strong_decay_is_finite():
    """A decay strong enough to underflow exp(cums) to 0 within a chunk
    (loga about -600 a step): the backward takes exp only below the
    diagonal, so every gradient stays finite, and it matches autograd
    through ``ssd_phases`` (the same fp32 algorithm, whose ``where`` keeps
    exp's argument at 0 above the diagonal) within 1e-4 of each max.
    ``jax.vjp`` of the reference's ``ssd_chunked`` is NaN here: its
    ``where`` takes exp's gradient above the diagonal, where exp overflows
    (ROADMAP C21)."""
    arrs, dy = _bwd_inputs(22, 1, 2, 128, 16, 16, None)
    arrs[1] = arrs[1] * 2000.0
    dy = torch.as_tensor(dy)
    got = ssk.ssd_scan_bwd_plain(*map(torch.as_tensor, arrs), dy, chunk=64)
    ins = [torch.as_tensor(a).requires_grad_() for a in arrs]
    want = torch.autograd.grad(ssk.ssd_phases(*ins, chunk=64)[0], ins, dy)
    _, vjp = jax.vjp(lambda *a: ssd_scan_ref(*a, chunk=64),
                     *map(jnp.asarray, arrs))
    assert not np.isfinite(np.asarray(vjp(jnp.asarray(dy.numpy()))[1])).all()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w.numpy()) < 1e-4


def test_ssd_scan_bwd_takes_the_plain_version_on_the_cpu():
    """``ssd_scan_bwd`` on CPU tensors is ``ssd_scan_bwd_plain`` at the
    caller's chunk, bit for bit, and counts no kernel launch; a dy that is
    not shaped like xdt raises."""
    arrs, dy = _bwd_inputs(23, 2, 3, 200, 16, 16, None)
    ins = [torch.as_tensor(a) for a in arrs]
    dy = torch.as_tensor(dy)
    before = ssk.bwd_launches
    for chunk in (64, 8):
        got = ssk.ssd_scan_bwd(*ins, dy, chunk=chunk)
        want = ssk.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssk.bwd_launches == before
    with pytest.raises(ValueError):
        ssk.ssd_scan_bwd(*ins, dy[:, :, :64])


# ---------------------------------------------------------------------------
# the backward's products in 3xTF32 (the chunk-gradient kernel's precision)
# ---------------------------------------------------------------------------
def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, on the fp32 bits (the low 13 mantissa bits cleared)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(a: torch.Tensor):
    hi = _round_tf32(a)
    return hi, _round_tf32(a - hi)


# ssd_scan_bwd_plain's torch.matmul calls without h_in, in order: C B^T;
# the chunk states dH (the forward's chunk-parallel kernel's on the card)
# and dS (the reverse pass's), both fp32 FMA; then the chunk-gradient
# kernel's dy x^T, B g^T, M^T dy, (dy e^cums) h_in, dG^T C, (x dec) g and
# dG B
_BWD_MATMULS = 10
_FP32_MATMULS = (1, 2)


def _bwd_with_tf32_products(arrs, dy, passes: int):
    """``ssd_scan_bwd_plain`` with the chunk-gradient kernel's products in
    ``passes`` TF32 products (1: hi hi; 3: hi hi + hi lo + lo hi, each
    summed in fp32) and the chunk states in fp32, as on the card."""
    matmul = torch.matmul
    calls = []

    def emulated(a, b):
        calls.append(None)
        if len(calls) - 1 in _FP32_MATMULS:
            return matmul(a, b)
        (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
        out = matmul(ah, bh)
        if passes == 3:
            out = out + matmul(ah, bl) + matmul(al, bh)
        return out
    torch.matmul = emulated
    try:
        got = ssk.ssd_scan_bwd_plain(*map(torch.as_tensor, arrs),
                                     torch.as_tensor(dy))
    finally:
        torch.matmul = matmul
    assert len(calls) == _BWD_MATMULS
    return got


def _tf32_rel_errors(case, passes: int) -> dict:
    """Each gradient's max |emulated - fp32 plain| over its max |plain|."""
    arrs, dy = _bwd_inputs(24, *case)
    want = ssk.ssd_scan_bwd_plain(*map(torch.as_tensor, arrs),
                                  torch.as_tensor(dy))
    got = _bwd_with_tf32_products(arrs, dy, passes)
    return {name: float((g - w).abs().max() / w.abs().max())
            for name, g, w in zip(("dxdt", "dloga", "dB", "dC"), got, want)}


TF32_CASES = [  # Bz, H, S, P, N, log-decay per step (None: random)
    (2, 8, 40, 16, 16, None),          # mamba2-370m smoke widths
    (2, 8, 40, 16, 16, -5.0),
    (2, 8, 512, 64, 128, None),        # mamba2-370m's P and N
    (2, 8, 512, 64, 128, -5.0),        # strong decay
]


@pytest.mark.parametrize("case", TF32_CASES)
def test_ssd_bwd_products_in_3xtf32_keep_half_the_tolerance(case):
    """The chunk-gradient kernel runs its products on tensor cores in
    3xTF32.  Emulated on the plain backward (round to TF32 as cvt.rna does,
    hi hi + hi lo + lo hi in fp32), every gradient stays within 5e-5 of its
    max |fp32 plain|: half the 1e-4 the card holds the kernel to."""
    errs = _tf32_rel_errors(case, passes=3)
    assert all(e < 5e-5 for e in errs.values()), errs


if __name__ == "__main__":
    # the figures behind the 3xTF32 choice: one TF32 pass and three
    for case in TF32_CASES:
        for passes in (1, 3):
            print(case, f"{passes} pass(es):", _tf32_rel_errors(case, passes))
