"""Mamba-2 SSD chunked scan over pre-discretized inputs, and its gradient.

``ssd_scan`` is an autograd Function (``SSDScan``).  On CUDA tensors its
forward launches the CUDA kernel ``csrc/ssd_scan.cu`` (the port of the
Pallas TPU kernel ``kernels/ssd_scan/kernel.py::ssd_scan`` of the
reference) and its backward ``csrc/ssd_scan_bwd.cu`` (``ssd_scan_bwd``; the
reference has no Pallas backward: its gradient is XLA's autodiff of
``layers/ssd.py::ssd_chunked``).  On CPU tensors the Function runs the
plain versions, ``ssd_phases`` forward and ``ssd_scan_bwd_plain``
backward, at the caller's chunk.  When an input needs a gradient the
forward also keeps h_in, the state entering each chunk [Bz, H, nc, P, N]
fp32, and hands it to the backward.

xdt: [Bz, H, S, P] (x * dt); loga: [Bz, H, S] (dt * A, the log-decay);
B/C: [Bz, S, N], shared across the heads.  Returns y [Bz, H, S, P] in
fp32 whatever the input dtype:

    h_t = exp(loga_t) h_{t-1} + xdt_t^T B_t      ([P, N] state per head)
    y_t = h_t C_t

computed chunk by chunk in the dual (quadratic) form, split the way the
CUDA kernel splits it (``ssd_phases``): chunk-local quantities for every
chunk at once (C B^T once per batch and chunk, the intra-chunk outputs,
each chunk's own state dH), then the state pass over the chunks in order,
then the outputs from the incoming states.  The kernels' chunk is 64, the
layer's ``ssm_chunk`` (the Pallas kernel's is 128 -- the same function up
to rounding).  Any S is taken: a partial last chunk is zero-padded.  The
kernels take P <= 64 and N <= 128, each a multiple of 8; the backward
takes fp32 only (an input in bf16 that requires grad raises, on the CPU
too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build

CHUNK = 64            # the kernel's chunk (kQ in csrc/ssd_scan.cu)
MAX_P, MAX_N = 64, 128
BWD_HEADS = 8         # heads a block of the backward's chunk kernels

launches = 0          # forward kernel launches since the caller zeroed this
bwd_launches = 0      # backward kernel launches, likewise

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_phases(xdt, loga, B, C, *, chunk: int = CHUNK, h0=None,
               with_h_in: bool = False):
    """The scan in the kernel's three phases, plain PyTorch, fp32.

    xdt [Bz, H, S, P], loga [Bz, H, S], B/C [Bz, S, N]; ``h0`` [Bz, H, P,
    N] or None for zeros.  Returns (y [Bz, H, S, P], h_final [Bz, H, P,
    N]), both fp32, and with ``with_h_in`` also the state entering each
    chunk, h_in [Bz, H, nc, P, N] (what the forward kernel stores for the
    backward).
    """
    Bz, H, S, P = xdt.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    # zero steps past S: no decay, no input, no readout
    x = F.pad(xdt.float(), (0, 0, 0, pad)).reshape(Bz, H, nc, Q, P)
    la = F.pad(loga.float(), (0, pad)).reshape(Bz, H, nc, Q)
    Bf = F.pad(B.float(), (0, 0, 0, pad)).reshape(Bz, 1, nc, Q, N)
    Cf = F.pad(C.float(), (0, 0, 0, pad)).reshape(Bz, 1, nc, Q, N)

    # 1. chunk-local, every chunk at once (the kernel's chunk-parallel part)
    cums = torch.cumsum(la, dim=-1)                          # [Bz,H,nc,Q]
    G = torch.matmul(Cf, Bf.transpose(-1, -2))               # [Bz,1,nc,Q,Q]
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    rel = cums[..., :, None] - cums[..., None, :]
    # exp only below the diagonal: above it rel >= 0 may overflow
    L = torch.exp(torch.where(causal, rel, 0.0)) * causal
    y = torch.matmul(G * L, x)                               # y_intra
    decay_out = torch.exp(cums[..., -1:] - cums)             # [Bz,H,nc,Q]
    dH = torch.matmul((x * decay_out[..., None]).transpose(-1, -2), Bf)
    ecum = torch.exp(cums)

    # 2. the state pass, in chunk order (the kernel's sequential part)
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_ins = []
    for c in range(nc):
        h_ins.append(h)
        h = h * ecum[:, :, c, -1, None, None] + dH[:, :, c]
    h_in = torch.stack(h_ins, dim=2)                         # [Bz,H,nc,P,N]

    # 3. the outputs from the incoming states
    y = y + torch.matmul(Cf, h_in.transpose(-1, -2)) * ecum[..., None]
    y = y.reshape(Bz, H, nc * Q, P)[:, :, :S]
    return (y, h, h_in) if with_h_in else (y, h)


def ssd_scan_plain(xdt, loga, B, C, *, chunk: int = CHUNK):
    """Plain PyTorch version of the kernel (``ssd_phases``), fp32."""
    return ssd_phases(xdt, loga, B, C, chunk=chunk)[0]


def ssd_scan_bwd_plain(xdt, loga, B, C, dy, *, chunk: int = CHUNK,
                       h_in=None):
    """Plain PyTorch version of the backward kernel: the gradient of
    ``ssd_phases``' y (from h0 = 0) given dy, in the kernel's three
    phases, without autograd.  ``h_in`` [Bz, H, nc, P, N] is the state
    entering each chunk as the forward hands it over (``ssd_phases(...,
    with_h_in=True)``), or None to rebuild it here from each chunk's own
    state dH.  Returns (dxdt [Bz, H, S, P], dloga [Bz, H, S], dB [Bz, S,
    N], dC [Bz, S, N]), all fp32.

    Per chunk c, with cums the in-chunk cumulative log-decay, L_ij =
    exp(cums_i - cums_j) for i >= j (0 above), G = C B^T, M = G * L,
    decay_out = exp(cums_last - cums), h_in the state entering the chunk
    and g_c the gradient of the state leaving it:

    1. the reverse state pass, last chunk to first: g_{nc-1} = 0,
       g_{c-1} = (dy_c * exp(cums_c))^T C_c + exp(cums_c[-1]) g_c (and,
       without ``h_in``, the forward pass that rebuilds it);
    2. chunk-parallel, from the chunk's own dy, h_in and g_c:
       dx = M^T dy + decay_out * (B g^T);
       dG = sum_h (dy x^T) * L,  dB = dG^T C + (x * decay_out) g,
       dC = dG B + (dy * exp(cums)) h_in  (B and C sum over the heads);
       dcums from L (row minus column sums of M * (dy x^T) below the
       diagonal), from exp(cums) in the inter-chunk output, from
       decay_out, and at the chunk's last step from decay_out and the
       chunk decay of the pass;
    3. dloga, the reverse cumulative sum of dcums within the chunk.
    """
    Bz, H, S, P = xdt.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    x = F.pad(xdt.float(), (0, 0, 0, pad)).reshape(Bz, H, nc, Q, P)
    la = F.pad(loga.float(), (0, pad)).reshape(Bz, H, nc, Q)
    Bf = F.pad(B.float(), (0, 0, 0, pad)).reshape(Bz, 1, nc, Q, N)
    Cf = F.pad(C.float(), (0, 0, 0, pad)).reshape(Bz, 1, nc, Q, N)
    dyf = F.pad(dy.float(), (0, 0, 0, pad)).reshape(Bz, H, nc, Q, P)

    cums = torch.cumsum(la, dim=-1)                          # [Bz,H,nc,Q]
    G = torch.matmul(Cf, Bf.transpose(-1, -2))               # [Bz,1,nc,Q,Q]
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    rel = cums[..., :, None] - cums[..., None, :]
    L = torch.exp(torch.where(causal, rel, 0.0)) * causal
    dec = torch.exp(cums[..., -1:] - cums)                   # decay_out
    ecum = torch.exp(cums)
    e_last = ecum[..., -1]                                   # [Bz,H,nc]
    xd = x * dec[..., None]
    dye = dyf * ecum[..., None]
    if h_in is None:
        dH = torch.matmul(xd.transpose(-1, -2), Bf)          # [Bz,H,nc,P,N]
    dS = torch.matmul(dye.transpose(-1, -2), Cf)

    # 1. the state passes: h_in forward (unless handed over), g in reverse
    g = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    if h_in is None:
        h, h_ins = torch.zeros_like(g), []
        for c in range(nc):
            h_ins.append(h)
            h = h * e_last[:, :, c, None, None] + dH[:, :, c]
        h_in = torch.stack(h_ins, dim=2)
    else:
        h_in = h_in.float()
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = dS[:, :, c] + e_last[:, :, c, None, None] * g
    g = torch.stack(gs, dim=2)                               # [Bz,H,nc,P,N]

    # 2. chunk-parallel
    D = torch.matmul(dyf, x.transpose(-1, -2))               # dy_i . x_j
    LD = L * D
    # L's diagonal is exp(0): its terms in the row and column sums cancel
    T = G * LD * (ii[:, None] > ii[None, :])
    V = torch.matmul(Bf, g.transpose(-1, -2))                # B g^T [Q,P]
    dx = torch.matmul((G * L).transpose(-1, -2), dyf) + dec[..., None] * V
    dG = LD.sum(1, keepdim=True)
    W = torch.matmul(dye, h_in)                              # [Bz,H,nc,Q,N]
    dB = torch.matmul(dG.transpose(-1, -2), Cf)[:, 0] + \
        torch.matmul(xd, g).sum(1)
    dC = torch.matmul(dG, Bf)[:, 0] + W.sum(1)
    u = dec * (x * V).sum(-1)
    dcums = T.sum(-1) - T.sum(-2) + (W * Cf).sum(-1) - u
    dcums[..., -1] += u.sum(-1) + e_last * (g * h_in).sum((-1, -2))

    # 3. dloga: the reverse cumulative sum within each chunk
    dloga = dcums.flip(-1).cumsum(-1).flip(-1)
    return (dx.reshape(Bz, H, nc * Q, P)[:, :, :S],
            dloga.reshape(Bz, H, nc * Q)[:, :, :S],
            dB.reshape(Bz, nc * Q, N)[:, :S],
            dC.reshape(Bz, nc * Q, N)[:, :S])


def _check(xdt, loga, B, C):
    if xdt.dim() != 4:
        raise ValueError("xdt must be [Bz, H, S, P]")
    Bz, H, S, P = xdt.shape
    if loga.shape != (Bz, H, S) or B.dim() != 3 or B.shape[:2] != (Bz, S) \
            or C.shape != B.shape:
        raise ValueError(f"shapes do not fit: xdt {tuple(xdt.shape)}, loga "
                         f"{tuple(loga.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    for t in (loga, B, C):
        if t.device != xdt.device:
            raise ValueError("all tensors must be on one device")
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {xdt.device}")


def _check_kernel_inputs(name, tensors, dtypes):
    """What the CUDA kernels take: one dtype of ``dtypes``, contiguous
    tensors, P and N multiples of 8 up to MAX_P and MAX_N."""
    dt = tensors[0].dtype
    if dt not in dtypes or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name} takes "
                        f"{' or '.join(str(d)[6:] for d in dtypes)} inputs "
                        f"of one dtype")
    P, N = tensors[0].shape[-1], tensors[2].shape[-1]
    if P % 8 or N % 8 or P > MAX_P or N > MAX_N:
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"multiples of 8; got P={P}, N={N}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _launch_fwd(xdt, loga, B, C, with_h_in: bool = False):
    """The forward kernel on CUDA tensors: y [Bz, H, S, P] fp32, and with
    ``with_h_in`` also (y, h_in): the state entering each chunk [Bz, H,
    nc, P, N] fp32, stored by the state pass as it walks the chunks."""
    global launches
    _check_kernel_inputs("ssd_scan", (xdt, loga, B, C), tuple(_DTYPE_CODE))
    Bz, H, S, P = xdt.shape
    N = B.shape[-1]
    nc = -(-S // CHUNK)
    y = torch.empty((Bz, H, S, P), dtype=torch.float32, device=xdt.device)
    # scratch: each chunk's own state and exp(cums), written by the
    # chunk-parallel kernel and read once by the state pass
    dH = torch.empty((Bz, H, nc, P, N), dtype=torch.float32,
                     device=xdt.device)
    ecum = torch.empty((Bz, H, nc, CHUNK), dtype=torch.float32,
                       device=xdt.device)
    h_in = torch.empty_like(dH) if with_h_in else None
    err = build.library().ssd_scan_launch(
        xdt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), dH.data_ptr(), ecum.data_ptr(),
        h_in.data_ptr() if with_h_in else None, Bz, H, S, P, N,
        _DTYPE_CODE[xdt.dtype], build.stream_ptr(xdt.device))
    build.check(err, "ssd_scan")
    launches += 1
    return (y, h_in) if with_h_in else y


def _check_h_in(h_in, xdt, N, chunk):
    Bz, H, S, P = xdt.shape
    want = (Bz, H, -(-S // chunk), P, N)
    if tuple(h_in.shape) != want or h_in.dtype != torch.float32 or \
            h_in.device != xdt.device:
        raise ValueError(f"h_in must be float32 {want} on {xdt.device}; got "
                         f"{h_in.dtype} {tuple(h_in.shape)} on "
                         f"{h_in.device}")


def ssd_scan_bwd(xdt, loga, B, C, dy, *, chunk: int = CHUNK, h_in=None):
    """(dxdt, dloga, dB, dC) of y = ssd_scan(xdt, loga, B, C) given dy [Bz,
    H, S, P]: the backward kernel on CUDA tensors (fp32, chunk CHUNK),
    ``ssd_scan_bwd_plain`` at ``chunk`` on CPU tensors.  ``h_in`` [Bz, H,
    nc, P, N] is the state entering each chunk as the forward stores it
    (``SSDScan`` hands it over); without it, on CUDA tensors, one forward
    launch with the store on (counted in ``launches``) makes it."""
    global bwd_launches
    _check(xdt, loga, B, C)
    if dy.shape != xdt.shape or dy.device != xdt.device:
        raise ValueError(f"dy {tuple(dy.shape)} must be like xdt "
                         f"{tuple(xdt.shape)}")
    N = B.shape[-1]
    if xdt.device.type == "cpu":
        if h_in is not None:
            _check_h_in(h_in, xdt, N, chunk)
        return ssd_scan_bwd_plain(xdt, loga, B, C, dy, chunk=chunk,
                                  h_in=h_in)
    _check_kernel_inputs("ssd_scan_bwd", (xdt, loga, B, C, dy),
                         (torch.float32,))
    if h_in is None:
        h_in = _launch_fwd(xdt, loga, B, C, with_h_in=True)[1]
    _check_h_in(h_in, xdt, N, CHUNK)
    if not h_in.is_contiguous():
        raise ValueError("ssd_scan_bwd needs a contiguous h_in")
    Bz, H, S, P = xdt.shape
    nc = -(-S // CHUNK)
    groups = -(-H // BWD_HEADS)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xdt.device)
    dx, dloga, dB, dC = f32(Bz, H, S, P), f32(Bz, H, S), f32(Bz, S, N), \
        f32(Bz, S, N)
    # scratch: the outgoing state's gradient g of each chunk, written by
    # the reverse pass; each head group's dB and dC partials, added in
    # group order
    g = f32(Bz, H, nc, P, N)
    parts = f32(2, Bz, nc, groups, CHUNK, N)
    err = build.library().ssd_scan_bwd_launch(
        xdt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
        dy.data_ptr(), h_in.data_ptr(), dx.data_ptr(), dloga.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), g.data_ptr(), parts.data_ptr(), Bz,
        H, S, P, N, build.stream_ptr(xdt.device))
    build.check(err, "ssd_scan_bwd")
    bwd_launches += 1
    return dx, dloga, dB, dC


class SSDScan(torch.autograd.Function):
    """The scan with the kernels' gradient.  When an input needs a
    gradient the forward keeps its inputs and h_in, the state entering
    each chunk (the forward kernel stores it as it walks; the plain
    version returns the one it builds), and the backward reads them;
    otherwise it keeps nothing.  Under the unit remat's checkpoint the
    first forward's tensors are dropped and the recomputed forward's are
    the ones the backward reads.  CPU tensors take the plain versions at
    ``chunk``; the kernels' chunk is CHUNK."""

    @staticmethod
    def forward(ctx, xdt, loga, B, C, chunk, grad_enabled):
        # needs_input_grad reads requires_grad alone, under no_grad too
        grad = grad_enabled and any(ctx.needs_input_grad[:4])
        if xdt.device.type == "cpu":
            out = ssd_phases(xdt, loga, B, C, chunk=chunk, with_h_in=grad)
            y = out[0]
        else:
            out = _launch_fwd(xdt, loga, B, C, with_h_in=grad)
            y = out[0] if grad else out
        if grad:
            ctx.save_for_backward(xdt, loga, B, C, out[-1])
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xdt, loga, B, C, h_in = ctx.saved_tensors
        grads = ssd_scan_bwd(xdt, loga, B, C, dy.contiguous(),
                             chunk=ctx.chunk, h_in=h_in)
        return (*grads, None, None)


def ssd_scan(xdt, loga, B, C, *, chunk: int = CHUNK):
    """xdt: [Bz, H, S, P]; loga: [Bz, H, S]; B/C: [Bz, S, N].  Returns y
    [Bz, H, S, P] in fp32, differentiable in all four inputs.  ``chunk`` is
    the plain version's on CPU tensors; the kernels' is CHUNK."""
    _check(xdt, loga, B, C)
    grad = torch.is_grad_enabled()
    if grad and any(t.requires_grad for t in (xdt, loga, B, C)) and \
            any(t.dtype != torch.float32 for t in (xdt, loga, B, C)):
        raise TypeError("ssd_scan's backward takes float32 inputs: an input "
                        "that requires grad must be float32")
    return SSDScan.apply(xdt, loga, B, C, chunk, grad)
