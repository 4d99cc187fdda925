"""The gradient of the port's ``flash_attention``:
``flash_attention_bwd_plain`` (the backward kernel's plain version)
against ``jax.vjp`` of the reference's
``chunked_attention`` (the function XLA differentiates for the reference's
training), fed q, k and v through identity projections; the autograd
Function on the CPU against autograd through the plain forward; the
forward's log-sum-exp; and the refusals.  The CUDA kernel itself is held
against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.layers import attention as JA  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fak  # noqa: E402

_J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, B, H, K, S, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, dh), (B, K, S, dh), (B, K, S, dh),
                          (B, H, S, dh))]


def _ref_vjp(q, k, v, do, causal, window, dt):
    """(dq, dk, dv) from jax.vjp of the reference's chunked attention:
    x = [q | k | v] along d_model, the projections slices of the identity
    (exact in either dtype), no RoPE, no bias."""
    B, H, S, dh = q.shape
    K = k.shape[1]
    D = (H + 2 * K) * dh
    jdt = _J[dt]
    cfg = JConfig(name="core", family="dense", num_layers=1, d_model=D,
                  num_heads=H, num_kv_heads=K, head_dim=dh, use_rope=False,
                  causal=causal, window=window, dtype=jdt)
    eye = jnp.eye(D, dtype=jdt)
    p = {"wq": eye[:, :H * dh], "wk": eye[:, H * dh:(H + K) * dh],
         "wv": eye[:, (H + K) * dh:], "wo": eye[:H * dh]}
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))

    def flat(t):
        return t.transpose(0, 2, 1, 3).reshape(B, S, -1)

    def core(q, k, v):
        x = jnp.concatenate([flat(q), flat(k), flat(v)], axis=-1)
        out, _ = JA.chunked_attention(cfg, p, x, pos, causal=causal,
                                      window=window)
        return out[..., :H * dh].reshape(B, S, H, dh).transpose(0, 2, 1, 3)

    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    _, vjp = jax.vjp(core, *args)
    return [np.asarray(jnp.asarray(g, jnp.float32))
            for g in vjp(jnp.asarray(do, jdt))]


# g 1 / 3 / 12, S 13 / 64 / 200, causal / window 16 / none, dh 16 / 80 /
# 128, and above 128 (nemotron-4-340b's 192, recurrentgemma-9b's 256)
@pytest.mark.parametrize("B,H,K,S,dh,causal,win,dt", [
    (2, 4, 4, 13, 16, True, 0, "fp32"),       # g 1, S below a tile
    (1, 6, 2, 64, 80, True, 16, "fp32"),      # g 3, window
    (1, 12, 1, 200, 16, False, 0, "fp32"),    # g 12, no mask
    (1, 3, 1, 200, 128, True, 0, "fp32"),
    (1, 3, 1, 64, 128, True, 16, "bf16"),
    (1, 12, 1, 200, 16, True, 0, "bf16"),
    (1, 4, 2, 100, 192, True, 24, "fp32"),    # causal with a window
    (1, 2, 1, 70, 192, False, 0, "fp32"),     # no mask
    (1, 2, 1, 100, 256, True, 24, "fp32"),
    (2, 3, 1, 70, 256, False, 0, "fp32"),
])
def test_flash_bwd_plain_vs_reference_vjp(B, H, K, S, dh, causal, win, dt):
    q, k, v, do = _inputs(0, B, H, K, S, dh)
    want = _ref_vjp(q, k, v, do, causal, win, dt)
    tq, tk, tv, tdo = (torch.as_tensor(a).to(_T[dt]) for a in (q, k, v, do))
    o, lse = fak.flash_attention_fwd_plain(tq, tk, tv, causal=causal,
                                           window=win)
    got = fak.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                        causal=causal, window=win)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == _T[dt]
        err = float(np.abs(g.float().numpy() - w).max())
        if dt == "fp32":
            assert err < 2e-5 * np.abs(w).max(), (name, err)
        else:
            # 3e-2 at unit scale: |dk| sums g x S terms and reaches ~5 at
            # g 12, where one bf16 ulp of the reference's own rounding is
            # 2^-5, so the bound scales with max(1, max |ref|)
            assert err < 3e-2 * max(1.0, np.abs(w).max()), (name, err)


@pytest.mark.parametrize("H,K,S,dh,causal,win", [
    (4, 2, 37, 16, True, 0), (3, 1, 50, 32, False, 0),
    (6, 3, 64, 16, True, 8), (2, 2, 19, 48, False, 5)])
def test_flash_function_on_cpu_vs_autograd_of_plain(H, K, S, dh, causal,
                                                   win):
    """The Function's plain backward against torch.autograd through the
    plain forward (float64 inputs, so the difference is the plain
    versions' fp32 arithmetic)."""
    q, k, v, do = (torch.as_tensor(a, dtype=torch.float64)
                   for a in _inputs(1, 2, H, K, S, dh))
    grads = []
    for fn in (fak.flash_attention, fak.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=causal, window=win)
        grads.append(torch.autograd.grad(out, leaves, do))
    for g, w in zip(*grads):
        assert float((g - w).abs().max()) < 1e-5 * float(w.abs().max())


def test_flash_plain_lse_is_the_rows_logsumexp():
    """lse = logsumexp of each row's scaled, masked scores, also at a row
    whose max is large (the kernels work relative to the running max)."""
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(2, 1, 4, 2, 70, 32))
    q[0, 1, 40] *= 60.0
    for causal, win in ((True, 0), (True, 9), (False, 0)):
        _, lse = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                               window=win, block_q=16)
        s = torch.einsum("bkgsd,bktd->bkgst",
                         q.reshape(1, 2, 2, 70, 32) * 32 ** -0.5, k)
        pos = torch.arange(70)
        mask = fak._mask(pos, 0, 70, causal, win)
        want = torch.logsumexp(torch.where(mask, s, -torch.inf), -1)
        assert float((lse - want.reshape(1, 4, 70)).abs().max()) < 1e-4
    assert float(lse[0, 1, 40]) > 30.0


def test_flash_grad_refusals():
    """The backward kernel's limits: head_dim a multiple of 16 up to 256,
    as the forward's (192 and 256 are taken); 72 and 272 raise (a CPU
    tensor takes the plain backward at any head_dim)."""
    for dh in (72, 272):
        with pytest.raises(ValueError, match="multiple of 16 up to 256"):
            fak.flash_bwd_variant(torch.bfloat16, dh)
    for dh in (16, 64, 80, 128, 192, 256):
        fak.flash_bwd_variant(torch.bfloat16, dh)
        fak.flash_bwd_variant(torch.float32, dh)
    with pytest.raises(TypeError):
        fak.flash_bwd_variant(torch.float16, 64)
    q = torch.zeros((1, 2, 8, 192), requires_grad=True)
    out = fak.flash_attention(q, q.detach(), q.detach())
    out.sum().backward()
    assert q.grad.shape == q.shape
    with pytest.raises(ValueError, match="runs on cuda"):
        z = torch.zeros((1, 2, 8, 16))
        fak.flash_attention_bwd(z, z, z, z, torch.zeros((1, 2, 8)), z)


# ---------------------------------------------------------------------------
# the variants, the wgmma kernel's split of the KV group's heads, and its
# decomposition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128,
                                144, 160, 192, 240, 256])
def test_flash_bwd_variant_takes(dh):
    """bf16 at 64, 128, 192 and 256 runs the wgmma kernel, at the other
    multiples of 16 up to 240 the mma.sync kernel; fp32 runs the FMA
    kernel."""
    want = "wgmma" if dh in (64, 128, 192, 256) else "mma_sync"
    assert fak.flash_bwd_variant(torch.bfloat16, dh) == want
    assert fak.flash_bwd_variant(torch.float32, dh) == "fma"
    assert fak.VARIANTS[want] in (1, 2)


@pytest.mark.parametrize("dh", [8, 72, 264, 272, 320, 0])
def test_flash_bwd_variant_refuses(dh):
    """Not a multiple of 16 (8, 72, 264), above 256 (272, 320), or 0."""
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="multiple of 16 up to 256"):
            fak.flash_bwd_variant(dt, dh)
    with pytest.raises(TypeError):
        fak.flash_bwd_variant(torch.float16, 64)


@pytest.mark.parametrize("B,H,K,S,want", [
    (2, 24, 2, 4096, 6),      # starcoder2-3b's training: 128 blocks -> 768
    (1, 48, 1, 1024, 48),     # granite-20b: 8 blocks -> 384
    (2, 24, 2, 8192, 1),      # 256 blocks fill the card already
    (1, 33, 1, 17000, 1),     # 133 blocks, no split
    (1, 40, 8, 2048, 5),      # qwen2.5-32b: g 5 has no smaller divisor
    (1, 24, 8, 2048, 3),      # granite-moe-3b-a800m
    (1, 16, 16, 4096, 1),     # moonshot's MHA, g 1: nothing to split
    (4, 32, 8, 4096, 1),
    (1, 4, 2, 200, 2),        # g 2: the most a group can split
    (1, 12, 1, 16384, 6),     # 128 blocks: 6 reach 4 an SM, 4 do not
    (1, 12, 1, 8192, 12),     # 64 blocks: only g reaches 528
])
def test_bwd_split_count(B, H, K, S, want):
    """No split where the grid fills the card; otherwise the least divisor
    of g that brings it to BWD_SPLIT_BLOCKS, g if none does."""
    got = fak.bwd_split_count(B, H, K, S)
    assert got == want
    g = H // K
    assert g % got == 0
    blocks = B * K * -(-S // fak.BWD_KEY_TILE)
    if blocks >= fak.BWD_SM_COUNT:
        assert got == 1
        return
    assert blocks * got >= fak.BWD_SPLIT_BLOCKS or got == g
    assert got == 1 or blocks * max(
        d for d in range(1, got) if g % d == 0) < fak.BWD_SPLIT_BLOCKS


@pytest.mark.parametrize("dh,tile", [(64, 128), (128, 128), (192, 64),
                                     (256, 64)])
def test_bwd_key_tile(dh, tile):
    """128 keys a block up to head_dim 128, 64 above it."""
    assert fak.bwd_key_tile(dh) == tile


@pytest.mark.parametrize("B,H,K,S,dh,want", [
    # recurrentgemma-9b's training: 128 64-key blocks < 132 SMs -> split 8
    # (1024 blocks; 4 would give 512 < 528); at 128-key tiles it would have
    # been 64 blocks -> 16
    (1, 16, 1, 8192, 256, 8),
    (1, 16, 1, 8192, 128, 16),
    # nemotron-4-340b's heads: 8 x 64 = 512 blocks fill the card
    (1, 96, 8, 4096, 192, 1),
    (1, 96, 8, 1024, 192, 6),      # 128 64-key blocks: 4 gives 512 < 528
    (2, 16, 1, 8192, 256, 1),      # 256 blocks
    (1, 2, 1, 100, 256, 2),        # 2 blocks: only g reaches 528
])
def test_bwd_split_count_counts_the_head_dims_key_tile(B, H, K, S, dh, want):
    """The split rule counts blocks of the key tile the head_dim gets: 64
    keys above 128.  Without a head_dim it counts 128-key tiles, as the
    callers before the wide kernel did."""
    got = fak.bwd_split_count(B, H, K, S, dh)
    assert got == want
    blocks = B * K * -(-S // fak.bwd_key_tile(dh))
    assert (got == 1) == (blocks >= fak.BWD_SM_COUNT)
    assert fak.bwd_split_count(B, H, K, S) == \
        fak.bwd_split_count(B, H, K, S, 128)


@pytest.mark.parametrize("B,H,K,S,dh,causal,win,want", [
    (1, 96, 8, 4096, 192, True, 0, True),     # nemotron: 256 pairs
    (1, 16, 1, 8192, 256, True, 2048, False),  # a window: no pairs
    (1, 16, 1, 8192, 256, True, 0, False),    # split 8: no pairs
    (2, 24, 2, 4096, 128, True, 0, False),    # dh 128: another kernel
    (1, 96, 8, 4096, 192, False, 0, False),   # no causal mask
    (1, 48, 4, 4480, 256, True, 0, True),     # 280 blocks, 140 pairs
    (1, 48, 1, 8448, 256, True, 0, False),    # 132 blocks but 66 pairs
    (2, 16, 16, 522, 192, True, 0, True),     # 9 key tiles: a lone middle
])
def test_bwd_pair_key_tiles(B, H, K, S, dh, causal, win, want):
    """The wgmma backward above head_dim 128 pairs key tiles j and n - 1 -
    j in a block under a causal mask without a window or a split, where
    the pairs still fill the card."""
    assert fak.bwd_pair_key_tiles(B, H, K, S, dh, causal, win) is want
    if want:
        assert fak.bwd_split_count(B, H, K, S, dh) == 1
        assert B * K * -(-S // 128) >= fak.BWD_SM_COUNT


def test_bwd_split_count_is_a_function_of_shapes():
    """Ints in, an int out, the same each call: nothing to read from the
    device, so the backward stays capturable."""
    for B in (1, 2, 3):
        for H, K in ((48, 1), (24, 2), (12, 4), (16, 16), (40, 8)):
            for S in (1, 64, 127, 128, 1000, 4096):
                a = fak.bwd_split_count(B, H, K, S)
                assert a == fak.bwd_split_count(B, H, K, S)
                assert isinstance(a, int) and (H // K) % a == 0
    with pytest.raises(ValueError):
        fak.bwd_split_count(1, 6, 4, 64)


# (B, H, K, S, dh, causal, window, key_tile, query_tile): small tiles so a
# small S spans several, partial last tiles, splits 1, 2 and g
_SPLIT_CASES = [
    (1, 4, 2, 40, 16, True, 0, 16, 8),
    (2, 8, 2, 37, 32, True, 9, 16, 8),
    (1, 8, 2, 50, 16, False, 0, 32, 16),
    (1, 4, 1, 200, 64, True, 0, 128, 64),        # the kernel's own tiles
    # the wide kernel's 64-key tiles (head_dim above 128): a window, S %
    # 64 != 0, no mask
    (1, 4, 1, 200, 256, True, 48, 64, 64),
    (1, 8, 2, 150, 192, False, 0, 64, 64),
]


@pytest.mark.parametrize("case", _SPLIT_CASES)
@pytest.mark.parametrize("which", ["1", "2", "g"])
def test_flash_bwd_split_plain_vs_plain_and_reference_vjp(case, which):
    """dk / dv summed from per-head-part partials and dq from per-key-tile
    partials, as the wgmma kernel sums them, against the plain backward
    and jax.vjp of the reference's chunked attention: fp32, 2e-5 of max."""
    B, H, K, S, dh, causal, win, kt, qt = case
    g = H // K
    splits = {"1": 1, "2": 2, "g": g}[which]
    q, k, v, do = _inputs(3, B, H, K, S, dh)
    want = _ref_vjp(q, k, v, do, causal, win, "fp32")
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    o, lse = fak.flash_attention_fwd_plain(tq, tk, tv, causal=causal,
                                           window=win)
    got = fak.flash_attention_bwd_split_plain(
        tq, tk, tv, o, lse, tdo, causal=causal, window=win, splits=splits,
        key_tile=kt, query_tile=qt)
    plain = fak.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                          causal=causal, window=win)
    for name, a, b, w in zip("qkv", got, plain, want):
        lim = 2e-5 * np.abs(w).max()
        assert float(np.abs(a.numpy() - w).max()) < lim, name
        assert float((a - b).abs().max()) < lim, name


def test_flash_bwd_split_plain_refuses_a_split_that_does_not_divide_g():
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(4, 1, 6, 2, 16, 16))
    o, lse = fak.flash_attention_fwd_plain(q, k, v)
    with pytest.raises(ValueError, match="does not divide"):
        fak.flash_attention_bwd_split_plain(q, k, v, o, lse, do, splits=2)
