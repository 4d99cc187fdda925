"""``rope_kv_append_plain`` (the decode layer's bias, RoPE, page/slot
lookup and K/V write, op by op) against the JAX package: the reference's
``layers/rope.py::apply_rope`` on q and k, its decode layer's page/slot
lookup (``serving/tp_layers.py``: a position past the table or a -1 page
writes to the dump page) and the Pallas ``kv_update`` in interpret mode
for the arena.  q and K within the reference's RoPE numerics (1e-6 in
fp32, one ulp in bf16); V and the placement of every row exactly equal.
The CUDA kernel is held to this plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.kv_update.kernel import kv_update as j_kv  # noqa: E402
from repro.layers.rope import apply_rope as j_rope  # noqa: E402
from repro.layers.rope import rope_freqs as j_freqs  # noqa: E402
from repro_torch.kernels.kv_update import kernel as kvk  # noqa: E402
from repro_torch.layers.rope import apply_rope, rope_freqs  # noqa: E402

_J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"fp32": torch.float32, "bf16": torch.bfloat16}
THETA = 1e6                      # qwen2.5's
PAGE, P = 8, 4
# lanes: the first slot, a page's last and next slots, a mid-page slot,
# a -1 table column (the dump page) and a position past the table
POS = [0, PAGE - 1, PAGE, 2 * PAGE + 3, 2 * PAGE + 5, 1000]
DUMP_COLUMN_LANE = 4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dt):
    """fp32: within 1e-6; bf16: within one ulp of the larger value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    if dt == "fp32":
        return float(err.max()) <= 1e-6
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return bool((err <= ulp).all())


def _inputs(H, K, dh, dt, seed):
    rng = np.random.default_rng(seed)
    B = len(POS)
    pages = B * P + 1
    f = {"q": rng.standard_normal((B, H * dh)),
         "k": rng.standard_normal((B, K * dh)),
         "v": rng.standard_normal((B, K * dh)),
         "bq": 0.5 * rng.standard_normal(H * dh),
         "bk": 0.5 * rng.standard_normal(K * dh),
         "bv": 0.5 * rng.standard_normal(K * dh),
         "ak": rng.standard_normal((pages, PAGE, K, dh)),
         "av": rng.standard_normal((pages, PAGE, K, dh))}
    # round once to the dtype, so both packages start from the same values
    f = {n: np.asarray(torch.as_tensor(a, dtype=torch.float32)
                       .to(_T[dt]).float()) for n, a in f.items()}
    bt = rng.permutation(pages - 1)[:B * P].astype(np.int32).reshape(B, P)
    bt[DUMP_COLUMN_LANE, POS[DUMP_COLUMN_LANE] // PAGE] = -1
    return f, bt, np.asarray(POS, np.int32)


def _reference(f, bt, pos, H, K, dh, dt, bias, rope):
    """The reference decode layer's chain, op by op in jnp, then the
    Pallas kv_update at the page ids the layer scatters to."""
    jdt = _J[dt]
    B = pos.shape[0]
    q, k, v = (jnp.asarray(f[n], jdt) for n in ("q", "k", "v"))
    if bias:
        q = q + jnp.asarray(f["bq"], jdt)
        k = k + jnp.asarray(f["bk"], jdt)
        v = v + jnp.asarray(f["bv"], jdt)
    q, k, v = q.reshape(B, H, dh), k.reshape(B, K, dh), v.reshape(B, K, dh)
    jpos = jnp.asarray(pos)
    if rope:
        q = j_rope(q[:, None], jpos[:, None], THETA)[:, 0]
        k = j_rope(k[:, None], jpos[:, None], THETA)[:, 0]
    ak, av = jnp.asarray(f["ak"], jdt), jnp.asarray(f["av"], jdt)
    dump = ak.shape[0] - 1
    slot = (jpos % PAGE).astype(jnp.int32)
    pid = jnp.take_along_axis(jnp.asarray(bt), (jpos // PAGE)[:, None],
                              axis=1)[:, 0]
    k, v = k.astype(ak.dtype), v.astype(av.dtype)
    # the Pallas kernel writes the lanes with a page (one lane a page, its
    # contract); the two lanes bound for the dump page share it, so they
    # land there by the decode layer's own scatter
    ak, av = j_kv(ak, av, k, v, jnp.where(pid >= 0, pid, -1).astype(
        jnp.int32), slot, interpret=True)
    to_dump = np.asarray(pid < 0)
    ak = ak.at[dump, slot[to_dump]].set(k[to_dump])
    av = av.at[dump, slot[to_dump]].set(v[to_dump])
    pid_w = np.where(to_dump, dump, np.asarray(pid))
    return q, ak, av, pid_w, np.asarray(slot)


def _port(f, bt, pos, dt, bias, rope, dh, fn=kvk.rope_kv_append_plain):
    tdt = _T[dt]
    t = {n: torch.tensor(a).to(tdt) for n, a in f.items()}     # copies
    biases = (t["bq"], t["bk"], t["bv"]) if bias else (None,) * 3
    # the table is an input: both packages rotate by the reference's
    # (``test_rope_freqs_within_an_ulp_of_reference`` compares the tables)
    freqs = torch.tensor(np.asarray(j_freqs(dh, THETA))) if rope \
        else None
    q = fn(t["q"], t["k"], t["v"], *biases, freqs, torch.as_tensor(pos),
           torch.as_tensor(bt), t["ak"], t["av"])
    return q, t["ak"], t["av"]


@pytest.mark.parametrize("H,K,dh,dt,bias,rope", [
    (40, 8, 128, "fp32", True, True),          # qwen2.5-32b
    (40, 8, 128, "bf16", True, True),
    (48, 1, 128, "fp32", True, True),          # granite-20b
    (48, 1, 128, "bf16", True, True),
    (16, 1, 256, "fp32", True, True),          # recurrentgemma-9b
    (16, 1, 256, "bf16", True, True),
    (40, 8, 128, "fp32", False, True),
    (40, 8, 128, "bf16", False, True),
    (40, 8, 128, "fp32", True, False),
    (40, 8, 128, "bf16", True, False),
    (40, 8, 128, "fp32", False, False),
    (40, 8, 128, "bf16", False, False),
])
def test_plain_matches_reference(H, K, dh, dt, bias, rope):
    f, bt, pos = _inputs(H, K, dh, dt, seed=H + K + dh)
    jq, jak, jav, pid_w, slot = _reference(f, bt, pos, H, K, dh, dt, bias,
                                           rope)
    tq, tak, tav = _port(f, bt, pos, dt, bias, rope, dh)
    assert tq.shape == (len(POS), H, dh) and tq.dtype == _T[dt]
    assert _close(tq.float().numpy(), _np(jq), dt)
    # V: every row of the arena exactly equal
    np.testing.assert_array_equal(tav.float().numpy(), _np(jav))
    # K: the written rows within RoPE's numerics, every other row untouched
    written = np.zeros(tak.shape[:2], bool)
    written[pid_w, slot] = True
    dump = tak.shape[0] - 1
    assert written[dump].sum() == 2            # the -1 column and past P
    got, want = tak.float().numpy(), _np(jak)
    np.testing.assert_array_equal(got[~written], want[~written])
    np.testing.assert_array_equal(got[~written], f["ak"][~written])
    assert _close(got[written], want[written], dt)
    if not rope:
        np.testing.assert_array_equal(got[written], want[written])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_wrapper_on_cpu_runs_the_plain_version(dt):
    f, bt, pos = _inputs(40, 8, 128, dt, seed=3)
    n = kvk.rope_kv_append_launches
    q1, ak1, av1 = _port(f, bt, pos, dt, True, True, 128)
    q2, ak2, av2 = _port(f, bt, pos, dt, True, True, 128,
                         fn=kvk.rope_kv_append)
    assert torch.equal(q1, q2) and torch.equal(ak1, ak2) \
        and torch.equal(av1, av2)
    assert kvk.rope_kv_append_launches == n       # no kernel on the CPU


def _args(H=8, K=2, dh=16, B=2, pos_dtype=torch.int32, bias=True):
    q = torch.zeros((B, H * dh))
    k = torch.zeros((B, K * dh))
    biases = (torch.zeros(H * dh), torch.zeros(K * dh),
              torch.zeros(K * dh)) if bias else (None,) * 3
    return (q, k, k.clone(), *biases, torch.ones(dh // 2),
            torch.zeros((B,), dtype=pos_dtype),
            torch.zeros((B, 2), dtype=torch.int32),
            torch.zeros((5, 4, K, dh)), torch.zeros((5, 4, K, dh)))


@pytest.mark.parametrize("case,exc", [
    ("odd head_dim", ValueError),
    ("head_dim above 256", ValueError),
    ("H % K != 0", ValueError),
    ("int64 pos", TypeError),
    ("one bias of three", ValueError),
])
def test_wrapper_refuses(case, exc):
    if case == "odd head_dim":
        args = list(_args(dh=16))
        args[9] = args[10] = torch.zeros((5, 4, 2, 15))
        args[0] = torch.zeros((2, 8 * 15))
        args[1] = args[2] = torch.zeros((2, 2 * 15))
        args[3:6] = [None] * 3
        args[6] = None
    elif case == "head_dim above 256":
        args = _args(H=2, K=1, dh=258, bias=False)
    elif case == "H % K != 0":
        args = _args(H=5, K=2)
    elif case == "int64 pos":
        args = _args(pos_dtype=torch.int64)
    else:
        args = list(_args())
        args[4] = None
    with pytest.raises(exc):
        kvk.rope_kv_append(*args)


def test_rope_freqs_is_cached_and_unchanged():
    a = rope_freqs(64, THETA)
    assert rope_freqs(64, THETA) is a
    assert rope_freqs(64, 1e4) is not a
    want = THETA ** (-torch.arange(0, 32, dtype=torch.float32) / 32)
    assert torch.equal(a, want)
    x = torch.randn((2, 3, 4, 64))
    pos = torch.arange(6).reshape(2, 3)
    assert torch.equal(apply_rope(x, pos, THETA),
                       apply_rope(x, pos, freqs=want))


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_rope_freqs_within_an_ulp_of_reference(dh):
    """``theta ** (-i / half)``: torch's and XLA's fp32 pow round a few
    entries apart, by one ulp at most."""
    a = rope_freqs(dh, THETA).numpy()
    b = np.asarray(j_freqs(dh, THETA))
    assert (np.abs(a.view(np.int32) - b.view(np.int32)) <= 1).all()
