"""Plain versions of the port's two kernels against the reference's
Pallas kernels (interpret mode) and their jnp oracles, on the sweeps of
``tests/test_kernels.py``.  The CUDA kernels themselves are checked
against these plain versions on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.kv_update.kernel import kv_update as j_kv  # noqa: E402
from repro.kernels.kv_update.kernel import kv_update_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import \
    paged_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.kv_update import kernel as kvk  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402

_J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    return jnp.asarray(a, _J[dt]), torch.as_tensor(a).to(_T[dt])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_kv_update_whole_arena(dt):
    """Every page of the arena: visited pages match ``kv_update_ref`` and
    the Pallas kernel, the dump page gets the kernel's write, and every
    other page is untouched."""
    rng = np.random.default_rng(0)
    B, K, dh, pages, page = 4, 2, 64, 8, 16
    kn = rng.standard_normal((B, K, dh)).astype(np.float32)
    vn = rng.standard_normal((B, K, dh)).astype(np.float32)
    ak = rng.standard_normal((pages, page, K, dh)).astype(np.float32)
    av = rng.standard_normal((pages, page, K, dh)).astype(np.float32)
    pids = np.asarray([0, 3, -1, 5], np.int32)
    slots = np.asarray([1, 15, 0, 7], np.int32)
    (jk, tk), (jv, tv) = _pair(kn, dt), _pair(vn, dt)
    (jak, tak), (jav, tav) = _pair(ak, dt), _pair(av, dt)
    before_k, before_v = tak.clone(), tav.clone()
    out_k, out_v = kvk.kv_update(tak, tav, tk, tv, torch.as_tensor(pids),
                                 torch.as_tensor(slots))
    assert out_k.data_ptr() == tak.data_ptr()          # in place
    rk, rv = kv_update_ref(jak, jav, jk, jv, jnp.asarray(pids),
                           jnp.asarray(slots))
    pk, pv = j_kv(jak, jav, jk, jv, jnp.asarray(pids), jnp.asarray(slots),
                  interpret=True)
    dump = pages - 1
    for p in range(pages):
        got_k, got_v = tak[p].float().numpy(), tav[p].float().numpy()
        if p == dump:
            want_k = before_k[p].clone()
            want_v = before_v[p].clone()
            want_k[slots[2]] = tk[2]
            want_v[slots[2]] = tv[2]
            np.testing.assert_array_equal(got_k, want_k.float().numpy())
            np.testing.assert_array_equal(got_v, want_v.float().numpy())
        else:
            np.testing.assert_array_equal(got_k, _np(rk[p]))
            np.testing.assert_array_equal(got_v, _np(rv[p]))
        if p in (0, 3, 5):
            np.testing.assert_array_equal(got_k, _np(pk[p]))
            np.testing.assert_array_equal(got_v, _np(pv[p]))
        elif p != dump:
            np.testing.assert_array_equal(got_k,
                                          before_k[p].float().numpy())


def test_kv_update_drops_out_of_range_slot():
    ak = torch.zeros((3, 4, 1, 2))
    av = torch.zeros((3, 4, 1, 2))
    kvk.kv_update(ak, av, torch.ones((2, 1, 2)), torch.ones((2, 1, 2)),
                  torch.tensor([0, 1], dtype=torch.int32),
                  torch.tensor([4, 1], dtype=torch.int32))
    assert float(ak[0].abs().sum()) == 0.0
    assert float(ak[1, 1].sum()) == 2.0


@pytest.mark.parametrize("B,H,K,pages,page,P,dh,dt,win", [
    (2, 4, 2, 16, 16, 4, 64, "fp32", 0),
    (2, 8, 1, 16, 32, 3, 128, "bf16", 0),     # MQA decode
    (1, 4, 4, 8, 16, 2, 64, "fp32", 24),       # windowed decode
    (3, 8, 2, 24, 8, 6, 128, "fp32", 0),       # small pages
    (2, 10, 2, 12, 16, 4, 128, "bf16", 20),    # qwen's g=5, windowed
])
def test_paged_attention_plain_vs_reference(B, H, K, pages, page, P, dh, dt,
                                            win):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    ak = rng.standard_normal((pages, page, K, dh)).astype(np.float32)
    av = rng.standard_normal((pages, page, K, dh)).astype(np.float32)
    bt = np.full((B, P), -1, np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        n = int(rng.integers(1, P * page))
        lens[b] = n
        need = -(-n // page)
        bt[b, :need] = rng.choice(pages, size=need, replace=False)
    jq, tq = _pair(q, dt)
    jak, tak = _pair(ak, dt)
    jav, tav = _pair(av, dt)
    out = pak.paged_attention(tq, tak, tav, torch.as_tensor(bt),
                              torch.as_tensor(lens), window=win)
    assert out.dtype == _T[dt] and out.shape == (B, H, dh)
    ref = paged_attention_ref(jq, jak, jav, jnp.asarray(bt),
                              jnp.asarray(lens), window=win)
    pal = j_paged(jq, jak, jav, jnp.asarray(bt), jnp.asarray(lens),
                  window=win, interpret=True)
    tol = 3e-2 if dt == "bf16" else 1e-5
    got = out.float().numpy()
    assert np.abs(got - _np(ref)).max() < tol
    assert np.abs(got - _np(pal)).max() < tol


def test_paged_attention_fully_masked_lane_is_zero():
    """A lane with no valid position gets zeros, as the Pallas kernel
    gives (the reference decode layer would average the gathered rows)."""
    q = torch.randn((2, 4, 16))
    ak = torch.randn((4, 8, 2, 16))
    av = torch.randn((4, 8, 2, 16))
    bt = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    lens = torch.tensor([9, 5], dtype=torch.int32)
    out = pak.paged_attention(q, ak, av, bt, lens)
    assert float(out[1].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0.0
