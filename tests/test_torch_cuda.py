"""The port's CUDA kernels against their plain versions, on the card.
Marked ``cuda``: they skip where no CUDA device is present.  On the
H100 run them with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kv_update import kernel as kvk  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pak  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kv_update_kernel_bit_equal(dev, dt):
    g = torch.Generator(device=dev).manual_seed(0)
    B, K, dh, pages, page = 8, 8, 128, 17, 16
    ak = torch.randn((pages, page, K, dh), generator=g, device=dev).to(dt)
    av = torch.randn((pages, page, K, dh), generator=g, device=dev).to(dt)
    kn = torch.randn((B, K, dh), generator=g, device=dev).to(dt)
    vn = torch.randn((B, K, dh), generator=g, device=dev).to(dt)
    pids = torch.tensor([0, 3, -1, 5, 7, 9, 11, 2], dtype=torch.int32,
                        device=dev)
    slots = torch.tensor([1, 15, 0, 7, 3, 3, 9, 0], dtype=torch.int32,
                         device=dev)
    rk, rv = ak.clone(), av.clone()
    kvk.kv_update_plain(rk, rv, kn, vn, pids, slots)
    n = kvk.launches
    kvk.kv_update(ak, av, kn, vn, pids, slots)
    torch.cuda.synchronize()
    assert kvk.launches == n + 1
    assert torch.equal(ak, rk) and torch.equal(av, rv)


@pytest.mark.parametrize("B,H,K,pages,page,P,dh,dt,win", [
    (2, 4, 2, 16, 16, 4, 64, torch.float32, 0),
    (2, 8, 1, 16, 32, 3, 128, torch.bfloat16, 0),
    (1, 4, 4, 8, 16, 2, 64, torch.float32, 24),
    (3, 8, 2, 24, 8, 6, 128, torch.float32, 0),
    (8, 40, 8, 83, 128, 8, 128, torch.bfloat16, 0),
    (8, 40, 8, 83, 128, 8, 128, torch.bfloat16, 200),
])
def test_paged_attention_kernel_vs_plain(dev, B, H, K, pages, page, P, dh,
                                         dt, win):
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn((B, H, dh), generator=g).to(dt).to(dev)
    ak = torch.randn((pages, page, K, dh), generator=g).to(dt).to(dev)
    av = torch.randn((pages, page, K, dh), generator=g).to(dt).to(dev)
    bt = torch.full((B, P), -1, dtype=torch.int32)
    lens = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        n = int(torch.randint(1, P * page, (1,), generator=g))
        lens[b] = n
        need = -(-n // page)
        bt[b, :need] = torch.randperm(pages - 1, generator=g)[:need]
    bt, lens = bt.to(dev), lens.to(dev)
    want = pak.paged_attention_plain(q, ak, av, bt, lens, window=win)
    got = pak.paged_attention(q, ak, av, bt, lens, window=win)
    torch.cuda.synchronize()
    tol = 3e-2 if dt == torch.bfloat16 else 1e-5
    assert float((got.float() - want.float()).abs().max()) < tol


def test_decode_tokens_match_cpu(dev):
    """fp32 smoke model: the decode step on the card (kernels) and on the
    CPU (plain versions) emit the same greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import decode as dec
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                              dtype=torch.float32, page_size=8)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        return tree.to(d)

    states = {}
    for d in ("cpu", "cuda"):
        st = dec.make_dstate(cfg, batch=2, max_seq=64, device=d)
        st["block_table"] = torch.arange(16, dtype=torch.int32,
                                         device=d).reshape(2, 8)
        states[d] = (st, to(cpu, d))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    for t in range(20):
        outs = {}
        for d, (st, p) in states.items():
            _, tok, lg = dec.decode_step(cfg, p, st, toks[:, t].to(d),
                                         return_logits=True)
            outs[d] = (tok.cpu(), lg.cpu())
        assert torch.equal(outs["cpu"][0], outs["cuda"][0])
        assert float((outs["cpu"][1] - outs["cuda"][1]).abs().max()) < 1e-3
