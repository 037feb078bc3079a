"""The port's roofline (``repro_torch.launch.roofline``) and meshes: the
algebra and ``parse_collectives`` equal the reference's (with the
reference's v5e figures patched in), the H100 figures, and ``trace_cost``'s
FLOPs, bytes and peak memory exactly on functions with known answers; the
flash op's FLOP formula against a brute-force count; a fake trace launches
nothing."""
import itertools

import numpy as np
import pytest
import torch

from repro.launch import roofline as jroof
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import roofline as roof

HLO = """
  %ar = f32[1024,16]{1,0} all-reduce(%x), channel_id=1, replica_groups=[16,16]<=[256]
  %ag = bf16[512,128]{1,0} all-gather(%y), channel_id=2, replica_groups=[2,8]<=[16]
  %rs = f32[64]{0} reduce-scatter(%z), channel_id=3, replica_groups=[1,4]<=[4]
  %cp = f32[32,32]{1,0} collective-permute(%w), channel_id=4
  %a2 = (s32[8,4]{1,0}) all-to-all-start(%v), replica_groups={{0,1,2,3}}
  %ar2 = bf16[7]{0} all-reduce(%u), replica_groups={{0,1}}
  %no = f32[4]{0} add(%p, %q)
"""


def _random_hlo(rng):
    ops = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute"]
    lines = []
    for i in range(int(rng.integers(1, 12))):
        dt = rng.choice(["f32", "bf16", "s8", "f64", "u16"])
        dims = ",".join(str(int(d)) for d in rng.integers(1, 300,
                                                          int(rng.integers(0, 4))))
        op = rng.choice(ops)
        g = int(rng.integers(1, 64))
        groups = (f"replica_groups=[{int(rng.integers(1, 8))},{g}]<=[{g}]"
                  if rng.uniform() < 0.5 else
                  "replica_groups={{" + ",".join(map(str, range(g))) + "}}")
        start = "-start" if rng.uniform() < 0.3 else ""
        lines.append(f"  %c{i} = {dt}[{dims}]{{0}} {op}{start}(%x{i}), {groups}")
    return "\n".join(lines)


def _stats(st):
    return (st.counts, st.link_bytes, st.raw_bytes, st.by_op)


@pytest.mark.parametrize("seed", [None] + list(range(8)))
def test_parse_collectives_equals_the_reference(seed):
    text = HLO if seed is None else _random_hlo(np.random.default_rng(seed))
    assert _stats(roof.parse_collectives(text)) == \
        _stats(jroof.parse_collectives(text))


def _pair(a):
    flops, nbytes, counts, link, raw, by_op = a
    return (roof.GraphCost(flops, nbytes, roof.CollectiveStats(
                dict(counts), link, raw, dict(by_op))),
            jroof.GraphCost(flops, nbytes, jroof.CollectiveStats(
                dict(counts), link, raw, dict(by_op))))


def _cost(c):
    return (c.flops, c.bytes_accessed) + _stats(c.collectives)


@pytest.fixture
def v5e(monkeypatch):
    """The reference's v5e figures in the port's roofline, for comparing
    the algebra on equal terms."""
    monkeypatch.setattr(roof, "PEAK_FLOPS_BF16", 197e12)
    monkeypatch.setattr(roof, "HBM_BW", 819e9)
    monkeypatch.setattr(roof, "LINK_BW", 50e9)


@pytest.mark.parametrize("seed", range(6))
def test_graphcost_and_roofline_equal_the_reference(v5e, seed):
    rng = np.random.default_rng(seed)

    def draw():
        ops = ["all-reduce", "all-gather"][:int(rng.integers(0, 3))]
        return (float(rng.uniform(0, 1e15)), float(rng.uniform(0, 1e12)),
                {o: int(rng.integers(1, 5)) for o in ops},
                float(rng.uniform(0, 1e10)), float(rng.uniform(0, 1e10)),
                {o: float(rng.uniform(0, 1e9)) for o in ops})
    (a, ja), (b, jb) = _pair(draw()), _pair(draw())
    k = float(rng.uniform(0, 5))
    assert _cost((a + b).scaled(k)) == _cost((ja + jb).scaled(k))
    assert _cost(a.scaled(-1.0) + b) == _cost(ja.scaled(-1.0) + jb)
    n_dev = int(rng.integers(1, 512))
    mf = float(rng.uniform(0, 1e18))
    assert roof.roofline_terms(a + b, n_dev, mf).as_dict() == \
        jroof.roofline_terms(ja + jb, n_dev, mf).as_dict()
    for kind in ("train", "prefill", "decode"):
        args = (None, int(rng.integers(1, 9999)), int(rng.integers(1, 999)),
                kind, int(rng.integers(1, 10 ** 9)),
                int(rng.integers(1, 10 ** 9)))
        assert roof.analytic_model_flops(*args) == \
            jroof.analytic_model_flops(*args)


def test_the_reference_tests_inputs(v5e):
    """``tests/test_roofline.py``'s bottleneck and algebra cases."""
    g = roof.GraphCost(1e12, 1e9, roof.CollectiveStats(link_bytes=1e6))
    r = roof.roofline_terms(g, n_devices=256, model_flops=2e14)
    assert r.bottleneck == "compute"
    assert r.compute_s == pytest.approx(1e12 / 197e12)
    assert 0 < r.mfu_bound <= 1.0
    g2 = roof.GraphCost(1e9, 1e12, roof.CollectiveStats(link_bytes=1e6))
    assert roof.roofline_terms(g2, 256, 1e12).bottleneck == "memory"
    a = roof.GraphCost(1.0, 2.0, roof.CollectiveStats(
        {"all-reduce": 1}, 10.0, 12.0, {"all-reduce": 10.0}))
    b = (a + a).scaled(2.0)
    assert b.flops == 4.0 and b.bytes_accessed == 8.0
    assert b.collectives.link_bytes == 40.0
    assert b.collectives.by_op["all-reduce"] == 40.0


def test_h100_figures_and_meshes():
    assert (port_mesh.PEAK_FLOPS_BF16, port_mesh.HBM_BW, port_mesh.HBM_BYTES,
            port_mesh.LINK_BW) == (989e12, 3.35e12, 80e9, 450e9)
    assert roof.PEAK_FLOPS_BF16 == 989e12 and roof.HBM_BW == 3.35e12
    r = roof.roofline_terms(roof.GraphCost(989e12, 3.35e12 / 2), 1, 989e12)
    assert (r.compute_s, r.memory_s, r.bottleneck, r.mfu_bound) == \
        (1.0, 0.5, "compute", 1.0)
    single = port_mesh.make_production_mesh()
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.size) == \
        ((32, 8), ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == \
        ((2, 32, 8), ("pod", "data", "model"), 512)
    host = port_mesh.make_host_mesh(model=4, device="cpu")
    assert (host.shape, host.devices) == ((1, 1), (torch.device("cpu"),))
    assert host.axis_sizes() == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_mesh.make_host_mesh()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_trace_cost_counts_a_chain_of_products_exactly():
    def chain(a, b, c, w):
        h = a @ b                                  # 2·32·64·16
        h = torch.bmm(h.expand(3, 32, 16), c)      # 3 · 2·32·16·8
        return torch.addmm(w, h[0], c[0].T)        # 2·32·8·16
    cost, _ = roof.trace_cost(chain, _meta(32, 64), _meta(64, 16),
                              _meta(3, 16, 8), _meta(32, 16))
    assert cost.flops == 2 * 32 * 64 * 16 + 3 * 2 * 32 * 16 * 8 \
        + 2 * 32 * 8 * 16
    assert cost.collectives.counts == {} and cost.collectives.link_bytes == 0


def test_trace_cost_counts_bytes_exactly_and_views_as_zero():
    def ops(x, y):
        v = x.t()                  # view: 0
        s = v[1:]                  # view: 0
        r = x.view(-1)[8:]         # views: 0
        z = s + y                  # reads 2·(7·8·4), writes 7·8·4
        z.mul_(2.0)                # in place: reads and writes 7·8·4
        w = s.reshape(-1)          # not contiguous: a copy, 7·8·4 each way
        return z.sum(), r, w       # reads 7·8·4, writes 4
    x, y = _meta(8, 8), _meta(7, 8)
    cost, mem = roof.trace_cost(lambda x, y: ops(x.contiguous(), y), x, y)
    tile = 7 * 8 * 4
    assert cost.bytes_accessed == 3 * tile + 2 * tile + 2 * tile + tile + 4
    assert cost.flops == 0
    assert mem["args_bytes"] == 8 * 8 * 4 + tile


def test_trace_cost_peak_of_a_known_allocation_sequence():
    def seq(x):                                    # x: 1000 f32 = 4000 B
        a = torch.empty(2000, device=x.device)     # 8000 live: 12 000
        b = a[:1000] + x                           # +4000: 16 000
        del a                                      # -8000: 8000
        c = torch.cat([b, b])                      # +8000: 16 000
        d = c * 2                                  # +8000: 24 000 (peak)
        del c
        return d, b.view(10, 100)                  # 4000 + 8000 + 4000
    cost, mem = roof.trace_cost(seq, _meta(1000))
    assert mem == {"args_bytes": 4000, "output_bytes": 12000,
                   "peak_bytes": 24000, "temp_bytes": 24000 - 4000 - 12000}


def _brute_pairs(T, S, causal, window, q_offset):
    n = 0
    for t, s in itertools.product(range(T), range(S)):
        rel = q_offset + t - s
        n += (not causal or rel >= 0) and (window <= 0 or rel < window)
    return n


FLOP_CASES = [  # (B, T, S, H, Hkv, D, causal, window, q_offset)
    (1, 17, 17, 2, 1, 16, True, 0, 0),
    (2, 33, 33, 4, 2, 32, True, 8, 0),
    (1, 20, 45, 2, 2, 16, True, 0, 25),
    (1, 20, 45, 2, 2, 16, True, 7, 25),
    (3, 19, 31, 4, 4, 64, False, 0, 0),
    (1, 23, 40, 2, 1, 16, False, 5, 0),
    (1, 9, 60, 8, 2, 32, True, 16, 51),
]


@pytest.mark.parametrize("case", FLOP_CASES)
def test_flash_flop_formula_counts_the_valid_pairs(case):
    B, T, S, H, Hkv, D, causal, window, q_offset = case
    pairs = _brute_pairs(T, S, causal, window, q_offset)
    assert flash.valid_pairs(T, S, causal, window, q_offset) == pairs
    cost, mem = roof.trace_cost(
        lambda q, k, v: flash.flash_attention(q, k, v, causal=causal,
                                              window=window,
                                              q_offset=q_offset),
        _meta(B, T, H, D, dtype=torch.bfloat16),
        _meta(B, S, Hkv, D, dtype=torch.bfloat16),
        _meta(B, S, Hkv, D, dtype=torch.bfloat16))
    assert cost.flops == 4 * D * B * H * pairs
    assert mem["output_bytes"] == B * T * H * D * 2


def test_the_fake_trace_launches_nothing(monkeypatch):
    """A model's prefill traced through the flash op: its fake
    implementation runs, no kernel, and CUDA is never initialised."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    def refuse(*a, **k):
        raise AssertionError("a kernel was launched")
    monkeypatch.setattr(flash, "launch", refuse)
    monkeypatch.setattr(flash, "flash_attention_plain", refuse)
    before = (flash.launches, flash.backward_plain_calls)
    model = build_model(get_config("llama3.2-1b").reduced())
    batch = model.input_specs(64, 2, "prefill")
    cost, _ = roof.trace_cost(
        lambda p, b: model.prefill(p, b), model.abstract_params(), batch)
    assert cost.flops > 0
    assert (flash.launches, flash.backward_plain_calls) == before
    assert not torch.cuda.is_initialized()
