"""The port's cost model (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU.

* The reference's six tests of ``tests/test_roofline.py`` as parity cases:
  the same numpy inputs go to ``analyze_hlo`` on the jitted JAX function
  and to ``analyze_program`` on its torch twin.  FLOPs within the
  reference's own tolerances (2% unrolled and looped, exact for one dot,
  10% nested); bytes equal to the eager count worked out by hand (XLA's
  fused bytes are another quantity); the terms on the H100's rates by
  FLOP class; the collective split from hand-built records.
* Reduced qwen2-0.5b ``loss`` (``tests/test_dryrun_small.py``'s shape,
  kernels off on both sides): product FLOPs within 1% of the reference's
  trip-aware product count (its layers run in a scan); with the kernels on
  the float32 attention regions price the design's pre-pass and 24*D
  bf16-class products per visible pair, exactly.
* Every wrapper opens one region carrying its kernel's work, and the work
  counts reproduce PERF.md's bound column.
* The twins of ``benchmarks/roofline_table.py`` and ``run.py``.
* ``gpu``: the card's reports equal the CPU's at the reduced config.

JAX is imported inside the fixture that the parity cases use, so the
``gpu`` case also runs where only PyTorch is installed (``--noconftest``).
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:       # chip_smoke.py and benchmarks/
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import marks  # noqa: E402
from repro_torch.analysis.walker import OpShapes, record  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.experiments import roofline_table  # noqa: E402
from repro_torch.experiments import run as prun  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import comms as kern  # noqa: E402
from repro_torch.kernels import rglru_scan as krg  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.roofline import (HW, RooflineReport,  # noqa: E402
                                  analyze_program)
from repro_torch.roofline.op_cost import price  # noqa: E402

F32 = 4


@pytest.fixture(scope="module")
def jx():
    """The reference's cost model and a compile helper."""
    jax = pytest.importorskip("jax")
    from repro.roofline import hlo_cost

    def hlo(f, *args):
        return jax.jit(f).lower(*args).compile().as_text()

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, hlo=hlo,
                                 hlo_cost=hlo_cost)


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flops(f, *arrays):
    return analyze_program("f", f, *map(torch.from_numpy, arrays))


def test_flops_match_the_reference_on_unrolled(jx):
    d = 64
    W, x = _normal(8, d, d), _normal(4, d, seed=1)

    def junrolled(x, W):
        for i in range(8):
            x = jx.jnp.tanh(x @ W[i])
        return x.sum()

    def unrolled(x, W):
        for i in range(8):
            x = torch.tanh(x @ W[i])
        return x.sum()

    ref = jx.hlo_cost.analyze_hlo(jx.hlo(junrolled, x, W)).flops
    rep = _flops(unrolled, x, W)
    assert abs(rep.flops_per_chip - ref) / ref < 0.02
    # eager bytes: each mm reads x and W[i] and writes y, each tanh reads y
    # and writes z (nothing fuses), the sum reads z and writes a scalar
    mm = (4 * d + d * d + 4 * d) * F32
    tanh = 2 * 4 * d * F32
    assert rep.bytes_per_chip == 8 * (mm + tanh) + 4 * d * F32 + F32


def test_loop_is_every_iteration(jx):
    d = 32
    W, x = _normal(16, d, d), _normal(4, d, seed=1)

    def jscanned(x, W):
        def body(x, w):
            return jx.jnp.tanh(x @ w), None
        y, _ = jx.jax.lax.scan(body, x, W)
        return y.sum()

    def loop(x, W):
        for i in range(16):
            x = torch.tanh(x @ W[i])
        return x

    ref = jx.hlo_cost.analyze_hlo(jx.hlo(jscanned, x, W)).flops
    looped = _flops(loop, x, W).flops_per_chip
    one = _flops(lambda x, w: torch.tanh(x @ w), x, W[0]).flops_per_chip
    assert looped == 16 * one
    assert abs(looped - ref) / ref < 0.02
    analytic = 16 * 2 * 4 * d * d
    assert abs(looped - analytic) / analytic < 0.05


def test_dot_flops_exact(jx):
    a, b = _normal(32, 48), _normal(48, 16, seed=1)
    ref = jx.hlo_cost.analyze_hlo(jx.hlo(lambda a, b: a @ b, a, b)).flops
    rep = _flops(lambda a, b: a @ b, a, b)
    assert rep.flops_per_chip == 2 * 32 * 48 * 16
    assert rep.flops_by_class == {"bf16": 0.0, "f32": 2 * 32 * 48 * 16,
                                  "other": 0.0}
    assert ref == pytest.approx(rep.flops_per_chip, rel=0.01)


def test_nested_loop_multiplies(jx):
    d = 16
    W, x = _normal(4, d, d), _normal(2, d, seed=1)

    def jnested(x, W):
        def outer(x, w):
            def inner(x, _):
                return jx.jnp.tanh(x @ w), None
            x, _ = jx.jax.lax.scan(inner, x, None, length=5)
            return x, None
        y, _ = jx.jax.lax.scan(outer, x, W)
        return y.sum()

    def nested(x, W):
        for i in range(4):
            for _ in range(5):
                x = torch.tanh(x @ W[i])
        return x.sum()

    ref = jx.hlo_cost.analyze_hlo(jx.hlo(jnested, x, W)).flops
    mine = _flops(nested, x, W).flops_per_chip
    analytic = 4 * 5 * 2 * 2 * d * d
    assert abs(mine - analytic) / analytic < 0.10
    assert abs(mine - ref) / ref < 0.02


def test_roofline_terms_arithmetic_by_flop_class():
    hw = HW()
    classes = {"bf16": hw.peak_flops, "f32": hw.f32_flops,
               "other": 2 * hw.f32_flops}
    kw = dict(name="x", flops_per_chip=sum(classes.values()),
              bytes_per_chip=hw.hbm_bw, coll_intra=hw.intra_bw,
              coll_cross=hw.cross_bw, coll_by_kind={},
              peak_memory_bytes=None, hw=hw, flops_by_class=classes)
    r = RooflineReport(**kw)
    assert r.compute_s == pytest.approx(4.0)      # 1 + 1 + 2
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)   # 1 s NVLink + 1 s network
    assert r.dominant == "compute" and r.step_s == r.compute_s
    # TF32 on: only the float32 products move, to the TF32 rate
    tf32 = RooflineReport(**kw, tf32=True)
    assert tf32.compute_s == pytest.approx(3.0 + hw.f32_flops
                                           / hw.tf32_flops)
    assert (hw.peak_flops, hw.tf32_flops, hw.f32_flops, hw.hbm_bw,
            hw.intra_bw, hw.cross_bw, hw.hbm_bytes) == (
        989e12, 494.7e12, 67e12, 3.35e12, 450e9, 50e9, 80e9)
    with pytest.raises(ValueError, match="flops_by_class"):
        RooflineReport(**dict(kw, flops_per_chip=1.0))


def test_collective_split_intra_and_cross():
    ops = [
        OpShapes("psum", "collective", (("float32", (4,)),),
                 (("float32", (4,)),), ("pod", "data")),
        OpShapes("pmax", "collective", (("float32", (4,)),),
                 (("float32", (4,)),), ("data",)),
        OpShapes("all_gather", "collective", (("int32", (2, 3)),),
                 (("int32", (8, 3)),), ("data",)),
    ]
    c = price(ops, top_axis="pod")
    assert (c.coll_cross, c.coll_intra) == (16, 16 + 96)
    assert c.coll_by_kind["all-reduce"] == 32
    assert c.coll_by_kind["all-gather"] == 96
    assert c.bytes == 0 and sum(c.flops.values()) == 0
    # the recorder keeps a collective's result: all_gather's gathered size
    t = torch.ones((2, 3), dtype=torch.int32)

    def gather(t):
        with marks.collective("all_gather", ("pod", "data"), t, 4):
            return torch.cat([t] * 4)

    op, = [o for o in record(gather, t).ops if o.kind == "collective"]
    assert op.results == (("int32", (8, 3)),)
    assert price([op]).coll_cross == 96


def _qwen2_reduced(**kw):
    """tests/test_dryrun_small.py's model: reduced qwen2-0.5b at 4 heads
    over 2 of 32 (what ``reduced`` gives), float32."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              num_heads=4, num_kv_heads=2, head_dim=32, **kw)
    assert cfg == dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                                      **kw)
    return cfg


def _tokens(cfg, b=2, s=32):
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "targets": tok[:, 1:].astype(np.int32)}


def _port_loss(cfg, batch):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return analyze_program("loss", model.loss, params,
                           {k: torch.from_numpy(v) for k, v in batch.items()})


def test_reduced_qwen2_loss_products_match_the_reference(jx, monkeypatch):
    """The reference scans its layers: its trip-aware count against eager
    unrolling.  Products only: XLA and aten break elementwise work such
    as tanh-GELU or the softmax into different pieces, so those counts are
    not compared."""
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild
    cfg = _qwen2_reduced()
    jcfg = dataclasses.replace(jreduced(jget("qwen2-0.5b")), num_heads=4,
                               num_kv_heads=2, head_dim=32)
    assert (jcfg.num_layers, jcfg.d_model, jcfg.d_ff, jcfg.vocab_size) == (
        cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
    batch = _tokens(cfg)
    jm = jbuild(jcfg)
    p0 = jx.jax.eval_shape(lambda: jm.init(jx.jax.random.PRNGKey(0)))
    text = jx.jax.jit(jm.loss).lower(
        p0, {k: jx.jnp.asarray(v) for k, v in batch.items()}).compile() \
        .as_text()
    monkeypatch.setattr(jx.hlo_cost, "_ELEMENTWISE", set())
    monkeypatch.setattr(jx.hlo_cost, "_REDUCE_LIKE", set())
    ref = jx.hlo_cost.analyze_hlo(text).flops
    rep = _port_loss(cfg, batch)
    products = rep.flops_by_class["f32"] + rep.flops_by_class["bf16"]
    assert abs(products - ref) / ref < 0.01


def test_kernel_regions_price_visible_pairs():
    """Kernels on (on the CPU the plain version runs inside each region),
    float32: the float32 product FLOPs are the kernels-off count less
    every attention product (Q.K^T and P.V over all S x S pairs, the
    masked ones included), exactly, and the regions' bf16-class products
    are the design's 24*D per visible pair per query head."""
    cfg = _qwen2_reduced()
    assert cfg.dtype == "float32"
    batch = _tokens(cfg)
    off = _port_loss(cfg, batch)
    on = _port_loss(dataclasses.replace(cfg, use_kernels=True), batch)
    b, s = batch["tokens"].shape
    per_layer = 4 * cfg.d_head * b * cfg.num_heads * s * s
    visible = kattn.visible_pairs(s, s, True, None)
    assert off.regions == {}
    assert on.regions == {"flash_attention": cfg.num_layers}
    assert off.flops_by_class["f32"] - on.flops_by_class["f32"] == \
        cfg.num_layers * per_layer
    assert on.flops_by_class["bf16"] - off.flops_by_class.get("bf16", 0) \
        == cfg.num_layers * 24 * cfg.d_head * b * cfg.num_heads * visible


def _randn(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0),
                       dtype=dtype)


# name -> (the wrapper, its inputs on the CPU, the work it must carry)
REGION_CASES = {
    "int8_quantize": (
        kern.int8_quantize, lambda: ((_randn(3, 600),), {}),
        lambda: kern.int8_quantize_work(3, 600, 256)),
    "int8_dequantize": (
        kern.int8_dequantize,
        lambda: ((torch.ones(3, 600, dtype=torch.int8), torch.ones(3, 3)),
                 {}),
        lambda: kern.int8_dequantize_work(3, 600, 256)),
    "int8_scale_quantize": (
        kern.int8_scale_quantize,
        lambda: ((_randn(3, 600), torch.ones(3, 3)), {}),
        lambda: kern.int8_scale_quantize_work(3, 600, 256)),
    "sign_pack": (
        kern.sign_pack, lambda: ((_randn(2, 1500),), {"block": 1024}),
        lambda: kern.sign_pack_work(2, 1500, 1024)),
    "sign_unpack": (
        kern.sign_unpack,
        lambda: ((torch.zeros(2, 256, dtype=torch.uint8), torch.ones(2, 2)),
                 {"size": 1500, "block": 1024}),
        lambda: kern.sign_unpack_work(2, 1500, 1024)),
    "topk_decode_reduce": (
        kern.topk_decode_reduce,
        lambda: ((_randn(3, 5), torch.arange(15, dtype=torch.int32).reshape(
            3, 5)), {"size": 40}),
        lambda: kern.topk_decode_reduce_work(3, 5, 40)),
    "flash_attention": (
        kattn.flash_attention,
        lambda: ((_randn(1, 20, 4, 32, dtype=torch.bfloat16),
                  *[_randn(1, 20, 2, 32, dtype=torch.bfloat16)] * 2),
                 {"window": 6}),
        lambda: kattn.flash_attention_work(1, 20, 20, 4, 2, 32,
                                           torch.bfloat16, True, 6)),
    "ssd_scan": (
        kssd.ssd_scan,
        lambda: ((_randn(1, 20, 2, 4), torch.rand(1, 20, 2), -torch.ones(2),
                  _randn(1, 20, 3), _randn(1, 20, 3)), {"chunk": 8}),
        lambda: kssd.ssd_scan_work(1, 20, 2, 4, 3, 8, torch.float32)),
    "rglru_scan": (
        krg.rglru_scan,
        lambda: ((torch.rand(2, 7, 5), _randn(2, 7, 5)), {}),
        lambda: krg.rglru_scan_work(2, 7, 5)),
}


@pytest.mark.parametrize("name", sorted(REGION_CASES))
def test_every_wrapper_is_one_region_with_its_work(name):
    wrapper, inputs, work = REGION_CASES[name]
    args, kwargs = inputs()
    summary = record(wrapper, *args, **kwargs)
    assert summary.kernels == (name,)
    # the plain version's outputs in the kernel's contiguous layout: the
    # ops after the region must be the same on either device
    out = wrapper(*args, **kwargs)
    assert all(t.is_contiguous() for t in
               (out if isinstance(out, tuple) else (out,)))
    # one op: the region with its work; nothing of the plain version
    # inside it is priced
    assert [(o.kind, o.primitive, o.work) for o in summary.ops] == [
        ("kernel", name, work())]


@pytest.mark.parametrize("key", sorted(chip_smoke.KERNEL_BOUNDS_MS))
def test_work_counts_give_perf_md_bounds(key):
    got = chip_smoke.kernel_bounds_ms(torch, kern, kattn, kssd, krg)[key]
    assert abs(got - chip_smoke.KERNEL_BOUNDS_MS[key]) <= 5e-5


def _record():
    """One hand-built record of the dry-run cache's format: a train pair
    whose global-sync step peaks at 20 GB (above a v5e's 16, below an
    H100's 80)."""
    def step(c, m, k, peak):
        return {"compute_s": c, "memory_s": m, "collective_s": k,
                "peak_memory_bytes": peak}
    return {"qwen2-0.5b|train_4k|single": {
        "steps": {"local": step(1.0, 2.0, 0.0, 10e9),
                  "global_sync": step(1.0, 2.0, 3.0, 20e9)},
        "terms_s": {"compute": 1.0, "memory": 2.0, "collective": 3.0},
        "dominant": "collective", "useful_ratio": 0.5,
        "mapping": "replica", "n_workers": 16,
        "amortized": {"compute_s": 1.0, "memory_s": 2.0,
                      "collective_s": 0.5, "dominant": "memory_s"}}}


def test_roofline_table_rows_equal_the_reference():
    from benchmarks import roofline_table as jtable
    want, = jtable.rows(_record())
    got, = roofline_table.rows(_record())
    assert want.pop("fits_hbm") is False and got.pop("fits_hbm") is True
    assert got == want
    assert roofline_table.HBM_PER_CHIP == 80e9


def test_roofline_table_save_load_and_refusal(tmp_path):
    path = tmp_path / "build" / "dryrun_torch.json"
    roofline_table.save(_record(), str(path))
    assert roofline_table.load(str(path)) == _record()
    assert len(roofline_table.main(path=str(path))) == 1
    with pytest.raises(ValueError, match="dryrun.json"):
        roofline_table.save(_record(), str(tmp_path / "dryrun.json"))


def test_run_only_roofline_table_without_a_cache(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    summary = prun.main(["--only", "roofline_table", "--device", "cpu"])
    assert [(name, derived) for name, _, derived in summary] == [
        ("roofline_table", [])]
    out = capsys.readouterr().out
    assert "no dry-run cache" in out and "roofline_table," in out


@pytest.mark.gpu
def test_card_reports_equal_the_cpu_reports():
    """At the reduced config (TRAIN_ARGV with ROOFLINE_REDUCED) the three
    step kinds and ``loss`` with the kernels price the same on the card
    (kernels launched) as on the CPU (plain versions inside the regions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    card = chip_smoke.reduced_reports("cuda")
    assert card == chip_smoke.reduced_reports("cpu")
    assert {k: regions for k, (_, _, regions) in card.items()} == {
        "local": {}, "local_sync": {"int8_scale_quantize": 1},
        "global_sync": {"int8_scale_quantize": 1},
        "loss": {"flash_attention": 2}}
