"""The port's comm ledger, work counter, kernel costs, roofline and dry
run, on the CPU.

* ``train_step_ledger`` equal to the JAX package's over a grid of rings,
  rows, widths, heads, backends, micro-batches and trunks;
* the collectives of real hybrid train steps, counted at the ``dist``
  wrappers on one spawned gloo ring of 4 for (full, knn) x (ref, kernel)
  at n_micro 1 and 2 and for the cnn trunk (whose gradient exchange the
  ledger charges), each member's equal to the ledger and to the count of
  the same step on the simulated ring of 4 (meta tensors);
* the kernels' cost functions: their bounds equal the figures of
  ``PERF.md``'s two kernel tables to the printed digits;
* the work counter: the same FLOPs, bytes and kernel charges for a step
  on CPU and on meta tensors; what it counts of a product;
* ``active_params`` and ``model_flops`` equal to the JAX package's for
  every arch id and input shape at full size; ``analyze_record``,
  ``to_markdown`` and the report on hand-made records;
* ``lower_paper_one`` at 10**8 classes on a ring of 256 in seconds, its
  argument bytes the sum by hand; ``lower_one`` on the ring, and its
  refusal of the production meshes.
"""
import functools
import json
import time

import pytest
import torch

from repro.roofline import analysis as janalysis
from repro.configs import base as jbase
from repro.telemetry import ledger as jledger
from repro_torch import dist, testing
from repro_torch.configs import base as tbase
from repro_torch.kernels import ce_softmax as ce
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ivf_rerank as ivf
from repro_torch.kernels import knn_dist_topk as dk
from repro_torch.kernels import sparse_ce as sp
from repro_torch.kernels import topk_dc as dc
from repro_torch.kernels.cost import as_fp32_fma, bound_ms
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import report as treport
from repro_torch.roofline.counter import WorkCounter
from repro_torch.telemetry import ledger as tledger
from tests.torch_threads import one_thread  # noqa: F401

RING = 4
CLASSES, BATCH, FEAT, HW = 64, 16, 16, 32
STEP_CASES = ([("feats", h, b, m) for h in ("full", "knn")
               for b in ("ref", "kernel") for m in (1, 2)]
              + [("cnn", "full", "ref", 1), ("cnn", "knn", "kernel", 2)])


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def _grid():
    for n_dev in (1, 4, 8):
        for rows, feat in ((256, 64), (4096, 512)):
            for head in ("full", "knn"):
                for backend in ("ref", "kernel"):
                    for n_micro in (1, 2, 4):
                        for fe in (0, 12345):
                            yield n_dev, rows, feat, head, backend, n_micro, fe


def test_train_step_ledger_is_the_jax_packages():
    """Every kind's bytes and count, and every entry, over the grid (the
    port's ``"kernel"`` is the JAX package's ``"pallas"``)."""
    assert tledger.LEDGER_HEADS == jledger.LEDGER_HEADS
    n = 0
    for n_dev, rows, feat, head, backend, n_micro, fe in _grid():
        kw = dict(n_dev=n_dev, rows=rows, feat_dim=feat, head=head,
                  n_micro=n_micro, fe_param_count=fe)
        port = tledger.train_step_ledger(backend=backend, **kw)
        ref = jledger.train_step_ledger(
            backend="pallas" if backend == "kernel" else "ref", **kw)
        assert port.per_kind() == ref.per_kind()
        assert ([(e.kind, e.bytes, e.count) for e in port.entries]
                == [(e.kind, e.bytes, e.count) for e in ref.entries])
        n += 1
    assert n == 144
    with pytest.raises(ValueError, match="ledger models heads"):
        tledger.train_step_ledger(n_dev=2, rows=8, feat_dim=4, head="mach")
    with pytest.raises(ValueError, match="not divisible"):
        tledger.train_step_ledger(n_dev=2, rows=9, feat_dim=4, n_micro=2)


def _feat(trunk):
    from repro_torch.api.experiment import paper_model_config
    return paper_model_config(trunk, CLASSES, FEAT).d_model


def _simulated(case):
    trunk, head, backend, n_micro = case
    return dryrun.lower_paper_one(
        classes=CLASSES, head=head, backend=backend, batch=BATCH,
        feat_dim=FEAT, n_micro=n_micro, n_dev=RING, trunk=trunk,
        image_size=HW)


@pytest.fixture(scope="module")
def ring_counts():
    """Each case's collectives on every member of one spawned gloo ring
    of 4."""
    per_rank = dist.spawn_ring(
        testing.run_all, RING,
        [("step_collectives", (STEP_CASES,),
          dict(classes=CLASSES, batch=BATCH, feat_dim=FEAT, hw=HW))])
    return [r[0] for r in per_rank]


@pytest.mark.parametrize("i", range(len(STEP_CASES)),
                         ids=lambda i: "-".join(map(str, STEP_CASES[i])))
def test_step_collectives_equal_the_ledger(ring_counts, i):
    """The bytes and counts a real step moves, by kind, on every member
    of the ring of 4, equal the simulated ring's count of the same step;
    their bytes equal the ledger's (the ledger's counts are the JAX
    program's, which merges the exchange's per-leaf all-reduces)."""
    case = STEP_CASES[i]
    sim = _simulated(case)
    assert sim["ledger_divergence"] == []
    ledger = tledger.CommLedger()
    ledger.entries = [tledger.Collective(k, k, v["bytes"], v["count"])
                      for k, v in sim["ledger"].items() if k != "total_bytes"]
    for member in ring_counts:
        counts = member[i]
        assert counts == sim["collectives"]
        assert ledger.compare(counts, rtol=0.0) == []
        assert counts["total_bytes"] == sim["ledger"]["total_bytes"]
    if case[0] == "cnn":
        assert sim["collectives"]["reduce-scatter"]["bytes"] == (
            BATCH * _feat("cnn") * 4 // RING)
    else:
        assert "reduce-scatter" not in sim["collectives"]


# ---------------------------------------------------------------------------
# the kernels' costs against PERF.md's tables
# ---------------------------------------------------------------------------

V, D = 1_020_250, 512
# (cost, the bound as PERF.md prints it): its two kernel tables, the
# paper's 1M-class shapes and the zoo's
BOUNDS = [
    (ce.forward_cost(256, V, D), "1.622"),
    (ce.forward_cost(128, V, D), "0.811"),
    (ce.forward_cost(64, V, D), "0.624"),
    (ce.forward_cost(256, 63_765, D), "0.101"),
    (as_fp32_fma(ce.forward_cost(256, V, D)), "3.992"),
    (as_fp32_fma(ce.forward_cost(64, V, D)), "0.998"),
    (ce.backward_cost(256, V, D), "4.866"),
    (ce.backward_cost(128, V, D), "2.433"),
    (ce.backward_cost(256, 63_765, D), "0.304"),
    (as_fp32_fma(ce.backward_cost(256, V, D)), "11.975"),
    (sp.forward_cost(256, 102_025, D), "0.162"),
    (as_fp32_fma(sp.forward_cost(256, 102_025, D)), "0.399"),
    (sp.backward_cost(256, 102_025, V, D), "0.687"),
    (as_fp32_fma(sp.backward_cost(256, 102_025, V, D)), "1.198"),
    (dk.cost(V, V, D, 32), "1077.7"),
    (dk.cost(16_896, V, D, 32), "17.85"),
    (dc.cost(64, V, 5, 2048), "0.078"),
    (fa.cost(72, 2000, 2000, 64, 2, 24), "0.0373"),
    (ce.forward_cost(8192, 49_152, 576), "2.813"),
    (ce.forward_cost(8192, 3072, 576), "0.176"),
    (ce.forward_cost(2048, 50_280, 1024), "1.279"),
    (ce.forward_cost(2048, 32_001, 1600), "1.272"),
    (ce.forward_cost(8192, 151_936, 2048), "30.92"),
    (ce.forward_cost(8192, 65_536, 8192), "53.34"),
    (ce.forward_cost(7168, 51_865, 384), "1.731"),
    (ce.backward_cost(8192, 49_152, 576), "8.439"),
    (ce.backward_cost(8192, 3072, 576), "0.527"),
    (ce.backward_cost(2048, 50_280, 1024), "3.837"),
    (ce.backward_cost(2048, 32_001, 1600), "3.815"),
    (ce.backward_cost(8192, 151_936, 2048), "92.75"),
    (ce.backward_cost(8192, 65_536, 8192), "160.03"),
    (ce.backward_cost(7168, 51_865, 384), "5.194"),
    (sp.forward_cost(8192, 4915, 576), "0.281"),
    (sp.forward_cost(1024, 3200, 1600), "0.064"),
    (sp.forward_cost(1024, 15_193, 2048), "0.386"),
    (sp.forward_cost(1024, 6553, 8192), "0.667"),
    (sp.forward_cost(896, 5186, 384), "0.022"),
    (sp.backward_cost(8192, 4915, 49_152, 576), "0.844"),
    (sp.backward_cost(1024, 3200, 32_001, 1600), "0.191"),
    (sp.backward_cost(1024, 15_193, 151_936, 2048), "1.159"),
    (sp.backward_cost(1024, 6553, 65_536, 8192), "2.000"),
    (sp.backward_cost(896, 5186, 51_865, 384), "0.065"),
    (dk.cost(49_152, 49_152, 576, 32), "2.814"),
    (dk.cost(32_001, 32_001, 1600, 32), "3.313"),
    (dk.cost(151_936, 151_936, 2048, 32), "95.61"),
    (dk.cost(65_536, 65_536, 8192, 32), "71.15"),
    (dk.cost(51_865, 51_865, 384, 32), "2.089"),
    (dk.cost(16_896, 151_936, 2048, 32), "10.63"),
    (dk.cost(16_896, 151_936, 3072, 32), "15.95"),
    (dk.cost(16_896, 65_536, 8192, 32), "18.34"),
    (dc.cost(64, 49_152, 5, 2048), "0.0038"),
    (dc.cost(64, 32_001, 5, 2048), "0.0025"),
    (dc.cost(64, 151_936, 5, 2048), "0.0117"),
    (dc.cost(64, 65_536, 5, 2048), "0.0050"),
    (dc.cost(64, 51_865, 5, 2048), "0.0040"),
    (ivf.cost(64, 576, 5, 40_073, 85_507, 64 * 6), "0.0276"),
    (ivf.cost(64, 1600, 5, 26_824, 57_557, 64 * 6), "0.0514"),
    (ivf.cost(64, 2048, 5, 130_627, 299_474, 64 * 6), "0.320"),
    (ivf.cost(64, 8192, 5, 57_087, 130_874, 64 * 6), "0.559"),
    (ivf.cost(64, 384, 5, 44_344, 101_796, 64 * 6), "0.0204"),
    (fa.cost(144, 512, 512, 64, 2, 48), "0.0075"),
    (fa.cost(200, 2000, 2000, 64, 2, 40, True, 1024), "0.0789"),
    (fa.cost(256, 2000, 2000, 128, 2, 32), "0.265"),
    (fa.cost(512, 2000, 2000, 128, 2, 64), "0.530"),
    (fa.cost(96, 1500, 1500, 64, 2, 96, False), "0.056"),
]


def test_kernel_costs_give_perf_md_bounds():
    """Each cost function's bound, rounded to the digits PERF.md prints,
    is PERF.md's figure: one count of each kernel's work, shared by
    ``chip_smoke.py`` and the roofline counter."""
    for c, printed in BOUNDS:
        ms, _ = bound_ms(c)
        digits = len(printed.split(".")[1])
        assert f"{ms:.{digits}f}" == printed, (c, printed)
    assert fa.valid_pairs(2000, 2000, True, 1024) == 1_524_224
    assert fa.valid_pairs(5, 7, True) == 35


# ---------------------------------------------------------------------------
# the work counter
# ---------------------------------------------------------------------------


def _kernel_step(device):
    """A knn + full kernel-path hybrid step on ``device`` (ring of one)."""
    from repro_torch.api.experiment import paper_model_config
    from repro_torch.api.heads import make_head
    from repro_torch.train import hybrid
    mcfg = paper_model_config("feats", CLASSES, FEAT)
    hcfg = tbase.HeadConfig(softmax_impl="full", backend="kernel")
    tcfg = tbase.TrainConfig(optimizer="sgd")
    h = make_head(mcfg, hcfg)
    w = torch.empty((CLASSES, FEAT), device=device).normal_() \
        if device == "cpu" else torch.empty((CLASSES, FEAT), device=device)
    state = hybrid.HybridState({}, w, (), hybrid.make_optimizer(tcfg).init(
        ({}, w)), None, 0)
    inputs = {"features": torch.zeros((BATCH, FEAT), device=device),
              "labels": torch.zeros((BATCH,), dtype=torch.int32,
                                    device=device)}
    step = hybrid.make_train_step(mcfg, hcfg, tcfg, head=h)
    with WorkCounter() as wc:
        step(state, inputs, 0.1)
    return wc.result()


def test_counter_counts_the_same_on_cpu_and_meta():
    """The kernels are charged by their cost functions, not by what their
    plain versions run on the CPU, so a step counts alike on both."""
    cpu, meta = _kernel_step("cpu"), _kernel_step("meta")
    assert cpu["kernels"] == meta["kernels"]
    assert cpu["kernels"]["ce_forward"]["calls"] == 1
    assert cpu["kernels"]["ce_backward"]["ops"] == (
        ce.backward_cost(BATCH, CLASSES, FEAT).ops)
    assert cpu["counted"] == meta["counted"]
    assert cpu["collectives"] == {"total_bytes": 0.0}


def test_counter_counts_products_and_bytes():
    """mm, bmm and their backward by rate class, bytes of non-view ops,
    and the peak of live storage on meta tensors."""
    a = torch.empty((8, 32), device="meta", requires_grad=True)
    b = torch.empty((32, 4), device="meta", dtype=torch.float32)
    with WorkCounter(track_memory=True) as wc:
        held = wc.hold(a, b)
        assert wc.hold(a) == 0
        (a @ b).sum().backward()
        c = torch.empty((3, 5, 7), dtype=torch.bfloat16, device="meta")
        torch.bmm(c, c.transpose(1, 2))
    assert held == (8 * 32 + 32 * 4) * 4
    out = wc.result()["counted"]
    assert out["flops_by_rate"]["fp32"] == 2 * (2 * 8 * 32 * 4)
    assert out["flops_by_rate"]["bf16"] == 2 * 3 * 5 * 7 * 5
    assert wc.peak >= held + 8 * 32 * 4


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------


@pytest.fixture()
def cached_params(monkeypatch):
    """Both packages' ``active_params`` once an arch (``model_flops``
    calls it for every shape)."""
    for mod in (janalysis, tanalysis):
        monkeypatch.setattr(mod, "active_params", functools.lru_cache(None)(
            mod.active_params))


def test_active_params_and_model_flops_are_the_jax_packages(cached_params):
    for arch in tbase.ARCH_IDS:
        tcfg, jcfg = (tbase.get_model_config(arch),
                      jbase.get_model_config(arch))
        assert tanalysis.active_params(tcfg) == janalysis.active_params(jcfg)
        for shape in tbase.INPUT_SHAPES:
            assert (tanalysis.model_flops(tbase.for_shape(
                        tcfg, tbase.INPUT_SHAPES[shape]), shape)
                    == janalysis.model_flops(jbase.for_shape(
                        jcfg, jbase.INPUT_SHAPES[shape]), shape)), (arch,
                                                                    shape)


def _record(**kw):
    rec = {"arch": "smollm_135m", "shape": "train_4k", "mesh": "1x16",
           "counted": {"flops": 2e15, "bytes": 1e12,
                       "flops_by_rate": {"bf16": 1.978e15, "fp32": 6.7e12,
                                         "tf32": 1.5e13}},
           "collectives": {"total_bytes": 4.5e9},
           "memory": {"argument_bytes": 10 * 2**30,
                      "peak_bytes": 60 * 2**30}}
    rec.update(kw)
    return rec


def test_analyze_record_and_markdown(tmp_path, capsys):
    """The three terms at the H100's rates, the dominant one, the useful
    share against the arch's MODEL_FLOPS, the peak and whether it fits
    80 GB; the table and the report CLI over a results file."""
    row = tanalysis.analyze_record(_record())
    assert row.n_chips == 16
    assert row.compute_s == pytest.approx(2.0 + 0.1 + 1.5e13 / 494.7e12)
    assert row.memory_s == pytest.approx(1e12 / 3.35e12)
    assert row.collective_s == pytest.approx(0.01)
    assert row.dominant == "compute"
    cfg = tbase.get_model_config("smollm_135m")
    assert row.useful_ratio == pytest.approx(
        tanalysis.model_flops(cfg, "train_4k") / (2e15 * 16))
    assert row.peak_gib == pytest.approx(60.0) and row.fits
    big = tanalysis.analyze_record(_record(
        mesh="256", model_flops=1e18, memory={"argument_bytes": 90e9}))
    assert big.n_chips == 256 and not big.fits
    assert big.useful_ratio == pytest.approx(1e18 / (2e15 * 256))
    assert tanalysis.analyze_record({"error": "x"}) is None
    coll = tanalysis.analyze_record(_record(collectives={"total_bytes":
                                                         4.5e12}))
    assert coll.dominant == "collective"
    assert "collective-bound" in tanalysis.bottleneck_sentence(coll)
    md = tanalysis.to_markdown([row, coll],
                               hillclimbed={("smollm_135m", "train_4k")})
    assert "**(hillclimbed)**" in md and "fits 80 GB" in md
    assert md.count("\n") == 3
    path = tmp_path / "dry.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in (
        _record(), _record(), {"arch": "gemma_2b", "error": "x"},
        _record(mesh="2x16x16"))) + "\n")
    assert len(tanalysis.load_rows(str(path))) == 2
    assert len(tanalysis.load_rows(str(path), mesh="1x16")) == 1
    assert treport.main([str(path)]) == 0
    assert "compute-bound: 2 combos" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_lower_paper_one_at_1e8_classes_on_256():
    """The simulated 100M-class step of one member of 256 runs on the CPU
    in seconds, allocates nothing, and its arguments are W's block and its
    momentum (390,625 x 64 fp32 each) plus the global batch; no
    divergence from the ledger, on either backend and for knn."""
    t0 = time.perf_counter()
    rec = dryrun.lower_paper_one(classes=10**8, n_dev=256)
    assert time.perf_counter() - t0 < 30
    v_loc = 10**8 // 256
    assert rec["memory"]["argument_bytes"] == (2 * v_loc * 64 * 4
                                               + 256 * 64 * 4 + 256 * 4)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["ledger_divergence"] == []
    assert rec["ledger"]["all-gather"]["bytes"] == 256 * 64 * 4 + 256 * 4
    assert rec["counted"]["flops"] == 2 * (2 * 256 * v_loc * 64)
    knn = dryrun.lower_paper_one(classes=10**8, n_dev=256, head="knn",
                                 backend="kernel", batch=512, n_micro=2)
    nnz = 10**8 * 16 // 256
    assert knn["memory"]["argument_bytes"] == (
        2 * v_loc * 64 * 4 + (10**8 + 1) * 4 + 2 * nnz * 4
        + 512 * 64 * 4 + 512 * 4)
    assert knn["ledger_divergence"] == []
    assert set(knn["kernels"]) == {"sparse_ce_forward", "sparse_ce_backward"}
    row = tanalysis.analyze_record(rec)
    assert row.n_chips == 256 and row.fits


def test_lower_one_on_the_ring():
    """SmolLM's train step at 2 x 512 tokens on a ring of 4: its arguments
    are the fp32 params, the momentum and the batch, the vocab's head
    work is a quarter of the table's, remat recomputes (more FLOPs, a
    lower peak), the prefill runs the flash kernel's meta path; the
    production meshes take every family, the ssm trunk too (their
    records: tests/test_torch_grid_specs.py)."""
    kw = dict(n_dev=4, batch=2, seq=512)
    rows = {r: dryrun.lower_one("smollm_135m", "train_4k", remat=r, **kw)
            for r in ("none", "full")}
    n = rows["none"]["n_params"]
    assert rows["none"]["memory"]["argument_bytes"] == 2 * n * 4 + 2 * (
        2 * 512 * 4)
    assert rows["full"]["counted"]["flops"] > rows["none"]["counted"]["flops"]
    assert (rows["full"]["memory"]["peak_bytes"]
            < rows["none"]["memory"]["peak_bytes"])
    assert rows["none"]["kernels"]["ce_forward"]["calls"] == 1
    assert rows["none"]["collectives"]["total_bytes"] > 0
    pre = dryrun.lower_one("smollm_135m", "prefill_32k", **kw)
    assert pre["kernels"]["flash_attention"]["calls"] == 30
    ssm = dryrun.lower_one("mamba2_370m", "train_4k", mesh="16x16",
                           n_layers=1, batch=32, seq=64)
    assert ssm["mesh"] == "16x16" and ssm["member_rows"] == 2


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_lower_one_runs_every_arch_and_shape(arch):
    """Every arch id (cut to 2 layers, one sequence of 256 tokens) and
    every input shape it takes runs on the meta device on a ring of 16:
    the moe family's routing included; a train step charges the CE pair,
    and its arguments hold the params and their momentum."""
    for shape in tbase.INPUT_SHAPES:
        if shape == "long_500k" and arch in tbase.LONG_CONTEXT_SKIP:
            continue
        decode = tbase.INPUT_SHAPES[shape].mode == "decode"
        rec = dryrun.lower_one(arch, shape, n_dev=16, batch=1,
                               seq=0 if decode else 256, n_layers=2)
        assert rec["counted"]["flops"] > 0 and rec["n_layers"] == 2
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
        if shape == "train_4k":
            assert set(rec["kernels"]) == {"ce_forward", "ce_backward"}
            assert rec["memory"]["argument_bytes"] >= 2 * 4 * rec["n_params"]
