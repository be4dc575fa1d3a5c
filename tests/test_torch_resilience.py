"""Fault injection and resumable training in the port, on the CPU.

A run killed mid-training and resumed by a FRESH experiment from its
latest full-state checkpoint is step for step the run that was never
interrupted. ``resilience.kill_and_recover`` reports ``bitwise`` for each
of the six heads on the feats trunk and for the reduced ResNet with DGC,
on rings of 1 and 2 gloo processes: the final snapshots byte-equal and
the loss rows equal. The scenarios of the JAX package's tests carry over:
a kill after DGC has accumulated u and v, a kill inside the FCCS batch
ramp, and a straggler delay that moves nothing but time. Then the facade
(``fit(resume=True)`` runs only the tail, a cold start without a
checkpoint, ``restore`` without a ``ckpt_dir``), the step hook's timing,
the telemetry, the launcher's checkpoint flags, and the zoo's checkpoints,
which wait for its trainer.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import dist, testing
from repro_torch.api import Experiment
from repro_torch.launch import train as launcher
from repro_torch.optim import tree_leaves
from repro_torch.resilience import (FaultPlan, SimulatedFault, fault_hook,
                                    kill_and_recover, tree_compare)
from repro_torch.telemetry import Tracer
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2)
HEAD = dict(backend="ref", knn_k=8, knn_kprime=16, active_frac=0.25,
            rebuild_every=5, sampled_n=64, mach_b=64, mach_r=2, csoft_b=64,
            csoft_r=2)

def _spec(head, *, dgc=False, trunk="feats", batch=16):
    return {"head": dict(HEAD, softmax_impl=head),
            "train": dict(optimizer="sgd",
                          fccs=dict(eta0=0.5, t_warm=2, b0=batch,
                                    b_min=batch, b_max=4 * batch, t_ini=2,
                                    t_final=8),
                          dgc=dict(enabled=dgc, sparsity=0.95, chunk=512,
                                   backend="ref")),
            "trunk": trunk, "classes": 256, "feat_dim": 32, "batch": batch,
            "hw": 16, "ckpt_every": 4}


# kill at 6 with snapshots every 4: the knn graph and the LSH tables of
# the snapshot (step 4) are the ones before the refresh after step 4,
# which the replay must rebuild exactly as the killed run did
SCENARIOS = {
    **{h: (_spec(h), dict(total_steps=8, kill_at=6,
                          fit_kw={"use_fccs_batch": False}))
       for h in ("full", "knn", "selective", "mach", "sampled", "csoft")},
    "cnn+dgc": (_spec("full", dgc=True, trunk="cnn", batch=8),
                dict(total_steps=6, kill_at=5,
                     fit_kw={"use_fccs_batch": False})),
    "full+dgc": (_spec("full", dgc=True),
                 dict(total_steps=8, kill_at=6,
                      fit_kw={"use_fccs_batch": False})),
    "full+fccs": (_spec("full"), dict(total_steps=8, kill_at=6,
                                      fit_kw={"use_fccs_batch": True})),
}
HEADLINE = ("full", "knn", "selective", "mach", "sampled", "csoft",
            "cnn+dgc")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Every scenario on one ring per ring size."""
    root = tmp_path_factory.mktemp("recover")
    out = {}
    for n in RINGS:
        cases = [("kill_recover", (spec, str(root / f"{name}_{n}")), kw)
                 for name, (spec, kw) in SCENARIOS.items()]
        per_rank = dist.spawn_ring(testing.run_all, n, cases)
        for i, name in enumerate(SCENARIOS):
            out[(name, n)] = [r[i] for r in per_rank]
    return out


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("name", HEADLINE)
def test_kill_and_recover_is_bitwise(reports, name, n):
    for rep in reports[(name, n)]:
        assert rep.ok, rep.summary()
        assert rep.equivalence == "bitwise" and rep.bitwise
        assert rep.max_abs_diff == 0.0 and rep.loss_max_rel == 0.0
        kill = SCENARIOS[name][1]["kill_at"]
        assert rep.restored_step == 4 and rep.steps_replayed == kill - 4
        assert [r["step"] for r in rep.resumed_history] == \
            list(range(4, SCENARIOS[name][1]["total_steps"]))
        assert rep.save_s > 0 and rep.restore_s > 0 and rep.ckpt_bytes > 0
        # the parts: member 0 alone fetches and writes; every member reads
        assert 0 <= rep.save_fetch_s < rep.save_s
        assert rep.restore_read_s > 0 and rep.restore_place_s > 0
        assert rep.restore_read_s + rep.restore_place_s <= rep.restore_s
        assert [e.name for e in rep.restore_spans] == ["train.restore"]
        assert rep.src_mesh == rep.dst_mesh == f"ring of {n}"


@pytest.mark.parametrize("n", RINGS)
def test_kill_after_dgc_accumulation(reports, n, tmp_path):
    """DGC's u and v are mid-flight at the kill: they ride the snapshot,
    one row a member, or the resumed exchange would diverge."""
    for rep in reports[("full+dgc", n)]:
        assert rep.ok, rep.summary()
    exp = testing.ckpt_experiment(SCENARIOS["full+dgc"][0])
    exp.fit(2, use_fccs_batch=False)
    tree = exp.trainer._snapshot()
    assert set(tree["dgc"]) == {"u", "v"}
    assert all(np.abs(v.numpy()).sum() > 0
               for v in tree["dgc"]["v"].values())


@pytest.mark.parametrize("n", RINGS)
def test_kill_mid_fccs_ramp(reports, n):
    """The kill lands inside the batch ramp: the resumed run takes the
    same batch sizes from the cursor (a restart from zero would re-warm
    the learning rate and shrink the batch)."""
    rep = reports[("full+fccs", n)][0]
    assert rep.ok, rep.summary()
    batches = [r["batch"] for r in rep.reference_history]
    assert batches[-1] > batches[0]
    resumed = {r["step"]: (r["batch"], r["lr"]) for r in rep.resumed_history}
    for r in rep.reference_history:
        if r["step"] in resumed:
            assert resumed[r["step"]] == (r["batch"], r["lr"])


def test_delay_fault_is_numerically_invisible():
    spec = SCENARIOS["full"][0]
    ref = testing.ckpt_experiment(spec)
    ref.fit(4, use_fccs_batch=False)
    slept = []
    slow = testing.ckpt_experiment(spec)
    slow.fit(4, use_fccs_batch=False, step_hook=fault_hook(
        FaultPlan(delay_at=2, delay_s=123.0), sleep=slept.append))
    assert slept == [123.0]
    cmp = tree_compare(slow.trainer._snapshot(), ref.trainer._snapshot())
    assert cmp["bitwise"], cmp["mismatches"]


def test_fit_resume_true_runs_only_the_tail(tmp_path):
    spec, ck = SCENARIOS["full"][0], str(tmp_path / "ck")
    victim = testing.ckpt_experiment(spec, ck)
    with pytest.raises(SimulatedFault):
        victim.fit(8, use_fccs_batch=False,
                   step_hook=fault_hook(FaultPlan(kill_at=6)))
    resumed = testing.ckpt_experiment(spec, ck)
    hist = resumed.fit(8, use_fccs_batch=False, resume=True)
    assert [r["step"] for r in hist] == [4, 5, 6, 7]
    assert resumed.trainer._t == 8 and resumed.state.step == 8
    # an idempotent relaunch: the target is reached, no step runs
    again = testing.ckpt_experiment(spec, ck)
    assert again.fit(8, use_fccs_batch=False, resume=True) == []
    assert again.trainer._t == 8


def test_fit_resume_without_checkpoint_is_cold_start(tmp_path):
    exp = testing.ckpt_experiment(SCENARIOS["full"][0],
                                  str(tmp_path / "empty"))
    hist = exp.fit(3, use_fccs_batch=False, resume=True)
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert exp.trainer.restores == 0


def test_restore_without_ckpt_dir_raises(tmp_path):
    exp = testing.ckpt_experiment(SCENARIOS["full"][0])
    with pytest.raises(ValueError, match="ckpt_dir"):
        exp.restore()
    with pytest.raises(ValueError, match="ckpt_dir"):
        exp.trainer.save_checkpoint()
    exp = testing.ckpt_experiment(SCENARIOS["full"][0], str(tmp_path / "e"))
    with pytest.raises(FileNotFoundError):
        exp.restore()
    assert exp.restore(missing_ok=True) is None


def test_restore_gathers_nothing(tmp_path, monkeypatch):
    """A restore reads the leaf paths from the member's own state: the
    GLOBAL W, its moment and DGC's stacked u and v are not gathered only
    to be dropped."""
    spec, ck = SCENARIOS["full+dgc"][0], str(tmp_path / "ck")
    exp = testing.ckpt_experiment(spec, ck)
    exp.fit(4, use_fccs_batch=False)
    fresh = testing.ckpt_experiment(spec, ck)

    def no_gather(*a, **k):
        raise AssertionError("a restore gathered")
    monkeypatch.setattr(dist, "all_gather", no_gather)
    assert fresh.restore() == 4
    monkeypatch.undo()
    cmp = tree_compare(fresh.trainer._snapshot(), exp.trainer._snapshot())
    assert cmp["bitwise"], cmp["mismatches"]


def test_step_hook_fires_before_the_step():
    """A kill before step k leaves the state at step k's entry: k steps
    taken, cursor k."""
    exp = testing.ckpt_experiment(SCENARIOS["full"][0])
    with pytest.raises(SimulatedFault):
        exp.fit(8, use_fccs_batch=False,
                step_hook=fault_hook(FaultPlan(kill_at=3)))
    assert exp.trainer._t == 3 and exp.state.step == 3
    assert len(exp.trainer.history) == 3


def test_snapshot_restores_the_refreshed_graph(tmp_path):
    """The snapshot carries the head's aux: a fresh experiment, whose own
    graph is built on its initial weights, restores the graph the trained
    run refreshed after step 4."""
    spec, ck = SCENARIOS["knn"][0], str(tmp_path / "ck")
    exp = testing.ckpt_experiment(spec, ck)
    exp.fit(6, use_fccs_batch=False)          # the refresh ran after step 4
    exp.trainer.save_checkpoint()
    fresh = testing.ckpt_experiment(spec, ck)
    assert not all(np.array_equal(a.numpy(), b.numpy()) for a, b in
                   zip(fresh.state.head_aux, exp.state.head_aux))
    fresh.restore()
    for a, b in zip(fresh.state.head_aux, exp.state.head_aux):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert fresh.trainer._t == 6


def test_checkpoint_telemetry_and_weights_version(tmp_path):
    """The spans and counters of a checkpointing run and of a restore, and
    ``weights_version`` moving on a restore to a step seen before."""
    spec, ck = dict(SCENARIOS["full"][0], ckpt_every=2), str(tmp_path / "c")
    exp = testing.ckpt_experiment(spec, ck)
    tr = Tracer()
    exp.fit(4, use_fccs_batch=False, telemetry=tr)
    assert tr.counters["train.checkpoints"] == 2
    assert [e.name for e in tr.events].count("train.checkpoint") == 2
    assert sorted(os.listdir(ck)) == ["ckpt_2.msgpack.zst",
                                      "ckpt_4.msgpack.zst"]
    v4 = exp.weights_version
    assert exp.restore(2) == 2 and exp.trainer._t == 2
    exp.fit(2, use_fccs_batch=False)
    assert exp.state.step == 4 and exp.weights_version != v4
    assert tr.counters["train.restores"] == 1
    for part in ("checkpoint.fetch_s", "checkpoint.write_s",
                 "restore.read_s", "restore.place_s"):
        assert tr.counters[f"train.{part}"] > 0, part
    # keep=1 leaves only the newest
    exp.trainer.ckpt_keep = 1
    exp.trainer.save_checkpoint()
    assert os.listdir(ck) == ["ckpt_4.msgpack.zst"]


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="injects nothing"):
        FaultPlan()
    with pytest.raises(ValueError, match="delay_s"):
        FaultPlan(delay_at=1, delay_s=-1.0)
    with pytest.raises(ValueError, match="kill_at"):
        kill_and_recover(lambda d: None, total_steps=4, kill_at=0,
                         ckpt_dir="x")
    with pytest.raises(ValueError, match="equivalence"):
        kill_and_recover(lambda d: None, total_steps=4, kill_at=2,
                         ckpt_dir="x", equivalence="vibes")


@pytest.mark.parametrize("argv,err", [
    (["--resume"], "--resume requires --ckpt-dir"),
    (["--ckpt-dir", "a", "--resume", "b"], "conflicts"),
    (["--ckpt-dir", "a", "--ckpt-keep", "0"], "--ckpt-keep must be >= 1"),
    (["--ckpt-dir", "a", "--ckpt-every", "-1"], "--ckpt-every must be >= 0"),
    # the zoo's checkpoint flags pass the same checks (the id is kept from
    # when the zoo refused them, naming ROADMAP.md A.9.3)
    pytest.param(["--system", "zoo", "--resume"],
                 "--resume requires --ckpt-dir",
                 id="argv4-ROADMAP.md queue A.9.3"),
])
def test_launcher_checkpoint_flag_checks(argv, err, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.parse_args(argv)
    assert e.value.code == 2
    assert err in capsys.readouterr().err


def test_launcher_resume_flags_imply():
    args = launcher.parse_args(["--resume", "d/ckpt_4.msgpack.zst"])
    assert args.ckpt_dir == "d" and args.resume is True
    args = launcher.parse_args(["--ckpt-dir", "d", "--resume-reshard"])
    assert args.resume is True and args.resume_reshard
    assert launcher.parse_args(["--ckpt-dir", "d"]).ckpt_every == 50


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--classes", "64", "--feat-dim", "16",
            "--batch", "8", "--ckpt-dir", ck, "--ckpt-every", "2"]
    assert launcher.main(base + ["--steps", "4"]) == 0
    assert sorted(os.listdir(ck)) == ["ckpt_2.msgpack.zst",
                                      "ckpt_4.msgpack.zst"]
    capsys.readouterr()
    assert launcher.main(base + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at t=4: 2 steps to 6" in out
    assert "final eval accuracy" in out
    assert launcher.main(base + ["--steps", "6", "--resume"]) == 0
    assert "nothing to run" in capsys.readouterr().out


def test_zoo_checkpoints_wait_for_the_zoo_trainer(tmp_path):
    """The zoo trainer's checkpoints (the name is kept from when they
    refused): a save at the end of ``fit`` and a fresh experiment's
    restore give back the params bit for bit, at the saved cursor."""
    ck = str(tmp_path / "ck")
    kw = dict(system="zoo", arch="smollm_135m", reduced=True, device="cpu",
              batch=2, seq=8, log_every=0, ckpt_dir=ck)
    exp = Experiment.from_config(**kw)
    exp.fit(2, lr=0.5)
    back = Experiment.from_config(**kw)
    assert back.restore() == 2 and back._t == 2
    for a, b in zip(tree_leaves(back.params), tree_leaves(exp.params)):
        assert torch.equal(a, b)
