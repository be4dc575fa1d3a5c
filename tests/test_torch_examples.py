"""The port's examples against the JAX package's, on the CPU.

* Each port example (``examples/*_torch.py``) runs the JAX example's
  settings, field for field: the JAX example runs with its entry points
  (``Experiment``, ``PaperTrainer``, the serve launcher's ``main``)
  replaced by recorders that keep their arguments and train nothing, and
  so does the port's; the recorded ``HeadConfig``, ``TrainConfig`` (its
  ``FCCSConfig`` and ``DGCConfig``) and ``ModelConfig`` are equal as
  ``dataclasses.asdict``, and so are the classes, batch, steps,
  ``log_every``, the learning rates and the calls made. The one field that
  differs is ``backend``, the packages' defaults for the head
  (``"kernel"`` in the port, ``"ref"`` in the JAX package), which the
  cnn example also gives DGC's threshold.
* Each port example runs on the CPU at a few steps: the quickstart on a
  ring of one prints both result lines and its history's learning rate
  and batch are the JAX package's FCCS schedule, ``train_sku_cnn_torch``
  prints its accuracy line, ``serve_lm_torch`` exits 0.
"""
import dataclasses
import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import fccs as jax_fccs
from tests.torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run), with
    ``XLA_FLAGS`` as it was before: the JAX examples set it on import."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return mod


class _Recorder:
    """Stands in for an experiment or a trainer: keeps every call."""

    def __init__(self, calls: list, *args, **kw):
        self.calls = calls
        calls.append(("init", args, kw))
        self.history = [{"batch": 0}]
        self.trainer = self

    def __getattr__(self, name):
        def call(*args, **kw):
            self.calls.append((name, args, kw))
            return np.zeros(64, np.int32) if name == "serve" else 0.0
        return call


def _asdict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("backend", None)
    return d


def _quickstart_calls(name: str, argv=None) -> list:
    mod = _load(name)
    calls: list = []

    class Experiment:
        @staticmethod
        def from_config(**kw):
            return _Recorder(calls, **kw)

    mod.Experiment = Experiment
    mod.main() if argv is None else mod.main(argv)
    return calls


def test_quickstart_has_the_jax_examples_settings():
    """The ``Experiment.from_config`` arguments of both quickstarts (the
    classes, feat_dim and batch, the head, the trainer with its FCCS and
    DGC configs, ``log_every``) and their fit, evaluate and serve calls,
    field for field; the port's module-level ``SOFTMAX_IMPL`` is the JAX
    one's."""
    jax_calls = _quickstart_calls("quickstart")
    port_calls = _quickstart_calls("quickstart_torch", [])
    (_, _, jkw), (_, _, pkw) = jax_calls[0], port_calls[0]
    assert pkw.pop("device") == "cuda"
    assert set(jkw) == set(pkw) == {"system", "classes", "feat_dim", "batch",
                                    "head", "train", "log_every"}
    for key in ("system", "classes", "feat_dim", "batch", "log_every"):
        assert pkw[key] == jkw[key], key
    assert _asdict(pkw["head"]) == _asdict(jkw["head"])
    assert pkw["head"].backend == "kernel"
    assert dataclasses.asdict(pkw["train"]) == dataclasses.asdict(jkw["train"])
    assert (pkw["classes"], pkw["batch"]) == (4096, 128)
    assert port_calls[1:] == jax_calls[1:] == [
        ("fit", (150,), {"use_fccs_batch": True}),
        ("evaluate", (), {"eval_batch": 1024}), ("serve", (), {"batch": 64})]
    assert _load("quickstart_torch").SOFTMAX_IMPL == \
        _load("quickstart").SOFTMAX_IMPL


def _sku_calls(name: str, argv: list, monkeypatch) -> list:
    mod = _load(name)
    calls: list = []

    def trainer(*args, **kw):
        return _Recorder(calls, *args, **kw)

    monkeypatch.setattr(mod, "PaperTrainer", trainer)
    monkeypatch.setattr(mod, "sku_image_batch", lambda *a, **kw: calls.append(
        ("sku_image_batch", a, {k: v for k, v in kw.items()
                                if k != "device"})))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main() if name == "train_sku_cnn" else mod.main(argv)
    return calls


def test_train_sku_cnn_has_the_jax_examples_settings(monkeypatch):
    """The ``PaperTrainer`` of both cnn examples at the same flags: the
    reduced SKU ResNet in fp32, the knn head, SGD with momentum and DGC,
    the hardware batch, ``log_every``, the learning rate at every step of
    a 200-step run, ``run``'s arguments and the evaluation batch."""
    argv = ["--steps", "7", "--classes", "96", "--batch", "16"]
    jax_calls = _sku_calls("train_sku_cnn", argv, monkeypatch)
    port_calls = _sku_calls("train_sku_cnn_torch", argv, monkeypatch)
    (_, (jm, jh, jt, _mesh, jdata), jkw) = jax_calls[0]
    (_, (pm, ph, pt, pdata), pkw) = port_calls[0]
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    assert pm.vocab_size == 96 and pm.dtype == "float32"
    assert _asdict(ph) == _asdict(jh) and ph.backend == "kernel"
    assert _asdict(pt.dgc) == _asdict(jt.dgc)
    assert pt.dgc.enabled and pt.dgc.backend == "kernel"
    tj, tp = dataclasses.asdict(jt), dataclasses.asdict(pt)
    tj["dgc"].pop("backend")
    tp["dgc"].pop("backend")
    assert tp == tj
    assert pkw.pop("device") == "cuda"
    jlr, plr = jkw.pop("lr_fn"), pkw.pop("lr_fn")
    assert [plr(t) for t in range(200)] == [jlr(t) for t in range(200)]
    assert pkw == jkw == {"hw_batch": 16, "log_every": 20}
    pdata(3, 16)
    jdata(3, 16)
    assert port_calls[1:] == jax_calls[1:] == [
        ("run", (7,), {"use_fccs_batch": False}),
        ("sku_image_batch", (10**6, 256, 96), {}), ("evaluate", (None,), {}),
        ("sku_image_batch", (3, 16, 96), {})]


def test_serve_lm_forwards_the_jax_examples_flags(monkeypatch):
    """Both serve examples hand their serve launcher the same flags, the
    port's with ``--system zoo`` (its launcher's default system is the
    paper's) and ``--device``."""
    import repro.launch.serve as jax_serve
    import repro_torch.launch.serve as port_serve
    got = {}
    for pkg, mod in (("jax", jax_serve), ("port", port_serve)):
        monkeypatch.setattr(mod, "main",
                            lambda argv, pkg=pkg: got.setdefault(pkg, argv))
    argv = ["--arch", "mamba2_370m", "--batch", "3", "--prompt-len", "5",
            "--gen", "2"]
    monkeypatch.setattr(sys, "argv", ["serve_lm"] + argv)
    _load("serve_lm").main()
    _load("serve_lm_torch").main(argv)
    assert got["port"][:4] == ["--system", "zoo", "--device", "cuda"]
    assert got["port"][4:] == got["jax"] == [
        "--arch", "mamba2_370m", "--reduced", "--batch", "3",
        "--prompt-len", "5", "--gen", "2"]


def test_quickstart_runs_on_the_cpu(capsys):
    """Four steps on a ring of one: both result lines, and every history
    row's learning rate and batch from the JAX package's FCCS schedule of
    the JAX example's config."""
    jax_cfg = _quickstart_calls("quickstart")[0][2]["train"].fccs
    exp, acc = _load("quickstart_torch").main(["--device", "cpu",
                                               "--steps", "4"])
    out = capsys.readouterr().out
    assert "final deploy-style (nearest class weight) accuracy:" in out
    assert "serve() returned 64 retrieval ids; final batch = 128" in out
    assert math.isfinite(acc) and exp.device.type == "cpu"
    hist = exp.trainer.history
    assert [r["step"] for r in hist] == [0, 1, 2, 3]
    assert [r["lr"] for r in hist] == pytest.approx(
        [jax_fccs.learning_rate(t, jax_cfg) for t in range(4)], rel=1e-12)
    assert [r["batch"] for r in hist] == [
        jax_fccs.batch_size(t, jax_cfg) for t in range(4)]


def test_train_sku_cnn_runs_on_the_cpu(capsys):
    trainer, acc = _load("train_sku_cnn_torch").main(
        ["--steps", "2", "--classes", "64", "--batch", "8", "--device",
         "cpu"])
    out = capsys.readouterr().out
    assert "final accuracy (CNN trunk + KNN softmax + DGC):" in out
    assert math.isfinite(acc) and len(trainer.history) == 2
    assert all(r["batch"] == 8 for r in trainer.history)


def test_serve_lm_runs_on_the_cpu(capsys):
    rc = _load("serve_lm_torch").main(["--device", "cpu", "--batch", "2",
                                       "--prompt-len", "8", "--gen", "3"])
    assert rc == 0
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_the_examples_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for name, argv in (("quickstart_torch", ["--steps", "1"]),
                       ("train_sku_cnn_torch", ["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main(argv)
