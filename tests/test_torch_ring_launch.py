"""The paper system's launchers under ``torchrun`` on the CPU: two
processes (``python -m torch.distributed.run --standalone
--nproc-per-node 2``, ``--device cpu``, gloo) are one ring of two.

* Training: the run prints its result lines once (member 0), ends at the
  same checkpoint, byte for byte, and the same losses as the launcher's
  ``main`` on a ``dist.spawn_ring`` of two, and not at the ring of one's;
  resumed with ``--resume`` from its step-4 checkpoint it ends at the
  uninterrupted run's checkpoint, byte for byte.
* Serving: exact top-5 ids equal the ring of one's on the same weights
  (W does not depend on the ring's size); ``--replay`` runs on a ring of
  two in lockstep.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import dist, testing
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--device", "cpu", "--classes", "512", "--feat-dim", "32",
         "--batch", "32", "--fccs", "--optimizer", "lars", "--ckpt-every",
         "2"]
SERVE = ["--device", "cpu", "--classes", "4096", "--feat-dim", "64",
         "--batch", "8", "--topk", "5"]


def torchrun(module: str, argv: list) -> str:
    """``module``'s launcher under torchrun on two CPU processes; its
    standard output (the run must exit 0)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", f"repro_torch.launch.{module}"]
        + argv, cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _lines(out: str, key: str) -> list:
    return [line for line in out.splitlines() if key in line]


def _losses(path) -> list:
    return [json.loads(line)["loss"] for line in
            open(path).read().splitlines()]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Six steps under torchrun, checkpointed every two."""
    tmp = tmp_path_factory.mktemp("ring")
    out = torchrun("train", TRAIN + [
        "--steps", "6", "--ckpt-dir", str(tmp / "ck"), "--metrics-out",
        str(tmp / "m.jsonl")])
    return tmp, out


def test_train_launcher_is_one_ring_of_two(uninterrupted, tmp_path):
    """The torchrun run prints its ring, its accuracy and writes its
    metrics once, and ends at the checkpoint and losses of the same
    launcher on a ``spawn_ring`` of two, byte for byte; the ring of one
    (the processes' old behaviour, each alone) trains otherwise."""
    tmp, out = uninterrupted
    assert len(_lines(out, "[train] ring of 2 over gloo")) == 1
    assert len(_lines(out, "[train] final eval accuracy")) == 1
    assert len(_lines(out, "[telemetry] metrics")) == 1
    ring = dist.spawn_ring(testing.run_launcher, 2, "train", TRAIN + [
        "--steps", "6", "--ckpt-dir", str(tmp_path / "ck"),
        "--metrics-out", str(tmp_path / "m.jsonl")])
    assert [rc for rc, _ in ring] == [0, 0]
    assert _lines(ring[0][1], "final eval accuracy") == \
        _lines(out, "final eval accuracy") and not ring[1][1]
    assert (tmp / "ck" / "ckpt_6.msgpack.zst").read_bytes() == \
        (tmp_path / "ck" / "ckpt_6.msgpack.zst").read_bytes()
    assert _losses(tmp / "m.jsonl") == _losses(tmp_path / "m.jsonl")
    one = tmp_path / "one.jsonl"
    assert train_launcher.main(TRAIN + ["--steps", "6", "--metrics-out",
                                        str(one), "--ckpt-every", "0"]) == 0
    assert _losses(one)[0] == pytest.approx(_losses(tmp / "m.jsonl")[0],
                                            rel=1e-5)
    assert _losses(one)[-1] != _losses(tmp / "m.jsonl")[-1]


def test_train_launcher_resumes_on_the_ring(uninterrupted, tmp_path):
    """A run killed after its step-4 checkpoint (the uninterrupted run's
    directory as it stood then) relaunched with ``--resume`` on the ring
    replays steps 4 and 5 and ends at the uninterrupted run's checkpoint,
    byte for byte."""
    tmp, _ = uninterrupted
    ck = tmp_path / "ck"
    ck.mkdir()
    for step in (2, 4):
        name = f"ckpt_{step}.msgpack.zst"
        (ck / name).write_bytes((tmp / "ck" / name).read_bytes())
    out = torchrun("train", TRAIN + ["--steps", "6", "--ckpt-dir", str(ck),
                                     "--resume"])
    assert _lines(out, "[train] resumed") == \
        ["[train] resumed at t=4: 2 steps to 6"]
    assert (ck / "ckpt_6.msgpack.zst").read_bytes() == \
        (tmp / "ck" / "ckpt_6.msgpack.zst").read_bytes()


def test_serve_launcher_on_the_ring(capsys):
    """Top-5 on a torchrun ring of two prints the ring of one's ids, once;
    ``--replay`` serves the trace on a ring of two in lockstep, member 0
    printing."""
    out = torchrun("serve", SERVE)
    ids = _lines(out, "first query ids")
    assert len(ids) == 1
    assert serve_launcher.main(SERVE) == 0
    assert _lines(capsys.readouterr().out, "first query ids") == ids
    ring = dist.spawn_ring(testing.run_launcher, 2, "serve", SERVE + [
        "--replay", "0.2"])
    assert [rc for rc, _ in ring] == [0, 0] and not ring[1][1]
    assert len(_lines(ring[0][1], "[serve] replayed")) == 1
