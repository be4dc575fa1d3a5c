"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the port's
examples (``examples/*_torch.py``) and scripts (``scripts/check_docs_torch.py``,
``scripts/smoke_torch_legs.py``) import nothing of JAX or of the JAX
package, its configs match the JAX package's field for field, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import sku100m_resnet as jax_sku
from repro_torch import interop
from repro_torch.api import Experiment
from repro_torch.configs import base as port_base
from repro_torch.configs import sku100m_resnet as port_sku
from repro_torch.serving import IVFIndex

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# the port's scripts beside the package, each importable by path
PORT_SCRIPTS = ("examples/quickstart_torch.py",
                "examples/train_sku_cnn_torch.py",
                "examples/serve_lm_torch.py", "scripts/check_docs_torch.py",
                "scripts/smoke_torch_legs.py")
# a subprocess's CPU ops on one thread: the test run's workers share the
# cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
KNN_MODULES = ("repro_torch.core.knn_graph", "repro_torch.core.knn_softmax",
               "repro_torch.kernels.sparse_ce",
               "repro_torch.kernels.knn_dist_topk")
IVF_MODULES = ("repro_torch.serving.index", "repro_torch.kernels.ivf_rerank")
ZOO_MODULES = ("repro_torch.models.layers", "repro_torch.models.decoder",
               "repro_torch.models.lm", "repro_torch.train.gspmd",
               "repro_torch.kernels.flash_attention")
CKPT_MODULES = ("repro_torch.checkpoint.checkpoint",
                "repro_torch.checkpoint.codec", "repro_torch.elastic.plan",
                "repro_torch.elastic.reshard", "repro_torch.elastic.apply",
                "repro_torch.resilience.faults",
                "repro_torch.resilience.harness",
                "repro_torch.telemetry.ledger")
ROOFLINE_MODULES = ("repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                    "repro_torch.optim.scale", "repro_torch.kernels.cost",
                    "repro_torch.roofline.analysis",
                    "repro_torch.roofline.counter",
                    "repro_torch.roofline.hardware",
                    "repro_torch.roofline.report")
SLICE_MODULES = (KNN_MODULES + IVF_MODULES + ZOO_MODULES + CKPT_MODULES
                 + ROOFLINE_MODULES)


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port,
    ``chip_smoke`` and the port's examples and scripts, and finds neither
    JAX nor the JAX package loaded."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for i, path in enumerate({PORT_SCRIPTS!r}):\n"
        f"    spec = importlib.util.spec_from_file_location(\n"
        f"        f'script{{i}}', {str(ROOT)!r} + '/' + path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"missing = set("
        f"{SLICE_MODULES!r}) "
        f"- set(sys.modules)\n"
        "assert not missing, missing\n"
        "print('modules', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), **ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the training slice's modules (optim, pipeline, fccs, sparsify,
    # trainer, launch.train), the knn slice's (knn_graph, knn_softmax,
    # sparse_ce, knn_dist_topk), the IVF slice's (serving.index,
    # kernels.ivf_rerank) and the zoo's (models, train.gspmd,
    # kernels.flash_attention) and the checkpoint slice's (checkpoint,
    # elastic, resilience, telemetry.ledger) are among them
    assert int(out.stdout.split()[-1]) >= 56


def test_checkpoints_need_neither_msgpack_nor_zstandard(tmp_path):
    """Where neither package is installed (the card's machine), the port
    still writes and reads checkpoints, with its own codec and zlib, and
    no module of the port imports msgpack; zstandard is imported only by
    the checkpoint module, guarded."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "import numpy as np\n"
        "from repro_torch import checkpoint, elastic, resilience\n"
        "from repro_torch.api import Experiment\n"
        "assert checkpoint.codec_name() == 'zlib-0'\n"
        "exp = Experiment.from_config(system='paper', classes=64, "
        "feat_dim=8, batch=8, device='cpu', log_every=0, "
        f"ckpt_dir={str(tmp_path / 'ck')!r}, ckpt_every=2)\n"
        "exp.fit(2)\n"
        "fresh = Experiment.from_config(system='paper', classes=64, "
        "feat_dim=8, batch=8, device='cpu', log_every=0, "
        f"ckpt_dir={str(tmp_path / 'ck')!r})\n"
        "assert fresh.restore() == 2\n"
        "cmp = resilience.tree_compare(fresh.trainer._snapshot(), "
        "exp.trainer._snapshot())\n"
        "assert cmp['bitwise'], cmp\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
    importers = {str(p.relative_to(ROOT)): m
                 for p in sorted(PORT.rglob("*.py")) for m in _imports(p)
                 if m.split(".")[0] in ("msgpack", "zstandard")}
    assert importers == {"src/repro_torch/checkpoint/checkpoint.py":
                         "zstandard"}
    src = (PORT / "checkpoint" / "checkpoint.py").read_text()
    assert "try:\n    import zstandard\nexcept ImportError:" in src


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_port_imports_jax():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + [ROOT / p for p in PORT_SCRIPTS])
    assert len(files) > 30
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        exp = Experiment.from_config(system="paper", classes=64, feat_dim=8)
        assert exp.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment.from_config(system="paper", classes=64, feat_dim=8)
    exp = Experiment.from_config(system="paper", classes=64, feat_dim=8,
                                 device="cpu")
    assert exp.state.w_head.device.type == "cpu"


def test_unported_parts_say_so():
    # the zoo builds every arch id; the encoder-decoder's token serving
    # refuses, as the JAX package's does (its decode runs through lm.decode)
    moe = Experiment.from_config(system="zoo", arch="qwen3_moe_30b_a3b",
                                 reduced=True, device="cpu")
    assert moe.model_cfg.family == "moe"
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Experiment.from_config(system="zoo", arch="whisper_tiny",
                               reduced=True, device="cpu").serve(
            prompt_len=4, gen=2)
    zoo = Experiment.from_config(system="zoo", arch="smollm_135m",
                                 reduced=True, device="cpu")
    # the zoo's checkpoints are ported: like the paper system's, a resume
    # wants a ckpt_dir to restore from
    with pytest.raises(ValueError, match="ckpt_dir"):
        zoo.fit(1, resume=True)
    ck = Experiment.from_config(system="zoo", arch="mamba2_370m",
                                reduced=True, device="cpu",
                                ckpt_dir="no_such_ckpt_dir")
    assert ck.restore(missing_ok=True) is None
    assert ck.ckpt_dir == "no_such_ckpt_dir"
    exp = Experiment.from_config(system="paper", classes=64, feat_dim=8,
                                 device="cpu")
    with pytest.raises(ValueError, match="ckpt_dir"):
        exp.fit(1, resume=True)
    with pytest.raises(ValueError, match="ckpt_dir"):
        exp.trainer.restore_checkpoint()
    with pytest.raises(TypeError, match="not a paper/zoo Experiment"):
        IVFIndex.fit(types.SimpleNamespace(par=None))


def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory)
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["ModelConfig", "HeadConfig", "TrainConfig",
                                  "FCCSConfig", "DGCConfig", "MoEConfig",
                                  "SSMConfig", "ParallelConfig",
                                  "InputShape"])
def test_configs_match_the_jax_package_field_for_field(name):
    """Same field names and defaults, so one dict drives both packages;
    only the head's default backend differs (the port defaults to its
    kernels, ``"kernel"``, the JAX package to ``"ref"``)."""
    jax_f, port_f = (_fields(getattr(m, name)) for m in (jax_base, port_base))
    assert list(jax_f) == list(port_f)
    differ = {k for k in jax_f if k not in ("fccs", "dgc")
              and jax_f[k] != port_f[k]}
    assert differ == ({"backend"} if name == "HeadConfig" else set())


@pytest.mark.parametrize("fn", ["config", "config_1m", "config_10m",
                                "reduced"])
def test_sku_configs_match(fn):
    assert (dataclasses.asdict(getattr(port_sku, fn)())
            == dataclasses.asdict(getattr(jax_sku, fn)()))


def test_pad_vocab_matches():
    cfg = port_sku.config_1m()
    jcfg = jax_sku.config_1m()
    for mult in (128, 8, 2):
        assert (dataclasses.asdict(port_base.pad_vocab(cfg, mult))
                == dataclasses.asdict(jax_base.pad_vocab(jcfg, mult)))
    padded = port_base.pad_vocab(cfg, 128)
    assert port_base.effective_vocab(padded) == 1_020_250


def test_head_config_validation_and_interop():
    with pytest.raises(ValueError, match="'ref' or 'kernel'"):
        port_base.HeadConfig(backend="pallas")
    with pytest.raises(ValueError, match="softmax_impl"):
        port_base.HeadConfig(softmax_impl="nope")
    jcfg = jax_base.HeadConfig(backend="pallas", cosine_scale=8.0)
    cfg = interop.head_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.backend == "kernel" and cfg.cosine_scale == 8.0
    with pytest.raises(ValueError, match="unknown HeadConfig fields"):
        interop.head_config_from_dict({"bogus": 1})


def test_paper_state_from_numpy_keeps_this_members_rows():
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    w.setflags(write=False)                   # as np.asarray of a jax array
    blocks = [interop.paper_state_from_numpy({}, w, rank=r, world_size=3,
                                             device="cpu").w_head
              for r in range(3)]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), w)
    with pytest.raises(ValueError, match="do not divide"):
        interop.paper_state_from_numpy({}, w, rank=0, world_size=4,
                                       device="cpu")
    # the knn head's graph arrives [P, ...]: each member keeps its row
    aux = (np.arange(12, dtype=np.int32).reshape(3, 4),
           np.arange(6, dtype=np.int32).reshape(3, 2))
    for r in range(3):
        st = interop.paper_state_from_numpy({}, w, head_aux=aux, rank=r,
                                            world_size=3, device="cpu")
        assert [a.tolist() for a in st.head_aux] == [a[r].tolist()
                                                     for a in aux]
    with pytest.raises(ValueError, match="leading axis"):
        interop.paper_state_from_numpy({}, w, head_aux=aux, rank=0,
                                       world_size=2, device="cpu")
