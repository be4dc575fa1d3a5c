"""The ``Experiment`` facade of the port: the paper system's training and
serving paths, and the zoo's greedy token serving.

  >>> exp = Experiment.from_config(system="paper", classes=1_020_250,
  ...                              feat_dim=512, batch=256)  # on "cuda"
  >>> exp.fit(6, use_fccs_batch=True)                       # history rows
  >>> run = Experiment.from_config(system="paper", ckpt_dir="ck",
  ...                              ckpt_every=4)
  >>> run.fit(100, resume=True)          # restores the latest, runs the rest
  >>> exp.serve(batch=64)                                    # greedy ids
  >>> exp.serve(batch=64, top_k=5, return_scores=True)       # (ids, scores)
  >>> exp.serve(batch=64, top_k=5, index="ivf")              # IVF top-k
  >>> cnn = Experiment.from_config(         # ResNet-50 + DGC, on images
  ...     system="paper", model=sku100m_resnet.config_1m(), batch=128,
  ...     train=TrainConfig(optimizer="lars", dgc=DGCConfig(
  ...         enabled=True, backend="kernel")))
  >>> zoo = Experiment.from_config(system="zoo", arch="smollm_135m",
  ...                              batch=16, seq=512)
  >>> zoo.fit(4, lr=0.5)                                     # history rows
  >>> zoo.serve(prompt_len=2000, gen=48, batch=8)            # tokens [8, 48]
  >>> zoo.serve(batch=64, top_k=5, index="ivf")              # feature top-k
  >>> ssm = Experiment.from_config(system="zoo", arch="mamba2_370m",
  ...                              ckpt_dir="ck", ckpt_every=2)
  >>> ssm.fit(6, resume=True)            # restores the latest, runs the rest

The port of the JAX package's ``api/experiment.py`` for the slices landed
so far: ``fit`` (the FCCS trainer, with full-state checkpoints under
``ckpt_dir`` every ``ckpt_every`` steps, ``fit(resume=True)`` and
``restore``, on the same ring or, with ``resume="reshard"``, on a ring of
another size), ``evaluate``,
``serve`` (greedy and top-k, through the serving engine or on explicit
inputs, and top-k through the IVF index), ``serving_engine``,
``ivf_index`` / ``install_ivf_index`` and ``weights_version`` on the paper
system, with any of the six softmax heads (``HeadConfig.softmax_impl``:
full, knn, selective, mach, sampled, csoft; the sketch heads mach and
csoft serve greedy only, since top-k and the IVF index retrieve against a
[V, D] class matrix they do not train), on the ``feats`` trunk or the
paper's ResNet (``trunk="cnn"``, or a ``family="cnn"`` model config), with
or without DGC (``TrainConfig.dgc``); for every arch id of the zoo (the
dense and vlm decoders, the moe family's qwen3-moe and kimi-K2, the ssm
mamba2, the hybrid hymba and the encdec whisper) the zoo trainer
(``ZooExperiment.fit`` / ``evaluate``, any of the six heads), its
full-state checkpoints (``ckpt_dir``, ``fit(resume=True | "reshard")``,
``restore``) in the JAX package's layout, prefill + greedy decode (not
for encdec, as in the JAX package) and feature retrieval
(``serve(top_k=...)``, exact or through the IVF index, and
``serving_engine``).

Entry points run on the card: ``device=None`` means ``"cuda"``, and with no
GPU present they raise rather than fall back to the CPU. Pass
``device="cpu"`` to run on the CPU, as the tests do. fp32 products stay
fp32 (TF32 is switched off), as in the JAX reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.configs.base import (HeadConfig, InputShape, ModelConfig,
                                      ParallelConfig, TrainConfig,
                                      effective_vocab, get_model_config,
                                      pad_vocab, ring_parallel_config)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _validate_serve_args(n_classes: int, batch: Optional[int],
                         top_k: Optional[int], index: Optional[str] = None):
    """Reject bad serving knobs with a clear error."""
    if batch is not None and batch <= 0:
        raise ValueError(
            f"serve batch must be a positive query count, got {batch}")
    if top_k is not None and not 0 < top_k <= n_classes:
        raise ValueError(
            f"top_k must be in [1, num_classes={n_classes}], got {top_k} "
            f"(retrieval cannot return more classes than exist)")
    if index not in (None, "none", "ivf"):
        raise ValueError(f"unknown serving index {index!r}; "
                         f"expected 'none' or 'ivf'")
    if index == "ivf" and top_k is None:
        raise ValueError("index='ivf' serves top-k retrieval; "
                         "pass top_k=...")


def paper_model_config(trunk: str = "feats", classes: int = 4096,
                       feat_dim: int = 64) -> ModelConfig:
    """The paper system's trunk config: raw features or the reduced SKU
    ResNet (in fp32; its width is the config's, ``feat_dim`` is not
    read)."""
    if trunk == "feats":
        return ModelConfig(name="paper-feats", family="feats", n_layers=0,
                           d_model=feat_dim, n_heads=0, n_kv_heads=0,
                           d_ff=0, vocab_size=classes, dtype="float32")
    if trunk == "cnn":
        from repro_torch.configs import sku100m_resnet
        return dataclasses.replace(sku100m_resnet.reduced(classes),
                                   dtype="float32")
    raise ValueError(f"unknown paper trunk {trunk!r}")


class Experiment:
    """Facade over one configured system."""

    @staticmethod
    def from_config(*, system: str = "paper", **kw) -> "Experiment":
        if system == "paper":
            return PaperExperiment(**kw)
        if system == "zoo":
            return ZooExperiment(**kw)
        raise ValueError(f"unknown system {system!r} (paper | zoo)")

    def fit(self, steps: int, **kw):
        raise NotImplementedError

    def evaluate(self, inputs=None) -> float:
        raise NotImplementedError

    def serve(self, *args, **kw):
        raise NotImplementedError

    def serving_engine(self, *, top_k: Optional[int] = None, **kw):
        """A ``repro_torch.serving.ServingEngine`` over this experiment's
        head: ``submit()`` of single queries, coalesced into padded
        micro-batches, optional hot-query score cache."""
        from repro_torch.serving import ServingEngine
        _validate_serve_args(effective_vocab(self.model_cfg), None, top_k)
        return ServingEngine.for_experiment(self, top_k=top_k, **kw)

    def ivf_index(self, *, n_clusters: int = 0, nprobe: int = 0,
                  iters: int = 8, refit: bool = False):
        """The experiment's ``repro_torch.serving.IVFIndex`` over its class
        shard, fit lazily and cached. The cached index is REFIT whenever
        ``weights_version`` has moved since the fit (the seam that also
        invalidates the serving score cache), so train steps and weight
        loads retire a stale quantizer. ``refit=True`` forces a refit; the
        knobs only apply when a (re)fit happens."""
        from repro_torch.serving import IVFIndex
        cur = getattr(self, "_ivf", None)
        if (refit or cur is None
                or tuple(cur.version) != tuple(self.weights_version)):
            cur = IVFIndex.fit(self, n_clusters=n_clusters, nprobe=nprobe,
                               iters=iters)
            self._ivf = cur
        return cur

    def install_ivf_index(self, index) -> None:
        """Install an index (``IVFIndex.state_from_restore``, or one carried
        over by ``repro_torch.interop``) so the server skips the fit. It
        still retires itself once ``weights_version`` moves past its
        fit-time snapshot."""
        self._ivf = index

    def _serve_via_engine(self, queries, top_k: Optional[int],
                          return_scores: bool, *,
                          index: Optional[str] = None,
                          nprobe: Optional[int] = None, telemetry=None):
        """Batched serving of ``queries`` through the engine: one engine
        per (top_k, batch, index, nprobe), every query submitted, then
        drained as one micro-batch. No cache on this path (a synchronous
        call wants fresh scores)."""
        queries = np.asarray(queries.cpu() if torch.is_tensor(queries)
                             else queries, np.float32)
        batch = queries.shape[0]
        key = (top_k, batch, index, nprobe)
        eng = self._engines.get(key)
        if eng is None:
            # max_batch >= 2 keeps a 1-query call on the batched shapes
            eng = self.serving_engine(top_k=top_k, max_batch=max(batch, 2),
                                      max_wait_ms=0.0, cache=None,
                                      index=index, nprobe=nprobe)
            self._engines[key] = eng
        if telemetry is not None:
            eng.telemetry = telemetry
        for i in range(batch):
            eng.submit(queries[i])
        done = sorted(eng.drain(), key=lambda r: r.rid)
        if len(done) != batch:
            raise RuntimeError(f"engine returned {len(done)} of {batch}")
        ids = np.stack([r.ids for r in done])
        if top_k is None:
            return ids.astype(np.int32)
        if return_scores:
            return ids, np.stack([r.scores for r in done])
        return ids


class PaperExperiment(Experiment):
    """The paper's system with a pluggable softmax head, on a ring of
    ``repro_torch.dist.world_size()`` members (one without a process
    group). Each member holds its row block of the head."""

    def __init__(self, *, model: Optional[ModelConfig] = None,
                 head: Optional[HeadConfig] = None,
                 train: Optional[TrainConfig] = None,
                 trunk: str = "feats", classes: int = 4096,
                 feat_dim: int = 64, batch: int = 64,
                 data_fn: Optional[Callable[[int, int], dict]] = None,
                 lr_fn=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, ckpt_keep: int = 0,
                 log_every: int = 10, seed: int = 0, telemetry=None,
                 device=None):
        from repro_torch.train.trainer import PaperTrainer

        self.device = resolve_device(device)
        self.model_cfg = model or paper_model_config(trunk, classes, feat_dim)
        self.head_cfg = head or HeadConfig()
        self.train_cfg = train or TrainConfig(optimizer="sgd")
        self.batch = batch
        self.data_fn = data_fn or self._default_data_fn()
        self.trainer = PaperTrainer(
            self.model_cfg, self.head_cfg, self.train_cfg, self.data_fn,
            hw_batch=batch, device=self.device, lr_fn=lr_fn,
            ckpt_dir=ckpt_dir or None, ckpt_every=ckpt_every,
            ckpt_keep=ckpt_keep, log_every=log_every, seed=seed,
            telemetry=telemetry)
        self.loads = 0       # bumped on every load_state (serving-cache probe)
        self._serve_step = None
        self._topk_steps: dict = {}
        self._engines: dict = {}

    def _default_data_fn(self):
        from repro_torch.data.synthetic import (ClassificationStream,
                                                sku_feature_batch,
                                                sku_image_batch)
        n_classes = self.model_cfg.vocab_size
        if self.model_cfg.family == "feats":
            stream = ClassificationStream(n_classes, self.model_cfg.d_model,
                                          device=self.device)
            return lambda t, b: sku_feature_batch(t, b, stream)
        return lambda t, b: sku_image_batch(t, b, n_classes,
                                            device=self.device)

    @property
    def head(self):
        return self.trainer.head

    @property
    def state(self):
        return self.trainer.state

    @property
    def weights_version(self):
        """Serving-cache invalidation probe: moves whenever the served
        weights can have changed: on every step, every weight load and
        every restore. Counting restores is what makes a rewound-then-
        retrained run (the step back at a value seen before, other
        weights) retire a cached score or IVF index."""
        return (self.loads + self.trainer.restores,
                int(self.trainer.state.step))

    def load_state(self, state) -> None:
        """Install a ``HybridState`` (for example state carried over from
        the JAX package by ``repro_torch.interop``). Training updates its
        tensors in place."""
        self.trainer.state = state
        self.loads += 1

    def fit(self, steps: int, *, use_fccs_batch: bool = True,
            resume=False, step_hook=None, telemetry=None):
        """Train ``steps`` steps from the current cursor: the FCCS learning
        rate and, with ``use_fccs_batch``, its batch growth through
        micro-batch accumulation. With ``resume=True`` the latest
        checkpoint under ``ckpt_dir`` is restored first (if there is one)
        and ``steps`` becomes the TOTAL: a killed 100-step run relaunched
        with ``fit(100, resume=True)`` replays only the lost tail.
        ``resume="reshard"`` also takes a checkpoint written on a ring of
        another size. ``step_hook(t)`` fires before each step (fault
        injection, ``repro_torch.resilience``); ``telemetry=`` installs a
        ``repro_torch.telemetry.Tracer`` on the trainer. Returns the
        history rows (step, lr, batch, loss, acc)."""
        if telemetry is not None:
            self.trainer.telemetry = telemetry
        if resume:
            self.restore(missing_ok=True, reshard=(resume == "reshard"))
            steps = steps - self.trainer._t
        if steps > 0:
            self.trainer.run(steps, use_fccs_batch=use_fccs_batch,
                             step_hook=step_hook)
        return self.trainer.history

    def restore(self, step: Optional[int] = None, *,
                missing_ok: bool = False,
                reshard: bool = False) -> Optional[int]:
        """Restore the FULL trainer state (params, moments, head aux, DGC
        buffers, cursor) from ``ckpt_dir``. ``reshard=True`` takes a
        checkpoint written on a ring of another size
        (``repro_torch.elastic``). Returns the restored step, or None when
        ``missing_ok`` and there is no checkpoint."""
        from repro_torch import checkpoint as ckpt
        if not self.trainer.ckpt_dir:
            raise ValueError("experiment has no ckpt_dir to restore from")
        if step is None and ckpt.latest_step(self.trainer.ckpt_dir) is None:
            if missing_ok:
                return None
            raise FileNotFoundError(
                f"no checkpoints under {self.trainer.ckpt_dir}")
        return self.trainer.restore_checkpoint(step, reshard=reshard)

    def _to_device(self, inputs: dict) -> dict:
        from repro_torch.train.trainer import to_device
        return to_device(inputs, self.device)

    def evaluate(self, inputs=None, *, eval_batch: Optional[int] = None
                 ) -> float:
        """Deploy-style top-1 accuracy through the head's own prediction
        (§4.5 nearest class weight; the hashed-bucket decode of mach and
        csoft)."""
        if inputs is None:
            inputs = self.data_fn(10**6, eval_batch or 4 * self.batch)
        return self.trainer.evaluate(inputs)

    def serve(self, inputs=None, *, batch: Optional[int] = None,
              top_k: Optional[int] = None, return_scores: bool = False,
              index: Optional[str] = None, nprobe: Optional[int] = None,
              telemetry=None):
        """Deploy-style retrieval (§4.5): nearest-class predictions for a
        batch of inputs.

        Greedy mode (default) returns [b] class ids. ``top_k=k`` returns
        ids [b, k] (descending), or (ids, scores) with ``return_scores``.
        ``index="ivf"`` (top-k only) serves through the experiment's
        ``IVFIndex``: probe the ``nprobe`` nearest centroids of each shard
        and rerank only their member rows.
        Without explicit ``inputs`` the call is routed through the
        serving engine (per-query submit -> one padded micro-batch ->
        batched serve step); explicit ``inputs`` run the single-shot step
        (the batch must then divide the ring), except under
        ``index="ivf"``, which always serves through the engine."""
        from repro_torch.telemetry import NULL_TRACER
        from repro_torch.train import hybrid

        _validate_serve_args(effective_vocab(self.model_cfg), batch, top_k,
                             index)
        if inputs is None or index == "ivf":
            if inputs is None:
                inputs = self.data_fn(10**6, batch or self.batch)
            queries = next(v for k, v in inputs.items() if k != "labels")
            return self._serve_via_engine(queries, top_k, return_scores,
                                          index=index, nprobe=nprobe,
                                          telemetry=telemetry)
        tr = telemetry or NULL_TRACER
        inputs = self._to_device(inputs)
        if top_k is not None:
            if top_k not in self._topk_steps:
                self._topk_steps[top_k] = hybrid.make_topk_serve_step(
                    self.model_cfg, self.head_cfg, top_k, head=self.head)
            with tr.span("serve.compute"):
                vals, ids = self._topk_steps[top_k](self.state, inputs)
                ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
            return (ids, vals) if return_scores else ids
        if self._serve_step is None:
            self._serve_step = hybrid.make_serve_step(
                self.model_cfg, self.head_cfg, head=self.head)
        with tr.span("serve.compute"):
            return self._serve_step(self.state, inputs).cpu().numpy()


# ---------------------------------------------------------------------------
# zoo system (the zoo trainer, checkpoints, feature retrieval and greedy
# token serving)
# ---------------------------------------------------------------------------


def _int32(v) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32)


class ZooExperiment(Experiment):
    """Training and serving for the zoo's dense, vlm, moe, ssm and hybrid
    decoders and its encoder-decoder with any registered softmax head: the loss goes through the head registry
    (``gspmd.make_head_train_step``), so full / knn / selective / mach /
    sampled / csoft all train. The trunk is replicated on every ring
    member and runs the whole batch; the W-heads train the model's own
    class matrix (the tied embedding or ``params.head``), each member
    scoring its row block, and the sketch heads (mach, csoft) train
    head-owned [R, B/P, D] bucket blocks (``head_state.params``). The
    head's aux (the knn graph, the LSH tables, the hashes) lives in
    ``head_state.aux`` and ``refresh_head`` rebuilds it on the head's
    ``rebuild_every`` cadence. The vocab is padded to ``n_model``
    (default: the ring size).

    ``serve`` decodes tokens greedily (prefill, then one-token steps
    through the KV cache) or, with ``top_k``, retrieves against the class
    matrix through the serving engine, exactly or through the IVF index.
    ``head.backend`` (``"kernel"`` by default) selects the kernels of every
    path but the trunk's training attention, which runs the ``ref``
    branches. ``data_fn(t, batch) -> {"tokens", "labels"}`` (the encdec
    family's with ``"frames"`` [batch, enc_seq, D]) replaces the synthetic
    stream (``_synthetic_batch``). The moe family's router losses enter
    the loss once, beside the head's; the encdec family trains, evaluates,
    retrieves and checkpoints, and its ``serve(prompt_len=...)`` raises,
    as the JAX package's does.

    ``ckpt_dir`` takes full-state checkpoints in the JAX package's layout
    (``_snapshot``: the model with its blocks stacked on [L], the head's
    params and aux, the moments, the cursor) every ``ckpt_every`` steps
    and at the end of every ``fit``, written by member 0 (``ckpt_keep``:
    retain the newest N); ``fit(resume=True)`` and ``restore`` take the
    latest back, ``resume="reshard"`` / ``restore(reshard=True)`` one
    written on a ring or grid of another shape
    (``elastic.reshard_zoo_snapshot``, then the member's cut). The ring
    has no data axis: its geometry counts one data shard.

    On a grid (``dist.grid(n_data, n_model)``, every member building the
    experiment) every family's trunk is split as the JAX package's
    ``param_pspecs`` places them under ``par`` (by default the
    JAX host tests' policy on the grid's shape; FSDP where its
    ``param_rules`` say so): each member holds its slices (``specs``), the
    batch's rows go over ``data`` as the JAX pipeline cuts them (each
    micro-batch of the GLOBAL batch split over the data shards,
    ``_member_rows``), checkpoints gather every leaf into the JAX layout
    and cut it again on restore, the geometry counts the data shards, and
    token serving decodes each data shard's prompts. Retrieval serves the
    same queries on every data member, over ``model``."""

    def __init__(self, *, arch: str = "smollm_135m", reduced: bool = False,
                 head: Optional[HeadConfig] = None,
                 train: Optional[TrainConfig] = None,
                 batch: int = 64, seq: int = 64, n_model: Optional[int] = None,
                 data_fn: Optional[Callable[[int, int], dict]] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep: int = 0, log_every: int = 10,
                 seed: int = 0, telemetry=None, device=None,
                 par: Optional[ParallelConfig] = None):
        from repro_torch.api.heads import HeadState, make_head, member_aux
        from repro_torch.models import lm
        from repro_torch.train import gspmd

        cfg = get_model_config(arch, reduced=reduced)
        on_grid = dist.grid_declared()
        lm.require_ported(cfg, grid=on_grid)
        self.device = resolve_device(device)
        if reduced:
            cfg = dataclasses.replace(cfg, dtype="float32")
        self.model_cfg = pad_vocab(cfg, n_model or dist.world_size())
        self.head_cfg = head or HeadConfig()
        if self.head_cfg.softmax_impl == "full":
            # the JAX package's zoo numerics: the full softmax on LM trunks
            # trains raw logits, matching the raw-argmax decode
            self.head_cfg = dataclasses.replace(self.head_cfg,
                                                cosine_scale=0.0)
        self.train_cfg = train or TrainConfig(optimizer="sgd")
        self.batch, self.seq = batch, seq
        self.shape = InputShape("experiment", seq, batch, "train")
        self.log_every = log_every
        self.telemetry = telemetry   # Tracer, or None = NULL_TRACER
        self.ckpt_dir = ckpt_dir or None
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        self.seed = seed
        self.last_reshard = None     # stats dict of the last elastic restore
        self.history: list = []
        self.data_fn = data_fn or self._synthetic_batch
        self.head = make_head(self.model_cfg, self.head_cfg)
        # the grid's layout (None on the ring: the trunk replicated)
        self.par = (gspmd.grid_parallel_config(par) if on_grid
                    else par or ring_parallel_config(dist.world_size()))
        self.specs = (gspmd.member_specs(self.model_cfg, self.par)
                      if on_grid else None)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            self.params = lm.init_model(gen, self.model_cfg, self.specs)
        # head-owned state: the W-heads init only aux (their class matrix
        # is the model's); the sketch heads keep [R, B/P, D] bucket blocks
        n, r = dist.world_size(), dist.rank()
        if self.head.params_are_class_weights:
            hp = ()
            aux = member_aux(self.head.init_aux(n), self.head.aux_spec(),
                             rank=r, world_size=n, device=self.device)
        else:
            hgen = torch.Generator(device=self.device)
            hgen.manual_seed(seed + 1)
            hp, aux = self.head.init(hgen, n, rank=r, device=self.device)
        self.head_state = HeadState(hp, aux)
        # the optimizer's moments and the steps are built on first use, so
        # a serve-only experiment holds only its params
        self.opt_state = None
        self._train_step = None
        self._eval_step = None
        self._refreshed = False
        self._engines: dict = {}
        self.restores = 0    # bumped on every load and every restore
        self._t = 0          # data cursor: the next step fit() takes

    @property
    def weights_version(self):
        """Moves whenever the served weights can have changed: on every
        step and every load."""
        return (self.restores, self._t)

    def load_params(self, params) -> None:
        """Install model params (a ``models.layers.ParamDict``, for example
        the JAX package's carried over by
        ``repro_torch.interop.zoo_params_from_numpy``). Training updates
        them in place."""
        self.params = params
        self.restores += 1

    def load_head_state(self, head_state) -> None:
        """Install this member's ``HeadState`` (for example the JAX
        package's, carried over by
        ``repro_torch.interop.zoo_head_state_from_numpy``): the sketch
        heads' bucket block and the aux, used as they are (no refresh
        before the next step)."""
        self.head_state = head_state
        self._refreshed = True
        self.restores += 1

    @property
    def graph(self):
        """Back-compat: the knn head's graph row (offsets, neighbors,
        ranks)."""
        return self.head_state.aux if self.head.name == "knn" else None

    @graph.setter
    def graph(self, value):
        """Back-compat: ``exp.graph = None`` forces a rebuild before the
        next fit / evaluate; a tuple installs it as the head's aux."""
        from repro_torch.api.heads import HeadState
        if value is None:
            self._refreshed = False
        else:
            self.head_state = HeadState(self.head_state.params, tuple(value))
            self._refreshed = True

    def refresh_head(self):
        """Rebuild the head's aux (the knn graph, the LSH tables) from the
        CURRENT class weights on the ring: the zoo counterpart of the paper
        trainer's refresh. A no-op for heads without periodic work."""
        from repro_torch.api.heads import HeadState
        from repro_torch.models import lm
        from repro_torch.train import gspmd

        with torch.no_grad():
            w = (gspmd.vocab_rows(lm.head_weight(self.params, self.model_cfg,
                                                 self.specs))
                 if self.head.params_are_class_weights
                 else self.head_state.params)
            hs = self.head.refresh(HeadState(w, self.head_state.aux))
        self.head_state = HeadState(self.head_state.params, hs.aux)
        self._refreshed = True
        return self.head_state

    def rebuild_graph(self):
        """Back-compat: refresh the head and return the knn graph row."""
        self.refresh_head()
        return self.graph

    def _synthetic_batch(self, t: int, b: int) -> dict:
        """The synthetic LM stream's batch t (``data.synthetic.lm_batch``);
        the encdec family's also carries ``frames`` [b, enc_seq, D]
        (``data.synthetic.frame_batch``)."""
        from repro_torch.data import synthetic
        cfg = self.model_cfg
        out = synthetic.lm_batch(t, b, self.seq, effective_vocab(cfg),
                                 device=self.device)
        if cfg.family == "encdec":
            out["frames"] = synthetic.frame_batch(
                t, b, cfg.enc_seq, cfg.d_model, device=self.device)
        return out

    def _n_micro(self) -> int:
        from repro_torch.train import gspmd
        return (self.train_cfg.micro_batch
                or gspmd.auto_micro_batches(self.model_cfg, self.shape,
                                            self.par))

    def _member_rows(self, batch: dict, n_micro: int = 1) -> dict:
        """This member's rows of a GLOBAL batch: on a grid, as the JAX
        pipeline takes them, each of the ``n_micro`` micro-batches
        (consecutive row blocks) split over the data shards, the member's
        part of each in turn; the whole batch on the ring, or where a
        micro-batch's rows do not split over the data shards, which the
        JAX trunk then runs replicated (the train step's loss takes each
        shard's share of the tokens, ``gspmd.token_share``)."""
        from repro_torch.train import gspmd
        n_data, d = dist.world_size(dist.BATCH), dist.rank(dist.BATCH)
        b = next(iter(batch.values())).shape[0]
        if n_data == 1 or not gspmd.rows_split(b // n_micro, self.par):
            return batch
        per = b // (n_micro * n_data)
        return {k: v.reshape((n_micro, n_data, per) + tuple(v.shape[1:]))[
                    :, d].reshape((n_micro * per,) + tuple(v.shape[1:]))
                for k, v in batch.items()}

    def _batch(self, t: int) -> dict:
        from repro_torch.train.trainer import to_device
        return self._member_rows(
            to_device(self.data_fn(t, self.batch), self.device),
            self._n_micro())

    def _ensure_opt(self):
        """The optimizer state over (params, head params) and the train
        step, built on first use."""
        from repro_torch.optim import make_optimizer
        from repro_torch.train import gspmd
        if self.opt_state is None:
            self.opt_state = make_optimizer(self.train_cfg).init(
                (self.params, self.head_state.params))
        if self._train_step is None:
            self._train_step = gspmd.make_head_train_step(
                self.model_cfg, self.head_cfg, self.train_cfg, self.shape,
                head=self.head, par=self.par, specs=self.specs)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def load_opt_state(self, opt_state) -> None:
        """Install this member's optimizer state (for example the JAX
        package's, carried over by
        ``repro_torch.interop.zoo_opt_state_from_numpy``), so a run
        continues mid-stream with its moments."""
        self._ensure_opt()
        self.opt_state = opt_state
        self.restores += 1

    # -- full-state checkpoint / restore ----------------------------------

    @torch.no_grad()
    def _snapshot(self, gather: bool = True) -> dict:
        """The checkpoint tree, GLOBAL, in the JAX package's layout: the
        model params (blocks stacked on [L]), the head's params (the sketch
        heads' buckets; ``()`` for the W-heads) and aux (``state_to_save``),
        the optimizer moments, which mirror (model, head params), and the
        data cursor. A collective on a ring. ``gather=False`` gives the
        same tree paths over this member's own tensors, with no collective
        and no copy of the model: the template a restore reads the leaf
        names from."""
        from repro_torch.api.heads import HeadState
        from repro_torch.models import lm
        from repro_torch.optim import OptState

        self._ensure_opt()
        hs, opt = self.head_state, self.opt_state
        if gather:
            head_tree = self.head.state_to_save(HeadState(hs.params, hs.aux))
            gather_params = self.head.gather_params
        else:
            head_tree = {"params": hs.params, "aux": tuple(hs.aux)}
            gather_params = (lambda a: a)

        def model(params):
            if gather and self.specs is not None:
                params = lm.gather_params(params, self.specs)
            return lm.params_tree(params, stacked=gather)

        def moments(pair):
            if pair is None:
                return None
            return (model(pair[0]), gather_params(pair[1]))

        return {"model": model(self.params), "head": head_tree,
                "opt": OptState(step=_int32(opt.step), mu=moments(opt.mu),
                                nu=moments(opt.nu)),
                "extra": {"t": _int32(self._t), "seed": _int32(self.seed)}}

    def geometry(self):
        """This experiment's ``elastic.MeshGeometry``: the ring counts the
        vocab row shards, there is one data shard, and the classes are the
        REAL (unpadded) vocabulary, which is ring-invariant (the padding
        goes into the checkpoint's meta)."""
        from repro_torch.elastic import MeshGeometry
        return MeshGeometry(n_model=dist.world_size(),
                            n_data=dist.world_size(dist.BATCH),
                            n_classes=effective_vocab(self.model_cfg))

    def save_checkpoint(self) -> Optional[str]:
        """An atomic full-state snapshot at the current cursor, written by
        member 0 with the geometry and the padded vocab as its meta; every
        member returns once the file is complete. Returns the file's path
        on member 0, None on the others. The tracer's counters
        ``train.checkpoint.fetch_s`` / ``write_s`` take it apart."""
        from repro_torch import checkpoint as ckpt
        from repro_torch.telemetry import NULL_TRACER
        if not self.ckpt_dir:
            raise ValueError("experiment has no ckpt_dir")
        tree = self._snapshot()
        fname = None
        if dist.rank(dist.ALL) == 0:
            tr = self.telemetry or NULL_TRACER
            meta = {"system": "zoo", **self.geometry().meta(),
                    "padded_vocab": self.model_cfg.vocab_size}
            self._sync()        # the fetches wait on no pending step
            parts = {}
            fname = ckpt.save(self.ckpt_dir, tree, step=self._t,
                              keep=self.ckpt_keep or None, meta=meta,
                              timings=parts)
            tr.count("train.checkpoint.fetch_s", parts["fetch_s"])
            tr.count("train.checkpoint.write_s", parts["write_s"])
        dist.barrier()
        return fname

    def restore(self, step: Optional[int] = None, *,
                missing_ok: bool = False,
                reshard: bool = False) -> Optional[int]:
        """Refill the model, the head's state and the optimizer from
        ``ckpt_dir`` (the latest step by default) and move the cursor. The
        restored aux is installed as it is, not rebuilt: a run killed
        mid-refresh-interval resumes with the graph or tables the killed
        run used. ``reshard=True`` takes a checkpoint written on a ring of
        another size (``repro_torch.elastic``); without it a ring mismatch
        raises ``ReshardError`` before any leaf is decoded. Returns the
        restored step, or None when ``missing_ok`` and there is none."""
        from repro_torch import checkpoint as ckpt
        from repro_torch.telemetry import NULL_TRACER
        if not self.ckpt_dir:
            raise ValueError("experiment has no ckpt_dir to restore from")
        if step is None and ckpt.latest_step(self.ckpt_dir) is None:
            if missing_ok:
                return None
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        tr = self.telemetry or NULL_TRACER
        with tr.span("train.restore"):
            return self._do_restore(step, tr, reshard)

    def _do_restore(self, step, tr, reshard: bool) -> int:
        import time

        from repro_torch import checkpoint as ckpt
        from repro_torch import elastic, interop
        from repro_torch.models import lm

        dst = self.geometry()
        src = ckpt.validate_restore(self.ckpt_dir, dst, step,
                                    reshard=reshard)
        src_meta = ckpt.read_meta(self.ckpt_dir, step) or {}
        parts = {}
        tree, step = ckpt.restore(self.ckpt_dir, self._snapshot(gather=False),
                                  step, timings=parts)
        tr.count("train.restore.read_s", parts["read_s"])
        needs_refresh = False
        if (src.n_model, src.n_data) != (dst.n_model, dst.n_data):
            # the tree is GLOBAL in the JAX layout: resharded for the dst
            # geometry, then cut by this member's specs below, as the JAX
            # _do_restore places it by the new mesh's shardings
            t0 = time.perf_counter()
            with tr.span("train.reshard", attrs={"src": src.describe(),
                                                 "dst": dst.describe()}):
                tree, needs_refresh, led = elastic.reshard_zoo_snapshot(
                    tree, self.head, self.model_cfg, src, dst,
                    padded_vocab_src=int(src_meta.get(
                        "padded_vocab", self.model_cfg.vocab_size)))
            tr.count("reshard.bytes_moved", led.total_bytes())
            self.last_reshard = {
                "src": src, "dst": dst, "bytes_moved": led.total_bytes(),
                "ledger": led, "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        r, n = dist.rank(), dist.world_size()
        self.params = interop.zoo_params_from_numpy(
            tree["model"], self.model_cfg, rank=r, world_size=n,
            device=self.device, specs=self.specs)
        self.head_state = interop.zoo_head_state_from_numpy(
            self.head, tree["head"]["params"], tree["head"]["aux"], rank=r,
            world_size=n, device=self.device)
        opt = tree["opt"]
        self.opt_state = interop.zoo_opt_state_from_numpy(
            {"step": opt.step, "mu": opt.mu, "nu": opt.nu}, self.model_cfg,
            rank=r, world_size=n, device=self.device, specs=self.specs)
        self._sync()
        tr.count("train.restore.place_s", time.perf_counter() - t0)
        self._t = int(tree["extra"]["t"])
        self.restores += 1
        tr.count("train.restores")
        # the aux came from the snapshot: no rebuild before the next step,
        # unless the elastic path asked for the head's own refresh
        self._refreshed = not needs_refresh
        return step

    def fit(self, steps: int, *, lr: float = 0.5, resume=False,
            step_hook=None, telemetry=None):
        """Train ``steps`` steps from the current cursor at learning rate
        ``lr``. Heads with derived aux (the knn graph, the LSH tables)
        rebuild it from the class weights before the first step, and every
        ``rebuild_every`` steps. ``step_hook(t)`` fires before each step;
        ``telemetry=`` installs a ``repro_torch.telemetry.Tracer`` (spans
        ``train.data``, ``train.step``, ``train.refresh``,
        ``train.checkpoint``; counters ``train.steps``,
        ``train.refreshes``, ``train.checkpoints``; one metrics row a
        step). ``resume=True`` restores the latest checkpoint under
        ``ckpt_dir`` first (if there is one) and makes ``steps`` the TOTAL,
        as ``PaperExperiment.fit`` does; ``resume="reshard"`` also takes
        one written on a ring of another size.
        Returns the history rows (step, loss, acc, and the head's own
        metrics: knn's and selective's ``active_frac`` and
        ``label_recall``, sampled's ``sample_frac``)."""
        from repro_torch.telemetry import NULL_TRACER

        if telemetry is not None:
            self.telemetry = telemetry
        tr = self.telemetry or NULL_TRACER
        if resume:
            self.restore(missing_ok=True, reshard=(resume == "reshard"))
            steps = steps - self._t
            if steps <= 0:
                return self.history
        if not self._refreshed:
            self.refresh_head()
        self._ensure_opt()
        refresh_every = self.head.refresh_every
        own = [k for k in self.head.metrics_spec()
               if k not in ("accuracy", "logz")]
        lead = dist.rank(dist.ALL) == 0     # the group's member 0 prints
        start = self._t
        for t in range(start, start + steps):
            if step_hook is not None:
                step_hook(t)
            with tr.span("train.data"):
                inputs = self._batch(t)
            with tr.span("train.step"):
                self.params, self.head_state, self.opt_state, loss, \
                    metrics = self._train_step(self.params, self.head_state,
                                               self.opt_state, inputs, lr)
                if tr.enabled:
                    self._sync()
            tr.count("train.steps")
            self._t = t + 1
            if refresh_every and (t + 1) % refresh_every == 0:
                with tr.span("train.refresh"):
                    self.refresh_head()
                tr.count("train.refreshes")
            if self.ckpt_dir and self.ckpt_every and \
                    (t + 1) % self.ckpt_every == 0:
                with tr.span("train.checkpoint"):
                    self.save_checkpoint()
                tr.count("train.checkpoints")
            row = {"step": t, "loss": float(loss),
                   "acc": float(metrics["accuracy"])}
            row.update({k: float(metrics[k]) for k in own})
            self.history.append(row)
            tr.log_metrics(row)
            if self.log_every and t % self.log_every == 0 and lead:
                print(f"[zoo] step={t} loss={row['loss']:.4f} "
                      f"acc={row['acc']:.3f}")
        tr.record_peak_memory()
        if self.ckpt_dir:
            # the end-of-fit snapshot: the full state (the sketch heads'
            # buckets included), resumable
            with tr.span("train.checkpoint"):
                self.save_checkpoint()
            if self.log_every and lead:
                print(f"[zoo] checkpoint written to {self.ckpt_dir}")
        return self.history

    def evaluate(self, inputs=None) -> float:
        """Deploy-style top-1 next-token accuracy on a held-out (late
        stream) batch, through the head's own prediction (§4.5 retrieval
        for the W-heads, the hashed-bucket decode for mach and csoft)."""
        from repro_torch.train import gspmd
        from repro_torch.train.trainer import to_device

        if not self._refreshed:
            self.refresh_head()
        inputs = self._member_rows(to_device(
            self.data_fn(10**6, self.batch) if inputs is None else inputs,
            self.device))
        if self._eval_step is None:
            self._eval_step = gspmd.make_head_eval_step(
                self.model_cfg, self.head_cfg, head=self.head, par=self.par,
                specs=self.specs)
        return float(self._eval_step(self.params, self.head_state.params,
                                     self.head_state.aux, inputs))

    def serve(self, *, prompt_len: int = 32, gen: int = 16,
              batch: Optional[int] = None, top_k: Optional[int] = None,
              queries=None, return_scores: bool = False,
              index: Optional[str] = None, nprobe: Optional[int] = None,
              telemetry=None):
        """Batched greedy decoding: prefill ``prompt_len`` tokens of the
        synthetic LM stream once, then ``gen - 1`` single-token decode
        steps through the KV / SSM cache and the sharded-vocab argmax. Returns
        the generated tokens [batch, gen] (numpy int32). Spans
        ``serve.prefill`` / ``serve.decode`` and the counter
        ``serve.decoded_tokens`` go to ``telemetry``.

        ``top_k=k`` switches to feature retrieval against the model's
        class matrix (the contract of ``PaperExperiment.serve(top_k=...)``,
        W-heads only): ``queries`` [b, d_model] embeddings (by default the
        JAX package's pool, ``np.random.default_rng(0).standard_normal((b,
        d_model))``) -> ids [b, k] (or (ids, scores) with
        ``return_scores``), through the serving engine; ``index="ivf"``
        routes it through the experiment's ``IVFIndex``."""
        from repro_torch.data import synthetic
        from repro_torch.models import decoder, lm
        from repro_torch.telemetry import NULL_TRACER
        from repro_torch.train import gspmd

        tr = telemetry or NULL_TRACER
        _validate_serve_args(effective_vocab(self.model_cfg), batch, top_k,
                             index)
        if top_k is not None:
            if queries is None:
                queries = np.random.default_rng(0).standard_normal(
                    (batch or self.batch, self.model_cfg.d_model))
            return self._serve_via_engine(queries, top_k, return_scores,
                                          index=index, nprobe=nprobe,
                                          telemetry=telemetry)
        if queries is not None:
            raise ValueError("queries= are for top-k feature retrieval; "
                             "pass top_k=...")
        if prompt_len <= 0 or gen <= 0:
            raise ValueError(
                f"prompt_len and gen must be positive, got "
                f"prompt_len={prompt_len} gen={gen}")
        if self.model_cfg.family == "encdec":
            raise NotImplementedError(
                "serve() decodes decoder-only archs, as the JAX package's "
                "does; the encoder-decoder's greedy decode runs through "
                "models.lm.decode with the cross caches (models.encdec)")
        if not self.head.params_are_class_weights:
            raise NotImplementedError(
                f"zoo serve() decodes with the model's [V, D] head weight, "
                f"which the {self.head.name!r} head does not train; use "
                f"evaluate() (hashed-bucket decode) or a W-head "
                f"(full/knn/selective/sampled) for token serving")
        cfg = self.model_cfg
        batch = batch or self.batch
        total = prompt_len + gen
        dshape = InputShape("serve-decode", total, batch, "decode")
        backend = self.head_cfg.backend
        with torch.no_grad():
            prompts = self._member_rows(synthetic.lm_batch(
                0, batch, prompt_len, effective_vocab(cfg),
                device=self.device))
            window = lm.decode_window(cfg, total)
            prefill = gspmd.make_prefill_step(cfg, dshape, backend=backend,
                                              specs=self.specs)
            serve = gspmd.make_serve_step(cfg, dshape, backend=backend,
                                          specs=self.specs)
            with tr.span("serve.prefill"):
                tok, caches = prefill(self.params,
                                      {"tokens": prompts["tokens"]})
                if tr.enabled:
                    self._sync()

            def grow(c):
                # K/V of a prompt shorter than the window: pad to its slots
                if c.shape[2] == prompt_len:
                    return torch.nn.functional.pad(
                        c, (0, 0) * (c.dim() - 3) + (0, window - prompt_len))
                return c
            caches = {k: grow(c) if k in ("k", "v") else c
                      for k, c in caches.items()}
            slots = decoder.init_cache_slots(
                cfg, window, prefill_positions=torch.arange(
                    prompt_len, device=self.device))
            out = [tok]
            tok = tok[:, None]
            with tr.span("serve.decode"):
                for _ in range(gen - 1):
                    tok, caches, slots = serve(self.params, caches, slots,
                                               tok)
                    out.append(tok[:, 0])
                toks = torch.stack(out, dim=1)
                if toks.shape[0] != batch:     # each data shard's prompts
                    toks = dist.all_gather(toks, axis=dist.BATCH)
                toks = toks.cpu().numpy()
        tr.count("serve.decoded_tokens", float(toks.shape[0] * gen))
        return toks
