"""Train step: augment, forward, loss, gradient exchange, optimizer.

Counterpart of ``tf_face_toolbox_tpu/train/trainer.py``. Each process
is one rank of a (data, model) grid (``parallel.mesh.Topology``; none:
one device). The classifier's classes are padded to a multiple of the
model size, C_pad, and rank (d, m) holds shard m of them (the
class-sharded Partial-FC head, ``parallel/sharded_softmax.py``). A
step, on each rank:

1. takes its rows, block d * model + m of the global batch (global
   batch / (data * model) rows), or its own rows when given only those;
2. augments them (random crop, flip, per-image standardization; with
   ``pallas_input``, the crop then the fused input kernel,
   ``ops/fused_preprocess.py``), optional random erase;
3. forwards in ``cfg.dtype`` in train mode (each rank's own batch
   statistics; the updated running statistics come back in a
   ``TrainContext``); gathers the f32 embeddings and labels of its model
   row; takes the exact or, with ``pfc_sample_rate`` < 1, the sampled
   sharded margin-softmax loss against its f32 shard (the row's mean),
   or CurricularFace's, with MagFace's or AdaFace's per-sample margins
   and the center and triplet losses on the gathered rows added; with a
   ``teacher``, the embedding distillation term on this rank's own rows
   (``alpha * mean(1 - cos)``, the margin term weighted 1 - alpha, or
   skipped at alpha 1); and backward of that objective over the model
   size (the psums inside it sum each rank's cotangent, JAX's algebra);
4. exchanges, as the JAX step does (``parallel/collectives.py``): the
   backbone's gradient summed over the model row and averaged over the
   data axis; the classifier shard's averaged over its data column (the
   sampled head averaged its compact gradient in backward already); the
   loss's parts and the running statistics averaged over every rank;
5. then, in order, on the same values on every rank: the global
   gradient norm (the shards' squared norms summed over the model row),
   ``grad_clip_norm``, the optimizer (``train/optimizers.py``: SGD,
   Adam, AdamW or LARS, weight decay on conv and Dense kernels and the
   classifier; a parameter no gradient reaches steps on zeros), the
   EMA ``d * e + (1 - d) * p``, the loss
   heads' state (``head_state``: AdaFace's norm statistics and
   CurricularFace's t as the head computed them, the center shard by
   the delta rule over the global batch), and ``skip_nonfinite`` on the
   averaged loss and norm (so every rank skips together; nothing but
   ``step`` changes).

``accum_steps`` splits a rank's rows into micro-batches whose forwards
advance the BN statistics one after another; their gradients are summed
and divided by the count. Augmentation and dropout draw from generators
seeded from (state.rng, step, stream), and (state.rng, step, rank,
stream) on ranks above 0 (JAX folds the device's position into its
step key), not JAX's threefry stream; the sampled head's keys from
(state.rng, step, 0x9FC, model index), the same on every data rank.

``quantized="qat"``: quantization-aware training. The train forward
fake-quantizes every bottleneck conv's input (per tensor) and kernel
(per output channel) and the stream between blocks onto the int8 grid,
with straight-through gradients (``models/layers.py``), so the
checkpoint serves through calibrate -> static int8 with little drift.
Each scale is the max over the rank's own rows, as JAX's inside
``shard_map``: no all-reduce.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models import create_network, init_parameters
from tf_face_toolbox_tpu_torch.models.layers import (
    BatchNorm,
    TrainContext,
    l2_normalize,
)
from tf_face_toolbox_tpu_torch.ops import preprocess as pp
from tf_face_toolbox_tpu_torch.ops.jpeg import decode_dct
from tf_face_toolbox_tpu_torch.ops.losses import (
    AdaFaceConfig,
    MagFaceConfig,
    MarginConfig,
    adaface_margins,
    adaface_norms,
    adaface_stats_init,
    batch_hard_triplet_loss,
    curricular_t_init,
    init_classifier_weights,
    magface_margins,
)
from tf_face_toolbox_tpu_torch.parallel import collectives
from tf_face_toolbox_tpu_torch.parallel.mesh import rank_batch_size
from tf_face_toolbox_tpu_torch.parallel.sharded_softmax import (
    sampled_sharded_margin_softmax_loss,
    sharded_center_loss,
    sharded_center_update,
    sharded_curricular_loss,
    sharded_margin_softmax_loss,
)
from tf_face_toolbox_tpu_torch.train import optimizers
from tf_face_toolbox_tpu_torch.train.schedule import cosine, staircase
from tf_face_toolbox_tpu_torch.train.state import TrainState

# generator streams of a step (the JAX trainer's fold_in tags)
_AUGMENT, _ERASE, _DROPOUT, _PFC = 0, 0xE5A5E, 0x0D12, 0x9FC
_MODES = ("fixed", "magface", "adaface", "curricular")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """All training hyperparameters: the JAX ``TrainConfig``'s fields and
    defaults, with ``dtype`` a torch dtype. Fields of paths not ported
    yet raise at construction, naming the ROADMAP.md item."""
    network: str = "resnet_v1_50"
    stem: str = "face"          # "face" | "imagenet"
    head_variant: str = "gap"
    dropout_rate: float = 0.0   # flatten head, train mode only
    drop_path_rate: float = 0.0     # ViT family: stochastic depth
    embedding_dim: int = 512
    num_classes: int = 10572          # CASIA-WebFace identity count
    image_size: int = 112
    global_batch: int = 256
    optimizer: str = "sgd"            # sgd | adam | adamw | lars
    base_lr: float = 0.1
    lr_schedule: str = "staircase"    # or "cosine" (needs lr_total_steps)
    lr_boundaries: tuple[int, ...] = (100_000, 160_000, 220_000)
    lr_decay: float = 0.1
    lr_total_steps: int = 0
    warmup_steps: int = 0
    momentum: float = 0.9
    weight_decay: float = 5e-4
    grad_clip_norm: float = 0.0       # global L2 norm before SGD; 0 = off
    margin_scale: float = 64.0
    margin_m1: float = 1.0
    margin_m2: float = 0.0
    margin_m3: float = 0.35           # CosFace default
    # fixed | magface | adaface | curricular; magface and adaface add
    # their per-sample terms to m1/m2/m3, curricular's margin is m2
    margin_mode: str = "fixed"
    magface: MagFaceConfig = MagFaceConfig()
    adaface: AdaFaceConfig = AdaFaceConfig()
    subcenters: int = 1
    center_weight: float = 0.0        # center loss, added to the margin's
    center_alpha: float = 0.5         # the centers' delta-rule step
    triplet_weight: float = 0.0       # batch-hard triplet, a data row's
    triplet_margin: float = 0.3
    pfc_sample_rate: float = 1.0      # sampled Partial-FC; 1 = exact
    dtype: Any = torch.float32        # torch.bfloat16 on the card
    augment: bool = True              # crop/flip/standardize a u8 batch
    crop_from: int = 120              # source size when augmenting
    random_erase: float = 0.0         # per-image probability; 0 = off
    accum_steps: int = 1
    skip_nonfinite: bool = False
    input_norm: str = "per_image"     # or "fixed": (x - 127.5) / 127.5
    ema_decay: float = 0.0            # 0 = off
    pallas_input: bool = False        # augment through the fused kernel
    quantized: Any = False            # "qat": quantization-aware training
    distill_alpha: float = 1.0        # the distill weight, with a teacher

    def __post_init__(self):
        if self.optimizer not in optimizers.SLOTS:
            raise ValueError(f"unknown optimizer '{self.optimizer}'; "
                             "have sgd|adam|adamw|lars")
        if self.margin_mode not in _MODES:
            raise ValueError(f"unknown margin_mode '{self.margin_mode}'; "
                             "have fixed|magface|adaface|curricular")
        if self.drop_path_rate > 0 and not self.network.startswith("dct_vit"):
            raise ValueError(
                "drop_path_rate is a ViT-family knob (stochastic depth over "
                f"transformer blocks); network={self.network!r} has no block "
                "drop path")
        if self.subcenters < 1:
            raise ValueError(f"subcenters must be >= 1 (got "
                             f"{self.subcenters})")
        if self.pfc_sample_rate < 1.0 and self.subcenters > 1:
            raise ValueError(
                "sampled Partial-FC (pfc_sample_rate < 1) cannot pool "
                "sub-centers: uniform row sampling would split classes - "
                "use the exact head (pfc_sample_rate=1) with subcenters")
        if self.pfc_sample_rate < 1.0 and self.margin_mode == "curricular":
            raise ValueError(
                "sampled Partial-FC cannot combine with curricular: the "
                "hard-negative modulation is defined over ALL negatives - "
                "use the exact head (pfc_sample_rate=1)")
        if self.accum_steps > 1 and (self.margin_mode != "fixed"
                                     or self.center_weight > 0):
            raise ValueError(
                "accum_steps>1 supports stateless losses only: adaptive "
                "margin modes (magface/adaface/curricular) and center loss "
                "update per-STEP head state, which micro-batches would "
                "apply K times per step")

    @property
    def margin(self) -> MarginConfig:
        return MarginConfig(scale=self.margin_scale, m1=self.margin_m1,
                            m2=self.margin_m2, m3=self.margin_m3)


def padded_classes(num_classes: int, model: int) -> int:
    """Classes padded up to a multiple of the model axis (JAX's
    ``_padded_classes``); the head masks the pads."""
    return -(-num_classes // model) * model


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    if cfg.lr_schedule == "cosine":
        return cosine(cfg.base_lr, cfg.lr_total_steps, cfg.warmup_steps)
    if cfg.lr_schedule == "staircase":
        return staircase(cfg.base_lr, cfg.lr_boundaries, cfg.lr_decay,
                         cfg.warmup_steps)
    raise ValueError(f"unknown lr_schedule '{cfg.lr_schedule}'; "
                     "have staircase|cosine")


def make_optimizer(cfg: TrainConfig, net: torch.nn.Module,
                   classifier: torch.Tensor,
                   mesh=None) -> torch.optim.Optimizer:
    """``cfg.optimizer`` (``train/optimizers.py``) in two groups: weight
    decay on every conv and Dense kernel and on the classifier; none on
    BatchNorm scales and biases or Dense biases. Every parameter is one
    JAX leaf (LARS takes its norms per leaf). Its learning rate is set
    from the schedule before each update (``make_train_step``).
    ``mesh``: the classifier is this rank's shard of the model row's."""
    from tf_face_toolbox_tpu_torch.interop import port

    leaves = [(key, t) for key, t, _ in port.jax_leaves(net)
              if key.startswith("params/")]
    params = list(net.parameters())
    if sorted(id(t) for _, t in leaves) != sorted(map(id, params)):
        raise ValueError("the network's parameters are not its JAX leaves "
                         "one for one")
    kernels = {id(t) for key, t in leaves if key.endswith("/kernel")}
    decay = [p for p in params if id(p) in kernels] + [classifier]
    plain = [p for p in params if id(p) not in kernels]
    return optimizers.build(
        cfg.optimizer,
        [{"params": decay, "weight_decay": cfg.weight_decay},
         {"params": plain, "weight_decay": 0.0}],
        lr=cfg.base_lr, momentum=cfg.momentum, classifier=classifier,
        mesh=mesh)


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1, np.uint64)[0] >> 1)


def _generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed(*parts))


def build_network(cfg: TrainConfig, **overrides) -> torch.nn.Module:
    """The backbone ``cfg`` names (``overrides``: other ResNet fields, such
    as ``remat``); a ViT's drop path rate and the QAT mode where they are
    set."""
    if cfg.drop_path_rate > 0:
        overrides["drop_path_rate"] = cfg.drop_path_rate
    if cfg.quantized:
        overrides["quantized"] = cfg.quantized
    return create_network(cfg.network, embedding_dim=cfg.embedding_dim,
                          dtype=cfg.dtype, stem=cfg.stem,
                          head_variant=cfg.head_variant,
                          dropout_rate=cfg.dropout_rate,
                          input_size=cfg.image_size, **overrides)


def create_train_state(cfg: TrainConfig, seed: int = 0, *,
                       net: torch.nn.Module | None = None,
                       variables: dict | None = None,
                       classifier: np.ndarray | None = None,
                       mesh=None, whole_classifier: bool = False,
                       device="cuda") -> tuple[TrainState, torch.nn.Module]:
    """Network, classifier shard and optimizer, ready to train on
    ``device``.

    Fresh by default: the JAX initialisers' distributions
    (``models.init_parameters``) and a N(0, 1) * 0.01 classifier of the
    global (C_pad * K, D) shape, drawn from generators seeded from
    ``seed``. ``variables`` (a flat JAX-key dict or tree, the ``.npz``
    hand-off) and ``classifier`` (global shape) start from given values
    instead. ``net`` injects a backbone. ``mesh``: the rank keeps rows
    [m * C_local * K, (m + 1) * C_local * K) of the classifier, m its
    model index; with several ranks, every rank must build the same
    network and global classifier, which one checksum exchange checks
    (it raises on every rank otherwise). ``whole_classifier``: keep the
    global classifier (the state of ``parallel.reference``'s plain
    version of the step). The loss heads' state (``head_state``, None
    without one): AdaFace's norm statistics (mean 20, std 100),
    CurricularFace's t (0), and f32 zero centers of the C_pad classes,
    split over the model axis as the classifier is (whole with
    ``whole_classifier``). Returns (state, net).
    """
    if net is None:
        net = build_network(cfg)
    if variables is not None:
        from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
        load_jax_variables(net, variables)
    else:
        init_parameters(net, _seed(seed, 0))
    net.to(device).train()
    model = mesh.model if mesh is not None else 1
    rows = padded_classes(cfg.num_classes, model) * cfg.subcenters
    if classifier is None:
        w = init_classifier_weights(rows, cfg.embedding_dim,
                                    generator=_generator("cpu", seed, 1))
    else:
        w = torch.tensor(np.asarray(classifier, np.float32))    # a copy
        if tuple(w.shape) != (rows, cfg.embedding_dim):
            raise ValueError(f"classifier {tuple(w.shape)} != "
                             f"{(rows, cfg.embedding_dim)}")
    w = w.to(device)
    params = dict(net.named_parameters())
    buffers = dict(net.named_buffers())
    collectives.check_replicated([*params.values(), *buffers.values(), w],
                                 mesh, "the initial train state")
    if not whole_classifier:
        shard = rows // model
        m = mesh.model_index if mesh is not None else 0
        w = w[m * shard:(m + 1) * shard].clone()
    w.requires_grad_(True)
    opt = make_optimizer(cfg, net, w, None if whole_classifier else mesh)
    head_state = {}
    if cfg.margin_mode == "adaface":
        head_state["adaface"] = adaface_stats_init(device)
    elif cfg.margin_mode == "curricular":
        head_state["curricular"] = curricular_t_init(device)
    if cfg.center_weight > 0:
        c_pad = padded_classes(cfg.num_classes, model)
        head_state["centers"] = torch.zeros(
            (c_pad if whole_classifier else c_pad // model,
             cfg.embedding_dim), dtype=torch.float32, device=device)
    state = TrainState(
        step=0, params=params, batch_stats=buffers, classifier=w,
        opt_state={"optimizer": opt, "name": cfg.optimizer, "count": 0},
        rng=seed,
        ema_params=({k: p.detach().clone() for k, p in params.items()}
                    if cfg.ema_decay > 0 else None),
        head_state=head_state or None)
    return state, net


def _frozen(teacher, device) -> torch.nn.Module:
    """A distillation teacher as an eval-mode module on ``device`` with no
    trainable parameters: a module holding its weights, or ``(module,
    variables)`` with the variables (flat JAX keys or a tree) loaded."""
    if isinstance(teacher, tuple):
        net, variables = teacher
        if variables is not None:
            from tf_face_toolbox_tpu_torch.interop.port import (
                load_jax_variables)
            load_jax_variables(net, variables)
        teacher = net
    return teacher.to(device).eval().requires_grad_(False)


def _augment(cfg: TrainConfig, images: torch.Tensor, step_gen: torch.Generator,
             erase_gen: torch.Generator) -> torch.Tensor:
    """Random crop, flip and standardization of a u8 batch; offsets and
    the flip mask come from ``step_gen`` (on the host) in that order on
    both routes, so the kernel route and the plain one see the same
    draws."""
    size = cfg.image_size
    if cfg.pallas_input and cfg.input_norm == "per_image":
        from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
            fused_preprocess)

        n, h, w, _ = images.shape
        offs = pp.random_offsets(step_gen, n, h, w, size, size)
        flips = pp.random_flip_mask(step_gen, n)
        # a contiguous u8 crop: the kernel reads whole images
        cropped = pp.crop_at(images, offs, size, size).contiguous()
        x = fused_preprocess(cropped, flips.to(images.device, torch.int32),
                             out_h=size, out_w=size, out_dtype=cfg.dtype)
    else:
        x = pp.preprocess_train(step_gen, images, size, size, cfg.input_norm)
    if cfg.random_erase > 0:
        x = pp.random_erase(erase_gen, x, cfg.random_erase)
    return x


def _grad_norm(grads: list[torch.Tensor], mesh=None) -> torch.Tensor:
    """The global L2 norm; the classifier (last) is a shard of the model
    row's, whose squared norms are summed over the row."""
    norms = list(torch._foreach_norm(grads))
    if collectives.model_sharded(mesh):
        norms[-1] = collectives.model_psum(norms[-1].square(), mesh).sqrt()
    return torch.linalg.vector_norm(torch.stack(norms))


def adaface_moments(norms: torch.Tensor, mesh=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch's mean and std (ddof=1) of AdaFace's norms: sums
    over a model row's rows (the same on each of its ranks) summed over
    the data axis, in two passes."""
    # the count by a fill on the device: a host tensor's copy would wait
    # for the queued forward
    total = collectives.data_psum(torch.stack(
        [norms.sum(), norms.new_full((), float(norms.numel()))]), mesh)
    mean = total[0] / total[1]
    ss = collectives.data_psum(((norms - mean) ** 2).sum(), mesh)
    return mean, torch.sqrt(ss / torch.clamp_min(total[1] - 1.0, 1.0))


def mean_terms(steps: list[dict]) -> dict:
    """Each term's mean over the micro-batches' ``objective`` terms,
    detached (one micro-batch: its values exactly)."""
    return {name: torch.stack([t[name].detach() for t in steps]).mean()
            for name in steps[0]}


def make_train_step(net: torch.nn.Module, cfg: TrainConfig,
                    state: TrainState, *, mesh=None, input_format: str = "u8",
                    teacher=None) -> Callable:
    """``step_fn(state, images, labels) -> (state, metrics)``.

    ``teacher``: a frozen distillation teacher, a port module holding its
    weights or ``(module, variables)`` (the flat JAX-key dict or tree;
    JAX's ``(teacher_net, teacher_variables)``). It forwards the same
    augmented views in eval mode, in ``cfg.dtype``, under no_grad, and
    the objective becomes ``cfg.distill_alpha * mean(1 - cos)`` over the
    rank's rows, plus ``(1 - alpha)`` times the margin loss when alpha <
    1 (at alpha 1 the margin head is not run and the classifier steps on
    a zero gradient).

    ``images``: (B, crop_from, crop_from, 3) uint8 when ``cfg.augment``,
    else (B, image_size, image_size, 3) standardized f32; with
    ``input_format="dct"``, the (coef, qtab) pair of
    ``data.pipeline.native_dct_batch_iterator`` instead, which the step
    decodes to uint8 frames on the device (``ops/jpeg.decode_dct``)
    before the u8 step; ``labels``: (B,) ints. Tensors on the state's
    device, or numpy arrays. With ``mesh`` (a ``parallel.mesh.Topology``
    of several ranks) B is the global batch, of which this rank takes
    its rows, or this rank's rows alone; every rank calls ``step_fn``
    once a step. The state is updated in place and returned. Metrics (the same on every rank):
    ``loss`` (the global batch's objective: the margin loss plus the
    weighted auxiliary terms), ``grad_norm`` (before the clip),
    ``center_loss``, ``triplet_loss``, ``magface_reg_loss`` (each term
    unweighted, where on), ``distill_loss`` and, when alpha < 1,
    ``margin_loss`` with a teacher, ``adaface_norm_mean`` and ``curricular_t``
    (the head state after the step) and, with ``skip_nonfinite``,
    ``skipped_nonfinite``, as tensors or floats; ``learning_rate`` = the
    schedule at ``state.step`` (the applied rate follows the optimizer's
    count, which a skipped step holds).
    """
    parts = StepParts(net, cfg, state, mesh, input_format=input_format,
                      teacher=teacher)

    def step_fn(state: TrainState, images, labels):
        images, labels = parts.rows(images, labels)
        terms, stats, update = parts.local(state, images, labels, parts.rank)
        grads = parts.grads(state)
        collectives.sync_gradients(grads[:-1], mesh)
        if parts.budget is None:
            # the sampled head averaged its compact gradient in backward
            collectives.sync_classifier_gradients(grads[-1:], mesh)
        mean = collectives.replicate_mean(torch.stack(list(terms.values())),
                                          mesh)
        collectives.sync_batch_stats([t for pair in stats.values()
                                      for t in pair], mesh)
        return parts.apply(state, dict(zip(terms, mean)), stats, update)

    if input_format == "u8":
        return step_fn

    def dct_step(state: TrainState, images, labels):
        # this rank's rows, decoded: the u8 step then takes them whole
        coef, qtab = (torch.as_tensor(a) for a in images)
        coef, rows = parts.rows(coef, labels)
        qtab, _ = parts.rows(qtab, labels)
        return step_fn(state, decode_dct(coef, qtab), rows)

    return dct_step


class StepParts:
    """A step in two halves around the exchange: ``local`` (one rank's
    augment, forward and backward, its gradients left in ``.grad``) and
    ``apply`` (norm, clip, skip, SGD, statistics, EMA, head state). The
    train step runs them with the collectives between; the plain version
    (``parallel.reference.replica_loop_step``) runs ``prepare``, the
    forward and ``objective`` for every rank in one process and averages
    by hand."""

    def __init__(self, net: torch.nn.Module, cfg: TrainConfig,
                 state: TrainState, mesh=None, *, input_format: str = "u8",
                 teacher=None):
        if input_format not in ("u8", "dct"):
            raise ValueError(f"unknown input_format {input_format!r}; have "
                             "u8|dct")
        if input_format == "dct" and not cfg.augment:
            raise ValueError(
                "input_format='dct' decodes to uint8 crop_from² frames — "
                "it requires the augment preprocessing chain (cfg.augment)")
        self.teacher, self.alpha = None, 0.0
        if teacher is not None:
            self.alpha = float(cfg.distill_alpha)
            if not 0.0 < self.alpha <= 1.0:
                raise ValueError(f"distill_alpha must be in (0, 1] with a "
                                 f"teacher; got {self.alpha}")
            if self.alpha == 1.0 and (cfg.margin_mode != "fixed"
                                      or cfg.center_weight > 0
                                      or cfg.triplet_weight > 0):
                raise ValueError(
                    "pure distillation (distill_alpha=1) skips the margin "
                    "branch entirely - margin_mode/center_weight/"
                    "triplet_weight would be silently dead; set "
                    "distill_alpha<1 to mix them")
            self.teacher = _frozen(teacher, state.classifier.device)
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.world = mesh.world if mesh is not None else 1
        self.model = mesh.model if mesh is not None else 1
        self.model_index = mesh.model_index if mesh is not None else 0
        self.rows_a_rank = (rank_batch_size(cfg.global_batch, mesh)
                            if mesh is not None else cfg.global_batch)
        if cfg.accum_steps > 1 and self.rows_a_rank % cfg.accum_steps:
            raise ValueError(f"per-device batch {self.rows_a_rank} not "
                             f"divisible by accum_steps {cfg.accum_steps}")
        if cfg.pallas_input and cfg.input_norm != "per_image":
            # the kernel bakes per-image standardization in; fixed norm
            # takes the plain augment chain (the reference's own rule)
            logging.warning("pallas_input: the fused kernel covers per_image "
                            "standardization only; input_norm=%s uses the "
                            "plain augment chain", cfg.input_norm)
        self.budget = None
        if cfg.pfc_sample_rate < 1.0:
            c_local = padded_classes(cfg.num_classes, self.model) // self.model
            # positives come from the global (micro-)batch, so its rows
            # are the budget's floor
            pool = cfg.global_batch // cfg.accum_steps
            self.budget = min(max(math.ceil(cfg.pfc_sample_rate * c_local),
                                  pool), c_local)
        # each auxiliary term's weight in the objective
        self.weights = {"magface_reg": cfg.magface.lambda_g,
                        "center": cfg.center_weight,
                        "triplet": cfg.triplet_weight}
        self.net, self.cfg = net, cfg
        self.sched = make_schedule(cfg)
        self.device = state.classifier.device
        self.bn_keys = {mod: name for name, mod in net.named_modules()
                        if isinstance(mod, BatchNorm)}

    def rows(self, images, labels) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of a global batch, on the device."""
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        n = self.rows_a_rank
        if self.world > 1:
            if images.shape[0] == self.cfg.global_batch:
                images = images[self.rank * n:(self.rank + 1) * n]
                labels = labels[self.rank * n:(self.rank + 1) * n]
            elif images.shape[0] != n:
                raise ValueError(
                    f"a batch of {images.shape[0]} rows is neither the "
                    f"global batch ({self.cfg.global_batch}) nor a rank's "
                    f"rows ({n})")
        return (images.to(self.device),
                labels.to(device=self.device, dtype=torch.long))

    def prepare(self, state: TrainState, images: torch.Tensor,
                rank: int) -> tuple[TrainContext, torch.Tensor]:
        """Rank ``rank``'s train context (its dropout generator; the BN
        statistics its forwards update) and its augmented input."""
        cfg, device = self.cfg, self.device
        # rank 0 draws a one-device run's streams
        parts = (state.rng, state.step) + ((rank,) if rank else ())
        ctx = TrainContext(_generator(device, *parts, _DROPOUT))
        if cfg.augment:
            x = _augment(cfg, images, _generator("cpu", *parts, _AUGMENT),
                         _generator(device, *parts, _ERASE))
        else:
            x = images
        return ctx, x.to(cfg.dtype)

    def pfc_generator(self, state: TrainState,
                      model_index: int) -> torch.Generator:
        """The sampled head's generator of a step, the same on every rank
        of a data column (JAX folds the step, not the device)."""
        return _generator(self.device, state.rng, state.step, _PFC,
                          model_index)

    def objective(self, state: TrainState, emb: torch.Tensor,
                  labels: torch.Tensor, margin_loss: Callable,
                  moments=None, margin_weight: float = 1.0
                  ) -> tuple[torch.Tensor, dict, dict]:
        """A model row's objective from its gathered f32 rows ``emb`` and
        ``labels`` (JAX's ``margin_branch``): MagFace's margins and
        regularizer, or AdaFace's margins from the global batch's norm
        ``moments`` (``adaface_moments``); the center loss against the
        centers and the triplet loss mined within the row; and
        ``margin_loss(extra_m2, extra_m3)``, the margin head's loss (with
        CurricularFace, (loss, t')), weighted ``margin_weight`` (1 -
        distill_alpha with a teacher). Returns (objective, terms: each
        part by name, "margin" first, update: the head state to write
        after the step)."""
        cfg = self.cfg
        terms, update = {}, {}
        extra_m2 = extra_m3 = None
        if cfg.margin_mode == "magface":
            extra_m2, terms["magface_reg"] = magface_margins(emb, cfg.magface)
        elif cfg.margin_mode == "adaface":
            extra_m2, extra_m3, update["adaface"] = adaface_margins(
                adaface_norms(emb), state.head_state["adaface"], cfg.adaface,
                *moments)
        if cfg.center_weight > 0:
            terms["center"] = sharded_center_loss(
                emb, state.head_state["centers"], labels, self.mesh)
            update["centers"] = (emb.detach(), labels)
        if cfg.triplet_weight > 0:
            terms["triplet"] = batch_hard_triplet_loss(emb, labels,
                                                       cfg.triplet_margin)
        margin = margin_loss(extra_m2, extra_m3)
        if cfg.margin_mode == "curricular":
            margin, t_new = margin
            update["curricular"] = {"t": t_new}
        total = margin if margin_weight == 1.0 else margin_weight * margin
        for name, value in terms.items():
            total = total + self.weights[name] * value
        return total, {"margin": margin, **terms}, update

    def loss(self, state: TrainState, x: torch.Tensor, emb: torch.Tensor,
             labels: torch.Tensor) -> tuple[torch.Tensor, dict, dict]:
        """This rank's objective on its (micro-)batch ``x`` and its f32
        embeddings ``emb``: the model row's ``head``, and with a teacher
        the distillation term on the rank's own rows (JAX's local-shard
        mean, which the backbone's sum over the model row turns into the
        row's mean) before it, the head weighted 1 - alpha and skipped
        at alpha 1. Returns ``head``'s (objective, terms, update)."""
        if self.teacher is None:
            return self.head(state, emb, labels)
        with torch.no_grad():
            t_emb = self.teacher(x).to(torch.float32)
        cos = torch.sum(l2_normalize(emb) * l2_normalize(t_emb), dim=-1)
        distill = torch.mean(1.0 - cos)
        total = self.alpha * distill
        terms, update = {}, {}
        if self.alpha < 1.0:
            head, terms, update = self.head(state, emb, labels,
                                            1.0 - self.alpha)
            total = total + head
        return total, {"distill": distill, **terms}, update

    def head(self, state: TrainState, emb: torch.Tensor,
             labels: torch.Tensor, margin_weight: float = 1.0
             ) -> tuple[torch.Tensor, dict, dict]:
        """``objective`` of this rank's model row: ``emb`` (f32) and
        ``labels`` of this rank, gathered over the row, against this
        rank's classifier and center shards (the same on each of the
        row's ranks)."""
        cfg, mesh = self.cfg, self.mesh
        emb = collectives.model_all_gather(emb, mesh)
        labels = collectives.model_all_gather(labels, mesh)
        moments = (adaface_moments(adaface_norms(emb), mesh)
                   if cfg.margin_mode == "adaface" else None)

        def margin_loss(extra_m2, extra_m3):
            if cfg.margin_mode == "curricular":
                return sharded_curricular_loss(
                    emb, state.classifier, labels, cfg.margin,
                    state.head_state["curricular"]["t"], mesh,
                    total_classes=cfg.num_classes,
                    subcenters=cfg.subcenters, data_sync=True)
            if self.budget is None:
                return sharded_margin_softmax_loss(
                    emb, state.classifier, labels, cfg.margin, mesh,
                    total_classes=cfg.num_classes, extra_m2=extra_m2,
                    extra_m3=extra_m3, subcenters=cfg.subcenters)
            return sampled_sharded_margin_softmax_loss(
                emb, state.classifier, labels, cfg.margin,
                self.pfc_generator(state, self.model_index), self.budget,
                mesh, total_classes=cfg.num_classes, extra_m2=extra_m2,
                extra_m3=extra_m3, data_sync=True)

        return self.objective(state, emb, labels, margin_loss, moments,
                              margin_weight)

    def local(self, state: TrainState, images: torch.Tensor,
              labels: torch.Tensor, rank: int
              ) -> tuple[dict, dict, dict]:
        """Rank ``rank``'s forward and backward on its rows: returns its
        model row's terms (``objective``'s, detached; averaged over the
        micro-batches), the BN modules' updated running statistics and
        the head-state update; the gradients (of the objective over the
        model size) are in the parameters' ``.grad``, zeros where the
        objective does not reach a parameter (the classifier under pure
        distillation: optax still decays it and steps its state)."""
        ctx, x = self.prepare(state, images, rank)
        for p in (*state.params.values(), state.classifier):
            p.grad = None
        k = self.cfg.accum_steps
        steps = []
        for xm, lm in zip(x.chunk(k), labels.chunk(k)):
            emb = self.net(xm, train=ctx).to(torch.float32)
            total, terms, update = self.loss(state, xm, emb, lm)
            (total / self.model).backward()
            steps.append(terms)
        for p in (*state.params.values(), state.classifier):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if k > 1:
            torch._foreach_div_(self.grads(state), float(k))
        return mean_terms(steps), ctx.stats, update

    @staticmethod
    def grads(state: TrainState) -> list[torch.Tensor]:
        """The gradients of params, then the classifier's."""
        return [p.grad for p in (*state.params.values(), state.classifier)]

    def apply(self, state: TrainState, terms: dict, stats: dict,
              update: dict | None = None) -> tuple[TrainState, dict]:
        """The update from the gradients in ``.grad``, the objective's
        terms (averaged over every rank), the running statistics and the
        head-state update, as they are after the exchange."""
        cfg = self.cfg
        grads = self.grads(state)
        grad_norm = _grad_norm(grads, self.mesh)
        if cfg.grad_clip_norm > 0:
            scale = torch.clamp_max(
                cfg.grad_clip_norm / torch.clamp_min(grad_norm, 1e-12), 1.0)
            torch._foreach_mul_(grads, scale)

        if self.teacher is None:
            loss = terms["margin"]
        else:
            loss = self.alpha * terms["distill"]
            if self.alpha < 1.0:
                loss = loss + (1.0 - self.alpha) * terms["margin"]
        for name, weight in self.weights.items():
            if name in terms:
                loss = loss + weight * terms[name]
        metrics = {"loss": loss, "learning_rate": self.sched(state.step),
                   "grad_norm": grad_norm}
        ok = True
        if cfg.skip_nonfinite:
            # a host sync: the step applies or holds as a whole
            ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
            metrics["skipped_nonfinite"] = 0.0 if ok else 1.0
        if ok:
            opt = state.opt_state["optimizer"]
            lr = self.sched(state.opt_state["count"])
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            state.opt_state["count"] += 1
            with torch.no_grad():
                for mod, (mean, var) in stats.items():
                    name = self.bn_keys[mod]
                    state.batch_stats[f"{name}.running_mean"].copy_(mean)
                    state.batch_stats[f"{name}.running_var"].copy_(var)
                if state.ema_params is not None:
                    d = cfg.ema_decay
                    ema = list(state.ema_params.values())
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(
                        ema, [p.detach() for p in state.params.values()],
                        alpha=1.0 - d)
            self._write_head(state, update or {})
        if self.teacher is not None:
            metrics["distill_loss"] = terms["distill"]
            if self.alpha < 1.0:
                metrics["margin_loss"] = terms["margin"]
        for name in ("center", "triplet", "magface_reg"):
            if name in terms:
                metrics[f"{name}_loss"] = terms[name]
        head = state.head_state or {}
        if "adaface" in head:
            metrics["adaface_norm_mean"] = head["adaface"]["norm_mean"]
        if "curricular" in head:
            metrics["curricular_t"] = head["curricular"]["t"]
        state.step += 1
        return state, metrics

    def _write_head(self, state: TrainState, update: dict) -> None:
        """The head state after an applied step: AdaFace's statistics and
        t' as the head computed them, the centers by the delta rule over
        the global batch (new tensors: a metric read before keeps its
        value)."""
        head = state.head_state
        for name in ("adaface", "curricular"):
            if name in update:
                head[name] = {k: v.detach() for k, v in update[name].items()}
        if "centers" in update:
            emb, labels = update["centers"]
            head["centers"] = sharded_center_update(
                emb, head["centers"], labels, self.mesh, self.cfg.center_alpha)
