"""Training CLI: margin-softmax training of a backbone, on one GPU or
data-parallel over several (one process a GPU, through torchrun).

Counterpart of ``tf_face_toolbox_tpu/cli/train.py``, with its flag
names and defaults. Every flag of the JAX CLI is accepted; one whose
path is not ported yet raises if set, naming its ROADMAP.md item.
``--train_dir`` checkpoints every ``--save_every`` steps and resumes
from the latest one; SIGTERM flushes a checkpoint at the current step
and exits 0, and the same command continues from it. ``--preset``
takes a named config's values (``configs.py``) as the defaults of the
flags it sets.

Like the JAX CLI, which trains on every device it sees, a run trains on
every GPU it is launched on: under torchrun with ``--multihost``, one
rank a GPU, each reading its own slice of the data (global batch /
ranks rows a step). ``--mesh_model N`` puts the ranks on a (ranks / N,
N) grid whose model axis shards the classifier's classes (the
Partial-FC head; ``--pfc_sample_rate`` < 1 samples each shard's
columns). A plain ``python -m`` with ``--device cuda`` on a host with
several GPUs refuses and prints the torchrun line (``--device cuda:0``
trains on one).

    # BASELINE config 5 on every GPU of a host (global batch 256 a GPU)
    torchrun --standalone --nproc_per_node 8 -m \\
        tf_face_toolbox_tpu_torch.cli.train --preset v5e8_data_parallel \\
        --multihost --pallas_input --train_dir /tmp/dp

    # BASELINE config 7: 93,431 classes over a 2 x 4 grid, sampled PFC
    torchrun --standalone --nproc_per_node 8 -m \\
        tf_face_toolbox_tpu_torch.cli.train --preset large_id_pfc_v5e8 \\
        --mesh_model 4 --multihost --pallas_input --train_dir /tmp/pfc

    # BASELINE preset 8: AdaFace, 3 sub-centers, random erase, cosine LR
    python -m tf_face_toolbox_tpu_torch.cli.train \\
        --preset adaface_noisy_data --pallas_input --train_dir /tmp/ada

    # center loss and batch-hard triplet on P x K batches of a shard
    python -m tf_face_toolbox_tpu_torch.cli.train --data=faces.faceshard \\
        --center_loss=0.003 --triplet_loss=0.1 --balanced_pk=64,4

    # CASIA-WebFace-shaped run (BASELINE config 4), synthetic faces
    python -m tf_face_toolbox_tpu_torch.cli.train --data=synthetic \\
        --network=resnet_v1_50 --stem=face --num_classes=10572 \\
        --global_batch=256 --pallas_input --num_steps=30 --log_every=10 \\
        --train_dir=/tmp/run --save_every=10

    # distil a student from a trained run (AdamW, half margin loss)
    python -m tf_face_toolbox_tpu_torch.cli.train --data=faces.faceshard \\
        --train_dir=/tmp/student --optimizer=adamw --base_lr=1e-3 \\
        --distill_from=/tmp/run --distill_network=resnet_v1_50 \\
        --distill_alpha=0.5

    # fine-tune from a train dir (or a JAX .npz), with the LFW hook
    python -m tf_face_toolbox_tpu_torch.cli.train --data=faces.faceshard \\
        --train_dir=/tmp/ft --finetune_from=/tmp/run \\
        --eval_data=lfw.faceshard --eval_pairs=pairs.txt --eval_every=1000 \\
        --keep_best=lfw_accuracy

    # on the host, a tiny net
    python -m tf_face_toolbox_tpu_torch.cli.train --device=cpu \\
        --network=resnet_tiny --image_size=16 --crop_from=20 \\
        --global_batch=8 --num_classes=10 --num_steps=4 --nobf16
"""

from __future__ import annotations

import argparse
import logging

_MARGINS = {  # (m1, m2, m3) defaults per variant
    "softmax": (1.0, 0.0, 0.0),
    "arcface": (1.0, 0.5, 0.0),
    "cosface": (1.0, 0.0, 0.35),
    "sphereface": (1.35, 0.0, 0.0),
}

def _bool_flag(p, name: str, default: bool, help: str) -> None:
    p.add_argument(f"--{name}", dest=name, action="store_true",
                   default=default, help=help)
    p.add_argument(f"--no{name}", dest=name, action="store_false")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", default="synthetic",
                   help="FaceShard path, several as a,b (a weighted "
                        "mixture; labels offset per source), or "
                        "'synthetic' for random faces")
    p.add_argument("--data_weights", default="",
                   help="comma floats, one per --data shard: relative "
                        "per-step sampling weights of the mixture "
                        "(default equal)")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"])
    p.add_argument("--head", default="gap", choices=["gap", "flatten"])
    p.add_argument("--dropout", type=float, default=0.0,
                   help="flatten-head dropout rate (train mode only)")
    p.add_argument("--drop_path", type=float, default=0.0,
                   help="stochastic depth for the ViT family: per-block "
                        "branch-drop rate ramping to this value at the "
                        "last block (train mode only)")
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--num_classes", type=int, default=0,
                   help="identity count (0 = from the data; synthetic 100)")
    p.add_argument("--image_size", type=int, default=112,
                   help="train crop size")
    p.add_argument("--crop_from", type=int, default=0,
                   help="source image size (0 = image_size + 8)")
    p.add_argument("--global_batch", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=200_000)
    p.add_argument("--lr_schedule", default="staircase",
                   choices=["staircase", "cosine"],
                   help="cosine: half-cosine to 0 over --num_steps")
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adamw", "lars"],
                   help="sgd = momentum SGD; adam (L2 on the kernels), "
                        "adamw (decoupled decay), lars (layerwise trust "
                        "ratios, for large global batches)")
    p.add_argument("--base_lr", type=float, default=0.1)
    p.add_argument("--lr_boundaries", default="100000,160000,220000",
                   help="comma-separated staircase decay steps")
    p.add_argument("--lr_decay", type=float, default=0.1)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4,
                   help="L2 on conv/Dense kernels and the classifier")
    p.add_argument("--grad_clip_norm", type=float, default=0.0,
                   help="clip gradients to this global L2 norm (0 = off)")
    _bool_flag(p, "skip_nonfinite", False,
               "skip (hold all state) any step whose loss or gradient "
               "norm is non-finite; the step counter advances")
    p.add_argument("--max_consecutive_skips", type=int, default=100,
                   help="with --skip_nonfinite: raise after this many "
                        "skips in a row (0 = never)")
    p.add_argument("--margin", default="cosface",
                   choices=["softmax", "arcface", "cosface", "sphereface",
                            "magface", "adaface", "curricular"],
                   help="margin-softmax variant; magface and adaface are "
                        "per-sample margins on zero base margins, "
                        "curricular modulates hard negatives over an "
                        "ArcFace margin")
    p.add_argument("--margin_scale", type=float, default=64.0)
    p.add_argument("--margin_value", type=float, default=-1.0,
                   help="margin (-1 = the variant's default; curricular: "
                        "its ArcFace margin, 0.5)")
    p.add_argument("--magface_la", type=float, default=10.0,
                   help="MagFace magnitude lower bound")
    p.add_argument("--magface_ua", type=float, default=110.0,
                   help="MagFace magnitude upper bound")
    p.add_argument("--magface_lm", type=float, default=0.45,
                   help="MagFace margin at l_a")
    p.add_argument("--magface_um", type=float, default=0.8,
                   help="MagFace margin at u_a")
    p.add_argument("--magface_lambda_g", type=float, default=35.0,
                   help="MagFace magnitude-regularizer weight")
    p.add_argument("--subcenters", type=int, default=1,
                   help="sub-center ArcFace K")
    p.add_argument("--adaface_m", type=float, default=0.4,
                   help="AdaFace margin magnitude")
    p.add_argument("--adaface_h", type=float, default=0.333,
                   help="AdaFace norm concentration")
    p.add_argument("--center_loss", type=float, default=0.0,
                   help="center-loss weight (Wen et al. 2016; 0 = off)")
    p.add_argument("--center_alpha", type=float, default=0.5,
                   help="the centers' delta-rule step")
    p.add_argument("--triplet_loss", type=float, default=0.0,
                   help="batch-hard triplet weight (Hermans et al. 2017; "
                        "0 = off), mined within a data row's batch")
    p.add_argument("--triplet_margin", type=float, default=0.3)
    p.add_argument("--balanced_pk", default="",
                   help="'P,K': batches of P identities x K images of a "
                        "FaceShard --data (P * K = the batch a rank; the "
                        "python loader), so the triplet and center losses "
                        "always see positives")
    _bool_flag(p, "bf16", True, "bfloat16 compute (--nobf16: float32)")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0, help="init/data seed")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python", "native_dct"],
                   help="host decode: native C++ pool or Python threads; "
                        "native_dct = entropy decode only, the train step "
                        "finishes the JPEG on the device (needs a cli.pack "
                        "--recode_size=<crop_from> shard)")
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--distill_from", default="",
                   help="embedding distillation teacher: a port train dir "
                        "or a JAX-key .npz; the student minimizes 1 - cos "
                        "against the frozen teacher's embeddings, mixed "
                        "with the margin loss by --distill_alpha")
    p.add_argument("--distill_network", default="resnet_v1_50",
                   help="teacher backbone name")
    p.add_argument("--distill_stem", default="face",
                   choices=["face", "imagenet", "space2depth"],
                   help="teacher stem")
    p.add_argument("--distill_head", default="gap", choices=["gap", "flatten"],
                   help="teacher embedding head")
    p.add_argument("--distill_alpha", type=float, default=1.0,
                   help="distillation weight: 1.0 = pure distillation "
                        "(labels unused), < 1 mixes in (1 - alpha) x the "
                        "margin loss")
    _bool_flag(p, "distill_use_ema", False,
               "distill from the teacher checkpoint's EMA weights")
    _bool_flag(p, "pallas_input", False,
               "augment through the fused input kernel (the name of the "
               "JAX flag; here the CUDA kernel of ops/fused_preprocess)")
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--random_erase", type=float, default=0.0)
    p.add_argument("--input_norm", default="per_image",
                   choices=["per_image", "fixed"])
    p.add_argument("--train_dir", default="",
                   help="checkpoint directory; resumes from its latest step")
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--finetune_from", default="",
                   help="warm-start the backbone from a train dir or a "
                        "JAX-key .npz (classifier, optimizer, step fresh); "
                        "a checkpoint in --train_dir wins")
    _bool_flag(p, "finetune_use_ema", False,
               "warm-start from the source's EMA weights")
    p.add_argument("--eval_data", default="",
                   help="FaceShard for in-training LFW-style eval")
    p.add_argument("--eval_pairs", default="",
                   help="index-format pairs file over --eval_data")
    p.add_argument("--eval_every", type=int, default=0,
                   help="eval every N steps (0 = off)")
    p.add_argument("--eval_batch", type=int, default=256)
    p.add_argument("--keep_best", default="",
                   help="eval metric (e.g. lfw_accuracy) whose best value's "
                        "state is kept in <train_dir>/best")
    p.add_argument("--device", default="cuda",
                   help="torch device; with --multihost, cuda is "
                        "cuda:<LOCAL_RANK>")
    _bool_flag(p, "multihost", False,
               "join torchrun's process group (NCCL on the card, gloo on "
               "the CPU) and train on every rank")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-axis size: the ranks of a data row share "
                        "their rows and split the classifier's classes "
                        "(the Partial-FC head)")
    p.add_argument("--pfc_sample_rate", type=float, default=1.0,
                   help="sampled Partial-FC: the share of each classifier "
                        "shard scored a step (1.0 = exact; 0.1 = An et al. "
                        "2021's setting for 10^5..10^7 identities)")
    p.add_argument("--mesh_slices", type=int, default=0,
                   help="nodes the ranks span (0 = from torchrun's "
                        "LOCAL_WORLD_SIZE): checked to split the ranks "
                        "into equal nodes, node-major")
    p.add_argument("--preset", default="",
                   help="a named train config (configs.py); its values "
                        "are the defaults of the flags it sets, its "
                        "per-GPU batch times the ranks the global batch")
    _bool_flag(p, "qat", False,
               "quantization-aware training: fake-quantize the convs and "
               "the inter-block stream onto the int8 grid (straight-through "
               "backward), so the checkpoint serves via --quant_mode=static "
               "with little drift (ResNet family)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _given(argv) -> set[str]:
    """The flags ``argv`` sets explicitly."""
    p = _parser()
    for action in p._actions:
        action.default = argparse.SUPPRESS
    return set(vars(p.parse_args(argv)))


def preset_flags(cfg) -> dict:
    """A preset's ``TrainConfig`` as the values of the flags that set it."""
    import torch

    m1, m2, m3 = cfg.margin_m1, cfg.margin_m2, cfg.margin_m3
    margin, value = (("arcface", m2) if m2 else ("cosface", m3) if m3 else
                     ("sphereface", m1) if m1 != 1.0 else ("softmax", -1.0))
    if cfg.margin_mode == "curricular":
        margin, value = "curricular", m2
    elif cfg.margin_mode != "fixed":
        # the base margins travel apart: --margin_value does not apply
        margin, value = cfg.margin_mode, -1.0
    flags = dict(
        network=cfg.network, stem=cfg.stem, head=cfg.head_variant,
        dropout=cfg.dropout_rate, embedding_dim=cfg.embedding_dim,
        num_classes=cfg.num_classes, image_size=cfg.image_size,
        crop_from=cfg.crop_from, global_batch=cfg.global_batch,
        optimizer=cfg.optimizer, base_lr=cfg.base_lr,
        lr_schedule=cfg.lr_schedule,
        lr_boundaries=",".join(str(b) for b in cfg.lr_boundaries),
        lr_decay=cfg.lr_decay, warmup_steps=cfg.warmup_steps,
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        grad_clip_norm=cfg.grad_clip_norm,
        skip_nonfinite=cfg.skip_nonfinite, margin=margin,
        margin_scale=cfg.margin_scale, margin_value=value,
        subcenters=cfg.subcenters, pfc_sample_rate=cfg.pfc_sample_rate,
        bf16=cfg.dtype == torch.bfloat16,
        ema_decay=cfg.ema_decay, pallas_input=cfg.pallas_input,
        accum_steps=cfg.accum_steps, random_erase=cfg.random_erase,
        input_norm=cfg.input_norm, magface_la=cfg.magface.l_a,
        magface_ua=cfg.magface.u_a, magface_lm=cfg.magface.l_m,
        magface_um=cfg.magface.u_m, magface_lambda_g=cfg.magface.lambda_g,
        adaface_m=cfg.adaface.m, adaface_h=cfg.adaface.h,
        center_loss=cfg.center_weight, center_alpha=cfg.center_alpha,
        triplet_loss=cfg.triplet_weight, triplet_margin=cfg.triplet_margin)
    if cfg.lr_schedule == "cosine":
        flags["num_steps"] = cfg.lr_total_steps
    return flags


def apply_preset(args, argv, world: int) -> None:
    """Fill the flags ``argv`` leaves unset from ``args.preset`` (its batch
    a GPU times ``world``); a preset whose path is not ported raises
    naming its item. A preset's MagFace or AdaFace mode keeps its base
    margins (preset 8: CosFace's 0.35 under AdaFace's terms) unless
    ``--margin`` is given."""
    from tf_face_toolbox_tpu_torch import configs

    try:
        cfg = configs.get_config(args.preset, world=world)
    except NotImplementedError as e:
        raise SystemExit(str(e))
    given = _given(argv)
    for name, value in preset_flags(cfg).items():
        if name not in given:
            setattr(args, name, value)
    if cfg.margin_mode in ("magface", "adaface") and "margin" not in given:
        args.base_margins = (cfg.margin_m1, cfg.margin_m2, cfg.margin_m3)


def check_launch(args, gpus: int, env=None) -> None:
    """Without --multihost a run is one process: refuse one rank of a
    torchrun launch, and a bare ``--device cuda`` on a host with several
    GPUs, naming the torchrun line."""
    import os

    env = os.environ if env is None else env
    if args.multihost:
        return
    ranks = int(env.get("WORLD_SIZE", "1"))
    if ranks > 1:
        raise SystemExit(f"WORLD_SIZE={ranks}: this process is one of "
                         f"{ranks} torchrun ranks; pass --multihost")
    if args.device == "cuda" and gpus > 1:
        raise SystemExit(
            f"this host has {gpus} GPUs: train on every one with `torchrun "
            f"--standalone --nproc_per_node {gpus} -m "
            "tf_face_toolbox_tpu_torch.cli.train --multihost ...`, or on "
            "one with --device cuda:0")


def build_config(args, num_classes: int):
    import torch

    from tf_face_toolbox_tpu_torch.ops.losses import (
        AdaFaceConfig, MagFaceConfig)
    from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig

    margin_mode = "fixed"
    if args.margin in ("magface", "adaface"):
        if args.margin_value >= 0:
            raise SystemExit(
                f"--margin_value does not apply to --margin={args.margin} "
                "(its margins are per-sample adaptive); tune --magface_lm/"
                "--magface_um or --adaface_m instead")
        # the papers' losses: zero base margins, per-sample terms
        margin_mode = args.margin
        m1, m2, m3 = getattr(args, "base_margins", (1.0, 0.0, 0.0))
    elif args.margin == "curricular":
        # the paper's ArcFace margin 0.5 on the target column
        margin_mode, m1, m3 = "curricular", 1.0, 0.0
        m2 = args.margin_value if args.margin_value >= 0 else 0.5
    else:
        m1, m2, m3 = _MARGINS[args.margin]
        if args.margin_value >= 0:
            if args.margin == "arcface":
                m2 = args.margin_value
            elif args.margin == "cosface":
                m3 = args.margin_value
            elif args.margin == "sphereface":
                m1 = args.margin_value
    try:
        return TrainConfig(
            network=args.network, stem=args.stem, head_variant=args.head,
            dropout_rate=args.dropout, drop_path_rate=args.drop_path,
            embedding_dim=args.embedding_dim,
            num_classes=num_classes, image_size=args.image_size,
            global_batch=args.global_batch, optimizer=args.optimizer,
            base_lr=args.base_lr, lr_schedule=args.lr_schedule,
            lr_boundaries=tuple(int(b) for b in args.lr_boundaries.split(",")
                                if b),
            lr_decay=args.lr_decay, lr_total_steps=args.num_steps,
            warmup_steps=args.warmup_steps, momentum=args.momentum,
            weight_decay=args.weight_decay,
            grad_clip_norm=args.grad_clip_norm,
            skip_nonfinite=args.skip_nonfinite,
            margin_scale=args.margin_scale, margin_m1=m1, margin_m2=m2,
            margin_m3=m3, margin_mode=margin_mode,
            magface=MagFaceConfig(
                l_a=args.magface_la, u_a=args.magface_ua,
                l_m=args.magface_lm, u_m=args.magface_um,
                lambda_g=args.magface_lambda_g),
            adaface=AdaFaceConfig(m=args.adaface_m, h=args.adaface_h),
            center_weight=args.center_loss, center_alpha=args.center_alpha,
            triplet_weight=args.triplet_loss,
            triplet_margin=args.triplet_margin, subcenters=args.subcenters,
            pfc_sample_rate=args.pfc_sample_rate,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            augment=True, crop_from=args.crop_from or args.image_size + 8,
            random_erase=args.random_erase, accum_steps=args.accum_steps,
            ema_decay=args.ema_decay, pallas_input=args.pallas_input,
            input_norm=args.input_norm, distill_alpha=args.distill_alpha,
            quantized="qat" if args.qat else False)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))


def build_teacher(cfg, source: str, network: str = "resnet_v1_50",
                  stem: str = "face", head: str = "gap",
                  use_ema: bool = False):
    """The frozen distillation teacher ``(net, flat variables)`` from
    ``source`` (``--distill_from``: a port train dir, through
    ``pretrained.load_variables``, or a JAX-key ``.npz``) at ``cfg``'s
    embedding size, input size and dtype. A source lacking the params or
    the BN statistics exits, as the JAX CLI's does."""
    if not source.endswith(".npz"):
        from tf_face_toolbox_tpu_torch.pretrained import load_variables

        try:
            net, flat = load_variables(
                source, network, cfg.embedding_dim, cfg.image_size,
                cfg.dtype, use_ema=use_ema, stem=stem, head=head)
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"--distill_from {source}: {e}")
    else:
        from tf_face_toolbox_tpu_torch.interop.port import (
            flatten_variables, load_variables_npz)
        from tf_face_toolbox_tpu_torch.models import create_network

        if use_ema:
            raise SystemExit(".npz sources hold one weight set; "
                             "--distill_use_ema only applies to train-dir "
                             "sources")
        net = create_network(network, embedding_dim=cfg.embedding_dim,
                             dtype=cfg.dtype, stem=stem, head_variant=head,
                             input_size=cfg.image_size)
        tree = load_variables_npz(source)
        missing = [k for k in ("params", "batch_stats") if k not in tree]
        if missing:
            raise SystemExit(f"--distill_from source lacks {missing}")
        flat = flatten_variables({k: tree[k]
                                  for k in ("params", "batch_stats")})
    logging.info("distillation teacher: %s from %s (alpha=%.2f)", network,
                 source, cfg.distill_alpha)
    return net, flat


def build_eval_fn(cfg, args, device):
    """In-training LFW-style verification, or None without the eval
    flags: ``eval_fn(state) -> {"lfw_accuracy", "lfw_std",
    "tar_at_far_1e2"}``.

    The state's EMA params when EMA is on (else its params), with the
    running BN statistics, go into a separate eval-mode module; the
    training module is not touched. Extraction is the offline extract
    CLI's (``extract.extract_shard``, the module path in ``cfg.dtype``).
    """
    if not (args.eval_data and args.eval_pairs and args.eval_every):
        return None
    import torch

    from tf_face_toolbox_tpu_torch.cli.eval_lfw import load_pairs
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard, make_extract_fn
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.ops.verification import verify_pairs

    net = create_network(cfg.network, embedding_dim=cfg.embedding_dim,
                         dtype=cfg.dtype, stem=cfg.stem,
                         head_variant=cfg.head_variant,
                         input_size=cfg.image_size).to(device).eval()
    net.requires_grad_(False)
    source = FaceShardSource(args.eval_data)
    i1, i2, labels = load_pairs(args.eval_pairs)
    extract_fn = make_extract_fn(net)

    def eval_fn(state):
        params = (state.ema_params if state.ema_params is not None
                  else state.params)
        with torch.no_grad():
            net.load_state_dict({**params, **state.batch_stats})
        emb = extract_shard(net, None, source, image_size=cfg.image_size,
                            crop_from=cfg.crop_from, batch=args.eval_batch,
                            norm=cfg.input_norm, extract_fn=extract_fn,
                            device=device)
        report = verify_pairs(emb[i1], emb[i2], labels)
        return {"lfw_accuracy": report["accuracy_mean"],
                "lfw_std": report["accuracy_std"],
                # NaN when the pair set is too small to resolve FAR=1e-2
                "tar_at_far_1e2": report.get("tar@far=0.01", float("nan"))}

    return eval_fn


def synthetic_batches(cfg, seed: int, rank: int = 0, world: int = 1):
    """Random faces and identities at the loader's geometry (uint8
    crop_from x crop_from): rank ``rank``'s block of the global batch
    (global batch / ``world`` rows, ``world`` = data * model ranks) a
    step, from a numpy generator seeded (seed, rank)."""
    import numpy as np

    rows = cfg.global_batch // world
    rng = np.random.default_rng((seed, rank))
    while True:
        images = rng.integers(0, 256, (rows, cfg.crop_from, cfg.crop_from,
                                       3), dtype=np.uint8)
        labels = rng.integers(0, cfg.num_classes, rows).astype(np.int32)
        yield {"image": images, "label": labels}


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.network.startswith("densenet") and args.stem == "space2depth":
        raise SystemExit("--stem=space2depth is a resnet-family option; "
                         "densenet supports stem=face|imagenet")
    if args.network.startswith("densenet") and args.qat:
        raise SystemExit("--qat is a resnet-family option; densenet "
                         "supports fp training")
    if args.keep_best and not (args.eval_data and args.eval_pairs
                               and args.eval_every):
        raise SystemExit(
            "--keep_best tracks the in-training eval hook; it needs "
            "--eval_data/--eval_pairs/--eval_every")
    if args.keep_best and not args.train_dir:
        raise SystemExit("--keep_best saves to <train_dir>/best; "
                         "pass --train_dir")
    if args.data_weights and "," not in args.data:
        # a --data that lost its comma would silently train on one source
        raise SystemExit("--data_weights needs a multi-shard --data "
                         f"(got --data={args.data!r})")

    import torch
    import torch.distributed as dist

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the host")
    check_launch(args, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0)
    from tf_face_toolbox_tpu_torch.parallel.mesh import (
        create_topology, init_distributed)

    try:
        if args.multihost:
            topo = init_distributed(args.device, model=args.mesh_model,
                                    nodes=args.mesh_slices)
        else:
            topo = create_topology(1, model=args.mesh_model,
                                   nodes=args.mesh_slices, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh_model={args.mesh_model} --mesh_slices="
                         f"{args.mesh_slices}: {e}")
    try:
        _train(args, argv, topo)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _balanced_pk(args, host_batch: int) -> tuple[int, int] | None:
    """``--balanced_pk``'s (P, K), checked against the data, the loader
    and the batch a rank; None when it is not set."""
    if not args.balanced_pk:
        return None
    try:
        p, k = (int(v) for v in args.balanced_pk.split(","))
    except ValueError:
        raise SystemExit("--balanced_pk must be 'P,K' "
                         f"(got {args.balanced_pk!r})")
    if args.data == "synthetic" or "," in args.data:
        raise SystemExit("--balanced_pk samples the identities of ONE "
                         "FaceShard --data; it does not compose with "
                         f"--data={args.data}")
    if args.loader not in ("auto", "python"):
        raise SystemExit("--balanced_pk is a python-loader sampler "
                         f"(got --loader={args.loader})")
    if p * k != host_batch:
        raise SystemExit(f"--balanced_pk={p},{k}: P*K={p * k} must equal "
                         f"the batch a rank {host_batch}")
    return p, k


def _train(args, argv, topo) -> None:
    import signal
    import threading

    from tf_face_toolbox_tpu_torch.data.pipeline import (
        FaceShardSource, balanced_batch_iterator, batch_iterator,
        device_prefetch, host_prefetch, mixed_batch_iterator,
        mixture_sources, native_batch_iterator, native_dct_batch_iterator)
    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.loop import train_loop

    device, rank, world = topo.device, topo.rank, topo.world
    if not topo.is_main:
        logging.getLogger().setLevel(logging.WARNING)
    if args.preset:
        apply_preset(args, argv, world)
    if args.global_batch % world:
        raise SystemExit(f"--global_batch={args.global_batch} is not "
                         f"divisible by the {world} ranks ({topo.data} x "
                         f"{topo.model})")
    host_batch = args.global_batch // world
    latest = (CheckpointManager(args.train_dir).latest_step()
              if args.train_dir else None) or 0
    pk = _balanced_pk(args, host_batch)
    if args.loader == "native_dct" and (args.data == "synthetic"
                                        or "," in args.data):
        raise SystemExit("--loader=native_dct entropy-decodes ONE FaceShard "
                         "--data packed with --recode_size=<crop_from>; got "
                         f"--data={args.data}")
    if args.data == "synthetic":
        # restarts from its seed on resume, as the JAX CLI's does
        cfg = build_config(args, args.num_classes or 100)
        batches = synthetic_batches(cfg, args.seed, rank, world)
    elif "," in args.data:
        # one source a step, picked by one choice stream shared by the
        # ranks; the python loader (a source switch a step defeats the
        # native loader's readahead)
        if args.loader not in ("auto", "python"):
            raise SystemExit("--data with several shards uses the python "
                             f"loader (got --loader={args.loader})")
        paths = [p for p in args.data.split(",") if p]
        sources = mixture_sources(paths, seed=args.seed, host_index=rank,
                                  host_count=world)
        weights = None
        if args.data_weights:
            try:
                weights = [float(v) for v in args.data_weights.split(",")]
            except ValueError:
                raise SystemExit("--data_weights must be comma floats "
                                 f"(got {args.data_weights!r})")
            if len(weights) != len(paths):
                raise SystemExit(f"--data_weights has {len(weights)} "
                                 f"entries for {len(paths)} shards")
        total = sum(s.num_classes for s in sources)
        if args.num_classes and args.num_classes < total:
            # offset labels past the classifier's rows would index out of
            # it on the device
            raise SystemExit(
                f"--num_classes={args.num_classes} is smaller than the "
                f"mixture's combined identity count {total} (labels are "
                f"offset per source); omit --num_classes or set it >= "
                f"{total}")
        cfg = build_config(args, args.num_classes or total)
        batches = mixed_batch_iterator(
            paths, host_batch, weights=weights, seed=args.seed,
            start_step=latest, resize_to=(cfg.crop_from, cfg.crop_from),
            sources=sources)
    else:
        source = FaceShardSource(args.data, seed=args.seed, host_index=rank,
                                 host_count=world)
        cfg = build_config(args, args.num_classes or source.num_classes)
        # resume: continue through the same shuffled sequence from the
        # checkpointed step instead of replaying epoch 0
        spe = source.num_records // host_batch
        if spe == 0:
            raise ValueError(
                f"dataset ({source.num_records} records a rank) is smaller "
                f"than the batch a rank ({host_batch})")
        start_epoch, start_step = divmod(latest, spe)
        use_native = args.loader == "native"
        if args.loader == "auto":
            from tf_face_toolbox_tpu_torch.data.native import native_available
            use_native = native_available()
        if pk is not None:
            # step-indexed (no epochs): resumed by the global step alone
            batches = balanced_batch_iterator(
                source, ids_per_batch=pk[0], images_per_id=pk[1],
                start_step=latest, resize_to=(cfg.crop_from, cfg.crop_from))
        elif args.loader == "native_dct":
            batches = native_dct_batch_iterator(
                source, host_batch, size=cfg.crop_from,
                start_epoch=start_epoch, start_step=start_step)
        elif use_native:
            batches = native_batch_iterator(
                source, host_batch, out_h=cfg.crop_from,
                out_w=cfg.crop_from, start_epoch=start_epoch,
                start_step=start_step)
        else:
            batches = batch_iterator(
                source, host_batch,
                resize_to=(cfg.crop_from, cfg.crop_from),
                start_epoch=start_epoch, start_step=start_step)
    batches = device_prefetch(host_prefetch(batches), device=device)

    # preemption safety: SIGTERM flags the loop to flush a checkpoint at
    # the current step and exit 0; a resume continues where it landed
    # (with several ranks, all stop at the step where they agree)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    warm_start = None
    if args.finetune_from:
        from tf_face_toolbox_tpu_torch.train.finetune import (
            load_pretrained_variables,
            warm_start_state,
        )

        def warm_start(state):
            # loaded here: the loop calls this only on a fresh start, so
            # a resumed fine-tune never re-reads the source
            pretrained = load_pretrained_variables(
                args.finetune_from, use_ema=args.finetune_use_ema)
            return warm_start_state(state, pretrained, log=logging.info)

    teacher = None
    if args.distill_from:
        teacher = build_teacher(cfg, args.distill_from, args.distill_network,
                                args.distill_stem, args.distill_head,
                                args.distill_use_ema)
    before = fused_preprocess.launches
    result = train_loop(cfg, batches, num_steps=args.num_steps,
                        train_dir=args.train_dir or None,
                        save_every=args.save_every,
                        log_every=args.log_every, rng_seed=args.seed,
                        eval_fn=build_eval_fn(cfg, args, device),
                        eval_every=args.eval_every,
                        keep_best=args.keep_best,
                        should_stop=stop.is_set, warm_start=warm_start,
                        teacher=teacher,
                        max_consecutive_skips=args.max_consecutive_skips,
                        mesh=topo, device=device,
                        input_format=("dct" if args.loader == "native_dct"
                                      else "u8"))
    step = result.state.step
    print(f"kernel launches: preprocess={fused_preprocess.launches - before}",
          flush=True)
    if result.last_metrics.get("preempted"):
        if args.train_dir:
            print(f"preempted: checkpoint flushed at step={step}; resume "
                  "with the same command", flush=True)
        else:
            print(f"preempted at step={step}: NO checkpoint (--train_dir "
                  "not set); progress is lost", flush=True)
        return
    loss = result.last_metrics.get("loss")
    print(f"done: step={step} loss={loss:.4f}" if loss is not None else
          f"done: step={step} (no steps run)", flush=True)


if __name__ == "__main__":
    main()
