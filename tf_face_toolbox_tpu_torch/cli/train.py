"""Training CLI: margin-softmax training of a backbone on one device.

Counterpart of ``tf_face_toolbox_tpu/cli/train.py``, with its flag
names and defaults. Every flag of the JAX CLI is accepted; one whose
path is not ported yet raises if set, naming its ROADMAP.md item.
``--train_dir`` checkpoints every ``--save_every`` steps and resumes
from the latest one; SIGTERM flushes a checkpoint at the current step
and exits 0, and the same command continues from it.

    # CASIA-WebFace-shaped run (BASELINE config 4), synthetic faces
    python -m tf_face_toolbox_tpu_torch.cli.train --data=synthetic \\
        --network=resnet_v1_50 --stem=face --num_classes=10572 \\
        --global_batch=256 --pallas_input --num_steps=30 --log_every=10 \\
        --train_dir=/tmp/run --save_every=10

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

# flags of paths not ported yet: name -> (JAX default, ROADMAP.md item)
_NOT_PORTED = {
    "data_weights": ("", "10b/11"),
    "drop_path": (0.0, "17"),
    "magface_la": (10.0, "9"), "magface_ua": (110.0, "9"),
    "magface_lm": (0.45, "9"), "magface_um": (0.8, "9"),
    "magface_lambda_g": (35.0, "9"),
    "adaface_m": (0.4, "9"), "adaface_h": (0.333, "9"),
    "center_loss": (0.0, "9"), "center_alpha": (0.5, "9"),
    "triplet_loss": (0.0, "9"), "triplet_margin": (0.3, "9"),
    "balanced_pk": ("", "9"),
    "pfc_sample_rate": (1.0, "11"),
    "mesh_model": (1, "10b/11"), "mesh_slices": (0, "10b/11"),
    "multihost": (False, "10b/11"),
    "distill_from": ("", "10c"), "distill_network": ("resnet_v1_50", "10c"),
    "distill_stem": ("face", "10c"), "distill_head": ("gap", "10c"),
    "distill_alpha": (1.0, "10c"), "distill_use_ema": (False, "10c"),
    "qat": (False, "18"),
}


def _bool_flag(p, name: str, default: bool, help: str) -> None:
    p.add_argument(f"--{name}", dest=name, action="store_true",
                   default=default, help=help)
    p.add_argument(f"--no{name}", dest=name, action="store_false")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", default="synthetic",
                   help="FaceShard path, or 'synthetic' for random faces")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"])
    p.add_argument("--head", default="gap", choices=["gap", "flatten"])
    p.add_argument("--dropout", type=float, default=0.0,
                   help="flatten-head dropout rate (train mode only)")
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
                   help="sgd = momentum SGD (the others: item 10c)")
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
                   help="margin-softmax variant (magface, adaface, "
                        "curricular: item 9)")
    p.add_argument("--margin_scale", type=float, default=64.0)
    p.add_argument("--margin_value", type=float, default=-1.0,
                   help="margin (-1 = the variant's default)")
    p.add_argument("--subcenters", type=int, default=1,
                   help="sub-center ArcFace K")
    _bool_flag(p, "bf16", True, "bfloat16 compute (--nobf16: float32)")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0, help="init/data seed")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python", "native_dct"],
                   help="host decode: native C++ pool or Python threads "
                        "(native_dct: item 17)")
    p.add_argument("--ema_decay", type=float, default=0.0)
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
    p.add_argument("--device", default="cuda", help="torch device")
    for name, (default, item) in _NOT_PORTED.items():
        if isinstance(default, bool):
            _bool_flag(p, name, default, f"not ported yet (item {item})")
        else:
            p.add_argument(f"--{name}", type=type(default), default=default,
                           help=f"not ported yet (item {item})")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise SystemExit(f"--{name} is not ported yet (ROADMAP.md §1 "
                             f"item {item})")
    if "," in args.data:
        raise SystemExit("--data with several shards (a weighted mixture) "
                         "is not ported yet (ROADMAP.md §1 item 10b/11)")
    if args.margin in ("magface", "adaface", "curricular"):
        raise SystemExit(f"--margin={args.margin} is not ported yet "
                         "(ROADMAP.md §1 item 9)")
    if args.loader == "native_dct":
        raise SystemExit("--loader=native_dct is not ported yet "
                         "(ROADMAP.md §1 item 17)")


def build_config(args, num_classes: int):
    import torch

    from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig

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
            dropout_rate=args.dropout, embedding_dim=args.embedding_dim,
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
            margin_m3=m3, subcenters=args.subcenters,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            augment=True, crop_from=args.crop_from or args.image_size + 8,
            random_erase=args.random_erase, accum_steps=args.accum_steps,
            ema_decay=args.ema_decay, pallas_input=args.pallas_input,
            input_norm=args.input_norm)
    except NotImplementedError as e:
        raise SystemExit(str(e))


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


def synthetic_batches(cfg, seed: int):
    """Random faces and identities at the loader's geometry (uint8
    crop_from x crop_from) from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng((seed, 0))
    while True:
        images = rng.integers(0, 256, (cfg.global_batch, cfg.crop_from,
                                       cfg.crop_from, 3), dtype=np.uint8)
        labels = rng.integers(0, cfg.num_classes,
                              cfg.global_batch).astype(np.int32)
        yield {"image": images, "label": labels}


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    _refuse_unported(args)
    if args.keep_best and not (args.eval_data and args.eval_pairs
                               and args.eval_every):
        raise SystemExit(
            "--keep_best tracks the in-training eval hook; it needs "
            "--eval_data/--eval_pairs/--eval_every")
    if args.keep_best and not args.train_dir:
        raise SystemExit("--keep_best saves to <train_dir>/best; "
                         "pass --train_dir")

    import signal
    import threading

    import torch

    from tf_face_toolbox_tpu_torch.data.pipeline import (
        FaceShardSource, batch_iterator, device_prefetch, host_prefetch,
        native_batch_iterator)
    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.loop import train_loop

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the host")
    if args.data == "synthetic":
        # restarts from its seed on resume, as the JAX CLI's does
        cfg = build_config(args, args.num_classes or 100)
        batches = synthetic_batches(cfg, args.seed)
    else:
        source = FaceShardSource(args.data, seed=args.seed)
        cfg = build_config(args, args.num_classes or source.num_classes)
        # resume: continue through the same shuffled sequence from the
        # checkpointed step instead of replaying epoch 0
        start_epoch = start_step = 0
        if args.train_dir:
            latest = CheckpointManager(args.train_dir).latest_step()
            spe = source.num_records // cfg.global_batch
            if spe == 0:
                raise ValueError(
                    f"dataset ({source.num_records} records) is smaller "
                    f"than the batch ({cfg.global_batch})")
            if latest:
                start_epoch, start_step = latest // spe, latest % spe
        use_native = args.loader == "native"
        if args.loader == "auto":
            from tf_face_toolbox_tpu_torch.data.native import native_available
            use_native = native_available()
        if use_native:
            batches = native_batch_iterator(
                source, cfg.global_batch, out_h=cfg.crop_from,
                out_w=cfg.crop_from, start_epoch=start_epoch,
                start_step=start_step)
        else:
            batches = batch_iterator(
                source, cfg.global_batch,
                resize_to=(cfg.crop_from, cfg.crop_from),
                start_epoch=start_epoch, start_step=start_step)
    batches = device_prefetch(host_prefetch(batches), device=device)

    # preemption safety: SIGTERM flags the loop to flush a checkpoint at
    # the current step and exit 0; a resume continues where it landed
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

    before = fused_preprocess.launches
    result = train_loop(cfg, batches, num_steps=args.num_steps,
                        train_dir=args.train_dir or None,
                        save_every=args.save_every,
                        log_every=args.log_every, rng_seed=args.seed,
                        eval_fn=build_eval_fn(cfg, args, device),
                        eval_every=args.eval_every,
                        keep_best=args.keep_best,
                        should_stop=stop.is_set, warm_start=warm_start,
                        max_consecutive_skips=args.max_consecutive_skips,
                        device=device)
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
