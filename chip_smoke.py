"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths (tf_face_toolbox_tpu_torch) once each at full
width. Extraction: resnet_v1_50 (imagenet stem, gap head, 512-d, bf16,
seeded random weights): raw uint8 faces -> fused preprocess kernel ->
flip-averaged fused-block engine -> L2-normalized embeddings, then the
extract and eval_lfw CLIs. 1:N search: those embeddings among 10^6
seeded distractors in DeviceGallery (f32, bf16, int8 stores) through
the two top-k kernels, then the cluster, search and
eval_identification CLIs. Training (BASELINE config 4): resnet_v1_50
(face stem, bf16, f32 master weights), CosFace over 10,572 classes,
batch 256, synthetic faces augmented through the preprocess kernel,
by cli.train; then train -> preempt (SIGTERM) -> resume -> serve the
trained checkpoint through the fused-block engine; then data-parallel
training (BASELINE config 5 at the card's one replica) through torchrun;
then the class-sharded Partial-FC head (BASELINE config 7: 93,431
classes) at one rank and on four gloo ranks sharing the card; then the
loss heads: BASELINE preset 8 (AdaFace, 3 sub-centers) by cli.train,
MagFace, CurricularFace, center and triplet losses on a P x K batch,
and AdaFace with center loss and CurricularFace on four gloo ranks;
then SE-ResNet-50, ResNeXt-50, SE-ResNeXt-50, DenseNet-121 and the
space2depth stem served, benchmarked and trained; then the rest of
extraction (resumable chunks, quality, data-parallel ranks), IJB
templates at IJB-C's counts, and Adam, AdamW, LARS and distillation
at config 4; then the data layer (an InsightFace .bin at LFW's counts,
a .rec, TFRecords; merge; the bundle export) and the HTTP daemon booted
from that bundle, its /identify through kernels 3 and 4 over 10^6 rows,
a hot reload and the SIGTERM drain; then the gallery sharded four
ways at 4 x 10^6 rows, iResNet and MobileFaceNet, the DCT input with
dct_resnet_50 and the ViT family, and int8 serving (W8A8 convs on the
int8 tensor cores, calibrated static bundles, the int8 daemon) with
quantization-aware training. Runs that time nothing (the
cli.train, cli.extract and other CLI runs, whose steps, launches and
outputs are checked) go side by side with other untimed work; every
timed run (bench, bench_train under torchrun, time_training in this
process, the kernels' timings) has the card to itself.
Phases:

1. device: the card's name and power limit; TF32 off for f32 checks
2. build: every CUDA kernel from tf_face_toolbox_tpu_torch/csrc
3. kernel vs plain PyTorch version at the main path's shapes (the
   preprocess kernel also on a constant image and on 512x512 frames)
4. slice: the e2e chain, its launch counts, and its embeddings held
   against the f32 module path (no kernels) on the same card
5. CLIs: extract (--engine fused) and eval_lfw as subprocesses
6. times: kernels vs plain versions; the preprocess kernel warm and
   cold (inputs past the L2), eagerly and as CUDA-graph replays, and its
   library route (F.interpolate and the standardization); the fused
   blocks' library route (the folded engine's cuDNN/cuBLAS convs for the
   same blocks, per stage); the port bench (informational)
7. top-k kernels vs plain versions: 2^20-row stores, 10^6 valid, 1%
   tombstoned, B 1/64/300, k 5/20/100 and k 1100; k 12,000 (lists in
   the workspace) at 2^16 rows; galleries of 100-d (and 5-d f32) rows
   against their plain twins
8. gallery slice: enroll, search, remove, search; launch counts
9. gallery CLIs: cluster (bf16, int8), search, eval_identification,
   side by side
10. gallery times: kernels vs plain at 2^20 rows and 10^7 rows, each
    beside its bound, the library route (matmul + torch.topk) at B=64,
    and the f32 and int8 galleries' search latency at 2^20 rows
    (tf_face_toolbox_tpu_torch.bench_search gallery gives the
    10^7-row galleries' latency and device time by kernel)
11. training: the preprocess kernel at the train shape ((256, 112,
    112, 3) u8 crops, identity resize, random flips -> bf16) vs its
    plain version and its bound; one full-width step through the
    kernel and through the plain augment chain from the same variables
    and draws (loss within 1%, every leaf's update cosine >= 0.999);
    cli.train for 12 config-4 steps (one kernel launch a step, finite
    losses); a packed shard through the python loader and, where
    native/faceshard builds (it links libjpeg), the native one;
    training faces/sec (bench_train: CUDA events over 10 steps after 3,
    peak memory, idle share from torch.profiler, share of the bf16 peak);
    kernel 1's library route at the train shape
12. checkpoints (BASELINE config 4 on a packed shard of synthetic
    faces, python loader): cli.train --train_dir --save_every 10 with
    the LFW hook (--eval_every 5 --keep_best lfw_accuracy), SIGTERM past
    step 10 (exit 0, a flush at the current step k), the same command
    to 20 (resumes at k; kernel 1 launches = steps taken); exact resume
    in-process (6 straight steps, twice, vs 3 + save + restore + 3,
    cuDNN deterministic); one checkpoint's bytes, save and restore
    times; cli.extract --checkpoint_dir --engine fused (24 kernel 2
    launches at the face stem's 56/28/14/7 stages; beside the exact
    resume) and eval_lfw, held
    against the folded engine and the f32 module path (cosine >=
    0.999, batch-centered >= 0.99); kernel 2 on each trained stage's
    stack (56x56x256, 28x28x512, 14x14x1024, 7x7x2048, each fed the
    previous stage's output) vs its plain version, its time and bound
13. data-parallel training (BASELINE config 5; this machine has one
    GPU, so its 8 replicas of 256 are cut to 1): (a) torchrun, one rank,
    NCCL: cli.train --preset v5e8_data_parallel --multihost
    --pallas_input for 10 steps (kernel 1 once a step), then bench_train
    --preset v5e8_data_parallel (faces/s, ms/step, idle share, peak
    memory, the NCCL all-reduce of the step's gradients, timed apart:
    the trainer skips it at one rank); (b) two ranks sharing cuda:0 over
    gloo, r50 face stem, 32 rows a rank, 2 bf16 steps: the ranks' states
    equal (max |diff| 0), and held against replica_loop_step in this
    process (per-leaf update cosine >= 0.999, BN running statistics
    within 2 bf16 steps of each value, or of 1% of its tensor's largest
    where smaller, losses within 1%); (c) remat at the batch of a
    replica (256): False, True, "save_convs": gradients against no
    remat (deterministic cuDNN), ms/step and peak memory. (a)'s cli.train
    and (b)'s ranks (untimed) run in phase 12 beside its preemption flow
14. the class-sharded Partial-FC head (BASELINE config 7; the preset's
    2 x 4 mesh of 256 rows a device cut to this card's one rank): (a)
    cli.train --preset large_id_pfc_v5e8 --pallas_input for 10 steps
    (93,431 classes, sampled at 0.1: budget 9,344; kernel 1 once a
    step), then time_training in this process (bench_train's
    measurement) for the sampled head and for the exact one
    (pfc_sample_rate 1; 8 steps after 2, 1 profiled): faces/s, ms/step,
    peak memory, device ms by kind with the head's share, against phase
    11's config-4 rate; (b)
    four ranks sharing cuda:0 over gloo as data 2 x model 2, config 7
    (r50 face stem, its warmup schedule) at 16 rows a rank, 93,431
    classes (46,716 a shard), 2 bf16 steps of the exact head, then 2 of
    the sampled one at 0.1 (budget 4,672), cuDNN deterministic:
    gloo's MAX on CUDA tensors (the head's pmax), the replicated tensors
    equal on all four ranks and each shard on its two data ranks (max
    |diff| 0), and held against replica_loop_step(model=2) in this
    process, each step from the ranks' state before it (losses within 1%,
    per-leaf update cosine >= 0.999 with the classifier reassembled from
    its shards, BN running statistics within 2 bf16 steps); kernel 1 2
    launches a rank a head. Phase 15's cli.train (untimed) runs beside
    (b), and its two gloo heads run on (b)'s four ranks after (b)'s two
15. the loss heads (BASELINE preset 8, ``adaface_noisy_data``): (a)
    cli.train --preset adaface_noisy_data --pallas_input for 10 steps
    (r50 face stem, bf16, 10,572 classes x 3 sub-centers, batch 256,
    random erase 0.25, cosine LR; kernel 1 once a step, finite losses,
    the logged adaface_norm_mean moving from 20), then time_training of
    adaface_noisy_data in this process (bench_train's measurement; 8
    steps after 2, 1 profiled: faces/s, ms/step, peak memory, device ms
    by kind with the head's share) against phase 11's config-4 rate; (b) at config 4's width, one step from the same state
    through kernel 1 and through the plain augment chain for MagFace,
    CurricularFace, and CosFace with center loss and triplet on a P x K
    batch of 64 identities x 4 faces drawn by balanced_batch_iterator
    from phase 11's shard (losses within 1%, every leaf's update cosine
    >= 0.999, the head state included); (c) phase 14(b)'s four gloo ranks
    sharing cuda:0 as data 2 x model 2, preset 8 (r50 face stem, 3 sub-centers,
    random erase, its schedule) at 16 rows a rank: AdaFace with center
    loss, then CurricularFace, 2 bf16 steps each, held as phase 14(b)
    holds config 7 (the centers split and compared as the classifier is;
    AdaFace's statistics and t within 1e-3)
16. the ResNet family and DenseNet (BASELINE configs 2 and 3) at
    published widths, bf16, seeded weights, 128 faces (256 images with
    their mirrors) at 112x112: (a) se_resnet_50, resnext_50,
    se_resnext_50 and densenet_121 (face stem), resnet_v1_50 at the face
    stem beside them and at the space2depth stem, each through the route
    cli.extract --engine auto takes (the folded engine, or the module
    path for ResNeXt and DenseNet), held against the f32 module path
    (cosine >= 0.999, batch-centered >= 0.95), its faces/s plain and e2e
    (kernel 1 once a batch), peak memory and device time by kernel kind;
    (b) resnet_v1_50 --stem space2depth --impl fused: 13 kernel 2
    launches a batch, each fused stage (56x56 with its stride-1 entry
    block, 28, 14, 7) against its plain version, the folded cuDNN stages
    and the bound; se_resnet_50 fused launches kernel 2 zero times and
    equals folded; (c) cli.extract --network densenet_121 --engine auto
    on phase 5's shard (beside (d)'s cli.train runs): the fallback
    logged, cosine >= 0.999 against the f32 module path; (d) cli.train
    --pallas_input, 5 steps, batch 64, 10,572 classes, on se_resnet_50
    and densenet_121 (kernel 1 once a step, finite losses) and their
    training rates (bench_train)
17. the rest of extraction at full width (resnet_v1_50, face stem,
    512-d, bf16, seeded weights) on a packed shard of 4,096 synthetic
    120x120 faces, python loader: (a) cli.extract --engine fused
    --chunk_rows 1024 --batch 256, SIGKILLed once its second chunk's
    sidecar is on disk, then run again: the rerun computes only the
    chunks not recorded (at most the one in flight is recomputed; kernel
    2 launches of each run), and the output agrees with an uninterrupted
    one-shot run (per-face cosine >= 0.99999); (b) one file from two
    disjoint --rows ranges (its first and last chunks; the first beside
    (a)'s rerun); (c) the one-shot run's --output_quality
    (through kernel 2): its first 32 faces against the f32 module path on
    the host (cosine >= 0.999, quality within 5e-3); (d) --data_parallel
    under torchrun (one NCCL rank) and two gloo ranks sharing the card,
    a batch ragged against the ranks (bf16 module path, cosine >= 0.9999;
    the ranks' returns equal, rank 0's resumable file equal to them),
    each against the module path in this process
18. IJB templates at IJB-C's 1:1 counts (469,375 faces, 23,124
    templates, 15,658,489 pairs; synthetic embeddings):
    aggregate_templates and verify_templates on the card against a
    plain host computation (TAR equal, templates within 1e-5), and
    cli.eval_templates on a 10^6-pair file beside the host computation;
    each stage's seconds
19. Adam, AdamW and LARS at config 4: cli.train 6 steps under each
    (kernel 1 once a step; the three runs side by side, as the two
    distillation runs below), faces/s, device ms and peak memory under
    each beside phase 11's SGD (time_training, 8 steps after 2); 2 f32 steps at
    batch 32 from one state and one set of batches on the card and on
    the host (TF32 off), the largest per-leaf difference over the
    update (< 1 under Adam and AdamW, < 0.1 under LARS); an exact
    resume under Adam (max |diff| 0); distillation of a fresh
    resnet_v1_50 from phase 12's checkpoint at alpha 1 and 0.5
    (cli.train 6 steps: distill_loss falling at alpha 1; faces/s at
    0.5, whose step computes both losses)
20. the data layer: a synthetic InsightFace lfw.bin at LFW's counts
    (6,000 pairs, 12,000 112x112 JPEG faces, 3 PNG entries, entries as
    bytes and as uint8 arrays), a .rec/.idx of 200 faces of 40 sparse
    identities (a split record), two TFRecord files of 100; cli.import_bin,
    cli.import_rec, cli.convert_tfrecord and cli.export (phase 12's
    checkpoint, crop_from 112) side by side, then cli.merge --relabel of
    the .rec and TFRecord shards: every shard's records and labels
    against the inputs, the pairs file against issame; cli.extract
    --engine fused on the imported LFW from --checkpoint_dir and from
    --bundle side by side (kernel 2: 12 launches a batch of 256; the two
    outputs equal, max |diff| 0), then cli.eval_lfw on the pairs file
21. the daemon at full width: cli.serve --bundle (resnet_v1_50, face
    stem, 512-d, bf16, --engine auto = folded, --max_batch 64) as a
    subprocess on localhost: (a) the bundle's variables equal the
    step-20 checkpoint's; (b) with a 10^6-row seeded f32 gallery: 256
    /embed from 32 clients (fewer device calls than requests, each
    equal to its /embed_batch row, cosine >= 0.999 against the f32
    module path on the card), one /embed_batch of 256 faces (npy),
    /enroll 128, /deenroll one, /identify 128 at k 5 (kernel 3: top-1
    the face's own label, labels and scores against the plain programs
    on the /gallery/save snapshot, which equals the live rows), SIGTERM
    (exit 0, `drained; bye`, topk= the /identify count); (c) the int8
    gallery (kernel 4; labels and scores equal the plain int8
    programs'); (d) --checkpoint_dir at step 10 with --watch_interval 1:
    step 20 copied in under traffic, /healthz moves to 20, no request
    fails, embeddings against step 20's f32 module path; (e) gRPC's
    Embed and EmbedBatch against HTTP's rows where grpc is installed;
    (f) bulk faces/s, single /embed p50/p99 at 32 clients, /identify
    latency, beside phase 16's folded rate
22. the sharded gallery: 4 x 10^6 seeded unit 512-d rows (8 planted
    groups of 4 equal rows across shards, one 1,024-row label) in a
    DistributedGallery over [cuda:0] * 4 at 3.2 GB a shard, bf16 (one
    bf16 DeviceGallery at 3.2 GB refuses the rows) and int8: searches at
    B 1 and 64, k 5 (int8: coarse k 20) launch kernel 3 or 4 once a
    shard; labels and scores against one unbounded DeviceGallery and
    the plain programs, the groups in the reference's shard-major order
    (a numpy sort on the host); a tombstone, then a compaction crossing;
    the compacted store's snapshot loaded into an int8 DeviceGallery;
    the sharded search timed against the one store's; cli.search
    --data_parallel over 10^6 rows and 1,024 probes against cli.search;
    cli.serve --gallery_shards -1 over phase 21's snapshot, its
    /identify against phase 21's answers; serve() in this process over
    a four-shard gallery (/enroll with a 507, /identify, /deenroll,
    /gallery)
23. iresnet_100 and mobilefacenet at full width
    (bf16, seeded weights, --input_norm fixed): cli.extract --engine
    auto (the module-path fallback logged) over 1,024 packed faces
    against the f32 module path, their module path's faces/s at batch
    128 beside resnet_v1_50's; cli.train of iresnet_50 and mobilefacenet
    (5 steps at batch 64: finite losses, every BN statistic moved) and
    their training faces/s. Phase 23's CLI runs go beside phase 22's
    host work
24. the DCT input and the JPEG-block-token ViTs at full width (bf16,
    seeded weights, per-image norm): (a) 128 synthetic faces as 4:4:4
    JPEG coefficients (Annex K tables at IJG quality 90, built in
    numpy): decode_dct within 1 LSB of the host's, prepare_coefficients
    within 1e-4, block_dct's round trip and Parseval, the frequency flip
    against the pixel flip, prepare_coefficients against block_dct of
    the standardized decoded faces (per-face cosine >= 0.999); (b)
    cli.extract --engine auto of dct_vit_small, dct_vit_tiny and
    dct_resnet_50 over phase 23's 1,024 faces (the module-path fallback
    logged) against the f32 module path (cosine >= 0.999), coefficient
    input (flipped in the frequency domain) against pixel input of the
    decoded faces (>= 0.999), the module path's faces/s plain and e2e
    (kernel 1 once a batch) beside resnet_v1_50's; (c) cli.train
    --network dct_vit_small --drop_path 0.1 --pallas_input (batch 128,
    5 steps, kernel 1 once a step) and dct_resnet_50 (batch 64, 5 steps,
    every BN statistic moved), one DCT-input step against the u8 step
    on the decoded frames (losses equal, update cosine >= 0.999), and
    dct_vit_small's training rate; (d) cli.extract --loader dct_domain
    and native_dct where native/faceshard builds. Phase 24's CLI runs go
    beside phase 22's host work
25. int8 serving and QAT at full width (resnet_v1_50, face stem, 512-d,
    bf16): (a) int8_conv2d_nhwc (torch._int_mm on the int8 tensor cores,
    over an int8 im2col) at each of the net's int8 conv shapes, and at
    resnext_50's grouped 3x3s (block-diagonal), at 256 images, bit
    for bit against its float64 plain version, its time
    beside the bf16 cuDNN conv of the shape and its bound (int8
    operations at 1,979 TOP/s, bytes at 3.35 TB/s); (b) faces/s at
    batch 128 e2e (kernel 1 once a batch, 52 _int_mm convs a forward) of
    dynamic and static int8 beside the fp module path (and phase 16's
    folded rate); cli.export --quant_mode static --calibrate_data of phase 12's
    checkpoint, then cli.extract --bundle of its 512 eval faces, held
    against the f32 module path (cosine >= 0.98) and against the same
    int8 module with its convs on the float64 plain route (>= 0.9999);
    (c) cli.serve --bundle over the int8 bundle with phase 21's 10^6-row
    gallery in f32 and in int8: /identify through kernels 3 and 4 against
    the plain programs; cli.train --qat --pallas_input (5 steps at batch
    64: finite losses, kernel 1 once a step), then its static bundle
    (cli.export) served on the bundle's module path. Phase 25's CLI
    chains run beside
    phase 22's host work; phase 22 joins them, and waits for (c)'s
    daemons to be serving, before it times anything
26. alignment, the iResNet interop and the acceptance runner at full
    width: (a) ops/align.warp_similarity_torch on the card over 256
    seeded 250x250 faces with random similarity landmarks -> 112x112,
    within 1 LSB of the float64 numpy warp with >= 98% of the values
    equal, timed with CUDA events; (b) phase 23's seeded iresnet_100
    .npz through cli.export_torch -> InsightFace .pth ->
    cli.import_torch -> .npz (bit-equal), then cli.extract --engine auto
    --input_norm fixed of it over phase 23's 1,024 faces (per-face cosine
    >= 0.999 against phase 23's embeddings); (c) python -m
    tf_face_toolbox_tpu_torch.acceptance at resnet_v1_50 (bf16, 512-d)
    over a synthetic LFW-layout directory at LFW's 6,000 pairs, the
    golden rows this process's f32 module path gives
    (--reference_embeddings): exit 0, every gate PASS. (b)'s and (c)'s
    CLI runs go beside phase 22's host work; phase 22 joins them

Exits non-zero on any failure, or when torch sees no CUDA device:
there is no CPU path. Imports nothing of JAX. Scratch files go under
build/smoke/ in the checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.bench_blocks import (
    graph_ms, in_turns, run_folded, stack_work, stage_operands, stage_plans)
from tf_face_toolbox_tpu_torch.bench_search import (
    gallery_search_latency, quantize_rows, unit_rows)

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_START = time.time()


def say(*parts) -> None:
    """Print a line; a phase's header ("[N name] ...") also gets the
    seconds since the smoke started."""
    if parts and isinstance(parts[0], str) and parts[0][:1] == "[":
        parts = (*parts, f"(+{time.time() - _START:.1f} s)")
    print(*parts, flush=True)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at ``x`` (8 significant bits)."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def per_image_cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # float64: an f32 cosine of two equal 800k-value maps is off by 4e-5
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    return torch.nn.functional.cosine_similarity(a, b, dim=1)


def check_block_stack(name, x, entry, tail, folded,
                      stats: list) -> torch.Tensor:
    """Fused-block kernel vs its plain version on one stage's stack, and
    the library route (the folded engine's cuDNN / cuBLAS convs for the
    same blocks) timed in turns with the kernel: eagerly (host gaps
    count) and as CUDA-graph replays (device time alone). Returns the
    kernel's output."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    from tf_face_toolbox_tpu_torch.serving.fused_block import (
        fused_bottleneck_stack, fused_bottleneck_stack_reference)

    h, w = x.shape[1:3]
    got = fused_bottleneck_stack(x, entry, tail, h=h, w=w)
    torch.cuda.synchronize()
    want = fused_bottleneck_stack_reference(x, entry, tail, h=h, w=w)
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    cos = per_image_cos(got, want).min().item()

    def kernel():
        return fused_bottleneck_stack(x, entry, tail, h=h, w=w)

    def library():
        return run_folded(x, folded)

    ks, ls = in_turns(kernel, library, 1, time_ms)
    kg, lg = in_turns(kernel, library, 1, graph_ms)
    ms, library_ms = sum(ks) / len(ks), sum(ls) / len(ls)
    plain = time_ms(
        lambda: fused_bottleneck_stack_reference(x, entry, tail, h=h, w=w))
    say(f"  fused_block {name} x{tuple(x.shape)}: max_abs={err:.4g} "
        f"(max|ref|={peak:.4g}, /rms={err / rms:.4g}) min_cos={cos:.7f} "
        f"plain {plain:.3f} ms; in turns, kernel / library route / route / "
        f"kernel: eager {ks[0]:.3f} / {ls[0]:.3f} / {ls[1]:.3f} / "
        f"{ks[1]:.3f} ms, graph replays {kg[0]:.3f} / {lg[0]:.3f} / "
        f"{lg[1]:.3f} / {kg[1]:.3f} ms")
    # bf16 output: a rounding flip anywhere upstream moves an output by
    # one bf16 step, whose size at the map's largest value is peak/128.
    for pl in stage_plans(x, entry, tail):
        say(f"    plan: tile {pl['th']}x{pl['tw']}, g {pl['g']}, cluster "
            f"{pl['cluster']}, grid {pl['grid']}, stages {pl['stages']}, "
            f"CTAs/SM {pl['ctas_per_sm']}, n-blocks {pl['nb']}")
    expect(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    expect(cos >= 0.9999, f"{name}: min cosine {cos} < 0.9999")
    expect(err <= 2 * peak / 128, f"{name}: max_abs {err} > 2 bf16 steps "
                                  f"at the peak {peak}")
    b_ms, b_by = bound(*stack_work(x, entry, tail), "bfloat16")
    stats.append({"stage": name, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain, "library_route_ms": library_ms,
                  "library_route_range": (min(ls), max(ls)),
                  "graph_ms": sum(kg) / len(kg),
                  "library_route_graph_ms": sum(lg) / len(lg),
                  "bound_ms": b_ms, "bound_by": b_by})
    return got


GALLERY_DTYPES = ("float32", "bfloat16", "int8")
TOPK_TOL = 1e-5     # f32 sums in another order: scores, near-tie width
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): device
# memory bytes/s, and operations/s by operand type (f32 outside the
# tensor cores: the top-k kernel's products are exact f32, no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """Least time (ms) the card could take: each input byte read and
    each output byte written once at the memory rate, or the operations
    at the peak for their type, whichever is larger; and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def topk_bound(dtype: str, cap: int, batch: int, d: int, k: int,
               bias: bool = False) -> tuple[float, str]:
    """Bound of one top-k search: the store, probes, (int8) row and
    probe scales, bias and the (B, k) result once; 2 B cap D
    operations."""
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    nbytes = (cap + batch) * d * item + batch * k * 8 + cap * 4 * bias
    if dtype == "int8":
        nbytes += (cap + batch) * 4
    return bound(nbytes, 2 * batch * cap * d, dtype)


def near_ties(ref: np.ndarray, k: int, tol: float = TOPK_TOL) -> np.ndarray:
    """(B, k) mask of positions whose score in ``ref`` (the plain top
    k+1) is within ``tol`` of a neighbour's: where f32 sums in another
    order may swap two rows."""
    gap = np.diff(-ref, axis=1) <= tol
    near = np.zeros((ref.shape[0], k), bool)
    near[:, 1:] |= gap[:, :k - 1]
    near[:, :gap.shape[1]] |= gap[:, :k]
    return near


def check_topk_case(label, dtype, store, scale, probes, pscale, n_valid, k,
                    bias, dead) -> float:
    """One kernel call vs its plain version; → max |score error|."""
    from tf_face_toolbox_tpu_torch.ops import topk as ttk

    if dtype == "int8":
        got = ttk.cosine_topk_q(store, scale, probes, pscale, n_valid, k,
                                bias=bias)
        torch.cuda.synchronize()
        want = ttk.cosine_topk_q_reference(store, scale, probes, pscale,
                                           n_valid, k, bias=bias)
        expect(torch.equal(got[1], want[1]), f"{label}: indices differ")
        expect(torch.equal(got[0], want[0]), f"{label}: scores not bit-equal")
    else:
        got = ttk.cosine_topk(store, probes, n_valid, k, bias=bias)
        torch.cuda.synchronize()
        want = ttk.cosine_topk_reference(store, probes, n_valid, k + 1,
                                         bias=bias)
        ws = want[0].cpu().numpy()
        near = near_ties(ws, k)
        gi, wi = got[1].cpu().numpy(), want[1].cpu().numpy()[:, :k]
        expect((gi == wi)[~near].all(),
               f"{label}: indices differ away from near-ties")
        err = (got[0] - want[0][:, :k]).abs().max().item()
        expect(err <= TOPK_TOL, f"{label}: score error {err} > {TOPK_TOL}")
    s, i = got[0].cpu().numpy(), got[1].cpu().numpy()
    expect(bool((np.diff(s, axis=1) <= 0).all()), f"{label}: not descending")
    expect(bool((i < n_valid).all()) and not np.isin(i, dead).any(),
           f"{label}: a masked or tombstoned row surfaced")
    return (got[0] - want[0][:, :k]).abs().max().item()


def phase_topk_kernels(g) -> dict:
    """Phase 7: both top-k kernels vs their plain versions."""
    from tf_face_toolbox_tpu_torch.ops import topk as ttk

    cap, n_valid, d = 1 << 20, 1_000_000, 512
    base = unit_rows(g, cap, d)
    base[n_valid - 1] = base[5]             # exact duplicate, another CTA
    dead = torch.randperm(n_valid, generator=g, device="cuda")[:n_valid // 100]
    dead = dead[(dead != 5) & (dead != n_valid - 1)]
    bias = torch.zeros(cap, device="cuda")
    bias[dead] = -2e9
    dead_np = dead.cpu().numpy()
    # probes: a duplicated row, three tombstoned rows, a masked row, and
    # fresh unit vectors
    probes = torch.cat([base[5:6], base[dead[:3]], base[n_valid + 10:n_valid + 11],
                        unit_rows(g, 295, d)])
    err = {"topk": 0.0, "topk_q": 0.0}
    t0 = time.time()
    for dtype in GALLERY_DTYPES:
        store, scale, pq, ps = store_operands(dtype, base, probes)
        name = "topk_q" if dtype == "int8" else "topk"
        # k 1100: past the old 1024 limit, lists still in shared memory
        for b, k in [(b, k) for b in (1, 64, 300) for k in (5, 20, 100)] + [
                (16, 1100)]:
            e = check_topk_case(f"{dtype} B={b} k={k}", dtype, store, scale,
                                pq[:b], None if ps is None else ps[:b],
                                n_valid, k, bias, dead_np)
            err[name] = max(err[name], e)
        if dtype != "int8":
            _, i = ttk.cosine_topk(store, probes[:1], n_valid, 3, bias=bias)
            i = i.cpu().numpy()
            expect(i[0, 0] == 5 and i[0, 1] == n_valid - 1,
                   f"{dtype}: duplicate rows not in index order: {i[0]}")
        del store, scale
    say(f"[7 top-k kernels] cap 2^20 x 512, n_valid 10^6, "
        f"{len(dead_np)} tombstones, f32/bf16/int8 x B 1/64/300 x k "
        f"5/20/100, and B=16 k=1100: int8 index- and bit-equal; f32/bf16 "
        f"max score error {err['topk']:.3g}, index-equal away from "
        f"near-ties (<= {TOPK_TOL}); no masked/tombstoned row surfaced; "
        f"{time.time() - t0:.1f} s")
    del base
    for name, e in large_k_case(g).items():
        err[name] = max(err[name], e)
    any_width_galleries(g)
    return err


def store_operands(dtype: str, base: torch.Tensor, probes: torch.Tensor):
    """(store, row scales, probes, probe scales) of one store dtype."""
    if dtype == "int8":
        return (*quantize_rows(base), *quantize_rows(probes))
    return base.to(getattr(torch, dtype)), None, probes, None


def large_k_case(g) -> dict:
    """Phase 7: k 12,000 at 2^16 rows, B=2, every store. Two probes'
    lists (192,000 bytes) do not fit beside the ring, so the plan keeps
    them in the workspace, and the merge in a global scratch."""
    from tf_face_toolbox_tpu_torch.ops import topk as ttk

    cap, n_valid, d, b, k = 1 << 16, 60_000, 512, 2, 12_000
    base = unit_rows(g, cap, d)
    dead = torch.randperm(n_valid, generator=g, device="cuda")[:n_valid // 100]
    dead = dead[dead != 5]
    bias = torch.zeros(cap, device="cuda")
    bias[dead] = -2e9
    probes = torch.cat([base[5:6], unit_rows(g, b - 1, d)])
    err = {"topk": 0.0, "topk_q": 0.0}
    t0 = time.time()
    for dtype in GALLERY_DTYPES:
        plan = ttk.launch_plan(b, cap, k, ttk._n_sms(base.device),
                               dtype=getattr(torch, dtype))
        expect(not plan["shared_lists"] and plan["merge_scratch"],
               f"{dtype} k={k}: plan {plan} keeps its lists in shared memory")
        store, scale, pq, ps = store_operands(dtype, base, probes)
        name = "topk_q" if dtype == "int8" else "topk"
        err[name] = max(err[name], check_topk_case(
            f"{dtype} B={b} k={k}", dtype, store, scale, pq, ps, n_valid, k,
            bias, dead.cpu().numpy()))
    say(f"  k={k} at 2^16 rows, B={b}, lists in the workspace, merge in a "
        f"global scratch: int8 bit-equal, f32/bf16 max score error "
        f"{err['topk']:.3g}, index-equal away from near-ties; "
        f"{time.time() - t0:.1f} s")
    return err


def any_width_galleries(g) -> None:
    """Phase 7: DeviceGallery of 100-d rows in every store and of 5-d
    rows in f32 (not a multiple of 16 bytes: the gallery pads the store
    and the probes), kernels vs the plain programs on the same rows."""
    from tf_face_toolbox_tpu_torch.ops import topk as ttk
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    n, k = 1 << 16, 10
    t0 = time.time()
    for dtype, dim in (("float32", 100), ("bfloat16", 100), ("int8", 100),
                       ("float32", 5)):
        rows = unit_rows(g, n, dim).cpu().numpy()
        probes = rows[:64] + 0.1 * unit_rows(g, 64, dim).cpu().numpy()
        kern = DeviceGallery(dim, dtype=dtype, device="cuda")
        plain = DeviceGallery(dim, dtype=dtype, device="cuda")
        plain.use_kernels = False
        for gal in (kern, plain):
            gal.enroll(rows, np.arange(n))
            gal.remove(3)
        counter = ttk.cosine_topk_q if dtype == "int8" else ttk.cosine_topk
        before = counter.launches
        lk, sk = kern.search(probes, k=k)
        expect(counter.launches == before + 1, f"{dtype} d={dim}: no launch")
        # int8 at the same k: its coarse stage keeps 4k rows
        lp, sp = plain.search(probes, k=k if dtype == "int8" else k + 1)
        label = f"gallery {dtype} d={dim} (row {kern._dev.shape[1]})"
        expect(3 not in lk, f"{label}: a removed label surfaced")
        if dtype == "int8":
            expect(np.array_equal(lk, lp) and np.array_equal(sk, sp),
                   f"{label}: kernel and plain two-stage searches differ")
        else:
            near = near_ties(sp, k)
            expect((lk == lp[:, :k])[~near].all(),
                   f"{label}: labels differ away from near-ties")
            expect(np.abs(sk - sp[:, :k]).max() <= TOPK_TOL,
                   f"{label}: scores differ")
        del kern, plain
    torch.cuda.empty_cache()
    say(f"  galleries of 100-d rows (f32, bf16, int8) and 5-d rows (f32), "
        f"2^16 rows, 64 probes, k={k}: equal to the plain programs "
        f"(int8 exactly, f32/bf16 away from near-ties); "
        f"{time.time() - t0:.1f} s")


def phase_gallery_slice(g, faces: np.ndarray) -> dict:
    """Phase 8: the 1:N slice on the card through DeviceGallery."""
    from tf_face_toolbox_tpu_torch.ops import topk as ttk
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    n_dist = 1_000_000
    distract = unit_rows(g, n_dist, faces.shape[1]).cpu().numpy()
    labels = np.arange(len(faces))
    # probes: every face, and 64 distractors (well separated from all)
    probes = np.concatenate([faces, distract[:64]])
    removed = [0, 7, 130, 300]
    t0 = time.time()
    galleries, results = {}, {}
    ttk.cosine_topk.launches = 0
    ttk.cosine_topk_q.launches = 0
    for dtype in GALLERY_DTYPES:
        gal = DeviceGallery(faces.shape[1], dtype=dtype, device="cuda")
        gal.enroll(distract, 10_000 + np.arange(n_dist))
        gal.enroll(faces[:128], labels[:128])
        gal.enroll(faces[128:], labels[128:])
        before = gal.search(probes, k=5)
        for lab in removed:
            expect(gal.remove(lab) == 1, f"{dtype}: remove({lab})")
        after = gal.search(probes, k=5)
        galleries[dtype] = gal
        results[dtype] = (before, after)
    torch.cuda.synchronize()
    launches = {"topk": ttk.cosine_topk.launches,
                "topk_q": ttk.cosine_topk_q.launches}
    expect(launches == {"topk": 4, "topk_q": 2},
           f"gallery launch counts {launches}, want topk 4 (f32 and bf16, "
           "2 searches each), topk_q 2")
    slice_s = time.time() - t0

    # the same searches through the plain programs (no launches); f32
    # and bf16 with one more column, for the near-tie test at rank 5
    plain = {}
    for dtype, gal in galleries.items():
        gal.use_kernels = False
        plain[dtype] = gal.search(probes, k=5 if dtype == "int8" else 6)
        if dtype == "float32":
            wide = gal.search(probes, k=21)[1]
        gal.use_kernels = True
    sims = faces @ faces.T
    np.fill_diagonal(sims, -1)
    for dtype in GALLERY_DTYPES:
        (l1, s1), (l2, s2) = results[dtype]
        expect(l1.shape == (len(probes), 5) and np.isfinite(s1).all(),
               f"{dtype}: search shape/finite")
        expect(not np.isin(l2, removed).any(), f"{dtype}: a removed label "
                                                "surfaced")
        pl, ps = plain[dtype]
        if dtype == "int8":
            expect(np.array_equal(l2, pl) and np.array_equal(s2, ps),
                   "int8: kernel and plain two-stage searches differ")
            continue
        near = near_ties(ps, 5)
        expect((l2 == pl[:, :5])[~near].all(),
               f"{dtype}: labels differ from the plain program away "
               "from near-ties")
        expect(np.abs(s2 - ps[:, :5]).max() <= TOPK_TOL,
               f"{dtype}: scores differ from the plain program")
    # int8 two-stage labels equal the f32 store's, away from near-ties,
    # for every probe whose coarse top-20 must hold its true top 5: the
    # f32 rank-5 and rank-21 scores 0.01 apart, several times the int8
    # store's coarse cosine error on unit vectors
    l8, s8 = results["int8"][1]
    l32, s32 = results["float32"][1]
    posed = wide[:, 4] - wide[:, 20] > 0.01
    expect(posed.sum() >= 32, f"only {posed.sum()} probes with a clear "
                              "rank-5 margin")
    near = near_ties(plain["float32"][1], 5)
    expect((l8 == l32)[posed[:, None] & ~near].all(),
           "int8 labels differ from the f32 store's")
    expect(np.abs(s8 - s32)[posed].max(initial=0) <= TOPK_TOL,
           "int8 rescored scores differ from the f32 store's")
    say(f"[8 gallery slice] {len(faces)} embeddings (128 phase-4 + 400 "
        f"CLI) among {n_dist} distractors, {len(probes)} probes (max cosine between two faces "
        f"{sims.max():.6f}), f32/bf16/int8 stores: enroll, search, remove "
        f"{removed}, search; removed labels never surface; labels equal "
        f"the plain programs' away from near-ties; int8 labels equal the "
        f"f32 store's on the {int(posed.sum())} probes where that is "
        f"well posed (all labels agree on {float((l8 == l32).mean()):.4f}); "
        f"launches {launches}; {slice_s:.1f} s")
    return launches


def phase_gallery_clis(work: str, out_npy: str) -> None:
    """Phase 9: the gallery CLIs as subprocesses on the CLI embeddings,
    side by side (they time nothing)."""
    from tf_face_toolbox_tpu_torch.ops.clustering import cluster_embeddings
    from tf_face_toolbox_tpu_torch.ops.verification import (
        identification_stats, cmc_curve)

    emb = np.load(out_npy)
    t0 = time.time()
    gal, probe = emb[:200], emb[100:300]
    paths = {}
    for name, arr in (("gal", gal), ("probe", probe)):
        paths[name] = os.path.join(work, f"{name}.npy")
        np.save(paths[name], arr)
    glab = np.arange(200)
    plab = np.r_[100:200, 1000:1100]         # 100 mated, 100 non-mated
    for name, lab in (("gal_list", glab), ("probe_list", plab)):
        paths[name] = os.path.join(work, f"{name}.txt")
        with open(paths[name], "w") as f:
            f.writelines(f"face_{i}.jpg {v}\n" for i, v in enumerate(lab))
    matches = os.path.join(work, "matches.npz")
    clusters = {dtype: os.path.join(work, f"clusters_{dtype}.npy")
                for dtype in ("bfloat16", "int8")}
    started = {f"cluster {dtype}": _cli(
        "cluster", "--embeddings", out_npy, "--output", out,
        "--store_dtype", dtype, "--k", "10", "--device", "cuda")
        for dtype, out in clusters.items()}
    started["search"] = _cli(
        "search", "--gallery", paths["gal"], "--probe", paths["probe"],
        "--gallery_list", paths["gal_list"], "--k", "5", "--output", matches,
        "--device", "cuda")
    started["eval_identification"] = _cli(
        "eval_identification", "--gallery", paths["gal"], "--probe",
        paths["probe"], "--gallery_list", paths["gal_list"], "--probe_list",
        paths["probe_list"], "--device", "cuda")
    stdout = {name: _cli_done(run, 300) for name, run in started.items()}

    for dtype, out in clusters.items():
        report = json.loads(stdout[f"cluster {dtype}"][-1])
        labels = np.load(out)
        want, n = cluster_embeddings(emb, threshold=0.6, k=10,
                                     store_dtype=dtype, device="cpu")
        expect(labels.shape == (400,) and report["rows"] == 400 and
               report["clusters"] == n and np.array_equal(labels, want),
               f"cli.cluster {dtype}: {report} vs plain {n} clusters")
    m = np.load(matches)
    expect(m["indices"].shape == (200, 5) and m["labels"].shape == (200, 5)
           and np.isfinite(m["scores"]).all(), "cli.search output shapes")
    ref = probe @ gal.T
    order = np.argsort(-ref, axis=1, kind="stable")[:, :6]
    ref_s = np.take_along_axis(ref, order, axis=1)
    near = near_ties(ref_s, 5)
    expect((m["indices"] == order[:, :5])[~near].all() and np.abs(
        m["scores"] - ref_s[:, :5]).max() <= TOPK_TOL,
        "cli.search differs from a numpy search")
    report = json.loads("\n".join(stdout["eval_identification"]))
    want = cmc_curve(None, None, None, None, ranks=(1, 5, 10),
                     stats=identification_stats(gal, glab, probe, plab,
                                                 device="cpu"))
    expect(report["probes"] == 100 and report["skipped"] == 100 and
           "open_set" in report and
           {int(k): v for k, v in report["cmc"].items()} == want["cmc"],
           f"cli.eval_identification report {report} vs {want}")
    say(f"[9 gallery CLIs] cluster (bf16, int8) labels equal the plain "
        f"run's ({n} clusters; random weights), search top-5 of 200 "
        f"probes, eval_identification CMC {report['cmc']} (random "
        f"weights: means nothing); the four side by side, "
        f"{time.time() - t0:.1f} s")


def library_route(dtype: str, store, probes, k: int, scale=None, pscale=None):
    """The same search as library calls (a matmul, int8's rescale, then
    torch.topk), timed for information only: nothing in the port calls
    it. bf16's product comes back in bf16; torch.topk leaves tie order
    open."""
    if dtype == "int8":
        def run():
            acc = torch._int_mm(probes, store.T)
            return torch.topk(acc.float() * pscale[:, None] * scale[None, :], k)
    else:
        p = probes.to(store.dtype)

        def run():
            return torch.topk(p @ store.T, k)
    return run


def phase_gallery_times(g) -> list:
    """Phase 10: kernel vs plain times (CUDA events) at 2^20 and 10^7
    rows for every store, each beside its bound, and the library route
    at B=64."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.ops import topk as ttk

    rows = []
    d = 512
    for cap in (1 << 20, 10_000_000):
        base = unit_rows(g, cap, d, dtype=torch.bfloat16)
        probes = unit_rows(g, 64, d)
        for dtype in GALLERY_DTYPES:
            if dtype == "int8":
                store = torch.empty((cap, d), dtype=torch.int8, device="cuda")
                scale = torch.empty(cap, device="cuda")
                for i in range(0, cap, 1 << 20):
                    store[i:i + (1 << 20)], scale[i:i + (1 << 20)] = \
                        quantize_rows(base[i:i + (1 << 20)].float())
                pq, ps = quantize_rows(probes)
            elif dtype == "float32":
                store = base.float()
            else:
                store = base
            for b in (1, 64):
                if dtype == "int8":
                    k = 20                          # the coarse 4 x k of k=5
                    args = (store, scale, pq[:b], ps[:b], cap, k)
                    kern, plain = ttk.cosine_topk_q, ttk.cosine_topk_q_reference
                else:
                    k = 5
                    args = (store, probes[:b], cap, k)
                    kern, plain = ttk.cosine_topk, ttk.cosine_topk_reference
                iters = 10 if cap == 1 << 20 else 3
                p_ms = bench.time_ms(lambda: plain(*args), iters=iters, warmup=1)
                k_ms = bench.time_ms(lambda: kern(*args), iters=iters, warmup=1)
                k_ms2 = bench.time_ms(lambda: kern(*args), iters=iters, warmup=1)
                p_ms2 = bench.time_ms(lambda: plain(*args), iters=iters, warmup=1)
                gb = store.numel() * store.element_size() / 1e9
                km = (k_ms + k_ms2) / 2
                b_ms, b_by = topk_bound(dtype, cap, b, d, k)
                row = {"dtype": dtype, "rows": cap, "batch": b, "k": k,
                       "ms": km, "plain_ms": (p_ms + p_ms2) / 2,
                       "gb_per_s": gb / km * 1e3, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_share": b_ms / km}
                lib = ""
                if b == 64:
                    route = (library_route(dtype, store, pq, k, scale, ps)
                             if dtype == "int8" else
                             library_route(dtype, store, probes, k))
                    row["library_route_ms"] = bench.time_ms(
                        route, iters=iters, warmup=1)
                    lib = (f", library route (matmul + torch.topk) "
                           f"{row['library_route_ms']:.3f} ms")
                    torch.cuda.empty_cache()
                rows.append(row)
                say(f"  top-k {dtype} {cap} rows B={b} k={k}: kernel "
                    f"{k_ms:.3f}/{k_ms2:.3f} ms ({gb / km * 1e3:.0f} GB/s of "
                    f"store), plain {p_ms:.3f}/{p_ms2:.3f} ms, bound "
                    f"{b_ms:.3f} ms ({b_by}), {b_ms / km:.1%} of it{lib}")
            if store is not base:
                del store
        del base
        torch.cuda.empty_cache()
    return rows


def spawn(cmd: list) -> tuple:
    """A subprocess started in the background from the checkout, its
    output into temporary files (an unread pipe could fill and stall it):
    for runs that time nothing, beside other work. ``collect`` ends it."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    return subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                            text=True), out, err


def collect(started: tuple, timeout: int) -> subprocess.CompletedProcess:
    """A ``spawn``ed subprocess's end: its exit code and output."""
    proc, out, err = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    err.seek(0)
    return subprocess.CompletedProcess(proc.args, proc.returncode,
                                       out.read(), err.read())


def _cli(name: str, *args) -> tuple:
    """A port CLI started in the background (``_cli_done`` ends it)."""
    return name, spawn([sys.executable, "-m",
                        f"tf_face_toolbox_tpu_torch.cli.{name}", *args])


def _cli_done(started: tuple, timeout: int = 600) -> list:
    """The stdout lines of a ``_cli`` run; fails unless it exits 0."""
    name, spawned = started
    proc = collect(spawned, timeout)
    expect(proc.returncode == 0, f"cli.{name} failed:\n{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines()


def start_train_cli(args: list) -> tuple:
    """cli.train started in the background (``finish_train_cli``)."""
    return args, spawn([sys.executable, "-m",
                        "tf_face_toolbox_tpu_torch.cli.train", "--device",
                        "cuda", *args])


def kill_train_clis(started: list) -> None:
    """End ``start_train_cli`` runs still going (a failure beside them)."""
    for _, (proc, _, _) in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def train_cli(args: list, timeout: int) -> tuple[int, dict, int]:
    """cli.train as a subprocess: (final step, each logged metric's values
    by name, kernel 1 launches it counted)."""
    return finish_train_cli(start_train_cli(args), timeout)


def train_clis(runs: list, timeout: int) -> list:
    """``train_cli`` of each argument list of ``runs``, the subprocesses
    side by side on the card (for runs that time nothing)."""
    started = [start_train_cli(args) for args in runs]
    return [finish_train_cli(s, timeout) for s in started]


def finish_train_cli(started: tuple, timeout: int) -> tuple[int, dict, int]:
    args, spawned = started
    proc = collect(spawned, timeout)
    expect(proc.returncode == 0, f"cli.train {' '.join(args)} failed:\n"
                                 f"{proc.stderr[-3000:]}")
    out = proc.stdout.strip().splitlines()
    expect(out and out[-1].startswith("done: step="),
           f"cli.train printed {out[-3:]}")
    step = int(out[-1].split("step=")[1].split()[0])
    launches = next(int(line.split("preprocess=")[1]) for line in out
                    if line.startswith("kernel launches:"))
    logged: dict = {"loss": []}
    for line in proc.stderr.splitlines():
        if line.startswith("step ") and "loss=" in line:
            for key, _, value in (pair.partition("=") for pair in
                                  line.split(":", 1)[1].split()):
                logged.setdefault(key, []).append(float(value))
    return step, logged, launches


TRAIN_STEPS = 12            # phase 11's cli.train steps (config 4)


def phase_train(g, work: str) -> dict:
    """Phase 11: training, BASELINE config 4, on the card."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp

    torch.cuda.empty_cache()
    t0 = time.time()
    # kernel 1 at the train shape: the crop at the output size
    crops = torch.randint(0, 256, (256, 112, 112, 3), generator=g,
                          device="cuda", dtype=torch.uint8)
    # int32, as the trainer passes them (the wrapper's dtype)
    flips = torch.randint(0, 2, (256,), generator=g, device="cuda",
                          dtype=torch.int32)
    want = fp.fused_preprocess_reference(crops, flips, out_h=112, out_w=112)
    got = fp.fused_preprocess(crops, flips, out_h=112, out_w=112)
    torch.cuda.synchronize()
    err32 = (got - want).abs().max().item()
    got16 = fp.fused_preprocess(crops, flips, out_h=112, out_w=112,
                                out_dtype=torch.bfloat16)
    want16 = want.to(torch.bfloat16).float()
    excess = ((got16.float() - want16).abs() - 1e-4).clamp_min(0)
    ulps = (excess / bf16_ulp(want16)).max().item()
    expect(err32 <= 1e-4, f"train-shape preprocess f32 max_abs {err32} > 1e-4")
    expect(ulps <= 1.0, f"train-shape preprocess bf16 {ulps} ulp > 1 beyond "
                        "1e-4")

    def kernel():
        return fp.fused_preprocess(crops, flips, out_h=112, out_w=112,
                                   out_dtype=torch.bfloat16)

    def plain():
        return fp.fused_preprocess_reference(crops, flips, out_h=112,
                                             out_w=112,
                                             out_dtype=torch.bfloat16)

    from tf_face_toolbox_tpu_torch import bench_preprocess as bp

    def library():
        # the same function as library calls: F.interpolate at the crop's
        # own size, the flip, the standardization
        return bp.library_route(crops, flips, size=112)

    route_err = (bp.library_route(crops, flips, size=112,
                                  dtype=torch.float32) - want).abs().max().item()
    k_ms = bench.time_ms(kernel, iters=50)
    p_ms = bench.time_ms(plain)
    r_ms = bench.time_ms(library, iters=50)
    k_ms2 = bench.time_ms(kernel, iters=50)
    # u8 in, bf16 out, int32 flags; per value the standardization (5
    # operations; the identity resize needs none)
    b_ms, b_by = bound(crops.numel() * 3 + 256 * 4, 5 * crops.numel(),
                       "float32")
    plan = fp.launch_plan(256, 112, 112, 3, 112, 112)
    k_mean = (k_ms + k_ms2) / 2
    say(f"[11 train] {bench.gpu_info()}")
    say(f"  preprocess train shape (256,112,112,3) u8 -> bf16 112, random "
        f"flips: f32 max_abs={err32:.3g}, bf16 max {ulps:.2f} ulp beyond "
        f"1e-4; kernel {k_ms:.4f} / {k_ms2:.4f} ms (eager, warm), plain "
        f"{p_ms:.3f} ms, library route (F.interpolate, flip, standardize; "
        f"bf16) {r_ms:.4f} ms (max |route - plain| {route_err:.3g}, f32), "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / k_mean:.1%} of it; plan "
        f"cluster {plan['cluster']}, {plan['threads']} threads "
        f"x {plan['vals']} values, copy {plan['copy']}, persist "
        f"{plan['persist']}")
    del crops, got, got16, want, want16

    # the main path (cli.train, config 4, TRAIN_STEPS) and a packed shard
    # through both loaders (the native one where its library builds:
    # native/faceshard links libjpeg), side by side with the one-step
    # route comparison: they time nothing
    from tf_face_toolbox_tpu_torch.data import native

    t1 = time.time()
    main = start_train_cli(
        ["--network", "resnet_v1_50", "--stem", "face", "--data",
         "synthetic", "--num_classes", "10572", "--global_batch", "256",
         "--bf16", "--pallas_input", "--num_steps", str(TRAIN_STEPS),
         "--log_every", str(TRAIN_STEPS // 3)])
    shard = os.path.join(work, "train.faceshard")
    faces = torch.randint(0, 256, (512, 120, 120, 3), generator=g,
                          device="cuda", dtype=torch.uint8).cpu().numpy()
    pack_arrays(shard, faces, [i % 64 for i in range(512)])
    loaders = ["python"]
    try:
        native._load_library()
        loaders.append("native")
    except OSError as e:
        say(f"  --loader native not run: the native loader does not build "
            f"on this machine ({e}); the CPU tests run it")
    packed = [start_train_cli(
        ["--network", "resnet_v1_50", "--stem", "face", "--data", shard,
         "--loader", loader, "--global_batch", "128", "--bf16",
         "--pallas_input", "--num_steps", "3", "--log_every", "1"])
        for loader in loaders]

    # one full-width step, kernel route vs the plain augment chain
    cfg = bt.config4()
    images = torch.randint(0, 256, (256, 120, 120, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, cfg.num_classes, (256,), generator=g,
                           device="cuda")
    try:
        routes = bt.step_routes(cfg, images, labels)
    except BaseException:
        kill_train_clis([main, *packed])
        raise
    del images, labels
    torch.cuda.empty_cache()
    packed = [finish_train_cli(s, 600) for s in packed]
    step, logged, launches = finish_train_cli(main, timeout=900)
    say(f"  one step, kernel vs plain route: loss {routes['loss']['kernel']:.5f}"
        f" / {routes['loss']['plain']:.5f} (rel {routes['loss_rel']:.2e}), "
        f"update cosine min {routes['min_cos']:.6f} ({routes['worst_leaf']})"
        f" over {routes['compared_leaves']} leaves, "
        f"{routes['unmoved_leaves']} unmoved in both (the plain route run "
        f"twice: cosine min {routes['repeat_min_cos']:.6f}; cuDNN "
        f"deterministic); launches {routes['launches']}")
    expect(routes["loss_rel"] <= 0.01, f"routes' losses {routes['loss']}")
    expect(routes["min_cos"] >= 0.999,
           f"update cosine {routes['min_cos']} < 0.999 at "
           f"{routes['worst_leaf']}")
    expect(routes["launches"] == {"kernel": 1, "plain": 0, "plain_again": 0},
           f"route launches {routes['launches']}")
    losses = logged["loss"]
    say(f"  cli.train config 4, {TRAIN_STEPS} steps: done step={step}, losses "
        f"{[round(v, 4) for v in losses]}, preprocess launches {launches}")
    expect(step == TRAIN_STEPS, f"cli.train stopped at step {step}")
    expect(len(losses) == 3 and all(np.isfinite(losses)),
           f"cli.train logged losses {losses}")
    expect(launches == TRAIN_STEPS,
           f"kernel 1 launched {launches} times in {TRAIN_STEPS} steps")
    for loader, (step_s, logged_s, launches_s) in zip(loaders, packed):
        losses_s = logged_s["loss"]
        say(f"  cli.train packed shard (512 faces, 64 ids), --loader "
            f"{loader}, batch 128: done step={step_s}, losses "
            f"{[round(v, 4) for v in losses_s]}, launches {launches_s}")
        expect(step_s == 3 and launches_s == 3 and len(losses_s) == 3
               and all(np.isfinite(losses_s)), f"--loader {loader} run")
    say(f"  the cli.train runs and the route comparison side by side: "
        f"{time.time() - t1:.1f} s")

    # training faces/sec/GPU, the card to itself
    torch.cuda.empty_cache()
    t = bt.time_training(cfg, steps=10, warmup=3, profile_steps=2)
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        t["device_ms_by_kind"].items(), key=lambda kv: -kv[1]))
    say(f"  training faces/sec/GPU (config 4, batch 256, bf16, kernel 1, "
        f"device prefetch): {t['faces_per_sec']:.1f} ({t['ms_per_step']:.2f}"
        f" ms/step, CUDA events over 10 steps after 3; first step "
        f"{t['first_step_s']:.1f} s); peak memory {t['peak_memory_gb']:.2f} "
        f"GB; profiled {t['profiled_wall_ms_per_step']:.2f} ms/step wall, "
        f"{t['device_ms_per_step']:.2f} device, idle "
        f"{t['idle_share']:.1%}; {t['step_tflop']:.2f} TFLOP a step, "
        f"{t['peak_share']:.1%} of 989 TFLOP/s bf16; device ms by kind: "
        f"{kinds}; {bench.gpu_info()}")
    say("  top kernels (ms/step): " + "; ".join(
        f"{ms:.2f} {name[:60]}" for ms, name in t["top_kernels_ms"]))
    expect(np.isfinite(t["loss"]), f"timed run's loss {t['loss']}")
    torch.cuda.empty_cache()

    say(f"  phase 11: {time.time() - t0:.1f} s")
    return {"max_abs_err": err32, "ms": k_mean, "plain_ms": p_ms,
            "library_route_ms": r_ms, "library_route_max_abs": route_err,
            "bound_ms": b_ms, "bound_by": b_by, "launches": launches,
            "routes": routes, "time": t}

def _snapshot(state) -> dict:
    """Host copies of every tensor of a train state, momentum buffers
    included, and its counters."""
    opt = state.opt_state["optimizer"]
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"batch_stats/{k}": v for k, v in state.batch_stats.items()})
    out["classifier"] = state.classifier
    for k, v in (state.ema_params or {}).items():
        out[f"ema/{k}"] = v
    from tf_face_toolbox_tpu_torch.train.state import head_leaves

    out.update({f"head/{k}": v
                for k, v in head_leaves(state.head_state).items()})
    for name, p in {**state.params, "classifier": state.classifier}.items():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum/{name}"] = buf
    out = {k: v.detach().cpu().clone() for k, v in out.items()}
    out["counters"] = torch.tensor([state.step, state.opt_state["count"],
                                    state.rng])
    return out


def _max_diff(a: dict, b: dict) -> tuple[float, str]:
    expect(a.keys() == b.keys(), "snapshots hold different tensors")
    worst, name = 0.0, ""
    for k in a:
        d = (a[k].double() - b[k].double()).abs().max().item()
        if d > worst:
            worst, name = d, k
    return worst, name


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def phase_checkpoint(g, work: str) -> dict:
    """Phase 12: BASELINE config 4 through train -> preempt -> resume ->
    serve, on a packed shard; exact resume in-process; the checkpoint
    served through kernel 2 and held against the folded and module
    paths; kernel 2 at each of the face stem's four stages on the
    trained weights. Phase 13's untimed runs go beside the preemption
    flow: ``out["data_parallel_runs"]``."""
    import re
    import shutil
    import signal
    import threading

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard, make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply
    from tf_face_toolbox_tpu_torch.serving.engine import (
        _plan_stage_fusion, _to, build_plan)
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.loop import train_loop
    from tf_face_toolbox_tpu_torch.train.trainer import create_train_state

    torch.cuda.empty_cache()
    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[12 checkpoints] {gpu}")
    run = os.path.join(work, "ckpt_run")
    for d in (run, os.path.join(work, "ckpt_exact"),
              os.path.join(work, "ckpt_timed")):
        shutil.rmtree(d, ignore_errors=True)
    # seeded synthetic u8 faces at 120x120: 1,024 to train on (4 steps an
    # epoch at batch 256, so the resume lands mid-epoch), 512 to serve
    train_shard = os.path.join(work, "ckpt_train.faceshard")
    eval_shard = os.path.join(work, "ckpt_eval.faceshard")
    pairs = os.path.join(work, "ckpt_pairs.txt")
    faces = torch.randint(0, 256, (1536, 120, 120, 3), generator=g,
                          device="cuda", dtype=torch.uint8).cpu().numpy()
    pack_arrays(train_shard, faces[:1024], [i % 1000 for i in range(1024)])
    pack_arrays(eval_shard, faces[1024:], list(range(512)))
    with open(pairs, "w") as f:     # 200 pairs: 10 folds of 20
        for i in range(200):
            f.write(f"{i} {(i + 256) if i % 2 else i + 1} {1 - i % 2}\n")

    # ---- the preemption flow: cli.train, SIGTERM past step 10, resume;
    # phase 13's untimed runs go beside it
    dp_runs = _start_data_parallel_runs(work)
    cmd = [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.train",
           "--device", "cuda", "--network", "resnet_v1_50", "--stem", "face",
           "--data", train_shard, "--loader", "python", "--num_classes",
           "10572", "--global_batch", "256", "--bf16", "--pallas_input",
           "--train_dir", run, "--save_every", "10", "--log_every", "1",
           "--eval_data", eval_shard, "--eval_pairs", pairs,
           "--eval_every", "5", "--keep_best", "lfw_accuracy"]
    t1 = time.time()
    proc = subprocess.Popen([*cmd, "--num_steps", "1000"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: list = []
    past_10 = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            m = re.match(r"step (\d+): loss=", line)
            if m and int(m.group(1)) > 10:
                past_10.set()

    reading = threading.Thread(target=reader, daemon=True)
    reading.start()
    try:
        deadline = time.time() + 400
        while not past_10.wait(1) and proc.poll() is None \
                and time.time() < deadline:
            pass
        ok = past_10.is_set()
        if ok:
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reading.join(timeout=30)
    expect(ok, f"no logged step past 10: {lines[-10:]}")
    expect(rc == 0, f"preempted cli.train exited {rc}: {lines[-10:]}")
    flushed = [ln for ln in lines
               if ln.startswith("preempted: checkpoint flushed at step=")]
    expect(len(flushed) == 1, f"no flush line: {lines[-10:]}")
    k = int(re.search(r"step=(\d+)", flushed[0]).group(1))
    launches_1 = next(int(ln.split("preprocess=")[1]) for ln in lines
                      if ln.startswith("kernel launches:"))
    steps_1 = [int(m.group(1)) for m in (re.match(r"step (\d+): loss=", ln)
                                         for ln in lines) if m]
    evals_1 = [ln for ln in lines if "eval/lfw_accuracy=" in ln]
    run1_s = time.time() - t1
    mgr = CheckpointManager(run)
    say(f"  cli.train config 4 (packed shard, python loader, --pallas_input, "
        f"--save_every 10, --eval_every 5): SIGTERM after logged step "
        f"{steps_1[-1]}; exit {rc}, "
        f"'{flushed[0]}', checkpoints {mgr.all_steps()}, preprocess "
        f"launches {launches_1} in {k} steps, {len(evals_1)} evals; "
        f"{run1_s:.1f} s")
    expect(k > 10 and mgr.all_steps() == [10, k],
           f"flushed at {k}, checkpoints {mgr.all_steps()}")
    expect(launches_1 == k, f"kernel 1 launched {launches_1} in {k} steps")
    expect(len(evals_1) == k // 5, f"evals in run 1: {evals_1}")

    t1 = time.time()
    proc = subprocess.run([*cmd, "--num_steps", "20"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    expect(proc.returncode == 0, f"resumed cli.train failed:\n"
                                 f"{proc.stderr[-3000:]}")
    out = proc.stdout.strip().splitlines()
    steps_2 = [int(m) for m in re.findall(r"^step (\d+): loss=",
                                          proc.stderr, re.M)]
    launches_2 = next(int(ln.split("preprocess=")[1]) for ln in out
                      if ln.startswith("kernel launches:"))
    losses_2 = [float(v) for v in re.findall(r"^step \d+: loss=(\S+)",
                                             proc.stderr, re.M)]
    evals_2 = re.findall(r"^step (\d+): eval/lfw_accuracy=(\S+)",
                         proc.stderr, re.M)
    best = mgr.best_info()
    resumed_line = next((ln for ln in proc.stderr.splitlines()
                         if ln.startswith("resumed from")), None)
    say(f"  resumed: '{resumed_line}', first logged step {steps_2[:1]}, "
        f"{out[-1]}, preprocess launches {launches_2} in {20 - k} steps, evals at {evals_2}, best "
        f"{best}; checkpoints {mgr.all_steps()}; {time.time() - t1:.1f} s")
    expect(f"resumed from step {k}" in proc.stderr, "no resume line")
    expect(steps_2[:1] == [k + 1] and steps_2[-1] == 20,
           f"resumed run logged steps {steps_2}")
    expect(out[-1].startswith("done: step=20"), f"resumed run: {out[-1]}")
    expect(launches_2 == 20 - k, f"kernel 1 launched {launches_2} times in "
                                 f"{20 - k} steps")
    expect(all(np.isfinite(losses_2)), f"losses {losses_2}")
    expect([int(s) for s, _ in evals_2] == [s for s in range(k + 1, 21)
                                            if s % 5 == 0],
           f"evals {evals_2}")
    expect(best is not None and best["name"] == "lfw_accuracy"
           and os.path.isdir(os.path.join(run, "best", str(best["step"])))
           and os.path.exists(os.path.join(run, "best_step.json")),
           f"best checkpoint {best}")
    expect(mgr.all_steps()[-1] == 20, f"checkpoints {mgr.all_steps()}")
    t_dp = time.time()
    dp_runs = _finish_data_parallel_runs(dp_runs)
    say(f"  phase 13's cli.train under torchrun and two gloo ranks, beside "
        f"the preemption flow: their wait {time.time() - t_dp:.1f} s")

    # serve the checkpoint: cli.extract --engine fused, beside the exact
    # resume below (neither times the other's work)
    out_fused = os.path.join(work, "ckpt_emb_fused.npy")
    t_extract = time.time()
    extract = _cli("extract", "--checkpoint_dir", run, "--engine", "fused",
                   "--data", eval_shard, "--output", out_fused, "--batch",
                   "256", "--device", "cuda")

    # ---- exact resume in-process, deterministic cuDNN: 6 straight steps
    # (twice: the noise floor) vs 3, a save, a restore into a fresh
    # state, 3 more
    cfg = bt.config4()
    batches = [{"image": torch.randint(0, 256, (256, 120, 120, 3),
                                       generator=g, device="cuda",
                                       dtype=torch.uint8),
                "label": torch.randint(0, cfg.num_classes, (256,),
                                       generator=g, device="cuda")}
               for _ in range(6)]
    exact_dir = os.path.join(work, "ckpt_exact")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        snaps = []
        for _ in range(2):
            st = train_loop(cfg, iter(batches), num_steps=6, log_every=0,
                            device="cuda").state
            snaps.append(_snapshot(st))
            del st
            torch.cuda.empty_cache()
        train_loop(cfg, iter(batches[:3]), num_steps=3, log_every=0,
                   train_dir=exact_dir, save_every=3, device="cuda")
        torch.cuda.empty_cache()
        st = train_loop(cfg, iter(batches[3:]), num_steps=6, log_every=0,
                        train_dir=exact_dir, save_every=3,
                        device="cuda").state
        resumed = _snapshot(st)
        # one checkpoint's save and restore, timed apart
        timed = CheckpointManager(os.path.join(work, "ckpt_timed"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        timed.maybe_save(st, force=True)
        save_s = time.perf_counter() - t1
        del st
        torch.cuda.empty_cache()
        fresh, _ = create_train_state(cfg, 1, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        timed.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        restored_ok = _max_diff(_snapshot(fresh), resumed)[0] == 0.0
        del fresh
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del batches
    torch.cuda.empty_cache()
    floor, floor_at = _max_diff(snaps[0], snaps[1])
    diff, diff_at = _max_diff(resumed, snaps[0])
    nbytes = _dir_bytes(os.path.join(timed.directory, "6"))
    n_mom = sum(k.startswith("momentum/") for k in resumed)
    say(f"  exact resume (config 4, cuDNN deterministic, {len(resumed) - 1} "
        f"tensors incl. {n_mom} momentum buffers; counters step/count/rng "
        f"{resumed['counters'].tolist()}): 6 straight vs 3 + save + restore "
        f"+ 3: max |diff| {diff:.3g}{f' at {diff_at}' if diff else ''}; "
        f"straight run twice: {floor:.3g}{f' at {floor_at}' if floor else ''}")
    say(f"  one checkpoint (step 6): {nbytes / 1e6:.1f} MB on disk, save "
        f"{save_s:.3f} s, restore onto the card {restore_s:.3f} s "
        f"(bit-equal: {restored_ok}); {gpu}")
    expect(diff <= floor, f"resume differs by {diff} at {diff_at}, beyond "
                          f"the straight run's own {floor}")
    expect(restored_ok, "timed restore is not bit-equal")

    # ---- the served checkpoint: cli.extract --engine fused, eval_lfw
    ext_launches = next(int(ln.split("fused_block=")[1])
                        for ln in _cli_done(extract)
                        if ln.startswith("kernel launches:"))
    emb = np.load(out_fused)
    extract_s = time.time() - t_extract
    expect(emb.shape == (512, 512) and np.isfinite(emb).all(),
           f"cli.extract wrote {emb.shape}")
    expect(np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-4,
           "checkpoint embeddings not unit norm")
    # 2 forwards of 512 images (256 faces and their flips), 12 fused
    # launches each: 2 + 3 + 5 + 2 identity blocks at 56, 28, 14, 7
    expect(ext_launches == 24, f"kernel 2 launched {ext_launches} times, "
                               "want 24")
    eval_lfw = _cli("eval_lfw", "--embeddings", out_fused, "--pairs", pairs)

    # parity (beside eval_lfw): the same checkpoint through the folded
    # engine and the f32 module path, in-process, from the CLI's loader
    net, flat = load_variables(run, "resnet_v1_50", 512, 112,
                               torch.bfloat16)
    source = FaceShardSource(eval_shard)
    folded = extract_shard(net, flat, source, image_size=112, batch=256,
                           loader="python",
                           extract_fn=make_extract_fn(make_serving_apply(
                               net, flat, device="cuda")), device="cuda")
    net32 = load_jax_variables(create_network("resnet_v1_50", stem="face"),
                               flat).to("cuda").eval()
    module = extract_shard(net32, flat, source, image_size=112, batch=256,
                           loader="python", extract_fn=make_extract_fn(net32),
                           device="cuda")
    del net32
    report = json.loads("\n".join(_cli_done(eval_lfw, 300)))
    expect(len(report["fold_accuracies"]) == 10, "eval_lfw report")
    cos_folded = (emb * folded).sum(1)
    cos_module = (emb * module).sum(1)
    mean = module.mean(0, keepdims=True)
    c = emb - mean
    m = module - mean
    centered = (c * m).sum(1) / (np.linalg.norm(c, axis=1)
                                 * np.linalg.norm(m, axis=1))
    say(f"  cli.extract --checkpoint_dir (step 20) --engine fused: "
        f"{emb.shape} unit-norm, kernel 2 launches {ext_launches}; "
        f"{extract_s:.1f} s (beside the exact resume); eval_lfw accuracy "
        f"{report['accuracy_mean']:.4f} "
        f"(20 steps on random faces: means nothing); per-face cosine vs "
        f"folded min {cos_folded.min():.6f}, vs f32 module min "
        f"{cos_module.min():.6f} (batch-centered {centered.min():.4f})")
    expect(cos_folded.min() >= 0.999, "fused vs folded cosine < 0.999")
    expect(cos_module.min() >= 0.999, "fused vs module cosine < 0.999")
    # every face shares a large component, so the plain cosine is
    # lenient; the centered one still catches a wrong stage (bf16
    # rounding alone leaves it near 0.999 here)
    expect(centered.min() >= 0.99, "fused vs module batch-centered "
                                   "cosine < 0.99")

    # kernel 2 alone at every stage of the face stem (56x56x256,
    # 28x28x512, 14x14x1024, 7x7x2048): each trained stride-1 stack on
    # the activations the main path gives it (256 faces and their flips
    # after the stem, the previous stages and the stage's strided block)
    plan = build_plan(net, flat)
    stem = plan.stem.to("cuda")
    u8 = torch.from_numpy(faces[1024:1280]).to("cuda")
    with torch.inference_mode():
        pix = preprocess_eval(u8, 112, 112).to(torch.bfloat16)
        x = stem(torch.cat([pix, pix.flip(2)]))
    del u8, pix, stem
    stats: list = []
    for blocks in plan.stages:
        blocks = [blk.to("cuda") for blk in blocks]
        n_folded, entry, tail = _plan_stage_fusion(blocks)
        expect(tail is not None, "a face-stem stage with no fused stack")
        with torch.inference_mode():
            for blk in blocks[:n_folded]:
                x = blk.apply_folded(x)
        x = x.clone()
        h, w, c = x.shape[1:]
        x = check_block_stack(f"checkpoint face {h}x{w}", x,
                              _to(entry, "cuda"), _to(tail, "cuda"),
                              tuple(blocks[n_folded:]), stats)
        s = stats[-1]
        say(f"  kernel 2 at {h}x{w}x{c}, {x.shape[0]} images, "
            f"{tail['w1s'].shape[0]} trained blocks: {s['ms']:.3f} ms eager "
            f"(graph {s['graph_ms']:.3f}), plain {s['plain_ms']:.3f}, "
            f"library route {s['library_route_ms']:.3f} (graph "
            f"{s['library_route_graph_ms']:.3f}), bound {s['bound_ms']:.3f} "
            f"ms ({s['bound_by']}), {s['bound_ms'] / s['graph_ms']:.1%} of "
            f"it (graph); {gpu}")
        del blocks, entry, tail
    expect([s["stage"] for s in stats] == [
        f"checkpoint face {n}x{n}" for n in (56, 28, 14, 7)],
        f"face-stem stages {[s['stage'] for s in stats]}")
    del x, net, plan
    torch.cuda.empty_cache()
    total = time.time() - t0
    say(f"  phase 12: {total:.1f} s; {gpu}")
    return {"k": k, "launches": [launches_1, launches_2],
            "extract_launches": ext_launches, "resume_max_diff": diff,
            "noise_floor": floor, "save_s": save_s, "restore_s": restore_s,
            "bytes": nbytes, "face_stages": stats, "seconds": total,
            "data_parallel_runs": dp_runs}


def _dp_batches(cfg, steps: int) -> list:
    """Phase 13(b)'s global batches: uint8 faces and labels from a seed."""
    rng = np.random.default_rng(13)
    return [(rng.integers(0, 256, (cfg.global_batch, cfg.crop_from,
                                   cfg.crop_from, 3), np.uint8),
             rng.integers(0, cfg.num_classes, cfg.global_batch))
            for _ in range(steps)]


def _dp_rank(rank: int, world: int, port: int, cfg_kw: dict, steps: int,
             out_path: str) -> None:
    """Phase 13(b): one rank of a gloo group on cuda:0 (a spawned
    process): ``steps`` data-parallel steps, then its state, losses and
    kernel 1 launches to ``out_path``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)
    from tf_face_toolbox_tpu_torch.parallel.mesh import init_distributed
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    topo = init_distributed("cuda:0", backend="gloo")
    try:
        cfg = TrainConfig(**cfg_kw)
        state, net = create_train_state(cfg, 0, mesh=topo,
                                        device=topo.device)
        step = make_train_step(net, cfg, state, mesh=topo)
        fused_preprocess.launches = 0
        losses, seconds = [], []
        for x, y in _dp_batches(cfg, steps):
            t0 = time.perf_counter()
            state, m = step(state, x, y)
            losses.append(float(m["loss"]))     # waits for the step
            seconds.append(time.perf_counter() - t0)
        torch.save({"state": _snapshot(state), "losses": losses,
                    "seconds": seconds,
                    "launches": fused_preprocess.launches}, out_path)
    finally:
        dist.destroy_process_group()


def _start_torchrun(args: list) -> tuple:
    """``python -m torch.distributed.run`` (torchrun) of one rank on this
    card, in the background (``_torchrun`` waits for it)."""
    return args, spawn([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", "1", "-m", *args])


def _torchrun(started: tuple, timeout: int) -> subprocess.CompletedProcess:
    """A ``_start_torchrun`` run to its end; fails the smoke unless it
    exits 0."""
    args, spawned = started
    proc = collect(spawned, timeout)
    expect(proc.returncode == 0, f"torchrun {' '.join(args[:3])} failed:\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
    return proc


def _start_data_parallel_runs(work: str) -> tuple:
    """Phase 13's untimed runs, started in phase 12 beside its preemption
    flow: config 5's cli.train under torchrun (one NCCL rank, PRESET_STEPS)
    and two ``_dp_rank`` processes on cuda:0 over gloo; and (a)'s timed
    bench_train under torchrun, which starts up beside them and then
    waits (``--start_after``) until phase 13 lets it time."""
    import atexit
    import multiprocessing as mp
    import socket

    from tf_face_toolbox_tpu_torch import bench_train as bt

    go = os.path.join(work, "bench13.go")
    for path in (go, go + ".ready"):
        if os.path.exists(path):
            os.remove(path)
    bench = _start_torchrun(
        ["tf_face_toolbox_tpu_torch.bench_train", "--preset",
         "v5e8_data_parallel", "--steps", "10", "--warmup", "3",
         "--start_after", go])

    def stop_bench() -> None:
        # SIGTERM: torchrun passes it on to its worker
        if bench[1][0].poll() is None:
            bench[1][0].terminate()

    atexit.register(stop_bench)
    dp_cli = _start_torchrun(
        ["tf_face_toolbox_tpu_torch.cli.train", "--preset",
         "v5e8_data_parallel", "--multihost", "--pallas_input", "--data",
         "synthetic", "--num_steps", str(PRESET_STEPS), "--log_every",
         str(PRESET_STEPS // 2)])
    cfg_kw = dict(bt.CONFIG4, global_batch=64)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    paths = [os.path.join(work, f"dp_rank{r}.pt") for r in range(2)]
    procs = [ctx.Process(target=_dp_rank, args=(r, 2, port, cfg_kw,
                                                GRID_STEPS, paths[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    return dp_cli, procs, paths, cfg_kw, (bench, go)


def _finish_data_parallel_runs(started: tuple) -> dict:
    """The untimed runs at their end, and the timed bench up and waiting
    (it touches the card no more until phase 13 lets it go)."""
    dp_cli, procs, paths, cfg_kw, (bench, go) = started
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    expect([p.exitcode for p in procs] == [0, 0],
           f"gloo ranks exited {[p.exitcode for p in procs]}")
    deadline = time.time() + 300
    while (not os.path.exists(go + ".ready") and bench[1][0].poll() is None
           and time.time() < deadline):
        time.sleep(0.1)
    if not os.path.exists(go + ".ready"):
        _torchrun(bench, timeout=1)     # fails with its output
        expect(False, "bench_train --start_after never came up")
    return {"ranks": [torch.load(path, weights_only=True) for path in paths],
            "cfg_kw": cfg_kw, "cli": _torchrun(dp_cli, timeout=600),
            "bench": (bench, go)}


def phase_data_parallel(work: str, single_faces_per_sec: float,
                        runs: dict) -> dict:
    """Phase 13: data-parallel training (BASELINE config 5). ``runs``: its
    cli.train under torchrun and its two gloo ranks, run in phase 12."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.parallel.reference import (
        replica_loop_step)
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state)

    t0 = time.time()
    say(f"[13 data parallel] {bench.gpu_info()}")
    # (a) config 5 on the production path: torchrun, NCCL, one replica;
    # bench_train timed alone (it started up in phase 12 and has waited
    # since; cli.train ran beside (b) there)
    t1 = time.time()
    timed, go = runs["bench"]
    with open(go, "w"):
        pass
    proc = _torchrun(timed, timeout=600)
    timing = json.loads(proc.stdout.strip().splitlines()[-1])
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        timing["device_ms_by_kind"].items(), key=lambda kv: -kv[1]))
    ratio = timing["faces_per_sec_per_gpu"] / single_faces_per_sec
    say(f"  (a) bench_train --preset v5e8_data_parallel under torchrun "
        f"(NCCL, 1 rank): {timing['faces_per_sec_per_gpu']:.1f} faces/s a "
        f"GPU, {timing['faces_per_sec']:.1f} in all, "
        f"{timing['ms_per_step']:.2f} ms/step; {ratio:.4f} x phase 11's "
        f"one-process {single_faces_per_sec:.1f}; peak memory "
        f"{timing['peak_memory_gb']:.2f} GB; profiled "
        f"{timing['profiled_wall_ms_per_step']:.2f} ms/step wall, "
        f"{timing['device_ms_per_step']:.2f} device, idle "
        f"{timing['idle_share']:.1%}; device ms by kind: {kinds}; one NCCL "
        f"all-reduce of the step's {timing['exchange']['values']:,} "
        f"gradient values ({timing['exchange']['bytes'] / 1e6:.1f} MB) "
        f"{timing['exchange']['ms']:.3f} ms at 1 rank (timed apart: the "
        f"trainer skips it at 1 rank); {time.time() - t1:.1f} s")
    expect(np.isfinite(timing["loss"]), f"timed run's loss {timing['loss']}")
    t1 = time.time()

    # (b) two ranks on cuda:0 over gloo (run in phase 12) against
    # replica_loop_step
    cfg = TrainConfig(**runs["cfg_kw"])
    ranks = runs["ranks"]
    diff, where = _max_diff(ranks[0]["state"], ranks[1]["state"])
    expect(diff == 0, f"the two ranks' states differ by {diff} at {where}")
    expect([r["launches"] for r in ranks] == [GRID_STEPS] * 2,
           f"kernel 1 launches on the ranks {[r['launches'] for r in ranks]}")

    state, net = create_train_state(cfg, 0, device="cuda")
    before = _snapshot(state)
    ref_losses = []
    for x, y in _dp_batches(cfg, GRID_STEPS):
        state, m = replica_loop_step(net, cfg, state, x, y, 2)
        ref_losses.append(float(m["loss"]))
    ref = _snapshot(state)
    del state, net
    torch.cuda.empty_cache()
    got = ranks[0]["state"]
    cos, stats_ulps, unmoved = {}, 0.0, 0
    for k, want in ref.items():
        if k.startswith(("params/", "classifier")) and not k.endswith(
                bt.NOISE_ONLY):
            a = (got[k] - before[k]).double().ravel()
            b = (want - before[k]).double().ravel()
            if not a.any() and not b.any():
                unmoved += 1
                continue
            cos[k] = float(a @ b / (a.norm() * b.norm()))
        elif k.startswith("batch_stats/"):
            # the bf16 step at each value, or at 1% of the tensor's
            # largest where the value is smaller
            scale = torch.clamp_min(want.abs(), 0.01 * want.abs().max())
            ulps = ((got[k] - want).abs() / bf16_ulp(scale)).max().item()
            stats_ulps = max(stats_ulps, ulps)
    worst = min(cos, key=cos.get)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["losses"], ref_losses))
    say(f"  (b) 2 gloo ranks on cuda:0, r50 face stem, 32 rows a rank, "
        f"{GRID_STEPS} bf16 steps: ranks' states max |diff| {diff} over {len(got)} "
        f"tensors; losses {[round(v, 4) for v in ranks[0]['losses']]} vs "
        f"replica_loop_step {[round(v, 4) for v in ref_losses]} (rel "
        f"{loss_rel:.2e}); update cosine min {cos[worst]:.6f} ({worst}) "
        f"over {len(cos)} leaves, {unmoved} unmoved in both; BN running "
        f"statistics within {stats_ulps:.2f} bf16 steps; kernel 1 launches "
        f"{[r['launches'] for r in ranks]}; rank 0's steps (host clock, "
        f"the gloo exchange staged through the host included) "
        f"{[round(v, 3) for v in ranks[0]['seconds']]} s (run in phase "
        f"12); {time.time() - t1:.1f} s")
    expect(cos[worst] >= 0.999, f"update cosine {cos[worst]} at {worst}")
    expect(stats_ulps <= 2.0, f"BN running statistics {stats_ulps} bf16 "
                              "steps from replica_loop_step's")
    expect(loss_rel <= 0.01, f"losses {ranks[0]['losses']} vs {ref_losses}")

    proc = runs["cli"]
    out = proc.stdout.strip().splitlines()
    expect(out and out[-1].startswith(f"done: step={PRESET_STEPS}"),
           f"torchrun cli.train printed {out[-3:]}")
    launches = next(int(line.split("preprocess=")[1]) for line in out
                    if line.startswith("kernel launches:"))
    losses = [float(line.split("loss=")[1].split()[0])
              for line in proc.stderr.splitlines()
              if line.startswith("step ") and "loss=" in line]
    say(f"  (a) torchrun cli.train --preset v5e8_data_parallel --multihost "
        f"--pallas_input (NCCL, 1 rank of 256; the preset's 8 x 256 cut to "
        f"the card's 1), beside (b) in phase 12: {out[-1]}, losses "
        f"{[round(v, 4) for v in losses]}, kernel 1 launches {launches} in "
        f"{PRESET_STEPS} steps")
    expect(launches == PRESET_STEPS,
           f"kernel 1 launched {launches} times in {PRESET_STEPS} steps")
    expect(len(losses) == 2 and all(np.isfinite(losses)),
           f"config-5 losses {losses}")
    # (c) remat at a replica's batch (config 4/5: 256)
    t1 = time.time()
    cfg4 = bt.config4()
    g = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randint(0, 256, (256, 120, 120, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, cfg4.num_classes, (256,), generator=g,
                           device="cuda")
    grads = bt.remat_grads(cfg4, images, labels)
    del images, labels
    remat = {}
    for name, value in bt.REMAT.items():
        torch.cuda.empty_cache()
        remat[name] = bt.time_training(cfg4, steps=5, warmup=2,
                                       profile_steps=0, remat=value)
    for name in bt.REMAT:
        r = remat[name]
        cmp = grads.get(str(bt.REMAT[name]))
        say(f"  (c) remat={name}: {r['ms_per_step']:.2f} ms/step "
            f"({r['faces_per_sec']:.1f} faces/s), peak memory "
            f"{r['peak_memory_gb']:.2f} GB" + (
                f"; gradients vs no remat: max |diff| "
                f"{cmp['max_abs_diff']:.3g} (f32), cosine min "
                f"{cmp['min_cos']:.6f}" if cmp else ""))
    for name, cmp in grads.items():
        expect(cmp["min_cos"] >= 0.9999, f"remat={name} gradients' cosine "
                                         f"{cmp['min_cos']}")
    say(f"  (c) {time.time() - t1:.1f} s; phase 13: {time.time() - t0:.1f} s")
    return {"cli_launches": launches, "timing": timing,
            "rank_launches": [r["launches"] for r in ranks],
            "rank_step_s": ranks[0]["seconds"],
            "ranks_max_diff": diff, "min_cos": cos[worst],
            "stats_ulps": stats_ulps, "remat": remat, "remat_grads": grads}


def _pfc_config(rate: float):
    """Phase 14(b)'s config: config 7's preset (its schedule: a 5,000-step
    warmup to 0.4) at 16 rows a rank of four, the head sampled at
    ``rate``, kernel 1 on the augment."""
    import dataclasses

    from tf_face_toolbox_tpu_torch import configs

    return dataclasses.replace(
        configs.get_config("large_id_pfc_v5e8", world=4), global_batch=64,
        pallas_input=True, pfc_sample_rate=rate)


def _grid_rank(rank: int, world: int, port: int, steps: int,
               out_path: str, heads: list) -> None:
    """Phases 14(b) and 15(c): one rank of four on cuda:0 over gloo, on a
    (2, 2) grid (a spawned process): gloo's MAX all-reduce of a CUDA
    tensor, then ``steps`` steps of each (name, config) of ``heads``, each
    from a fresh state; each head's final state, losses and kernel 1
    launches to ``out_path``. The ranks of data index 0 (model indices 0
    and 1) also write their state after each step to
    ``out_path.<name>.<k>`` (rank 1 its shards only): the plain version
    starts each step there."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)
    from tf_face_toolbox_tpu_torch.parallel.mesh import init_distributed
    from tf_face_toolbox_tpu_torch.train.trainer import (
        create_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic cuDNN, as in the plain version: the comparison is of
    # the step's arithmetic, not of cuDNN's atomics
    torch.backends.cudnn.deterministic = True
    topo = init_distributed("cuda:0", model=2, backend="gloo")
    try:
        t = torch.tensor([float(rank), -float(rank)], device=topo.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = {"max": t.tolist()}
        for name, cfg in heads:
            state, net = create_train_state(cfg, 0, mesh=topo,
                                            device=topo.device)
            step = make_train_step(net, cfg, state, mesh=topo)
            fused_preprocess.launches = 0
            losses, seconds = [], []
            for k, (x, y) in enumerate(_dp_batches(cfg, steps)):
                t0 = time.perf_counter()
                state, m = step(state, x, y)
                losses.append(float(m["loss"]))     # waits for the step
                seconds.append(time.perf_counter() - t0)
                if rank < 2:
                    snap = _snapshot(state)
                    if rank == 1:
                        snap = {key: snap[key] for key in _SHARD_KEYS
                                if key in snap}
                    torch.save(snap, f"{out_path}.{name}.{k}")
            out[name] = {"state": _snapshot(state), "losses": losses,
                         "seconds": seconds,
                         "launches": fused_preprocess.launches}
            del state, net, step
            torch.cuda.empty_cache()
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


# a model index's own tensors: the classifier, its momentum, the centers
_SHARD_KEYS = ("classifier", "momentum/classifier", "head/centers")


def _state_at(cfg, saved: list, k: int):
    """A state of the plain version (the global classifier and centers)
    at rank 0's snapshot ``saved[0].<k>`` and rank 1's shards
    ``saved[1].<k>``: (state, net)."""
    from tf_face_toolbox_tpu_torch.parallel.mesh import Topology
    from tf_face_toolbox_tpu_torch.train.trainer import create_train_state

    state, net = create_train_state(cfg, 0, mesh=Topology(data=2, model=2),
                                    whole_classifier=True, device="cuda")
    snap = torch.load(f"{saved[0]}.{k}", weights_only=True)
    shard = torch.load(f"{saved[1]}.{k}", weights_only=True)
    for key in _SHARD_KEYS:
        if key in snap:
            snap[key] = torch.cat([snap[key], shard[key]])
    opt = state.opt_state["optimizer"]
    with torch.no_grad():
        for name, t in (*state.params.items(), *state.batch_stats.items()):
            kind = "params" if name in state.params else "batch_stats"
            t.copy_(snap[f"{kind}/{name}"])
        state.classifier.copy_(snap["classifier"])
    for name, p in {**state.params, "classifier": state.classifier}.items():
        buf = snap.get(f"momentum/{name}")
        if buf is not None:
            opt.state[p] = {"momentum_buffer": buf.to(p.device)}
    for key, value in snap.items():
        if key.startswith("head/"):
            path = key.split("/")[1:]
            tree = state.head_state
            for part in path[:-1]:
                tree = tree[part]
            tree[path[-1]] = value.to("cuda")
    state.step, state.opt_state["count"], state.rng = (
        int(v) for v in snap["counters"])
    return state, net


def _time_preset(preset: str, **overrides) -> dict:
    """What ``bench_train --preset <preset>`` measures (``time_training``
    of the preset at 256 rows, kernel 1 on), in this process as phase
    11's config 4 rate is, at 8 steps after 2, 1 of them profiled, the
    card to itself."""
    import dataclasses

    from tf_face_toolbox_tpu_torch import bench, configs
    from tf_face_toolbox_tpu_torch import bench_train as bt

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get_config(preset), pallas_input=True,
                              global_batch=256, **overrides)
    r = bt.time_training(cfg, steps=8, warmup=2, profile_steps=1)
    torch.cuda.empty_cache()
    r["gpu"] = bench.gpu_info()
    return r


def _say_bench(label: str, r: dict, single_faces_per_sec: float) -> None:
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        r["device_ms_by_kind"].items(), key=lambda kv: -kv[1]))
    say(f"  {label} ({r['head']} head, {r['classifier_columns']:,} "
        f"classifier rows scored a step): {r['faces_per_sec']:.1f} faces/s "
        f"({r['faces_per_sec'] / single_faces_per_sec:.4f} x phase 11's "
        f"config 4 {single_faces_per_sec:.1f}), {r['ms_per_step']:.2f} "
        f"ms/step; peak memory {r['peak_memory_gb']:.2f} GB; profiled "
        f"{r['profiled_wall_ms_per_step']:.2f} ms/step wall, "
        f"{r['device_ms_per_step']:.2f} device, idle {r['idle_share']:.1%}; "
        f"head share {r['head_share']:.2%}; device ms by kind: {kinds}")
    expect(np.isfinite(r["loss"]), f"{label}: loss {r['loss']}")


# steps of the gloo ranks of phases 13(b), 14(b) and 15(c) (3 until the
# smoke outgrew its time)
GRID_STEPS = 2
PRESET_STEPS = 10           # phases 13-15's untimed cli.train runs


def _start_grid(work: str, tag: str, heads: list, steps: int) -> tuple:
    """Four ``_grid_rank`` processes on cuda:0 over gloo, spawned (they
    time nothing); ``_finish_grid`` waits for them."""
    import multiprocessing as mp
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    paths = [os.path.join(work, f"{tag}_rank{r}.pt") for r in range(4)]
    procs = [ctx.Process(target=_grid_rank,
                         args=(r, 4, port, steps, paths[r], heads))
             for r in range(4)]
    for p in procs:
        p.start()
    return procs, paths


def _finish_grid(started: tuple) -> tuple[list, list]:
    """A ``_start_grid``'s ranks at their end: their results by rank, and
    the paths they wrote."""
    procs, paths = started
    try:
        for p in procs:
            p.join(timeout=900)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    expect([p.exitcode for p in procs] == [0] * 4,
           f"gloo ranks exited {[p.exitcode for p in procs]}")
    ranks = [torch.load(path, weights_only=True) for path in paths]
    expect(all(r["max"] == [3.0, 0.0] for r in ranks),
           f"gloo MAX on cuda:0 gave {[r['max'] for r in ranks]}")
    return ranks, paths


def _grid_against_reference(ranks: list, paths: list, name: str, cfg,
                            steps: int) -> dict:
    """The four ranks' runs of head ``name``: the replicated tensors equal
    on all four ranks and each model index's shards on its two data
    ranks (max |diff|), and each step against ``replica_loop_step(
    model=2)`` in this process from the ranks' state before it (the
    first from the same seed): losses, per-leaf update cosine with the
    classifier and centers reassembled, BN running statistics in bf16
    steps, the head's scalars' relative difference."""
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.parallel.mesh import Topology
    from tf_face_toolbox_tpu_torch.parallel.reference import (
        replica_loop_step)
    from tf_face_toolbox_tpu_torch.train.trainer import create_train_state

    states = [r[name]["state"] for r in ranks]
    rep = [{k: v for k, v in s.items() if k not in _SHARD_KEYS}
           for s in states]
    diff, where = max(_max_diff(rep[0], rep[r]) for r in range(1, 4))
    own = [{k: states[r][k] for k in _SHARD_KEYS if k in states[r]}
           for r in range(4)]
    shard_diff = max(_max_diff(own[r], own[r + 2]) for r in range(2))[0]
    expect(diff == 0 and shard_diff == 0,
           f"{name}: the ranks differ by {diff} at {where}, the shards by "
           f"{shard_diff}")
    # bf16 weights that four ranks' f32 sums leave an ulp apart would
    # otherwise move later steps
    saved = [f"{p}.{name}" for p in paths[:2]]
    cos, unmoved, ref_losses = {}, set(), []
    stats_ulps = loss_rel = head_rel = 0.0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for k, (x, y) in enumerate(_dp_batches(cfg, steps)):
            if k == 0:
                state, net = create_train_state(
                    cfg, 0, mesh=Topology(data=2, model=2),
                    whole_classifier=True, device="cuda")
            else:
                state, net = _state_at(cfg, saved, k - 1)
            before = _snapshot(state)
            state, m = replica_loop_step(net, cfg, state, x, y, 4, model=2)
            ref_losses.append(float(m["loss"]))
            ref = _snapshot(state)
            del state, net
            got = torch.load(f"{saved[0]}.{k}", weights_only=True)
            shard = torch.load(f"{saved[1]}.{k}", weights_only=True)
            for key in _SHARD_KEYS:
                if key in got:
                    got[key] = torch.cat([got[key], shard[key]])
            for key, want in ref.items():
                if key.startswith(("params/", "classifier", "head/centers")) \
                        and not key.endswith(bt.NOISE_ONLY):
                    a = (got[key] - before[key]).double().ravel()
                    b = (want - before[key]).double().ravel()
                    if not a.any() and not b.any():
                        unmoved.add(key)
                        continue
                    c = float(a @ b / (a.norm() * b.norm()))
                    cos[key] = min(cos.get(key, 1.0), c)
                elif key.startswith("head/"):
                    head_rel = max(head_rel, ((got[key] - want).abs()
                                              / want.abs()).max().item())
                elif key.startswith("batch_stats/"):
                    scale = torch.clamp_min(want.abs(),
                                            0.01 * want.abs().max())
                    ulps = ((got[key] - want).abs()
                            / bf16_ulp(scale)).max().item()
                    stats_ulps = max(stats_ulps, ulps)
            loss_rel = max(loss_rel, abs(ranks[0][name]["losses"][k]
                                         - ref_losses[-1])
                           / abs(ref_losses[-1]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    unmoved -= cos.keys()
    worst = min(cos, key=cos.get)
    launches = [r[name]["launches"] for r in ranks]
    expect(launches == [steps] * 4, f"{name}: kernel 1 launches {launches}")
    expect(cos[worst] >= 0.999, f"{name}: update cosine {cos[worst]} at "
                                f"{worst}")
    expect(stats_ulps <= 2.0, f"{name}: BN running statistics {stats_ulps} "
                              "bf16 steps off")
    expect(loss_rel <= 0.01, f"{name}: losses {ranks[0][name]['losses']} vs "
                             f"{ref_losses}")
    expect(head_rel <= 1e-3, f"{name}: head state {head_rel} apart")
    return {"min_cos": cos[worst], "worst_leaf": worst,
            "compared_leaves": len(cos), "unmoved_leaves": len(unmoved),
            "stats_ulps": stats_ulps, "loss_rel": loss_rel,
            "head_rel": head_rel, "launches": launches,
            "ranks_max_diff": diff, "shards_max_diff": shard_diff,
            "losses": ranks[0][name]["losses"], "ref_losses": ref_losses,
            "seconds": ranks[0][name]["seconds"]}


def phase_partial_fc(work: str, single_faces_per_sec: float) -> dict:
    """Phase 14: the class-sharded Partial-FC head (BASELINE config 7).
    Phase 15's untimed runs (its cli.train, and its two heads on (b)'s
    four gloo ranks) go beside (b) and end with it:
    ``out["loss_heads_runs"]``."""
    from tf_face_toolbox_tpu_torch import bench

    t0 = time.time()
    say(f"[14 partial fc] {bench.gpu_info()}")
    # (a) config 7 at the card's one rank: 93,431 classes, sampled at 0.1;
    # timed alone, then cli.train beside (b)
    timing = {}
    for head, extra in (("sampled", {}), ("exact", {"pfc_sample_rate": 1.0})):
        t1 = time.time()
        timing[head] = _time_preset("large_id_pfc_v5e8", **extra)
        _say_bench(f"(a) time_training large_id_pfc_v5e8 "
                   f"{'pfc_sample_rate=1 ' if extra else ''}",
                   timing[head], single_faces_per_sec)
        say(f"      {time.time() - t1:.1f} s")
    ratio = (timing["sampled"]["faces_per_sec"]
             / timing["exact"]["faces_per_sec"])
    say(f"  (a) sampled / exact faces/s: {ratio:.4f}")
    t1 = time.time()
    pfc_cli = start_train_cli(
        ["--preset", "large_id_pfc_v5e8", "--pallas_input", "--data",
         "synthetic", "--num_steps", str(PRESET_STEPS), "--log_every",
         str(PRESET_STEPS // 2)])

    # (b) four ranks on cuda:0 over gloo, data 2 x model 2, beside (a)'s
    # cli.train and phase 15's cli.train; the same four ranks then run
    # phase 15's two heads (one set of processes: each rank's start-up
    # costs more host time than its steps)
    heads = [("exact", _pfc_config(1.0)), ("sampled", _pfc_config(0.1))]
    ada_cli = _start_loss_heads_cli()
    grid = _start_grid(work, "grid", heads + _loss_heads_grid(), GRID_STEPS)
    try:
        ranks, paths = _finish_grid(grid)
    except BaseException:
        kill_train_clis([pfc_cli, ada_cli])
        raise
    step, logged, cli_launches = finish_train_cli(pfc_cli, timeout=600)
    losses = logged["loss"]
    say(f"  (a) cli.train --preset large_id_pfc_v5e8 --pallas_input (1 rank "
        f"of 256, the preset's 2 x 4 mesh cut to the card's 1; 93,431 "
        f"classes, sampled at 0.1, budget 9,344), beside (b): done "
        f"step={step}, losses {[round(v, 4) for v in losses]}, kernel 1 "
        f"launches {cli_launches} in {PRESET_STEPS} steps")
    expect(step == PRESET_STEPS, f"config 7 stopped at step {step}")
    expect(cli_launches == PRESET_STEPS,
           f"kernel 1 launched {cli_launches} times in {PRESET_STEPS} steps")
    expect(len(losses) == 2 and all(np.isfinite(losses)),
           f"config-7 losses {losses}")
    out = {}
    for head, cfg in heads:
        r = out[head] = _grid_against_reference(ranks, paths, head, cfg,
                                                GRID_STEPS)
        say(f"  (b) {head} head{' at 0.1 (budget 4,672)' if head == 'sampled' else ''}"
            f": 4 gloo ranks on cuda:0 (2 x 2), config 7's r50 face stem and "
            f"schedule, 16 rows a rank, 93,431 classes (46,716 a shard), "
            f"{GRID_STEPS} bf16 steps: replicated tensors max |diff| {r['ranks_max_diff']},"
            f" shards across data ranks {r['shards_max_diff']}; losses "
            f"{[round(v, 4) for v in r['losses']]} vs replica_loop_step("
            f"model=2) from the ranks' state before each step "
            f"{[round(v, 4) for v in r['ref_losses']]} (rel "
            f"{r['loss_rel']:.2e}); update cosine min over the steps "
            f"{r['min_cos']:.6f} ({r['worst_leaf']}) over "
            f"{r['compared_leaves']} leaves, {r['unmoved_leaves']} unmoved in "
            f"both; BN running statistics within {r['stats_ulps']:.2f} bf16 "
            f"steps; kernel 1 launches {r['launches']}; rank 0's steps (host "
            f"clock, the gloo exchanges through the host included) "
            f"{[round(v, 3) for v in r['seconds']]} s")
    out["loss_heads_runs"] = {"cli": finish_train_cli(ada_cli, timeout=600),
                              "ranks": ranks, "paths": paths}
    say(f"  (b) {time.time() - t1:.1f} s (with phase 15's heads and "
        f"cli.train); phase 14: {time.time() - t0:.1f} s")
    out.update(cli_launches=cli_launches, timing=timing,
               seconds=time.time() - t0)
    return out


def _loss_heads_grid() -> list:
    """Phase 15(c)'s heads on the four gloo ranks."""
    return [("adaface+center", _heads_config(center_weight=0.01)),
            ("curricular", _heads_config(margin_mode="curricular",
                                         margin_m2=0.5, margin_m3=0.0))]


def _start_loss_heads_cli() -> tuple:
    """Phase 15's untimed cli.train (preset 8, PRESET_STEPS), started in
    phase 14(b); its gloo heads run on phase 14's four ranks."""
    return start_train_cli(
        ["--preset", "adaface_noisy_data", "--pallas_input", "--data",
         "synthetic", "--num_steps", str(PRESET_STEPS), "--log_every",
         str(PRESET_STEPS // 2)])


def _heads_config(**overrides):
    """Phase 15(c)'s configs: preset 8 (AdaFace, 3 sub-centers, random
    erase 0.25, its cosine schedule) at 16 rows a rank of four, kernel 1
    on the augment, with ``overrides``."""
    import dataclasses

    from tf_face_toolbox_tpu_torch import configs

    return dataclasses.replace(configs.get_config("adaface_noisy_data"),
                               global_batch=64, pallas_input=True,
                               **overrides)


def phase_loss_heads(g, work: str, single_faces_per_sec: float,
                     runs: dict) -> dict:
    """Phase 15: the loss heads (BASELINE preset 8 and the other heads).
    ``runs``: its cli.train and gloo ranks, run during phase 14(b)."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.data.pipeline import (
        FaceShardSource, balanced_batch_iterator)

    t0 = time.time()
    say(f"[15 loss heads] {bench.gpu_info()}")
    # (a) preset 8's rate, timed alone, then its cli.train at full width
    # beside (c)
    t1 = time.time()
    timing = _time_preset("adaface_noisy_data")
    _say_bench("(a) time_training adaface_noisy_data", timing,
               single_faces_per_sec)
    say(f"      {time.time() - t1:.1f} s")

    # (b) the other heads at config 4's width: one step from the same
    # state through kernel 1 and through the plain augment chain
    t1 = time.time()
    images = torch.randint(0, 256, (256, 120, 120, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 10572, (256,), generator=g, device="cuda")
    # a P x K batch of 64 identities x 4 faces from phase 11's shard
    pk = next(balanced_batch_iterator(
        FaceShardSource(os.path.join(work, "train.faceshard")),
        ids_per_batch=64, images_per_id=4))
    counts = np.unique(pk["label"], return_counts=True)[1]
    expect(len(counts) == 64 and (counts == 4).all(),
           f"P x K batch: {len(counts)} identities, counts {set(counts)}")
    routes = {}
    for head, cfg, (x, y) in (
            ("magface", bt.config4(margin_mode="magface", margin_m3=0.0),
             (images, labels)),
            ("curricular", bt.config4(margin_mode="curricular",
                                      margin_m2=0.5, margin_m3=0.0),
             (images, labels)),
            ("cosface+center+triplet (P x K 64 x 4)",
             bt.config4(center_weight=0.01, triplet_weight=0.1),
             (torch.as_tensor(pk["image"]).cuda(),
              torch.as_tensor(pk["label"]).long().cuda()))):
        r = routes[head] = bt.step_routes(cfg, x, y)
        say(f"  (b) {head}, one step, kernel vs plain route: loss "
            f"{r['loss']['kernel']:.5f} / {r['loss']['plain']:.5f} (rel "
            f"{r['loss_rel']:.2e}), update cosine min {r['min_cos']:.6f} "
            f"({r['worst_leaf']}) over {r['compared_leaves']} leaves, "
            f"{r['unmoved_leaves']} unmoved in both (plain twice: "
            f"{r['repeat_min_cos']:.6f}); launches {r['launches']}")
        expect(r["loss_rel"] <= 0.01, f"{head}: routes' losses {r['loss']}")
        expect(r["min_cos"] >= 0.999, f"{head}: update cosine "
                                      f"{r['min_cos']} at {r['worst_leaf']}")
        expect(r["launches"] == {"kernel": 1, "plain": 0, "plain_again": 0},
               f"{head}: route launches {r['launches']}")
    del images, labels, pk
    torch.cuda.empty_cache()
    say(f"  (b) {time.time() - t1:.1f} s")

    # (c) four ranks on cuda:0 over gloo, data 2 x model 2, and (a)'s
    # cli.train, both run in phase 14(b)
    t1 = time.time()
    heads = _loss_heads_grid()
    ranks, paths = runs["ranks"], runs["paths"]
    step, logged, cli_launches = runs["cli"]
    losses, means = logged["loss"], logged.get("adaface_norm_mean", [])
    say(f"  (a) cli.train --preset adaface_noisy_data --pallas_input (r50 "
        f"face stem, bf16, 10,572 classes x 3 sub-centers, batch 256, random "
        f"erase 0.25, cosine LR; synthetic faces), in phase 14(b): done "
        f"step={step}, losses {[round(v, 4) for v in losses]}, "
        f"adaface_norm_mean {[round(v, 4) for v in means]}, kernel 1 "
        f"launches {cli_launches} in {PRESET_STEPS} steps")
    expect(step == PRESET_STEPS, f"preset 8 stopped at step {step}")
    expect(cli_launches == PRESET_STEPS,
           f"kernel 1 launched {cli_launches} times in {PRESET_STEPS} steps")
    expect(len(losses) == 2 and all(np.isfinite(losses)),
           f"preset-8 losses {losses}")
    expect(len(means) == 2 and all(np.isfinite(means)) and means[-1] != 20.0,
           f"AdaFace's EMA mean {means} did not move from 20")
    grid = {}
    for head, cfg in heads:
        r = grid[head] = _grid_against_reference(ranks, paths, head, cfg,
                                                 GRID_STEPS)
        say(f"  (c) {head}: 4 gloo ranks on cuda:0 (2 x 2), preset 8's r50 "
            f"face stem, 3 sub-centers, random erase and schedule, 16 rows a "
            f"rank, 10,572 classes (5,286 a shard), {GRID_STEPS} bf16 steps: "
            f"replicated "
            f"tensors max |diff| {r['ranks_max_diff']}, shards (classifier, "
            f"centers) across data ranks {r['shards_max_diff']}; losses "
            f"{[round(v, 4) for v in r['losses']]} vs replica_loop_step("
            f"model=2) from the ranks' state before each step "
            f"{[round(v, 4) for v in r['ref_losses']]} (rel "
            f"{r['loss_rel']:.2e}); update cosine min {r['min_cos']:.6f} "
            f"({r['worst_leaf']}) over {r['compared_leaves']} leaves; BN "
            f"running statistics within {r['stats_ulps']:.2f} bf16 steps; "
            f"head state rel {r['head_rel']:.2e}; kernel 1 launches "
            f"{r['launches']}")
    say(f"  (c) {time.time() - t1:.1f} s; phase 15: {time.time() - t0:.1f} s")
    return {"cli_launches": cli_launches, "timing": timing,
            "routes": routes, "grid": grid, "seconds": time.time() - t0}


# (network, stem) of phase 16(a): the new backbones at the extraction
# CLI's default stem, resnet_v1_50 at that stem (the rate they are read
# against), and resnet_v1_50 at the space2depth stem
BACKBONES = (("resnet_v1_50", "face"), ("se_resnet_50", "face"),
             ("resnext_50", "face"), ("se_resnext_50", "face"),
             ("densenet_121", "face"), ("resnet_v1_50", "space2depth"))
# kernel 2 at the space2depth stem, resnet_v1_50: the fused stages' bound
# at 256 images, 5.70 GFLOP an image at 989 TFLOP/s bf16
S2D_BOUND_MS = 1.475


def auto_impl(network: str, stem: str) -> str:
    """What ``cli.extract --engine auto`` serves a network through: the
    folded engine where it accepts the net, else the module path."""
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.serving.engine import check_servable
    try:
        check_servable(create_network(network, stem=stem))
    except ValueError:
        return "module"
    return "folded"


def phase_backbones(g, u8: torch.Tensor, work: str,
                    single_faces_per_sec: float) -> dict:
    """Phase 16: the ResNet family and DenseNet (BASELINE configs 2 and
    3) served, benchmarked and trained at published widths."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard, make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp
    from tf_face_toolbox_tpu_torch.serving import fused_block as fb
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply

    torch.cuda.empty_cache()
    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[16 backbones] {gpu}")
    faces = u8[:128]
    pixels = fp.fused_preprocess_reference(
        faces, torch.zeros(128, device="cuda"), out_h=112, out_w=112)
    # (a) each backbone through the route --engine auto takes, bf16,
    # against the f32 module path; faces/s plain and e2e, peak memory,
    # where the device time goes. The f32 module path itself is held
    # against the same module on the host (4 faces): a random-weight
    # DenseNet gives every face nearly the same embedding (face-to-face
    # cosine ~0.9999), so its bf16 route's batch-centered cosine reads
    # bf16 rounding, not a fault; there the f32 check is the one that
    # catches a wrong layer
    nets = {}
    host_pixels = pixels[:4].cpu()
    for network, stem in BACKBONES:
        label = f"{network}/{stem}"
        impl = auto_impl(network, stem)
        net32 = create_network(network, stem=stem)
        flat = random_variables(net32, 0)
        load_jax_variables(net32, flat)
        host = make_extract_fn(net32)(host_pixels)
        ref = make_extract_fn(net32.to("cuda"))(pixels)
        del net32
        torch.cuda.empty_cache()
        card = ref[:4].cpu()
        host_cos = per_image_cos(card, host).min().item()
        hmean = host.mean(0, keepdim=True)
        host_centered = per_image_cos(card - hmean, host - hmean).min().item()
        expect(host_cos >= 0.99999 and host_centered >= 0.99,
               f"{label}: f32 module on the card vs on the host: cosine "
               f"{host_cos}, batch-centered {host_centered}")
        # one build: the e2e forward and its plain one share the weights
        e2e = bench.build_forward(impl=impl, e2e=True, network=network,
                                  stem=stem)
        forward = e2e.plain
        fp.fused_preprocess.launches = 0
        fb.fused_bottleneck_block.launches = 0
        emb = forward(pixels)
        torch.cuda.synchronize()
        cos = per_image_cos(emb, ref).min().item()
        mean = ref.mean(0, keepdim=True)
        centered = per_image_cos(emb - mean, ref - mean).min().item()
        spread = per_image_cos(ref, ref[:1].expand_as(ref)).min().item()
        expect(tuple(emb.shape) == (128, 512)
               and bool(torch.isfinite(emb).all()), f"{label}: embeddings")
        expect(cos >= 0.999, f"{label}: cosine vs f32 module {cos} < 0.999")
        if impl == "folded":
            # the folded engine is another computation than the module:
            # the centered cosine catches a wrong block (phase 4's bar)
            expect(centered >= 0.95, f"{label}: batch-centered cosine "
                                     f"{centered} < 0.95")
        expect(fb.fused_bottleneck_block.launches == 0,
               f"{label}: {impl} launched kernel 2")
        torch.cuda.reset_peak_memory_stats()
        ms = bench.time_ms(forward, pixels, iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        prof = bt.device_profile(forward, pixels, iters=3)
        fp.fused_preprocess.launches = 0
        emb_e2e = e2e(faces)
        torch.cuda.synchronize()
        e2e_launches = fp.fused_preprocess.launches
        expect(e2e_launches == 1, f"{label} e2e: kernel 1 launched "
                                  f"{e2e_launches} times, want 1")
        e2e_cos = per_image_cos(emb_e2e, ref).min().item()
        expect(e2e_cos >= 0.999, f"{label} e2e: cosine {e2e_cos} < 0.999")
        e2e_ms = bench.time_ms(e2e, faces, iters=5, warmup=2)
        nets[label] = {
            "impl": impl, "min_cos": cos, "centered_min_cos": centered,
            "face_to_face_min_cos": spread, "host_min_cos": host_cos,
            "host_centered_min_cos": host_centered,
            "faces_per_sec": 128 * 1e3 / ms, "ms_per_batch": ms,
            "e2e_faces_per_sec": 128 * 1e3 / e2e_ms, "e2e_ms": e2e_ms,
            "e2e_launches": e2e_launches, "e2e_min_cos": e2e_cos,
            "peak_memory_gb": peak / 1e9,
            **{k: v for k, v in prof.items() if k != "kernels_ms"},
            "top_kernels_ms": prof["kernels_ms"][:5]}
        kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            prof["device_ms_by_kind"].items(), key=lambda kv: -kv[1])[:3])
        say(f"  (a) {label} via {impl}, bf16, 128 faces (256 images): cos "
            f"vs f32 module min {cos:.6f} (centered {centered:.4f}; the f32 "
            f"module's faces agree to cos {spread:.6f}; f32 module vs host "
            f"cos {host_cos:.7f}, centered {host_centered:.5f}); "
            f"{128 * 1e3 / ms:.1f} faces/s ({ms:.2f} ms/batch), e2e "
            f"{128 * 1e3 / e2e_ms:.1f} faces/s (kernel 1 x{e2e_launches}, "
            f"cos {e2e_cos:.6f}); peak {peak / 1e9:.2f} GB; device "
            f"{prof['device_ms']:.2f} of {prof['wall_ms']:.2f} ms wall "
            f"(idle {prof['idle_share']:.1%}): {kinds} ms; top "
            f"{prof['kernels_ms'][0][1][:60]} "
            f"{prof['kernels_ms'][0][0]:.2f} ms")
        del forward, e2e
        torch.cuda.empty_cache()
    t1 = time.time()
    say(f"  (a) {t1 - t0:.1f} s")

    # (b) kernel 2 at the space2depth stem: 13 launches a batch, each
    # stage held to its plain version, timed beside the folded cuDNN
    # stages and the bound; an SE net's stages stay folded
    forward = bench.build_forward(impl="fused", network="resnet_v1_50",
                                  stem="space2depth")
    fb.fused_bottleneck_block.launches = 0
    emb = forward(pixels)
    torch.cuda.synchronize()
    s2d_launches = fb.fused_bottleneck_block.launches
    expect(s2d_launches == 13, f"space2depth --impl fused: {s2d_launches} "
                               "kernel 2 launches, want 13 (3 + 3 + 5 + 2)")
    folded = bench.build_forward(impl="folded", network="resnet_v1_50",
                                 stem="space2depth")(pixels)
    cos = per_image_cos(emb, folded).min().item()
    expect(cos >= 0.999, f"space2depth fused vs folded: cosine {cos}")
    del forward
    stages: list = []
    for (shape, entry, tail, fold), name in zip(
            stage_operands("resnet_v1_50", "space2depth", 0),
            ("s2d 56x56", "s2d 28x28", "s2d 14x14", "s2d 7x7")):
        x = torch.relu(torch.randn((256, *shape), generator=g, device="cuda")
                       ).to(torch.bfloat16)
        check_block_stack(name, x, entry, tail, fold, stages)
    s2d_bound = sum(s["bound_ms"] for s in stages)
    expect(abs(s2d_bound - S2D_BOUND_MS) < 0.01 * S2D_BOUND_MS,
           f"space2depth stages' bound {s2d_bound} ms, reckoned "
           f"{S2D_BOUND_MS} ms")
    se = create_network("se_resnet_50", dtype=torch.bfloat16)
    flat = random_variables(se, 0)
    fb.fused_bottleneck_block.launches = 0
    se_fused = make_serving_apply(se, flat, use_kernels=True)(
        pixels.to(torch.bfloat16))
    torch.cuda.synchronize()
    se_launches = fb.fused_bottleneck_block.launches
    se_folded = make_serving_apply(se, flat)(pixels.to(torch.bfloat16))
    expect(se_launches == 0, f"se_resnet_50 --engine fused: {se_launches} "
                             "kernel 2 launches, want 0 (SE stages fold)")
    expect(torch.equal(se_fused, se_folded),
           "se_resnet_50 fused differs from folded")
    s2d = {"launches": s2d_launches, "fused_vs_folded_min_cos": cos,
           "ms": sum(s["ms"] for s in stages),
           "graph_ms": sum(s["graph_ms"] for s in stages),
           "plain_ms": sum(s["plain_ms"] for s in stages),
           "library_route_ms": sum(s["library_route_ms"] for s in stages),
           "library_route_graph_ms": sum(s["library_route_graph_ms"]
                                         for s in stages),
           "bound_ms": s2d_bound, "max_abs_err": max(
               s["max_abs_err"] for s in stages),
           "stages": [{k: v for k, v in st.items()
                       if k != "library_route_range"} for st in stages],
           "se_resnet_50_launches": se_launches}
    say(f"  (b) resnet_v1_50/space2depth --impl fused: kernel 2 x"
        f"{s2d_launches} a batch, cos vs folded {cos:.6f}; the 4 fused "
        f"stages at 256 images: kernel {s2d['ms']:.3f} ms (graph "
        f"{s2d['graph_ms']:.3f}), folded cuDNN stages {s2d['library_route_ms']:.3f} "
        f"ms (graph {s2d['library_route_graph_ms']:.3f}), plain "
        f"{s2d['plain_ms']:.3f} ms, bound {s2d_bound:.3f} ms "
        f"({s2d_bound / s2d['graph_ms']:.1%} of it, graph); se_resnet_50 "
        f"--engine fused: kernel 2 x{se_launches}, equal to folded; "
        f"{time.time() - t1:.1f} s")
    t2 = time.time()

    # (c) cli.extract --engine auto on a DenseNet: the module path; and
    # (d)'s two cli.train runs: the three side by side (they time nothing)
    shard = os.path.join(work, "faces.faceshard")
    out = os.path.join(work, "densenet_emb.npy")
    trained = ("se_resnet_50", "densenet_121")
    started = [start_train_cli(["--network", network, "--num_classes",
                                "10572", "--global_batch", "64",
                                "--num_steps", "5", "--log_every", "1",
                                "--pallas_input", "--data", "synthetic"])
               for network in trained]
    densenet = spawn(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--network", "densenet_121", "--engine", "auto", "--data", shard,
         "--output", out, "--crop_from", "120", "--batch", "128",
         "--loader", "python", "--device", "cuda"])
    try:
        net32 = create_network("densenet_121")
        want = extract_shard(net32, random_variables(net32, 0),
                             FaceShardSource(shard), image_size=112,
                             crop_from=120, batch=128, loader="python",
                             device="cuda")
        proc = collect(densenet, timeout=600)
    except BaseException:
        for _, (p, _, _) in started:
            p.kill()
            p.wait()
        densenet[0].kill()
        densenet[0].wait()
        raise
    expect(proc.returncode == 0,
           f"cli.extract densenet_121 failed:\n{proc.stderr[-3000:]}")
    expect("serving engine not applicable" in proc.stderr,
           "cli.extract densenet_121 --engine auto logged no fallback")
    expect("kernel launches: fused_block=0" in proc.stdout,
           f"cli.extract densenet_121: {proc.stdout[-500:]}")
    got = np.load(out)
    cli_cos = per_image_cos(torch.from_numpy(got),
                            torch.from_numpy(want)).min().item()
    expect(got.shape == (400, 512) and np.isfinite(got).all(),
           f"cli.extract densenet_121 wrote {got.shape}")
    expect(cli_cos >= 0.999, f"cli.extract densenet_121 (bf16) vs f32 "
                             f"module: cosine {cli_cos} < 0.999")
    say(f"  (c) cli.extract --network densenet_121 --engine auto: fallback "
        f"to the module path logged, {got.shape}, cos vs f32 module min "
        f"{cli_cos:.6f}; beside (d)'s cli.train runs, "
        f"{time.time() - t2:.1f} s")
    t3 = time.time()

    # (d) training: cli.train --pallas_input (one kernel 1 launch a step),
    # then the training rate, the card to itself
    train = {}
    runs = [finish_train_cli(s, timeout=600) for s in started]
    for network, (step, logged, launches) in zip(trained, runs):
        losses = logged["loss"]
        expect(step == 5 and len(losses) == 5
               and all(np.isfinite(v) for v in losses),
               f"cli.train {network}: step {step}, losses {losses}")
        expect(launches == 5, f"cli.train {network}: kernel 1 launched "
                              f"{launches} times in 5 steps")
        r = bt.time_training(bt.config4(network=network, global_batch=64),
                             steps=6, warmup=2, profile_steps=1)
        train[network] = {"launches": launches, "losses": losses,
                          **{k: r[k] for k in (
                              "faces_per_sec", "ms_per_step",
                              "peak_memory_gb", "idle_share",
                              "device_ms_per_step", "peak_share",
                              "device_ms_by_kind")}}
        say(f"  (d) {network}: training faces/s {r['faces_per_sec']:.1f} "
            f"(batch 64, {r['ms_per_step']:.2f} ms/step; config 4's "
            f"resnet_v1_50 at 256: {single_faces_per_sec:.1f}), peak "
            f"{r['peak_memory_gb']:.2f} GB, idle {r['idle_share']:.1%}, "
            f"{r['peak_share']:.1%} of the bf16 peak")
        say(f"  (d) cli.train --network {network} --pallas_input, 5 steps, "
            f"batch 64, 10,572 classes: losses "
            f"{[round(v, 4) for v in losses]}, kernel 1 x{launches}")
    say(f"  (d) {time.time() - t3:.1f} s; phase 16: {time.time() - t0:.1f} s")
    return {"nets": nets, "space2depth": s2d, "cli_extract_min_cos": cli_cos,
            "train": train, "seconds": time.time() - t0}


def _extract_cli(args: list, timeout: int = 600) -> subprocess.CompletedProcess:
    """cli.extract as a subprocess on this card; fails the smoke unless
    it exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--device", "cuda", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout)
    expect(proc.returncode == 0, f"cli.extract {' '.join(args)} failed:\n"
                                 f"{proc.stderr[-3000:]}")
    return proc


def _kernel2_launches(text: str) -> int:
    """The last ``fused_block=N`` a cli.extract run printed or logged."""
    found = [int(line.rsplit("fused_block=", 1)[1].split(")")[0])
             for line in text.splitlines() if "fused_block=" in line]
    expect(bool(found), "cli.extract printed no kernel launches")
    return found[-1]


def _face_cos(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(min per-face cosine, max |a - b|) of two embedding files."""
    expect(a.shape == b.shape, f"shapes {a.shape} vs {b.shape}")
    cos = per_image_cos(torch.from_numpy(np.asarray(a)),
                        torch.from_numpy(np.asarray(b)))
    return cos.min().item(), float(np.abs(np.asarray(a) - b).max())


def _extract_rank(rank: int, world: int, port: int, shard: str, npz: str,
                  rows: int, batch: int, output: str, out_path: str) -> None:
    """Phase 17(d): one rank of a gloo group on cuda:0 (a spawned
    process): data-parallel extraction of the shard's first ``rows``
    faces through the bf16 module path, with the quality scores, and the
    resumable writer into ``output`` in chunks of two batches (rank 0
    alone writes); its results to ``out_path``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import (
        extract_shard, extract_shard_to_npy, make_extract_fn)
    from tf_face_toolbox_tpu_torch.interop.port import (
        flatten_variables, load_jax_variables, load_variables_npz)
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.parallel.mesh import init_distributed

    topo = init_distributed("cuda:0", backend="gloo")
    try:
        flat = flatten_variables(load_variables_npz(npz))
        net = load_jax_variables(create_network(
            "resnet_v1_50", stem="face", dtype=torch.bfloat16), flat).to(
                topo.device).eval()
        src = FaceShardSource(shard)
        kw = dict(image_size=112, crop_from=120, batch=batch,
                  loader="python", rows=(0, rows), device=topo.device)
        emb, quality = extract_shard(
            net, flat, src, with_quality=True,
            extract_fn=make_extract_fn(net, with_quality=True, mesh=topo),
            **kw)
        out = extract_shard_to_npy(
            net, flat, src, output, chunk_rows=2 * batch,
            extract_fn=make_extract_fn(net, mesh=topo), mesh=topo, **kw)
        torch.save({"emb": torch.from_numpy(emb),
                    "quality": torch.from_numpy(quality),
                    "written": None if out is None
                    else torch.from_numpy(np.array(out))}, out_path)
    finally:
        dist.destroy_process_group()


def phase_extract_resume(g, work: str) -> dict:
    """Phase 17: the rest of extraction at full width (resnet_v1_50, face
    stem, 512-d, bf16, seeded weights) on a packed shard of 4,096
    synthetic 120x120 faces, python loader: cli.extract --engine fused
    --chunk_rows 1024 --batch 256 killed (SIGKILL) once its second
    chunk's sidecar is on disk and run again (it recomputes at most the
    chunk in flight), against an uninterrupted one-shot run; one file
    filled from two disjoint --rows ranges; --output_quality through the
    fused engine against the f32 module path on the host; data-parallel
    extraction on two gloo ranks sharing the card (a batch ragged against
    the ranks) and cli.extract --data_parallel under torchrun (one NCCL
    rank), each against the single-process module path."""
    import multiprocessing as mp
    import signal
    import socket

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard
    from tf_face_toolbox_tpu_torch.interop.port import (
        load_jax_variables, save_variables_npz)
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables

    torch.cuda.empty_cache()
    t0 = time.time()
    say(f"[17 extraction] {bench.gpu_info()}")
    # (16,384 faces in chunks of 4,096 until the smoke outgrew its time)
    n, chunk, batch = 4096, 1024, 256
    shard = os.path.join(work, "extract17.faceshard")
    faces = torch.randint(0, 256, (n, 120, 120, 3), generator=g,
                          device="cuda", dtype=torch.uint8).cpu().numpy()
    pack_arrays(shard, faces, [i % 1000 for i in range(n)])
    del faces
    npz = os.path.join(work, "r50_face_seed0.npz")
    flat = random_variables(create_network("resnet_v1_50", stem="face"), 0)
    save_variables_npz(npz, flat)
    base = ["--stem", "face", "--variables_npz", npz, "--data", shard,
            "--crop_from", "120", "--batch", str(batch), "--loader",
            "python"]
    times = {}

    # an earlier run's files: its outputs and their finished sidecars
    # would leave every run here nothing to compute
    for f in os.listdir(work):
        if f.startswith("x17_"):
            os.remove(os.path.join(work, f))

    def out(name):
        return os.path.join(work, f"x17_{name}.npy")

    # one shot, uninterrupted, with the quality scores, beside the chunked
    # run and its rerun (no run here is timed)
    t_one = time.time()
    one, q_path = out("oneshot"), out("quality")
    oneshot = spawn([sys.executable, "-m",
                     "tf_face_toolbox_tpu_torch.cli.extract", "--device",
                     "cuda", *base, "--engine", "fused", "--output", one,
                     "--output_quality", q_path])
    # chunked, SIGKILLed once the second chunk is recorded, then again
    t1 = time.time()
    chunked = out("chunked")
    side = chunked + ".progress.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--device", "cuda", *base, "--engine", "fused", "--chunk_rows",
         str(chunk), "--output", chunked], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done_at_kill = []
    while proc.poll() is None and time.time() - t1 < 600:
        try:
            with open(side) as f:
                done_at_kill = json.load(f)["done"]
        except (OSError, ValueError):
            pass
        if len(done_at_kill) >= 2:
            os.kill(proc.pid, signal.SIGKILL)
            break
        time.sleep(0.05)
    _, err1 = proc.communicate(timeout=60)
    expect(proc.returncode == -signal.SIGKILL,
           f"the chunked run was not killed (exit {proc.returncode}):\n"
           f"{err1[-2000:]}")
    with open(side) as f:
        done_at_kill = json.load(f)["done"]
    killed_launches = _kernel2_launches(err1)
    times["killed run"] = time.time() - t1
    # (d)'s data-parallel runs beside the rest of (a) and (b): 3 batches
    # of 256 and a ragged 231, which two ranks pad to 232
    dp_rows = 999
    dp, dq = out("dp"), out("dp_quality")
    dp_run = _start_torchrun(["tf_face_toolbox_tpu_torch.cli.extract",
                              "--device", "cuda", *base, "--data_parallel",
                              "--rows", f"0:{dp_rows}", "--output", dp,
                              "--output_quality", dq])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    rank_paths = [os.path.join(work, f"x17_rank{r}.pt") for r in range(2)]
    rank_procs = [ctx.Process(target=_extract_rank, args=(
        r, 2, port, shard, npz, dp_rows, batch, out("gloo"), rank_paths[r]))
        for r in range(2)]
    for p in rank_procs:
        p.start()
    # (b)'s first range beside the rerun (its second writes the same
    # file, after it)
    t_ranges = time.time()
    ranged = out("ranged")
    ranges = ((0, chunk), (n - chunk, n))      # the first and last chunks
    first_range = spawn([sys.executable, "-m",
                         "tf_face_toolbox_tpu_torch.cli.extract", "--device",
                         "cuda", *base, "--engine", "fused", "--chunk_rows",
                         str(chunk), "--rows", f"{ranges[0][0]}:{ranges[0][1]}",
                         "--output", ranged])
    t1 = time.time()
    proc = _extract_cli([*base, "--engine", "fused", "--chunk_rows",
                         str(chunk), "--output", chunked])
    rerun_launches = _kernel2_launches(proc.stdout)
    times["rerun"] = time.time() - t1
    proc = collect(oneshot, timeout=600)
    expect(proc.returncode == 0, f"cli.extract one shot failed:\n"
                                 f"{proc.stderr[-3000:]}")
    one_launches = _kernel2_launches(proc.stdout)
    times["one-shot (from its start)"] = time.time() - t_one
    per_batch = one_launches / (n // batch)
    expect(per_batch == int(per_batch) and per_batch > 0,
           f"kernel 2: {one_launches} launches in {n // batch} batches")
    chunks = n // chunk
    computed = rerun_launches / (per_batch * (chunk // batch))
    # the run killed mid-chunk lost that chunk alone: the rerun computes
    # the chunks not recorded, the one in flight among them
    recomputed = computed - (chunks - len(done_at_kill) - 1) if len(
        done_at_kill) < chunks else computed
    cos, diff = _face_cos(np.load(chunked), np.load(one))
    say(f"  (a) cli.extract --engine fused --chunk_rows {chunk} --batch "
        f"{batch}, {n:,} faces: one shot {one_launches} kernel 2 launches "
        f"({per_batch:.0f} a batch); SIGKILL with chunks {done_at_kill} "
        f"recorded ({killed_launches} launches logged by then), the rerun "
        f"computed {computed:.0f} of {chunks} chunks ({rerun_launches} "
        f"launches), recomputed {recomputed:.0f} (the one in flight); "
        f"against the one-shot run: min per-face cosine {cos:.7f}, max "
        f"|diff| {diff:.3g}")
    expect(computed == chunks - len(done_at_kill),
           f"the rerun computed {computed} chunks, "
           f"{chunks - len(done_at_kill)} were left")
    expect(recomputed <= 1, f"recomputed {recomputed} chunks")
    expect(cos >= 0.99999, f"resumed output cosine {cos} < 0.99999")
    with open(side) as f:
        expect(json.load(f)["done"] == list(range(0, n, chunk)),
               "sidecar not complete")
    # one file from two disjoint ranges
    proc = collect(first_range, timeout=600)
    expect(proc.returncode == 0, f"cli.extract --rows {ranges[0]} failed:\n"
                                 f"{proc.stderr[-3000:]}")
    lo, hi = ranges[1]
    _extract_cli([*base, "--engine", "fused", "--chunk_rows", str(chunk),
                  "--rows", f"{lo}:{hi}", "--output", ranged])
    times["two ranges (the first beside the rerun)"] = time.time() - t_ranges
    filled = np.load(ranged)
    expect(not filled[chunk:n - chunk].any(), "rows outside the ranges "
                                              "were written")
    picked = np.r_[0:chunk, n - chunk:n]
    cos_r, diff_r = _face_cos(filled[picked], np.load(one)[picked])
    sidecars = sorted(p for p in os.listdir(work)
                      if p.startswith("x17_ranged.npy.rows"))
    say(f"  (b) --rows {ranges[0][0]}:{ranges[0][1]} then "
        f"{ranges[1][0]}:{ranges[1][1]} into one {n}-row file: min per-face "
        f"cosine {cos_r:.7f} against the one-shot run, max |diff| "
        f"{diff_r:.3g}, the rows between untouched; sidecars {sidecars}")
    expect(cos_r >= 0.99999, f"ranged output cosine {cos_r} < 0.99999")
    # the one-shot run's quality (kernel 2) against the host's f32 module
    t1 = time.time()
    q_rows = 32
    host = load_jax_variables(create_network("resnet_v1_50", stem="face"),
                              flat).eval()
    h_emb, h_q = extract_shard(host, flat, FaceShardSource(shard),
                               image_size=112, crop_from=120, batch=q_rows,
                               loader="python", rows=(0, q_rows),
                               with_quality=True, device="cpu")
    times["quality (host f32)"] = time.time() - t1
    del host
    cos_q, _ = _face_cos(np.load(one)[:q_rows], h_emb)
    q = np.load(q_path)
    q_rel = float(np.abs(q[:q_rows] / h_q - 1).max())
    say(f"  (c) --output_quality of the one-shot run: {q.shape} scores "
        f"{q.min():.3f}-{q.max():.3f}; its first {q_rows} faces against the "
        f"host's f32 module path: embedding cosine min {cos_q:.6f}, quality "
        f"max relative error {q_rel:.3g}")
    expect(q.shape == (n,) and np.isfinite(q).all(), "quality file")
    expect(cos_q >= 0.999, f"quality run cosine {cos_q} < 0.999")
    expect(q_rel <= 5e-3, f"quality relative error {q_rel} > 5e-3")
    # data-parallel: two gloo ranks, torchrun (one NCCL rank)
    t1 = time.time()
    try:
        for p in rank_procs:
            p.join(timeout=600)
    finally:
        for p in rank_procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    expect([p.exitcode for p in rank_procs] == [0, 0],
           f"gloo extraction ranks exited {[p.exitcode for p in rank_procs]}")
    ranks = [torch.load(path, weights_only=True) for path in rank_paths]
    proc = _torchrun(dp_run, timeout=600)
    expect("data-parallel extraction over 1 ranks" in proc.stderr,
           "torchrun cli.extract did not run data-parallel")
    times["data parallel (its wait)"] = time.time() - t1
    t1 = time.time()
    net = load_jax_variables(create_network(
        "resnet_v1_50", stem="face", dtype=torch.bfloat16), flat).to(
            "cuda").eval()
    mod = extract_shard(net, flat, FaceShardSource(shard), image_size=112,
                        crop_from=120, batch=batch, loader="python",
                        rows=(0, dp_rows), device="cuda")
    del net
    times["module"] = time.time() - t1
    cos_dp, diff_dp = _face_cos(np.load(dp), mod)
    # each gloo rank forwards half of every batch, where the module path
    # forwards it whole: cuDNN may take other algorithms, so bf16 rounds
    # differently (BASELINE's 0.999 is bf16 against f32)
    emb2 = ranks[0]["emb"].numpy()
    cos_g, diff_g = _face_cos(emb2, mod)
    q_g = float(np.abs(ranks[0]["quality"].numpy() / q[:dp_rows] - 1).max())
    written = ranks[0]["written"]
    say(f"  (d) 2 gloo ranks on cuda:0, {dp_rows} faces in batches of "
        f"{batch} (the last, {dp_rows % batch}, padded to "
        f"{dp_rows % batch + 1} over the ranks): against the "
        f"single-process module path min cosine {cos_g:.7f}, max |diff| "
        f"{diff_g:.3g}, quality max relative difference {q_g:.3g} against "
        f"the fused one-shot run's; the ranks' returns equal: "
        f"{bool(torch.equal(ranks[0]['emb'], ranks[1]['emb']))}; rank 0's "
        f"resumable file equals its one-shot return: "
        f"{written is not None and bool(np.array_equal(written[:dp_rows], emb2))}"
        f"; torchrun --nproc_per_node 1 cli.extract --data_parallel (NCCL): "
        f"min cosine {cos_dp:.7f}, max |diff| {diff_dp:.3g}; quality "
        f"{np.load(dq).shape}")
    expect(all(torch.equal(ranks[0][k], ranks[1][k])
               for k in ("emb", "quality")), "the gloo ranks' returns differ")
    expect(ranks[1]["written"] is None, "rank 1 returned the written file")
    expect(written is not None and written.shape == (n, emb2.shape[1])
           and np.array_equal(written[:dp_rows], emb2)
           and not written[dp_rows:].any(),
           "rank 0's resumable file is not its one-shot extraction")
    expect(cos_g >= 0.9999, f"gloo data-parallel cosine {cos_g} < 0.9999")
    expect(q_g <= 5e-3, f"gloo data-parallel quality {q_g} > 5e-3")
    expect(cos_dp >= 0.99999, f"data-parallel cosine {cos_dp} < 0.99999")
    total = time.time() - t0
    say(f"  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f"; phase 17: {total:.1f} s")
    return {"launches": {"one_shot": one_launches, "killed": killed_launches,
                         "rerun": rerun_launches},
            "recomputed": recomputed, "resume_max_diff": diff,
            "quality_rel_err": q_rel, "gloo_min_cos": cos_g,
            "seconds": total}


def _ijbc_synthetic(g):
    """Embeddings at IJB-C's 1:1 counts: 469,375 faces of 23,124 templates
    of 3,531 subjects (media ids within a template), and 15,658,489
    template pairs, 19,557 of them genuine. Unit-norm 512-d rows: a
    subject's center plus noise."""
    faces, templates, subjects, pairs, genuine = (469_375, 23_124, 3_531,
                                                   15_658_489, 19_557)
    rng = np.random.default_rng(17)
    t_subject = np.arange(templates) % subjects
    face_t = np.concatenate([np.arange(templates),
                             rng.integers(0, templates, faces - templates)])
    media = rng.integers(0, 8, faces)
    centers = torch.randn((subjects, 512), generator=g, device="cuda")
    centers = centers / centers.norm(dim=1, keepdim=True)
    subj = torch.from_numpy(t_subject[face_t]).cuda()
    emb = centers[subj] + 0.35 * torch.randn((faces, 512), generator=g,
                                             device="cuda")
    emb = (emb / emb.norm(dim=1, keepdim=True)).cpu().numpy()
    # genuine pairs: a template and another of its subject (templates s,
    # s + S, s + 2S, ... share subject s); the rest uniform
    i1 = rng.integers(0, templates, pairs)
    i2 = rng.integers(0, templates, pairs)
    first = i1[:genuine]
    i2[:genuine] = np.where(first + subjects < templates, first + subjects,
                            first - subjects)
    labels = (t_subject[i1] == t_subject[i2]).astype(np.int64)
    ids = np.arange(templates) * 7 + 11        # ids, not row numbers
    return emb, ids[face_t], media, np.stack([ids[i1], ids[i2]], 1), labels


def _same_tar(a: dict, b: dict) -> bool:
    """The TAR entries of two reports are equal (NaN, or JSON's null, at
    a FAR finer than the pairs resolve, matches either)."""
    def v(x):
        return float("nan") if x is None else x
    keys = [k for k in b if k.startswith("tar@")]
    return bool(keys) and all(
        v(a.get(k)) == v(b[k]) or (np.isnan(v(a.get(k, 0.0)))
                                   and np.isnan(v(b[k]))) for k in keys)


def _host_segment_mean(x: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    """Plain f64 segment means on the host: a (segments, rows) 0/1 sparse
    matrix times the rows."""
    from scipy import sparse

    onehot = sparse.csr_matrix((np.ones(len(seg)), (seg, np.arange(len(seg)))),
                               shape=(n, len(seg)))
    counts = np.bincount(seg, minlength=n).astype(np.float64)
    return (onehot @ x.astype(np.float64)) / np.maximum(counts, 1)[:, None]


def _host_tar(sims: np.ndarray, labels: np.ndarray, fars) -> dict:
    """TAR at each FAR, plainly: k = floor(FAR * impostors) impostors may
    pass, so the threshold is the (k + 1)-th highest impostor score and a
    genuine pair is accepted strictly above it (NaN where k is 0: a FAR
    finer than the impostors resolve)."""
    genuine = sims[labels == 1]
    impostor = np.sort(sims[labels == 0])
    out = {}
    for far in fars:
        k = int(far * len(impostor))
        thr = impostor[len(impostor) - 1 - k]
        out[f"tar@far={far:g}"] = (np.count_nonzero(genuine > thr)
                                   / len(genuine) if k else float("nan"))
    return out


def phase_templates(g, work: str) -> dict:
    """Phase 18: IJB templates at IJB-C's 1:1 counts (synthetic
    embeddings): aggregate_templates and verify_templates on the card
    against a plain host computation (f64 segment means, pair scores
    from the templates' f32 Gram matrix, TAR from a sort of the impostor
    scores; TAR equal, templates allclose at 1e-5), then
    cli.eval_templates end to end on a 10^6-pair file; the seconds of
    each stage."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.ops.templates import (
        aggregate_templates, verify_templates)

    torch.cuda.empty_cache()
    t0 = time.time()
    say(f"[18 templates] {bench.gpu_info()}")
    times = {}
    emb, tids, mids, pairs, labels = _ijbc_synthetic(g)
    times["synthetic data"] = time.time() - t0
    t1 = time.time()
    t_emb, keys = aggregate_templates(emb, tids, mids, device="cuda")
    torch.cuda.synchronize()
    times["aggregate (card)"] = time.time() - t1
    t1 = time.time()
    fars = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)
    report = verify_templates(t_emb, keys, pairs, labels, fars=fars,
                              device="cuda")
    times["verify (card)"] = time.time() - t1
    # the CLI on a 10^6-pair file, beside the host computation below
    t1 = time.time()
    emb_path = os.path.join(work, "ijbc_emb.npy")
    meta = os.path.join(work, "ijbc_meta.txt")
    pair_file = os.path.join(work, "ijbc_pairs.txt")
    np.save(emb_path, emb)
    with open(meta, "w") as f:
        f.writelines(f"{t} {m}\n" for t, m in zip(tids.tolist(),
                                                  mids.tolist()))
    sub = slice(0, 1_000_000)
    with open(pair_file, "w") as f:
        f.writelines(f"{a} {b} {c}\n" for (a, b), c in zip(
            pairs[sub].tolist(), labels[sub].tolist()))
    times["CLI inputs written"] = time.time() - t1
    t_cli = time.time()
    cli = _cli("eval_templates", "--embeddings", emb_path, "--meta", meta,
               "--pairs", pair_file, "--fars", "1e-1,1e-2,1e-3,1e-4",
               "--device", "cuda")
    # the plain host computation, independent of the port's functions
    t1 = time.time()
    tk, tidx = np.unique(tids, return_inverse=True)
    mk, midx = np.unique(np.stack([tidx, mids], 1), axis=0,
                         return_inverse=True)
    media = _host_segment_mean(emb, midx.reshape(-1), len(mk))
    host = _host_segment_mean(media, mk[:, 0], len(tk))
    host = (host / np.sqrt((host * host).sum(1, keepdims=True) + 1e-12)
            ).astype(np.float32)
    times["aggregate (host)"] = time.time() - t1
    t1 = time.time()
    i1, i2 = np.searchsorted(tk, pairs[:, 0]), np.searchsorted(tk, pairs[:, 1])
    expect(bool((tk[i1] == pairs[:, 0]).all()
                and (tk[i2] == pairs[:, 1]).all()), "a pair names no template")
    # every pair's cosine from the templates' f32 Gram matrix (2.1 GB)
    sims = (host @ host.T)[i1, i2]
    want = _host_tar(sims, labels, fars)
    times["verify (host)"] = time.time() - t1
    tmpl_diff = float(np.abs(t_emb - host).max())
    tars = {k: v for k, v in report.items() if k.startswith("tar@")}
    say(f"  (a) {len(emb):,} faces, {len(keys):,} templates, "
        f"{report['pairs']:,} pairs ({report['positives']:,} genuine): "
        f"templates max |card - host| {tmpl_diff:.3g}; TAR {tars}; host "
        f"TAR equal: {_same_tar(want, report)}")
    expect(tk.tolist() == keys.tolist(), "template keys differ")
    expect(np.allclose(t_emb, host, rtol=1e-5, atol=1e-5),
           f"templates card vs host max |diff| {tmpl_diff}")
    expect(_same_tar(want, report), f"TAR card {tars} vs host {want}")
    expect(any(0 < v < 1 for v in tars.values()), f"degenerate TAR {tars}")
    cli_report = json.loads("\n".join(_cli_done(cli, 600)))
    times["cli.eval_templates (beside the host's)"] = time.time() - t_cli
    # the same 10^6 pairs in this process (string ids: the CLI's)
    inproc = verify_templates(
        t_emb, keys.astype(str), pairs[sub].astype(str), labels[sub],
        fars=(1e-1, 1e-2, 1e-3, 1e-4), device="cuda")
    same = _same_tar(cli_report, inproc)
    say(f"  (b) cli.eval_templates, 10^6 pairs: templates "
        f"{cli_report['templates']:,}, images {cli_report['images']:,}, "
        f"TAR { {k: v for k, v in cli_report.items() if k.startswith('tar@')} }"
        f", equal to the in-process report: {same}")
    expect(cli_report["templates"] == len(keys)
           and cli_report["images"] == len(emb), "CLI counts")
    expect(same, f"CLI report {cli_report} vs {inproc}")
    for f in (emb_path, meta, pair_file):
        os.remove(f)
    total = time.time() - t0
    say("  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f"; phase 18: {total:.1f} s")
    return {"tar": tars, "seconds": total, "stages": times}


# the optimizers' learning rates at config 4 (SGD keeps the preset's 0.1)
_OPT_LR = {"adam": 1e-3, "adamw": 1e-3, "lars": 0.1}
OPT_STEPS = 6               # phase 19's cli.train steps
# phase 19(c)'s bound on the largest per-leaf |card - host| / |update|
# after 2 f32 steps (the noise-only leaf apart). The card's and the
# host's convolutions round differently; Adam's update is near the sign
# of the gradient, so entries that nearly cancel flip it: a whole leaf
# can differ by a third of its update there, where a wrong moment or
# rate moves it by the whole update or more. LARS scales the gradient
# itself, so its bound is tight enough to see a wrong trust ratio.
_OPT_PARITY = {"adam": 1.0, "adamw": 1.0, "lars": 0.1}


def _rel_update_diff(a: dict, b: dict, start: dict) -> tuple[float, str]:
    """The largest per-leaf |a - b| / |b - start| (L2 norms) over the
    leaves ``b`` moved."""
    worst, name = 0.0, ""
    for k, v in b.items():
        moved = (v - start[k]).norm().item()
        if moved == 0:
            continue
        r = (a[k] - v).norm().item() / moved
        if r > worst:
            worst, name = r, k
    return worst, name


def phase_optimizers(g, work: str, teacher_dir: str,
                     single_faces_per_sec: float) -> dict:
    """Phase 19: Adam, AdamW, LARS and distillation at config 4 (r50 face
    stem, bf16, batch 256, CosFace over 10,572 classes, --pallas_input):
    cli.train OPT_STEPS steps under each optimizer (kernel 1 once a step),
    faces/s, device ms and peak memory under each (time_training, 8
    steps after 2; SGD's is phase 11's); 2 f32 steps at batch 32 from one state and one set
    of batches on the card and on the host (TF32 off) per optimizer, the
    host's in a thread beside the cli.train runs; an
    exact resume under Adam; distillation of a fresh resnet_v1_50 from
    ``teacher_dir`` at alpha 1 and 0.5 (cli.train, OPT_STEPS steps), its
    distill_loss, and its faces/s at 0.5 (both losses a step)."""
    import dataclasses
    import shutil

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.cli.train import build_teacher
    from tf_face_toolbox_tpu_torch.interop.port import named_to_flat
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    torch.cuda.empty_cache()
    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[19 optimizers, distillation] {gpu}")
    args4 = ["--network", "resnet_v1_50", "--stem", "face", "--num_classes",
             "10572", "--global_batch", "256", "--bf16", "--pallas_input",
             "--data", "synthetic", "--num_steps", str(OPT_STEPS),
             "--log_every", "2"]
    # (c)'s host half runs in a thread beside (a)'s subprocesses (the
    # host's f32 steps take ~10 s each; (a) times nothing)
    rng = np.random.default_rng(19)
    data = [(rng.standard_normal((32, 112, 112, 3)).astype(np.float32),
             rng.integers(0, 10572, 32)) for _ in range(2)]
    host_runs: dict = {}

    def parity_cfg(name):
        return TrainConfig(network="resnet_v1_50", stem="face",
                           num_classes=10572, global_batch=32, augment=False,
                           optimizer=name, dtype=torch.float32,
                           base_lr=_OPT_LR[name])

    def host_steps():
        for name in _OPT_LR:
            state, net = create_train_state(parity_cfg(name), 0, device="cpu")
            start = {k: v.detach().clone() for k, v in state.params.items()}
            # copies: on the host these arrays share the live tensors
            init = ({k: v.copy() for k, v in named_to_flat(
                {**state.params, **state.batch_stats}).items()},
                    state.classifier.detach().numpy().copy())
            step = make_train_step(net, parity_cfg(name), state)
            for x, y in data:
                state, m = step(state, x, y)
            host_runs[name] = (init, start, float(m["loss"]), {
                k: v.detach() for k, v in state.params.items()})

    import threading

    t1 = time.time()
    host_thread = threading.Thread(target=host_steps)
    host_thread.start()
    cli, distilling = {}, []
    alphas = (1.0, 0.5)
    try:
        # the three runs side by side: (a) times nothing
        runs = train_clis([[*args4, "--optimizer", name, "--base_lr",
                            str(lr)] for name, lr in _OPT_LR.items()],
                          timeout=600)
        for (name, lr), (step, logged, launches) in zip(_OPT_LR.items(),
                                                        runs):
            cli[name] = launches
            say(f"  (a) cli.train --optimizer {name} --base_lr {lr}: step "
                f"{step}, losses {[round(v, 4) for v in logged['loss']]}, "
                f"kernel 1 launches {launches} in {OPT_STEPS} steps")
            expect(step == OPT_STEPS and launches == OPT_STEPS,
                   f"{name}: step {step}, {launches} kernel 1 launches")
            expect(all(np.isfinite(logged["loss"])), f"{name} losses")
        say(f"  (a) the three runs side by side: {time.time() - t1:.1f} s")
        # (e)'s distillation runs (untimed) beside the rest of (c)'s host
        # steps, (c) and (d)
        t_e = time.time()
        distilling = [start_train_cli(
            [*args4, "--distill_from", teacher_dir, "--distill_network",
             "resnet_v1_50", "--distill_alpha", str(alpha)])
            for alpha in alphas]
    finally:
        host_thread.join()
    try:
        expect(host_runs.keys() == _OPT_LR.keys(), "the host's parity steps")
        # 2 f32 steps at batch 32, the card's from the host's initial state
        parity = {}
        for name in _OPT_LR:
            (flat, cls), start, host_loss, host = host_runs[name]
            card, cnet = create_train_state(parity_cfg(name), 0,
                                            variables=flat,
                                            classifier=cls, device="cuda")
            step = make_train_step(cnet, parity_cfg(name), card)
            for x, y in data:
                card, cm = step(card, x, y)
            # the Dense bias ahead of the head's BatchNorm has no gradient in
            # exact arithmetic: its update is rounding noise, read apart
            noise = bt.NOISE_ONLY
            worst, leaf = _rel_update_diff(
                {k: v.detach().cpu() for k, v in card.params.items()
                 if k != noise},
                {k: v for k, v in host.items() if k != noise}, start)
            noise_rel, _ = _rel_update_diff(
                {noise: card.params[noise].detach().cpu()},
                {noise: host[noise]}, start)
            loss_rel = abs(float(cm["loss"]) / host_loss - 1)
            parity[name] = worst
            say(f"  (c) {name}: 2 f32 steps at batch 32, card vs host: "
                f"largest per-leaf |card - host| / |update| {worst:.3g} "
                f"({leaf}; the noise-only {noise} {noise_rel:.3g}), loss "
                f"relative difference {loss_rel:.2g}")
            expect(loss_rel < 1e-3, f"{name}: card loss vs host {loss_rel}")
            expect(worst < _OPT_PARITY[name],
                   f"{name}: card vs host {worst} of {leaf}'s update > "
                   f"{_OPT_PARITY[name]}")
            del card, cnet
        del host_runs
        say(f"  (a), (c) {time.time() - t1:.1f} s")
        cfg4 = bt.config4()
        # exact resume under Adam: 4 straight steps against 2 + save +
        # restore into a fresh state + 2, cuDNN deterministic
        t1 = time.time()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            cfg = dataclasses.replace(cfg4, optimizer="adam", base_lr=1e-3)
            u8 = [(torch.randint(0, 256, (256, 120, 120, 3), generator=g,
                                 device="cuda", dtype=torch.uint8),
                   torch.randint(0, 10572, (256,), generator=g, device="cuda"))
                  for _ in range(4)]

            def run(state, net, batches):
                step = make_train_step(net, cfg, state)
                for x, y in batches:
                    state, _ = step(state, x, y)
                return state

            straight = run(*create_train_state(cfg, 0, device="cuda"), u8)
            want = _full_state(straight)
            del straight
            half, hnet = create_train_state(cfg, 0, device="cuda")
            half = run(half, hnet, u8[:2])
            ckpt = os.path.join(work, "adam_ckpt")
            shutil.rmtree(ckpt, ignore_errors=True)
            mgr = CheckpointManager(ckpt)
            mgr.maybe_save(half, force=True)
            del half, hnet
            fresh, fnet = create_train_state(cfg, 1, device="cuda")
            mgr.restore(fresh)
            got = _full_state(run(fresh, fnet, u8[2:]))
            diff = max((got[k] - want[k]).abs().max().item() for k in want)
            expect(got.keys() == want.keys(), "resumed state's tensors differ")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        say(f"  (d) Adam, 4 straight steps vs 2 + save + restore + 2 (cuDNN "
            f"deterministic): {len(want)} tensors incl. moments and step, max "
            f"|diff| {diff}; {time.time() - t1:.1f} s")
        expect(diff == 0, f"Adam resume max |diff| {diff}")
        del u8, want, got, fresh, fnet
        torch.cuda.empty_cache()
    except BaseException:
        kill_train_clis(distilling)
        raise
    # distillation from phase 12's trained checkpoint
    distill = {}
    runs = [finish_train_cli(s, 600) for s in distilling]
    say(f"  (e) cli.train --distill_from, both alphas side by side (with "
        f"(c) and (d)): {time.time() - t_e:.1f} s")
    # SGD's rate is phase 11's (config 4, the same step)
    rates = {}
    for name in _OPT_LR:
        cfg = dataclasses.replace(cfg4, optimizer=name,
                                  base_lr=_OPT_LR[name])
        r = bt.time_training(cfg, steps=8, warmup=2, profile_steps=1)
        rates[name] = r
        say(f"  (b) time_training {name}: {r['faces_per_sec']:.1f} faces/s "
            f"({r['faces_per_sec'] / single_faces_per_sec:.4f} x phase 11's "
            f"SGD {single_faces_per_sec:.1f}), {r['ms_per_step']:.2f} ms/step, "
            f"{r['device_ms_per_step']:.2f} device ms, idle "
            f"{r['idle_share']:.1%}, peak {r['peak_memory_gb']:.2f} GB")
        expect(np.isfinite(r["loss"]), f"{name} time_training loss")
        torch.cuda.empty_cache()
    for alpha, (step, logged, launches) in zip(alphas, runs):
        t1 = time.time()
        dl = logged.get("distill_loss", [])
        expect(step == OPT_STEPS and launches == OPT_STEPS,
               f"distill alpha {alpha}: step {step}, {launches} launches")
        expect(len(dl) == OPT_STEPS // 2 and (alpha < 1 or dl[-1] < dl[0]),
               f"distill alpha {alpha}: distill_loss {dl} not falling")
        expect((alpha < 1) == ("margin_loss" in logged),
               f"alpha {alpha}: margin_loss logged {'margin_loss' in logged}")
        distill[alpha] = {"launches": launches, "distill_loss": dl}
        timed = ""
        if alpha < 1:
            # timed at 0.5 only: its step computes the distill and the
            # margin loss, a superset of alpha 1's
            cfg = dataclasses.replace(cfg4, distill_alpha=alpha)
            teacher = build_teacher(cfg, teacher_dir)
            r = bt.time_training(cfg, steps=8, warmup=2, profile_steps=1,
                                 teacher=teacher)
            del teacher
            torch.cuda.empty_cache()
            distill[alpha]["faces_per_sec"] = r["faces_per_sec"]
            timed = (f"; time_training {r['faces_per_sec']:.1f} faces/s "
                     f"({r['faces_per_sec'] / single_faces_per_sec:.4f} x "
                     f"phase 11's config 4), {r['device_ms_per_step']:.2f} "
                     f"device ms, peak {r['peak_memory_gb']:.2f} GB; "
                     f"time_training {time.time() - t1:.1f} s")
        say(f"  (e) distill alpha {alpha} from {os.path.relpath(teacher_dir, ROOT)}: "
            f"cli.train {OPT_STEPS} steps, distill_loss "
            f"{[round(v, 4) for v in dl]}, "
            f"kernel 1 launches {launches}{timed}")
    total = time.time() - t0
    say(f"  phase 19: {total:.1f} s; {gpu}")
    return {"cli_launches": cli, "rates": {k: v["faces_per_sec"]
                                           for k, v in rates.items()},
            "parity": parity, "resume_max_diff": diff, "distill": distill,
            "seconds": total}


# ---- phases 20-21: the data layer and the daemon ---------------------------

LFW_PAIRS = 6000            # LFW's 10 folds of 600 pairs: 12,000 faces
LFW_PNG = (5, 777, 11_999)  # entries a .bin stores as PNG (some do)
GALLERY_ROWS = 1_000_000    # the daemon's distractor gallery


def _smooth_faces(g, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) u8 synthetic faces: a random 7x7 image
    upsampled bilinearly plus noise (about 6 KB a face as a q95 JPEG)."""
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(0, n, 2048):
        m = min(2048, n - i)
        low = torch.rand((m, 3, 7, 7), generator=g, device="cuda") * 255
        x = torch.nn.functional.interpolate(low, size=(size, size),
                                            mode="bilinear",
                                            align_corners=False)
        x = x + 6 * torch.randn(x.shape, generator=g, device="cuda")
        out[i:i + m] = (x.clamp(0, 255).round().to(torch.uint8)
                        .permute(0, 2, 3, 1).cpu().numpy())
    return out


def _encode(images, fmt: str = "JPEG") -> list:
    """Encoded bytes of each image (PIL, threads)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def one(img):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt, **({"quality": 95}
                                                if fmt == "JPEG" else {}))
        return buf.getvalue()

    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, images))


def _write_rec(path: str, blobs: list, idents: list) -> None:
    """An InsightFace-layout MXNet ``.rec`` and its ``.idx``: meta record
    0, the image records (IRHeader with a scalar or a 2-float label, one
    record split in three frames), identity index rows at the tail."""
    import struct

    magic = 0xCED7230A

    def ir(flag, label, content):
        if flag == 0:
            return struct.pack("<IfQQ", 0, float(label), 0, 0) + content
        return (struct.pack("<IfQQ", flag, 0.0, 0, 0)
                + np.asarray(label, "<f4").tobytes() + content)

    def frames(payload, split=False):
        parts = ([payload[:40], payload[40:80], payload[80:]] if split
                 else [payload])
        out = b""
        for k, part in enumerate(parts):
            cflag = 0 if len(parts) == 1 else (1, 2, 3)[k]
            pad = (4 - len(part) % 4) % 4
            out += (struct.pack("<II", magic, cflag << 29 | len(part)) + part
                    + b"\0" * pad)
        return out

    n, ids = len(blobs), sorted(set(idents))
    records = [ir(2, [n + 1, n + 1 + len(ids)], b"")]
    for i, (blob, ident) in enumerate(zip(blobs, idents)):
        records.append(ir(0, ident, blob) if i % 2 else
                       ir(2, [ident, 0.0], blob))
    for ident in ids:
        first = 1 + idents.index(ident)
        records.append(ir(2, [first, first + idents.count(ident)], b""))
    offset = 0
    with open(path, "wb") as rec, open(path[:-4] + ".idx", "w") as idx:
        for key, payload in enumerate(records):
            data = frames(payload, split=key == 3)
            idx.write(f"{key}\t{offset}\n")
            rec.write(data)
            offset += len(data)


def _write_tfrecord(path: str, blobs: list, labels: list) -> None:
    """tf.train.Example records ({image/encoded, image/label}) in TFRecord
    framing with both masked CRC32Cs, written without TensorFlow."""
    import struct

    from tf_face_toolbox_tpu_torch.data.tfrecord import masked_crc32c

    def varint(v):
        v &= (1 << 64) - 1
        out = bytearray()
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num, payload):
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    with open(path, "wb") as f:
        for blob, label in zip(blobs, labels):
            feats = (field(1, field(1, b"image/encoded")
                           + field(2, field(1, field(1, blob))))
                     + field(1, field(1, b"image/label")
                             + field(2, field(3, field(1, varint(label))))))
            raw = field(1, feats)
            length = struct.pack("<Q", len(raw))
            f.write(length + struct.pack("<I", masked_crc32c(length)) + raw
                    + struct.pack("<I", masked_crc32c(raw)))


def _shard_records(path: str) -> tuple[list, list]:
    from tf_face_toolbox_tpu_torch.data.format import ShardReader, read_index

    reader = ShardReader(read_index(path))
    n = reader.index.count
    return ([reader.blob(i) for i in range(n)],
            [int(reader.label(i)) for i in range(n)])


def phase_data_layer(g, work: str, overlap=None) -> dict:
    """Phase 20: the importers, merge and bundle export on synthetic
    inputs at LFW's counts, then the imported LFW through cli.extract
    --engine fused (phase 12's checkpoint, and the bundle exported from
    it) and cli.eval_lfw. ``overlap(bundle, faces)`` runs while the two
    extractions do (they time nothing); its result is returned as
    ``side``, and a daemon it started is stopped if this phase fails."""
    import pickle
    import shutil

    from tf_face_toolbox_tpu_torch import bench

    t0 = time.time()
    say(f"[20 data layer] {bench.gpu_info()}")
    d = os.path.join(work, "data20")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    run = os.path.join(work, "ckpt_run")

    # the bundle export (host only) runs while the inputs are made
    bundle = os.path.join(d, "r50.bundle.npz")
    export = _cli("export", "--checkpoint_dir", run, "--output", bundle,
                  "--crop_from", "112")  # aligned 112x112 faces: no resize
    # the inputs: an InsightFace-layout lfw.bin (12,000 112x112 faces, 3
    # of them PNG; entries as bytes and as 1-D uint8 arrays), a .rec of
    # 200 faces of 40 sparse identities, two TFRecord files of 100 each
    faces = _smooth_faces(g, 2 * LFW_PAIRS, 112)
    blobs = _encode(faces)
    for i in LFW_PNG:
        blobs[i] = _encode(faces[i:i + 1], "PNG")[0]
    issame = [i % 2 == 0 for i in range(LFW_PAIRS)]
    bin_path = os.path.join(d, "lfw.bin")
    with open(bin_path, "wb") as f:
        pickle.dump(([np.frombuffer(b, np.uint8) if i % 3 == 0 else b
                      for i, b in enumerate(blobs)], issame), f, protocol=4)
    small = _encode(_smooth_faces(g, 400, 112))
    rec_ids = [1000 + 7 * (i // 5) for i in range(200)]
    rec_path = os.path.join(d, "train.rec")
    _write_rec(rec_path, small[:200], rec_ids)
    tf_labels = [(13 * i) % 50 for i in range(200)]
    tf_paths = [os.path.join(d, f"train-{k:05d}.tfrecord") for k in range(2)]
    for k, p in enumerate(tf_paths):
        _write_tfrecord(p, small[200 + 100 * k:300 + 100 * k],
                        tf_labels[100 * k:100 * (k + 1)])
    made_s = time.time() - t0

    # the importers side by side (none uses the card); the imported LFW's
    # two extractions (the checkpoint and its bundle, through kernel 2)
    # start once the .bin and the bundle are written, beside the rest
    lfw = os.path.join(d, "lfw.faceshard")
    rec_shard = os.path.join(d, "rec.faceshard")
    tf_shard = os.path.join(d, "tf.faceshard")
    merged = os.path.join(d, "merged.faceshard")
    t1 = time.time()
    importers = [
        _cli("import_bin", "--bin", bin_path, "--output", lfw),
        _cli("import_rec", "--rec", rec_path, "--output", rec_shard),
        _cli("convert_tfrecord", "--tfrecords", ",".join(tf_paths),
             "--output", tf_shard)]
    out = [_cli_done(importers[0])[-1], _cli_done(export)[-1]]
    e_ckpt = os.path.join(d, "lfw_ckpt.npy")
    e_bundle = os.path.join(d, "lfw_bundle.npy")
    common = ["--data", lfw, "--engine", "fused", "--batch", "256",
              "--device", "cuda"]
    t_extract = time.time()
    started = [_cli("extract", "--checkpoint_dir", run, "--crop_from", "112",
                    "--output", e_ckpt, *common),
               _cli("extract", "--bundle", bundle, "--output", e_bundle,
                    *common)]
    side = None
    try:
        out += [_cli_done(s)[-1] for s in importers[1:]]
        want = [f"imported {2 * LFW_PAIRS} images / {LFW_PAIRS} pairs into "
                f"{lfw} ({len(LFW_PNG)} transcoded to JPEG)",
                f"imported 200 images / 40 identities into {rec_shard}",
                f"converted 200 records into {tf_shard}"]
        expect([out[0], *out[2:]] == want, f"importers printed {out}")
        expect(out[1].startswith("exported resnet_v1_50 (step=20, "
                                 "quant=none, ema=False, ")
               and out[1].endswith(bundle), f"cli.export printed {out[1]}")
        line = _cli_done(_cli("merge", "--inputs", f"{rec_shard},{tf_shard}",
                              "--output", merged, "--relabel"))[-1]
        expect(line == f"merged 2 shards (400 records) into {merged}",
               f"cli.merge printed {line}")
        import_s = time.time() - t1

        # every shard's records and labels against the inputs
        got, labels = _shard_records(lfw)
        expect(labels == list(range(2 * LFW_PAIRS)), "lfw shard labels")
        jpegs = [i for i in range(len(blobs)) if i not in LFW_PNG]
        expect(all(got[i] == blobs[i] for i in jpegs),
               "lfw shard: a JPEG entry not carried verbatim")
        from tf_face_toolbox_tpu_torch.data.pipeline import _decode_jpeg
        png_err = max(int(np.abs(_decode_jpeg(got[i]).astype(int)
                                 - faces[i]).max()) for i in LFW_PNG)
        expect(all(got[i][:2] == b"\xff\xd8" for i in LFW_PNG)
               and png_err <= 8, f"PNG entries: transcoded max |diff| "
                                 f"{png_err}")
        with open(lfw + ".pairs.txt") as f:
            rows = [tuple(map(int, ln.split())) for ln in f
                    if ln.strip() and not ln.startswith("#")]
        expect(rows == [(2 * i, 2 * i + 1, int(s))
                        for i, s in enumerate(issame)], "lfw pairs file")
        dense = {ident: k for k, ident in enumerate(dict.fromkeys(rec_ids))}
        expect(_shard_records(rec_shard) == (small[:200],
                                             [dense[i] for i in rec_ids]),
               "rec shard records/labels")
        with open(rec_shard + ".labels.json") as f:
            expect(json.load(f) == {str(k): v for k, v in dense.items()},
                   "rec label map")
        expect(_shard_records(tf_shard) == (small[200:], tf_labels),
               "tfrecord shard records/labels")
        expect(_shard_records(merged) == (
            small, [dense[i] for i in rec_ids] + [v + 40 for v in tf_labels]),
            "merged shard records/labels")
        say(f"  inputs: lfw.bin {os.path.getsize(bin_path) / 1e6:.1f} MB "
            f"({2 * LFW_PAIRS} faces, {LFW_PAIRS} pairs, {len(LFW_PNG)} "
            f"PNG), .rec 200 faces / 40 ids (+ .idx, a split record), 2 "
            f"TFRecords of 100; made in {made_s:.1f} s (cli.export beside). "
            f"import_bin, import_rec and convert_tfrecord side by side, then "
            f"merge (--relabel): {import_s:.1f} s; records and labels equal "
            f"the inputs (PNG transcoded within {png_err} of the source)")

        served = got[:256]      # the faces phase 21 sends its daemons
        if overlap is not None:
            side = overlap(bundle, served)
        launches = [_kernel2_launches("\n".join(_cli_done(s)))
                    for s in started]
        _check_lfw_extraction(e_ckpt, e_bundle, launches)
        extract_s = time.time() - t_extract
        report = json.loads("\n".join(_cli_done(_cli(
            "eval_lfw", "--embeddings", e_ckpt, "--pairs",
            lfw + ".pairs.txt"), 300)))
        expect(len(report["fold_accuracies"]) == 10, "eval_lfw report")
    except BaseException:
        for _, (proc, _, _) in (*importers, *started):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if side is not None:
            side["db"].stop()
        raise
    total = time.time() - t0
    say(f"  cli.extract --engine fused on the imported LFW ({2 * LFW_PAIRS} "
        f"faces, batch 256, crop_from 112): --checkpoint_dir (step 20) and "
        f"--bundle side by side (the checks above and phase 21's set-up "
        f"beside them), kernel 2 "
        f"launches {launches} (12 a batch of 256), max |diff| 0.0; "
        f"{extract_s:.1f} s; eval_lfw 10 "
        f"folds of {LFW_PAIRS // 10} pairs, accuracy "
        f"{report['accuracy_mean']:.4f} (random faces: means nothing)")
    say(f"  phase 20: {total:.1f} s")
    return {"bundle": bundle, "lfw": lfw, "bodies": served,
            "extract_launches": launches, "side": side,
            "seconds": total}


def _check_lfw_extraction(e_ckpt: str, e_bundle: str, launches: list):
    """Phase 20's two extractions of the imported LFW: finite unit rows,
    12 kernel 2 launches a batch of 256, and bit-equal outputs."""
    a, b = np.load(e_ckpt), np.load(e_bundle)
    batches = -(-2 * LFW_PAIRS // 256)
    expect(a.shape == (2 * LFW_PAIRS, 512) and np.isfinite(a).all()
           and np.abs(np.linalg.norm(a, axis=1) - 1).max() < 1e-4,
           f"lfw embeddings {a.shape}")
    expect(launches == [12 * batches] * 2,
           f"kernel 2 launched {launches}, want {12 * batches} each")
    diff = float(np.abs(a - b).max())
    expect(diff == 0.0, f"extract --bundle differs from --checkpoint_dir "
                        f"by {diff}")


class _Daemon:
    """cli.serve as a subprocess on the card (port 0 on localhost): its
    stdout read on a thread until ``serving on``; ``stop`` sends SIGTERM
    and waits for the drain."""

    def __init__(self, args: list):
        import tempfile
        import threading

        self.args = args
        self._err = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "tf_face_toolbox_tpu_torch.cli.serve",
             "--device", "cuda", "--port", "0", "--max_batch", "64", *args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=self._err, text=True)
        self.lines: list = []
        self.base = None
        self._up = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if line.startswith("serving on"):
                self._up.set()
        self._up.set()

    def stderr(self) -> str:
        self._err.seek(0)
        return self._err.read()

    def wait_serving(self, timeout: float = 300) -> None:
        self._up.wait(timeout)
        up = [ln for ln in self.lines if ln.startswith("serving on")]
        expect(bool(up), f"cli.serve {' '.join(self.args)} did not come up: "
                         f"{self.lines[-5:]}\n{self.stderr()[-3000:]}")
        self.base = up[0].split("serving on ")[1].split()[0]

    def term(self) -> None:
        """SIGTERM: the drain starts; ``stop`` waits for its end."""
        if self.proc.poll() is None:
            self.proc.send_signal(15)

    def stop(self, timeout: float = 120) -> tuple[int, list]:
        self.term()
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode, self.lines

    def expect_drained(self, topk: int, topk_q: int) -> None:
        rc, lines = self.stop()
        expect(rc == 0 and lines[-2:] == [
            f"kernel launches: topk={topk} topk_q={topk_q}", "drained; bye"],
            f"cli.serve {' '.join(self.args)} exited {rc}: {lines[-3:]}\n"
            f"{self.stderr()[-2000:]}")


def _http(base: str, method: str, path: str, body: bytes | None = None,
          headers: dict | None = None, timeout: float = 120):
    """One request on a new connection -> (status, the JSON payload or the
    array of an npy reply, seconds in all, seconds to connect)."""
    import http.client
    import io
    from urllib.parse import urlsplit

    where = urlsplit(base)
    conn = http.client.HTTPConnection(where.hostname, where.port,
                                      timeout=timeout)
    try:
        t = time.perf_counter()
        conn.connect()
        t_conn = time.perf_counter() - t
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        raw = r.read()
        dt = time.perf_counter() - t
        status, ctype = r.status, r.getheader("Content-Type")
    finally:
        conn.close()
    if ctype == "application/x-npy":
        return status, np.load(io.BytesIO(raw), allow_pickle=False), dt, t_conn
    return status, json.loads(raw), dt, t_conn


def _npy_bytes(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _ok(reply, what: str):
    status, payload = reply[:2]
    expect(status == 200, f"{what}: HTTP {status} {payload}")
    return payload


def _pcts(seconds: list) -> dict:
    ms = np.sort(np.asarray(seconds)) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "n": len(ms)}


def _enroll(base: str, bodies: list) -> None:
    """Sequential /enroll of each body, its index the label."""
    for i, body in enumerate(bodies):
        _ok(_http(base, "POST", f"/enroll?label={i}", body), "/enroll")


def _identify(base: str, bodies: list, k: int = 5):
    """For each body, one after the other: its /embed row (one face a
    device call, as its /identify's) and its /identify matches ->
    (probes (n, D), labels (n, k), scores (n, k), /identify seconds)."""
    probes, labels, scores, secs = [], [], [], []
    for body in bodies:
        probes.append(_ok(_http(base, "POST", "/embed", body),
                          "/embed")["embedding"])
        reply = _http(base, "POST", f"/identify?k={k}", body)
        matches = _ok(reply, "/identify")["matches"]
        labels.append([m["label"] for m in matches])
        scores.append([m["score"] for m in matches])
        secs.append(reply[2])
    return (np.asarray(probes, np.float32), np.asarray(labels),
            np.asarray(scores, np.float32), secs)


def daemon_setup(g, work: str, bundle: str, bodies: list) -> dict:
    """Phase 21's set-up, run while phase 20's extractions (which time
    nothing) run: (a) the bundle against the checkpoint, the f32 module
    path's embeddings of the served faces on the card, the 10^6-row
    gallery snapshot, and the f32 daemon (b) started (not waited for)."""
    import shutil

    from tf_face_toolbox_tpu_torch.interop.port import flatten_variables
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving.bundle import read_bundle
    from tf_face_toolbox_tpu_torch.serving.server import EmbeddingService

    t0 = time.time()
    d = os.path.join(work, "daemon21")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    run = os.path.join(work, "ckpt_run")

    # (a) the bundle holds the checkpoint's step-20 variables, bit for bit
    variables, meta = read_bundle(bundle)
    flat = flatten_variables(variables)
    net32, want = load_variables(run, "resnet_v1_50", 512, 112,
                                 torch.float32)
    expect(meta["step"] == 20 and meta["crop_from"] == 112
           and (meta["stem"], meta["head_variant"]) == ("face", "gap"),
           f"bundle meta {meta}")
    expect(sorted(flat) == sorted(want)
           and all(np.array_equal(flat[k], want[k]) for k in want),
           "bundle variables differ from load_variables(step 20)")

    # the served faces (phase 20's imported JPEGs) through the f32 module
    # path on the card: the reference of every served embedding
    ref_svc = EmbeddingService(net32, want, image_size=112, crop_from=112,
                               batch=64, dtype=torch.float32, device="cuda")
    decoded = np.stack([ref_svc.decode_request(b) for b in bodies])
    ref = np.concatenate([ref_svc.embed_batch(decoded[i:i + 64])
                          for i in range(0, len(decoded), 64)])
    del ref_svc
    torch.cuda.empty_cache()
    rows = unit_rows(g, GALLERY_ROWS, 512).cpu().numpy()
    labels = np.arange(GALLERY_ROWS, 2 * GALLERY_ROWS)
    snap = os.path.join(d, "gallery_1m.npz")
    np.savez(snap, embeddings=rows, labels=labels)
    # the daemons save their gallery on drain (a new file renamed over
    # the path): each gets its own link to the distractor snapshot
    snaps = {}
    for tag in ("f32", "int8"):
        snaps[tag] = os.path.join(d, f"gallery_{tag}.npz")
        os.link(snap, snaps[tag])
    setup_s = time.time() - t0
    db = _Daemon(["--bundle", bundle, "--gallery", snaps["f32"],
                  "--gallery_dtype", "float32"])
    return {"dir": d, "meta": meta, "flat": flat, "n_arrays": len(flat),
            "decoded": decoded, "ref": ref, "rows": rows, "labels": labels,
            "snaps": snaps, "db": db, "db_started": time.time(),
            "setup_s": setup_s}


def phase_daemon(g, work: str, data: dict, folded_faces_per_sec: float
                 ) -> dict:
    """Phase 21: the daemon at full width (resnet_v1_50, face stem, 512-d,
    bf16, --engine auto = folded, --max_batch 64) booted from phase 20's
    bundle of phase 12's checkpoint, its 1:N endpoints over 10^6 rows
    through kernels 3 and 4, a hot reload, the drain. Its set-up and the
    first daemon's boot ran during phase 20 (``daemon_setup``)."""
    import importlib.util
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import quote

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery
    from tf_face_toolbox_tpu_torch.serving.server import EmbeddingService

    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[21 daemon] {gpu}")
    run = os.path.join(work, "ckpt_run")
    bundle = data["bundle"]
    side = data["side"]
    d, meta, flat = side["dir"], side["meta"], side["flat"]
    decoded, ref, snaps = side["decoded"], side["ref"], side["snaps"]
    rows, distractor_labels = side["rows"], side["labels"]
    bodies = data["bodies"]
    say(f"  (a) bundle {os.path.getsize(bundle) / 1e6:.1f} MB: "
        f"{side['n_arrays']} arrays equal to the step-20 checkpoint's; "
        f"cli.extract --bundle equals --checkpoint_dir (phase 20); set-up "
        f"(the f32 module path's 256 faces, the {GALLERY_ROWS:,}-row "
        f"snapshot) {side['setup_s']:.1f} s during phase 20")

    def centered_cos(a, b):
        mean = b.mean(0, keepdims=True)
        x, y = a - mean, b - mean
        return (x * y).sum(1) / (np.linalg.norm(x, axis=1)
                                 * np.linalg.norm(y, axis=1))

    db = side["db"]
    daemons = [db]
    try:
        # ---- (b) the f32 gallery (started during phase 20)
        t1 = time.time()
        db.wait_serving()
        boot_s = time.time() - side["db_started"]
        # 256 single /embed requests from 32 clients, after a first wave
        # of 64 (connections, handler threads, the batcher's first calls)
        with ThreadPoolExecutor(32) as ex:
            for r in ex.map(lambda b: _http(db.base, "POST", "/embed", b),
                            bodies[:64]):
                _ok(r, "/embed")
            before = _ok(_http(db.base, "GET", "/stats"), "/stats")
            replies = list(ex.map(
                lambda b: _http(db.base, "POST", "/embed", b), bodies))
        single = np.asarray([_ok(r, "/embed")["embedding"] for r in replies],
                            np.float32)
        single_lat = _pcts([r[2] for r in replies])
        slowest = sorted(range(len(replies)), key=lambda i: -replies[i][2])[:3]
        stats = _ok(_http(db.base, "GET", "/stats"), "/stats")
        calls = stats["device_calls"] - before["device_calls"]
        expect(stats["requests"] - before["requests"] == len(bodies)
               and calls < len(bodies),
               f"/stats after {len(bodies)} requests: {stats}")
        # one /embed_batch of the same faces, a binary .npy reply
        reply = _http(db.base, "POST", "/embed_batch", _npy_bytes(decoded),
                      {"Accept": "application/x-npy"})
        bulk = _ok(reply, "/embed_batch")
        bulk_s = reply[2]
        expect(bulk.shape == (len(bodies), 512) and bulk.dtype == np.float32,
               f"/embed_batch {bulk.shape} {bulk.dtype}")
        row_diff = float(np.abs(single - bulk).max())
        cos = (single * ref).sum(1)
        cen = centered_cos(single, ref)
        say(f"  (b) cli.serve --bundle (bf16, folded, b64) with a "
            f"{GALLERY_ROWS:,}-row f32 gallery: up {boot_s:.1f} s after its "
            f"start; "
            f"{len(bodies)} /embed from 32 clients in {calls} device calls "
            f"(slowest: " + ", ".join(
                f"#{i} {replies[i][2] * 1e3:.1f} ms (connect "
                f"{replies[i][3] * 1e3:.1f})" for i in slowest)
            + f"); each equals its /embed_batch row "
            f"to {row_diff:.3g}; vs the f32 module path min cosine "
            f"{cos.min():.6f} (batch-centered {cen.min():.4f})")
        expect(row_diff <= 1e-6, f"/embed vs /embed_batch rows {row_diff}")
        expect(cos.min() >= 0.999, f"served vs f32 module cosine {cos.min()}")
        # /enroll 128, /deenroll one, /identify the 128 at k 5
        n_id = 128
        _enroll(db.base, bodies[:n_id])
        removed = _ok(_http(db.base, "POST", "/deenroll?label=5"),
                      "/deenroll")
        expect(removed["removed"] == 1
               and removed["size"] == GALLERY_ROWS + n_id - 1,
               f"/deenroll {removed}")
        probes, labels, scores, id_secs = _identify(db.base, bodies[:n_id])
        # (c) and (d) boot while (b)'s untimed checks and drain run
        t_cd = time.time()
        reload_dir = os.path.join(d, "reload_run")
        os.makedirs(reload_dir)
        shutil.copytree(os.path.join(run, "10"),
                        os.path.join(reload_dir, "10"))
        dc = _Daemon(["--bundle", bundle, "--gallery", snaps["int8"],
                      "--gallery_dtype", "int8"])
        dd = _Daemon(["--checkpoint_dir", reload_dir, "--crop_from", "112",
                      "--watch_interval", "1"])
        daemons += [dc, dd]
        own = labels[:, 0] == np.arange(n_id)
        expect(own[np.arange(n_id) != 5].all() and 5 not in labels[5],
               f"/identify top-1 {labels[:, 0].tolist()}")
        saved = os.path.join(d, "saved.npz")
        _ok(_http(db.base, "POST", f"/gallery/save?path={quote(saved)}"),
            "/gallery/save")
        with np.load(saved) as snap:
            emb_saved, lab_saved = snap["embeddings"], snap["labels"]
        live = [i for i in range(n_id) if i != 5]
        expect(np.array_equal(lab_saved[:GALLERY_ROWS], distractor_labels)
               and np.array_equal(emb_saved[:GALLERY_ROWS], rows)
               and lab_saved[GALLERY_ROWS:].tolist() == live
               and np.array_equal(emb_saved[GALLERY_ROWS:], probes[live]),
               "/gallery/save: the snapshot is not the live rows")
        plain = DeviceGallery(512, dtype="float32", device="cuda")
        plain.use_kernels = False
        plain.enroll(emb_saved, lab_saved)
        pl, ps = plain.search(probes, k=6)
        del plain
        torch.cuda.empty_cache()
        near = near_ties(ps, 5)
        same = (labels == pl[:, :5]) | near
        score_err = float(np.abs(scores - ps[:, :5]).max())
        say(f"  (b) /enroll {n_id}, /deenroll 5, /identify {n_id} at k 5 "
            f"over {GALLERY_ROWS + n_id - 1:,} rows (kernel 3): top-1 is "
            f"each face's own label (5 gone); /gallery/save equals the live "
            f"rows; vs the plain programs on the snapshot: labels equal "
            f"({int(near.sum())} near-tie positions), max |score diff| "
            f"{score_err:.3g}")
        expect(same.all(), "identify labels differ from the plain programs")
        expect(score_err <= TOPK_TOL, f"identify scores differ by {score_err}")
        db.term()       # it drains (and saves 2 GB) while (c) runs
        b_s = t_cd - t1

        # ---- (c) the int8 gallery and (d) the hot reload
        dc.wait_serving()
        dd.wait_serving()
        n_q = 32
        _enroll(dc.base, bodies[:n_q])
        q_probes, q_labels, q_scores, _ = _identify(dc.base, bodies[:n_q])
        # the daemon's rows: the distractors and the /embed rows ((b)
        # showed an enrolled row is the /embed row of its face)
        plain = DeviceGallery(512, dtype="int8", device="cuda")
        plain.use_kernels = False
        plain.enroll(rows, distractor_labels)
        plain.enroll(q_probes, np.arange(n_q))
        ql, qs = plain.search(q_probes, k=5)
        del plain
        torch.cuda.empty_cache()
        q_err = float(np.abs(q_scores - qs).max())
        say(f"  (c) int8 gallery ({GALLERY_ROWS + n_q:,} rows, kernel 4 + "
            f"the exact rescore): /identify {n_q} at k 5: top-1 own label "
            f"{int((q_labels[:, 0] == np.arange(n_q)).sum())}/{n_q}; vs the "
            f"plain int8 programs: labels equal "
            f"{bool(np.array_equal(q_labels, ql))}, max |score diff| "
            f"{q_err:.3g}")
        expect((q_labels[:, 0] == np.arange(n_q)).all(), "int8 top-1")
        expect(np.array_equal(q_labels, ql) and q_err <= 1e-6,
               "int8 /identify differs from the plain int8 programs")
        db.expect_drained(topk=n_id, topk_q=0)
        dc.term()

        # (d) hot reload under traffic: step 10 -> 20
        health = _ok(_http(dd.base, "GET", "/healthz"), "/healthz")
        expect(health["serving_step"] == 10, f"/healthz {health}")
        statuses: list = []
        stop = threading.Event()

        def client(i):
            k = i
            while not stop.is_set():
                try:
                    statuses.append(_http(dd.base, "POST", "/embed",
                                          bodies[k % len(bodies)])[0])
                except OSError as e:        # refused, reset: a failure
                    statuses.append(repr(e))
                k += 4

        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(4)]
        for c in clients:
            c.start()
        time.sleep(1.0)
        tmp = os.path.join(reload_dir, ".20.tmp")
        shutil.copytree(os.path.join(run, "20"), tmp)
        os.rename(tmp, os.path.join(reload_dir, "20"))
        t_new = time.time()
        step = 10
        while step != 20 and time.time() - t_new < 120:
            time.sleep(0.1)
            step = _ok(_http(dd.base, "GET", "/healthz"),
                       "/healthz")["serving_step"]
        reload_s = time.time() - t_new
        time.sleep(0.5)
        stop.set()
        for c in clients:
            c.join(timeout=60)
        served = _ok(_http(dd.base, "POST", "/embed_batch",
                           _npy_bytes(decoded[:64]),
                           {"Accept": "application/x-npy"}), "/embed_batch")
        stats_d = _ok(_http(dd.base, "GET", "/stats"), "/stats")
        rcos = (served * ref[:64]).sum(1)
        failed = [s for s in statuses if s != 200]
        say(f"  (d) --checkpoint_dir at step 10, --watch_interval 1: step 20 "
            f"copied in under 4 clients' traffic, /healthz read step 20 "
            f"{reload_s:.1f} s later (bound 120 s); {len(statuses)} requests, "
            f"{len(failed)} failed; after it, vs step 20's f32 module path "
            f"min cosine {rcos.min():.6f}; /stats reloads "
            f"{stats_d['reloads']}")
        expect(step == 20, "no hot reload within 120 s")
        expect(not failed and len(statuses) > 0, f"failed requests {failed}")
        expect(stats_d["reloads"] == 1 and stats_d["serving_step"] == 20,
               f"/stats {stats_d}")
        expect(rcos.min() >= 0.999, f"reloaded cosine {rcos.min()}")
        dd.expect_drained(topk=0, topk_q=0)
        dc.expect_drained(topk=0, topk_q=n_q)
        cd_s = time.time() - t_cd
    finally:
        for dmn in daemons:
            dmn.stop()

    # ---- (e) gRPC, where grpc is installed
    if importlib.util.find_spec("grpc") is None:
        grpc_note = "not installed on this machine"
        say("  (e) gRPC: grpc is not installed on this machine; the gRPC "
            "transport is held by the CPU tests alone "
            "(tests/test_torch_serve.py)")
    else:
        from tf_face_toolbox_tpu_torch.serving import make_serving_apply
        from tf_face_toolbox_tpu_torch.serving.bundle import network_from_meta
        from tf_face_toolbox_tpu_torch.serving.grpc_server import (
            GrpcEmbeddingClient, serve_grpc)
        from tf_face_toolbox_tpu_torch.serving.server import DynamicBatcher

        net = network_from_meta(meta, dtype=torch.bfloat16)
        svc = EmbeddingService(net, flat, image_size=112, crop_from=112,
                               batch=64, apply_fn=make_serving_apply(
                                   net, flat, device="cuda"),
                               dtype=torch.bfloat16, device="cuda")
        svc.warmup()
        batcher = DynamicBatcher(svc)
        server = serve_grpc(batcher, port=0)
        client = GrpcEmbeddingClient(f"127.0.0.1:{server.bound_port}")
        try:
            g_rows = np.stack([client.embed(b) for b in bodies[:8]])
            g_bulk = client.embed_batch(decoded)
        finally:
            client.close()
            server.stop(grace=10).wait()
            batcher.close()
        g_diff = max(float(np.abs(g_rows - single[:8]).max()),
                     float(np.abs(g_bulk - bulk).max()))
        grpc_note = f"Embed and EmbedBatch vs HTTP's rows max |diff| {g_diff}"
        say(f"  (e) gRPC (in this process, the daemon's service): {grpc_note}")
        expect(g_diff <= 1e-6, f"gRPC rows differ from HTTP's by {g_diff}")

    # ---- (f) informational numbers
    identify = _pcts(id_secs)
    bulk_rate = len(bodies) / bulk_s
    total = time.time() - t0
    say(f"  (f) {gpu}: /embed_batch of {len(bodies)} faces (npy reply) "
        f"{bulk_s * 1e3:.1f} ms on the client's clock = {bulk_rate:.1f} "
        f"faces/s ({bulk_rate / folded_faces_per_sec:.3f} x phase 16's folded "
        f"resnet_v1_50 face-stem rate {folded_faces_per_sec:.1f}); single "
        f"/embed at 32 clients p50 {single_lat['p50']:.2f} ms, p99 "
        f"{single_lat['p99']:.2f} ms (client; /stats embed "
        f"{stats['latency_ms_by_endpoint']['embed']}); /identify over "
        f"{GALLERY_ROWS + n_id - 1:,} rows, one client, p50 "
        f"{identify['p50']:.2f} ms, p99 {identify['p99']:.2f} ms")
    say(f"  phase 21: {total:.1f} s ((b) to its "
        f"/identify {b_s:.1f}, then (b)'s checks and drain, (c) and (d) "
        f"{cd_s:.1f})")
    return {"launches": {"topk": n_id, "topk_q": n_q},
            "bulk_faces_per_sec": bulk_rate, "embed_latency_ms": single_lat,
            "identify_latency_ms": identify, "reload_s": reload_s,
            "grpc": grpc_note, "seconds": total,
            # for phase 22: (b)'s faces, answers and drained snapshot
            "bodies": bodies[:n_id], "identify": (labels, scores),
            "snap": snaps["f32"]}


SHARDED_ROWS = 4_000_000    # phase 22: one bf16 DeviceGallery at 3.2 GB refuses
SHARD_HBM_GB = 3.2          # its bound, a shard's and the one store's
SHARDS = 4                  # phase 22's shards, all on cuda:0
ZOO_EXTRACT = ("iresnet_100", "mobilefacenet")
ZOO_TRAIN = ("iresnet_50", "mobilefacenet")
ZOO_FACES = 1024


def _shard_major(group: np.ndarray, n_dev: int) -> np.ndarray:
    """Equal-score rows in the reference's merged order: a stable sort by
    (shard, local slot) = (row % n_dev, row // n_dev), on the host."""
    return group[np.lexsort((group // n_dev, group % n_dev))]


def _check_sharded(tag: str, got, want, plain, probe_labels, groups,
                   n_dev: int) -> dict:
    """A sharded search (``got``) against the one store's (``want``, k + 1
    columns) and its plain programs' (``plain``), each (labels, scores):
    scores within TOPK_TOL; labels equal away from near-ties and the
    planted groups; each planted group's four labels in shard-major order
    in ``got`` and ``plain`` and in row order in ``want``."""
    (gl, gs), (wl, ws), (pl, ps) = got, want, plain
    k = gl.shape[1]
    n_groups = len(groups)
    near = near_ties(ws, k)
    near[:n_groups] = True
    score_err = max(float(np.abs(gs - ws[:, :k]).max()),
                    float(np.abs(gs - ps).max()))
    for j, grp in enumerate(groups[:len(gl)]):
        expect(gl[j, :4].tolist() == pl[j, :4].tolist()
               == probe_labels[_shard_major(grp, n_dev)].tolist()
               and wl[j, :4].tolist() == probe_labels[np.sort(grp)].tolist(),
               f"{tag}: planted group {grp.tolist()}: sharded "
               f"{gl[j, :4].tolist()}, plain {pl[j, :4].tolist()}, one "
               f"store {wl[j, :4].tolist()}")
    expect((gl == wl[:, :k])[~near].all() and (gl == pl)[~near].all(),
           f"{tag}: labels differ from the one store's or the plain "
           "programs' away from near-ties")
    expect(score_err <= TOPK_TOL, f"{tag}: scores differ by {score_err}")
    return {"score_err": score_err, "near_ties": int(near[n_groups:].sum())}


def phase_sharded_gallery(g, work: str, data20: dict, daemon21: dict,
                          zoo: dict) -> dict:
    """Phase 22: DistributedGallery over [cuda:0] * 4 at 4 x 10^6 rows (bf16 and
    int8), kernels 3 and 4 on each shard, against one unbounded
    DeviceGallery and the plain programs; a tombstone, a compaction
    crossing and the snapshot; the sharded CLIs and daemon. Phase 23's,
    24's and 25's CLI runs (``zoo``, untimed) run beside its host work
    and end before its timings, phase 25's daemons serving by then."""
    import shutil

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.ops import topk as ttk
    from tf_face_toolbox_tpu_torch.serving.distributed_gallery import (
        DistributedGallery)
    from tf_face_toolbox_tpu_torch.serving.gallery import (
        DeviceGallery, GalleryCapacityError)

    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[22 sharded gallery] {gpu}")
    n, d, n_dev = SHARDED_ROWS, 512, SHARDS
    shards = [torch.device("cuda", 0)] * n_dev
    d22 = os.path.join(work, "sharded22")
    shutil.rmtree(d22, ignore_errors=True)
    os.makedirs(d22)
    secs = {}

    # the daemon over phase 21's snapshot (10^6 rows and 127 faces) with
    # --gallery_shards -1, booting beside the host work (it times nothing)
    snap21 = os.path.join(d22, "gallery_21.npz")
    os.link(daemon21["snap"], snap21)
    served = _Daemon(["--bundle", data20["bundle"], "--gallery", snap21,
                      "--gallery_shards", "-1"])

    # (a) 4 x 10^6 seeded unit rows made on the card, f32 on the host, labels
    # their indices: 8 groups of 4 equal rows in the first fifth (rows b,
    # b+1, b+2, b+5: shards 1, 2, 3, 2), the probes' rows after them, and
    # one label (-1) on the last four fifths (its removal crosses
    # compaction and leaves every earlier row where it was)
    fifth = n // 5
    rows = np.empty((n, d), np.float32)
    stage = torch.empty((1 << 20, d), pin_memory=True)   # fast read-back
    for i in range(0, n, 1 << 20):
        x = torch.randn((min(1 << 20, n - i), d), generator=g, device="cuda")
        m = x.shape[0]
        stage[:m].copy_(x / x.norm(dim=1, keepdim=True))
        torch.from_numpy(rows[i:i + m]).copy_(stage[:m])
    del stage
    groups = [b + np.array([0, 1, 2, 5])
              for b in fifth // 20 + 1 + fifth // 10 * np.arange(8)]
    for grp in groups:
        rows[grp[1:]] = rows[grp[0]]
    labels = np.arange(n, dtype=np.int64)
    labels[fifth:] = -1
    rng = np.random.default_rng(22)
    probe_idx = np.concatenate([[grp[0] for grp in groups], rng.choice(
        np.arange(fifth * 4 // 5, fifth), 56, replace=False)])
    probes = rows[probe_idx].copy()
    # the CLIs' inputs: the first 10^6 rows, 1,024 probes near them
    gal_npy, probe_npy = (os.path.join(d22, f) for f in ("gal.npy",
                                                        "probe.npy"))
    np.save(gal_npy, rows[:GALLERY_ROWS])
    near = rows[rng.choice(GALLERY_ROWS, 1024, replace=False)] + \
        0.05 * rng.standard_normal((1024, d)).astype(np.float32)
    np.save(probe_npy, near / np.linalg.norm(near, axis=1, keepdims=True))
    # 256 probes a batch: each run's (B, 10^6) scores and top-k keys stay
    # a few GB beside the other processes on the card
    searches = {flag: _cli("search", "--gallery", gal_npy, "--probe",
                           probe_npy, "--k", "5", "--probe_batch", "256",
                           "--output", os.path.join(d22, f"m{flag}.npz"),
                           "--device", "cuda",
                           *(["--data_parallel"] if flag else []))
                for flag in (0, 1)}
    secs["rows"] = time.time() - t0

    # (b) the bf16 store over four shards at 3.2 GB a shard; one store at
    # that bound refuses the same rows; the one unbounded store over them
    t = time.time()
    bf = DistributedGallery(d, devices=shards, dtype="bfloat16",
                            hbm_limit_gb=SHARD_HBM_GB)
    bf.enroll(rows, labels)
    secs["bf16 enroll"] = time.time() - t
    one = DeviceGallery(d, dtype="bfloat16", hbm_limit_gb=SHARD_HBM_GB,
                        device="cuda")
    try:
        one.enroll(rows, labels)
        refusal = None
    except GalleryCapacityError as e:
        refusal = str(e)
    one_gb = one._bytes_for(n) / 1e9
    del one, rows
    per_shard = bf.device_bytes() / n_dev
    say(f"  (b) {n:,} x {d} bf16 rows over {n_dev} shards on cuda:0 at "
        f"hbm_limit_gb={SHARD_HBM_GB:g}: {per_shard / 1e9:.2f} GB a shard, "
        f"{bf.device_bytes() / 1e9:.2f} GB in all, enrolled in "
        f"{secs['bf16 enroll']:.1f} s; one DeviceGallery at the same bound: "
        f"{refusal}")
    expect(refusal is not None and f"{one_gb:.2f} GB" in refusal,
           f"one bf16 store did not refuse {n:,} rows: {refusal}")
    expect(per_shard <= SHARD_HBM_GB * 1e9 < bf.device_bytes()
           and len(bf) == n,
           f"sharded store {per_shard} B a shard, {len(bf)} rows")
    t = time.time()
    ref = DeviceGallery(d, dtype="bfloat16", hbm_limit_gb=0, device="cuda")
    ref.enroll(bf._host[:n], bf._lab[:n])
    secs["bf16 one store"] = time.time() - t

    def run(gal, b, k):
        before = (ttk.cosine_topk.launches, ttk.cosine_topk_q.launches)
        out = gal.search(probes[:b], k=k)
        return out, (ttk.cosine_topk.launches - before[0],
                     ttk.cosine_topk_q.launches - before[1])

    def plain_of(gal, b, k):
        gal.use_kernels = False
        try:
            return gal.search(probes[:b], k=k)
        finally:
            gal.use_kernels = True

    checks, launches = {}, {"topk": 0, "topk_q": 0}

    def compare(tag, gal, one_store, b, removed=()):
        got, (lt, lq) = run(gal, b, 5)
        launches["topk"] += lt
        launches["topk_q"] += lq
        kern = (0, n_dev) if gal.dtype == "int8" else (n_dev, 0)
        expect((lt, lq) == kern, f"{tag} B={b}: launches topk {lt}, topk_q "
                                 f"{lq}, want {n_dev} (one a shard)")
        # bf16: the one store's top 6 shows a near-tie at rank 5; int8
        # searches the same coarse k (a wider one may pick other rows)
        want = one_store.search(probes[:b], k=5 if gal.dtype == "int8"
                                else 6)
        checks[f"{tag} B={b}"] = _check_sharded(
            f"{tag} B={b}", got, want, plain_of(gal, b, 5), labels, groups,
            n_dev)
        expect(not np.isin(got[0], removed).any(),
               f"{tag}: a removed label surfaced")

    for b in (1, 64):
        compare("bf16", bf, ref, b)

    # (c) the CLIs (side by side since (a)): cli.search --data_parallel
    # shards the 10^6 rows over the card's one device
    outs = {flag: _cli_done(run_, 600) for flag, run_ in searches.items()}
    m0, m1 = (np.load(os.path.join(d22, f"m{f}.npz")) for f in (0, 1))
    summ = [json.loads(outs[f][-1]) for f in (0, 1)]
    cli_err = float(np.abs(m0["scores"] - m1["scores"]).max())
    cli_near = near_ties(m0["scores"], 5)
    mean_diff = abs(summ[0].pop("top1_score_mean")
                    - summ[1].pop("top1_score_mean"))
    expect(summ[0].pop("output") != summ[1].pop("output")
           and mean_diff <= TOPK_TOL and summ[0] == summ[1],
           f"cli.search summaries {summ}")
    expect(cli_err <= TOPK_TOL
           and (m0["indices"] == m1["indices"])[~cli_near].all(),
           f"cli.search --data_parallel differs: max |score| {cli_err}")
    say(f"  (c) cli.search --data_parallel over {GALLERY_ROWS:,} rows and 1,024 "
        f"probes equals cli.search without it: the summary line, indices "
        f"away from near-ties ({int(cli_near.sum())}), scores within "
        f"{TOPK_TOL} (cuBLAS products of another shape: max |diff| "
        f"{cli_err:.3g})")

    # (d) the daemon over phase 21's snapshot with --gallery_shards -1:
    # /identify of phase 21's faces equals phase 21's answers
    served.wait_serving()
    bodies = daemon21["bodies"]
    answers = [_ok(_http(served.base, "POST", "/identify?k=5", b),
                   "/identify")["matches"] for b in bodies]
    s_labels = np.asarray([[m["label"] for m in a] for a in answers])
    s_scores = np.asarray([[m["score"] for m in a] for a in answers],
                          np.float32)
    w_labels, w_scores = daemon21["identify"]
    err21 = float(np.abs(s_scores - w_scores).max())
    expect((s_labels == w_labels)[~near_ties(w_scores, 5)].all()
           and err21 <= TOPK_TOL,
           f"--gallery_shards -1 /identify differs from phase 21's "
           f"(max |score diff| {err21})")
    served.expect_drained(topk=len(bodies), topk_q=0)
    say(f"  (d) cli.serve --bundle --gallery_shards -1 (one shard: the "
        f"card's one device) over phase 21's snapshot "
        f"({GALLERY_ROWS + 127:,} rows): /identify of its {len(bodies)} "
        f"faces equals phase 21's answers (max |score diff| {err21:.3g}); "
        f"drained with topk={len(bodies)}")

    # (f) the int8 store over four shards (kernel 4 a shard, then the
    # exact rescore) and the one unbounded int8 store, from the bf16
    # store's host master (one after the other: two host copies side by
    # side page slower than in turn); untimed, beside the CLI runs
    t = time.time()
    q8 = DistributedGallery(d, devices=shards, dtype="int8",
                            hbm_limit_gb=SHARD_HBM_GB)
    q8.enroll(bf._host[:n], bf._lab[:n])
    ref8 = DeviceGallery(d, dtype="int8", hbm_limit_gb=0, device="cuda")
    ref8.enroll(bf._host[:n], bf._lab[:n])
    secs["int8 stores"] = time.time() - t
    for b in (1, 64):
        compare("int8", q8, ref8, b)

    # phase 23's, 24's and 25's CLI runs end here, and phase 25's daemons
    # are up and idle: the card is this phase's from now on
    t = time.time()
    zoo["done"] = {name: collect(p, 900) for name, p in
                   zoo["extract"].items()}
    zoo["trained"] = {name: finish_train_cli(s, 900)
                      for name, s in zoo["train"].items()}
    zoo["t_done"] = time.time()
    secs["phase 23's CLIs (their wait)"] = zoo["t_done"] - t
    if "dct" in zoo:
        t = time.time()
        finish_dct_clis(zoo["dct"])
        secs["phase 24's CLIs (their wait)"] = zoo["dct"]["t_done"] - t
    if "int8" in zoo:
        t = time.time()
        finish_int8_clis(zoo["int8"])
        secs["phase 25's CLIs and daemons' boot (their wait)"] = (
            zoo["int8"]["t_done"] - t)
    if "item19" in zoo:
        t = time.time()
        finish_item19_clis(zoo["item19"])
        secs["phase 26's CLIs (their wait)"] = zoo["item19"]["t_done"] - t

    # (e) times with CUDA events: the sharded search (4 launches, the
    # merge, one read back) against the one store's
    times = {}

    def time_both(tag, gal, one_store):
        for b in (1, 64):
            times[f"{tag} B={b}"] = (
                bench.time_ms(lambda: gal.search(probes[:b], k=5), iters=10,
                              warmup=2),
                bench.time_ms(lambda: one_store.search(probes[:b], k=5),
                              iters=10, warmup=2))

    time_both("bf16", bf, ref)
    time_both("int8", q8, ref8)
    del ref, bf
    torch.cuda.empty_cache()
    say(f"  (e) bf16 and int8, B 1 and 64, k 5 (int8: coarse k 20, then "
        f"the rescore): each search launched kernel 3 or 4 once a shard; "
        f"labels and scores equal the one unbounded store's and the plain "
        f"programs' (max |score diff| "
        f"{max(c['score_err'] for c in checks.values()):.3g}; "
        f"{sum(c['near_ties'] for c in checks.values())} near-tie "
        f"positions); the 8 planted groups in shard-major order (a numpy "
        f"sort by (row % 4, row // 4) on the host), the one store's in row "
        f"order")
    for tag, (ms, one_ms) in times.items():
        say(f"  (e) {gpu}: {tag} k=5 over {n:,} rows: the sharded search "
            f"({n_dev} launches, the merge, one read back) {ms:.3f} ms, the "
            f"one store's {one_ms:.3f} ms ({ms / one_ms:.3f} x)")

    # (g) one label removed (a tombstone), then the label of the last
    # four fifths (a compaction crossing in both stores), each searched
    # again; the compacted store's snapshot loaded into a DeviceGallery
    one_label = int(labels[probe_idx[9]])
    for gal in (q8, ref8):
        expect(gal.remove(one_label) == 1, "remove one label")
    expect(q8._tomb == 1, f"tombstone: {q8._tomb}")
    compare("int8 tombstone", q8, ref8, 64, [one_label])
    t = time.time()
    expect(q8.remove(-1) == n - fifth and ref8.remove(-1) == n - fifth,
           "remove(-1)")
    secs["compaction"] = time.time() - t
    n2 = fifth - 1
    expect(q8._tomb == 0 and q8._n == n2 and ref8._tomb == 0,
           f"compaction: tomb {q8._tomb}, fill {q8._n}")
    compare("int8 compacted", q8, ref8, 64, [one_label, -1])
    snap = os.path.join(d22, "sharded.npz")

    def save_and_load():
        t_save = time.time()
        expect(q8.save(snap) == n2, "sharded save")
        secs["save"] = time.time() - t_save
        t_load = time.time()
        out = DeviceGallery.load(snap, dtype="int8", hbm_limit_gb=0,
                                 device="cuda")
        secs["load"] = time.time() - t_load
        return out

    # (h) beside the snapshot's save and load (neither times anything):
    # serve() in this process over DistributedGallery(devices=[cuda:0] *
    # 4), a scripted /enroll (507 past capacity), /identify, /deenroll,
    # /gallery sequence
    loading = _beside(save_and_load)
    daemon = _sharded_daemon(data20, daemon21, shards)
    launches["topk"] += daemon["launches"]
    loaded = loading()
    os.remove(snap)
    expect(len(loaded) == n2 and np.array_equal(loaded._lab[:n2],
                                                q8._lab[:n2])
           and np.array_equal(loaded._host[:n2], q8._host[:n2]),
           "the snapshot loaded into a DeviceGallery differs from the store")
    compare("int8 loaded", q8, loaded, 64, [one_label, -1])
    say(f"  (g) int8: one label removed (a tombstone, 1 dead row), then the "
        f"label of {n - fifth:,} rows (compaction in both stores, "
        f"{secs['compaction']:.1f} s), each searched again against the one "
        f"store and the plain programs; the compacted store ({n2:,} rows) "
        f"saved ({secs['save']:.1f} s) and loaded into a DeviceGallery "
        f"({secs['load']:.1f} s): its rows and labels equal the store's, "
        f"its searches the store's")
    del q8, ref8, loaded
    torch.cuda.empty_cache()
    total = time.time() - t0
    say("  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; phase 22: {total:.1f} s")
    return {"launches": launches, "times_ms": times, "checks": checks,
            "served_launches": len(bodies), "daemon": daemon,
            "seconds": total}


def _beside(fn):
    """``fn()`` started in a thread, beside this one's work (for runs that
    time nothing); → a function that waits for it and returns its result,
    or raises what it raised."""
    import threading

    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # re-raised by the waiter
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]

    return wait


def _sharded_daemon(data20: dict, daemon21: dict, shards: list) -> dict:
    """Phase 22 (h): the daemon's endpoints over a four-shard gallery, in
    this process (serve() over phase 20's bundle, bf16, folded)."""
    from tf_face_toolbox_tpu_torch.ops import topk as ttk
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply
    from tf_face_toolbox_tpu_torch.serving.bundle import network_from_meta
    from tf_face_toolbox_tpu_torch.serving.distributed_gallery import (
        DistributedGallery)
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery
    from tf_face_toolbox_tpu_torch.serving.server import (
        DynamicBatcher, EmbeddingService, serve)

    side = data20["side"]
    meta, flat = side["meta"], side["flat"]
    bodies = daemon21["bodies"][:9]
    net = network_from_meta(meta, dtype=torch.bfloat16)
    svc = EmbeddingService(net, flat, image_size=112, crop_from=112,
                           batch=64, apply_fn=make_serving_apply(
                               net, flat, device="cuda"),
                           dtype=torch.bfloat16, device="cuda")
    svc.warmup()
    batcher = DynamicBatcher(svc)
    # one-row blocks of 2,048 B: two rows a shard fit 5,000 B, three not
    gal = DistributedGallery(512, devices=shards, block=1,
                             hbm_limit_gb=5000e-9)
    server = serve(batcher, port=0, gallery=gal)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    before = ttk.cosine_topk.launches
    try:
        empty = _ok(_http(base, "GET", "/gallery"), "/gallery")
        _enroll(base, bodies[:8])
        over = _http(base, "POST", "/enroll?label=8", bodies[8])
        emb, got_l, got_s, _ = _identify(base, bodies[:4], k=3)
        removed = _ok(_http(base, "POST", "/deenroll?label=2"), "/deenroll")
        after = _ok(_http(base, "POST", "/identify?k=7", bodies[2]),
                    "/identify")
        info = _ok(_http(base, "GET", "/gallery"), "/gallery")
        # the enrolled rows: each face's /embed row (phase 21 (b))
        rows = np.asarray([_ok(_http(base, "POST", "/embed", b),
                               "/embed")["embedding"] for b in bodies[:8]],
                          np.float32)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    launches = ttk.cosine_topk.launches - before
    plain = DeviceGallery(512, device="cuda")
    plain.use_kernels = False
    plain.enroll(rows, np.arange(8))
    pl, ps = plain.search(emb, k=3)
    err = float(np.abs(got_s - ps).max())
    expect(empty["size"] == 0 and over[0] == 507
           and got_l[:, 0].tolist() == [0, 1, 2, 3]
           and np.array_equal(got_l, pl) and err <= TOPK_TOL
           and removed["removed"] == 1
           and 2 not in [m["label"] for m in after["matches"]]
           and info["size"] == 7 and info["overflow"] == "refuse"
           and info["streaming"] is False and launches == 5 * len(shards),
           f"serve() over the sharded gallery: /gallery {empty} -> {info}, "
           f"9th /enroll {over[:2]}, /identify {got_l.tolist()} vs plain "
           f"{pl.tolist()} (|score diff| {err}), /deenroll {removed}, "
           f"launches {launches}")
    say(f"  (h) serve() over DistributedGallery([cuda:0] x {len(shards)}, "
        f"bf16 folded service): /gallery empty, 8 /enroll, the 9th HTTP "
        f"{over[0]}, /identify 4 at k 3 equal to the plain programs over "
        f"the served rows (max |score diff| {err:.3g}), /deenroll 2, "
        f"/identify k 7 without it, /gallery size {info['size']}; kernel 3 "
        f"launches {launches} ({len(shards)} a search)")
    return {"launches": launches}


def start_zoo_clis(g, work: str) -> dict:
    """Phase 23's untimed runs, started beside phase 22's host work:
    cli.extract --engine auto of each ZOO_EXTRACT net over packed
    synthetic faces, cli.train 5 steps at batch 64 of each ZOO_TRAIN
    net (fixed input norm, seeded random weights)."""
    import shutil

    from tf_face_toolbox_tpu_torch.data.format import pack_arrays

    d = os.path.join(work, "zoo23")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shard = os.path.join(d, "faces.faceshard")
    pack_arrays(shard, torch.randint(
        0, 256, (ZOO_FACES, 112, 112, 3), generator=g, device="cuda",
        dtype=torch.uint8).cpu().numpy(), list(range(ZOO_FACES)))
    extract = {name: spawn(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--network", name, "--engine", "auto", "--input_norm", "fixed",
         "--data", shard, "--output", os.path.join(d, f"{name}.npy"),
         "--image_size", "112", "--crop_from", "112", "--batch", "128",
         "--loader", "python", "--device", "cuda"])
        for name in ZOO_EXTRACT}
    train = {name: start_train_cli(
        ["--network", name, "--input_norm", "fixed", "--num_classes",
         "10572", "--global_batch", "64", "--num_steps", "5",
         "--log_every", "1", "--data", "synthetic", "--train_dir",
         os.path.join(d, f"{name}_run"), "--save_every", "5"])
        for name in ZOO_TRAIN}
    return {"dir": d, "shard": shard, "extract": extract, "train": train,
            "t0": time.time()}


def phase_zoo(g, zoo: dict, r50_folded: float) -> dict:
    """Phase 23: iResNet and MobileFaceNet at full width (bf16, seeded
    weights, fixed input norm): cli.extract --engine auto (collected in
    phase 22) against the f32 module path, the module path's faces/s at
    batch 128 beside resnet_v1_50's, and cli.train (5 steps, batch 64)
    with its losses, BN statistics and training rate."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[23 iresnet, mobilefacenet] {gpu}")
    out = {"extract": {}, "train": {}}
    # (a) cli.extract --engine auto: the module path, logged; against the
    # f32 module path in this process
    for name in ZOO_EXTRACT:
        proc = zoo["done"][name]
        expect(proc.returncode == 0,
               f"cli.extract {name} failed:\n{proc.stderr[-3000:]}")
        expect("serving engine not applicable" in proc.stderr
               and "supports the ResNet family" in proc.stderr
               and "kernel launches: fused_block=0" in proc.stdout,
               f"cli.extract {name}: no module-path fallback logged: "
               f"{proc.stderr[-800:]}")
        got = np.load(os.path.join(zoo["dir"], f"{name}.npy"))
        net32 = create_network(name)
        want = extract_shard(net32, random_variables(net32, 0),
                             FaceShardSource(zoo["shard"]), image_size=112,
                             crop_from=112, batch=128, loader="python",
                             norm="fixed", device="cuda")
        del net32
        torch.cuda.empty_cache()
        cos = per_image_cos(torch.from_numpy(got), torch.from_numpy(want))
        mean = want.mean(0, keepdims=True)
        cen = per_image_cos(torch.from_numpy(got - mean),
                            torch.from_numpy(want - mean))
        expect(got.shape == (ZOO_FACES, 512) and np.isfinite(got).all()
               and cos.min().item() >= 0.999,
               f"cli.extract {name}: {got.shape}, cosine vs the f32 module "
               f"path {cos.min().item()}")
        out["extract"][name] = {"min_cos": cos.min().item(),
                                "centered_min_cos": cen.min().item()}
    # (b) the module path's rate at batch 128 (256 images), bf16, beside
    # resnet_v1_50's face-stem module path
    pixels = torch.randn((128, 112, 112, 3), generator=g, device="cuda")
    rates = {}
    for name in (*ZOO_EXTRACT, "resnet_v1_50"):
        forward = bench.build_forward(impl="module", network=name,
                                      stem="face")
        torch.cuda.reset_peak_memory_stats()
        ms = bench.time_ms(forward, pixels, iters=5, warmup=2)
        rates[name] = {"faces_per_sec": 128e3 / ms, "ms_per_batch": ms,
                       "peak_memory_gb": torch.cuda.max_memory_allocated()
                       / 1e9}
        del forward
        torch.cuda.empty_cache()
    r50 = rates["resnet_v1_50"]["faces_per_sec"]
    out["r50_module_faces_per_sec"] = r50
    for name in ZOO_EXTRACT:
        r = rates[name]
        out["extract"][name].update(r)
        say(f"  (a) cli.extract --network {name} --engine auto --input_norm "
            f"fixed, {ZOO_FACES} faces: the module-path fallback logged; "
            f"vs the f32 module path min cosine "
            f"{out['extract'][name]['min_cos']:.6f} (batch-centered "
            f"{out['extract'][name]['centered_min_cos']:.4f}); (b) module "
            f"path bf16 at batch 128: {r['faces_per_sec']:.1f} faces/s "
            f"({r['ms_per_batch']:.2f} ms/batch, peak "
            f"{r['peak_memory_gb']:.2f} GB; {r['faces_per_sec'] / r50:.3f} x "
            f"resnet_v1_50's face-stem module path {r50:.1f}, whose folded "
            f"route runs {r50_folded:.1f})")
    # (c) cli.train: 5 steps, finite losses, the BN statistics moved; then
    # the training rate at batch 64, the card to itself
    for name in ZOO_TRAIN:
        step, logged, launches = zoo["trained"][name]
        losses = logged["loss"]
        raw = CheckpointManager(os.path.join(zoo["dir"], f"{name}_run")
                                ).restore_raw(5)
        stats = raw["batch_stats"]
        moved = sum(bool((v != (1.0 if k.endswith("var") else 0.0)).any())
                    for k, v in stats.items())
        expect(step == 5 and len(losses) == 5
               and all(np.isfinite(v) for v in losses)
               and moved == len(stats) and launches == 0,
               f"cli.train {name}: step {step}, losses {losses}, "
               f"{moved}/{len(stats)} BN statistics moved, kernel 1 "
               f"x{launches}")
        r = bt.time_training(bt.config4(network=name, global_batch=64,
                                        input_norm="fixed",
                                        pallas_input=False),
                             steps=6, warmup=2, profile_steps=1)
        out["train"][name] = {"losses": losses, **{k: r[k] for k in (
            "faces_per_sec", "ms_per_step", "peak_memory_gb", "idle_share",
            "device_ms_per_step", "peak_share")}}
        say(f"  (c) cli.train --network {name} --input_norm fixed, 5 steps, "
            f"batch 64, 10,572 classes: losses "
            f"{[round(v, 4) for v in losses]}, all {len(stats)} BN "
            f"statistics moved; training {r['faces_per_sec']:.1f} faces/s "
            f"({r['ms_per_step']:.2f} ms/step, peak "
            f"{r['peak_memory_gb']:.2f} GB, idle {r['idle_share']:.1%})")
    total = time.time() - t0
    say(f"  phase 23: {total:.1f} s (its CLIs ran beside phase 22, "
        f"collected {zoo['t_done'] - zoo['t0']:.1f} s after their start)")
    out["seconds"] = total
    return out


DCT_EXTRACT = ("dct_vit_small", "dct_vit_tiny", "dct_resnet_50")
DCT_FACES = 128             # phase 24's JPEG-form faces: one batch
DCT_STEPS = 5               # phase 24's cli.train steps
# ITU-T T.81 Annex K, tables K.1 (luminance) and K.2 (chrominance), in
# natural (row-major) order
JPEG_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60,
             55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80,
             62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
             113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98,
             112, 100, 103, 99)
JPEG_CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
               99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99,
               99, 99) + (99,) * 32


def jpeg_tables(quality: int) -> np.ndarray:
    """(3, 64) uint16: Annex K's tables scaled as the IJG library scales
    them for ``quality`` (Y's table, then Cb's and Cr's)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tables = [np.clip((np.asarray(t, np.int64) * scale + 50) // 100, 1, 255)
              for t in (JPEG_LUMA, JPEG_CHROMA, JPEG_CHROMA)]
    return np.stack(tables).astype(np.uint16)


def jpeg_coefficients(u8: np.ndarray, quality: int = 90):
    """What a baseline 4:4:4 JPEG encoder stores for (N, H, W, 3) uint8
    faces (H, W multiples of 8), in NativeShardReader.dct_batch's form:
    JFIF YCbCr less 128, the 8x8 DCT in ops/jpeg's basis, divided by the
    quantization tables and rounded -> (coef int16 (N, H/8, W/8, 3, 64),
    qtab uint16 (N, 3, 64))."""
    from tf_face_toolbox_tpu_torch.ops.jpeg import _idct_matrix

    n, h, w, _ = u8.shape
    r, g, b = (u8[..., i].astype(np.float64) for i in range(3))
    ycc = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                    -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                    0.5 * r - 0.418688 * g - 0.081312 * b + 128.0], -1)
    blocks = (ycc - 128.0).reshape(n, h // 8, 8, w // 8, 8, 3).transpose(
        0, 1, 3, 5, 2, 4)
    a = _idct_matrix().astype(np.float64)
    q = jpeg_tables(quality)
    coef = np.round((a @ blocks @ a.T) / q.reshape(3, 8, 8))
    return (coef.astype(np.int16).reshape(n, h // 8, w // 8, 3, 64),
            np.ascontiguousarray(np.broadcast_to(q, (n, 3, 64))))


def start_dct_clis(work: str, shard: str) -> dict:
    """Phase 24's untimed runs, started beside phase 22's host work with
    phase 23's: cli.extract --engine auto of each DCT_EXTRACT net over
    phase 23's packed faces (per-image norm); cli.train of dct_vit_small
    (--drop_path 0.1 --pallas_input, batch 128) and of dct_resnet_50
    (batch 64, checkpointed at its last step), DCT_STEPS steps each."""
    import shutil

    d = os.path.join(work, "dct24")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    extract = {name: spawn(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--network", name, "--engine", "auto", "--data", shard, "--output",
         os.path.join(d, f"{name}.npy"), "--image_size", "112",
         "--crop_from", "112", "--batch", "128", "--loader", "python",
         "--device", "cuda"])
        for name in DCT_EXTRACT}
    common = ["--num_classes", "10572", "--num_steps", str(DCT_STEPS),
              "--log_every", "1", "--data", "synthetic"]
    train = {
        "dct_vit_small": start_train_cli(
            ["--network", "dct_vit_small", "--drop_path", "0.1",
             "--pallas_input", "--global_batch", "128", *common]),
        "dct_resnet_50": start_train_cli(
            ["--network", "dct_resnet_50", "--global_batch", "64",
             "--train_dir", os.path.join(d, "dct_resnet_50_run"),
             "--save_every", str(DCT_STEPS), *common])}
    return {"dir": d, "shard": shard, "extract": extract, "train": train,
            "t0": time.time()}


def finish_dct_clis(dct: dict) -> None:
    dct["done"] = {name: collect(p, 900) for name, p in
                   dct["extract"].items()}
    dct["trained"] = {name: finish_train_cli(s, 900)
                      for name, s in dct["train"].items()}
    dct["t_done"] = time.time()


def _dct_ops(g) -> dict:
    """Phase 24 (a): JPEG-form coefficients of DCT_FACES synthetic faces;
    decode_dct, prepare_coefficients, block_dct / block_idct and
    flip_coefficients on the card against the host and their identities."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.ops import dct as dops
    from tf_face_toolbox_tpu_torch.ops.jpeg import decode_dct
    from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval

    faces = _smooth_faces(g, DCT_FACES, 112)
    coef_np, qtab_np = jpeg_coefficients(faces)
    host = torch.from_numpy(coef_np), torch.from_numpy(qtab_np)
    coef, qtab = (t.to("cuda") for t in host)
    dec = decode_dct(coef, qtab)
    lsb = (dec.cpu().int() - decode_dct(*host).int()).abs().max().item()
    codec = np.abs(dec.cpu().numpy().astype(int) - faces.astype(int)).mean()
    prep = dops.prepare_coefficients(coef, qtab)
    prep_err = (prep.cpu()
                - dops.prepare_coefficients(*host)).abs().max().item()
    x = dec.float()
    z = dops.block_dct(x)
    round_trip = (dops.block_idct(z) - x).abs().max().item()
    parseval = (z.double().square().sum((1, 2, 3))
                / x.double().square().sum((1, 2, 3)) - 1).abs().max().item()
    flip_err = (dops.flip_coefficients(z)
                - dops.block_dct(x.flip(2))).abs().max().item()
    cos = per_image_cos(prep, dops.block_dct(preprocess_eval(dec, 112, 112)))
    dec_ms = bench.time_ms(lambda: decode_dct(coef, qtab))
    prep_ms = bench.time_ms(lambda: dops.prepare_coefficients(coef, qtab))
    say(f"  (a) {DCT_FACES} faces as 4:4:4 JPEG coefficients (Annex K "
        f"tables, IJG quality 90; the decoded faces {codec:.2f} LSB from "
        f"the sources on average): decode_dct on the card vs the host max "
        f"{lsb} LSB ({dec_ms:.3f} ms); prepare_coefficients max |diff| "
        f"{prep_err:.3g} ({prep_ms:.3f} ms); block_idct(block_dct) max "
        f"|diff| {round_trip:.3g}, Parseval {parseval:.2e}; the frequency "
        f"flip vs the pixel flip max |diff| {flip_err:.3g}; "
        f"prepare_coefficients vs block_dct of the standardized decoded "
        f"faces min cosine {cos.min().item():.6f}")
    expect(lsb <= 1, f"decode_dct card vs host {lsb} LSB > 1")
    expect(prep_err <= 1e-4, f"prepare_coefficients card vs host {prep_err}")
    expect(round_trip <= 1e-3 and parseval <= 1e-5,
           f"block_dct round trip {round_trip}, Parseval {parseval}")
    expect(flip_err <= 1e-3, f"flip_coefficients vs pixel flip {flip_err}")
    expect(cos.min().item() >= 0.999,
           f"prepare_coefficients vs the pixel chain {cos.min().item()}")
    return {"coef": coef, "qtab": qtab, "decoded": dec, "prepared": prep,
            "decode_lsb": lsb, "prepare_max_abs": prep_err,
            "decode_ms": dec_ms, "prepare_ms": prep_ms,
            "prepare_vs_pixels_min_cos": cos.min().item()}


def _dct_native(work: str, faces: torch.Tensor) -> dict | None:
    """Phase 24 (d): cli.extract --loader dct_domain and --loader
    native_dct of dct_resnet_50 over a --recode_size 112 shard, where
    native/faceshard builds (it links libjpeg); None where it does not."""
    from PIL import Image

    from tf_face_toolbox_tpu_torch.data import native

    try:
        native._load_library()
    except OSError as e:
        say(f"  (d) cli.extract --loader dct_domain / native_dct not run: "
            f"the native loader does not build on this machine ({e}); the "
            f"CPU tests run both")
        return None
    d = os.path.join(work, "dct24", "recoded")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "list.txt"), "w") as f:
        for i, face in enumerate(faces.cpu().numpy()):
            Image.fromarray(face).save(os.path.join(d, f"{i}.jpg"),
                                       quality=95)
            f.write(f"{i}.jpg {i}\n")
    shard = os.path.join(d, "recoded.faceshard")
    _cli_done(_cli("pack", "--list", os.path.join(d, "list.txt"), "--root",
                   d, "--output", shard, "--recode_size", "112"))
    runs = {loader: _cli(
        "extract", "--network", "dct_resnet_50", "--loader", loader,
        "--data", shard, "--output", os.path.join(d, f"{loader}.npy"),
        "--image_size", "112", "--crop_from", "112", "--batch", "128",
        "--device", "cuda") for loader in ("dct_domain", "native_dct")}
    for started in runs.values():
        _cli_done(started)
    a, b = (np.load(os.path.join(d, f"{loader}.npy")) for loader in runs)
    cos = per_image_cos(torch.from_numpy(a), torch.from_numpy(b)).min().item()
    say(f"  (d) cli.extract dct_resnet_50 over a --recode_size 112 shard of "
        f"{len(a)} faces: --loader dct_domain vs --loader native_dct min "
        f"cosine {cos:.6f}")
    expect(a.shape == b.shape == (len(faces), 512) and cos >= 0.999,
           f"dct_domain vs native_dct: {a.shape} {b.shape}, cosine {cos}")
    return {"min_cos": cos}


def phase_dct(g, dct: dict, r50_module: float, work: str) -> dict:
    """Phase 24: the DCT input and the JPEG-block-token ViTs at full
    width (bf16, seeded weights, per-image norm): (a) the DCT ops on the
    card; (b) cli.extract --engine auto of dct_vit_small, dct_vit_tiny and
    dct_resnet_50 (collected in phase 22) against the f32 module path,
    coefficient input against pixel input, the module path's faces/s
    plain and e2e beside resnet_v1_50's; (c) cli.train of dct_vit_small
    (drop path, kernel 1) and dct_resnet_50, the DCT-input step against
    the u8 step, dct_vit_small's training rate; (d) the native DCT
    loaders where they build."""
    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard, make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp
    from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.trainer import (
        create_train_state, make_train_step)

    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[24 dct input, dct_vit_small/tiny, dct_resnet_50] {gpu}")
    ops = _dct_ops(g)
    out = {"ops": {k: v for k, v in ops.items()
                   if not isinstance(v, torch.Tensor)},
           "extract": {}, "train": {}}
    # (b) cli.extract --engine auto: the module path, logged; against the
    # f32 module path; coefficient input against the decoded pixels
    for name in DCT_EXTRACT:
        proc = dct["done"][name]
        why = ("does not fold the dct stem" if name == "dct_resnet_50"
               else "supports the ResNet family")
        expect(proc.returncode == 0,
               f"cli.extract {name} failed:\n{proc.stderr[-3000:]}")
        expect("serving engine not applicable" in proc.stderr
               and why in proc.stderr
               and "kernel launches: fused_block=0" in proc.stdout,
               f"cli.extract {name}: no module-path fallback logged: "
               f"{proc.stderr[-800:]}")
        got = np.load(os.path.join(dct["dir"], f"{name}.npy"))
        net32 = create_network(name)
        flat = random_variables(net32, 0)
        want = extract_shard(net32, flat, FaceShardSource(dct["shard"]),
                             image_size=112, crop_from=112, batch=128,
                             loader="python", device="cuda")
        cos = per_image_cos(torch.from_numpy(got), torch.from_numpy(want))
        net16 = load_jax_variables(create_network(name, dtype=torch.bfloat16),
                                   flat).to("cuda")
        extract = make_extract_fn(net16)
        coef_cos = per_image_cos(
            extract(ops["prepared"]),
            extract(preprocess_eval(ops["decoded"], 112, 112)))
        del net32, net16, extract
        torch.cuda.empty_cache()
        expect(got.shape == (ZOO_FACES, 512) and np.isfinite(got).all()
               and cos.min().item() >= 0.999,
               f"cli.extract {name}: {got.shape}, cosine vs the f32 module "
               f"path {cos.min().item()}")
        expect(coef_cos.min().item() >= 0.999,
               f"{name}: coefficient vs pixel input cosine "
               f"{coef_cos.min().item()}")
        out["extract"][name] = {"min_cos": cos.min().item(),
                                "coef_vs_pixels_min_cos":
                                    coef_cos.min().item()}
    # the module path's rate at batch 128 (256 images), bf16, plain and
    # e2e (kernel 1 once a batch), beside resnet_v1_50's face-stem module
    # path (phase 23, this process)
    pixels = torch.randn((128, 112, 112, 3), generator=g, device="cuda")
    u8 = bench.make_inputs(128, e2e=True)
    for name in DCT_EXTRACT:
        r = out["extract"][name]
        # one build: the e2e forward and its plain one share the weights
        e2e_fwd = bench.build_forward(impl="module", e2e=True, network=name,
                                      stem="face")
        for e2e, x in ((False, pixels), (True, u8)):
            forward = e2e_fwd if e2e else e2e_fwd.plain
            fp.fused_preprocess.launches = 0
            forward(x)
            torch.cuda.synchronize()
            launches = fp.fused_preprocess.launches
            torch.cuda.reset_peak_memory_stats()
            ms = bench.time_ms(forward, x, iters=5, warmup=2)
            tag = "e2e_" if e2e else ""
            r[f"{tag}faces_per_sec"] = 128e3 / ms
            r[f"{tag}ms_per_batch"] = ms
            if e2e:
                r["e2e_launches"] = launches
                expect(launches == 1, f"{name} --e2e: kernel 1 launched "
                                      f"{launches} times in a batch")
            else:
                r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
                p = bt.device_profile(forward, x, iters=3)
                r.update(device_ms=p["device_ms"], idle_share=p["idle_share"],
                         device_ms_by_kind=p["device_ms_by_kind"])
            del forward
        del e2e_fwd
        torch.cuda.empty_cache()
        kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            r["device_ms_by_kind"].items(), key=lambda kv: -kv[1])[:3])
        say(f"  (b) {name}: cli.extract --engine auto, {ZOO_FACES} faces: "
            f"the module-path fallback logged; vs the f32 module path min "
            f"cosine {r['min_cos']:.6f}; coefficient vs pixel input "
            f"{r['coef_vs_pixels_min_cos']:.6f}; module path bf16 at batch "
            f"128: {r['faces_per_sec']:.1f} faces/s plain, "
            f"{r['e2e_faces_per_sec']:.1f} e2e (kernel 1 x"
            f"{r['e2e_launches']}), {r['ms_per_batch']:.2f} ms/batch, device "
            f"{r['device_ms']:.2f} ms, idle {r['idle_share']:.1%}, peak "
            f"{r['peak_memory_gb']:.2f} GB, "
            f"{r['faces_per_sec'] / r50_module:.3f} x resnet_v1_50's "
            f"face-stem module path {r50_module:.1f}; "
            f"device ms by kind: {kinds}")
    # (c) cli.train: finite losses; dct_vit_small's kernel 1 once a step,
    # dct_resnet_50's BN statistics all moved
    for name, (step, logged, launches) in dct["trained"].items():
        losses = logged["loss"]
        moved = total = 0
        if name == "dct_resnet_50":
            stats = CheckpointManager(os.path.join(
                dct["dir"], f"{name}_run")).restore_raw(DCT_STEPS)[
                    "batch_stats"]
            total = len(stats)
            moved = sum(bool((v != (1.0 if k.endswith("var") else 0.0)).any())
                        for k, v in stats.items())
        want_launches = DCT_STEPS if name == "dct_vit_small" else 0
        expect(step == DCT_STEPS and len(losses) == DCT_STEPS
               and all(np.isfinite(v) for v in losses)
               and moved == total and launches == want_launches,
               f"cli.train {name}: step {step}, losses {losses}, "
               f"{moved}/{total} BN statistics moved, kernel 1 x{launches}")
        out["train"][name] = {"losses": losses, "launches": launches}
        say(f"  (c) cli.train --network {name}"
            + (" --drop_path 0.1 --pallas_input, batch 128" if not total
               else f", batch 64 (all {total} BN statistics moved)")
            + f", {DCT_STEPS} steps, 10,572 classes: losses "
            f"{[round(v, 4) for v in losses]}, kernel 1 x{launches}")
    # one step from (a)'s coefficients (input_format "dct": decode_dct on
    # the card, then the u8 step) against the u8 step on their decoded
    # frames, from the same variables and draws
    cfg = bt.config4(network="dct_vit_small", global_batch=DCT_FACES,
                     crop_from=112, drop_path_rate=0.1)
    labels = torch.randint(0, cfg.num_classes, (DCT_FACES,), generator=g,
                           device="cuda")
    runs = {}
    for fmt, images in (("dct", (ops["coef"], ops["qtab"])),
                        ("u8", ops["decoded"])):
        state, net = create_train_state(cfg, 0, device="cuda")
        before = {k: v.detach().clone() for k, v in bt._leaves(state).items()}
        step_fn = make_train_step(net, cfg, state, input_format=fmt)
        fp.fused_preprocess.launches = 0
        state, m = step_fn(state, images, labels)
        torch.cuda.synchronize()
        runs[fmt] = (float(m["loss"]), fp.fused_preprocess.launches,
                     {k: (v.detach() - before[k]).double().ravel()
                      for k, v in bt._leaves(state).items()})
        del state, net, step_fn, before
        torch.cuda.empty_cache()
    (l_dct, n_dct, u_dct), (l_u8, _, u_u8) = runs["dct"], runs["u8"]
    cos = min(float(a @ u_u8[k] / (a.norm() * u_u8[k].norm()))
              for k, a in u_dct.items()
              if k != bt.NOISE_ONLY and (a.any() or u_u8[k].any()))
    del runs, u_dct, u_u8
    torch.cuda.empty_cache()
    say(f"  (c) one dct_vit_small step (batch {DCT_FACES}, drop path 0.1, "
        f"kernel 1) from (a)'s coefficients, input_format dct vs the u8 "
        f"step on their decoded frames: loss {l_dct:.6f} vs {l_u8:.6f}, "
        f"min per-leaf update cosine {cos:.6f}, kernel 1 x{n_dct}")
    expect(abs(l_dct - l_u8) <= 1e-3 * abs(l_u8) and cos >= 0.999
           and n_dct == 1, f"DCT-input step: losses {l_dct} / {l_u8}, "
                           f"update cosine {cos}, kernel 1 x{n_dct}")
    out["dct_step"] = {"loss": l_dct, "u8_loss": l_u8, "min_cos": cos,
                       "launches": n_dct}
    # dct_vit_small's training rate at batch 128, the card to itself
    r = bt.time_training(bt.config4(network="dct_vit_small", global_batch=128,
                                    drop_path_rate=0.1),
                         steps=6, warmup=2, profile_steps=1)
    out["train"]["dct_vit_small"].update({k: r[k] for k in (
        "faces_per_sec", "ms_per_step", "peak_memory_gb", "idle_share",
        "device_ms_per_step", "peak_share", "device_ms_by_kind")})
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        r["device_ms_by_kind"].items(), key=lambda kv: -kv[1])[:3])
    say(f"  (c) dct_vit_small training (bench_train, batch 128, drop path "
        f"0.1, kernel 1): {r['faces_per_sec']:.1f} faces/s "
        f"({r['ms_per_step']:.2f} ms/step, device "
        f"{r['device_ms_per_step']:.2f} ms, idle {r['idle_share']:.1%}, peak "
        f"{r['peak_memory_gb']:.2f} GB, {r['peak_share']:.1%} of 989 "
        f"TFLOP/s); device ms by kind: {kinds}")
    expect(np.isfinite(r["loss"]), f"dct_vit_small timed loss {r['loss']}")
    out["native"] = _dct_native(work, ops["decoded"])
    total = time.time() - t0
    say(f"  phase 24: {total:.1f} s (its CLIs ran beside phase 22, "
        f"collected {dct['t_done'] - dct['t0']:.1f} s after their start)")
    out["seconds"] = total
    return out


INT8_FACES = 512            # phase 25's served faces: phase 12's eval shard
QAT_STEPS = 5               # phase 25's cli.train --qat steps


def start_int8_clis(work: str) -> dict:
    """Phase 25's untimed runs, started beside phase 22's host work: (A)
    cli.export --quant_mode static --calibrate_data of phase 12's
    step-20 checkpoint (calibrated on its 512 eval faces), then
    cli.extract --bundle over them; as soon as (A)'s bundle is written,
    phase 25 (c)'s two daemons boot from it over phase 21's 10^6-row
    snapshot (f32 and int8 galleries; up and idle by phase 23, which
    times nothing beside them but their idle threads); (B) cli.train
    --qat --pallas_input (resnet_v1_50 face stem, bf16, batch 64,
    QAT_STEPS steps, a checkpoint at the last), then its static bundle
    (phase 25 serves it in its own process). Each chain runs in a thread
    (``_beside``);
    the daemons are killed at exit if phase 25 never drains them."""
    import atexit
    import shutil

    d = os.path.join(work, "int8_25")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    eval_shard = os.path.join(work, "ckpt_eval.faceshard")
    net = ["--network", "resnet_v1_50", "--stem", "face", "--embedding_dim",
           "512", "--image_size", "112"]

    daemons: dict = {}

    def boot_daemons(bundle: str) -> None:
        snap = os.path.join(work, "daemon21", "gallery_1m.npz")  # phase 21's
        for tag, dtype in (("f32", "float32"), ("int8", "int8")):
            link = os.path.join(d, f"gallery_{tag}.npz")
            os.link(snap, link)
            daemons[tag] = _Daemon(["--bundle", bundle, "--gallery", link,
                                    "--gallery_dtype", dtype])
        daemons["t0"] = time.time()

    def kill_daemons() -> None:
        for dmn in daemons.values():
            if isinstance(dmn, _Daemon) and dmn.proc.poll() is None:
                dmn.proc.kill()

    atexit.register(kill_daemons)

    def export_extract(run: str, tag: str, extract: bool = True) -> dict:
        t = time.time()
        bundle = os.path.join(d, f"{tag}.int8.npz")
        out = _cli_done(_cli("export", "--checkpoint_dir", run, *net,
                             "--output", bundle, "--quant_mode", "static",
                             "--calibrate_data", eval_shard,
                             "--calibrate_batches", "4", "--device", "cuda"))
        export_s = time.time() - t
        if tag == "r50":
            boot_daemons(bundle)
        if not extract:
            return {"bundle": bundle, "export": out[-1], "export_s": export_s,
                    "s": time.time() - t}
        emb = os.path.join(d, f"{tag}.npy")
        _cli_done(_cli("extract", "--bundle", bundle, "--data", eval_shard,
                       "--output", emb, "--batch", "128", "--loader",
                       "python", "--device", "cuda"))
        return {"bundle": bundle, "emb": np.load(emb), "export": out[-1],
                "export_s": export_s, "s": time.time() - t}

    def qat():
        t = time.time()
        run = os.path.join(d, "qat_run")
        step, logged, launches = train_cli(
            ["--network", "resnet_v1_50", "--stem", "face", "--qat",
             "--pallas_input", "--global_batch", "64", "--num_classes",
             "10572", "--num_steps", str(QAT_STEPS), "--log_every", "1",
             "--data", "synthetic", "--train_dir", run, "--save_every",
             str(QAT_STEPS)], 900)
        train_s = time.time() - t
        return {"step": step, "losses": logged["loss"], "launches": launches,
                "train_s": train_s, **export_extract(run, "qat", False)}

    return {"dir": d, "eval_shard": eval_shard, "t0": time.time(),
            "daemons": daemons,
            "r50": _beside(lambda: export_extract(
                os.path.join(work, "ckpt_run"), "r50")),
            "qat": _beside(qat)}


def finish_int8_clis(int8: dict) -> None:
    """Join phase 25's chains and wait for its two daemons' ``serving
    on``: nothing of phase 25 runs on the card after this."""
    int8["r50"] = int8["r50"]()
    int8["qat"] = int8["qat"]()
    for tag in ("f32", "int8"):
        int8["daemons"][tag].wait_serving()
    int8["t_done"] = time.time()


def phase_int8(g, int8: dict, work: str, daemon21: dict,
               folded_e2e_faces_per_sec: float) -> dict:
    """Phase 25: int8 serving at full width (resnet_v1_50, face stem,
    512-d, bf16). (a) ``int8_conv2d_nhwc`` at each of its conv shapes at
    256 images on the card's int8 tensor cores (``torch._int_mm``), bit
    for bit against the float64 plain version, timed beside the bf16
    cuDNN conv of the shape and its bound; (b) the static bundle of phase
    12's checkpoint (cli.export --calibrate_data, beside phase 22)
    served by cli.extract --bundle, held against the f32 module path and
    against the same int8 module with its convs on the plain route;
    faces/s at batch 128 e2e (kernel 1) of dynamic and static int8
    beside the fp module path and phase 16's folded rate of the same
    net, batch and input; (c) cli.serve
    --bundle over the int8 bundle with the 10^6-row gallery, /identify
    through kernels 3 and 4 against the plain programs; cli.train --qat
    (beside phase 22) and its static bundle served."""
    import shutil

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch import bench_train as bt
    from tf_face_toolbox_tpu_torch.bench_int8 import NETS, face_conv_shapes
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard
    from tf_face_toolbox_tpu_torch.interop.port import flatten_variables
    from tf_face_toolbox_tpu_torch.models import layers
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving.bundle import (
        network_from_meta, read_bundle)
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    torch.cuda.empty_cache()
    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[25 int8] {gpu}")

    # ---- (a) the conv on the card, alone: resnet_v1_50's convs, then
    # resnext_50's grouped 3x3s (one _int_mm over a block-diagonal kernel)
    convs = []
    grouped = [sh for sh in face_conv_shapes(*NETS["resnext_50"])
               if sh[5] > 1]
    for net, shapes in (("resnet_v1_50", face_conv_shapes()),
                        ("resnext_50", grouped)):
        for h, c, k, s, o, gr, n in shapes:
            xq = torch.randint(-127, 128, (256, h, h, c), generator=g,
                               device="cuda", dtype=torch.int8)
            kq = torch.randint(-127, 128, (o, c // gr, k, k), generator=g,
                               device="cuda", dtype=torch.int8)
            before = layers.int8_conv2d_nhwc.launches
            got = layers.int8_conv2d_nhwc(xq, kq, s, gr)
            routed = layers.int8_conv2d_nhwc.launches - before
            equal = torch.equal(got, layers.int8_conv2d_plain(xq, kq, s, gr))
            del got
            ms = bench.time_ms(lambda: layers.int8_conv2d_nhwc(xq, kq, s, gr))
            xb, kb = xq.to(torch.bfloat16), kq.to(torch.bfloat16)
            bf16_ms = bench.time_ms(
                lambda: layers.conv2d_same_nhwc(xb, kb, s, groups=gr))
            ho = -(-h // s)
            m = 256 * ho * ho
            b_ms, b_by = bound(xq.numel() + kq.numel() + 4 * m * o,
                               2 * m * (c // gr) * k * k * o, "int8")
            shape = (f"{h}x{h}x{c} {k}x{k}/{s} -> {o}"
                     + (f" in {gr} groups" if gr > 1 else ""))
            convs.append({"net": net, "shape": shape, "count": n,
                          "equal": equal, "routed": routed, "ms": ms,
                          "bf16_cudnn_ms": bf16_ms, "bound_ms": b_ms,
                          "bound_by": b_by})
            say(f"  (a) {net} int8 conv {shape} (x{n}) at 256 images: "
                f"_int_mm {ms:.3f} ms, bf16 cuDNN {bf16_ms:.3f} ms "
                f"({bf16_ms / ms:.2f} x), bound {b_ms:.3f} ms ({b_by}, "
                f"{b_ms / ms:.1%} of it); bit-equal to float64: {equal}")
            expect(equal, f"int8 conv {shape} differs from its float64 "
                          "plain version")
            expect(routed == 1, f"int8 conv {shape}: {routed} wrapper "
                                "calls, want 1")
            del xq, kq, xb, kb
            torch.cuda.empty_cache()
    net_ms = {}
    for net in ("resnet_v1_50", "resnext_50"):
        mine = [cv for cv in convs if cv["net"] == net]
        net_ms[net] = {key: sum(cv[key] * cv["count"] for cv in mine)
                       for key in ("ms", "bf16_cudnn_ms", "bound_ms")}
        say(f"  (a) {net}'s {sum(cv['count'] for cv in mine)} "
            f"{'int8' if net == 'resnet_v1_50' else 'grouped int8'} convs "
            f"at 256 images: _int_mm {net_ms[net]['ms']:.2f} ms, bf16 "
            f"cuDNN {net_ms[net]['bf16_cudnn_ms']:.2f} ms, bound "
            f"{net_ms[net]['bound_ms']:.2f} ms")
    say(f"  (a) {time.time() - t0:.1f} s")

    # ---- (b) faces/s, alone: batch 128 e2e (kernel 1), seeded weights
    u8 = bench.make_inputs(128, True)
    rates, launches, embs, profiles = {}, {}, {}, {}
    for label, q in (("dynamic int8", "dynamic"), ("static int8", "static"),
                     ("fp module", False)):
        fwd = bench.build_forward(impl="module", e2e=True,
                                  network="resnet_v1_50", stem="face",
                                  quantized=q)
        fp.fused_preprocess.launches = 0
        before = layers.int8_conv2d_nhwc.launches
        embs[label] = fwd(u8)
        torch.cuda.synchronize()
        launches[label] = {"preprocess": fp.fused_preprocess.launches,
                           "int8_conv": layers.int8_conv2d_nhwc.launches
                           - before}
        ms = sorted(bench.time_ms(fwd, u8, iters=5, warmup=2)
                    for _ in range(3))[1]
        rates[label] = 128 * 1000.0 / ms
        if label in ("static int8", "fp module"):
            # where the module path's time goes (the int8 GEMMs count
            # under bench_train's "head (GEMMs, ...)" kind)
            prof = bt.device_profile(fwd, u8, iters=3)
            kinds = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                prof["device_ms_by_kind"].items(), key=lambda kv: -kv[1]))
            top = "; ".join(f"{name[:48]} {t:.2f}"
                            for t, name in prof["kernels_ms"][:6])
            profiles[label] = prof
            say(f"  (b) {label}: device {prof['device_ms']:.2f} of "
                f"{prof['wall_ms']:.2f} ms wall a batch (idle "
                f"{prof['idle_share']:.1%}): {kinds} ms; top kernels {top}")
        del fwd
        torch.cuda.empty_cache()
    for label, r in rates.items():
        cos = per_image_cos(embs[label], embs["fp module"]).min().item()
        say(f"  (b) {label:12s} e2e batch 128: {r:.1f} faces/s "
            f"({r / rates['fp module']:.3f} x the fp module path, "
            f"{r / folded_e2e_faces_per_sec:.3f} x phase 16's folded "
            f"{folded_e2e_faces_per_sec:.1f}); launches {launches[label]}; "
            f"cos vs fp module (seeded weights) min {cos:.4f}")
    for label in ("dynamic int8", "static int8"):
        expect(launches[label] == {"preprocess": 1, "int8_conv": 52},
               f"{label} launches {launches[label]}, want kernel 1 once "
               "and 52 _int_mm convs (one forward of 256 images)")
        expect(bool(torch.isfinite(embs[label]).all()), f"{label} finite")
    del embs
    torch.cuda.empty_cache()

    t_b = time.time()
    # ---- (c)'s daemons booted beside phase 22 (``start_int8_clis``),
    # up since phase 22 joined the chains
    a, b = int8["r50"], int8["qat"]
    d = int8["dir"]
    snap = os.path.join(work, "daemon21", "gallery_1m.npz")   # phase 21's
    daemons = {tag: int8["daemons"][tag] for tag in ("f32", "int8")}
    try:
        # (b) checks: the CLI's int8 faces against the f32 module path and
        # against the int8 module with its convs on the plain route
        run = os.path.join(work, "ckpt_run")
        source = FaceShardSource(int8["eval_shard"])
        net32, flat32 = load_variables(run, "resnet_v1_50", 512, 112,
                                       torch.float32)
        fp32 = extract_shard(net32, flat32, source, image_size=112,
                             batch=128, loader="python", device="cuda")
        variables, meta = read_bundle(a["bundle"])
        flat = flatten_variables(variables)
        qnet = network_from_meta(meta, dtype=torch.bfloat16)
        route = layers.int8_conv2d_int_mm
        layers.int8_conv2d_int_mm = layers.int8_conv2d_plain
        try:
            plain = extract_shard(qnet, flat, source, image_size=112,
                                  batch=128, loader="python", device="cuda")
        finally:
            layers.int8_conv2d_int_mm = route
        got = a["emb"]
        c_fp = _face_cos(got, fp32)
        c_plain = _face_cos(got, plain)
        n_stats = sum(k.startswith("quant_stats/") for k in flat)
        say(f"  (b) cli.export --quant_mode static --calibrate_data (phase "
            f"12's step 20, {n_stats} frozen scales; {a['export_s']:.1f} s) "
            f"then cli.extract --bundle of {got.shape[0]} faces (bf16, the "
            f"module path): vs the f32 module path per-face cos min "
            f"{c_fp[0]:.6f} (max |diff| {c_fp[1]:.3g}); vs the same int8 "
            f"module on the float64 plain conv route min {c_plain[0]:.6f} "
            f"(max |diff| {c_plain[1]:.3g}); chain {a['s']:.1f} s")
        expect(meta["quant_mode"] == "static" and n_stats == 52 + 16,
               f"bundle meta {meta['quant_mode']}, {n_stats} stats")
        expect(got.shape == (INT8_FACES, 512) and np.isfinite(got).all(),
               f"int8 extraction {got.shape}")
        expect(c_fp[0] >= 0.98, f"int8 vs f32 module cosine {c_fp[0]}")
        expect(c_plain[0] >= 0.9999,
               f"int8 vs its plain conv route cosine {c_plain[0]}")
        del net32, qnet, fp32, plain
        torch.cuda.empty_cache()

        # QAT: cli.train --qat, its static bundle (cli.export), served
        # here through the bundle's module path, as cli.extract --bundle
        # serves (b)'s
        variables, meta = read_bundle(b["bundle"])
        qat_net = network_from_meta(meta, dtype=torch.bfloat16)
        qat_emb = extract_shard(qat_net, flatten_variables(variables),
                                source, image_size=112, batch=128,
                                loader="python", device="cuda")
        del qat_net, variables
        expect(meta["quant_mode"] == "static",
               f"the QAT bundle's mode {meta['quant_mode']}")
        say(f"  (c) cli.train --qat --pallas_input (batch 64, "
            f"{QAT_STEPS} steps): done step={b['step']}, losses "
            f"{[round(x, 3) for x in b['losses']]}, kernel 1 launches "
            f"{b['launches']}; its static bundle (cli.export) served on "
            f"the bundle's module path: {qat_emb.shape}, |norm-1| max "
            f"{np.abs(np.linalg.norm(qat_emb, axis=1) - 1).max():.2e}")
        expect(b["step"] == QAT_STEPS and len(b["losses"]) == QAT_STEPS
               and np.isfinite(b["losses"]).all(),
               f"cli.train --qat: step {b['step']}, losses {b['losses']}")
        expect(b["launches"] == QAT_STEPS,
               f"cli.train --qat kernel 1 launches {b['launches']}")
        expect(qat_emb.shape == (INT8_FACES, 512)
               and np.isfinite(qat_emb).all()
               and np.abs(np.linalg.norm(qat_emb, axis=1) - 1).max() < 1e-4,
               "the QAT bundle's served faces")

        t_c = time.time()
        # (c) /identify over 10^6 rows + the probes, kernel 3 and kernel 4
        with np.load(snap) as z:
            rows, row_labels = z["embeddings"], z["labels"]
        bodies = daemon21["bodies"][:16]
        n_q = len(bodies)
        answers = {}
        for tag, dmn in daemons.items():
            dmn.wait_serving()
            _enroll(dmn.base, bodies)
            probes, labels, scores, _ = _identify(dmn.base, bodies)
            plain = DeviceGallery(512, dtype="float32" if tag == "f32"
                                  else "int8", device="cuda")
            plain.use_kernels = False
            plain.enroll(rows, row_labels)
            plain.enroll(probes, np.arange(n_q))
            pl, ps = plain.search(probes, k=6 if tag == "f32" else 5)
            del plain
            torch.cuda.empty_cache()
            err = float(np.abs(scores - ps[:, :5]).max())
            same = labels == pl[:, :5]
            if tag == "f32":
                same |= near_ties(ps, 5)
            own = int((labels[:, 0] == np.arange(n_q)).sum())
            answers[tag] = (own, bool(same.all()), err)
            say(f"  (c) cli.serve --bundle (static int8, bf16) with the "
                f"{GALLERY_ROWS:,}-row {tag} gallery: /enroll {n_q}, "
                f"/identify {n_q} at k 5 (kernel {3 if tag == 'f32' else 4}):"
                f" top-1 own label {own}/{n_q}; vs the plain programs: "
                f"labels equal {bool(same.all())}, max |score diff| "
                f"{err:.3g}")
            expect(own == n_q, f"int8 daemon ({tag} gallery) top-1")
            expect(same.all() and err <= (TOPK_TOL if tag == "f32" else 1e-6),
                   f"int8 daemon ({tag} gallery) /identify differs from "
                   "the plain programs")
        del rows
        # both drain (and save) at once; each gets one SIGTERM (a second
        # one, once its drain has ended, would kill its exit)
        t_drain = time.time()
        drains = [_beside(lambda: daemons["f32"].expect_drained(
                      topk=n_q, topk_q=0)),
                  _beside(lambda: daemons["int8"].expect_drained(
                      topk=0, topk_q=n_q))]
        for wait in drains:
            wait()
        t_end = time.time()
    finally:
        for dmn in daemons.values():
            dmn.stop()
        shutil.rmtree(d, ignore_errors=True)
    total = time.time() - t0
    say(f"  phase 25: {total:.1f} s ((a) and (b)'s rates {t_b - t0:.1f}, "
        f"(b)'s checks {t_c - t_b:.1f}, (c) {t_drain - t_c:.1f}, the drains "
        f"{t_end - t_drain:.1f}; its CLIs ran beside phase 22, collected "
        f"{int8['t_done'] - int8['t0']:.1f} s after their start; (c) "
        f"began {t_c - int8['daemons']['t0']:.1f} s after the daemons' "
        f"start)")
    rates["folded (phase 16)"] = folded_e2e_faces_per_sec
    return {"convs": convs, "net_ms": net_ms, "rates": rates,
            "profiles": profiles, "launches": launches, "cos_fp": c_fp[0], "cos_plain": c_plain[0],
            "qat": {k: b[k] for k in ("step", "losses", "launches")},
            "daemon_launches": {"topk": n_q, "topk_q": n_q},
            "seconds": total}

LFW26_IDS, LFW26_PER = 108, 8               # phase 26 (c): 864 faces
LFW26_PAIRS = 300           # LFW's view 2: 10 folds of 300 same + 300 different
WARP_FACES, WARP_SRC = 256, 250             # phase 26 (a): LFW's source size


def _lfw_layout(root: str, rng) -> tuple[str, np.ndarray]:
    """Phase 26 (c)'s synthetic LFW: LFW26_IDS identities of LFW26_PER
    120x120 JPEGs (a ``_smooth_faces`` face each, its images that face
    plus +-2 of noise), in ``Name/Name_0001.jpg`` layout; → (an official-format pairs file at
    LFW's counts: 10 folds, each LFW26_PAIRS same pairs, every pair of a
    person's images, then LFW26_PAIRS different ones; the faces before
    JPEG, (N, 120, 120, 3) u8, in the runner's list order)."""
    names = [f"Id_{i:04d}" for i in range(LFW26_IDS)]
    bases = _smooth_faces(torch.Generator("cuda").manual_seed(26),
                          LFW26_IDS, 120)
    faces, paths = [], []
    for name, base in zip(names, bases):
        os.makedirs(os.path.join(root, name))
        for k in range(1, LFW26_PER + 1):
            faces.append(np.clip(base + rng.normal(0, 2, base.shape), 0,
                                 255).round().astype(np.uint8))
            paths.append(os.path.join(root, name, f"{name}_{k:04d}.jpg"))
    for path, blob in zip(paths, _encode(faces)):
        with open(path, "wb") as fh:
            fh.write(blob)
    combos = [(u, v) for u in range(1, LFW26_PER + 1)
              for v in range(u + 1, LFW26_PER + 1)]     # 28 a person
    same = [(names[i // len(combos)], *combos[i % len(combos)])
            for i in range(10 * LFW26_PAIRS)]
    a = rng.integers(0, LFW26_IDS, 10 * LFW26_PAIRS)
    b = (a + rng.integers(1, LFW26_IDS, a.shape)) % LFW26_IDS
    n1, n2 = rng.integers(1, LFW26_PER + 1, (2, a.size))
    lines = [f"10\t{LFW26_PAIRS}"]
    for fold in range(10):
        cut = slice(fold * LFW26_PAIRS, (fold + 1) * LFW26_PAIRS)
        lines += ["\t".join(map(str, p)) for p in same[cut]]
        lines += [f"{names[x]}\t{u}\t{names[y]}\t{v}"
                  for x, u, y, v in zip(a[cut], n1[cut], b[cut], n2[cut])]
    pairs = os.path.join(os.path.dirname(root), "pairs.txt")
    with open(pairs, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return pairs, np.stack(faces)


def start_item19_clis(work: str, zoo_shard: str) -> dict:
    """Phase 26's untimed runs, started beside phase 22's host work, each
    chain in a thread (``_beside``): (b) phase 23's seeded iresnet_100
    .npz -> cli.export_torch -> cli.import_torch -> cli.extract --engine
    auto --input_norm fixed over phase 23's faces (``zoo_shard``); (c)
    the synthetic LFW directory, its golden rows from this process's f32
    module path (resnet_v1_50, seed 0, the head BN's bias shifted by 3/4
    of the mean raw output over the faces), then python -m
    tf_face_toolbox_tpu_torch.acceptance on the card."""
    import shutil

    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables

    d = os.path.join(work, "item19_26")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)

    def iresnet() -> dict:
        t = time.time()
        npz = os.path.join(d, "iresnet_100.npz")
        save_variables_npz(npz, random_variables(create_network("iresnet_100"),
                                                 0))
        secs = {"npz": time.time() - t}
        pt, back = os.path.join(d, "iresnet_100.pth"), os.path.join(
            d, "iresnet_100_imported.npz")
        emb = os.path.join(d, "iresnet_100.npy")
        out = {}
        for name, *args in (
                ("export_torch", "--variables_npz", npz, "--output", pt,
                 "--network", "iresnet_100", "--input_norm", "fixed"),
                ("import_torch", "--pt", pt, "--output", back, "--network",
                 "iresnet_100"),
                ("extract", "--variables_npz", back, "--network",
                 "iresnet_100", "--engine", "auto", "--input_norm", "fixed",
                 "--data", zoo_shard, "--output", emb, "--image_size", "112",
                 "--crop_from", "112", "--batch", "128", "--loader",
                 "python", "--device", "cuda")):
            t = time.time()
            out[name] = _cli_done(_cli(name, *args))
            secs[name] = time.time() - t
        return {"npz": npz, "back": back, "emb": emb, "lines": out,
                "secs": secs}

    def runner() -> dict:
        from tf_face_toolbox_tpu_torch.acceptance import build_list
        from tf_face_toolbox_tpu_torch.data.format import pack_image_list
        from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
        from tf_face_toolbox_tpu_torch.extract import extract_shard
        from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
        from tf_face_toolbox_tpu_torch.ops.preprocess import standardize

        t = time.time()
        lfw = os.path.join(d, "lfw")
        pairs, faces = _lfw_layout(lfw, np.random.default_rng(26))
        net = create_network("resnet_v1_50")
        flat = random_variables(net, 0)
        # random weights give every face one large shared component: every
        # pair's cosine then falls in one step of eval_lfw's 0.0025
        # threshold grid. The head BN's bias takes 3/4 of the mean raw
        # output over an eighth of these faces and their mirror images off
        load_jax_variables(net, flat).to("cuda")
        x = standardize(torch.from_numpy(faces[::8, 4:116, 4:116]).to(
            "cuda").float())
        with torch.no_grad():
            mean = torch.cat([net(x), net(x.flip(2))]).mean(0).cpu().numpy()
        key = "params/EmbeddingHead_0/BatchNorm_0/bias"
        flat[key] = flat[key] - np.float32(0.75) * mean
        npz = os.path.join(d, "r50_face_seed0.npz")
        save_variables_npz(npz, flat)
        # the golden rows: the f32 module path over the faces in the
        # runner's pack-list order
        listing, shard = os.path.join(d, "list.txt"), os.path.join(
            d, "golden.faceshard")
        build_list(lfw, listing)
        pack_image_list(listing, shard, root=lfw)
        golden = os.path.join(d, "golden.npy")
        np.save(golden, extract_shard(net, flat, FaceShardSource(shard),
                                      image_size=112, batch=128,
                                      loader="python", device="cuda"))
        del net
        secs = {"set-up": time.time() - t}
        t = time.time()
        workdir = os.path.join(d, "acceptance")
        proc = collect(spawn(
            [sys.executable, "-m", "tf_face_toolbox_tpu_torch.acceptance",
             "--data", lfw, "--pairs", pairs, "--variables_npz", npz,
             "--reference_embeddings", golden, "--workdir", workdir,
             "--device", "cuda"]), 900)
        secs["acceptance"] = time.time() - t
        return {"proc": proc, "workdir": workdir, "golden": golden,
                "secs": secs}

    return {"dir": d, "t0": time.time(), "iresnet": _beside(iresnet),
            "runner": _beside(runner)}


def finish_item19_clis(item19: dict) -> None:
    """Join phase 26's two chains: nothing of phase 26 runs on the card
    after this but (a)."""
    item19["iresnet"] = item19["iresnet"]()
    item19["runner"] = item19["runner"]()
    item19["t_done"] = time.time()


def phase_item19(g, item19: dict, zoo: dict) -> dict:
    """Phase 26: item 19 at full width. (a) the torch warp on the card
    against the numpy warp, timed; (b) the iresnet_100 round trip and its
    extraction (run beside phase 22); (c) the acceptance runner's report
    (run beside phase 22)."""
    import shutil

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.interop.port import (
        flatten_variables, load_variables_npz)
    from tf_face_toolbox_tpu_torch.ops import align

    t0 = time.time()
    gpu = bench.gpu_info()
    say(f"[26 alignment, iresnet interop, acceptance] {gpu}")

    # (a) WARP_FACES seeded WARP_SRC^2 faces, each with its own landmarks:
    # the template moved by a random similarity (scale 1.4-2.0, +-0.3
    # rad, anywhere its 112^2 crop still overlaps the frame) plus
    # 1.5 px of noise, aligned onto the template at 112
    faces = torch.randint(0, 256, (WARP_FACES, WARP_SRC, WARP_SRC, 3),
                          generator=g, device="cuda", dtype=torch.uint8)
    host = faces.cpu().numpy()
    rng = np.random.default_rng(260)
    mats = []
    for _ in range(WARP_FACES):
        scale, theta = rng.uniform(1.4, 2.0), rng.uniform(-0.3, 0.3)
        c, s_ = scale * np.cos(theta), scale * np.sin(theta)
        shift = rng.uniform(-60, WARP_SRC - 100, 2)
        lm = align.ARCFACE_TEMPLATE_112 @ np.array([[c, s_], [-s_, c]]) + shift
        lm = lm + rng.normal(0, 1.5, lm.shape)
        mats.append(align.umeyama(lm, align.ARCFACE_TEMPLATE_112))
    mats = np.stack(mats)
    got = align.warp_similarity_torch(faces, mats, 112, 112)     # warm-up
    torch.cuda.synchronize()
    ms = bench.time_ms(lambda: align.warp_similarity_torch(
        faces, mats, 112, 112), iters=5, warmup=0)
    got = got.cpu().numpy()
    want = np.stack([align.warp_similarity(host[i], mats[i], 112, 112)
                     for i in range(WARP_FACES)])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    equal = float(np.mean(diff == 0))
    outside = float(np.mean(want == 0))
    expect(got.shape == (WARP_FACES, 112, 112, 3) and diff.max() <= 1
           and equal >= 0.98,
           f"warp_similarity_torch vs numpy: shape {got.shape}, max "
           f"|diff| {diff.max()}, {equal:.2%} equal")
    # bytes: the u8 faces read once, the crops written, the (y, x) f32
    # coordinates copied in; no operation count binds it
    nbytes = host.nbytes + got.nbytes + WARP_FACES * 112 * 112 * 8
    say(f"  (a) warp_similarity_torch, {WARP_FACES} faces {WARP_SRC}x"
        f"{WARP_SRC} u8 -> 112x112 (random similarity landmarks, Umeyama): "
        f"max |diff| vs the float64 numpy warp {diff.max()}, {equal:.4%} "
        f"equal ({outside:.2%} zero fill); {ms:.3f} ms a call of "
        f"{WARP_FACES} faces (host coordinates and the gather; CUDA events, "
        f"5 after 1), bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del faces

    # (b) the iresnet_100 round trip, bit-equal; its extraction against
    # phase 23's
    ir = item19["iresnet"]
    a = flatten_variables(load_variables_npz(ir["npz"]))
    b = flatten_variables(load_variables_npz(ir["back"]))
    same = sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    expect(same, "iresnet_100 .npz -> export_torch -> import_torch -> .npz "
           "is not bit-equal")
    emb = np.load(ir["emb"])
    ref = np.load(os.path.join(zoo["dir"], "iresnet_100.npy"))
    cos = per_image_cos(torch.from_numpy(emb), torch.from_numpy(ref))
    lines = ir["lines"]
    expect(emb.shape == (ZOO_FACES, 512) and np.isfinite(emb).all()
           and cos.min().item() >= 0.999
           and "kernel launches: fused_block=0" in "\n".join(
               lines["extract"]),
           f"cli.extract of the imported iresnet_100: {emb.shape}, cosine "
           f"vs phase 23 {cos.min().item()}")
    n = sum(v.size for v in a.values())
    say(f"  (b) iresnet_100 ({n:,} values, seed 0) .npz -> export_torch -> "
        f".pth -> import_torch -> .npz: bit-equal, {len(a)} keys; "
        f"cli.extract --engine auto --input_norm fixed of it, {ZOO_FACES} "
        f"faces: per-face cosine vs phase 23 min {cos.min().item():.6f}, "
        f"max |diff| {np.abs(emb - ref).max():.3g}; seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ir["secs"].items()))
    say(f"      {lines['export_torch'][-1]}")
    say(f"      {lines['import_torch'][-1]}")

    # (c) the acceptance runner: exit 0, every gate PASS
    run = item19["runner"]
    proc = run["proc"]
    report_path = os.path.join(run["workdir"], "acceptance_report.json")
    expect(proc.returncode == 0 and os.path.exists(report_path),
           f"acceptance runner exited {proc.returncode}:\n"
           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(report_path) as fh:
        report = json.load(fh)
    gates = {x["gate"]: x for x in report["gates"]}
    expect(report["status"] == "PASS" and sorted(gates) == [
        "lfw_accuracy_vs_reference", "per_face_cosine_vs_reference"]
           and all(x["pass"] for x in report["gates"]),
           f"acceptance report: status {report['status']}, gates {gates}")
    say(f"  (c) python -m tf_face_toolbox_tpu_torch.acceptance, resnet_v1_50 "
        f"face stem bf16 512-d (seed 0), {LFW26_IDS} x {LFW26_PER} "
        f"synthetic LFW faces, {20 * LFW26_PAIRS} pairs, golden "
        f"rows from the f32 module path: exit 0, {report['status']}; LFW "
        f"accuracy {report['lfw_accuracy']:.4f}; gates "
        + ", ".join(f"{k} {x['value']:.6g} ({'PASS' if x['pass'] else 'FAIL'})"
                    for k, x in gates.items())
        + "; seconds: " + ", ".join(f"{k} {v:.1f}"
                                    for k, v in run["secs"].items()))
    shutil.rmtree(item19["dir"], ignore_errors=True)
    total = time.time() - t0
    say(f"  phase 26: {total:.1f} s (its CLI chains ran beside phase 22, "
        f"collected {item19['t_done'] - item19['t0']:.1f} s after their "
        f"start)")
    return {"warp_ms": ms, "warp_max_diff": int(diff.max()),
            "warp_equal": equal, "iresnet_cos": cos.min().item(),
            "acceptance": report["status"], "seconds": total}


def _full_state(state) -> dict:
    """Host copies of a train state's tensors, its optimizer's included."""
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"batch_stats/{k}": v for k, v in state.batch_stats.items()})
    out["classifier"] = state.classifier
    opt = state.opt_state["optimizer"]
    for name, p in {**state.params, "classifier": state.classifier}.items():
        for slot, t in opt.state.get(p, {}).items():
            out[f"{slot}/{name}"] = t
    return {k: v.detach().float().cpu().clone() for k, v in out.items()}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; there is no CPU path")

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.kernels import build
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp
    from tf_face_toolbox_tpu_torch.serving import fused_block as fb

    # ---- 1. device
    gpu = bench.gpu_info()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[1 device] {gpu} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} | TF32 off")

    # ---- 2. build
    t0 = time.time()
    lib_path = build.build()
    build.load_library()
    say(f"[2 build] {os.path.relpath(lib_path, ROOT)} in "
        f"{time.time() - t0:.1f} s (nvcc sm_90a)")

    g = torch.Generator(device="cuda").manual_seed(0)

    # ---- 3. kernels vs their plain versions
    say("[3 kernels]")
    u8 = torch.randint(0, 256, (256, 120, 120, 3), generator=g,
                       device="cuda", dtype=torch.uint8)
    flips = torch.randint(0, 2, (256,), generator=g, device="cuda")
    # a constant image at its own size: no resize, zero variance, so the
    # std floor 1/sqrt(N) must give exact zeros (not NaN); a large frame,
    # whose bands stage only the source rows their taps read
    const = torch.full((4, 112, 112, 3), 77, dtype=torch.uint8, device="cuda")
    frames = torch.randint(0, 256, (16, 512, 512, 3), generator=g,
                           device="cuda", dtype=torch.uint8)
    pre_err = 0.0
    # no mask: the eval path (fused_eval_preprocess, no image flipped)
    for images, fl, label in ((u8, flips, "random flips"),
                              (u8, None, "eval path"),
                              (const, flips[:4], "constant image"),
                              (frames, flips[:16], "large frames")):
        if fl is None:
            def run(dtype, images=images):
                return fp.fused_eval_preprocess(images, 112, 112,
                                                out_dtype=dtype)
            fl = torch.zeros(images.shape[0], device="cuda")
        else:
            def run(dtype, images=images, fl=fl):
                return fp.fused_preprocess(images, fl, out_h=112, out_w=112,
                                           out_dtype=dtype)
        want = fp.fused_preprocess_reference(images, fl, out_h=112, out_w=112)
        got = run(torch.float32)
        torch.cuda.synchronize()
        err32 = (got - want).abs().max().item()
        got16 = run(torch.bfloat16)
        torch.cuda.synchronize()
        # bf16: within one bf16 step of the plain version's rounded
        # value, beyond the f32 tolerance (near zero, (y - mean)
        # cancels and only the absolute f32 error means anything)
        want16 = want.to(torch.bfloat16).float()
        excess = ((got16.float() - want16).abs() - 1e-4).clamp_min(0)
        ulps = (excess / bf16_ulp(want16)).max().item()
        plan = fp.launch_plan(*images.shape, 112, 112)
        say(f"  preprocess {label} {tuple(images.shape)} -> 112: f32 "
            f"max_abs={err32:.3g}, bf16 max {ulps:.2f} ulp beyond 1e-4; plan "
            f"cluster {plan['cluster']}, band {plan['band_rows']} rows, "
            f"{plan['threads']} threads ({plan['tr']} rows of {plan['tc']} "
            f"columns) x {plan['vals']} values, {plan['ctas_an_sm']} CTAs an "
            f"SM, copy {plan['copy']}, persist {plan['persist']}, "
            f"{len(plan['chunks'])} "
            f"chunks, {len(plan['segs'])} runs, {plan['smem_bytes']} B smem")
        expect(err32 <= 1e-4, f"preprocess f32 max_abs {err32} > 1e-4")
        expect(ulps <= 1.0, f"preprocess bf16 {ulps} ulp > 1 beyond 1e-4")
        if label == "constant image":
            expect(got.abs().max().item() == 0 and
                   got16.float().abs().max().item() == 0,
                   "constant image: std floor did not give zeros")
        pre_err = max(pre_err, err32)
    del frames

    block_stats: list = []
    for (shape, entry, tail, folded), name in zip(
            stage_operands("resnet_v1_50", "imagenet", 0),
            ("28x28", "14x14", "7x7", "4x4")):
        x = torch.relu(torch.randn((256, *shape), generator=g, device="cuda")
                       ).to(torch.bfloat16)
        check_block_stack(name, x, entry, tail, folded, block_stats)
    face = stage_operands("resnet_v1_50", "face", 1)
    for idx, name in ((0, "face 56x56"), (3, "face 7x7")):
        shape, entry, tail, folded = face[idx]
        x = torch.relu(torch.randn((64, *shape), generator=g, device="cuda")
                       ).to(torch.bfloat16)
        check_block_stack(name, x, entry, tail, folded, [])

    # ---- 4. slice: the e2e chain on the card, held against f32 module
    from tf_face_toolbox_tpu_torch.extract import make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables

    faces = u8[:128]
    forward = bench.build_forward(impl="fused", e2e=True)
    fp.fused_preprocess.launches = 0
    fb.fused_bottleneck_block.launches = 0
    emb = forward(faces)
    torch.cuda.synchronize()
    launches = {"preprocess": fp.fused_preprocess.launches,
                "fused_block": fb.fused_bottleneck_block.launches}
    net32 = create_network("resnet_v1_50", stem="imagenet")
    load_jax_variables(net32, random_variables(net32, 0)).to("cuda")
    pixels = fp.fused_preprocess_reference(
        faces, torch.zeros(128, device="cuda"), out_h=112, out_w=112)
    ref = make_extract_fn(net32)(pixels)
    norms = emb.norm(dim=1)
    cos = per_image_cos(emb, ref)
    mean = ref.mean(0, keepdim=True)
    centered = per_image_cos(emb - mean, ref - mean)
    say(f"[4 slice] resnet_v1_50 imagenet bf16, 128 u8 faces 120->112: "
        f"emb {tuple(emb.shape)} {emb.dtype}, |norm-1| max "
        f"{(norms - 1).abs().max().item():.2e}, cos vs f32 module min "
        f"{cos.min().item():.6f}, batch-centered cos min "
        f"{centered.min().item():.4f}, launches {launches}")
    expect(tuple(emb.shape) == (128, 512) and emb.dtype == torch.float32,
           "embedding shape/dtype")
    expect(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    expect((norms - 1).abs().max().item() < 1e-4, "embeddings not unit norm")
    expect(cos.min().item() >= 0.999, "cosine vs f32 module path < 0.999")
    # random weights give every face a large shared component, so the
    # plain cosine is lenient; the centered one still catches a wrong
    # block (bf16 rounding alone leaves it near 0.99)
    expect(centered.min().item() >= 0.95, "batch-centered cosine < 0.95")
    expect(launches == {"preprocess": 1, "fused_block": 13},
           f"launch counts {launches}, want preprocess 1, fused_block 13 "
           "(3 + 3 + 5 + 2)")

    # ---- 5. CLIs
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    shard = os.path.join(work, "faces.faceshard")
    npz = os.path.join(work, "r50_imagenet_seed0.npz")
    out_npy = os.path.join(work, "emb.npy")
    pairs = os.path.join(work, "pairs.txt")
    cli_faces = torch.randint(0, 256, (400, 120, 120, 3), generator=g,
                              device="cuda", dtype=torch.uint8).cpu().numpy()
    pack_arrays(shard, cli_faces, list(range(400)))
    save_variables_npz(npz, random_variables(net32, 0))
    with open(pairs, "w") as f:
        for i in range(200):
            f.write(f"{i} {(i + 200) if i % 2 else i + 1} {1 - i % 2}\n")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--engine", "fused", "--stem", "imagenet", "--variables_npz", npz,
         "--data", shard, "--output", out_npy, "--crop_from", "120",
         "--batch", "128", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    expect(proc.returncode == 0, f"cli.extract failed:\n{proc.stderr[-3000:]}")
    emb_cli = np.load(out_npy)
    expect(emb_cli.shape == (400, 512) and np.isfinite(emb_cli).all(),
           f"cli.extract wrote {emb_cli.shape}")
    expect(np.abs(np.linalg.norm(emb_cli, axis=1) - 1).max() < 1e-4,
           "cli.extract embeddings not unit norm")
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.eval_lfw",
         "--embeddings", out_npy, "--pairs", pairs],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    expect(proc.returncode == 0, f"cli.eval_lfw failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    keys = {"accuracy_mean", "accuracy_std", "fold_accuracies",
            "fold_thresholds", "tar@far=0.1", "auc", "eer"}
    expect(keys <= report.keys() and len(report["fold_accuracies"]) == 10,
           f"eval_lfw report keys {sorted(report)}")
    say(f"[5 CLIs] extract --engine fused: {emb_cli.shape} unit-norm; "
        f"eval_lfw: 200 pairs, 10 folds, keys ok (random weights: "
        f"accuracy {report['accuracy_mean']:.3f} means nothing); "
        f"{time.time() - t0:.1f} s")

    # ---- 6. times (informational)
    from tf_face_toolbox_tpu_torch import bench_preprocess as bp

    # kernel 1, eval path: warm (one input) and cold (rotating over 7
    # batches, 77 MB of u8, past the 50 MB L2), eager and graph replays
    batches = [u8] + bp.make_batches(256, bp.COLD_BATCHES - 1, seed=1)
    pre = bp.readings(lambda x: fp.fused_eval_preprocess(
        x, 112, 112, out_dtype=torch.bfloat16), batches)
    zeros = torch.zeros(256, device="cuda")
    pre_plain = bench.time_ms(lambda: fp.fused_preprocess_reference(
        u8, zeros, out_h=112, out_w=112))
    route_err = (bp.library_route(u8, None, dtype=torch.float32)
                 - fp.fused_preprocess_reference(u8, zeros, out_h=112,
                                                 out_w=112)).abs().max().item()
    route = bp.library_readings(u8)
    del batches
    # u8 in, bf16 out, the flip flags; per output value 2 taps on each
    # axis (6 flops) and the standardization (5)
    pre_bound = bound(u8.numel() + u8.shape[0] * (112 * 112 * 3 * 2 + 4),
                      11 * u8.shape[0] * 112 * 112 * 3, "float32")
    say(f"[6 times] {gpu}")
    say(f"  preprocess (256,120,120,3) u8 -> bf16 112, eval path: kernel "
        f"eager warm {pre['ms']:.4f} / cold {pre['cold_ms']:.4f} ms, graph "
        f"replays warm {pre['graph_ms']:.4f} / cold {pre['cold_graph_ms']:.4f} "
        f"ms; plain (f32) {pre_plain:.3f} ms; bound {pre_bound[0]:.4f} ms "
        f"({pre_bound[1]}), {pre_bound[0] / pre['cold_graph_ms']:.1%} of it "
        f"(cold graph); library route (F.interpolate + standardize, bf16) "
        f"eager {route['ms']:.4f} / graph {route['graph_ms']:.4f} ms, max "
        f"|route - plain| {route_err:.3g} (f32)")
    for s in block_stats:
        lo, hi = s["library_route_range"]
        say(f"  fused_block stage {s['stage']} b256: kernel {s['ms']:.3f} ms "
            f"(graph replay {s['graph_ms']:.3f}), plain {s['plain_ms']:.3f} "
            f"ms, library route (folded cuDNN/cuBLAS blocks) "
            f"{s['library_route_ms']:.3f} ms ({lo:.3f}-{hi:.3f}; graph "
            f"replay {s['library_route_graph_ms']:.3f}), bound "
            f"{s['bound_ms']:.3f} ms ({s['bound_by']})")
    # one build an engine: its plain and e2e forwards share the weights
    rows = {}
    for impl in bench.IMPLS:
        e2e_fwd = bench.build_forward(impl=impl, e2e=True)
        for batch in (128, 256):
            for e2e in (False, True):
                rows[batch, e2e, impl] = bench.measure(
                    e2e_fwd if e2e else e2e_fwd.plain,
                    bench.make_inputs(batch, e2e), iters=5, warmup=2,
                    repeats=3)
        del e2e_fwd
        torch.cuda.empty_cache()
    for (batch, e2e, impl), r in sorted(rows.items(), key=lambda kv: (
            kv[0][0], kv[0][1], bench.IMPLS.index(kv[0][2]))):
        say(f"  bench impl={impl:6s} e2e={int(e2e)} batch={batch}: "
            f"{r['value']:.1f} faces/s (min {r['min']:.1f}, max "
            f"{r['max']:.1f}), {r['ms_per_batch']:.2f} ms/batch")

    # ---- 7-10. 1:N search: top-k kernels, gallery slice, CLIs, times
    topk_err = phase_topk_kernels(g)
    topk_launches = phase_gallery_slice(g, np.concatenate(
        [emb.cpu().numpy(), emb_cli]))
    phase_gallery_clis(work, out_npy)
    say(f"[10 gallery times] {gpu}")
    topk_times = phase_gallery_times(g)
    for r in gallery_search_latency(1 << 20, ("float32", "int8")):
        say(f"  DeviceGallery({r['dtype']}).search {r['rows']} rows B={r['batch']} "
            f"k=5: host p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms over "
            f"50 searches")
    # ---- 11. training
    train = phase_train(g, work)
    # ---- 12. checkpoints: train -> preempt -> resume -> serve
    ckpt = phase_checkpoint(g, work)
    # ---- 13. data-parallel training (config 5), through torchrun
    dp = phase_data_parallel(work, train["time"]["faces_per_sec"],
                             ckpt.pop("data_parallel_runs"))
    # ---- 14. the class-sharded Partial-FC head (config 7)
    pfc = phase_partial_fc(work, train["time"]["faces_per_sec"])
    # ---- 15. the loss heads (preset 8, MagFace, Curricular, center,
    # triplet)
    heads = phase_loss_heads(g, work, train["time"]["faces_per_sec"],
                             pfc.pop("loss_heads_runs"))
    # ---- 16. SE-ResNet, ResNeXt, SE-ResNeXt, DenseNet, space2depth
    backbones = phase_backbones(g, u8, work, train["time"]["faces_per_sec"])
    # ---- 17. the rest of extraction: resumable chunks, quality, ranks
    extract17 = phase_extract_resume(g, work)
    # ---- 18. IJB templates at IJB-C's 1:1 counts
    phase_templates(g, work)
    # ---- 19. Adam, AdamW, LARS; distillation from phase 12's checkpoint
    opt19 = phase_optimizers(g, work, os.path.join(work, "ckpt_run"),
                             train["time"]["faces_per_sec"])
    # ---- 20. the data layer: importers, merge, export, imported LFW
    data20 = phase_data_layer(
        g, work, overlap=lambda bundle, faces: daemon_setup(g, work, bundle,
                                                            faces))
    # ---- 21. the daemon: bundle boot, 1:N endpoints, reload, drain
    daemon = phase_daemon(
        g, work, data20,
        backbones["nets"]["resnet_v1_50/face"]["faces_per_sec"])
    # ---- 22. the sharded gallery at 4 x 10^6 rows, kernels 3 and 4 a shard;
    # phase 23's and 24's CLI runs go beside its host work
    zoo = start_zoo_clis(g, work)
    zoo["dct"] = start_dct_clis(work, zoo["shard"])
    zoo["int8"] = int8 = start_int8_clis(work)
    zoo["item19"] = start_item19_clis(work, zoo["shard"])
    sharded = phase_sharded_gallery(g, work, data20, daemon, zoo)
    # ---- 23. iResNet and MobileFaceNet at full width
    zoo23 = phase_zoo(g, zoo,
                      backbones["nets"]["resnet_v1_50/face"]["faces_per_sec"])
    # ---- 24. the DCT input, dct_resnet_50 and the ViT family
    dct24 = phase_dct(g, zoo["dct"], zoo23["r50_module_faces_per_sec"], work)
    # ---- 25. int8 serving and QAT at full width
    int8_25 = phase_int8(
        g, int8, work, daemon,
        backbones["nets"]["resnet_v1_50/face"]["e2e_faces_per_sec"])
    # ---- 26. alignment, the iResNet interop, the acceptance runner
    phase_item19(g, zoo["item19"], zoo)

    t_topk = next(r for r in topk_times if r["dtype"] == "bfloat16"
                  and r["rows"] == 10_000_000 and r["batch"] == 64)
    t_topk_f32 = next(r for r in topk_times if r["dtype"] == "float32"
                      and r["rows"] == 1 << 20 and r["batch"] == 64)
    t_topk_q = next(r for r in topk_times if r["dtype"] == "int8"
                    and r["rows"] == 10_000_000 and r["batch"] == 64)

    block_ms = sum(s["ms"] for s in block_stats)
    block_bound = sum(s["bound_ms"] for s in block_stats)
    by = {s["bound_by"] for s in block_stats}
    # library_ms: no single PyTorch call computes any of the four (the
    # top-k's library route is a matmul and torch.topk: two calls; the
    # fused blocks' is the folded engine's convs and elementwise ops)
    kernels = [
        {"name": "preprocess", "route": "cuda",
         "source": "tf_face_toolbox_tpu_torch/csrc/preprocess.cu",
         "replaces": "tf_face_toolbox_tpu/ops/pallas_preprocess.py:64",
         "launches": launches["preprocess"], "max_abs_err": pre_err,
         "ms": pre["ms"], "plain_ms": pre_plain, "bound_ms": pre_bound[0],
         "bound_by": pre_bound[1],
         "bound_share": pre_bound[0] / pre["cold_graph_ms"],
         "bound_share_of": "cold_graph_ms",
         "library_ms": None, "graph_ms": pre["graph_ms"],
         "cold_ms": pre["cold_ms"], "cold_graph_ms": pre["cold_graph_ms"],
         "library_route_ms": route["ms"],
         "library_route_graph_ms": route["graph_ms"],
         "library_route_max_abs": route_err,
         # the training path: (256, 112, 112, 3) crops, identity resize,
         # random flips -> bf16; launches in cli.train's TRAIN_STEPS steps
         "train_launches": train["launches"],
         "train_max_abs_err": train["max_abs_err"], "train_ms": train["ms"],
         "train_plain_ms": train["plain_ms"],
         "train_bound_ms": train["bound_ms"],
         "train_bound_by": train["bound_by"],
         "train_bound_share": train["bound_ms"] / train["ms"],
         "train_library_route_ms": train["library_route_ms"],
         # phase 12's cli.train runs (preempted at step k, resumed to 20)
         "checkpoint_train_launches": ckpt["launches"],
         "checkpoint_train_steps": [ckpt["k"], 20 - ckpt["k"]],
         # phase 13: config 5 under torchrun (PRESET_STEPS, one rank), and
         # each of two gloo ranks on cuda:0 (2 steps)
         "data_parallel_launches": dp["cli_launches"],
         "data_parallel_steps": PRESET_STEPS,
         "data_parallel_rank_launches": dp["rank_launches"],
         # phase 14: config 7 through cli.train (PRESET_STEPS, one rank), and
         # each of four gloo ranks on cuda:0 (2 steps a head)
         "partial_fc_launches": pfc["cli_launches"],
         "partial_fc_steps": PRESET_STEPS,
         "partial_fc_rank_launches": {h: pfc[h]["launches"]
                                      for h in ("exact", "sampled")},
         # phase 15: preset 8 through cli.train (PRESET_STEPS), one step a
         # head through each route, and each of four gloo ranks on
         # cuda:0 (2 steps a head)
         "loss_heads_launches": heads["cli_launches"],
         "loss_heads_steps": PRESET_STEPS,
         "loss_heads_route_launches": {
             h: r["launches"]["kernel"] for h, r in heads["routes"].items()},
         "loss_heads_rank_launches": {h: r["launches"]
                                      for h, r in heads["grid"].items()},
         # phase 16: one launch a batch of each new backbone's e2e
         # extraction, and one a step of its cli.train (5 steps)
         "backbones_e2e_launches": {k: v["e2e_launches"] for k, v in
                                    backbones["nets"].items()},
         "backbones_train_launches": {k: v["launches"] for k, v in
                                      backbones["train"].items()},
         "backbones_train_steps": 5,
         # phase 19: cli.train OPT_STEPS under each optimizer, and as many
         # steps distilling at each alpha
         "optimizers_launches": opt19["cli_launches"],
         "distill_launches": {str(a): d["launches"]
                              for a, d in opt19["distill"].items()},
         "optimizers_steps": OPT_STEPS,
         # phase 24: one launch a batch of each DCT net's e2e extraction,
         # one a step of dct_vit_small's cli.train (5 steps), and one in
         # the DCT-input step (after decode_dct, on the decoded frames)
         "dct_e2e_launches": {k: v["e2e_launches"]
                              for k, v in dct24["extract"].items()},
         "dct_train_launches": dct24["train"]["dct_vit_small"]["launches"],
         "dct_train_steps": DCT_STEPS,
         "dct_step_launches": dct24["dct_step"]["launches"],
         # phase 25: one launch a batch of the dynamic and static int8
         # module paths' e2e extraction, one a step of cli.train --qat
         "int8_e2e_launches": {k: v["preprocess"] for k, v in
                               int8_25["launches"].items()},
         "qat_train_launches": int8_25["qat"]["launches"],
         "qat_train_steps": QAT_STEPS},
        {"name": "fused_block", "route": "cuda",
         "source": "tf_face_toolbox_tpu_torch/csrc/fused_block.cu",
         "replaces": "tf_face_toolbox_tpu/serving/fused_block.py:122",
         "launches": launches["fused_block"],
         "max_abs_err": max(s["max_abs_err"]
                            for s in (*block_stats, *ckpt["face_stages"])),
         "ms": block_ms, "plain_ms": sum(s["plain_ms"] for s in block_stats),
         "bound_ms": block_bound,
         "bound_by": by.pop() if len(by) == 1 else "bytes and operations",
         "bound_share": block_bound / block_ms, "library_ms": None,
         "library_route_ms": sum(s["library_route_ms"] for s in block_stats),
         "graph_ms": sum(s["graph_ms"] for s in block_stats),
         "library_route_graph_ms": sum(s["library_route_graph_ms"]
                                       for s in block_stats),
         # phase 12: cli.extract --checkpoint_dir --engine fused (face
         # stem), and each trained stage's stack (56, 28, 14, 7) on the
         # activations the main path gives it
         "checkpoint_launches": ckpt["extract_launches"],
         "checkpoint_stages": [
             {k: v for k, v in st.items() if k != "library_route_range"}
             for st in ckpt["face_stages"]],
         # phase 16: resnet_v1_50 at the space2depth stem (a stride-1
         # entry block at 56x56), 256 images, and se_resnet_50 fused
         # (its SE stages stay folded: 0 launches)
         "space2depth": backbones["space2depth"],
         # phase 17: cli.extract --engine fused, 4,096 faces at batch
         # 256: one shot, the chunked run killed and its rerun, and 128
         # faces with --output_quality
         "extract_resume_launches": extract17["launches"],
         # phase 20: cli.extract --engine fused on the 12,000 imported LFW
         # faces, from the checkpoint and from its bundle (batch 256)
         "data_layer_launches": data20["extract_launches"]},
    ]
    for name, row, replaces in (("topk", t_topk, 118), ("topk_q", t_topk_q, 194)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tf_face_toolbox_tpu_torch/csrc/topk.cu",
            "replaces": f"tf_face_toolbox_tpu/ops/pallas_topk.py:{replaces}",
            "launches": topk_launches[name], "max_abs_err": topk_err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_share": row["bound_share"], "library_ms": None,
            "library_route_ms": row["library_route_ms"],
            # phase 21: the daemon's /identify, one search each (f32
            # gallery: kernel 3; int8 gallery: kernel 4)
            "daemon_launches": daemon["launches"][name],
            # phase 22: one launch a shard a search of the 4 x 10^6-row
            # four-shard stores (bf16: kernel 3; int8: kernel 4) and of the
            # in-process daemon's four-shard gallery (kernel 3); the
            # --gallery_shards -1 daemon's /identify (one shard)
            "sharded_launches": sharded["launches"][name],
            "sharded_daemon_launches": (sharded["served_launches"]
                                        if name == "topk" else 0),
            # phase 25: the static-int8 daemon's /identify, one search
            # each (f32 gallery: kernel 3; int8 gallery: kernel 4)
            "int8_daemon_launches": int8_25["daemon_launches"][name],
            "sharded_search_ms": {
                tag: {"sharded": ms, "one_store": one_ms}
                for tag, (ms, one_ms) in sharded["times_ms"].items()
                if tag.startswith("int8" if name == "topk_q" else "bf16")}})
    kernels[2].update(f32_ms=t_topk_f32["ms"], f32_plain_ms=t_topk_f32["plain_ms"])
    say(json.dumps({"kernels": kernels}))
    say(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
