"""One-command acceptance runner: the BASELINE contract through the
port's CLIs.

Counterpart of ``tools/acceptance.py``, run as a module:

    python -m tf_face_toolbox_tpu_torch.acceptance \
        --data=/data/lfw                  # LFW dir (Name/Name_0001.jpg) \
        --pairs=/data/pairs.txt           # official LFW view-2 pairs \
        --checkpoint_dir=/models/run1     # the model under acceptance \
        --reference_ckpt=/ref/model.ckpt-90000   # TF1 Saver prefix \
        --reference_accuracy=0.9963       # the TF baseline's LFW number \
        --int8                            # also gate static-int8 serving \
        --compare_checkpoint_dir=/models/dct_run \
        --compare_network=dct_resnet_50   # CONFIG_6-vs-face-stem gate \
        --workdir=/tmp/acceptance [--device cuda]

BASELINE.json's north star has two accuracy bars:

  A. LFW verification accuracy within 0.1% of the TF baseline.
  B. Per-face embedding cosine >= 0.999 vs the reference.

Stages (each a port CLI, ``python -m tf_face_toolbox_tpu_torch.cli.<x>``,
run as a subprocess exactly as a user would run it):

  1. pack         --data dir -> FaceShard (+ a recoded shard when a
                  dct_domain model is under test)
  2. import       --reference_ckpt -> .npz via cli.import_tf1 (the
                  reference's own weights served by the port)
  3. extract      flip-averaged L2-normalized embeddings for: the model
                  under test, the imported reference weights (parity
                  baseline), the int8 variant, the compare model
  4. eval         cli.eval_lfw 10-fold on each embedding set (and
                  cli.eval_identification for --identification)
  5. gates        cosine/accuracy thresholds -> acceptance_report.json,
                  one PASS/FAIL line, exit code

Gate semantics (thresholds are flags; defaults = the BASELINE bars):

  per_face_cosine_vs_reference   min cosine >= 0.999 against
      --reference_embeddings (golden rows in pack-list order) or, if
      absent, against embeddings extracted from the imported
      --reference_ckpt weights.
  lfw_accuracy_vs_reference      |acc - ref| <= 0.001 against
      --reference_accuracy or, if absent, the imported-weights eval.
  compare_accuracy (CONFIG_6)    acc_compare >= acc_primary - 0.001.
  int8_cosine / int8_accuracy    static-int8 serving of the SAME
      weights: min cosine vs fp >= --int8_cosine (default 0.995) and
      accuracy within --int8_accuracy_tol (default 0.002).
  identification (--identification)  the 1:N serving contract: the
      packed set splits per identity (first image of every multi-image
      identity -> gallery, the rest -> mated probes, single-image
      identities -> non-mated distractors), cli.eval_identification
      computes CMC@1 + DIR@FAR off the SAME embeddings, and the
      primary-vs-reference deltas gate at --accuracy_tol / --dir_tol.
      --min_cmc1 / --min_dir add absolute serving-mode bars.

Exit codes: 0 = all evaluable gates PASS; 1 = any gate FAIL;
2 = NO_REFERENCE (pipeline ran end-to-end, accuracy reported, but no
reference artifact was provided so bars A/B remain pending).

The flags and defaults are ``tools/acceptance.py``'s; the one new flag,
``--device`` (default cuda), goes to the CLIs that touch a device
(cli.extract, cli.eval_identification). Nothing falls back to the CPU:
pass ``--device cpu`` for a host run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# the directory holding the package: the CLI subprocesses import it from
# there, whatever the caller's working directory
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def log(msg: str) -> None:
    print(f"[acceptance] {msg}", flush=True)


def run_cli(module: str, args: list[str]) -> str:
    """Run one CLI entry point as a subprocess (flag namespaces collide
    in-process by design — one binary per entry point). Returns stdout."""
    cmd = [sys.executable, "-m",
           f"tf_face_toolbox_tpu_torch.cli.{module}"] + args
    log("$ " + " ".join(cmd[2:]))
    path = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ,
               PYTHONPATH=ROOT + (os.pathsep + path if path else ""))
    r = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if r.returncode != 0:
        sys.stderr.write(r.stdout + "\n" + r.stderr + "\n")
        raise SystemExit(
            f"stage failed: cli.{module} exited {r.returncode}")
    return r.stdout


def run_cli_json(module: str, args: list[str]) -> dict:
    out = run_cli(module, args)
    start = out.index("{")
    return json.loads(out[start:])


def build_list(data_dir: str, list_path: str) -> int:
    """LFW layout (``<dir>/<Name>/<Name>_0001.jpg``) -> pack list file
    (``relative/path label`` lines, identities labeled in sorted order).
    Flat directories of images work too (one label per file stem prefix
    before the trailing ``_<num>``, else one label per file)."""
    entries: list[tuple[str, str]] = []   # (relpath, identity_key)
    for root, dirs, files in os.walk(data_dir):
        dirs.sort()
        for f in sorted(files):
            if not f.lower().endswith(IMG_EXTS):
                continue
            rel = os.path.relpath(os.path.join(root, f), data_dir)
            parent = os.path.dirname(rel)
            if parent:
                ident = parent            # LFW: one dir per person
            else:
                stem = os.path.splitext(f)[0]
                name, _, num = stem.rpartition("_")
                ident = name if (name and num.isdigit()) else stem
            entries.append((rel, ident))
    if not entries:
        raise SystemExit(f"--data={data_dir}: no images found")
    labels = {k: i for i, k in enumerate(
        sorted({ident for _, ident in entries}))}
    with open(list_path, "w") as f:
        for rel, ident in entries:
            f.write(f"{rel} {labels[ident]}\n")
    log(f"listed {len(entries)} images / {len(labels)} identities")
    return len(entries)


def load_emb(path: str) -> np.ndarray:
    from tf_face_toolbox_tpu_torch.io import load_embeddings

    emb, _ = load_embeddings(path)
    emb = np.asarray(emb, np.float32)
    n = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(n, 1e-12)


def cosine_stats(a_path: str, b_path: str) -> dict:
    a, b = load_emb(a_path), load_emb(b_path)
    if a.shape != b.shape:
        raise SystemExit(
            f"embedding shape mismatch: {a_path} {a.shape} vs "
            f"{b_path} {b.shape} — reference rows must follow the SAME "
            "pack list order")
    cos = np.sum(a * b, axis=1)
    return {"min": float(cos.min()), "mean": float(cos.mean()),
            "p1": float(np.percentile(cos, 1.0)), "n": int(len(cos))}


def identification_split(names_path: str) -> tuple[list[int], list[int]]:
    """Pack-list rows -> (gallery_rows, probe_rows) for the 1:N stage.

    The first image of every multi-image identity enrolls; its
    remaining images become mated probes. Single-image identities
    cannot be both enrolled and probed, so they serve as the open-set
    non-mated (distractor) probe set — exactly the IJB-style watchlist
    split, derived deterministically from the pack list alone so the
    reference embeddings (same row order) split identically.
    """
    by_label: dict[str, list[int]] = {}
    with open(names_path) as f:
        row = 0                 # numbering must skip blank lines, the
        for line in f:          # same way the packer/extractor do —
            parts = line.split()  # else every row after an interior
            if not parts:         # blank is off by one
                continue
            by_label.setdefault(parts[-1], []).append(row)
            row += 1
    gallery_rows: list[int] = []
    probe_rows: list[int] = []
    for rows in by_label.values():
        if len(rows) >= 2:
            gallery_rows.append(rows[0])
            probe_rows.extend(rows[1:])
        else:
            probe_rows.extend(rows)      # non-mated distractor
    if not gallery_rows:
        raise SystemExit(
            "--identification: every identity has a single image — "
            "nothing can be enrolled AND probed")
    return sorted(gallery_rows), sorted(probe_rows)


def model_flags(ns: argparse.Namespace, prefix: str = "") -> list[str]:
    """Translate the tool's model args into cli.extract/eval flags."""
    g = lambda k: getattr(ns, prefix + k)  # noqa: E731
    flags = [f"--network={g('network')}",
             f"--embedding_dim={g('embedding_dim')}",
             f"--image_size={g('image_size')}",
             f"--input_norm={g('input_norm')}",
             f"--head={g('head')}",
             f"--batch={ns.batch}",
             f"--loader={g('loader')}"]
    if not g("network").startswith("dct"):
        flags.append(f"--stem={g('stem')}")
    if not ns.bf16:
        flags.append("--nobf16")
    return flags


def source_flags(ns: argparse.Namespace, prefix: str = "") -> list[str]:
    g = lambda k: getattr(ns, prefix + k)  # noqa: E731
    given = [(k, g(k)) for k in ("checkpoint_dir", "variables_npz",
                                 "bundle") if g(k)]
    if len(given) != 1:
        which = "--compare_*" if prefix else "--"
        raise SystemExit(
            f"exactly one model source required ({which}checkpoint_dir |"
            f" {which}variables_npz | {which}bundle); got "
            f"{[k for k, _ in given] or 'none'}")
    k, v = given[0]
    return [f"--{k}={v}"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", required=True,
                   help="LFW-layout image directory OR a prepacked "
                        ".faceshard (then pass --names)")
    p.add_argument("--pairs", required=True,
                   help="official LFW pairs.txt or 'idx1 idx2 label'")
    p.add_argument("--names", default="",
                   help="pack list file when --data is a prepacked "
                        "shard (row order of the embeddings)")
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--workdir", required=True)
    # model under acceptance
    p.add_argument("--checkpoint_dir", default="")
    p.add_argument("--variables_npz", default="")
    p.add_argument("--bundle", default="")
    p.add_argument("--network", default="resnet_v1_50")
    p.add_argument("--stem", default="face")
    p.add_argument("--head", default="gap")
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--image_size", type=int, default=112)
    p.add_argument("--input_norm", default="per_image")
    p.add_argument("--loader", default="auto")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True)
    # reference artifacts (any subset; more artifacts -> more gates)
    p.add_argument("--reference_embeddings", default="",
                   help="golden per-face embeddings from the reference "
                        "(.npy/.mat/.bin), rows in pack-list order")
    p.add_argument("--reference_accuracy", type=float, default=float("nan"),
                   help="the TF baseline's LFW accuracy (e.g. 0.9963)")
    p.add_argument("--reference_ckpt", default="",
                   help="TF1 Saver checkpoint prefix; imported via "
                        "cli.import_tf1 and used as the parity baseline")
    p.add_argument("--reference_scope", default="",
                   help="cli.import_tf1 --scope for the reference ckpt")
    p.add_argument("--reference_use_ema", action="store_true",
                   help="import the reference's EMA shadows (what the "
                        "era's extract scripts served)")
    # optional serving-mode gates
    p.add_argument("--int8", action="store_true",
                   help="also gate static-int8 serving of the same "
                        "weights (cosine vs fp + accuracy)")
    p.add_argument("--compare_checkpoint_dir", default="")
    p.add_argument("--compare_variables_npz", default="")
    p.add_argument("--compare_bundle", default="")
    p.add_argument("--compare_network", default="dct_resnet_50")
    p.add_argument("--compare_stem", default="face")
    p.add_argument("--compare_head", default="gap")
    p.add_argument("--compare_embedding_dim", type=int, default=512)
    p.add_argument("--compare_image_size", type=int, default=112)
    p.add_argument("--compare_input_norm", default="per_image")
    p.add_argument("--compare_loader", default="auto")
    # optional 1:N identification gates (BASELINE's serving story)
    p.add_argument("--identification", action="store_true",
                   help="also run the 1:N split (enroll first image "
                        "per identity, probe the rest) and gate "
                        "CMC@1 + DIR@FAR")
    p.add_argument("--identification_far", default="1e-2",
                   help="comma-separated FAR operating points for "
                        "DIR@FAR")
    p.add_argument("--identification_rank", type=int, default=1,
                   help="rank within which a mated probe must land "
                        "(CMC rank / dir_rank)")
    p.add_argument("--min_cmc1", type=float, default=float("nan"),
                   help="absolute CMC@rank bar (serving-mode gate; "
                        "NaN = report only)")
    p.add_argument("--min_dir", type=float, default=float("nan"),
                   help="absolute DIR at the first --identification_"
                        "far bar (NaN = report only)")
    # thresholds (defaults = the BASELINE bars)
    p.add_argument("--cosine_threshold", type=float, default=0.999)
    p.add_argument("--accuracy_tol", type=float, default=0.001)
    p.add_argument("--dir_tol", type=float, default=0.01,
                   help="|DIR@FAR - reference| tolerance (DIR rides "
                        "an order statistic of the non-mated set, so "
                        "it is noisier than accuracy)")
    p.add_argument("--int8_cosine", type=float, default=0.995)
    p.add_argument("--int8_accuracy_tol", type=float, default=0.002)
    p.add_argument("--device", default="cuda",
                   help="torch device of cli.extract and "
                        "cli.eval_identification")
    ns = p.parse_args(argv)
    device = [f"--device={ns.device}"]

    os.makedirs(ns.workdir, exist_ok=True)
    report: dict = {"stages": {}, "gates": []}

    def gate(name: str, value: float, threshold: float, ok: bool,
             detail: dict | None = None) -> None:
        report["gates"].append({
            "gate": name, "value": value, "threshold": threshold,
            "pass": bool(ok), **({"detail": detail} if detail else {})})
        log(f"gate {name}: value={value:.6g} threshold={threshold:g} "
            f"-> {'PASS' if ok else 'FAIL'}")

    # ---- stage 1: pack --------------------------------------------------
    compare_given = bool(ns.compare_checkpoint_dir
                         or ns.compare_variables_npz or ns.compare_bundle)
    if ns.data.endswith(".faceshard"):
        if not ns.names:
            raise SystemExit("--data is a prepacked shard: pass --names="
                             "<the pack list it was built from>")
        shard, names = ns.data, ns.names
    else:
        names = os.path.join(ns.workdir, "list.txt")
        build_list(ns.data, names)
        shard = os.path.join(ns.workdir, "data.faceshard")
        run_cli("pack", [f"--list={names}", f"--root={ns.data}",
                         f"--output={shard}"])
    report["stages"]["shard"] = shard
    report["stages"]["names"] = names

    def dct_shard_for(image_size: int) -> str:
        """dct_domain loaders need a 4:4:4 shard recoded at the eval
        geometry; built once per size, from the same list."""
        if ns.data.endswith(".faceshard"):
            raise SystemExit(
                "a dct_domain model needs a recoded shard; pass the "
                "image DIRECTORY as --data so the tool can pack it "
                f"(--recode_size={image_size})")
        path = os.path.join(ns.workdir, f"data_dct{image_size}.faceshard")
        if not os.path.exists(path):
            run_cli("pack", [f"--list={names}", f"--root={ns.data}",
                             f"--output={path}",
                             f"--recode_size={image_size}"])
        return path

    def shard_for(prefix: str) -> str:
        net = getattr(ns, prefix + "network")
        loader = getattr(ns, prefix + "loader")
        if loader == "dct_domain" or (loader == "auto"
                                      and net.startswith("dct_")):
            if getattr(ns, prefix + "loader") == "auto":
                setattr(ns, prefix + "loader", "dct_domain")
            return dct_shard_for(getattr(ns, prefix + "image_size"))
        return shard

    # ---- stage 2: import the reference checkpoint -----------------------
    ref_vars = ""
    if ns.reference_ckpt:
        ref_vars = os.path.join(ns.workdir, "reference_imported.npz")
        args = [f"--checkpoint={ns.reference_ckpt}",
                f"--output={ref_vars}", f"--network={ns.network}",
                f"--stem={ns.stem}", f"--head={ns.head}",
                f"--embedding_dim={ns.embedding_dim}",
                f"--image_size={ns.image_size}"]
        if ns.reference_scope:
            args.append(f"--scope={ns.reference_scope}")
        if ns.reference_use_ema:
            args.append("--use_ema")
        run_cli("import_tf1", args)
        report["stages"]["reference_imported"] = ref_vars

    # the model under test: explicit source, else the imported reference
    # weights themselves (the "switch frameworks, keep the model" path)
    mut_is_imported_ref = False
    if not (ns.checkpoint_dir or ns.variables_npz or ns.bundle):
        if not ref_vars:
            raise SystemExit(
                "no model to accept: pass --checkpoint_dir / "
                "--variables_npz / --bundle (or --reference_ckpt alone "
                "to accept the imported reference weights)")
        ns.variables_npz = ref_vars
        mut_is_imported_ref = True

    # ---- stage 3+4: extract + eval the model under test -----------------
    def extract_and_eval(tag: str, src: list[str], mflags: list[str],
                         data: str, extra: list[str] = ()) -> tuple[str, dict]:
        emb = os.path.join(ns.workdir, f"emb_{tag}.npy")
        run_cli("extract", src + mflags + list(extra) + device +
                [f"--data={data}", f"--output={emb}"])
        ev = run_cli_json("eval_lfw", [
            f"--embeddings={emb}", f"--pairs={ns.pairs}",
            f"--names={names}", f"--folds={ns.folds}"])
        log(f"{tag}: LFW accuracy {ev['accuracy_mean']:.4f} "
            f"±{ev['accuracy_std']:.4f}")
        report["stages"][f"emb_{tag}"] = emb
        report[f"eval_{tag}"] = ev
        return emb, ev

    emb_mut, eval_mut = extract_and_eval(
        "primary", source_flags(ns), model_flags(ns), shard_for(""))
    acc = float(eval_mut["accuracy_mean"])

    # ---- reference baselines --------------------------------------------
    ref_emb_path = ns.reference_embeddings
    ref_acc = ns.reference_accuracy
    if ref_vars and not mut_is_imported_ref:
        emb_ref, eval_ref = extract_and_eval(
            "reference", [f"--variables_npz={ref_vars}"],
            model_flags(ns), shard_for(""))
        ref_emb_path = ref_emb_path or emb_ref
        if np.isnan(ref_acc):
            ref_acc = float(eval_ref["accuracy_mean"])
    elif ref_emb_path and np.isnan(ref_acc):
        ev = run_cli_json("eval_lfw", [
            f"--embeddings={ref_emb_path}", f"--pairs={ns.pairs}",
            f"--names={names}", f"--folds={ns.folds}"])
        report["eval_reference"] = ev
        ref_acc = float(ev["accuracy_mean"])

    # ---- stage 5: gates --------------------------------------------------
    if ref_emb_path:
        cs = cosine_stats(emb_mut, ref_emb_path)
        gate("per_face_cosine_vs_reference", cs["min"],
             ns.cosine_threshold, cs["min"] >= ns.cosine_threshold, cs)
    if not np.isnan(ref_acc):
        delta = abs(acc - ref_acc)
        gate("lfw_accuracy_vs_reference", delta, ns.accuracy_tol,
             delta <= ns.accuracy_tol,
             {"ours": acc, "reference": ref_acc})

    # ---- optional stage: 1:N identification (CMC@rank + DIR@FAR) --------
    if ns.identification:
        g_rows, p_rows = identification_split(names)
        with open(names) as f:
            list_lines = [ln.rstrip("\n") for ln in f if ln.strip()]

        def subset_list(tag: str, rows: list[int]) -> str:
            path = os.path.join(ns.workdir, f"ident_{tag}_list.txt")
            with open(path, "w") as f:
                f.write("\n".join(list_lines[r] for r in rows) + "\n")
            return path

        g_list = subset_list("gallery", g_rows)
        p_list = subset_list("probe", p_rows)
        rank = ns.identification_rank
        log(f"identification split: {len(g_rows)} gallery / "
            f"{len(p_rows)} probes")

        def ident_eval(tag: str, emb_path: str) -> tuple[float, dict]:
            emb = load_emb(emb_path)
            gp = os.path.join(ns.workdir, f"ident_{tag}_gallery.npy")
            pp = os.path.join(ns.workdir, f"ident_{tag}_probe.npy")
            np.save(gp, emb[g_rows])
            np.save(pp, emb[p_rows])
            ev = run_cli_json("eval_identification", [
                f"--gallery={gp}", f"--gallery_list={g_list}",
                f"--probe={pp}", f"--probe_list={p_list}",
                f"--ranks={rank}", f"--far={ns.identification_far}",
                f"--dir_rank={rank}"] + device)
            report[f"identification_{tag}"] = ev
            cmc = float(ev["cmc"][str(rank)])
            # json_sanitize renders unevaluable DIR points (FAR finer
            # than 1/N_nonmated) as null — drop those from gating
            dirs = {k: float(v) for k, v in ev.get("open_set", {}).items()
                    if k.startswith("dir@")
                    and isinstance(v, (int, float))}
            log(f"identification {tag}: CMC@{rank} {cmc:.4f}" +
                "".join(f", {k} {v:.4f}" for k, v in sorted(dirs.items())))
            return cmc, dirs

        cmc1, dirs = ident_eval("primary", emb_mut)
        if not np.isnan(ns.min_cmc1):
            gate(f"identification_cmc@{rank}", cmc1, ns.min_cmc1,
                 cmc1 >= ns.min_cmc1)
        if not np.isnan(ns.min_dir):
            far0 = float(ns.identification_far.split(",")[0])
            k0 = f"dir@far={far0:g}"
            gate(f"identification_{k0}", dirs.get(k0, float("nan")),
                 ns.min_dir, k0 in dirs and dirs[k0] >= ns.min_dir)
        if ref_emb_path:
            rcmc1, rdirs = ident_eval("reference", ref_emb_path)
            d = abs(cmc1 - rcmc1)
            gate("identification_cmc1_vs_reference", d, ns.accuracy_tol,
                 d <= ns.accuracy_tol,
                 {"ours": cmc1, "reference": rcmc1, "rank": rank})
            for k in sorted(set(dirs) & set(rdirs)):
                dd = abs(dirs[k] - rdirs[k])
                gate(f"identification_{k}_vs_reference", dd, ns.dir_tol,
                     dd <= ns.dir_tol,
                     {"ours": dirs[k], "reference": rdirs[k]})

    if ns.int8:
        emb_i8, eval_i8 = extract_and_eval(
            "int8", source_flags(ns), model_flags(ns), shard_for(""),
            extra=["--quant_mode=static"])
        cs = cosine_stats(emb_i8, emb_mut)
        gate("int8_cosine_vs_fp", cs["min"], ns.int8_cosine,
             cs["min"] >= ns.int8_cosine, cs)
        d8 = acc - float(eval_i8["accuracy_mean"])
        gate("int8_accuracy_vs_fp", d8, ns.int8_accuracy_tol,
             d8 <= ns.int8_accuracy_tol,
             {"fp": acc, "int8": float(eval_i8["accuracy_mean"])})

    if compare_given:
        _, eval_cmp = extract_and_eval(
            "compare", source_flags(ns, "compare_"),
            model_flags(ns, "compare_"), shard_for("compare_"))
        acc_cmp = float(eval_cmp["accuracy_mean"])
        dc = acc - acc_cmp
        gate("compare_accuracy_vs_primary", dc, ns.accuracy_tol,
             dc <= ns.accuracy_tol,
             {"primary": acc, "compare": acc_cmp,
              "compare_network": ns.compare_network})

    # ---- verdict ---------------------------------------------------------
    ref_gates = [g for g in report["gates"] if "reference" in g["gate"]]
    all_pass = all(g["pass"] for g in report["gates"])
    if not report["gates"]:
        report["status"] = "NO_REFERENCE"
    elif not ref_gates and all_pass:
        # serving-mode gates passed but bars A/B had nothing to compare
        report["status"] = "NO_REFERENCE"
    else:
        report["status"] = "PASS" if all_pass else "FAIL"
    report["lfw_accuracy"] = acc
    out = os.path.join(ns.workdir, "acceptance_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    log(f"report -> {out}")
    if report["status"] == "NO_REFERENCE":
        log(f"NO_REFERENCE: pipeline PASSED end-to-end (LFW accuracy "
            f"{acc:.4f}) but no reference artifact was provided — bars "
            "A/B of BASELINE.json remain pending. Provide "
            "--reference_embeddings / --reference_accuracy / "
            "--reference_ckpt when they exist.")
        return 2
    log(f"{report['status']}: {sum(g['pass'] for g in report['gates'])}"
        f"/{len(report['gates'])} gates passed")
    return 0 if report["status"] == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
