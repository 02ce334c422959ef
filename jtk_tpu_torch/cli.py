"""The ``jtk`` CLI — 18 subcommands with the stdin/stdout JSON stage ABI.

Reference: ``cli/src/jtk_commands.rs`` (subcommand set + defaults) and
``cli/src/bin/jtk.rs`` (dispatch): every stage reads the DataSet JSON on stdin
and writes it on stdout, making the pipeline a shell-composable chain
(SURVEY.md §3.5); ``entry``/``polish``/``pipeline`` do file I/O instead.

Counterpart of ``jtk_tpu/cli.py`` with the same subcommands and arguments,
plus ``--device`` on every subcommand (default ``cuda``; ``--device cpu``
runs the plain PyTorch versions of the kernels) and ``--devices``, the
device set of the data-parallel paths (comma-separated, an entry may
repeat; default every visible GPU when the device is cuda;
``--devices cuda`` keeps a multi-GPU host on one card)::

    python -m jtk_tpu_torch.cli pipeline -p profile.toml [--device cpu]
    python -m jtk_tpu_torch.cli pipeline -p profile.toml --devices cuda:0,cuda:1

Defaults mirror the reference (jtk_commands.rs: chunk_len 2000 :100,
take_num 500 :108, margin 500 :116, exclude 0.8 :131, purge_copy_num 10 :140,
seed 42 :147, k 12 / freq 0.001 / min 10 :175-191, component_num 1 :269,
squish ari 0.4 / match 4.0 / mismatch -1.0 / count 7 :521-548, window 2000
:581, min_llr 1 :595, min_span 2 :604).
"""

from __future__ import annotations

import argparse
import logging
import sys


def _read_ds():
    from .datamodel import DataSet
    return DataSet.loads(sys.stdin.read())


def _write_ds(ds):
    sys.stdout.write(ds.dumps())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jtk", description="targeted diploid genome assembler "
        "(PyTorch/CUDA)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("entry", help="FASTA/Q -> DataSet JSON")
    sp.add_argument("--input", required=True)
    sp.add_argument("--read_type", default="CLR",
                    choices=["CCS", "CLR", "ONT", "None"])

    sp = sub.add_parser("extract", help="dump parts of the dataset to TSV")
    sp.add_argument("--target", required=True,
                    choices=["raw_reads", "encoded_reads", "chunks"])
    sp.add_argument("--output", required=True)

    sp = sub.add_parser("stats", help="summary statistics")
    sp.add_argument("--file", required=True)

    sp = sub.add_parser("select_chunks", help="sample + polish chunk set")
    sp.add_argument("--chunk_len", type=int, default=2000)
    sp.add_argument("--take_num", type=int, default=500)
    sp.add_argument("--margin", type=int, default=500)
    sp.add_argument("--exclude", type=float, default=0.8)
    sp.add_argument("--purge_copy_num", type=int, default=10)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--threads", type=int, default=1)

    sp = sub.add_parser("mask_repeats", help="mask frequent k-mers")
    sp.add_argument("--k", type=int, default=12)
    sp.add_argument("--freq", type=float, default=0.001)
    sp.add_argument("--min", type=int, default=10)

    sp = sub.add_parser("encode", help="align reads to chunks")
    sp.add_argument("--threads", type=int, default=1)
    sp.add_argument("--sim_thr", type=float, default=None)

    sp = sub.add_parser("polish_encoding", help="polish chunk consensi")

    sp = sub.add_parser("pick_components", help="keep top-N graph components")
    sp.add_argument("--component_num", type=int, default=1)

    sp = sub.add_parser("estimate_multiplicity", help="chunk copy numbers")
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--draft_assembly", default=None)
    sp.add_argument("--purge_copy_num", type=int, default=None)

    sp = sub.add_parser("partition_local", help="per-chunk phasing")
    sp.add_argument("--seed", type=int, default=42)

    sp = sub.add_parser("purge_diverged", help="purge diverged clusters")

    sp = sub.add_parser("correct_deletion", help="recover missing chunks")
    sp.add_argument("--re_cluster", action="store_true")

    sp = sub.add_parser("correct_clustering", help="global phasing smoothing")
    sp.add_argument("--repeat_num", type=int, default=5)
    sp.add_argument("--coverage_threshold", type=int, default=5)

    sp = sub.add_parser("encode_densely", help="dense encoding of diplotigs")
    sp.add_argument("--length", type=int, default=15)

    sp = sub.add_parser("squish", help="squish ambiguous clusterings")
    sp.add_argument("--ari", type=float, default=0.4)
    sp.add_argument("--match_score", type=float, default=4.0)
    sp.add_argument("--mismatch_score", type=float, default=-1.0)
    sp.add_argument("--count", type=int, default=7)

    sp = sub.add_parser("assemble", help="assemble to GFA")
    sp.add_argument("--output", required=True)
    sp.add_argument("--gfa2", action="store_true",
                    help="emit GFA 2.0 (the reference's dialect)")
    sp.add_argument("--min_llr", type=float, default=1.0)
    sp.add_argument("--min_span", type=int, default=2)
    sp.add_argument("--no_polish", action="store_true")
    sp.add_argument("--window_size", type=int, default=2000)

    sp = sub.add_parser("polish", help="polish external contigs")
    sp.add_argument("--reads", required=True)
    sp.add_argument("--contigs", required=True)
    sp.add_argument("--alignments", required=True)
    sp.add_argument("--format", default="sam", choices=["sam", "paf"])
    sp.add_argument("--output", required=True)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--window_size", type=int, default=2000)
    sp.add_argument("--read_type", default="ONT")

    sp = sub.add_parser("pipeline", help="run the whole pipeline from TOML")
    sp.add_argument("-p", "--profile", required=True)

    for sp in sub.choices.values():
        sp.add_argument("--device", default="cuda",
                        help="device of the device work (cuda or cpu)")
        sp.add_argument("--devices", default=None,
                        help="comma-separated device set of the "
                        "data-parallel paths, primary first (default: "
                        "every visible GPU when the device is cuda)")
    return p


def main(argv=None):
    from .runtime import use_device, use_devices
    args = build_parser().parse_args(argv)
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)]
    logging.basicConfig(level=level, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    with (use_devices(args.devices.split(",")) if args.devices
          else use_device(args.device)):
        _dispatch(args)


def _dispatch(args):
    if args.cmd == "pipeline":
        from .pipeline import PipelineConfig, run_pipeline
        cfg = PipelineConfig.from_toml(args.profile)
        out = run_pipeline(cfg)
        print(out, file=sys.stderr)
        return

    if args.cmd == "entry":
        from .stages.entry import entry
        ds = entry(args.input, args.read_type)
        _write_ds(ds)
        return

    if args.cmd == "polish":
        from .stages.polish_segments import polish_segments_files
        polish_segments_files(args.reads, args.contigs, args.alignments,
                              args.format, args.output, args.window_size,
                              args.read_type, args.seed)
        return

    ds = _read_ds()
    if args.cmd == "extract":
        from .stages.extract import extract
        with open(args.output, "w") as f:
            f.write(extract(ds, args.target))
        _write_ds(ds)
    elif args.cmd == "stats":
        from .stages.stats import stats_report
        with open(args.file, "w") as f:
            f.write(stats_report(ds))
        _write_ds(ds)
    elif args.cmd == "select_chunks":
        from .stages.determine_chunks import select_chunks
        select_chunks(ds, args.chunk_len, args.take_num, args.margin,
                      args.seed, args.purge_copy_num)
        _write_ds(ds)
    elif args.cmd == "mask_repeats":
        from .stages.repeat_masking import mask_repeats
        mask_repeats(ds, args.k, args.freq, args.min)
        _write_ds(ds)
    elif args.cmd == "encode":
        from .stages.encode import encode
        encode(ds, sim_thr=args.sim_thr)
        _write_ds(ds)
    elif args.cmd == "polish_encoding":
        from .stages.determine_chunks import polish_chunks
        polish_chunks(ds)
        _write_ds(ds)
    elif args.cmd == "pick_components":
        from .stages.pick_component import pick_top_n_component
        pick_top_n_component(ds, args.component_num)
        _write_ds(ds)
    elif args.cmd == "estimate_multiplicity":
        from .stages.multiplicity import estimate_multiplicity, purge_multiplicity
        estimate_multiplicity(ds, draft_gfa=args.draft_assembly)
        if args.purge_copy_num:
            purge_multiplicity(ds, args.purge_copy_num)
        _write_ds(ds)
    elif args.cmd == "partition_local":
        from .stages.local_clustering import local_clustering
        local_clustering(ds, seed=args.seed)
        _write_ds(ds)
    elif args.cmd == "purge_diverged":
        from .stages.purge_diverged import purge_diverged
        purge_diverged(ds)
        _write_ds(ds)
    elif args.cmd == "correct_deletion":
        from .stages.deletion_fill import correct_deletion
        correct_deletion(ds, re_cluster=args.re_cluster)
        _write_ds(ds)
    elif args.cmd == "correct_clustering":
        from .stages.correction import correct_clustering
        correct_clustering(ds, repeat_num=args.repeat_num,
                           coverage_thr=args.coverage_threshold)
        _write_ds(ds)
    elif args.cmd == "encode_densely":
        from .stages.dense_encoding import dense_encoding
        dense_encoding(ds, length=args.length)
        _write_ds(ds)
    elif args.cmd == "squish":
        from .stages.squish import squish_erroneous_clusters
        squish_erroneous_clusters(ds, ari=args.ari,
                                  match_score=args.match_score,
                                  mismatch_score=args.mismatch_score,
                                  count=args.count)
        _write_ds(ds)
    elif args.cmd == "assemble":
        from .stages.assemble import assemble
        assemble(ds, out_path=args.output, gfa2=args.gfa2)
        _write_ds(ds)
    else:
        raise SystemExit(f"unknown subcommand {args.cmd}")


if __name__ == "__main__":
    main()
