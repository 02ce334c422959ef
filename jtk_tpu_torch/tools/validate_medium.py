"""Medium-scale validation of the port: a simulated diploid region at a
given length and coverage through the whole pipeline, on the card.

    python3 -m jtk_tpu_torch.tools.validate_medium 500000 60 out.json
    python3 -m jtk_tpu_torch.tools.validate_medium 20000 10 --device cpu

The counterpart of ``scripts/validate_medium.py``: the same arguments
(length, default 60 000; coverage, default 30; an optional path the record
is written to), the same simulator calls on ``np.random.default_rng(2026)``
(``sim.diploid`` at het 0.004, then ``sim.simulate_reads`` at mean length
15 kb, 5 % error, clipped at the region's ends) and the same
``PipelineConfig`` (ONT, ``region_size`` the length, seed 13, contig
polishing, resume), so it assembles the very reads that script assembles.
The work directory is keyed by (length, coverage), under the temporary
directory unless ``--work-dir`` names one; ``VALIDATE_CKPT=npz`` writes the
phase checkpoints as npz instead of JSON.

Prints one JSON record with the script's fields (region, coverage,
n_reads, wall_s, stage_s from the timings TSV, peak_rss_mb, phased_chunks,
total_chunks, mean_phasing_ari, contigs, assembly_len, mean_contig_error)
and three more: the peak device memory of each card of the device set
(GiB, ``torch.cuda.max_memory_allocated``), each kernel's launches, and
the card's name and power limit as nvidia-smi gives them.  ``--device``
(default cuda: without a GPU it raises) and ``--devices`` (the device set
of the data-parallel paths) are the CLI's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

SIM_SEED = 2026
PIPELINE_SEED = 13


def simulate(L: int, cov: float):
    """The script's haplotypes and reads: (hap1, hap2, reads)."""
    from ..io import sim
    rng = np.random.default_rng(SIM_SEED)
    hap1, hap2 = sim.diploid(rng, L, het=0.004)
    reads = sim.simulate_reads(rng, [hap1, hap2], coverage=cov,
                               mean_len=15_000, error=0.05, clip_ends=True)
    return hap1, hap2, reads


def phasing_aris(ds, reads) -> list[float]:
    """ARI of each selected chunk of two or more clusters: its nodes'
    clusters against their reads' haplotypes."""
    from ..stages.util import adjusted_rand_index
    aris = []
    for c in ds.selected_chunks:
        if c.cluster_num < 2:
            continue
        asn, truth = [], []
        for er in ds.encoded_reads:
            for n in er.nodes:
                if n.chunk == c.id:
                    asn.append(n.cluster)
                    truth.append(reads[er.id]["hap"])
        aris.append(adjusted_rand_index(truth, asn))
    return aris


def record(L: int, cov: float, reads, wall: float, stage_s: dict,
           peak_rss_mb: float, ds, gfa_text: str, haplotypes) -> dict:
    """The script's record, from the clustered checkpoint ``ds`` and the
    GFA."""
    from ..io.eval import assembly_metrics
    aris = phasing_aris(ds, reads)
    m = assembly_metrics(gfa_text, haplotypes)
    return {
        "region": L, "coverage": cov, "n_reads": len(reads),
        "wall_s": round(wall, 1),
        "stage_s": stage_s,
        "peak_rss_mb": round(peak_rss_mb, 1),
        "phased_chunks": len(aris),
        "total_chunks": len(ds.selected_chunks),
        "mean_phasing_ari": round(float(np.mean(aris)), 3) if aris else None,
        "contigs": len(m["contigs"]),
        "assembly_len": m["total_len"],
        "mean_contig_error": round(m["mean_error"], 5),
    }


def launch_counters() -> list:
    """The launch counters of the eight kernel wrappers: K3's DP and walk,
    K1f, K1b, K1l, counts, the MCMC chain, K2."""
    from ..ops import (cluster, edit_dp, modtable, phmm_grad, phmm_lk,
                       phmm_tables)
    return [edit_dp.LAUNCHES, edit_dp.TB_LAUNCHES, phmm_tables.FWD_LAUNCHES,
            phmm_tables.BWD_LAUNCHES, phmm_lk.LAUNCHES, phmm_grad.LAUNCHES,
            cluster.CHAIN_LAUNCHES, modtable.ASSEMBLY_LAUNCHES]


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of every card, or
    "none" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"
    return out or "none"


def default_work_dir(L: int, cov: float) -> str:
    """Keyed by (length, coverage): a resumed run never picks up another
    scale's checkpoints."""
    return os.path.join(tempfile.gettempdir(),
                        f"jtk_validate_torch_{L}_{int(cov)}")


def run(L: int, cov: float, work_dir: str | None = None,
        ckpt: str = "json", resume: bool = True) -> dict:
    """Simulate, run the pipeline on the current device set and return
    the record (with the three extra fields)."""
    import torch

    from .. import seq as seqmod
    from ..datamodel import DataSet
    from ..pipeline import PipelineConfig, run_pipeline
    from ..runtime import devices

    devs = devices()     # raises where cuda is asked for without a GPU
    hap1, hap2, reads = simulate(L, cov)
    out = work_dir or default_work_dir(L, cov)
    os.makedirs(out, exist_ok=True)
    fa = os.path.join(out, "reads.fa")
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">sim_{i}\n{seqmod.decode(r['codes']).decode()}\n")
    cfg = PipelineConfig(input_file=fa, read_type="ONT", out_dir=out,
                         prefix="v", region_size=str(L), seed=PIPELINE_SEED,
                         to_polish=True, resume=resume,
                         checkpoint_format=ckpt)
    cards = sorted({d.index if d.index is not None
                    else torch.cuda.current_device()
                    for d in devs if d.type == "cuda"})
    for i in cards:
        # the card's allocator exists once the card is first used: an
        # explicit set (cuda:0,cuda:1,...) has not touched any card here
        torch.empty(0, device=f"cuda:{i}")
        torch.cuda.reset_peak_memory_stats(i)
    counters = launch_counters()
    for c in counters:
        c.reset()
    t0 = time.time()
    gfa_path = run_pipeline(cfg)
    wall = time.time() - t0
    launches = {c.name: c.count for c in counters}
    peak_gib = {f"cuda:{i}": round(torch.cuda.max_memory_allocated(i)
                                   / 2 ** 30, 3) for i in cards}
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    stage_s = {}
    timings = os.path.join(out, "v.timings.tsv")
    if os.path.exists(timings):
        with open(timings) as f:
            for line in f:
                k, v = line.rstrip("\n").split("\t")
                if k != "phase":
                    stage_s[k] = float(v)
    cl = os.path.join(out, f"v.clustered.{'npz' if ckpt == 'npz' else 'json'}")
    if not os.path.exists(cl):
        cl = os.path.join(out, "v.clustered.json")
    with open(gfa_path) as f:
        gfa_text = f.read()
    rec = record(L, cov, reads, wall, stage_s, peak_rss_mb,
                 DataSet.load(cl), gfa_text, [hap1, hap2])
    rec.update(peak_device_gib=peak_gib, launches=launches,
               card=card_line() if cards else "none")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("length", nargs="?", type=int, default=60_000)
    ap.add_argument("coverage", nargs="?", type=float, default=30)
    ap.add_argument("out", nargs="?", default=None,
                    help="path the JSON record is also written to")
    ap.add_argument("--device", default="cuda",
                    help="device of the device work (cuda or cpu)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device set of the data-parallel "
                    "paths (default every visible GPU when the device is "
                    "cuda)")
    ap.add_argument("--work-dir", default=None,
                    help="work directory (default: keyed by length and "
                    "coverage under the temporary directory)")
    args = ap.parse_args(argv)
    from ..runtime import use_device, use_devices
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    with (use_devices(args.devices.split(",")) if args.devices
          else use_device(args.device)):
        rec = run(args.length, args.coverage, args.work_dir,
                  os.environ.get("VALIDATE_CKPT", "json"))
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return rec


if __name__ == "__main__":
    main()
