"""End-to-end pipeline with TOML config + phase-granular checkpoint/resume.

Reference: ``cli/src/pipeline.rs:40-241`` — the 27-field ``PipelineConfig``
(TOML keys mirrored 1:1 here), ``take_num = 3*region_size/chunk_len/2``
(:98), SI-suffix region parser (:225-241), the canonical stage order
(SURVEY.md §3.1) and per-phase JSON checkpoints ``{prefix}.entry.json``,
``.encoded.json``, ``.clustered.json``, ``.de.json``, ``.json`` with the
``resume`` flag short-circuiting completed phases.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

from .datamodel import Coverage, DataSet

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PipelineConfig:
    input_file: str = "input.fa"
    read_type: str = "ONT"
    out_dir: str = "./"
    prefix: str = "temp"
    verbose: int = 1
    threads: int = 1
    seed: int = 42
    region_size: str = "5M"
    chunk_len: int = 2000
    margin: int = 500
    exclude: float = 0.8
    kmersize: int = 12
    top_freq: float = 0.001
    min_count: int = 10
    component_num: int = 1
    purge_copy_num: int = 10
    haploid_coverage: float | None = None
    compress_contig: int = 15
    polish_window_size: int = 2000
    to_polish: bool = True
    min_span: int = 2
    min_llr: float = 1.0
    resume: bool = False
    gfa2: bool = False
    # "json" (reference-ABI, diffable) or "npz" (columnar snapshot —
    # seconds instead of minutes per phase at Mb scale, SURVEY §2.1)
    checkpoint_format: str = "json"
    supress_ari: float = 0.4
    match_ari: float = 4.0
    mismatch_ari: float = -1.0
    required_count: int = 7

    @classmethod
    def from_toml(cls, path: str) -> "PipelineConfig":
        import tomllib
        with open(path, "rb") as f:
            d = tomllib.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def parse_si(s: str) -> int:
    """cli/src/pipeline.rs:225-241."""
    s = str(s).strip()
    mult = 1
    if s and s[-1] in "KMGkmg":
        mult = {"k": 10 ** 3, "m": 10 ** 6, "g": 10 ** 9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult)


def run_pipeline(config: PipelineConfig) -> str:
    """Run the full pipeline; returns the path of the final GFA."""
    from .stages.assemble import assemble
    from .stages.correction import correct_clustering
    from .stages.deletion_fill import correct_deletion
    from .stages.dense_encoding import dense_encoding
    from .stages.determine_chunks import select_chunks
    from .stages.entry import entry
    from .stages.local_clustering import local_clustering
    from .stages.model_tune import update_models_on_both_strands
    from .stages.multiplicity import estimate_multiplicity, purge_multiplicity
    from .stages.pick_component import pick_top_n_component
    from .stages.purge_diverged import purge_diverged, purge_largeindel
    from .stages.remove_erroneous import remove_erroneous_nodes
    from .stages.repeat_masking import mask_repeats
    from .stages.squish import squish_erroneous_clusters

    os.makedirs(config.out_dir, exist_ok=True)
    stem = os.path.join(config.out_dir, config.prefix)
    ext = "npz" if config.checkpoint_format == "npz" else "json"
    paths = {
        "entry": f"{stem}.entry.{ext}",
        "encoded": f"{stem}.encoded.{ext}",
        "clustered": f"{stem}.clustered.{ext}",
        "de": f"{stem}.de.{ext}",
        "corrected": f"{stem}.{ext}",
    }

    def existing_checkpoint(name):
        """The configured-format path if present, else the other format
        (a run may be resumed with a different checkpoint_format)."""
        if os.path.exists(paths[name]):
            return paths[name]
        other = paths[name].rsplit(".", 1)[0] + \
            (".json" if ext == "npz" else ".npz")
        return other if os.path.exists(other) else None
    region = parse_si(config.region_size)
    take_num = 3 * region // config.chunk_len // 2

    timings: dict = {}

    # resume jumps straight to the FURTHEST existing checkpoint: loading
    # every earlier one in sequence cost minutes each at 1 Mb+ scale
    # (260 MB JSON per phase) for state that is immediately replaced
    _order = ["entry", "encoded", "clustered", "de", "corrected"]
    resume_to = None
    if config.resume:
        for _name in reversed(_order):
            if existing_checkpoint(_name):
                resume_to = _name
                break

    def phase(name, fn, ds):
        path = paths[name]
        if resume_to is not None:
            i, j = _order.index(name), _order.index(resume_to)
            if i < j:
                logger.info("phase %s: skipped (later checkpoint %s exists)",
                            name, resume_to)
                return None
            if i == j:
                path = existing_checkpoint(name)
                logger.info("phase %s: resume from %s", name, path)
                return DataSet.load(path)
        t0 = time.time()
        ds = fn(ds)
        ds.dump(path)
        timings[name] = time.time() - t0
        logger.info("phase %s: %.1fs", name, timings[name])
        return ds

    def dump_timings():
        # per-stage wall-clock TSV (SURVEY §5.1: grep-able timing record)
        with open(f"{stem}.timings.tsv", "w") as f:
            f.write("phase\tseconds\n")
            for k, v in timings.items():
                f.write(f"{k}\t{v:.1f}\n")

    # --- entry ---
    if resume_to not in (None, "entry"):
        ds = None  # a later phase checkpoint supersedes entry
    elif resume_to == "entry":
        ds = DataSet.load(paths["entry"])
    else:
        ds = entry(config.input_file, config.read_type)
        if config.haploid_coverage:
            ds.coverage = Coverage(config.haploid_coverage, protected=True)
        ds.dump(paths["entry"])

    # --- encoded phase (SURVEY.md §3.1 / cli/src/pipeline.rs:143-154) ---
    def encoded_phase(ds):
        mask_repeats(ds, config.kmersize, config.top_freq, config.min_count)
        select_chunks(ds, config.chunk_len, int(take_num), config.margin,
                      config.seed, config.purge_copy_num)
        pick_top_n_component(ds, config.component_num)
        correct_deletion(ds, re_cluster=False)
        remove_erroneous_nodes(ds)
        estimate_multiplicity(ds, draft_gfa=f"{stem}.draft.gfa")
        purge_multiplicity(ds, config.purge_copy_num)
        return ds

    ds = phase("encoded", encoded_phase, ds)

    # --- clustered phase ---
    def clustered_phase(ds):
        update_models_on_both_strands(ds, seed=config.seed)
        local_clustering(ds, seed=config.seed)
        return ds

    ds = phase("clustered", clustered_phase, ds)

    # --- de phase (pipeline.rs:161-170) ---
    def de_phase(ds):
        # reference runs ds.purge() TWICE (cli/src/pipeline.rs:164-166):
        # the second pass catches clusters exposed by the first's
        # re-clustering
        purge_diverged(ds)
        purge_diverged(ds)
        purge_largeindel(ds)
        correct_deletion(ds, re_cluster=True)
        dense_encoding(ds, length=config.compress_contig, seed=config.seed,
                       draft_gfa=f"{stem}.draft2.gfa")
        correct_deletion(ds, re_cluster=True)
        return ds

    ds = phase("de", de_phase, ds)

    # --- corrected phase (pipeline.rs:171-177) ---
    def corrected_phase(ds):
        squish_erroneous_clusters(ds, ari=config.supress_ari,
                                  match_score=config.match_ari,
                                  mismatch_score=config.mismatch_ari,
                                  count=config.required_count)
        correct_clustering(ds, seed=config.seed)
        return ds

    ds = phase("corrected", corrected_phase, ds)

    # --- assemble ---
    out_gfa = f"{stem}.gfa"
    t0 = time.time()
    assemble(ds, out_path=out_gfa, to_polish=config.to_polish,
             window_size=config.polish_window_size, seed=config.seed,
             dump_prefix=stem if config.to_polish else None,
             gfa2=config.gfa2)
    timings["assemble"] = time.time() - t0
    dump_timings()
    return out_gfa
