"""The port's pipeline and CLI: twins of tests/test_stages.py's stats /
extract / TOML / parser tests and tests/test_pipeline.py's npz
checkpoints, the resume logic on JAX-written checkpoints with the stages
stubbed, and a CPU run of ``run_pipeline`` on tests/test_pipeline.py's
6 kb fixture (``slow``, as its JAX twin: ~18 min a run on the CPU, where
model tuning's plain K1 passes are Python loops over rows)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from envutil import cpu_subprocess_env
from jtk_tpu.datamodel import DataSet as JDataSet
from jtk_tpu.datamodel import RawRead as JRawRead
from jtk_tpu_torch.datamodel import DataSet
from test_stages import _mk_ds_with_pileup
from torch_util import port_on_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stats_and_extract():
    from jtk_tpu_torch.stages.extract import extract
    from jtk_tpu_torch.stages.stats import n50, stats_report
    jds, _ = _mk_ds_with_pileup(np.random.default_rng(4), n_chunks=2, cov=4)
    ds = DataSet.loads(jds.dumps())
    assert n50([1, 1, 10]) == 10
    rep = stats_report(ds)
    assert "reads\t8" in rep
    tsv = extract(ds, "chunks")
    assert len(tsv.strip().splitlines()) == 2
    tsv = extract(ds, "encoded_reads")
    assert len(tsv.strip().splitlines()) == 8
    from jtk_tpu.stages.extract import extract as jextract
    for target in ("raw_reads", "encoded_reads", "chunks"):
        assert extract(ds, target) == jextract(jds, target)


def test_pipeline_config_toml(tmp_path):
    from jtk_tpu.pipeline import PipelineConfig as JConfig
    from jtk_tpu_torch.pipeline import PipelineConfig, parse_si
    assert parse_si("5M") == 5_000_000
    assert parse_si("300k") == 300_000
    assert parse_si("1234") == 1234
    p = tmp_path / "cfg.toml"
    p.write_text('input_file = "in.fa"\nread_type = "ONT"\n'
                 'region_size = "2M"\nseed = 7\nunknown_key = 3\n')
    cfg = PipelineConfig.from_toml(str(p))
    assert cfg.read_type == "ONT"
    assert cfg.seed == 7
    assert cfg.region_size == "2M"
    import dataclasses
    fields = [(f.name, f.default) for f in dataclasses.fields(cfg)]
    # the reference's keys with their defaults, in the same order
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JConfig)]


def _subcommands(parser):
    for a in parser._actions:
        if hasattr(a, "choices") and a.choices and "entry" in a.choices:
            return a.choices
    return None


def test_cli_parser_covers_subcommands():
    from jtk_tpu.cli import build_parser as jbuild
    from jtk_tpu_torch.cli import build_parser
    subs = _subcommands(build_parser())
    expected = {"entry", "extract", "stats", "select_chunks", "mask_repeats",
                "encode", "polish_encoding", "pick_components",
                "estimate_multiplicity", "partition_local", "purge_diverged",
                "correct_deletion", "correct_clustering", "encode_densely",
                "squish", "assemble", "polish", "pipeline"}
    assert set(subs) == expected
    jsubs = _subcommands(jbuild())
    for name, sp in subs.items():
        opts = {o for a in sp._actions for o in a.option_strings}
        jopts = {o for a in jsubs[name]._actions for o in a.option_strings}
        # the same arguments plus --device, --devices (the device set) and
        # --trace (the spans and counters' file)
        assert opts == jopts | {"--device", "--devices", "--trace"}, name
        dev = [a.default for a in sp._actions
               if "--device" in a.option_strings]
        assert dev == ["cuda"], name
        devs = [a.default for a in sp._actions
                if "--devices" in a.option_strings]
        assert devs == [None], name
        traces = [a.default for a in sp._actions
                  if "--trace" in a.option_strings]
        assert traces == [None], name


def test_cli_stage_chain_on_cpu(tmp_path):
    """``entry`` then ``stats`` through the CLI with ``--device cpu``
    (stdin/stdout JSON ABI), in a fresh process."""
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTACGTAC\n>b\nGGGTTTAAAC\n")
    env = cpu_subprocess_env()
    run = [sys.executable, "-m", "jtk_tpu_torch.cli"]
    out = subprocess.run(run + ["entry", "--input", str(fa), "--read_type",
                                "ONT", "--device", "cpu"],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    ds = DataSet.loads(out.stdout)
    assert [r.name for r in ds.raw_reads] == ["a", "b"]
    rep = tmp_path / "stats.tsv"
    out2 = subprocess.run(run + ["stats", "--file", str(rep), "--device",
                                 "cpu"], input=out.stdout,
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)
    assert out2.returncode == 0, out2.stderr
    assert "reads\t2" in rep.read_text()
    assert DataSet.loads(out2.stdout).dumps() == ds.dumps()


def test_npz_checkpoint_paths(tmp_path):
    """A JAX-written json checkpoint and the port's npz round trip."""
    jds = JDataSet(read_type="ONT", raw_reads=[
        JRawRead("r0", "", 0, "ACGTACGTACGT")])
    jds.dump(str(tmp_path / "t.entry.json"))
    ds = DataSet.load(str(tmp_path / "t.entry.json"))
    assert ds.dumps() == jds.dumps()
    ds.dump(str(tmp_path / "t.encoded.npz"))
    back = DataSet.load(str(tmp_path / "t.encoded.npz"))
    assert back.dumps() == ds.dumps()
    assert JDataSet.load(str(tmp_path / "t.encoded.npz")).dumps() == \
        ds.dumps()


def test_polish_segments_matches_jax(tmp_path):
    """``jtk polish``: external contigs polished from PAF alignments give
    the same FASTA as jtk_tpu's."""
    from jtk_tpu import seq as seqmod
    from jtk_tpu.io import sim
    from jtk_tpu.stages.polish_segments import polish_segments_files as j
    from jtk_tpu_torch.stages.polish_segments import \
        polish_segments_files as p
    rng = np.random.default_rng(21)
    truth = sim.random_genome(rng, 600)
    draft = sim.mutate(rng, truth, sub=0.01, ins=0.005, dele=0.005)
    (tmp_path / "contigs.fa").write_text(
        f">c0\n{seqmod.decode(draft).decode()}\n")
    lines, paf = [], []
    for i in range(8):
        r = seqmod.decode(sim.noisy_read(rng, truth, 0.05)).decode()
        lines.append(f">r{i}\n{r}\n")
        paf.append(f"r{i}\t{len(r)}\t0\t{len(r)}\t+\tc0\t{len(draft)}\t0\t"
                   f"{len(draft)}\t{len(r)}\t{len(r)}\t60\n")
    (tmp_path / "reads.fa").write_text("".join(lines))
    (tmp_path / "aln.paf").write_text("".join(paf))
    args = [str(tmp_path / "reads.fa"), str(tmp_path / "contigs.fa"),
            str(tmp_path / "aln.paf"), "paf"]
    j(*args, str(tmp_path / "j.fa"))
    p(*args, str(tmp_path / "p.fa"))
    out = (tmp_path / "p.fa").read_text()
    assert out == (tmp_path / "j.fa").read_text()
    assert out != (tmp_path / "contigs.fa").read_text()


_LATER_STAGES = (
    ("stages.model_tune", "update_models_on_both_strands"),
    ("stages.local_clustering", "local_clustering"),
    ("stages.purge_diverged", "purge_diverged"),
    ("stages.purge_diverged", "purge_largeindel"),
    ("stages.deletion_fill", "correct_deletion"),
    ("stages.dense_encoding", "dense_encoding"),
    ("stages.squish", "squish_erroneous_clusters"),
    ("stages.correction", "correct_clustering"),
)


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_resume_from_jax_written_encoded_checkpoint(tmp_path, monkeypatch,
                                                    fmt):
    """``resume`` jumps to the furthest checkpoint, here one that
    ``jtk_tpu`` wrote, and runs the later phases in order on what it
    loaded (their stages stubbed; the real run is the slow test below)."""
    import importlib

    from jtk_tpu_torch.pipeline import PipelineConfig, run_pipeline
    jds, _ = _mk_ds_with_pileup(np.random.default_rng(5), n_chunks=2, cov=4)
    jds.dump(str(tmp_path / f"t.encoded.{fmt}"))
    calls = []
    for mod, fn in _LATER_STAGES:
        m = importlib.import_module(f"jtk_tpu_torch.{mod}")

        def stub(ds, *a, _name=fn, **kw):
            calls.append(_name)
            assert isinstance(ds, DataSet)
            return ds
        monkeypatch.setattr(m, fn, stub)
    m = importlib.import_module("jtk_tpu_torch.stages.assemble")

    def assemble(ds, out_path=None, **kw):
        calls.append("assemble")
        with open(out_path, "w") as f:
            f.write("H\tVN:Z:1.0\n")
        return ""
    monkeypatch.setattr(m, "assemble", assemble)
    cfg = PipelineConfig(out_dir=str(tmp_path), prefix="t", resume=True,
                         checkpoint_format="json")
    gfa = run_pipeline(cfg)
    assert os.path.exists(gfa)
    assert calls == ["update_models_on_both_strands", "local_clustering",
                     "purge_diverged", "purge_diverged", "purge_largeindel",
                     "correct_deletion", "dense_encoding",
                     "correct_deletion", "squish_erroneous_clusters",
                     "correct_clustering", "assemble"]
    assert not os.path.exists(tmp_path / "t.entry.json")
    for name in ("clustered", "de"):
        back = DataSet.load(str(tmp_path / f"t.{name}.json"))
        assert back.encoded_reads[0].nodes[0].seq == \
            jds.encoded_reads[0].nodes[0].seq
    assert JDataSet.load(str(tmp_path / "t.json")).dumps() == \
        DataSet.load(str(tmp_path / "t.json")).dumps()
    rows = (tmp_path / "t.timings.tsv").read_text().splitlines()
    assert rows[0] == "phase\tseconds"
    assert [r.split("\t")[0] for r in rows[1:]] == \
        ["clustered", "de", "corrected", "assemble"]


_RUNNER = r"""
import json, os, sys
REPO = sys.argv[4]
sys.path.insert(0, REPO)
import numpy as np
import torch
torch.set_num_threads(2)
from jtk_tpu_torch.io.eval import assembly_metrics
from jtk_tpu_torch.pipeline import PipelineConfig, run_pipeline
from jtk_tpu_torch.runtime import use_device
cfg = PipelineConfig(**json.load(open(sys.argv[1])))
hap1 = np.load(sys.argv[2])
hap2 = np.load(sys.argv[3])
with use_device("cpu"):
    gfa_path = run_pipeline(cfg)
    m = assembly_metrics(open(gfa_path).read(), [hap1, hap2])
    cfg.resume = True
    os.remove(gfa_path)
    gfa2 = run_pipeline(cfg)
print(json.dumps({"gfa": gfa_path, "gfa2": gfa2, "metrics": m}))
"""


@pytest.mark.slow
def test_run_pipeline_end_to_end(tmp_path):
    """tests/test_pipeline.py's 6 kb fixture through the port's
    run_pipeline on the CPU, its assertions, the resume round trip, and a
    resume from an ``encoded`` checkpoint rewritten by ``jtk_tpu``."""
    from jtk_tpu import seq as seqmod
    from jtk_tpu.io import sim
    rng = np.random.default_rng(11)
    hap1 = sim.random_genome(rng, 6000)
    hap2 = hap1.copy()
    snv = rng.choice(np.arange(100, 5900), 90, replace=False)
    for p in snv:
        hap2[p] = (hap2[p] + 1 + rng.integers(0, 3)) % 4
    reads = sim.simulate_reads(rng, [hap1, hap2], coverage=16, mean_len=2200,
                               error=0.05)
    fa = tmp_path / "reads.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">sim_{i}\n{seqmod.decode(r['codes']).decode()}\n")
    cfg = dict(
        input_file=str(fa), read_type="ONT", out_dir=str(tmp_path),
        prefix="t", region_size="6k", chunk_len=500, margin=100, seed=3,
        to_polish=True, polish_window_size=1000)
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    np.save(tmp_path / "hap1.npy", hap1)
    np.save(tmp_path / "hap2.npy", hap2)
    args = [sys.executable, "-c", _RUNNER, str(tmp_path / "cfg.json"),
            str(tmp_path / "hap1.npy"), str(tmp_path / "hap2.npy"), ROOT]

    def run():
        out = subprocess.run(args, capture_output=True, text=True,
                             timeout=3600, env=cpu_subprocess_env())
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    rec = run()
    assert os.path.exists(rec["gfa"])
    assert os.path.exists(rec["gfa2"])  # resume round trip
    for name in ("t.entry.json", "t.encoded.json", "t.clustered.json",
                 "t.de.json", "t.json"):
        assert os.path.exists(tmp_path / name), name
    m = rec["metrics"]
    assert m["total_len"] > 3500, m
    assert m["mean_error"] < 0.02, m
    # resume from an encoded checkpoint written by the JAX package
    enc = str(tmp_path / "t.encoded.json")
    JDataSet.load(enc).dump(enc)
    for name in ("t.clustered.json", "t.de.json", "t.json"):
        os.remove(tmp_path / name)
    cfg["resume"] = True
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    rec = run()
    for name in ("t.clustered.json", "t.de.json", "t.json"):
        assert os.path.exists(tmp_path / name), name
    m = rec["metrics"]
    assert m["total_len"] > 3500, m
    assert m["mean_error"] < 0.02, m
