"""Time the MCMC chain kernel and K3's traceback walk on the card, with
CUDA events, and print their loops' SASS statistics.

    python3 -m jtk_tpu_torch.tools.time_chain_walk [--reps N]

Prints one JSON line per measurement: a 1024-step chain launch at each of
CHAIN_SHAPES (the median of N launches after a warm-up, the state carried
from launch to launch) and a clustering call of 100 000 steps at path
(b)'s shape (host clock, synchronised); the walk at the mapper's (2048,
2048, 256), at one whole read (1, 59200, 512) and at path (b)'s K3 shapes
(the median of N walks of one stream); then the step loops of
``edit_tb_kernel`` and of the chain's kernels (``tools/sass_loop_stats``:
instructions, static stall cycles, scoreboard waits).  It uses only the
API that every tree of the port since the chain kernel has
(``chain_start``, ``generator_block``, ``block_draws``, ``mcmc_chain``,
``mcmc_cluster_batch``, ``k3_inputs``, ``edit_dp``, ``select_end``,
``traceback_packed``, ``cuda_build``), so a copy run from an unpacked
earlier commit times that commit's kernels on the same inputs: run both
trees in turns in one call (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

# (B chunks, S restarts, K, V, Rmax): path (b)'s clustered phase, the
# recursive path's K 4, K 8 / V 40, a 1 Mb run's 414 chunks
CHAIN_SHAPES = ((27, 20, 2, 8, 128), (1, 20, 4, 12, 64), (3, 4, 8, 40, 96),
                (414, 20, 2, 8, 128))
CHAIN_K_STEPS = 100_000
# (B, Q, W): the mapper's, one whole read, path (b)'s K3 shapes
WALK_SHAPES = ((2048, 2048, 256), (1, 59200, 512), (29, 256, 128),
               (26, 2048, 768), (748, 2240, 640))


def _median(fn, reps):
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def chain_case(rng, dev, B, S, K, V, Rmax, seed):
    """Planted clusters for B chunks, the chain's start and one draw
    block's draws (numpy and torch seeded from ``rng`` and ``seed``)."""
    import numpy as np
    import torch

    from jtk_tpu_torch.ops import cluster as pcl

    X = np.zeros((B, Rmax, V), np.float32)
    Rs = np.zeros(B, np.int64)
    for b in range(B):
        R = Rmax - int(rng.integers(0, 8))
        truth = rng.integers(0, K, R)
        x = rng.normal(0, 0.6, (R, V))
        for c in range(K):
            cols = np.arange(V) % K == c
            x[np.ix_(truth == c, cols)] += 2.0
            x[np.ix_(truth != c, cols)] -= 1.0
        X[b, :R] = x
        Rs[b] = R
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    Xt = torch.tensor(X, device=dev)
    Rt = torch.tensor(Rs, device=dev)
    slt = torch.tensor(size_lk, device=dev)
    w = (torch.arange(Rmax, device=dev)[None] < Rt[:, None]).float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = pcl.chain_start(Xt, w, slt, K, pcl._gumbel((B, S, K, Rmax), gen,
                                                    dev))
    draws = pcl.block_draws(*pcl.generator_block(
        gen, (pcl.DRAW_BLOCK, B, S), K, dev), Rt, Rmax)
    return dict(X=Xt, size_lk=slt, st=st, draws=draws, Xnp=X, Rnp=Rs,
                size_np=size_lk)


def walk_case(dev, B, Q, W, seed):
    """K3's stream of B random pairs of Q rows in a diagonal band of W
    (infix), and the walk's other arguments."""
    import torch

    from jtk_tpu_torch.ops import edit_dp as k3

    g = torch.Generator(device=dev).manual_seed(seed)
    T = Q + W
    q = torch.randint(0, 4, (B, Q), generator=g, device=dev)
    r = torch.randint(0, 4, (B, T), generator=g, device=dev)
    ii = torch.arange(Q + 1, device=dev)
    off = (ii - W // 4).clamp(0, T - W + 1)[None].expand(B, Q + 1) \
        .contiguous()
    tl = torch.full((B,), T, dtype=torch.int64, device=dev)
    qlen = torch.full((B,), Q, dtype=torch.int32, device=dev)
    args = k3.k3_inputs(q, r, off, tl, W, "infix") + (qlen,
                                                       tl.to(torch.int32))
    packed, last = k3.edit_dp(*args)
    _s, end = k3.select_end(last, off, qlen.long(), tl.long(), W, "infix")
    return packed, off, qlen, end


def sass_stats():
    """Step-loop statistics of the walk and the chain kernels of the built
    libraries: [(function, instructions, stall cycles, waits)]."""
    from jtk_tpu_torch.ops import cuda_build
    from jtk_tpu_torch.tools import sass_loop_stats as sls

    cuda_build.build(["edit_dp", "mcmc_chain"])
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    out = []
    for lib, kernels in (("edit_dp", (("edit_tb_kernel", "SHFL.IDX"),)),
                         ("mcmc_chain", (("mcmc_chain", "SHFL.DOWN"),))):
        text = subprocess.run([tool, "-sass", cuda_build.lib_path(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for name, body in sls.functions(text):
            for kernel, anchor in kernels:
                if kernel in name:
                    stats = sls.loop_stats(body, anchor)
                    out.append((name, *(stats or (None, None, None))))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=11)
    opts = ap.parse_args()

    import numpy as np
    import torch

    from jtk_tpu_torch.ops import cluster as pcl
    from jtk_tpu_torch.ops import edit_dp as k3

    if not torch.cuda.is_available():
        raise SystemExit("time_chain_walk: no CUDA device")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(42)

    def emit(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    for n, (B, S, K, V, Rmax) in enumerate(CHAIN_SHAPES):
        case = chain_case(rng, dev, B, S, K, V, Rmax, seed=100 + n)
        ms = _median(lambda: pcl.mcmc_chain(case["st"], case["X"],
                                            case["size_lk"],
                                            *case["draws"]), opts.reps)
        emit(kernel="mcmc_chain", shape=[B, S, K, V, Rmax],
             steps=pcl.DRAW_BLOCK, median_ms=ms)
        del case
    B, S, K, V, Rmax = CHAIN_SHAPES[0]
    case = chain_case(rng, dev, B, S, K, V, Rmax, seed=99)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcl.mcmc_cluster_batch(case["Xnp"], case["Rnp"], case["size_np"], K,
                           CHAIN_K_STEPS, S, generator=gen, device=dev)
    torch.cuda.synchronize()
    emit(kernel="mcmc_cluster_batch", shape=[B, S, K, V, Rmax],
         steps=CHAIN_K_STEPS, ms=(time.perf_counter() - t0) * 1e3)
    del case
    for n, (B, Q, W) in enumerate(WALK_SHAPES):
        packed, off, qlen, end = walk_case(dev, B, Q, W, seed=200 + n)
        ms = _median(lambda: k3.traceback_packed(packed, off, qlen, end, W),
                     opts.reps)
        emit(kernel="edit_tb", shape=[B, Q, W], median_ms=ms)
        del packed
        torch.cuda.empty_cache()
    for name, n, stalls, waits in sass_stats():
        emit(sass=name[:80], loop_instructions=n, stall_cycles=stalls,
             scoreboard_waits=waits)


if __name__ == "__main__":
    main()
