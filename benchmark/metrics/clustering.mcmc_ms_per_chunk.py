"""The Metropolis chains of every chunk and K (``cluster_chunks_mcmc``
over ``ops/cluster`` and ``csrc/mcmc_chain.cu``), milliseconds a chunk
clustered."""

SPANS = {"clustering.mcmc":
         "jtk_tpu_torch.stages.local_clustering:cluster_chunks_mcmc"}


def read(ctx):
    s = ctx.span_s("clustering.mcmc")
    if s is None or not ctx.units:
        return None
    return 1e3 * s / ctx.units
