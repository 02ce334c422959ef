"""Variant features: the per-read profiles' statistics on the device and
the candidate columns (``stages/local_clustering._variant_features_device``),
milliseconds a chunk clustered."""

SPANS = {"clustering.features":
         "jtk_tpu_torch.stages.local_clustering:_variant_features_device"}


def read(ctx):
    s = ctx.span_s("clustering.features")
    if s is None or not ctx.units:
        return None
    return 1e3 * s / ctx.units
