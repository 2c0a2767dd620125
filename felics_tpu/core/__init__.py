"""Codec core: context model, k-estimator, color transform, channel codecs.

Reference counterpart: the private functions of src/compression.rs plus
src/compression/{misc,parameter_selection,color_transform}.rs. Two codec
implementations live here:

  * ``oracle``    — a sequential, bit-exact scalar codec (numpy + Python bit
                    I/O). Slow; it is the correctness oracle for everything
                    else and the behavioral twin of the reference.
  * ``jax_codec`` — the vectorized JAX encoder/decoder built from the
                    parallel analysis passes in felics_tpu.ops.
"""

from felics_tpu.core.context import nearest_neighbours, neighbour_indices
from felics_tpu.core.kestimator import KEstimator
from felics_tpu.core.color import rgb_to_ycocg, ycocg_to_rgb

__all__ = [
    "nearest_neighbours",
    "neighbour_indices",
    "KEstimator",
    "rgb_to_ycocg",
    "ycocg_to_rgb",
]
