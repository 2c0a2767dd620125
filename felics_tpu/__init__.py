"""felics_tpu — a device-parallel FELICS lossless image compression engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the FELICS
reference codec (visanalexandru/felics): 8/16-bit grayscale and RGB lossless
compression with the two-neighbour context model, phased-in (truncated binary)
coding of in-range residuals, adaptive per-context Rice coding of out-of-range
residuals, the reversible YCoCg-R color transform, and the ``FLCS`` container
format (bit-exact interoperable with the reference ``cfelics``/``dfelics``).

On top of the reference's capability surface, this package adds what an
accelerator demands and the reference never had: a vectorized encoder whose per-pixel
analysis, k-parameter scan, codeword generation and bitstream packing are all
data-parallel XLA programs; a tiled container extension (``FLCT``) whose
independently-coded tiles shard across a ``jax.sharding.Mesh``; and a native
C++ runtime core for the irreducibly serial single-stream decode path. It
runs on an NVIDIA GPU, or on the CPU for tests.

Layer map (mirrors SURVEY.md §1):
  coding/    bit I/O + entropy coders (Rice, phase-in, range markers)
  core/      codec core: context model, k-estimator, color transform,
             sequential oracle codec, vectorized JAX codec
  ops/       parallel bitstream pack/unpack + the Pallas decode kernel
  parallel/  tiled FLCT format, mesh sharding, multi-host orchestration
  io/        image file IO helpers
  native/    (repo root) C++ runtime core, loaded via ctypes
"""

from felics_tpu.version import __version__
from felics_tpu.errors import DecompressionError
from felics_tpu.format import (
    ColorType,
    PixelDepth,
    Header,
    read_header,
    write_header,
    MAGIC,
)
from felics_tpu.config import CodingConfig, CONFIG_8BIT, CONFIG_16BIT
from felics_tpu.api import (
    compress_image,
    decompress_image,
    compress_image_bytes,
    compress_images_bytes,
    decompress_images_bytes,
    decompress_image_bytes,
    probe,
)

__all__ = [
    "__version__",
    "DecompressionError",
    "ColorType",
    "PixelDepth",
    "Header",
    "read_header",
    "write_header",
    "MAGIC",
    "CodingConfig",
    "CONFIG_8BIT",
    "CONFIG_16BIT",
    "compress_image",
    "decompress_image",
    "compress_image_bytes",
    "compress_images_bytes",
    "decompress_images_bytes",
    "decompress_image_bytes",
    "probe",
]
