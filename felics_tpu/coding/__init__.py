"""Entropy coding + bit I/O layer.

Reference counterpart: src/coding/ (RiceCoder, PhaseInCoder) over the
``bitstream-io`` crate's big-endian (MSB-first) bit writer/reader. Here each
coder exists in two forms:

  * scalar encode/decode against ``BitWriter``/``BitReader`` — the sequential
    oracle used for golden tests and the pure-Python fallback codec;
  * vectorized codeword generators returning ``(bits, length)`` arrays — the
    form the vectorized encoder consumes (codewords are materialized in parallel and
    packed by prefix-sum, never written serially).
"""

from felics_tpu.coding.bitio import BitWriter, BitReader, BitStringLogger
from felics_tpu.coding.rice import RiceCoder, rice_code_length
from felics_tpu.coding.phase_in import PhaseInCoder

__all__ = [
    "BitWriter",
    "BitReader",
    "BitStringLogger",
    "RiceCoder",
    "rice_code_length",
    "PhaseInCoder",
]
