"""Kaldi-format data path (numpy only, no torch): binary I/O, FSTs,
matrix codecs, cegs egs with the Python and the native parser, sparse
graphs, batches and data loaders; copies of the JAX package's modules."""

from kaldi_fp16_tpu_torch.io.kaldi_io import BinaryReader, BinaryWriter
from kaldi_fp16_tpu_torch.io.matrix import (
    read_compressed_matrix_cm, read_compressed_matrix_cm2,
    read_compressed_matrix_cm3, read_full_matrix, write_compressed_matrix_cm,
    write_compressed_matrix_cm2, write_compressed_matrix_cm3,
    write_full_matrix,
)
from kaldi_fp16_tpu_torch.io.fst import (
    Fst, FstArc, FstState, read_fst, write_fst_compact_acceptor,
    write_fst_vector,
)
from kaldi_fp16_tpu_torch.io.egs import (
    EgsReader, Example, Index, IoBlock, Supervision, example_to_text,
    read_examples, write_example,
)
from kaldi_fp16_tpu_torch.io.sparse import (
    COO, CSR, coo_to_csr, csr_to_coo, fst_to_coo, fst_to_csr, merge_coo,
)
