"""WFST decoding: decoding graphs, host token-passing Viterbi and
lattices, ARPA LMs and WER (numpy copies of the JAX package's host
modules), and the batched exact decoders on the device
(device_viterbi.py)."""

from kaldi_fp16_tpu_torch.decode.viterbi import (
    DecodeOptions, DecodeResult, ViterbiDecoder,
)
from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
from kaldi_fp16_tpu_torch.decode.wer import levenshtein, wer
from kaldi_fp16_tpu_torch.decode.lm import (
    read_arpa, read_symbol_table, sentence_cost,
)
from kaldi_fp16_tpu_torch.decode.lattice import (
    Lattice, LatticeArc, LatticeDecodeOptions, LatticeDecoder, NGramLM,
    rescore_with_lm,
)
from kaldi_fp16_tpu_torch.decode.device_viterbi import (
    DenseGraph, DenseViterbiDecoder, DeviceLatticeDecoder,
    SparseViterbiDecoder,
)
from kaldi_fp16_tpu_torch.decode.streaming import (
    StreamingDecoder, StreamingEncoder, StreamingPipeline,
    WindowedStreamingDecoder,
)
