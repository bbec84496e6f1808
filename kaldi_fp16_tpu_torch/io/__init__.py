"""Kaldi-format data path (numpy only, no torch): binary I/O, FSTs,
matrix codecs, cegs egs with the Python and the native parser, sparse
graphs, batches and data loaders; copies of the JAX package's modules."""
