"""WFST decoding: decoding graphs, host token-passing Viterbi and
lattices, ARPA LMs and WER (numpy copies of the JAX package's host
modules), and the batched exact decoders on the device
(device_viterbi.py)."""
