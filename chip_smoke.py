"""Smoke run of the port on one NVIDIA GPU: build, check, train, decode.

    python3 chip_smoke.py

Drives the port's main path, bench.py's chain training step, at full
width: the flagship configs/cnn_tdnn.xconfig with random weights from
seed 0, the 7052-state phone-LM den graph (F = 3526 chains, T_out = 49),
B = 128 sequences of 150 frames; once with the den's loop scans (the
den_matmul kernel) and once with the default den, whose scans resolve to
the fused ones on a card (the den_scan kernels); the loop den once more
with M pre-split (den_matmul, split="pre"); and the blocked den on the
same graph (the segment_reduce kernel).  Then the flagship recipe's
production loop: synthetic cegs files at flagship geometry, the
DataLoader, and `python -m kaldi_fp16_tpu_torch.tools.train`'s main with
configs/train_flagship.sh's flags (NG-SGD, the xent head, loss scaling,
the orthonormal constraint, checkpoints) at B = 128, killed and resumed;
the same with --data-parallel 1, bench.py's step on two data-parallel
ranks sharing the card, and the multi-process tools on the card.
Then decoding: offline at HCLG scale in each layout (segment, ELL,
tree-ELL), data-parallel on two ranks, and through `tools.decode`; the
trained network handed to Kaldi's nnet3 formats and back, and decoded
through `tools.decode --model`; online through the streaming decoders and
the streaming encoder; the flagship with a restricted-attention layer,
trained and streamed; and the closed accuracy loop of `tools.synthwer`
(train, then decode to words).  Last, the verification harness's tools,
the x-vector family (Adam, tools.xvectortrain), the train step with
rematerialisation, and the measurement tools (trainbench, roofline,
scalebench, profile_host, profile_latdecode, profile_den, a trace).
Phases, one line of numbers each:

  1. device          the card (nvidia-smi name and power limit); TF32 off
  2. build           nvcc builds the CUDA kernels from kaldi_fp16_tpu_torch/csrc
  3. kernel          den_matmul, split="kernel" and "pre", against float64
                     and the split's plain version, repeats bit-identical;
                     timed with L2 warm and flushed beside torch.matmul
  4. scan_kernels    den_scan forward / backward at the production shape,
                     both splits, against their plain versions, timed
  5. den             production-scale loop den forward-backward, kernel
                     (both splits) vs plain path; a small den against the
                     float64 oracle
  6. den_fused       the default den (scan_impl="auto": the fused scans)
                     against the loop path, timed; a small fused den against
                     the oracle
  7. den_blocked     the graph forced to the blocked layout, the default
                     posterior reduce (the kernel on a card) and the einsum
                     one, against each other and the structured den; a
                     small blocked den against the oracle
  8. segment_reduce  the kernel and its order pass against their plain
                     versions (on the card and the CPU) at the production
                     pdf-order shape, its labels sorted and shuffled; timed
                     from CUDA graphs beside index_add_
  9. small           a narrow fp32 train step on the card against the CPU
 10. train           1 warm-up + 5 timed flagship train steps, loop scans
 11. train_fused     the same with the default den (fused scans)
 12. ng_vs_cpu       one NG update step at flagship width (B = 128, T_in =
                     164, ranks 20 / 80, patch-lowered convs) on the card;
                     its NG calls re-run on the CPU from the same inputs
                     and states, equal at the NG tests' bars
 13. egs             2 x 512 synthetic cegs (164 frames in, 50 out, 3080
                     pdfs) and the 7052-state den.fst written by the port's
                     tool and read back; the DataLoader's batches with the
                     native and the Python parser, and the ProcessLoader's
                     (2 spawned workers), equal; ms per batch of each
 14. trainer         tools.train's main, train_flagship.sh's flags at
                     B = 128: 8 steps (checkpoint at 4), the first step's
                     den input [128, 50, 3080] through the Trainer's den
                     against the loop den and its scans against the plain
                     ones, the run resumed from step 4 equal to it bit for
                     bit, 1 + 1 den_scan launches and no den_matmul launch
                     per step; device and loop ms per step, idle share over
                     one window, the same 8 steps without NG (the NG cost),
                     peak memory
 15. data_parallel   tools.train's main with --data-parallel 1 (one rank,
                     NCCL) and the recipe's flags: its 8 steps and final
                     state equal to the trainer phase's bit for bit, the
                     data group's collectives and MB per step, device ms
                     per step beside the trainer phase's; then bench.py's
                     step at B = 256 in one process (bf16 with NG-SGD and
                     loss scaling and without, fp32 without), again with
                     its rows permuted (the yardstick), and on two ranks
                     of one gloo group on the card (128 rows, the fused
                     den, each): a gloo all-reduce of a CUDA tensor first,
                     the losses, the update and the BN statistics after
                     step 1 against one process's and the yardstick's
                     (after the last step reported), per-leaf update
                     distances, the ranks' states bit-identical to each
                     other and (bf16) to a repeat, 1 + 1 den_scan launches
                     per rank per step, ms per step, the collectives'
                     share, peak memory per rank; ranks with per-rank BN
                     statistics (bf16) and with averaged gradients (fp32)
                     must fail; the CPU tests' narrow fp32 cases on the
                     two ranks at those tests' bars (averaged gradients
                     must fail them); tools.mpworker as 2 processes on
                     the card against one process, 4 restoring their
                     checkpoint, a killed one failing its peer; and
                     tools.dryrun_multichip as 2 ranks on the card and
                     as 8 (data 2 x seq 2 x model 2)
 16. model_seq_parallel  bench.py's step at B = 128 on two gloo ranks of
                     the card split over the model axis (the 3080-pdf
                     heads, prefinal and TDNN-F affines by columns) and
                     over the seq axis (75 input frames and 25 grid
                     frames each, halos per temporal op): fp32 without NG
                     and bf16 with NG-SGD and loss scaling, 2 steps each,
                     against one process (losses, the update and the BN
                     statistics after step 1 at the data_parallel phase's
                     bars and yardstick), the ranks' whole states bit-
                     identical, 1 + 1 den_scan launches per rank per step;
                     per rank ms per step (CUDA events), collectives and MB
                     per step per axis, the collectives' share of an
                     instrumented step, peak memory beside one process's;
                     the CPU tests' narrow fp32 cases at (model 2) and
                     (seq 2) at those tests' bars; the 8-rank dryrun's
                     numbers from data_parallel
 17. decode_hclg     WFST decoding at HCLG scale: tools.decodebench's
                     synth_hclg_graph(100000, 3080) (390K arcs), random
                     loglikes made on the card, B = 16, T = 500: the Viterbi
                     decoder's checkpointed path, its plain path and a
                     repeat equal bit for bit; two utterances re-decoded on
                     the CPU equal; the lattice decoder (beam 4) with the
                     dense and the compact mask transfer equal, its
                     checkpointed and plain masks equal; the dense decoder
                     equal to the arc decoder at decodebench's defaults (S =
                     2048, P = 512, B = 32, T = 500); decode_audio_sec_per_s,
                     decode ms, launches per decode and peak memory
 18. decode_layouts  decode_hclg's graph and loglikes through the ELL and
                     tree-ELL layouts (width 128): the tree Viterbi
                     (checkpointed) and the ELL Viterbi (plain), and the
                     segment and tree plain paths, equal to the segment
                     decode bit for bit in best, words and alignment, and
                     their repeats; the two tie graphs decode to the
                     smallest arc id in every layout; the tree lattice
                     (checkpointed, compact transfer) and the ELL lattice
                     at B = 4 with the segment lattice's 1-best, equal to
                     the same layout on the CPU (2 utterances) bit for
                     bit, their arc instances that differ from the
                     segment lattice's counted and, for the utterance
                     with the most, each within float32 rounding of the
                     keep threshold in a float64 recomputation (the
                     layouts add in other orders); the tree windowed
                     stream (window >= T, chunks of 32) equal to the
                     offline decode; per layout ms per decode,
                     decode_audio_sec_per_s, launches per decode, peak
                     memory over held and the device ms split into
                     scatter, gather, reduce and other; the profile_tree
                     and profile_lattice twins' per-frame lines at their
                     defaults
 19. decode_parallel two gloo ranks sharing the card, 8 rows each of
                     decode_hclg's batch (loglikes made from the same
                     seed): the segment and tree Viterbi decoders and the
                     tree lattice decoder with mesh=, each rank's results
                     for all 16 rows equal to one process's, one
                     all-reduce per decode
 20. decode_tool     tools.decode's main --on-device, plainly and with
                     --nbest 3, on one of the egs phase's cegs files (512
                     utterances) through the flagship model and a 20000-state
                     HCLG-shaped graph written as an OpenFst file: every
                     utterance final, the lattices' 1-best equal to the
                     Viterbi words; the utterance count and wall seconds
 21. kaldi_model     the trainer phase's network (its step-8 checkpoint)
                     exported to nnet3 text and a binary .raw by
                     models/kaldi_loader.py, each loaded into a network of
                     another seed: parameters and BN buffers (counts as
                     max(count, 1)) and the fp32 and bf16 eval forwards
                     equal the source's bit for bit; tools.modeltools info,
                     copy text -> binary -> text, compare (0); tools.loadtest
                     round trip (bit for bit) and --model on the .raw;
                     tools.decode --on-device --model on the .raw, the
                     decode_tool phase's cegs file and graph: the words of
                     the network in memory, utterance for utterance;
                     seconds of export, parse, binary write, loads, MB
 22. stream_decode   streaming decoding at decode_hclg's HCLG scale and
                     loglikes: the incremental decoder fed 16 frames at a
                     time and in a ragged 5, 7, 12 schedule, and the
                     windowed decoder at window >= T, equal to the offline
                     decode bit for bit; the windowed decoder at window 96
                     with chunks of 6, 16 and 32 (its window bounded after
                     every feed, utterances equal to offline counted, peak
                     memory over what the phase holds at T = 500 and 1000);
                     tools.streambench's decode-only rows
 23. stream_encode   the streaming encoder on the flagship network (random
                     weights, seed 0, 100-dim ivectors, B = 8) at chunk_out
                     6, 16 and 32: fp32 against its offline_reference and
                     across chunk sizes, bf16 against its own oracle;
                     tools.streambench's encoder and pipeline rows
 24. attention       the flagship with attention1 (15 heads, value 80, key
                     40, context 5 + 1 + 2 at time-stride 3) after tdnnf21,
                     16,271,624 parameters: bench.py's step with the
                     default den, 1 warm-up + 3 timed, twice, in turns
                     with the flagship's (flagship, attention, attention,
                     flagship), 1 + 1 den_scan launches per step, ms
                     beside the flagship's and train_fused's, peak
                     memory; a narrow fp32 attention step on the card
                     against the CPU (rtol 2e-4 / atol 2e-5 scalars, 1e-4 /
                     1e-5 parameters); the streaming encoder (B = 8,
                     chunk_out 16, fp32) against its offline reference
 25. synthwer        tools.synthwer's main, the 40-word / 80-phone streaming
                     and rescoring run of the JAX evidence: ok, the WER
                     trajectory, den_matmul launches (its den has L = 1,
                     F = 81: loop scans), the first batch's den against
                     the same den through plain matmuls
 26. verify_chain    the verification harness, on the egs phase's files:
                     tools.chainverify at its defaults (a strict CPU pass,
                     then the card), then on the 7052-state den.fst and its
                     cegs (T = 50, 3080 pdfs) on the card once per den path,
                     each route asserted from the tool's output: structured
                     with the fused scans at B = 128, the loop scans at
                     B = 8 with split "kernel" and "pre", blocked with the
                     kernel reduce at B = 8 (phases 1-4: the fp64 oracle,
                     finite differences of the probed row's objective,
                     repeats bit for bit); tools.denverify on that den.fst;
                     tools.chaintest on the flagship; tools.chainbench
                     --topology phone-lm at production scale
 27. verify_net      tools.fwdtest on the flagship (B = 8, T = 150, 20
                     iterations) with and without --bn-identity;
                     tools.backtest and tools.sgdtest on the card, TF32 off
 28. verify_train    tools.traintest on the flagship at B = 128 over the egs
                     phase's cegs, 9 steps at lr 1e-4 (fused route, the
                     first batch's loss falls by its second visit, the
                     loop's train_audio_sec_per_s_per_chip); tools.soak on the
                     flagship (SIGKILL after 25 steps, --resume, run 1's
                     objf reproduced exactly; cut to 2 epochs and a
                     checkpoint every 20 steps); tools.abtest --ab grid
 29. verify_data     tools.gputest (pageable and pinned copies to the card),
                     tools.dltest (in-line, --workers 2, --process-workers 2:
                     one bf16 error), egstools analyze / verify, nscheck and
                     csrdump on the egs phase's files
 30. xvector         the x-vector family at XVectorConfig()'s widths with
                     1024 speakers: 30 fp32 Adam steps (warmup + StepLR) at
                     B = 64 x 300 frames, the loss on a fixed batch of 256
                     utterances must fall; ms per step,
                     peak memory; one fp32 loss + grad on the card against
                     the CPU at B = 4 (rtol 1e-4), then two adam_update
                     steps from that state on the same gradients, with and
                     without weight decay, parameters and m / v held card
                     against CPU (rtol 1e-4); tools.xvectortrain at its
                     defaults (ok)
 31. remat           bench.py's step (B = 128, T_in = 150, fused den) with
                     TrainConfig.remat off and on, same weights, batch and
                     SpecAugment generator, 2 steps each: losses, grad
                     norms and parameters at the JAX bars (rel 1e-6, 1e-5;
                     rtol 1e-5 / atol 1e-7), the generator's state and the
                     BN buffers equal; peak memory and ms of each
 32. measure         the measurement twins: tools.trainbench at B = 128
                     (plain, --remat, --natural-gradient) and --topology
                     random; tools.roofline at B = 128 on every stage (no
                     share over 100 %); tools.scalebench --worlds 1,2
                     (world 1 over NCCL, world 2 gloo ranks sharing the card);
                     tools.profile_host --place on the egs phase's files;
                     tools.profile_latdecode at its defaults (100,000
                     states, B = 64, T = 300); tools.profile_den --impls
                     high,pallas,fused; one trainbench step inside
                     utils.profiling.trace, whose Chrome trace must name
                     the den_scan kernels
 33. summary         the kernels' JSON line, then {"ok": true, "device": ...}

The verify and measure phases run each tool's main in this process (soak
and abtest start tools.train processes), its output in
build/chip_smoke/verify/; a FAIL line or a nonzero exit fails the run.
Their den_scan, den_matmul and segment_reduce launches, and the remat
phase's, count in the kernels line.

small_step_vs_cpu also holds a narrow NG step (patch-lowered convs) on
the card against the CPU.

Each path's kernel counts are set to 0 just before it is driven and read
just after; comparison launches do not count.  Each kernel's bound is the
larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over 989 TFLOP/s (bf16 tensor cores;
H100 SXM data sheet).

Any failure raises and exits non-zero: there is no CPU path and no
fallback.  Needs one card, nvcc, no network and no JAX.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
from kaldi_fp16_tpu_torch.chain.denominator import (
    AC, SB, DenominatorComputation,
)
from kaldi_fp16_tpu_torch.chain.graph import (
    DenominatorGraph, make_phone_lm_den_fst, make_simple_den_fst,
)
from kaldi_fp16_tpu_torch.chain.objective import ChainTrainingOpts
from kaldi_fp16_tpu_torch.chain.reference import (
    denominator_forward_backward_ref,
)
from kaldi_fp16_tpu_torch.convert import params_to_numpy
from kaldi_fp16_tpu_torch.decode.device_viterbi import (
    NEG_INF, ArcGraph, DenseViterbiDecoder, DeviceLatticeDecoder,
    SparseViterbiDecoder,
)
from kaldi_fp16_tpu_torch.decode.graph import DecodingGraph
from kaldi_fp16_tpu_torch.decode.streaming import (
    StreamingDecoder, StreamingEncoder, WindowedStreamingDecoder,
)
from kaldi_fp16_tpu_torch.io.dataloader import (
    DataLoader, DataLoaderConfig, ProcessLoader, shard_files,
)
from kaldi_fp16_tpu_torch.io.fst import (
    Fst, FstArc, FstState, read_fst_file, write_fst_file,
)
from kaldi_fp16_tpu_torch.models.model import (
    build_model, build_model_from_string,
)
from kaldi_fp16_tpu_torch.models import network as network_module
from kaldi_fp16_tpu_torch.models.network import Network
from kaldi_fp16_tpu_torch.ops import _build, den_scan
from kaldi_fp16_tpu_torch.ops.den_matmul import (
    DenMatmul, den_matmul_split_plain,
)
from kaldi_fp16_tpu_torch.parallel.data_parallel import (
    broadcast_train_state, full_state_dict, shard_batch, shard_graph,
    shard_train_state,
)
from kaldi_fp16_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, free_address, make_mesh, spawn_ranks,
)
from kaldi_fp16_tpu_torch.ops.segment_reduce import (
    segment_order, segment_order_plain, segment_reduce, segment_reduce_plain,
)
from kaldi_fp16_tpu_torch.io.nnet3_binary import (
    Nnet3Model, components_from_text, write_nnet3,
)
from kaldi_fp16_tpu_torch.models.kaldi_loader import (
    export_network_text, load_into_network, parse_nnet3_text,
)
from kaldi_fp16_tpu_torch.tools import (
    decode as decode_tool, decodebench, dryrun_multichip, loadtest,
    make_synthetic_egs, modeltools, mpworker, ng_precision, profile_lattice,
    profile_tree, streambench, synthwer,
)
from kaldi_fp16_tpu_torch.tools.dryrun_multichip import run_setup
from kaldi_fp16_tpu_torch.models.xvector import (
    XVectorConfig, init_xvector, xvector_forward, xvector_loss,
)
from kaldi_fp16_tpu_torch.training.schedulers import (
    adam_update, init_adam_state, step_lr, warmup_lr,
)
from kaldi_fp16_tpu_torch.utils.profiling import profile_fn, trace
from kaldi_fp16_tpu_torch.tools.profile_step import (
    supervision as bench_num_graph,
)
from kaldi_fp16_tpu_torch.tools import train as train_tool
from kaldi_fp16_tpu_torch.training import train_step as train_step_module
from kaldi_fp16_tpu_torch.training.checkpoint import CheckpointManager
from kaldi_fp16_tpu_torch.training.train_step import (
    TrainConfig, init_train_state, make_train_step,
)
from kaldi_fp16_tpu_torch.training.trainer import Trainer
from kaldi_fp16_tpu_torch.utils.profiling import (
    H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_BYTES, kernel_times,
)

ROOT = Path(__file__).resolve().parent
B, T_IN, P, AN = 128, 150, 3080, 256
LEFT = STRIDE = 3
T_OUT = (T_IN - LEFT + STRIDE - 1) // STRIDE          # 49
FP64_RTOL = 3e-6                 # tests/test_pallas_den_matmul.py:46-48
LOGP_RTOL, POST_RTOL, POST_ATOL = 2e-5, 2e-4, 2e-6    # ibid. :94-97
KERNEL_REPLACES = "kaldi_fp16_tpu/ops/pallas_den_matmul.py:95"
PRE_REPLACES = "_probe_pallas_den.py:57"
SCAN_REPLACES = {"fwd": "kaldi_fp16_tpu/ops/pallas_den_scan.py:180",
                 "bwd": "kaldi_fp16_tpu/ops/pallas_den_scan.py:307"}
REDUCE_REPLACES = "kaldi_fp16_tpu/ops/pallas_reduce.py:88"
# raw scan histories, kernel vs plain: fp32 products summed in another
# order, compounded over T frames (tests/test_torch_den_scan.py)
HIST_RTOL, HIST_ATOL_REL = 2e-5, 1e-7
# against the float64 oracle (tests/test_pallas_den_scan.py:104-106)
ORACLE_LOGP_ATOL, ORACLE_POST_RTOL, ORACLE_POST_ATOL = 5e-5, 1e-3, 5e-5
# blocked vs structured log-prob (tests/test_chain_denominator.py:175-178)
LOGP_ATOL = 2e-6
REDUCE_TOL = 1e-5                # fp32 segment sums, tests/test_pallas_reduce.py:30
REDUCE_REPS = 10                 # segment_reduce calls per timed CUDA graph
# fp32 card vs CPU: summation order only, through two SGD steps
SMALL_RTOL = 1e-4
# NG ranks of the small NG step: at the default ranks each narrow site
# keeps half its dimensions, where a near-tie between kept and dropped
# eigenvalues leaves the factor's span to fp32 rounding
# (tests/test_torch_trainer.py)
SMALL_NG_RANK = 4
# the production loop: the dataset's smallest chunk (io/batch.py:8), 50
# supervision frames at stride 3; 2 files x 512 examples = 8 batches of 128
EGS_T_IN, EGS_T_OUT, EGS_FILES, EGS_PER_FILE = 164, 50, 2, 512
TRAIN_STEPS, CKPT_STEP = 8, 4
NG_UPDATE_STEP = 5             # NG counters 0 and 4: steps 1 and 5
WORK = ROOT / "build" / "chip_smoke"
# decoding: tools/decodebench.py's HCLG scale (S = 100K states, 390K arcs)
# at B = 16, T = 500, its lattice beam, and its dense-decoder defaults
DEC_S, DEC_B, DEC_T, DEC_BEAM = 100_000, 16, 500, 4.0
DENSE_S, DENSE_P, DENSE_B, DENSE_T, DENSE_E = 2048, 512, 32, 500, 8
DEC_COST_RTOL = 1e-5             # fp32 path costs, card vs CPU
DEC_ITERS = 2                    # timed decodes per decoder
TREE_W = 128                     # the tree layout's row width
ELL_LAT_B = 4                    # ELL lattices keep [T, S, B] alphas: 0.8 GB
LAT_CPU_B = 2                    # a layout's lattices re-run on the CPU
TOOL_S = 20_000                  # the decode tool's HCLG-shaped graph
# streaming: tools/streambench.py's chunk sizes, window and batch; a ragged
# feed schedule; encoder outputs for 96 frames (a multiple of every chunk)
STREAM_CHUNKS, STREAM_WINDOW, STREAM_RAGGED = (6, 16, 32), 96, (5, 7, 12)
STREAM_B, STREAM_T_OUT, STREAM_ITERS = 8, 96, 20
# streamed vs offline encoder outputs (tests/test_streaming.py:92, :102)
ENC_FP32_TOL, ENC_BF16_TOL = 2e-5, 0.1
# the JAX evidence's streaming closed loop
# (docs/evidence/synthwer_r5_tpu.json, "streaming_closed_loop") plus
# --lm-rescore
SYNTHWER_FLAGS = ["--words", "40", "--phones", "80", "--feat-dim", "32",
                  "--words-per-utt", "5", "--dur", "2", "--max-dur", "4",
                  "--train-utts", "768", "--test-utts", "48", "--steps",
                  "200", "--streaming", "--lm-rescore"]
# data parallel (PERF.md): world 1 over NCCL equals the trainer phase bit
# for bit.  Two gloo ranks on the card against one process at bench.py's
# step, B = 256: the flagship's step at this init is ill-conditioned (a
# last-bit change in prefinal-chain's BatchNorm grows ~100x through its
# backward; one process, or the JAX step, with its rows permuted moves
# its first update ~1 % in fp32 and ~40 % in bf16).  So the update and
# the BN statistics after step 1 are held at DP_BARS' multiples of the
# distance from one process of the yardstick, one process with its rows
# permuted (the same mathematics summed in another order), or at their
# floors; a bar must stay below 1, the distance of no update at all.
# Later distances (bf16's yardstick reaches 0.77 by step 3) are reported,
# not held.  fp32's losses are held at 1e-5 (tests/test_parallel.py's
# bar), bf16's first loss at 2e-4 and the rest at 1e-2.  Two controls
# must fail: per-rank BatchNorm statistics (bf16) and gradients averaged
# over the ranks (fp32).  The narrow fp32 cases of the CPU tests hold the
# collectives on CUDA tensors at those tests' bars, and averaged
# gradients must fail them.
DP_B, DP_STEPS, DP32_STEPS = 256, 3, 2
DP_RUNS = (("ng", True, "bfloat16", DP_STEPS),
           ("no_ng", False, "bfloat16", DP_STEPS),
           ("fp32", False, "float32", DP32_STEPS))
DP_LOSS_RTOL = {"ng": (2e-4, 1e-2), "no_ng": (2e-4, 1e-2),
                "fp32": (1e-5, 1e-5)}      # (first loss, later losses)
# after step 1, tag: ((update, BN) x the yardstick, (update, BN) floors)
DP_BARS = {"ng": ((2.0, 3.0), (5e-2, 1e-3)),
           "no_ng": ((2.0, 3.0), (5e-2, 1e-3)),
           "fp32": ((3.0, 3.0), (1e-3, 1e-5))}
DP_HEAD_LEAVES = ("layers.output.w", "layers.prefinal-chain.small_w",
                  "layers.prefinal-chain.big_w")
DP_TOP_LEAVES = 3
NARROW_LOSS = dict(rtol=1e-5)
NARROW_PARAMS = dict(rtol=2e-5, atol=1e-6)
NARROW_BN_MEAN = dict(rtol=1e-5, atol=1e-7)
NARROW_BN = dict(rtol=1e-5, atol=5e-7)
NARROW_NG_V = dict(rtol=1e-4, atol=1e-5)
# model and sequence parallel: bench.py's step at B = 128 on two gloo
# ranks of the card, split over the model axis and over the seq axis, each
# against one process at B = 128 with the data_parallel phase's bars and
# yardstick (the same step with its rows permuted); fp32 without NG and
# bf16 with NG-SGD and loss scaling (the recipe's), DP_BARS / DP_LOSS_RTOL
# under the tags "fp32" and "ng".  The first loss (the forward alone) is
# held at DP_LOSS_RTOL's first bar; a later loss follows a step-1 update
# of this ill-conditioned step, so its bar is the larger of DP_LOSS_RTOL's
# and DP_BARS' update multiple of the yardstick's loss difference (at
# B = 128 fp32's yardstick moves loss 2 by 9.9e-5, ten times 1e-5: my chip
# run 2, PR 13)
MSP_B, MSP_STEPS = 128, 2
MSP_MESHES = {"model2": MeshConfig(data=1, model=2),
              "seq2": MeshConfig(data=1, seq=2)}
MSP_RUNS = (("fp32", False, "float32"), ("ng", True, "bfloat16"))
MP_FILES, MP_LOCAL_B, MP_STEPS = 4, 4, 2
MP_HEARTBEAT_S, MP_TIMEOUT_S = 20, 300
DP_JOIN_S = 600
FLUSH_BYTES = 128 << 20          # > the 50 MB L2
# the model of the attention phase: the flagship with one restricted
# attention layer after tdnnf21, at the head and context widths of Kaldi's
# restricted-attention xconfig recipes; its narrow twin for the card-vs-CPU
# step, held at tests/test_torch_train_step.py's scalar bars (and its
# parameter bars, SMALL_RTOL / 1e-5)
ATTENTION_LAYER = ("attention-relu-batchnorm-layer name=attention1 "
                   "num-heads=15 value-dim=80 key-dim=40 num-left-inputs=5 "
                   "num-right-inputs=2 time-stride=3")
SMALL_ATTENTION_LAYER = ("attention-relu-batchnorm-layer name=attention1 "
                         "num-heads=3 value-dim=6 key-dim=4 num-left-inputs=5 "
                         "num-right-inputs=2 time-stride=3")
ATTENTION_SIZE = (16_271_624, (63, 54))      # parameters, time context
ATTENTION_SCALAR = dict(rtol=2e-4, atol=2e-5)
# the flagship's layer types at narrow widths (tests/test_torch_train_step.py)
SMALL_XCONFIG = """
input name=ivector dim=10
input name=input dim=8
idct-layer name=idct input=input dim=8 cepstral-lifter=22
batchnorm-component name=idct-batchnorm input=idct
linear-component name=ivector-linear l2-regularize=0.03 dim=16 input=ReplaceIndex(ivector, t, 0)
batchnorm-component name=ivector-batchnorm target-rms=0.025
combine-feature-maps-layer name=combine_inputs input=Append(idct-batchnorm, ivector-batchnorm) num-filters1=1 num-filters2=2 height=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 height-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=4
conv-relu-batchnorm-layer name=cnn2 height-in=8 height-out=4 height-subsample-out=2 time-offsets=-1,0,1 height-offsets=-1,0,1 num-filters-out=6
tdnnf-layer name=tdnnf3 dim=24 bottleneck-dim=8 time-stride=0
tdnnf-layer name=tdnnf4 dim=24 bottleneck-dim=8 time-stride=3
prefinal-layer name=prefinal-l input=tdnnf4 big-dim=20 small-dim=12
prefinal-layer name=prefinal-chain input=prefinal-l big-dim=20 small-dim=12
output-layer name=output include-log-softmax=false dim=24
prefinal-layer name=prefinal-xent input=prefinal-l big-dim=20 small-dim=12
output-layer name=output-xent dim=24
"""


def phase(phase_name, **numbers):
    print(json.dumps({"phase": phase_name, **numbers}), flush=True)


def cuda_ms(fn, iters):
    """Mean device milliseconds of `iters` back-to-back calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / H100_PEAK_HBM_BYTES * 1e3
    t_ops = flops / H100_PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def captured(fn, reps):
    """A CUDA graph of `reps` back-to-back calls of fn: replaying it times
    the device work alone, without the host's time to enqueue each call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def warm_ms(fn, reps):
    """Mean device ms of one call of fn among `reps` back-to-back calls
    (L2 warm), replayed from a CUDA graph."""
    graph = captured(fn, reps)
    return cuda_ms(graph.replay, 1) / reps


def cold_ms(fn, flush, iters):
    """Mean device ms of one call of fn with the L2 flushed before each,
    replayed from a CUDA graph."""
    graph = captured(fn, 1)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_rel(out, ref):
    return float(np.max(np.abs(out.astype(np.float64) - ref)
                        / (np.abs(ref) + 1e-8)))


def alternate_ms(plain, kernel):
    """Mean device ms of one call each, in the order plain, kernel,
    kernel, plain (after one warm-up call of each)."""
    plain(), kernel()
    ms = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(cuda_ms(kernel if name == "kernel" else plain, 1))
    return float(np.mean(ms["kernel"])), float(np.mean(ms["plain"]))


def den_input(dev):
    """The production-scale den input [B, T_OUT, P], from seed 2."""
    gen = torch.Generator(device=dev).manual_seed(2)
    return torch.randn((B, T_OUT, P), generator=gen, device=dev)


def check_vs_oracle(den, graph, x, rows, leaky, dev):
    """The den on the card against the float64 oracle, at the bars of
    tests/test_pallas_den_scan.py:104-106."""
    lp, post = den.forward_backward(torch.from_numpy(x).to(dev))
    for n in rows:
        rlp, rpost = denominator_forward_backward_ref(graph, x[n],
                                                      leaky=leaky)
        if not abs(lp[n].item() - rlp) < ORACLE_LOGP_ATOL:
            raise AssertionError(f"log-prob {lp[n].item()} vs float64 {rlp}")
        np.testing.assert_allclose(post[n].cpu().numpy(), rpost,
                                   rtol=ORACLE_POST_RTOL,
                                   atol=ORACLE_POST_ATOL)


def assert_hist_close(out, ref, name):
    """Kernel vs plain scan output at the HIST bars; returns max abs err."""
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=HIST_RTOL,
                               atol=HIST_ATOL_REL * scale, msg=name)
    return float((out - ref).abs().max())


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's smoke run needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision must stay 'highest'")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          torch=torch.__version__, cuda=torch.version.cuda)
    return torch.device("cuda", 0)


def build_phase():
    t0 = time.perf_counter()
    lib_path, compile_s = _build.build()
    _build.library()
    phase("build", compile_s=compile_s, total_s=time.perf_counter() - t0,
          library=str(lib_path.relative_to(ROOT)))


def kernel_phase(dev, layout):
    """den_matmul at F = 3526, n = 128, both splits and orientations."""
    M = layout.M
    F = M.shape[0]
    v = np.random.default_rng(1).random((F, B)).astype(np.float32)
    vd = torch.from_numpy(v).to(dev)
    Md = torch.from_numpy(M).to(dev)
    M64, v64 = M.astype(np.float64), v.astype(np.float64)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    result = {"F": F, "n": B, "terms": 6}
    for split in ("kernel", "pre"):
        dm = DenMatmul(M, dev, split=split)
        worst_abs = 0.0
        times = {"kernel": [], "plain": [], "kernel_cold": [], "library": [],
                 "library_cold": []}
        for transpose in (False, True):
            tag = f"{split}_{'MT' if transpose else 'M'}"
            ref = (M64.T if transpose else M64) @ v64
            out, again = dm.apply(vd, transpose), dm.apply(vd, transpose)
            plain = den_matmul_split_plain(dm.M, vd, transpose)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"den_matmul ({tag}) repeats differ")
            rel = max_rel(out.cpu().numpy(), ref)
            result[f"max_rel_err_fp64_{tag}"] = rel
            result[f"plain_max_rel_err_fp64_{tag}"] = max_rel(
                plain.cpu().numpy(), ref)
            if not rel <= FP64_RTOL:
                raise AssertionError(f"den_matmul ({tag}) rel err {rel} > "
                                     f"{FP64_RTOL} against float64")
            worst_abs = max(worst_abs, float((out - plain).abs().max()))

            def kernel():
                return dm.apply(vd, transpose)

            def split_plain():
                return den_matmul_split_plain(dm.M, vd, transpose)

            def library():
                return (Md.t() if transpose else Md) @ vd

            # device time from CUDA graphs: L2 warm, 2*T back-to-back
            # applications, plain, kernel, kernel, plain; then one
            # application at a time with the L2 flushed
            # (the plain version allocates its fp32 split copies of M on
            # every call: 8 calls per graph)
            for name in ("plain", "kernel", "kernel", "plain"):
                times[name].append(warm_ms(kernel, 2 * T_OUT) if name == "kernel"
                                   else warm_ms(split_plain, 8))
            times["kernel_cold"].append(cold_ms(kernel, flush, 10))
            times["library"].append(warm_ms(library, 2 * T_OUT))
            times["library_cold"].append(cold_ms(library, flush, 10))
        for name, t in times.items():
            result[f"{split}_{name}_us"] = 1e3 * float(np.mean(t))
        result[f"{split}_max_abs_err_vs_plain"] = worst_abs
        del dm
        torch.cuda.empty_cache()
    result["bit_identical"] = True
    phase("kernel", **result)
    return result


def check_scans(sk, x_tpn, tag):
    """sk's fused forward and backward scans on the emissions of x_tpn
    [T, P, N], each run twice and beside its plain version: repeats
    bit-identical, the kernels within the HIST bars of the plain versions.
    Returns (max abs errors, the same relative to the largest entry,
    {"fwd": (plain, kernel), "bwd": (plain, kernel)} calls to time)."""
    xs = sk._hoisted_emissions(x_tpn)
    kw = dict(L=sk.lay.L, T=x_tpn.shape[0], leaky=sk.leaky)

    def fwd():
        return den_scan.fused_forward(sk.M, *xs, sk.init, planes=sk._planes,
                                      **kw)

    def fwd_plain():
        return den_scan.fused_forward_plain(sk.M.t(), *xs, sk.init, **kw)

    out, again, ref = fwd(), fwd(), fwd_plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"den_scan forward ({tag}) repeats differ")
    err = {name: assert_hist_close(a, r, f"{tag} {name}") for name, a, r in
           zip(("adash_hist", "asum", "logc", "a_final"), out, ref)}
    total = out[3] * (1.0 + sk.leaky * sk._init_sum)

    def bwd():
        return den_scan.fused_backward(sk.M, *xs, out[1], sk.init, sk.real,
                                       total, planes=sk._planes, **kw)

    def bwd_plain():
        return den_scan.fused_backward_plain(sk.M, *xs, out[1], sk.init,
                                             sk.real, total, **kw)

    beta, beta_again, beta_ref = bwd(), bwd(), bwd_plain()
    torch.cuda.synchronize()
    if not torch.equal(beta, beta_again):
        raise AssertionError(f"den_scan backward ({tag}) repeats differ")
    err["beta_hist"] = assert_hist_close(beta, beta_ref, f"{tag} beta_hist")
    rel = {k: float((a - r).abs().max() / r.abs().max())
           for k, a, r in (("adash_hist", out[0], ref[0]),
                           ("beta_hist", beta, beta_ref))}
    return err, rel, {"fwd": (fwd_plain, fwd), "bwd": (bwd_plain, bwd)}


def scan_kernels_phase(dev, graph):
    """den_scan forward and backward at the production shape (L = 2,
    Fp = 3584, N = 128, T = 49), split="kernel" and "pre", against their
    plain versions."""
    result = {"N": B, "T": T_OUT, "bit_identical": True}
    for split in ("kernel", "pre"):
        sk = StructuredKernels(analyze_chain_structure(graph), 1e-5,
                               scan_impl="fused", split=split, device=dev)
        L, Fp = sk.lay.L, sk.lay.F
        if (L, Fp) != (2, 3584):
            raise AssertionError(f"fused layout is L={L}, Fp={Fp}, expected "
                                 f"2, 3584")
        gen = torch.Generator(device=dev).manual_seed(4)
        x = torch.exp(torch.randn((T_OUT, P, B), generator=gen, device=dev))
        err, rel, calls = check_scans(sk, x, split)
        result[f"{split}_max_abs_err"] = err
        result[f"{split}_max_err_rel_to_max"] = rel
        for tag, pair in calls.items():
            ms, plain_ms = alternate_ms(*pair)
            result[f"{split}_{tag}_ms"] = ms
            result[f"{split}_{tag}_plain_ms"] = plain_ms
        del calls, x, sk
    # bounds of one scan: T frames of six bf16 products of M [Fp, Fp] with
    # [Fp, N]; bytes of each input read once and each output written once
    LFN, FN = 2 * 3584 * B, 3584 * B
    flops = T_OUT * 6 * 2 * 3584 ** 2 * B
    emissions = T_OUT * (LFN + (LFN - FN) + FN)
    result["fwd_bound"] = bound(4 * (3584 ** 2 + emissions + 2 * 3584
                                     + T_OUT * LFN + 2 * T_OUT * B + B), flops)
    result["bwd_bound"] = bound(4 * (3584 ** 2 + emissions + T_OUT * B
                                     + 4 * 3584 + B + T_OUT * LFN), flops)
    phase("scan_kernels", **result)
    return result


def den_phase(dev, graph):
    """The loop den (scan_impl="loop") through den_matmul, split="kernel"
    and split="pre", against the torch.matmul path; the pre run is
    den_matmul_pre's path."""
    x = den_input(dev)
    den_k = DenominatorComputation(graph, leaky=1e-5, scan_impl="loop",
                                   device=dev)
    den_p = DenominatorComputation(graph, leaky=1e-5, matmul_impl="plain",
                                   scan_impl="loop", device=dev)
    den_pre = DenominatorComputation(graph, leaky=1e-5, scan_impl="loop",
                                     split="pre", device=dev)
    before = DenMatmul.launches
    lp_k, post_k = den_k.forward_backward(x)
    torch.cuda.synchronize()
    launches = DenMatmul.launches - before
    if launches != 2 * T_OUT:
        raise AssertionError(f"den forward-backward launched den_matmul "
                             f"{launches} times, expected {2 * T_OUT}")
    # den_matmul_pre's path: its count starts at 0 here
    DenMatmul.launches_pre = 0
    lp_pre, post_pre = den_pre.forward_backward(x)
    torch.cuda.synchronize()
    pre_launches = DenMatmul.launches_pre
    if pre_launches != 2 * T_OUT:
        raise AssertionError(f"den (split='pre') launched den_matmul_pre "
                             f"{pre_launches} times, expected {2 * T_OUT}")
    lp_p, post_p = den_p.forward_backward(x)
    lp_r, post_r = den_k.forward_backward(x)
    torch.cuda.synchronize()
    if not (torch.equal(lp_r, lp_k) and torch.equal(post_r, post_k)):
        raise AssertionError("den forward-backward repeats differ")
    if not (torch.isfinite(lp_k).all() and torch.isfinite(post_k).all()):
        raise AssertionError("den output not finite")
    for lp, post in ((lp_k, post_k), (lp_pre, post_pre)):
        torch.testing.assert_close(lp, lp_p, rtol=LOGP_RTOL, atol=0)
        torch.testing.assert_close(post, post_p, rtol=POST_RTOL,
                                   atol=POST_ATOL)
    ms = {"kernel": [], "plain": [], "pre": []}
    for name, den in (("plain", den_p), ("kernel", den_k), ("pre", den_pre),
                      ("pre", den_pre), ("kernel", den_k), ("plain", den_p)):
        ms[name].append(cuda_ms(lambda: den.forward_backward(x), 1))

    # the same code on a small graph against the float64 oracle
    small = DenominatorGraph.from_fst(
        make_phone_lm_den_fst(24, 13, 2, 4, seed=3), 24)
    xs = np.random.default_rng(3).normal(size=(4, 9, 24)).astype(np.float32)
    lp_s, post_s = DenominatorComputation(small, leaky=1e-5, device=dev) \
        .forward_backward(torch.from_numpy(xs).to(dev))
    for b in range(xs.shape[0]):
        rlp, rpost = denominator_forward_backward_ref(small, xs[b], leaky=1e-5)
        np.testing.assert_allclose(lp_s[b].item(), rlp, rtol=LOGP_RTOL)
        np.testing.assert_allclose(post_s[b].cpu().numpy(), rpost,
                                   rtol=POST_RTOL, atol=POST_ATOL)
    phase("den", B=B, T=T_OUT, P=P, launches=launches,
          pre_launches=pre_launches, bit_identical=True,
          logp_max_rel_vs_plain=float(((lp_k - lp_p).abs()
                                       / lp_p.abs()).max()),
          post_max_abs_vs_plain=float((post_k - post_p).abs().max()),
          pre_logp_max_rel_vs_plain=float(((lp_pre - lp_p).abs()
                                           / lp_p.abs()).max()),
          pre_post_max_abs_vs_plain=float((post_pre - post_p).abs().max()),
          kernel_ms=float(np.mean(ms["kernel"])),
          pre_ms=float(np.mean(ms["pre"])),
          plain_ms=float(np.mean(ms["plain"])), small_vs_fp64="ok")
    del post_k, post_p, post_r, post_pre, x, den_pre
    return den_k, pre_launches


def den_fused_phase(dev, graph, den_loop):
    """The default den (scan_impl="auto", which a card resolves to the
    fused scans) against the loop path."""
    x = den_input(dev)
    den_f = DenominatorComputation(graph, leaky=1e-5, device=dev)
    counts = (den_scan.fused_forward, den_scan.fused_backward, DenMatmul)
    before = [c.launches for c in counts]
    lp_f, post_f = den_f.forward_backward(x)
    torch.cuda.synchronize()
    launches = [c.launches - b for c, b in zip(counts, before)]
    if launches != [1, 1, 0] or den_f._structured.scan_used != "fused":
        raise AssertionError(f"fused den launched (fwd, bwd, den_matmul) "
                             f"{launches} times, expected [1, 1, 0]")
    lp_r, post_r = den_f.forward_backward(x)
    lp_l, post_l = den_loop.forward_backward(x)
    torch.cuda.synchronize()
    if not (torch.equal(lp_r, lp_f) and torch.equal(post_r, post_f)):
        raise AssertionError("fused den repeats differ")
    if not (torch.isfinite(lp_f).all() and torch.isfinite(post_f).all()):
        raise AssertionError("fused den output not finite")
    torch.testing.assert_close(lp_f, lp_l, rtol=LOGP_RTOL, atol=0)
    torch.testing.assert_close(post_f, post_l, rtol=POST_RTOL,
                               atol=POST_ATOL)
    fused_ms, loop_ms = alternate_ms(lambda: den_loop.forward_backward(x),
                                     lambda: den_f.forward_backward(x))
    # a small fused den (N = 128) against the float64 oracle
    small = DenominatorGraph.from_fst(
        make_phone_lm_den_fst(24, 13, 2, 4, seed=7), 24)
    xs = np.random.default_rng(4).normal(size=(128, 5, 24)).astype(np.float32)
    check_vs_oracle(DenominatorComputation(small, leaky=1e-4,
                                           scan_impl="fused", device=dev),
                    small, xs, (0, 77), 1e-4, dev)
    phase("den_fused", B=B, T=T_OUT, P=P, launches_fwd_bwd_matmul=launches,
          bit_identical=True, fused_faster=fused_ms < loop_ms,
          logp_max_rel_vs_loop=float(((lp_f - lp_l).abs()
                                      / lp_l.abs()).max()),
          post_max_abs_vs_loop=float((post_f - post_l).abs().max()),
          fused_ms=fused_ms, loop_ms=loop_ms, small_vs_fp64="ok")
    del post_f, post_r
    return lp_l, post_l, den_f


def segment_reduce_phase(dev, den_b):
    """The kernel at the blocked den's pdf-order shape [NB, J*AC, Tc*N],
    with that order's labels (sorted, padding last) and with each block's
    slots shuffled (same labels, seed 5): against its plain version on the
    card and on the CPU, repeats bit-identical, its order pass against
    segment_order_plain; device times from CUDA-graph replays beside the
    plain version's and index_add_'s."""
    pdfo = den_b._pdf_o
    n = den_b.frames_per_chunk(B, T_OUT) * B
    gen = torch.Generator(device=dev).manual_seed(5)
    vals = torch.rand((pdfo.num_blocks, pdfo.chunks * AC, n), generator=gen,
                      device=dev)
    NB, K, n = vals.shape
    perm = np.argsort(np.random.default_rng(5).random((NB, K)), axis=1)
    shuffled = torch.gather(pdfo.local, 1,
                            torch.from_numpy(perm).to(dev)).contiguous()
    vals_cpu = vals.cpu()
    flat = vals.reshape(NB * K, n)
    result = {"shape": [NB, K, n], "bit_identical": True}
    for tag, labels in (("sorted", pdfo.local), ("shuffled", shuffled)):
        def kernel():
            return segment_reduce(vals, labels)

        def plain():
            return segment_reduce_plain(vals, labels)

        out, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"segment_reduce ({tag}) repeats differ")
        torch.testing.assert_close(out, ref, rtol=REDUCE_TOL, atol=REDUCE_TOL)
        ref_cpu = segment_reduce_plain(vals_cpu, labels.cpu())
        torch.testing.assert_close(out.cpu(), ref_cpu, rtol=REDUCE_TOL,
                                   atol=REDUCE_TOL)
        # the order pass alone, against its plain version on the CPU
        order, offsets = segment_order(labels)
        order_ref, offsets_ref = segment_order_plain(labels.cpu())
        offsets = offsets.cpu()
        if not torch.equal(offsets, offsets_ref):
            raise AssertionError(f"segment_order ({tag}) offsets differ")
        order = order.cpu()
        for b in range(NB):
            used = int(offsets[b, -1])
            if not torch.equal(order[b, :used], order_ref[b, :used]):
                raise AssertionError(f"segment_order ({tag}) block {b} "
                                     f"differs")
        # L2 warm, REDUCE_REPS back-to-back calls per graph, plain, kernel,
        # kernel, plain; the library call: one index_add_ of every slot
        # into its block's row (the plain version without its index set-up)
        ms = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            ms[name].append(warm_ms(kernel if name == "kernel" else plain,
                                    REDUCE_REPS))
        key = labels.to(torch.int64)
        rows = (torch.arange(NB, device=dev)[:, None] * (SB + 1)
                + torch.where((key >= 0) & (key < SB), key, SB)).reshape(-1)
        acc = torch.zeros((NB * (SB + 1), n), device=dev)
        labelled = int(((labels >= 0) & (labels < SB)).sum())
        result[tag] = {
            "max_abs_err": float((out - ref).abs().max()),
            "max_abs_err_vs_cpu_plain": float((out.cpu() - ref_cpu)
                                              .abs().max()),
            "equal_to_cpu_plain": torch.equal(out.cpu(), ref_cpu),
            "ms": float(np.mean(ms["kernel"])),
            "ms_each": ms["kernel"],
            "plain_ms": float(np.mean(ms["plain"])),
            "library_ms": warm_ms(lambda: acc.index_add_(0, rows, flat),
                                  REDUCE_REPS),
            "order_pass_ms": warm_ms(lambda: segment_order(labels),
                                     REDUCE_REPS),
            "labelled_slots": labelled,
            # bytes the labelled values need (each read once), the labels
            # and the output; one add per labelled value
            "bound": bound(4 * (labelled * n + labels.numel() + out.numel()),
                           labelled * n),
            "bound_all_slots_ms": bound(4 * (vals.numel() + labels.numel()
                                             + out.numel()),
                                        vals.numel())[0],
        }
        del out, again, ref, ref_cpu, acc, rows
    result["max_abs_err"] = max(result[t]["max_abs_err"]
                                for t in ("sorted", "shuffled"))
    phase("segment_reduce", **result)
    return result


def den_blocked_phase(dev, graph, lp_s, post_s):
    """The production graph forced to the blocked layout: the default
    posterior reduce (posterior_reduce="auto", which a card resolves to the
    kernel) and the einsum reduce, against each other and the structured
    den."""
    x = den_input(dev)
    den_k = DenominatorComputation(graph, leaky=1e-5, layout="blocked",
                                   device=dev)
    den_e = DenominatorComputation(graph, leaky=1e-5, layout="blocked",
                                   posterior_reduce="einsum", device=dev)
    if den_k.layout_used != "blocked":
        raise AssertionError("layout='blocked' was not taken")
    if den_k.posterior_reduce != "kernel":
        raise AssertionError(f"the default posterior reduce resolved to "
                             f"{den_k.posterior_reduce!r} on the card, "
                             f"expected 'kernel'")
    chunks = -(-T_OUT // den_k.frames_per_chunk(B, T_OUT))
    # the main path of segment_reduce: its count starts at 0 here
    segment_reduce.launches = 0
    lp_k, post_k = den_k.forward_backward(x)
    torch.cuda.synchronize()
    launches = segment_reduce.launches
    if launches != chunks:
        raise AssertionError(f"blocked den launched segment_reduce "
                             f"{launches} times, expected {chunks}")
    lp_r, post_r = den_k.forward_backward(x)
    lp_e, post_e = den_e.forward_backward(x)
    torch.cuda.synchronize()
    if not (torch.equal(lp_r, lp_k) and torch.equal(post_r, post_k)):
        raise AssertionError("blocked den repeats differ")
    if not (torch.isfinite(lp_k).all() and torch.isfinite(post_k).all()):
        raise AssertionError("blocked den output not finite")
    for other in ((lp_e, post_e), (lp_s, post_s)):
        torch.testing.assert_close(lp_k, other[0], rtol=LOGP_RTOL,
                                   atol=LOGP_ATOL)
        torch.testing.assert_close(post_k, other[1], rtol=POST_RTOL,
                                   atol=POST_ATOL)
    kernel_ms, einsum_ms = alternate_ms(lambda: den_e.forward_backward(x),
                                        lambda: den_k.forward_backward(x))
    # a small graph that does not decompose, against the float64 oracle
    small = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=6, num_states=5, seed=3), 6)
    xs = np.random.default_rng(6).normal(size=(3, 7, 6)).astype(np.float32)
    den_s = DenominatorComputation(small, leaky=1e-5,
                                   posterior_reduce="kernel", device=dev)
    if den_s.layout_used != "blocked":
        raise AssertionError("the small random graph decomposed")
    check_vs_oracle(den_s, small, xs, range(3), 1e-5, dev)
    phase("den_blocked", B=B, T=T_OUT, P=P, arcs=graph.num_transitions,
          default_posterior_reduce=den_k.posterior_reduce,
          posterior_chunks=chunks, segment_reduce_launches=launches,
          bit_identical=True, kernel_faster=kernel_ms < einsum_ms,
          logp_max_rel_kernel_vs_einsum=float(((lp_k - lp_e).abs()
                                               / lp_e.abs()).max()),
          post_max_abs_kernel_vs_einsum=float((post_k - post_e).abs().max()),
          logp_max_rel_vs_structured=float(((lp_k - lp_s).abs()
                                            / lp_s.abs()).max()),
          post_max_abs_vs_structured=float((post_k - post_s).abs().max()),
          kernel_ms=kernel_ms, einsum_ms=einsum_ms, small_vs_fp64="ok")
    return launches, den_k


def small_step_phase(dev):
    """Two fp32 train steps of a narrow flagship-shaped model on the card
    against the same steps on the CPU (where the port runs the plain
    versions): the card's path (cuDNN convs, the kernel, the recursions)
    must agree with the CPU reference to summation-order noise.  Then the
    same with NG-SGD, xent and loss scaling (patch-lowered convs, one NG
    update in the first step)."""
    result = {}
    for ng in (False, True):
        result["ng" if ng else "plain"] = small_step_pair(dev, ng)
    phase("small_step_vs_cpu", **result)


def small_step_pair(dev, natural_gradient, xconfig=SMALL_XCONFIG,
                    scalar_tol=None):
    """Two fp32 steps of `xconfig` on the card and on the CPU; the losses,
    grad and update norms within `scalar_tol` (default rtol SMALL_RTOL),
    every parameter within rtol SMALL_RTOL / atol 1e-5."""
    scalar_tol = scalar_tol or dict(rtol=SMALL_RTOL)
    n_seq, t_in, n_pdfs = 4, 30, 24
    t_out = (t_in - LEFT + STRIDE - 1) // STRIDE
    rng = np.random.default_rng(5)
    model = build_model_from_string(xconfig)
    graph = DenominatorGraph.from_fst(
        make_phone_lm_den_fst(n_pdfs, 13, 2, 4, seed=3), n_pdfs)
    num_graph = bench_num_graph(n_seq, t_out, 2 * t_out, n_pdfs, rng)
    ng = (dict(natural_gradient=True, ng_rank_in=SMALL_NG_RANK,
               ng_rank_out=SMALL_NG_RANK, xent_regularize=0.1,
               use_loss_scaling=True) if natural_gradient else {})
    config = TrainConfig(learning_rate=0.01, momentum=0.9,
                         frame_subsampling_factor=STRIDE, left_context=LEFT,
                         compute_dtype="float32", **ng)
    batch = {"features": rng.normal(size=(n_seq, t_in, 8)).astype(np.float32),
             "ivectors": rng.normal(size=(n_seq, 10)).astype(np.float32)}
    outs, params = {}, {}
    for tag, d in (("cpu", torch.device("cpu")), ("card", dev)):
        # the same CPU generator initialises both copies identically
        net, opt, scale = init_train_state(
            model, torch.Generator().manual_seed(0), config, device=d)
        step = make_train_step(
            model, net, DenominatorComputation(graph, leaky=1e-5, device=d),
            num_graph, ChainTrainingOpts(), config, num_frames_out=t_out)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        for _ in range(2):
            opt, scale, out = step(opt, scale, b)
        outs[tag] = out
        params[tag] = params_to_numpy(net)[0]
    worst = {}
    for name in ("loss", "grad_norm", "param_change_norm"):
        a = float(getattr(outs["card"], name))
        r = float(getattr(outs["cpu"], name))
        np.testing.assert_allclose(a, r, **scalar_tol, err_msg=name)
        worst[name] = abs(a - r) / abs(r)
    for lname, p in params["cpu"].items():
        for pname, w in p.items():
            np.testing.assert_allclose(params["card"][lname][pname], w,
                                       rtol=SMALL_RTOL, atol=1e-5,
                                       err_msg=f"{lname}/{pname}")
    return {"B": n_seq, "T_in": t_in, "natural_gradient": natural_gradient,
            "loss": float(outs["card"].loss), "rel_diff": worst}


def train_phase(dev, den, name, counters, per_step, check_den=None,
                xconfig=None, steps=6):
    """1 warm-up + (steps - 1) timed steps of bench.py's step on the
    flagship (or `xconfig`).  counters: {kernel name: object with a
    `launches` count}; each count is set to 0 before the steps and must
    grow by per_step[name] in every step.  check_den: another den that
    each step's den input is run through afterwards, to hold `den`
    against it on the nnet outputs that training produced.  Prints the
    phase line `name` (None: none); returns (launches, losses, numbers)."""
    seen = []
    if check_den is not None:
        run = den.forward_backward

        def keep_input(x, *args, **kwargs):
            seen.append(x.detach().clone())
            return run(x, *args, **kwargs)

        den.forward_backward = keep_input
    rng = np.random.default_rng(0)
    model = build_model(xconfig or str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    num_graph = bench_num_graph(B, T_OUT, AN, P, rng)
    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=STRIDE, left_context=LEFT)
    net, opt, scale = init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), config, device=dev)
    step = make_train_step(model, net, den, num_graph, ChainTrainingOpts(),
                           config, num_frames_out=T_OUT)
    batch = {
        "features": torch.from_numpy(
            rng.normal(size=(B, T_IN, 40)).astype(np.float32)).to(dev),
        "ivectors": torch.from_numpy(
            rng.normal(size=(B, 100)).astype(np.float32)).to(dev),
        "weights": torch.ones(B, device=dev),
    }
    spec_gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()

    # the main path: every kernel count starts at 0 here
    for counter in counters.values():
        counter.launches = 0
    step_ms, losses, den_logprobs = [], [], []
    for i in range(steps):
        before = {k: c.launches for k, c in counters.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt, scale, out = step(opt, scale, batch, generator=spec_gen)
        end.record()
        end.synchronize()
        loss, num_lp = float(out.loss), float(out.num_logprob)
        if not (np.isfinite(loss) and num_lp > -1e20 and bool(out.ok)
                and not bool(out.skipped)):
            raise AssertionError(f"step {i}: loss={loss} num_logprob={num_lp}"
                                 f" ok={bool(out.ok)} skipped="
                                 f"{bool(out.skipped)} (containment or skip)")
        for k, c in counters.items():
            if c.launches - before[k] != per_step[k]:
                raise AssertionError(f"step {i} launched {k} "
                                     f"{c.launches - before[k]} times, "
                                     f"expected {per_step[k]}")
        losses.append(loss)
        den_logprobs.append(float(out.den_logprob))
        if i > 0:                       # step 0 is the warm-up
            step_ms.append(start.elapsed_time(end))
    launches = {k: c.launches for k, c in counters.items()}
    mean_ms = float(np.mean(step_ms))
    checked = {}
    if check_den is not None:
        del den.forward_backward
        worst_lp = worst_post = 0.0
        for x in seen:
            lp, post = den.forward_backward(x)
            lp_c, post_c = check_den.forward_backward(x)
            torch.testing.assert_close(lp, lp_c, rtol=LOGP_RTOL, atol=0)
            torch.testing.assert_close(post, post_c, rtol=POST_RTOL,
                                       atol=POST_ATOL)
            worst_lp = max(worst_lp, float(((lp - lp_c).abs()
                                            / lp_c.abs()).max()))
            worst_post = max(worst_post, float((post - post_c).abs().max()))
        checked = {"den_inputs_checked": len(seen),
                   "den_logp_max_rel_vs_check": worst_lp,
                   "den_post_max_abs_vs_check": worst_post}
        del seen
    numbers = dict(
        B=B, T_in=T_IN, T_out=T_OUT, timed_steps=len(step_ms),
        step_ms=mean_ms, step_ms_each=step_ms, losses=losses,
        den_logprobs=den_logprobs, **checked,
        train_audio_sec_per_s_per_chip=B * T_IN / 100.0 / (mean_ms / 1e3),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        **{f"{k}_launches": v for k, v in launches.items()})
    if name is not None:
        phase(name, **numbers)
    return launches, losses, numbers


def ng_vs_cpu_phase(dev, den):
    """NG-SGD at flagship width, the card against the CPU.  One recipe
    step (train_flagship.sh's options: xent 0.1, loss scaling, l2 5e-5, NG
    at the default ranks 20 / 80, so patch-lowered convs) at B = 128,
    T_in = 164, T_out = 50 on the card, every NG counter due; what its NG
    calls (update_ng_states: the batched eigensolves; then
    apply_natural_gradient) get and give is recorded, and the same calls
    run from the same states, inputs X, output derivatives G and grads: on
    the card in float64, on the CPU in float32 and in float64
    (tools/ng_precision.py).  At tests/test_torch_natural_gradient.py's
    bars (t exactly, d and rho rtol 1e-4, d atol 1e-4 max d, Vᵀdiag(d)V
    within 1e-4 of its largest entry, the preconditioned grads rtol 1e-4,
    atol 1e-6 ||dw||, dw the site's gradient with its bias row):

      * float64, every site: the card equals the CPU;
      * float32 (the training step's), every site whose two states keep
        fewer than half their dimensions (2R < D - 1): the card equals the
        CPU, and the CPU's float32 result lies within the bars of its
        float64 one.  Where 2R >= D - 1 the update is ill-conditioned in
        float32 on any device (natural_gradient.py): those sites are listed
        with both devices' distances from the float64 result."""
    rec = ng_precision.record_ng_step(dev, den, B, EGS_T_IN, EGS_T_OUT,
                                      left_context=LEFT)
    out = rec["out"]
    if not (bool(out.ok) and not bool(out.skipped)
            and np.isfinite(float(out.loss))):
        raise AssertionError(f"NG step on the card: ok={bool(out.ok)} "
                             f"skipped={bool(out.skipped)} loss={out.loss}")
    cpu = torch.device("cpu")
    runs = {"card32": (ng_precision.cast(rec["new"], cpu),
                       ng_precision.cast(rec["pre"], cpu)),
            "card64": ng_precision.ng_calls(rec, dev, torch.float64)}
    patch_bytes = max(x.numel() * x.element_size()
                      for x in rec["xs"].values())
    for key in ("states", "xs", "gs", "grads"):
        rec[key] = ng_precision.cast(rec[key], cpu)
    del rec["new"], rec["pre"], rec["out"], out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs["cpu32"] = ng_precision.ng_calls(rec, cpu, torch.float32)
    cpu_s = time.perf_counter() - t0
    runs["cpu64"] = ng_precision.ng_calls(rec, cpu, torch.float64)

    sites, grads = rec["sites"], rec["grads"]

    def dist(a, b):
        return ng_precision.ng_excess(runs[a], runs[b], sites, grads)

    fp64, fp32 = dist("card64", "cpu64"), dist("card32", "cpu32")
    cpu32_vs_64, card32_vs_64 = dist("cpu32", "cpu64"), dist("card32",
                                                             "cpu64")
    posed = ng_precision.well_posed(rec["states"])
    bad = [f"{nm} float64: {e:.3g} x its bar" for nm, e in fp64.items()
           if not e <= 1.0]
    bad += [f"{nm} float32: {fp32[nm]:.3g} x its bar" for nm in posed
            if not fp32[nm] <= 1.0]
    bad += [f"{nm} CPU float32 vs float64: {cpu32_vs_64[nm]:.3g} x its bar"
            for nm in posed if not cpu32_vs_64[nm] <= 1.0]
    if bad:
        raise AssertionError(f"NG at flagship width, card vs CPU: "
                             f"{len(bad)} outside the bars: {bad[:20]}")
    ill = {nm: {"cpu32_vs_cpu64": cpu32_vs_64[nm],
                "card32_vs_cpu64": card32_vs_64[nm],
                "card32_vs_cpu32": fp32[nm]}
           for nm in fp32 if nm not in posed}
    shapes = {(tuple(st.v.shape), side) for nm in rec["states"]
              for side, st in rec["states"][nm].items()}
    phase("ng_vs_cpu", B=B, T_in=EGS_T_IN, T_out=EGS_T_OUT,
          rank_in=rec["cfg_in"].rank, rank_out=rec["cfg_out"].rank,
          sites=len(sites), states=2 * len(sites), state_shapes=len(shapes),
          largest_input_bytes=patch_bytes,
          float64_max_excess=max(fp64.values()),
          float32_sites_held=len(posed),
          float32_max_excess=max((fp32[nm] for nm in posed), default=0.0),
          float32_max_excess_cpu32_vs_cpu64=max(
              (cpu32_vs_64[nm] for nm in posed), default=0.0),
          float32_max_excess_card32_vs_cpu64=max(
              (card32_vs_64[nm] for nm in posed), default=0.0),
          float32_ill_posed_sites=ill, cpu_ng_s=cpu_s)


def batches_equal(a, b):
    """Two loaders' ChainBatches hold the same keys, arrays and graphs."""
    graph = ("arc_src", "arc_dst", "arc_pdf", "arc_logw", "arc_mask", "start",
             "final_logw")
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys != y.keys or (x.frames_per_seq, x.left_context) != (
                y.frames_per_seq, y.left_context):
            return False
        for name in ("features", "ivectors", "weights", "deriv_weights"):
            if not np.array_equal(getattr(x, name), getattr(y, name)):
                return False
        if not all(np.array_equal(getattr(x.num_graph, n),
                                  getattr(y.num_graph, n)) for n in graph):
            return False
    return True


def egs_phase():
    """Synthetic cegs at flagship geometry written by the port's
    make_synthetic_egs, the den.fst read back from its file, and the files
    read through the DataLoader with the native parser and with the
    Python one: equal batches."""
    if WORK.exists():
        shutil.rmtree(WORK)
    egs_dir = WORK / "egs"
    t0 = time.perf_counter()
    make_synthetic_egs.main([
        str(egs_dir), "--files", str(EGS_FILES), "--per-file",
        str(EGS_PER_FILE), "--pdfs", str(P), "--frames-in", str(EGS_T_IN),
        "--frames-out", str(EGS_T_OUT), "--den-topology", "phone-lm",
        "--den-states", "7052"])
    write_s = time.perf_counter() - t0
    den_fst = read_fst_file(str(egs_dir / "den.fst"))
    graph = DenominatorGraph.from_fst(den_fst, P)
    layout = analyze_chain_structure(graph)
    if layout is None or graph.num_states != 7052 or layout.F != 3526:
        raise AssertionError("den.fst read back did not decompose to 7052 "
                             "states, F = 3526")
    cfg = DataLoaderConfig(batch_size=B, label_dim=P, max_fst_states=256,
                           max_fst_arcs=512)
    loaded, ms = {}, {}
    for name, use_native in (("native", True), ("python", False)):
        dl = DataLoader(str(egs_dir / "cegs.*.ark"), cfg,
                        use_native=use_native)
        t0 = time.perf_counter()
        loaded[name] = list(dl)
        ms[name] = (time.perf_counter() - t0) * 1e3 / max(len(loaded[name]), 1)
        if dl.readers != name:
            raise AssertionError(f"the {name} loader ran the {dl.readers!r} "
                                 f"parser")
    if not batches_equal(loaded["native"], loaded["python"]):
        raise AssertionError("native and Python parsers gave other batches")
    # spawned workers beside this process's CUDA context: one file each,
    # merged round-robin, so the same batches in another order
    t0 = time.perf_counter()
    procs = ProcessLoader(str(egs_dir / "cegs.*.ark"), cfg, workers=EGS_FILES)
    try:
        spawned = list(procs)
    finally:
        procs.close()
    ms["process"] = (time.perf_counter() - t0) * 1e3 / max(len(spawned), 1)
    by_keys = sorted(spawned, key=lambda b: b.keys)
    if not batches_equal(by_keys, sorted(loaded["native"],
                                         key=lambda b: b.keys)):
        raise AssertionError("ProcessLoader gave other batches")
    first = loaded["native"][0]
    n_batches = EGS_FILES * EGS_PER_FILE // B
    span = first.left_context + (EGS_T_OUT - 1) * STRIDE + 1
    if (len(loaded["native"]) != n_batches
            or first.features.shape != (B, EGS_T_IN, 40)
            or first.ivectors.shape != (B, 100)
            or first.frames_per_seq != EGS_T_OUT or span > EGS_T_IN):
        raise AssertionError(f"egs geometry: {len(loaded['native'])} batches "
                             f"of {first.features.shape}, fps "
                             f"{first.frames_per_seq}, span {span}")
    phase("egs", files=EGS_FILES, examples=EGS_FILES * EGS_PER_FILE,
          T_in=EGS_T_IN, T_out=EGS_T_OUT, pdfs=P, ivector_dim=100,
          left_context=first.left_context, den_states=graph.num_states,
          den_arcs=graph.num_transitions, chains=layout.F,
          batches=len(loaded["native"]), write_s=write_s,
          readers=["native", "python"], batches_equal=True,
          ms_per_batch_native=ms["native"], ms_per_batch_python=ms["python"],
          process_loader_workers=EGS_FILES,
          process_loader_ms_per_batch_incl_start=ms["process"])
    return egs_dir, graph


def flagship_recipe_flags(egs_dir):
    """configs/train_flagship.sh's flags to tools/train.py, as written
    there, with the egs, den.fst and xconfig paths filled in."""
    import shlex
    text = (ROOT / "configs" / "train_flagship.sh").read_text()
    body = text.split('tools/train.py" \\', 1)[1].split('"$@"', 1)[0]
    flags = shlex.split(" ".join(line.strip().rstrip("\\")
                                 for line in body.splitlines()))
    fill = {"$EGS": str(egs_dir / "cegs.*.ark"),
            "$DEN": str(egs_dir / "den.fst")}
    return [fill.get(f, str(ROOT / "configs" / "cnn_tdnn.xconfig")
                     if f.endswith("/cnn_tdnn.xconfig") else f)
            for f in flags]


def recipe_run(egs_dir, ckpt_dir, counters, natural_gradient=True,
               resume=False, ckpt_every=CKPT_STEP, den_inputs=None,
               extra=()):
    """One tools.train main run of the recipe, 1 epoch of 8 batches at
    B = 128, a checkpoint every `ckpt_every` steps.  Every kernel count is
    set to 0 just before the run; returns (summary, per-step launch
    counts).  den_inputs: a list that gets a CPU copy of the den's input
    in the first step (a warm-up step, not timed); extra: more flags."""
    flags = flagship_recipe_flags(egs_dir)
    override = {"--epochs": "1", "--ckpt-dir": str(ckpt_dir),
                "--ckpt-every": str(ckpt_every)}
    for i, f in enumerate(flags[:-1]):
        if f in override:
            flags[i + 1] = override[f]
    if not natural_gradient:
        flags.remove("--natural-gradient")
    if resume:
        flags.append("--resume")
    flags += list(extra)
    per_step = []
    run_step = Trainer.train_batch

    def counted(self, *args, **kwargs):
        before = {k: c.launches for k, c in counters.items()}
        out = run_step(self, *args, **kwargs)
        per_step.append({k: c.launches - before[k]
                         for k, c in counters.items()})
        return out

    run_den = DenominatorComputation.forward_backward

    def keep_input(self, x, *args, **kwargs):
        if den_inputs is not None and not den_inputs:
            den_inputs.append(x.detach().cpu())
        return run_den(self, x, *args, **kwargs)

    Trainer.train_batch = counted
    DenominatorComputation.forward_backward = keep_input
    try:
        for counter in counters.values():
            counter.launches = 0
        res = train_tool.main(flags + ["--log-every", "100"])
        torch.cuda.synchronize()
    finally:
        Trainer.train_batch = run_step
        DenominatorComputation.forward_backward = run_den
    totals = {k: c.launches for k, c in counters.items()}
    if {k: sum(s[k] for s in per_step) for k in counters} != totals:
        raise AssertionError("kernel launches outside the train steps")
    return res, per_step


def tensor_leaves(tree):
    """The tensors of nested dicts, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def check_steps(res, per_step, first, last, tag):
    expect = {"den_scan_fwd": 1, "den_scan_bwd": 1, "den_matmul": 0}
    steps = res["steps"]
    if [s["step"] for s in steps] != list(range(first, last + 1)):
        raise AssertionError(f"{tag}: ran steps {[s['step'] for s in steps]}")
    for s, launches in zip(steps, per_step):
        if not (np.isfinite(s["loss"]) and s["ok"] and not s["skipped"]):
            raise AssertionError(f"{tag} step {s['step']}: {s}")
        if launches != expect:
            raise AssertionError(f"{tag} step {s['step']} launched "
                                 f"{launches}, expected {expect}")


def trainer_den_check(den_t, graph, x_cpu, dev):
    """The Trainer's den on the input of its first step ([B, 50, P], the
    network's output on the first egs batch): against the loop den at the
    den phases' bars, and its fused scans, on the same emissions, against
    their plain versions at the HIST bars."""
    x = x_cpu.to(dev)
    lp, post = den_t.forward_backward(x)
    if den_t._structured.scan_used != "fused":
        raise AssertionError(f"the Trainer's den ran the "
                             f"{den_t._structured.scan_used} scans")
    den_l = DenominatorComputation(graph, leaky=den_t.leaky, scan_impl="loop",
                                   device=dev)
    lp_l, post_l = den_l.forward_backward(x)
    torch.cuda.synchronize()
    if not (torch.isfinite(lp).all() and torch.isfinite(post).all()):
        raise AssertionError("the Trainer's den output is not finite")
    torch.testing.assert_close(lp, lp_l, rtol=LOGP_RTOL, atol=0)
    torch.testing.assert_close(post, post_l, rtol=POST_RTOL, atol=POST_ATOL)
    x_tpn = torch.exp(torch.clamp(x.float(), -30.0, 30.0)) \
        .permute(1, 2, 0).contiguous()
    err, rel, _ = check_scans(den_t._structured, x_tpn, "trainer")
    return {"input_shape": list(x.shape),
            "logp_max_rel_vs_loop": float(((lp - lp_l).abs()
                                           / lp_l.abs()).max()),
            "post_max_abs_vs_loop": float((post - post_l).abs().max()),
            "scan_max_abs_err": err, "scan_max_err_rel_to_max": rel}


def trainer_phase(egs_dir, graph, dev):
    """tools.train's main with configs/train_flagship.sh's flags: 8 steps
    with a checkpoint at step 4 (the den of its first step held against
    the loop den and the plain scans), the run resumed from that
    checkpoint (equal to the uninterrupted one bit for bit), and the same
    8 steps without NG-SGD."""
    counters = {"den_scan_fwd": den_scan.fused_forward,
                "den_scan_bwd": den_scan.fused_backward,
                "den_matmul": DenMatmul}
    torch.cuda.reset_peak_memory_stats()
    den_inputs = []
    full, full_steps = recipe_run(egs_dir, WORK / "ckpt_full", counters,
                                  den_inputs=den_inputs)
    peak = torch.cuda.max_memory_allocated()
    check_steps(full, full_steps, 1, TRAIN_STEPS, "full run")
    den_check = trainer_den_check(full["trainer"].den, graph, den_inputs[0],
                                  dev)
    del den_inputs
    launches = {k: sum(s[k] for s in full_steps) for k in counters}
    sd_full = {k: v.detach().cpu().clone()
               for k, v in full["trainer"].net.state_dict().items()}
    losses = [s["loss"] for s in full["steps"]]
    timer = full["timer"]
    readers = full["readers"]
    del full
    torch.cuda.empty_cache()

    killed = WORK / "ckpt_killed"
    killed.mkdir()
    shutil.copy(WORK / "ckpt_full" / f"ckpt_{CKPT_STEP}.pt", killed)
    resumed, resumed_steps = recipe_run(egs_dir, killed, counters,
                                        resume=True)
    check_steps(resumed, resumed_steps, CKPT_STEP + 1, TRAIN_STEPS,
                "resumed run")
    sd_res = resumed["trainer"].net.state_dict()
    if not all(torch.equal(sd_full[k], sd_res[k].cpu()) for k in sd_full):
        raise AssertionError("the resumed run's parameters differ from the "
                             "uninterrupted run's")
    if [s["loss"] for s in resumed["steps"]] != losses[CKPT_STEP:]:
        raise AssertionError("the resumed run's losses differ")
    saved = [CheckpointManager(str(d)).load(TRAIN_STEPS)
             for d in (WORK / "ckpt_full", killed)]
    opt_a, opt_b = (tensor_leaves({"opt": c["opt_state"],
                                   "scale": c["scale_state"]})
                    for c in saved)
    if len(opt_a) != len(opt_b) or not all(torch.equal(x, y)
                                           for x, y in zip(opt_a, opt_b)):
        raise AssertionError("the resumed run's optimizer state differs")
    del resumed, sd_res, saved, opt_a, opt_b
    torch.cuda.empty_cache()

    # no checkpoint inside this run's loop: its loop time is the steps'
    plain, plain_steps = recipe_run(egs_dir, WORK / "ckpt_no_ng", counters,
                                    natural_gradient=False,
                                    ckpt_every=10 * TRAIN_STEPS)
    check_steps(plain, plain_steps, 1, TRAIN_STEPS, "run without NG")
    plain_timer = plain["timer"]
    del plain
    torch.cuda.empty_cache()

    device_ms = timer["device_mean_ms"]
    loop_ms = timer["device_loop_mean_ms"]
    # timed steps 3..8: the NG update (counter % 4 == 0) falls on step 5
    each = timer["device_each_ms"]
    update_ms = each[NG_UPDATE_STEP - 3]
    other_ms = float(np.mean([m for i, m in enumerate(each)
                              if i != NG_UPDATE_STEP - 3]))
    plain_ms = plain_timer["device_mean_ms"]
    phase("trainer", B=B, T_in=EGS_T_IN, T_out=EGS_T_OUT, pdfs=P,
          steps=TRAIN_STEPS, timed_steps=timer["steps"],
          resumed_from=CKPT_STEP, resume_bit_identical=True,
          readers=readers, losses=losses,
          launches=launches, launches_per_step=full_steps[0],
          resumed_launches={k: sum(s[k] for s in resumed_steps)
                            for k in counters},
          den_check=den_check,
          step_device_ms=device_ms, step_host_ms=timer["mean_ms"],
          step_device_ms_each=each,
          loop_ms_per_step=loop_ms, loop_host_ms_per_step=timer["loop_mean_ms"],
          device_gaps_ms=timer["device_gaps_ms"],
          idle_share=timer["idle_share"],
          ng_update_step_device_ms=update_ms,
          ng_other_steps_device_ms=other_ms,
          no_ng_step_device_ms=plain_ms,
          no_ng_step_device_ms_each=plain_timer["device_each_ms"],
          no_ng_loop_ms_per_step=plain_timer["device_loop_mean_ms"],
          no_ng_device_gaps_ms=plain_timer["device_gaps_ms"],
          no_ng_idle_share=plain_timer["idle_share"],
          ng_cost_ms_per_step=device_ms - plain_ms,
          ng_cost_update_step_ms=update_ms - plain_ms,
          ng_cost_other_steps_ms=other_ms - plain_ms,
          train_audio_sec_per_s_per_chip=B * EGS_T_IN / 100.0
          / (loop_ms / 1e3),
          train_audio_sec_per_s_per_chip_device=B * EGS_T_IN / 100.0
          / (device_ms / 1e3),
          max_memory_allocated_bytes=peak)
    return launches, den_check, {"losses": losses, "device_each_ms": each,
                                 "digest": train_tool.state_digest(sd_full)}


def bn_slots(model):
    """The number of BatchNorms in a model's forward."""
    probe = Network(model, torch.Generator().manual_seed(0), "cpu")
    return sum(1 if "count" in st else len(st)
               for st in probe.bn_state().values())


def world1_run(egs_dir, trainer_ref):
    """tools.train --data-parallel 1 (one rank over NCCL, every collective
    run) with the recipe's flags: its 8 steps' losses and its final state
    equal to the trainer phase's bit for bit (at world 1 the data group's
    BatchNorm merge and reported means are torch.mean's and torch.var's
    bits), the data group's collectives per step, and its device ms per
    step beside the trainer phase's."""
    counters = {"den_scan_fwd": den_scan.fused_forward,
                "den_scan_bwd": den_scan.fused_backward,
                "den_matmul": DenMatmul}
    res, per_step = recipe_run(egs_dir, WORK / "ckpt_dp1", counters,
                               ckpt_every=10 * TRAIN_STEPS,
                               extra=["--data-parallel", "1"])
    check_steps(res, per_step, 1, TRAIN_STEPS, "world 1")
    losses = [s["loss"] for s in res["steps"]]
    if losses != trainer_ref["losses"] or \
            res["param_digest"] != trainer_ref["digest"]:
        raise AssertionError(f"world 1 differs from the trainer phase: "
                             f"losses {losses} vs {trainer_ref['losses']}")
    calls = [s["collectives"] for s in res["steps"]]
    mb = [s["collective_bytes"] / 1e6 for s in res["steps"]]
    n_bn = bn_slots(build_model(str(ROOT / "configs" / "cnn_tdnn.xconfig")))
    # 2 all-reduces per BatchNorm forward, 2 backward, 1 gradient bucket;
    # the NG update steps (1 and 5) add 2 per state shape
    plain_calls = 4 * n_bn + 1
    if [c for i, c in enumerate(calls) if i + 1 not in (1, NG_UPDATE_STEP)] \
            != [plain_calls] * (TRAIN_STEPS - 2) or \
            min(calls[0], calls[NG_UPDATE_STEP - 1]) <= plain_calls:
        raise AssertionError(f"collectives per step {calls}, expected "
                             f"{plain_calls} ({n_bn} BatchNorms) and more "
                             f"on the NG update steps")
    each, ref_each = res["timer"]["device_each_ms"], \
        trainer_ref["device_each_ms"]
    launches = {k: sum(s[k] for s in per_step) for k in counters}
    del res
    torch.cuda.empty_cache()
    return launches, {
        "losses_bit_identical": True, "state_bit_identical": True,
        "losses": losses, "collectives_per_step": calls,
        "collective_mb_per_step": mb, "batchnorms": n_bn,
        "step_device_ms_each": each, "trainer_step_device_ms_each": ref_each,
        # timed steps 3-8; the NG update (step 5) apart
        "step_device_ms": float(np.mean(each)),
        "trainer_step_device_ms": float(np.mean(ref_each)),
        "launches": launches}


@contextlib.contextmanager
def masks_permuted(perm):
    """SpecAugment masks drawn for the global batch as before, their rows
    permuted by `perm` (each sequence keeps its masks when the batch's
    rows are permuted)."""
    draw = network_module.spec_augment_masks
    index = torch.from_numpy(perm)

    def permuted(*args, **kwargs):
        return tuple(None if m is None else m[index.to(m.device)]
                     for m in draw(*args, **kwargs))

    network_module.spec_augment_masks = permuted
    try:
        yield
    finally:
        network_module.spec_augment_masks = draw


@contextlib.contextmanager
def per_rank_bn():
    """The fault the two-rank comparison must catch: each rank's BatchNorm
    takes the statistics of its own rows (the per-shard statistics that
    "would silently switch" the result, kaldi_fp16_tpu/parallel/
    data_parallel.py:10-13)."""
    merged = network_module.batch_moments

    def local(x, group, total=None):
        return (x.mean(dim=(0, 1)),
                torch.clamp(x.var(dim=(0, 1), unbiased=False), min=0.0),
                float(x.shape[0] * x.shape[1]))

    network_module.batch_moments = local
    try:
        yield
    finally:
        network_module.batch_moments = merged


@contextlib.contextmanager
def averaged_grads():
    """The other fault: the ranks' gradients averaged instead of summed
    (the habit of data-parallel wrappers; the chain objective is a sum
    over sequences, so the full batch's gradient is the ranks' sum)."""
    summed = train_step_module.all_reduce_grads

    def averaged(grads, stats, group):
        grads, tot, nonfinite = summed(grads, stats, group)
        return ({l: {k: g / group.world for k, g in p.items()}
                 for l, p in grads.items()}, tot, nonfinite)

    train_step_module.all_reduce_grads = averaged
    try:
        yield
    finally:
        train_step_module.all_reduce_grads = summed


def is_param(k):
    return not k.endswith((".count", ".mean", ".var"))


def state_distance(states, ref):
    """(update, BN statistics) relative distances of a run's states from a
    reference run's, after step 1 and after the last step: ||u - u_ref|| /
    ||u_ref|| over the parameters' updates from the shared start, and the
    larger of the running means' and variances' ||s - s_ref|| / ||s_ref||."""
    update, bn = [], []
    for state, ref_state in zip(states, ref["states"]):
        params = [k for k in ref_state if is_param(k)]
        update.append(rel_norm(
            {k: state[k] - ref["init"][k] for k in params},
            {k: ref_state[k] - ref["init"][k] for k in params}, params))
        bn.append(max(rel_norm(state, ref_state, [
            k for k in ref_state if k.endswith("." + suf)])
            for suf in ("mean", "var")))
    return update, bn


def leaf_distances(state, ref):
    """Per-parameter update distances after step 1, ||u - u_ref|| /
    ||u_ref||: the chain head's leaves back to prefinal-chain's BatchNorm,
    and the DP_TOP_LEAVES leaves that carry most of the whole distance
    (with their share of its square)."""
    init, ref_state = ref["init"], ref["states"][0]
    sq = {k: float(((state[k].astype(np.float64) - ref_state[k]) ** 2).sum())
          for k in ref_state if is_param(k)}
    total = sum(sq.values())
    top = sorted(sq, key=sq.get, reverse=True)[:DP_TOP_LEAVES]
    return {"chain_head": {k: rel_norm({k: state[k] - init[k]},
                                       {k: ref_state[k] - init[k]}, [k])
                           for k in DP_HEAD_LEAVES},
            "top": [[k, sq[k] / total,
                     rel_norm({k: state[k] - init[k]},
                              {k: ref_state[k] - init[k]}, [k])]
                    for k in top]}


def permute_rows(g, perm):
    """A NumeratorGraphBatch with its sequences in the order `perm`."""
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name)[perm] for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), np.ndarray)})


def dp_bench_steps(group, dev, graph, natural_gradient, instrument=False,
                   dtype="bfloat16", steps=DP_STEPS, perm=None, b=DP_B):
    """bench.py's step (train_phase's batch, seeds and SpecAugment
    generator) at global B = b for `steps` steps in `dtype`, NG-SGD and
    loss scaling on or off: in this process (group None) or as this rank
    of `group` (a DataGroup, or a Mesh: its rows, frames and columns) on
    its share.  perm: this process's batch in another row order, each
    sequence with its numerator graph and SpecAugment masks (the same
    mathematics, summed in another order).  instrument: one more step
    with every collective synchronised before and after, for the
    collectives' share.  The states it returns are whole (gathered over
    a model axis)."""
    rng = np.random.default_rng(0)
    model = build_model(str(ROOT / "configs" / "cnn_tdnn.xconfig"))
    dims = {layer.name: layer.output_dim for layer in model.inputs()}
    num_graph = bench_num_graph(b, T_OUT, AN, P, rng)
    batch = {"features": rng.normal(size=(b, T_IN, dims["input"]))
             .astype(np.float32),
             "ivectors": rng.normal(size=(b, dims["ivector"]))
             .astype(np.float32),
             "weights": np.ones(b, np.float32)}
    if group is not None:
        batch, num_graph = shard_batch(batch, group), shard_graph(num_graph,
                                                                  group)
    order = contextlib.nullcontext()
    if perm is not None:
        batch = {k: v[perm] for k, v in batch.items()}
        num_graph, order = permute_rows(num_graph, perm), masks_permuted(perm)
    extra = (dict(natural_gradient=True, use_loss_scaling=True)
             if natural_gradient else {})
    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=STRIDE, left_context=LEFT,
                         compute_dtype=dtype, **extra)
    torch.cuda.reset_peak_memory_stats(dev)
    net, opt, scale = init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), config, device=dev)
    if group is not None:
        broadcast_train_state(net, opt, scale, group)
    init = {k: v.detach().cpu().numpy().copy()
            for k, v in net.state_dict().items()}
    opt = shard_train_state(net, opt, group)
    den = DenominatorComputation(graph, leaky=1e-5, device=dev)
    step = make_train_step(model, net, den, num_graph, ChainTrainingOpts(),
                           config, num_frames_out=T_OUT, group=group)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    spec_gen = torch.Generator(device=dev).manual_seed(1)
    counters = {"den_scan_fwd": den_scan.fused_forward,
                "den_scan_bwd": den_scan.fused_backward,
                "den_matmul": DenMatmul}
    for c in counters.values():
        c.launches = 0
    losses, step_ms, launches, calls, mb = [], [], [], [], []
    axes, event_ms = [], []
    counts = group.counts if isinstance(group, Mesh) else dict
    with train_tool.deterministic_cudnn(), order:
        for i in range(steps):
            before = {k: c.launches for k, c in counters.items()}
            c0 = (group.calls, group.bytes) if group is not None else (0, 0)
            a0 = counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ev[0].record()
            opt, scale, out = step(opt, scale, batch, generator=spec_gen)
            ev[1].record()
            loss = float(out.loss)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(ev[0].elapsed_time(ev[1]))
            axes.append({k: {"calls": v["calls"] - a0[k]["calls"],
                             "mb": (v["bytes"] - a0[k]["bytes"]) / 1e6}
                         for k, v in counts().items()})
            if not (np.isfinite(loss) and bool(out.ok)
                    and not bool(out.skipped)):
                raise AssertionError(f"data-parallel step {i}: loss={loss} "
                                     f"ok={bool(out.ok)} "
                                     f"skipped={bool(out.skipped)}")
            losses.append(loss)
            launches.append({k: c.launches - before[k]
                             for k, c in counters.items()})
            if group is not None:
                calls.append(group.calls - c0[0])
                mb.append((group.bytes - c0[1]) / 1e6)
            if i == 0:
                first = {k: v.detach().cpu().numpy().copy()
                         for k, v in full_state_dict(net, group).items()}
        whole = full_state_dict(net, group)
        res = {"losses": losses, "step_ms": step_ms,
               "event_step_ms": event_ms, "axis_counts_per_step": axes,
               "launches_per_step": launches, "collectives_per_step": calls,
               "collective_mb_per_step": mb,
               "scan_used": den._structured.scan_used,
               "digest": train_tool.state_digest(whole),
               "leaf_digests": {k: train_tool.state_digest({k: v})[:16]
                                for k, v in whole.items()},
               "states": [first, {k: v.detach().cpu().numpy().copy()
                                  for k, v in whole.items()}],
               "init": init}
        if instrument and group is not None:
            res.update(timed_collectives(group, step, opt, scale, batch,
                                         spec_gen, dev))
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


def timed_collectives(group, step, opt, scale, batch, spec_gen, dev):
    """One more step with the device synchronised around each of the
    group's collectives (a Mesh: each axis group's): the step's ms and
    the ms inside collectives, in all and per axis."""
    groups = group.groups() if isinstance(group, Mesh) else {"data": group}
    spent = {k: [] for k in groups}

    def timed(run, axis):
        def wrapper(t, *args, **kwargs):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = run(t, *args, **kwargs)
            torch.cuda.synchronize(dev)
            spent[axis].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    for axis, g in groups.items():
        g.all_reduce = timed(g.all_reduce, axis)
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(opt, scale, batch, generator=spec_gen)
        torch.cuda.synchronize(dev)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for g in groups.values():
            del g.all_reduce            # the class's method again
    ms = float(sum(sum(v) for v in spent.values()))
    return {"instrumented_step_ms": total, "collective_ms": ms,
            "collective_calls": sum(len(v) for v in spent.values()),
            "collective_share": ms / total,
            "axis_collective_ms": {k: float(sum(v))
                                   for k, v in spent.items()}}


def narrow_setups():
    """tests/test_parallel.py's cases on the card: its model (the
    worker's MP_XCONFIG), B = 8, T_in = 12, fp32, linear supervision; 2
    steps plainly and with NG-SGD (ranks 4), 1 with SpecAugment."""
    base = dataclasses.replace(
        dryrun_multichip.dryrun_setup(MeshConfig(data=4)),
        xconfig=mpworker.MP_XCONFIG, config=dict(mpworker.TRAIN), steps=2,
        mesh=None)
    spec = mpworker.MP_XCONFIG.replace(
        "linear-component name=linear1 dim=32",
        "spec-augment-layer name=spec freq-max-proportion=0.5 "
        "time-zeroed-proportion=0.2 time-mask-max-frames=4\n"
        "linear-component name=linear1 dim=32")
    return {"plain": base,
            "ng": dataclasses.replace(base, config=dict(
                base.config, natural_gradient=True, ng_rank_in=4,
                ng_rank_out=4)),
            "spec": dataclasses.replace(base, xconfig=spec, steps=1,
                                        spec_seed=7)}


def narrow_check(got, ref, tag):
    """tests/test_torch_parallel.py's bars: the losses, the parameters,
    the BN statistics and the NG states of a rank against one process."""
    for i, (o, r) in enumerate(zip(got["outputs"], ref["outputs"])):
        np.testing.assert_allclose(o["loss"], r["loss"], **NARROW_LOSS,
                                   err_msg=f"{tag} loss {i}")
    for k, v in ref["params"].items():
        bars = (NARROW_BN_MEAN if k == "layers.bn1.bn.mean" else
                NARROW_BN if not is_param(k) else NARROW_PARAMS)
        np.testing.assert_allclose(got["params"][k], v, **bars,
                                   err_msg=f"{tag} {k}")
    for site, st in (ref["ng"] or {}).items():
        for side in ("in", "out"):
            np.testing.assert_allclose(got["ng"][site][side]["v"],
                                       st[side]["v"], **NARROW_NG_V,
                                       err_msg=f"{tag} NG {site}/{side}")


def _dp_rank(group, graph, narrow):
    """A spawned rank of the two-rank phase: a gloo all-reduce of a CUDA
    tensor (the probe); bench.py's step in bf16 with NG and without, each
    run twice (the repeat), then with per-rank BN statistics (a fault);
    in fp32, plainly and with averaged gradients (a fault); the narrow
    fp32 cases, plainly and the first with averaged gradients.  Rank 0
    returns its states, the other rank its digests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = group.all_reduce(torch.full((4,), float(group.rank + 1),
                                        device=group.device))
    out = {"probe": probe.tolist(), "device": str(group.device)}

    def kept(res):
        del res["init"]
        if group.rank != 0:
            del res["states"]
        return res

    for ng in (True, False):
        first = dp_bench_steps(group, group.device, graph, ng,
                               instrument=True)
        repeat = dp_bench_steps(group, group.device, graph, ng)
        first["repeat_digest"] = repeat["digest"]
        first["repeat_losses"] = repeat["losses"]
        out["ng" if ng else "no_ng"] = kept(first)
        del repeat
        torch.cuda.empty_cache()
    with per_rank_bn():
        out["per_rank_bn"] = kept(dp_bench_steps(group, group.device, graph,
                                                 False))
    out["fp32"] = kept(dp_bench_steps(group, group.device, graph, False,
                                      dtype="float32", steps=DP32_STEPS))
    torch.cuda.empty_cache()
    with averaged_grads():
        out["fp32_averaged"] = kept(dp_bench_steps(
            group, group.device, graph, False, dtype="float32",
            steps=DP32_STEPS))
    torch.cuda.empty_cache()
    out["narrow"] = {k: run_setup(s, group) for k, s in narrow.items()}
    with averaged_grads():
        out["narrow_averaged"] = run_setup(narrow["plain"], group)
    return out


def within_dp_bars(tag, yardstick, update, bn):
    """The update and the BN statistics after step 1 within their bars
    (DP_BARS[tag]: multiples of the yardstick's distances, or floors),
    each of which must stay below a frozen model's 1."""
    (y_update, _), (y_bn, _) = yardstick
    (x_update, x_bn), (f_update, f_bn) = DP_BARS[tag]
    bars = max(x_update * y_update, f_update), max(x_bn * y_bn, f_bn)
    if max(bars) >= 1.0:
        raise AssertionError(f"{tag}: bars {bars} pass no update at all")
    return update[0] <= bars[0] and bn[0] <= bars[1]


def rel_norm(a, b, keys):
    """||a - b|| / ||b|| over the tensors `keys` of two state dicts."""
    num = sum(float(((a[k].astype(np.float64) - b[k]) ** 2).sum())
              for k in keys)
    den = sum(float((b[k].astype(np.float64) ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def loss_rel(losses, ref):
    return [abs(a - b) / abs(b) for a, b in zip(losses, ref)]


def two_rank_run(dev, graph):
    """bench.py's step at B = 256 in this process (bf16 with NG-SGD and
    loss scaling and without, fp32 without; each again with its rows
    permuted, the yardstick) and the narrow fp32 cases, freed after; then
    all of them on two ranks of one gloo group on this card, 128 rows
    each (4 in the narrow cases), held against one process."""
    perm = np.r_[DP_B // 2:DP_B, 0:DP_B // 2]
    single, yard = {}, {}
    for tag, ng, dtype, steps in DP_RUNS:
        single[tag] = dp_bench_steps(None, dev, graph, ng, dtype=dtype,
                                     steps=steps)
        other = dp_bench_steps(None, dev, graph, ng, dtype=dtype,
                               steps=steps, perm=perm)
        yard[tag] = {"losses": other["losses"],
                     "distance": state_distance(other["states"], single[tag]),
                     "leaves": leaf_distances(other["states"][0],
                                              single[tag])}
        del other
        torch.cuda.empty_cache()
    narrow = narrow_setups()
    narrow_ref = {k: run_setup(s, device=dev) for k, s in narrow.items()}
    ranks = spawn_ranks(_dp_rank, [dev, dev], args=(graph, narrow),
                        backend="gloo", join_seconds=DP_JOIN_S)
    if any(r["probe"] != [3.0] * 4 for r in ranks):
        raise AssertionError(f"gloo all-reduce of a CUDA tensor: "
                             f"{[r['probe'] for r in ranks]}")
    report, launches = {}, {"den_scan_fwd": 0, "den_scan_bwd": 0,
                            "den_matmul": 0}

    def passes(tag, update, bn):
        return within_dp_bars(tag, yard[tag]["distance"], update, bn)

    for tag, *_ in DP_RUNS:
        ref, got = single[tag], [r[tag] for r in ranks]
        for r in got:
            if r["digest"] != got[0]["digest"]:
                raise AssertionError(f"{tag}: the ranks' states differ")
            if "repeat_digest" in r and (
                    r["repeat_digest"] != r["digest"] or
                    r["repeat_losses"] != r["losses"]):
                raise AssertionError(f"{tag}: the repeat is not "
                                     f"bit-identical")
            if r["scan_used"] != "fused" or any(
                    x != {"den_scan_fwd": 1, "den_scan_bwd": 1,
                          "den_matmul": 0} for x in r["launches_per_step"]):
                raise AssertionError(f"{tag}: den route {r['scan_used']}, "
                                     f"launches {r['launches_per_step']}")
            for x in r["launches_per_step"]:
                for k in launches:
                    launches[k] += x[k]
        losses = got[0]["losses"]
        bars = DP_LOSS_RTOL[tag]
        for i, (a, b) in enumerate(zip(losses, ref["losses"])):
            np.testing.assert_allclose(a, b, rtol=bars[min(i, 1)],
                                       err_msg=f"{tag} loss {i + 1}")
        # after step 1, against the yardstick
        update, bn = state_distance(got[0]["states"], ref)
        y_update, y_bn = yard[tag]["distance"]
        if not passes(tag, update, bn):
            raise AssertionError(
                f"{tag}: after step 1 the update differs from one "
                f"process's by {update[0]}, the BN statistics by {bn[0]}; "
                f"one process with its rows permuted by {y_update[0]} and "
                f"{y_bn[0]}")
        report[tag] = {
            "losses_two_ranks": losses, "losses_one_process": ref["losses"],
            "loss_rel_diff": loss_rel(losses, ref["losses"]),
            "update_rel_diff_steps_1_last": update,
            "bn_rel_diff_steps_1_last": bn,
            "leaves_step_1": leaf_distances(got[0]["states"][0], ref),
            "yardstick_loss_rel_diff": loss_rel(yard[tag]["losses"],
                                                ref["losses"]),
            "yardstick_update_rel_diff_steps_1_last": y_update,
            "yardstick_bn_rel_diff_steps_1_last": y_bn,
            "yardstick_leaves_step_1": yard[tag]["leaves"],
            "step_ms_two_ranks": [r["step_ms"] for r in got],
            "step_ms_one_process": ref["step_ms"],
            "collectives_per_step": got[0]["collectives_per_step"],
            "collective_mb_per_step": got[0]["collective_mb_per_step"],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in got],
            "peak_bytes_one_process": ref["peak_bytes"],
            "ranks_bit_identical": True}
        if "collective_ms" in got[0]:
            report[tag].update(
                instrumented_step_ms=[r["instrumented_step_ms"] for r in got],
                collective_ms=[r["collective_ms"] for r in got],
                collective_share=[r["collective_share"] for r in got],
                repeat_bit_identical=True)
    # the negative controls: each must fail the checks its run passed
    for fault, tag in (("per_rank_bn", "no_ng"), ("fp32_averaged", "fp32")):
        f = [r[fault] for r in ranks]
        f_update, f_bn = state_distance(f[0]["states"], single[tag])
        lr = loss_rel(f[0]["losses"], single[tag]["losses"])
        bars = DP_LOSS_RTOL[tag]
        if all(x <= bars[min(i, 1)] for i, x in enumerate(lr)) and \
                passes(tag, f_update, f_bn):
            raise AssertionError(f"{fault} passes the two-rank checks: "
                                 f"losses {lr}, update {f_update}, BN "
                                 f"statistics {f_bn}")
        report[fault] = {"loss_rel_diff": lr,
                         "update_rel_diff_steps_1_last": f_update,
                         "bn_rel_diff_steps_1_last": f_bn,
                         "ranks_bit_identical":
                             f[0]["digest"] == f[1]["digest"]}
    # the narrow fp32 cases at the CPU tests' bars; averaged gradients fail
    for k, ref in narrow_ref.items():
        for r in ranks:
            narrow_check(r["narrow"][k], ref, f"narrow {k} rank")
    try:
        narrow_check(ranks[0]["narrow_averaged"], narrow_ref["plain"],
                     "averaged")
    except AssertionError as e:
        caught = str(e).splitlines()[1] if "\n" in str(e) else str(e)
    else:
        raise AssertionError("averaged gradients pass the narrow checks")
    report["narrow"] = {
        k: {"loss_rel_diff": loss_rel(
                [o["loss"] for o in ranks[0]["narrow"][k]["outputs"]],
                [o["loss"] for o in ref["outputs"]]),
            "params_max_abs_diff": max(float(np.abs(
                ranks[0]["narrow"][k]["params"][p] - v).max())
                for p, v in ref["params"].items()),
            "collectives_per_step": ranks[0]["narrow"][k]["calls_per_step"]}
        for k, ref in narrow_ref.items()}
    report["narrow_averaged_caught"] = caught
    return launches, report


def launch_workers(d, nproc, steps, extra=(), per_pid=None):
    """nproc mpworker processes on this card over gloo (their default
    device: card pid mod 1); [(returncode, stderr tail, result or None)].
    Every process is waited for, or killed at MP_TIMEOUT_S."""
    address = free_address()[len("tcp://"):]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs, outs = [], []
    for pid in range(nproc):
        outs.append(d / f"out_{nproc}p_{pid}.json")
        if outs[-1].exists():
            outs[-1].unlink()
        cmd = [sys.executable, "-m", "kaldi_fp16_tpu_torch.tools.mpworker",
               "--coordinator", address, "--nproc", str(nproc),
               "--pid", str(pid), "--egs", str(d / "cegs.*.ark"),
               "--out", str(outs[-1]), "--ckpt", str(d / "ckpt"),
               "--steps", str(steps), "--local-batch", str(MP_LOCAL_B),
               "--backend", "gloo", *extra, *(per_pid or {}).get(pid, [])]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    results = []
    try:
        for p, out in zip(procs, outs):
            _, err = p.communicate(timeout=MP_TIMEOUT_S)
            res = json.loads(out.read_text()) if out.exists() else None
            results.append((p.returncode, err.decode()[-2000:], res))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def worker_data(results, tag):
    for rc, err, res in results:
        if rc != 0 or res is None:
            raise AssertionError(f"{tag}: a worker failed (rc {rc}):\n{err}")
    return [res for _, _, res in results]


def one_process_mp(arks, nproc, steps, dev):
    """The worker's step without a data group, on this card, on the
    shards' rows concatenated in rank order: its losses."""
    parts = [mpworker.local_batch(shard_files(arks, r, nproc), MP_LOCAL_B)
             for r in range(nproc)]
    batch = {k: torch.cat([p[0][k] for p in parts]).to(dev)
             for k in parts[0][0]}
    g0 = parts[0][1]
    graph = dataclasses.replace(g0, **{
        f.name: np.concatenate([getattr(p[1], f.name) for p in parts])
        for f in dataclasses.fields(g0)
        if isinstance(getattr(g0, f.name), np.ndarray)})
    model = build_model_from_string(mpworker.MP_XCONFIG)
    config = TrainConfig(**mpworker.TRAIN)
    net, opt, scale = init_train_state(
        model, torch.Generator().manual_seed(0), config, dev)
    den = DenominatorComputation(DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=mpworker.NUM_PDFS, num_states=5,
                            seed=9), mpworker.NUM_PDFS), leaky=1e-4,
        device=dev)
    step = make_train_step(model, net, den, graph, ChainTrainingOpts(),
                           config, num_frames_out=mpworker.T_OUT)
    losses = []
    for _ in range(steps):
        opt, scale, out = step(opt, scale, batch)
        losses.append(float(out.loss))
    return losses


def multiprocess_run(dev):
    """The multi-process entry points on the card: tools.mpworker as 2
    processes over gloo on this card (file shards, sharded steps, a
    checkpoint saved and restored) against one process on the shards'
    rows, then 4 processes restoring that checkpoint (2 -> 4) and a
    SIGKILLed worker whose peer must fail, not hang; then
    tools.dryrun_multichip (the grid cut conv) as 2 ranks on the card."""
    d = WORK / "mp"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    arks = mpworker.write_arks(d, MP_FILES, MP_LOCAL_B)
    t0 = time.perf_counter()
    two = worker_data(launch_workers(d, 2, MP_STEPS), "2 workers")
    t1 = time.perf_counter()
    ref = one_process_mp(arks, 2, MP_STEPS, dev)
    for w in two:
        if (w["device"], w["backend"], w["process_count"]) != \
                (str(dev), "gloo", 2) or not w["ckpt_ok"] or \
                w["losses"] != two[0]["losses"] or \
                w["param_digest"] != two[0]["param_digest"]:
            raise AssertionError(f"2 workers: {w}")
    np.testing.assert_allclose(two[0]["losses"], ref, rtol=NARROW_LOSS["rtol"],
                               err_msg="2 workers vs one process")
    t2 = time.perf_counter()
    four = worker_data(launch_workers(d, 4, 1, ["--restore-step",
                                                str(MP_STEPS)]), "4 workers")
    t3 = time.perf_counter()
    for w in four:
        if w["restored_digest"] != two[0]["param_digest"] or \
                w["restored_param_sums"] != two[0]["param_sums"] or \
                not w["ckpt_ok"] or not np.isfinite(w["losses"]).all():
            raise AssertionError(f"2 -> 4 resume: {w}")
    (rc0, err0, res0), (rc1, _, res1) = launch_workers(
        d, 2, 50, ["--heartbeat", str(MP_HEARTBEAT_S)],
        {1: ["--die-at-step", "1"]})
    t4 = time.perf_counter()
    if rc1 != -9 or rc0 == 0 or res0 is not None or res1 is not None:
        raise AssertionError(f"death: victim rc {rc1}, survivor rc {rc0}:"
                             f"\n{err0}")
    dry = dryrun_multichip.main(["--ranks", "2", "--backend", "gloo"])
    t5 = time.perf_counter()
    dry8 = dryrun_multichip.main(["--ranks", "8", "--backend", "gloo"])
    if dry8["mesh"] != {"data": 2, "seq": 2, "model": 2}:
        raise AssertionError(f"8-rank dryrun mesh {dry8['mesh']}")
    t6 = time.perf_counter()
    return {"two_workers_losses": two[0]["losses"],
            "one_process_losses": ref,
            "loss_rel_diff": loss_rel(two[0]["losses"], ref),
            "local_files": [w["local_files"] for w in two],
            "device": two[0]["device"], "backend": two[0]["backend"],
            "resume_2_to_4_bit_identical": True,
            "survivor_rc": rc0,
            "survivor_error": (err0.strip().splitlines() or [""])[-1],
            "dryrun": dry, "dryrun_8": dry8,
            "s": {"two": t1 - t0, "four": t3 - t2, "death": t4 - t3,
                  "dryrun": t5 - t4, "dryrun_8": t6 - t5}}


def data_parallel_phase(egs_dir, graph, trainer_ref, dev):
    """Data parallelism on the one card: tools.train --data-parallel 1
    over NCCL against the trainer phase, then two gloo ranks on the card
    against one process at bench.py's step, B = 256, and the
    multi-process tools (mpworker, dryrun_multichip at 2 and 8 ranks) on
    the card.  Returns the phase's launches and the 8-rank dryrun's
    result."""
    t0 = time.perf_counter()
    w1_launches, world1 = world1_run(egs_dir, trainer_ref)
    t1 = time.perf_counter()
    two_launches, two = two_rank_run(dev, graph)
    t2 = time.perf_counter()
    mp = multiprocess_run(dev)
    phase("data_parallel", world1=world1, world1_s=t1 - t0,
          two_ranks=two, two_ranks_s=t2 - t1, multiprocess=mp,
          multiprocess_s=time.perf_counter() - t2,
          two_ranks_B=DP_B, T_in=T_IN, steps=DP_STEPS,
          bars={"world1": "bit-identical", "loss_rtol": DP_LOSS_RTOL,
                "step_1_update_bn_x_yardstick_and_floors": DP_BARS,
                "narrow": {"loss": NARROW_LOSS, "params": NARROW_PARAMS,
                           "bn": NARROW_BN, "ng_v": NARROW_NG_V}},
          launches_two_ranks=two_launches)
    return ({k: w1_launches[k] + two_launches[k] for k in two_launches},
            mp["dryrun_8"])


def _msp_rank(group, graph, narrow):
    """A spawned rank of the model_seq_parallel phase: for each mesh of
    MSP_MESHES, bench.py's step at B = MSP_B in fp32 and in bf16 with
    NG-SGD (the latter with one instrumented step), then the narrow fp32
    cases.  Rank 0 returns its states, the other rank its digests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, cfg in MSP_MESHES.items():
        mesh = make_mesh(cfg, group.device)
        for tag, ng, dtype in MSP_RUNS:
            res = dp_bench_steps(mesh, group.device, graph, ng,
                                 instrument=tag == "ng", dtype=dtype,
                                 steps=MSP_STEPS, b=MSP_B)
            del res["init"]
            if group.rank != 0:
                del res["states"]
            out[f"{name}/{tag}"] = res
            torch.cuda.empty_cache()
        out[f"{name}/narrow"] = {
            k: run_setup(dataclasses.replace(s, mesh=cfg), group)
            for k, s in narrow.items()}
    return out


def model_seq_parallel_phase(dev, graph, dryrun_8):
    """Tensor and sequence parallelism on the one card: bench.py's step
    at B = MSP_B on two gloo ranks, split over the model axis and over
    the seq axis, against one process and its yardstick (rows permuted),
    the narrow cases at the CPU tests' bars; the data_parallel phase's
    8-rank dryrun (data 2 x seq 2 x model 2) reported beside them.
    Returns the ranks' kernel launches."""
    t0 = time.perf_counter()
    perm = np.r_[MSP_B // 2:MSP_B, 0:MSP_B // 2]
    single, yard = {}, {}
    for tag, ng, dtype in MSP_RUNS:
        single[tag] = dp_bench_steps(None, dev, graph, ng, dtype=dtype,
                                     steps=MSP_STEPS, b=MSP_B)
        other = dp_bench_steps(None, dev, graph, ng, dtype=dtype,
                               steps=MSP_STEPS, b=MSP_B, perm=perm)
        yard[tag] = {"losses": other["losses"],
                     "distance": state_distance(other["states"], single[tag])}
        del other
        torch.cuda.empty_cache()
    narrow = {k: v for k, v in narrow_setups().items() if k in ("plain",
                                                                "ng")}
    narrow_ref = {k: run_setup(s, device=dev) for k, s in narrow.items()}
    t1 = time.perf_counter()
    ranks = spawn_ranks(_msp_rank, [dev, dev], args=(graph, narrow),
                        backend="gloo", join_seconds=DP_JOIN_S)
    t2 = time.perf_counter()
    launches = {"den_scan_fwd": 0, "den_scan_bwd": 0, "den_matmul": 0,
                "segment_reduce": 0}
    report, failed = {}, []
    for name, cfg in MSP_MESHES.items():
        report[name] = {}
        for tag, *_ in MSP_RUNS:
            ref, got = single[tag], [r[f"{name}/{tag}"] for r in ranks]
            for r in got:
                if r["digest"] != got[0]["digest"]:
                    failed.append(f"{name} {tag}: the ranks' whole states "
                                  f"differ in " + ", ".join(
                                      k for k, d in r["leaf_digests"].items()
                                      if d != got[0]["leaf_digests"][k]))
                if r["scan_used"] != "fused" or any(
                        x != {"den_scan_fwd": 1, "den_scan_bwd": 1,
                              "den_matmul": 0}
                        for x in r["launches_per_step"]):
                    failed.append(
                        f"{name} {tag}: den route {r['scan_used']}, "
                        f"launches {r['launches_per_step']}")
                for x in r["launches_per_step"]:
                    for k in x:
                        launches[k] += x[k]
            losses = got[0]["losses"]
            rel = loss_rel(losses, ref["losses"])
            y_rel = loss_rel(yard[tag]["losses"], ref["losses"])
            bars = [DP_LOSS_RTOL[tag][0]] + [
                max(DP_LOSS_RTOL[tag][1], DP_BARS[tag][0][0] * y)
                for y in y_rel[1:]]
            if any(x > bar for x, bar in zip(rel, bars)):
                failed.append(f"{name} {tag}: losses {losses} against one "
                              f"process's {ref['losses']} (rel {rel}, bars "
                              f"{bars})")
            update, bn = state_distance(got[0]["states"], ref)
            if not within_dp_bars(tag, yard[tag]["distance"], update, bn):
                failed.append(
                    f"{name} {tag}: after step 1 the update differs from "
                    f"one process's by {update[0]}, the BN statistics by "
                    f"{bn[0]}; the yardstick by "
                    f"{yard[tag]['distance'][0][0]} and "
                    f"{yard[tag]['distance'][1][0]}")
            report[name][tag] = {
                "losses_two_ranks": losses,
                "losses_one_process": ref["losses"],
                "loss_rel_diff": rel,
                "yardstick_loss_rel_diff": y_rel, "loss_bars": bars,
                "update_rel_diff_steps_1_last": update,
                "bn_rel_diff_steps_1_last": bn,
                "yardstick_update_bn_rel_diff_step_1": [
                    yard[tag]["distance"][0][0], yard[tag]["distance"][1][0]],
                "leaves_step_1": leaf_distances(got[0]["states"][0], ref),
                "event_step_ms_per_rank": [r["event_step_ms"] for r in got],
                "event_step_ms_one_process": ref["event_step_ms"],
                "axis_collectives_per_step_per_rank": [
                    r["axis_counts_per_step"] for r in got],
                "peak_bytes_per_rank": [r["peak_bytes"] for r in got],
                "peak_bytes_one_process": ref["peak_bytes"],
                "ranks_bit_identical": True}
            if "collective_ms" in got[0]:
                report[name][tag].update(
                    instrumented_step_ms=[r["instrumented_step_ms"]
                                          for r in got],
                    collective_share=[r["collective_share"] for r in got],
                    axis_collective_ms=[r["axis_collective_ms"]
                                        for r in got])
        for k, ref in narrow_ref.items():
            for r in ranks:
                try:
                    narrow_check(r[f"{name}/narrow"][k], ref,
                                 f"{name} narrow {k}")
                except AssertionError as e:
                    failed.append(str(e))
        report[name]["narrow_loss_rel_diff"] = {
            k: loss_rel([o["loss"] for o in
                         ranks[0][f"{name}/narrow"][k]["outputs"]],
                        [o["loss"] for o in ref["outputs"]])
            for k, ref in narrow_ref.items()}
    for k in launches:
        launches[k] += dryrun_8["rank_launches"].get(k, 0)
    phase("model_seq_parallel", card=card(), B=MSP_B, T_in=T_IN,
          steps=MSP_STEPS, meshes={k: {"data": c.data, "seq": c.seq,
                                       "model": c.model}
                                   for k, c in MSP_MESHES.items()},
          runs=report, dryrun_8_ranks=dryrun_8,
          bars={"loss_rtol_first_later_floor": {t: DP_LOSS_RTOL[t]
                                                for t, *_ in MSP_RUNS},
                "step_1_update_bn_x_yardstick_and_floors":
                    {t: DP_BARS[t] for t, *_ in MSP_RUNS},
                "narrow": {"loss": NARROW_LOSS, "params": NARROW_PARAMS,
                           "bn": NARROW_BN, "ng_v": NARROW_NG_V}},
          launches=launches, one_process_s=t1 - t0, ranks_s=t2 - t1,
          phase_s=time.perf_counter() - t0, failed=failed)
    if failed:
        raise AssertionError("model_seq_parallel: " + "; ".join(failed))
    return launches


def lattices_equal(a, b):
    """Two Lattices with the same nodes, finals and arc arrays."""
    fields = ("src", "dst", "ilabel", "olabel", "graph_cost", "acoustic_cost")
    return (a.num_nodes == b.num_nodes
            and np.array_equal(a.node_frame, b.node_frame)
            and np.array_equal(a.final_cost, b.final_cost)
            and all(np.array_equal(getattr(a.arcs, f), getattr(b.arcs, f))
                    for f in fields))


def decode_split(name: str) -> str:
    """A decode kernel's share: "scatter" (scatter_reduce_'s amax / amin:
    torch's scatter-like scatter_gather kernel), "gather" (torch.take,
    gather, index), "reduce" (the axis max / min / argmax and sums:
    reduce_kernel) or "other" (elementwise, fills, copies)."""
    if "scatter_gather_internal_kernel<true" in name:
        return "scatter"
    if "take" in name or "gather" in name or "index" in name:
        return "gather"
    if "reduce_kernel" in name:
        return "reduce"
    return "other"


def decode_profile(fn, dev):
    """Device launches (kernels and copies), their summed device ms, the
    ms of each decode_split share and the three costliest kernels of one
    call of fn, under torch.profiler."""
    wall, rows = kernel_times(fn, dev)
    split = {"scatter": 0.0, "gather": 0.0, "reduce": 0.0, "other": 0.0}
    for name, _, us in rows:
        split[decode_split(name)] += us / 1e3
    return {"launches": sum(r[1] for r in rows),
            "device_busy_ms": sum(r[2] for r in rows) / 1e3,
            "profiled_wall_ms": wall, "split_ms": split,
            "top": [[name[:60], n, us / 1e3] for name, n, us in rows[:3]]}


def decode_hclg_phase(dev):
    """The device decoders at HCLG scale (see the module docstring)."""
    graph = decodebench.synth_hclg_graph(DEC_S, P)
    S, A = graph.num_states, len(graph.em_dst)
    gen = torch.Generator(device=dev).manual_seed(1)
    ll = torch.randn((DEC_B, DEC_T, P), generator=gen, device=dev)
    audio_s = DEC_B * DEC_T / 100.0

    # Viterbi: the default (checkpointed) path, the plain path, a repeat
    vit = SparseViterbiDecoder(graph, device=dev)
    if not DEC_T * S * DEC_B * 4 > vit.bp_hist_limit:
        raise AssertionError("the HCLG decode did not take the "
                             "checkpointed path")
    best_c, _, arcs_c = vit.arc_path(ll)
    plain = SparseViterbiDecoder(graph, device=dev)
    plain.bp_hist_limit = 1 << 40
    best_p, _, arcs_p = plain.arc_path(ll)
    best_r, _, arcs_r = vit.arc_path(ll)
    torch.cuda.synchronize()
    if not (torch.equal(arcs_c, arcs_p) and torch.equal(best_c, best_p)):
        raise AssertionError("Viterbi: checkpointed and plain paths differ")
    if not (torch.equal(arcs_c, arcs_r) and torch.equal(best_c, best_r)):
        raise AssertionError("Viterbi: repeats differ")
    del plain, arcs_p, arcs_r
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    vit_ms, card = decodebench.time_decode(vit, ll, DEC_ITERS)
    vit_peak = torch.cuda.max_memory_allocated()
    vit_extra = vit_peak - held
    if not all(r["final_reached"] for r in card):
        raise AssertionError("Viterbi: an utterance reached no final state")
    vit_prof = decode_profile(lambda: vit.decode_batch(ll), dev)

    # two utterances re-decoded by the port on the CPU
    t0 = time.perf_counter()
    host = SparseViterbiDecoder(graph, device="cpu").decode_batch(
        ll[:2].cpu())
    cpu_s = time.perf_counter() - t0
    worst_cost = 0.0
    for b, (r, h) in enumerate(zip(card, host)):
        if (r["words"], r["alignment"], r["final_reached"]) != (
                h["words"], h["alignment"], h["final_reached"]):
            raise AssertionError(f"Viterbi utterance {b}: card and CPU differ")
        np.testing.assert_allclose(r["total_cost"], h["total_cost"],
                                   rtol=DEC_COST_RTOL)
        worst_cost = max(worst_cost, abs(r["total_cost"] - h["total_cost"])
                         / abs(h["total_cost"]))

    # lattices: dense against compact transfer, checkpointed against plain
    lat = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, device=dev)
    masks_c, lbest_c = lat.masks(ll)
    lat_plain = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, device=dev)
    lat_plain.alpha_hist_limit = 1 << 40
    masks_p, lbest_p = lat_plain.masks(ll)
    torch.cuda.synchronize()
    if not (torch.equal(masks_c, masks_p) and torch.equal(lbest_c, lbest_p)):
        raise AssertionError("lattice: checkpointed and plain masks differ")
    del lat_plain, masks_p
    torch.cuda.empty_cache()
    dense = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM,
                                 transfer="dense", device=dev)
    lats_dense = dense.decode_batch(ll)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lat_ms, lats = decodebench.time_decode(lat, ll, DEC_ITERS)
    lat_peak = torch.cuda.max_memory_allocated()
    lat_extra = lat_peak - held
    if lat.last_transfer != "compact":
        raise AssertionError(f"the lattice decoder's auto transfer ran "
                             f"{lat.last_transfer!r}, expected 'compact'")
    if not all(lattices_equal(x, y) for x, y in zip(lats, lats_dense)):
        raise AssertionError("lattice: dense and compact transfer differ")
    best_words = [lt.best_path()[0] for lt in lats]
    lat_prof = decode_profile(lambda: lat.decode_batch(ll), dev)
    del lat, dense, lats_dense, masks_c
    torch.cuda.empty_cache()

    # the dense decoder against the arc decoder at decodebench's defaults
    g_d = DecodingGraph.from_fst(decodebench.synth_graph(DENSE_S, DENSE_P,
                                                         DENSE_E))
    ll_d = torch.randn((DENSE_B, DENSE_T, DENSE_P), generator=gen,
                       device=dev)
    dense_dec = DenseViterbiDecoder(g_d, device=dev)
    sparse_dec = SparseViterbiDecoder(g_d, device=dev)
    dense_ms, d_res = decodebench.time_decode(dense_dec, ll_d, 1)
    sparse_ms, s_res = decodebench.time_decode(sparse_dec, ll_d, 1)
    worst_dense = 0.0
    for b, (x, y) in enumerate(zip(d_res, s_res)):
        if (x["words"], x["alignment"], x["final_reached"]) != (
                y["words"], y["alignment"], y["final_reached"]):
            raise AssertionError(f"dense vs arc decoder, utterance {b}")
        np.testing.assert_allclose(x["total_cost"], y["total_cost"],
                                   rtol=DEC_COST_RTOL)
        worst_dense = max(worst_dense, abs(x["total_cost"] - y["total_cost"]))
    del dense_dec, sparse_dec, ll_d
    torch.cuda.empty_cache()
    dense_audio = DENSE_B * DENSE_T / 100.0
    phase("decode_hclg", states=S, arcs=A, pdfs=P, B=DEC_B, T=DEC_T,
          checkpointed_equals_plain=True, repeat_bit_identical=True,
          cpu_utterances=len(host), cpu_equal_words_alignment=True,
          cpu_cost_max_rel=worst_cost, cpu_decode_s=cpu_s,
          viterbi_decode_ms=vit_ms,
          viterbi_decode_audio_sec_per_s=audio_s / (vit_ms / 1e3),
          viterbi_profile=vit_prof, viterbi_peak_bytes=vit_peak,
          viterbi_peak_bytes_over_held=vit_extra,
          viterbi_mean_words=float(np.mean([len(r["words"]) for r in card])),
          lattice_beam=DEC_BEAM, lattice_dense_equals_compact=True,
          lattice_checkpointed_equals_plain=True,
          lattice_decode_ms=lat_ms,
          lattice_decode_audio_sec_per_s=audio_s / (lat_ms / 1e3),
          lattice_profile=lat_prof, lattice_peak_bytes=lat_peak,
          lattice_peak_bytes_over_held=lat_extra,
          mean_lattice_arcs=float(np.mean([len(x.arcs) for x in lats])),
          lattice_1best_equals_viterbi=sum(
              w == r["words"] for w, r in zip(best_words, card)),
          dense_states=DENSE_S, dense_pdfs=DENSE_P, dense_B=DENSE_B,
          dense_T=DENSE_T, dense_equals_sparse=True,
          dense_cost_max_abs_diff=worst_dense, dense_decode_ms=dense_ms,
          dense_decode_audio_sec_per_s=dense_audio / (dense_ms / 1e3),
          sparse_at_dense_shape_decode_ms=sparse_ms,
          sparse_at_dense_shape_decode_audio_sec_per_s=dense_audio
          / (sparse_ms / 1e3))
    return graph, ll, card


def arc_set(lat):
    """tests/test_tpu_viterbi.py's `_arc_set`: a lattice's arcs as (frame,
    ilabel, olabel, graph cost, acoustic cost) with costs to 1e-4."""
    frames = lat.node_frame
    a = lat.arcs
    return {(int(frames[s]), int(i), int(o), round(float(g), 4),
             round(float(c), 4))
            for s, i, o, g, c in zip(a.src, a.ilabel, a.olabel,
                                     a.graph_cost, a.acoustic_cost)}


def tie_graphs():
    """tests/test_tpu_viterbi.py:687 and :701: two arcs 0 -> 1 of equal
    score (olabels 7 and 8), and nine equal-score arcs into one sink from
    different sources (split over level-1 rows at width 2)."""
    s = [FstState() for _ in range(3)]
    s[0].arcs.append(FstArc(1, 0.5, 1, olabel=7))
    s[0].arcs.append(FstArc(1, 0.5, 1, olabel=8))
    s[1].arcs.append(FstArc(2, 0.0, 2, olabel=0))
    s[2].final = 0.0
    c = [FstState() for _ in range(11)]
    for i in range(1, 10):
        c[0].arcs.append(FstArc(1, 0.5, i, olabel=i))
        c[i].arcs.append(FstArc(2, 0.5, 10, olabel=100 + i))
    c[10].final = 0.0
    return [DecodingGraph.from_fst(Fst(start=0, states=x)) for x in (s, c)]


def kept_arcs(packed, b, A, slot_arc=None):
    """The arc instances utterance b keeps in a packed [T, nbytes, B] mask
    (bits in arc order, or in slot order mapped by slot_arc), as sorted
    t * A + arc; only the nonzero bytes are unpacked."""
    pb = packed[:, :, b]
    t8, byts = np.nonzero(pb)
    bits = np.unpackbits(pb[t8, byts]) > 0               # MSB first
    slots = (byts[:, None] * 8 + np.arange(8)[None, :]).ravel()[bits]
    t = np.repeat(t8, 8)[bits].astype(np.int64)
    arcs = slots if slot_arc is None else slot_arc[slots]
    live = arcs < A
    return np.sort(t[live] * A + arcs[live])


def edge_margins(a, ac, beam, t_idx, a_idx):
    """Lattice.prune's keep criterion in float64 for one utterance:
    alpha[t, src] + cost + beta[t + 1, dst] - (best + beam) of the arc
    instances (t_idx, a_idx); ac [T, P] acoustic costs."""
    S, T = a.num_states, ac.shape[0]
    g = -a.weight.astype(np.float64)
    fc = np.where(a.final > NEG_INF / 2, -a.final.astype(np.float64),
                  np.inf)
    has_in = np.bincount(a.dst, minlength=S) > 0
    in_starts = np.searchsorted(a.dst, np.arange(S))[has_in]
    order = np.argsort(a.src, kind="stable")
    has_out = np.bincount(a.src, minlength=S) > 0
    out_starts = np.searchsorted(a.src[order], np.arange(S))[has_out]
    alphas = np.full((T + 1, S), np.inf)
    alphas[0, a.start] = 0.0
    for t in range(T):
        cand = alphas[t, a.src] + g + ac[t, a.pdf]
        alphas[t + 1, has_in] = np.minimum.reduceat(cand, in_starts)
    thr = np.min(alphas[T] + fc) + beam
    beta, margins = fc, np.empty(len(t_idx))
    for t in range(T - 1, -1, -1):
        cand = g + ac[t, a.pdf] + beta[a.dst]
        sel = t_idx == t
        arcs = a_idx[sel]
        margins[sel] = alphas[t, a.src[arcs]] + cand[arcs] - thr
        beta = np.full(S, np.inf)
        beta[has_out] = np.minimum.reduceat(cand[order], out_starts)
    return margins, thr


def layout_vs_segment(layout, graph, ll, lats, seg_lats, masks, seg_masks,
                      steps):
    """A layout's lattices against the segment layout's on the same
    loglikes.  The 1-best must be equal.  The layout's own arithmetic
    must repeat on the CPU bit for bit (LAT_CPU_B utterances).  The arc
    sets may differ only at the beam's edge: the layouts add alpha, cost
    and beta in other orders (so does the JAX package), so an arc whose
    total lies within float32 rounding of best + beam may flip.  For the
    utterance with the most differing arc instances, each one's keep
    margin is recomputed in float64 and must lie within the worst-case
    rounding of the float32 alpha and beta sums, 2 T ulps of |thr|
    (four additions a frame, half an ulp each)."""
    if [x.best_path()[0] for x in lats] != [
            x.best_path()[0] for x in seg_lats]:
        raise AssertionError(f"{layout} lattice: 1-best differs from the "
                             f"segment lattice")
    n_cpu = min(LAT_CPU_B, ll.shape[0])
    t0 = time.perf_counter()
    cpu = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, layout=layout,
                               tree_max_width=TREE_W, device="cpu")
    if not all(lattices_equal(x, y) for x, y in zip(
            cpu.decode_batch(ll[:n_cpu].cpu()), lats[:n_cpu])):
        raise AssertionError(f"{layout} lattice: the card and the CPU "
                             f"differ")
    cpu_s = time.perf_counter() - t0
    a = ArcGraph.from_graph(graph)
    masks = masks.cpu().numpy()
    slot_arc = getattr(steps, "slot_arc", None)
    A = len(a.src)
    differ = [np.setxor1d(kept_arcs(masks, b, A, slot_arc),
                          kept_arcs(seg_masks, b, A), assume_unique=True)
              for b in range(ll.shape[0])]
    out = {"one_best_equal": True, "cpu_utterances": n_cpu,
           "cpu_equal": True, "cpu_s": cpu_s,
           "kept_arcs": [int(len(x.arcs)) for x in lats],
           "differing_arc_instances": [len(d) for d in differ]}
    w = int(np.argmax(out["differing_arc_instances"]))
    if len(differ[w]):
        t_idx, a_idx = np.divmod(differ[w], A)
        t0 = time.perf_counter()
        margins, thr = edge_margins(
            a, -ll[w].double().cpu().numpy(), DEC_BEAM, t_idx, a_idx)
        bound = 2 * ll.shape[1] * float(np.spacing(np.float32(abs(thr))))
        worst = float(np.abs(margins).max())
        if not worst <= bound:
            raise AssertionError(
                f"{layout} lattice, utterance {w}: an arc {worst} from the "
                f"keep threshold in float64 differs from the segment "
                f"lattice (float32 rounding reaches {bound})")
        out["edge"] = {"utterance": w, "float64_margin_max_abs": worst,
                       "rounding_bound": bound, "threshold": thr,
                       "s": time.perf_counter() - t0}
    return out


def layout_numbers(dec, ll, dev):
    """(decode_batch's results, {ms per decode, decode_audio_sec_per_s,
    peak bytes over held, the decode's profile}) of one decoder."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms, res = decodebench.time_decode(dec, ll, DEC_ITERS)
    extra = torch.cuda.max_memory_allocated() - held
    audio_s = ll.shape[0] * ll.shape[1] / 100.0
    return res, {"decode_ms": ms,
                 "decode_audio_sec_per_s": audio_s / (ms / 1e3),
                 "peak_bytes_over_held": extra,
                 "profile": decode_profile(lambda: dec.decode_batch(ll),
                                           dev)}


def decode_layouts_phase(dev, graph, ll, offline):
    """The ELL and tree-ELL layouts on decode_hclg's graph and loglikes
    (see the module docstring); `offline` is the segment layout's
    decode_batch of ll."""
    t_phase = time.perf_counter()
    out = {"states": graph.num_states, "arcs": len(graph.em_dst),
           "B": ll.shape[0], "T": ll.shape[1], "tree_max_width": TREE_W}
    # Viterbi: each layout against the segment decode, bit for bit
    vit = {}
    for tag, layout, plain in (("segment", "segment", False),
                               ("segment_plain", "segment", True),
                               ("tree", "tree", False),
                               ("tree_plain", "tree", True),
                               ("ell", "ell", True)):
        dec = SparseViterbiDecoder(graph, layout=layout,
                                   tree_max_width=TREE_W, device=dev)
        if plain:
            dec.bp_hist_limit = 1 << 40
        ckpt = layout != "ell" and not plain
        if ckpt != (DEC_T * graph.num_states * DEC_B * 4
                    > dec.bp_hist_limit):
            raise AssertionError(f"Viterbi {tag}: the wrong path")
        res, nums = layout_numbers(dec, ll, dev)
        if not results_equal(res, offline):
            raise AssertionError(f"Viterbi {tag}: best, words or alignment "
                                 f"differ from the segment decode")
        if not plain or layout == "ell":
            best_a, _, arcs_a = dec.arc_path(ll)
            best_b, _, arcs_b = dec.arc_path(ll)
            if not (torch.equal(arcs_a, arcs_b)
                    and torch.equal(best_a, best_b)):
                raise AssertionError(f"Viterbi {tag}: repeats differ")
            del best_a, arcs_a, best_b, arcs_b
        vit[tag] = dict(nums, checkpointed=ckpt,
                        launches_per_frame=nums["profile"]["launches"]
                        / DEC_T)
        del dec
    out["viterbi"] = vit
    out["viterbi_equal_to_segment"] = True
    torch.cuda.empty_cache()

    # ties on the card: the smallest arc id in every layout
    ties = []
    for g in tie_graphs():
        z = torch.zeros((1, 2, 3), device=dev)
        ref = SparseViterbiDecoder(g, device=dev).decode_batch(z)
        for layout in ("ell", "tree"):
            got = SparseViterbiDecoder(g, layout=layout, tree_max_width=2,
                                       device=dev).decode_batch(z)
            if not results_equal(got, ref):
                raise AssertionError(f"tie graph, {layout}: differs from "
                                     f"the segment layout")
        ties.append(ref[0]["words"])
    if ties[0] != [7]:
        raise AssertionError(f"tie graph: words {ties[0]}, expected [7]")
    out["tie_words"] = ties

    # lattices: tree (checkpointed, compact) and segment at B = 16; ELL
    # and segment at B = ELL_LAT_B (ELL keeps the whole alpha history)
    lat = {}
    seg = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, device=dev)
    seg_lats, lat["segment"] = layout_numbers(seg, ll, dev)
    seg_masks = seg.masks(ll)[0].cpu().numpy()
    del seg
    tree = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, layout="tree",
                                tree_max_width=TREE_W, device=dev)
    tree_lats, lat["tree"] = layout_numbers(tree, ll, dev)
    lat["tree"]["transfer"] = tree.last_transfer
    lat["tree"]["mask_bits_per_frame"] = tree._g.nbits
    if tree.last_transfer != "compact" or not (
            DEC_T * graph.num_states * DEC_B * 4 > tree.alpha_hist_limit):
        raise AssertionError(f"tree lattice: transfer {tree.last_transfer}, "
                             f"expected the checkpointed path, compacted")
    lat["tree"]["vs_segment"] = layout_vs_segment(
        "tree", graph, ll, tree_lats, seg_lats, tree.masks(ll)[0],
        seg_masks, tree._g)
    del tree, seg_masks
    torch.cuda.empty_cache()
    small = ll[:ELL_LAT_B]
    seg = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, device=dev)
    seg_small, lat[f"segment_B{ELL_LAT_B}"] = layout_numbers(seg, small, dev)
    seg_masks = seg.masks(small)[0].cpu().numpy()
    del seg
    ell = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, layout="ell",
                               device=dev)
    ell_lats, lat[f"ell_B{ELL_LAT_B}"] = layout_numbers(ell, small, dev)
    lat[f"ell_B{ELL_LAT_B}"]["vs_segment"] = layout_vs_segment(
        "ell", graph, small, ell_lats, seg_small, ell.masks(small)[0],
        seg_masks, ell._g)
    del ell, seg_masks
    out["lattice"] = lat
    out["lattice_beam"] = DEC_BEAM
    out["mean_lattice_arcs"] = float(np.mean([len(x.arcs)
                                              for x in tree_lats]))
    del seg_small, ell_lats, small
    torch.cuda.empty_cache()

    # the tree stream (window >= T, chunks of 32) = the offline decode
    sdec = WindowedStreamingDecoder(graph, window=DEC_T, layout="tree",
                                    tree_max_width=TREE_W, device=dev)
    got, wall, extra = peak_over_held(
        lambda: sdec.finalize(stream(sdec, ll, (32,))))
    if not results_equal(got, offline):
        raise AssertionError("tree stream: differs from the offline decode")
    out["tree_stream_chunk32"] = {"equal_to_offline": True, "s": wall,
                                  "peak_bytes_over_held": extra}
    del sdec
    torch.cuda.empty_cache()

    # the profile twins at their defaults
    out["profile_tree"] = profile_tree.main(["--device", str(dev)])
    out["profile_lattice"] = profile_lattice.main(["--device", str(dev)])
    phase("decode_layouts", card=card(), phase_s=time.perf_counter() - t_phase,
          **out)
    return {"tree_lattices": tree_lats}


def _decode_rank(group):
    """A spawned rank of decode_parallel: decode_hclg's graph and
    loglikes (made here from the same seed), its B / 2 rows decoded by
    the segment and tree Viterbi decoders and the tree lattice decoder,
    every rank given all rows' results."""
    dev = group.device
    graph = decodebench.synth_hclg_graph(DEC_S, P)
    gen = torch.Generator(device=dev).manual_seed(1)
    ll = torch.randn((DEC_B, DEC_T, P), generator=gen, device=dev)
    out = {"ll_sum": float(ll.double().sum())}
    for layout in ("segment", "tree"):
        dec = SparseViterbiDecoder(graph, layout=layout, mesh=group,
                                   tree_max_width=TREE_W, device=dev)
        calls = group.calls
        t0 = time.perf_counter()
        out[layout] = {"results": dec.decode_batch(ll),
                       "s": time.perf_counter() - t0,
                       "collectives": group.calls - calls}
        del dec
    dec = DeviceLatticeDecoder(graph, lattice_beam=DEC_BEAM, layout="tree",
                               mesh=group, tree_max_width=TREE_W, device=dev)
    calls, nbytes = group.calls, group.bytes
    t0 = time.perf_counter()
    lats = dec.decode_batch(ll)
    out["tree_lattice"] = {
        "s": time.perf_counter() - t0, "collectives": group.calls - calls,
        "all_reduce_bytes": group.bytes - nbytes,
        "lattices": [{"num_nodes": x.num_nodes, "node_frame": x.node_frame,
                      "final_cost": x.final_cost,
                      **{f: getattr(x.arcs, f) for f in (
                          "src", "dst", "ilabel", "olabel", "graph_cost",
                          "acoustic_cost")}} for x in lats]}
    return out


def decode_parallel_phase(dev, ll, offline, layouts):
    """Two gloo ranks sharing the card decode decode_hclg's batch: equal
    to one process (`offline`, the tree lattices of decode_layouts)."""
    fields = ("src", "dst", "ilabel", "olabel", "graph_cost", "acoustic_cost")
    t0 = time.perf_counter()
    ranks = spawn_ranks(_decode_rank, [dev, dev], backend="gloo",
                        join_seconds=DP_JOIN_S)
    wall = time.perf_counter() - t0
    ll_sum = float(ll.double().sum())
    out = {"world": len(ranks), "B": DEC_B, "T": DEC_T, "wall_s": wall}
    for r, got in enumerate(ranks):
        if got["ll_sum"] != ll_sum:
            raise AssertionError(f"rank {r}: other loglikes")
        for layout in ("segment", "tree"):
            if not results_equal(got[layout]["results"], offline):
                raise AssertionError(f"rank {r}, Viterbi {layout}: differs "
                                     f"from one process")
            if got[layout]["collectives"] != 1:
                raise AssertionError(f"rank {r}, Viterbi {layout}: "
                                     f"{got[layout]['collectives']} "
                                     f"collectives, expected 1")
        tl = got["tree_lattice"]
        for b, (x, y) in enumerate(zip(tl["lattices"],
                                       layouts["tree_lattices"])):
            if not (x["num_nodes"] == y.num_nodes
                    and np.array_equal(x["node_frame"], y.node_frame)
                    and np.array_equal(x["final_cost"], y.final_cost)
                    and all(np.array_equal(x[f], getattr(y.arcs, f))
                            for f in fields)):
                raise AssertionError(f"rank {r}, tree lattice {b}: differs "
                                     f"from one process")
        if tl["collectives"] != 1:
            raise AssertionError(f"rank {r}, tree lattice: "
                                 f"{tl['collectives']} collectives")
    out["per_rank"] = [{k: {"s": g[k]["s"], "collectives": g[k]["collectives"]}
                        for k in ("segment", "tree")}
                       | {"tree_lattice": {
                           k: g["tree_lattice"][k]
                           for k in ("s", "collectives", "all_reduce_bytes")}}
                       for g in ranks]
    phase("decode_parallel", card=card(), phase_s=time.perf_counter() - t0,
          backend="gloo",
          viterbi_equal_to_one_process=True,
          lattice_equal_to_one_process=True, **out)


def graph_fst(g):
    """An epsilon-free DecodingGraph as an Fst, for write_fst_file."""
    states = [FstState(final=float(f)) for f in g.final_cost]
    src = np.repeat(np.arange(g.num_states), np.diff(g.em_row_ptr))
    for s, d, il, ol, w in zip(src.tolist(), g.em_dst.tolist(),
                               g.em_ilabel.tolist(), g.em_olabel.tolist(),
                               g.em_weight.tolist()):
        states[s].arcs.append(FstArc(il, w, d, olabel=ol))
    return Fst(start=g.start, states=states)


def decode_tool_phase(egs_dir):
    """tools.decode's main --on-device on one cegs file of the egs phase,
    through the flagship model: Viterbi, then lattices with --nbest 3;
    per-utterance lines go to build/chip_smoke/decode_*.txt."""
    fst_path = WORK / "HCLG.fst"
    graph = decodebench.synth_hclg_graph(TOOL_S, P)
    write_fst_file(str(fst_path), graph_fst(graph))
    flags = ["--egs", str(egs_dir / "cegs.1.ark"), "--graph", str(fst_path),
             "--xconfig", str(ROOT / "configs" / "cnn_tdnn.xconfig"),
             "--pdfs", str(P), "--batch", str(B), "--on-device"]
    runs, wall_s = {}, {}
    for tag, extra in (("viterbi", []), ("lattice", ["--nbest", "3"])):
        t0 = time.perf_counter()
        with open(WORK / f"decode_{tag}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            runs[tag] = decode_tool.main(flags + extra)
        torch.cuda.synchronize()
        wall_s[tag] = time.perf_counter() - t0
    vit, lat = runs["viterbi"], runs["lattice"]
    for tag, run in runs.items():
        if len(run["hyps"]) != EGS_PER_FILE:
            raise AssertionError(f"decode tool ({tag}) decoded "
                                 f"{len(run['hyps'])} utterances, expected "
                                 f"{EGS_PER_FILE}")
        if not all(run["final_reached"].values()):
            raise AssertionError(f"decode tool ({tag}): an utterance reached "
                                 f"no final state")
    differ = [k for k in vit["hyps"] if lat["hyps"][k] != vit["hyps"][k]]
    if differ:
        raise AssertionError(f"decode tool: the lattices' 1-best differs from "
                             f"the Viterbi words in {len(differ)} "
                             f"utterances, e.g. {differ[:3]}")
    phase("decode_tool", utterances=len(vit["hyps"]), T_out=EGS_T_OUT,
          pdfs=P, graph_states=graph.num_states,
          graph_arcs=len(graph.em_dst), nbest=3, wall_s=wall_s,
          mean_words=float(np.mean([len(w) for w in vit["hyps"].values()])),
          lattice_1best_equals_viterbi=True, all_final=True)


def bn_count_rule(sd):
    """A state dict as a Kaldi round trip gives it back: BatchNorm counts
    as max(count, 1) (the JAX loader's rule)."""
    return {k: v.clamp(min=1.0) if k.endswith(".count") else v
            for k, v in sd.items()}


def kaldi_model_phase(egs_dir, dev):
    """The trainer phase's trained network (its final checkpoint) exported
    to nnet3 text and a binary .raw, loaded back, handed to the model
    tools and decoded through tools.decode --model (see the module
    docstring).  Files go to build/chip_smoke/kaldi_model/."""
    xconfig = str(ROOT / "configs" / "cnn_tdnn.xconfig")
    model = build_model(xconfig)
    src = Network(model, torch.Generator(device=dev).manual_seed(0), dev)
    src.load_state_dict(CheckpointManager(str(WORK / "ckpt_full")).load(
        TRAIN_STEPS)["network"], strict=True)
    src.eval()
    d = WORK / "kaldi_model"
    d.mkdir(exist_ok=True)
    txt, raw = d / "final.txt", d / "final.raw"
    secs = {}
    t0 = time.perf_counter()
    text = export_network_text(src)
    secs["text_export"] = time.perf_counter() - t0
    txt.write_text(text)
    t0 = time.perf_counter()
    comps = parse_nnet3_text(text)
    secs["text_parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_nnet3(Nnet3Model(config_lines=[],
                           components=components_from_text(comps)), str(raw))
    secs["binary_write"] = time.perf_counter() - t0
    del text, comps

    want = bn_count_rule(src.state_dict())
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.normal(size=(8, EGS_T_IN, 40))
                             .astype(np.float32)).to(dev)
    ivecs = torch.from_numpy(rng.normal(size=(8, 100))
                             .astype(np.float32)).to(dev)
    reports = {}
    for kind, path in (("text", txt), ("binary", raw)):
        net = Network(model, torch.Generator(device=dev).manual_seed(1), dev)
        t0 = time.perf_counter()
        reports[kind] = load_into_network(net, str(path))
        torch.cuda.synchronize()
        secs[f"{kind}_load"] = time.perf_counter() - t0
        net.eval()
        got = net.state_dict()
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        if differ or got.keys() != want.keys():
            raise AssertionError(f"{kind} round trip: {len(differ)} tensors "
                                 f"differ, e.g. {differ[:3]}")
        for dtype in (torch.float32, torch.bfloat16):
            with torch.no_grad(), train_tool.deterministic_cudnn():
                a, _ = src(feats, ivecs, train=False, compute_dtype=dtype)
                b, _ = net(feats, ivecs, train=False, compute_dtype=dtype)
            if not all(torch.equal(a[n], b[n]) for n in a):
                raise AssertionError(f"{kind} round trip: the {dtype} "
                                     f"forward differs")
        del net
    # every layer with parameters or BN statistics (30 in the flagship)
    if reports["text"] != reports["binary"] or \
            set(reports["text"]) != set(src.params) | set(src.bn_state()):
        raise AssertionError(f"load reports {reports}")

    t0 = time.perf_counter()
    copy_raw, copy_txt = d / "copy.raw", d / "copy.txt"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rcs = [modeltools.main(["info", str(raw)]),
               modeltools.main(["copy", str(txt), str(copy_raw), "--binary"]),
               modeltools.main(["copy", str(copy_raw), str(copy_txt),
                                "--text"]),
               modeltools.main(["compare", str(txt), str(copy_txt)])]
    secs["modeltools"] = time.perf_counter() - t0
    tool_out = out.getvalue()
    if rcs != [0, 0, 0, 0] or "worst |diff| = 0.000e+00" not in tool_out \
            or copy_raw.read_bytes() != raw.read_bytes():
        raise AssertionError(f"modeltools: exit codes {rcs}, "
                             f"{tool_out.splitlines()[-1]}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        lt = {"round_trip": loadtest.main([]),
              "model": loadtest.main(["--model", str(raw)])}
    secs["loadtest"] = time.perf_counter() - t0
    if any(r["failures"] for r in lt.values()) or \
            lt["round_trip"]["round_trip_max_abs_err"] != 0.0:
        raise AssertionError(f"loadtest: {lt}")

    # the decode tool with --model, against the same weights from memory
    flags = ["--egs", str(egs_dir / "cegs.1.ark"), "--graph",
             str(WORK / "HCLG.fst"), "--xconfig", xconfig, "--pdfs", str(P),
             "--batch", str(B), "--on-device", "--model", str(raw)]
    t0 = time.perf_counter()
    with open(WORK / "decode_model.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        run = decode_tool.main(flags)
    torch.cuda.synchronize()
    secs["decode_tool"] = time.perf_counter() - t0
    posts = decode_tool.acoustic_posteriors(src, DataLoader(
        str(egs_dir / "cegs.1.ark"),
        DataLoaderConfig(batch_size=B, label_dim=P)), dev)
    graph = DecodingGraph.from_file(str(WORK / "HCLG.fst"))
    if len(graph.eps_dst):
        raise AssertionError("the decode tool's graph has epsilon arcs")
    ref = SparseViterbiDecoder(graph, device=dev).decode_batch(
        torch.stack(list(posts.values())))
    memory = {k: r["words"] for k, r in zip(posts, ref)}
    if len(run["hyps"]) != EGS_PER_FILE or run["hyps"] != memory:
        differ = [k for k in memory if run["hyps"].get(k) != memory[k]]
        raise AssertionError(f"decode --model: {len(run['hyps'])} "
                             f"utterances, {len(differ)} differ from the "
                             f"network in memory, e.g. {differ[:3]}")
    phase("kaldi_model", source=f"trainer checkpoint step {TRAIN_STEPS}",
          values_loaded=sum(reports["binary"].values()),
          layers_loaded=len(reports["binary"]),
          text_mb=txt.stat().st_size / 1e6, binary_mb=raw.stat().st_size / 1e6,
          seconds=secs, params_bit_identical=True, forward_bit_identical=True,
          modeltools_compare_worst=0.0,
          loadtest_round_trip_max_abs_err=0.0,
          decode_utterances=len(run["hyps"]), decode_words_equal=True,
          decode_all_final=all(run["final_reached"].values()),
          mean_words=float(np.mean([len(w) for w in memory.values()])))
    del src
    torch.cuda.empty_cache()


def attention_xconfig():
    """The flagship with ATTENTION_LAYER after tdnnf21 (prefinal-l takes
    its output), written to build/chip_smoke/attention.xconfig."""
    text = (ROOT / "configs" / "cnn_tdnn.xconfig").read_text()
    old = "prefinal-layer name=prefinal-l input=tdnnf21"
    if old not in text:
        raise AssertionError(f"configs/cnn_tdnn.xconfig has no {old!r}")
    path = WORK / "attention.xconfig"
    path.write_text(text.replace(old, ATTENTION_LAYER + "\n" + old.replace(
        "input=tdnnf21", "input=attention1")))
    return str(path)


def attention_phase(dev, graph, fused):
    """The flagship with one attention layer: bench.py's step with the
    default den, in turns with the flagship's, a narrow fp32 attention
    step on the card against the CPU, the streaming encoder against its
    offline reference (see the module docstring).  fused: the
    train_fused phase's numbers.  Returns the attention steps' kernel
    launches."""
    xconfig = attention_xconfig()
    model = build_model(xconfig)
    if (model.num_params(), model.time_context()) != ATTENTION_SIZE:
        raise AssertionError(f"attention model: {model.num_params()} "
                             f"parameters, context {model.time_context()}")
    counts = {"den_scan_fwd": den_scan.fused_forward,
              "den_scan_bwd": den_scan.fused_backward,
              "den_matmul": DenMatmul}
    # the attention model's steps and the flagship's in turns, so that the
    # two step times share the card's and the host's state
    runs = {"attention": [], "flagship": []}
    launches = dict.fromkeys(counts, 0)
    for tag in ("flagship", "attention", "attention", "flagship"):
        counted, _, numbers = train_phase(
            dev, DenominatorComputation(graph, leaky=1e-5, device=dev), None,
            counts, {"den_scan_fwd": 1, "den_scan_bwd": 1, "den_matmul": 0},
            xconfig=xconfig if tag == "attention" else None, steps=4)
        runs[tag].append(numbers)
        if tag == "attention":
            launches = {k: launches[k] + counted[k] for k in counts}
        torch.cuda.empty_cache()
    att_ms = float(np.mean([r["step_ms"] for r in runs["attention"]]))
    flag_ms = float(np.mean([r["step_ms"] for r in runs["flagship"]]))
    small_xconfig = SMALL_XCONFIG.replace(
        "prefinal-layer name=prefinal-l input=tdnnf4",
        SMALL_ATTENTION_LAYER
        + "\nprefinal-layer name=prefinal-l input=attention1")
    small = small_step_pair(dev, False, small_xconfig,
                            scalar_tol=ATTENTION_SCALAR)

    net = Network(model, torch.Generator(device=dev).manual_seed(0), dev)
    net.eval()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(
        STREAM_B, 3 * STREAM_T_OUT, 40)).astype(np.float32)).to(dev)
    iv = torch.from_numpy(rng.normal(size=(STREAM_B, 100))
                          .astype(np.float32)).to(dev)
    enc = StreamingEncoder(net, chunk_out=16, compute_dtype=torch.float32,
                           device=dev)
    got, ref = encode_stream(enc, x, iv), enc.offline_reference(x, iv)
    excess = float(((got - ref).abs() - ENC_FP32_TOL * ref.abs()).max())
    if got.shape != ref.shape or not torch.isfinite(got).all() or \
            not excess <= ENC_FP32_TOL:
        raise AssertionError(f"attention streaming encoder: "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}, "
                             f"excess {excess}")
    phase("attention", params=model.num_params(),
          context=list(model.time_context()), step_ms=att_ms,
          step_ms_each=[r["step_ms_each"] for r in runs["attention"]],
          flagship_step_ms=flag_ms,
          flagship_step_ms_each=[r["step_ms_each"] for r in runs["flagship"]],
          step_ms_over_flagship=att_ms / flag_ms,
          train_fused_step_ms=fused["step_ms"],
          losses=[r["losses"] for r in runs["attention"]], launches=launches,
          train_audio_sec_per_s_per_chip=B * T_IN / 100.0 / (att_ms / 1e3),
          max_memory_allocated_bytes=runs["attention"][0][
              "max_memory_allocated_bytes"],
          flagship_max_memory_allocated_bytes=runs["flagship"][0][
              "max_memory_allocated_bytes"],
          small_step_vs_cpu=small,
          stream_fp32_chunk16={"max_abs_err": float((got - ref).abs().max()),
                               "max_abs_ref": float(ref.abs().max()),
                               "max_excess_over_rtol": excess,
                               "lag": enc.lag})
    del net, enc
    torch.cuda.empty_cache()
    return launches


def results_equal(a, b):
    """Hypothesis dicts equal in words, alignment, final_reached and cost."""
    key = ("words", "alignment", "final_reached", "total_cost")
    return len(a) == len(b) and all(
        [x[k] for k in key] == [y[k] for k in key] for x, y in zip(a, b))


def stream(dec, ll, chunks, check=None):
    """Feed ll [B, T, P] to a streaming decoder in chunks of the given
    sizes, cycled (the last cut to fit), calling check(state) after every
    feed; returns the last state."""
    st = dec.init(ll.shape[0])
    t0, i = 0, 0
    while t0 < ll.shape[1]:
        c = min(chunks[i % len(chunks)], ll.shape[1] - t0)
        st = dec.feed(st, ll[:, t0:t0 + c])
        if check is not None:
            check(st)
        t0, i = t0 + c, i + 1
    return st


def peak_over_held(fn):
    """(fn's result, wall s, peak device bytes above what was allocated
    when fn started)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - held)


def stream_decode_phase(dev, graph, ll, offline):
    """The streaming decoders on decode_hclg's graph and loglikes (see the
    module docstring); `offline` is SparseViterbiDecoder's decode_batch of
    ll."""
    inc = StreamingDecoder(graph, device=dev)
    result = {"states": graph.num_states, "arcs": len(inc.arcs.src),
              "B": ll.shape[0], "T": ll.shape[1]}
    for tag, chunks in (("incremental_16", (16,)),
                        ("incremental_ragged", STREAM_RAGGED)):
        got, wall, extra = peak_over_held(
            lambda: inc.finalize(stream(inc, ll, chunks)))
        if not results_equal(got, offline):
            raise AssertionError(f"{tag}: the streamed decode differs from "
                                 f"the offline one")
        result[f"{tag}_s"] = wall
        result[f"{tag}_peak_bytes_over_held"] = extra
    full = WindowedStreamingDecoder(graph, window=ll.shape[1], device=dev)
    st = stream(full, ll, (16,))
    if st.committed or not results_equal(full.finalize(st), offline):
        raise AssertionError("windowed decoder at window >= T: committed "
                             "early or differs from the offline decode")
    del inc, full, st
    torch.cuda.empty_cache()

    def windowed(lls, C):
        dec = WindowedStreamingDecoder(graph, window=STREAM_WINDOW,
                                       device=dev)

        def bounded(st):
            if not (st.window_frames <= STREAM_WINDOW + C
                    and st.committed_frames == st.frames - st.window_frames):
                raise AssertionError(
                    f"window {STREAM_WINDOW}, chunk {C}: {st.window_frames} "
                    f"window frames, {st.committed_frames} committed of "
                    f"{st.frames}")
        return dec.finalize(stream(dec, lls, (C,), bounded))

    for C in STREAM_CHUNKS:
        got, wall, extra = peak_over_held(lambda: windowed(ll, C))
        result[f"window{STREAM_WINDOW}_chunk{C}"] = {
            "equal_to_offline": sum(results_equal([a], [b])
                                    for a, b in zip(got, offline)),
            "words_equal": sum(a["words"] == b["words"]
                               for a, b in zip(got, offline)),
            "all_final": all(r["final_reached"] for r in got),
            "s": wall, "peak_bytes_over_held": extra}
    # the same window over a stream twice as long: the memory bound holds
    gen = torch.Generator(device=dev).manual_seed(3)
    ll2 = torch.randn((ll.shape[0], 2 * ll.shape[1], ll.shape[2]),
                      generator=gen, device=dev)
    C = STREAM_CHUNKS[-1]
    _, wall, extra2 = peak_over_held(lambda: windowed(ll2, C))
    extra1 = result[f"window{STREAM_WINDOW}_chunk{C}"]["peak_bytes_over_held"]
    if not extra2 <= 1.05 * extra1:
        raise AssertionError(f"windowed decoder's peak grew with T: "
                             f"{extra1} bytes at T = {ll.shape[1]}, {extra2} "
                             f"at {ll2.shape[1]}")
    result[f"T{ll2.shape[1]}_chunk{C}"] = {"s": wall,
                                           "peak_bytes_over_held": extra2}
    # one steady-state feed of 16 frames (window full, a commit every
    # feed) under torch.profiler
    dec = WindowedStreamingDecoder(graph, window=STREAM_WINDOW, device=dev)
    box = [stream(dec, ll2[:, :STREAM_WINDOW + 32], (16,))]
    nxt = ll2[:, STREAM_WINDOW + 32:STREAM_WINDOW + 48]

    def feed():
        box[0] = dec.feed(box[0], nxt)

    result["feed_profile_chunk16"] = decode_profile(feed, dev)
    del ll2, dec, box, nxt
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        result["streambench_rows"] = streambench.main(
            ["--decode-only", "--hclg", "--graph-states", str(DEC_S),
             "--pdfs", str(P), "--batch", str(ll.shape[0]), "--decoder",
             "windowed", "--window", str(STREAM_WINDOW), "--chunks",
             ",".join(map(str, STREAM_CHUNKS)), "--iters", str(STREAM_ITERS),
             "--device", str(dev)])
    phase("stream_decode", window=STREAM_WINDOW, ragged=STREAM_RAGGED,
          incremental_equals_offline=True, window_ge_T_equals_offline=True,
          **result)


def encode_stream(enc, x, ivectors):
    """x [B, T_in, D] through the streaming encoder chunk by chunk, then
    flushed: [B, T_in / subsample, P]."""
    st = enc.init(ivectors)
    outs = []
    for i in range(x.shape[1] // enc.cin):
        st, p = enc.feed(st, x[:, i * enc.cin:(i + 1) * enc.cin])
        outs.append(p)
    st, p = enc.flush(st)
    return torch.cat([o for o in outs + [p] if o.shape[1]], dim=1)


def stream_encode_phase(dev):
    """The streaming encoder at flagship width (see the module
    docstring)."""
    xconfig = str(ROOT / "configs" / "cnn_tdnn.xconfig")
    model = build_model(xconfig)
    net = Network(model, torch.Generator(device=dev).manual_seed(0), dev)
    net.eval()
    dims = {inp.name: inp.spec.dim for inp in model.inputs()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(
        STREAM_B, 3 * STREAM_T_OUT, dims["input"])).astype(np.float32)).to(dev)
    iv = torch.from_numpy(rng.normal(size=(STREAM_B, dims["ivector"]))
                          .astype(np.float32)).to(dev)
    result, failed = {"B": STREAM_B, "T_out": STREAM_T_OUT,
                      "context": list(model.time_context())}, []
    for name, dtype, tol in (("fp32", torch.float32, ENC_FP32_TOL),
                             ("bf16", torch.bfloat16, ENC_BF16_TOL)):
        outs = {}
        for co in STREAM_CHUNKS:
            enc = StreamingEncoder(net, chunk_out=co, compute_dtype=dtype,
                                   device=dev)
            got, ref = encode_stream(enc, x, iv), enc.offline_reference(x, iv)
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} chunk {co}: streamed output "
                                     f"{tuple(got.shape)} vs {tuple(ref.shape)}")
            # |got - ref| <= tol + tol * |ref| (assert_allclose's test)
            excess = float(((got - ref).abs() - tol * ref.abs()).max())
            result[f"{name}_chunk{co}"] = {
                "max_abs_err": float((got - ref).abs().max()),
                "max_abs_ref": float(ref.abs().max()),
                "max_excess_over_rtol": excess, "lag": enc.lag}
            if not excess <= tol:
                failed.append(f"{name} chunk {co} vs offline_reference")
            outs[co] = got
        base = outs[STREAM_CHUNKS[0]]
        for co in STREAM_CHUNKS[1:]:
            excess = float(((outs[co] - base).abs() - tol * base.abs()).max())
            result[f"{name}_chunk{co}_vs_chunk{STREAM_CHUNKS[0]}"] = {
                "max_abs_diff": float((outs[co] - base).abs().max()),
                "max_excess_over_rtol": excess}
            if not excess <= tol:
                failed.append(f"{name} chunk {co} vs chunk {STREAM_CHUNKS[0]}")
    if failed:
        phase("stream_encode", failed=failed, **result)
        raise AssertionError(f"streaming encoder off its bars: {failed}")
    # one warm bf16 feed at chunk_out 16 under torch.profiler
    enc = StreamingEncoder(net, chunk_out=16, device=dev)
    box = [enc.init(iv)]
    for i in range(enc.lag + 1):
        box[0], _ = enc.feed(box[0], x[:, i * enc.cin:(i + 1) * enc.cin])

    def feed():
        box[0], _ = enc.feed(box[0], x[:, :enc.cin])

    result["feed_profile_bf16_chunk16"] = decode_profile(feed, dev)
    with contextlib.redirect_stdout(io.StringIO()):
        result["streambench_rows"] = streambench.main(
            ["--batch", str(STREAM_B), "--chunks",
             ",".join(map(str, STREAM_CHUNKS)), "--xconfig", xconfig,
             "--pdfs", str(P),
             "--iters", str(STREAM_ITERS), "--device", str(dev)])
    phase("stream_encode", fp32_tol=ENC_FP32_TOL, bf16_tol=ENC_BF16_TOL,
          **result)


def synthwer_phase(dev):
    """tools.synthwer's main on the card (see the module docstring).
    Returns (den_matmul launches in the run, the kernel's max abs err
    against its plain version at the run's shape)."""
    den_inputs = []
    run_den = DenominatorComputation.forward_backward

    def keep_input(self, x, *args, **kwargs):
        if not den_inputs:
            den_inputs.append(x.detach().clone())
        return run_den(self, x, *args, **kwargs)

    DenominatorComputation.forward_backward = keep_input
    DenMatmul.launches = 0
    t0 = time.perf_counter()
    try:
        with open(WORK / "synthwer.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            res = synthwer.main(SYNTHWER_FLAGS + ["--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        DenominatorComputation.forward_backward = run_den
    wall = time.perf_counter() - t0
    launches = DenMatmul.launches
    if not res["ok"]:
        raise AssertionError(f"synthwer: not ok: {res['history'][-1]}, "
                             f"{res['streaming']}, {res['lm_rescore']}")
    if launches <= 0:
        raise AssertionError("synthwer: den_matmul was never launched")
    den = res["trainer"].den
    sk = den._structured
    if sk is None or sk._kernel is None:
        raise AssertionError(f"synthwer's den is {den.layout_used}, without "
                             f"the den_matmul kernel")

    # the first batch through the Trainer's den and through plain matmuls
    x = den_inputs[0]
    phones = synthwer.parse_args(SYNTHWER_FLAGS).phones
    graph = DenominatorGraph.from_fst(synthwer.bigram_den_fst(phones), phones)
    lp, post = den.forward_backward(x)
    den_p = DenominatorComputation(graph, leaky=den.leaky, matmul_impl="plain",
                                   scan_impl="loop", device=dev)
    lp_p, post_p = den_p.forward_backward(x)
    torch.cuda.synchronize()
    if not (torch.isfinite(lp).all() and torch.isfinite(post).all()):
        raise AssertionError("synthwer: the den output is not finite")
    torch.testing.assert_close(lp, lp_p, rtol=LOGP_RTOL, atol=0)
    torch.testing.assert_close(post, post_p, rtol=POST_RTOL, atol=POST_ATOL)

    # den_matmul at this shape against its plain version, and timed
    dm, n = sk._kernel, x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    v = torch.rand((dm.F, n), generator=gen, device=dev)
    err, us = 0.0, {}
    for transpose in (False, True):
        out = dm.apply(v, transpose)
        ref = den_matmul_split_plain(dm.M, v, transpose)
        torch.cuda.synchronize()
        err = max(err, float((out - ref).abs().max()))
    T = x.shape[1]
    us["kernel"] = 1e3 * warm_ms(lambda: dm.apply(v, False), 2 * T)
    us["plain"] = 1e3 * warm_ms(
        lambda: den_matmul_split_plain(dm.M, v, False), 8)
    hist = res["history"]
    phase("synthwer", flags=SYNTHWER_FLAGS, ok=True, steps=res["steps"],
          wall_s=wall, wer_trajectory=[[h["step"], h["wer"]] for h in hist],
          objf_final=hist[-1].get("objf"), wer_first=res["wer_first"],
          wer_final=res["wer_final"], wer_streaming=res["wer_streaming"],
          wer_rescored=res["wer_rescored"], streaming=res["streaming"],
          lm_rescore=res["lm_rescore"], layout_used=den.layout_used,
          scan_used=sk.scan_used, den_L=sk.lay.L, den_F=dm.F, den_Fp=dm.Fp,
          n=n, first_batch_shape=list(x.shape), den_matmul_launches=launches,
          logp_max_rel_vs_plain=float(((lp - lp_p).abs()
                                       / lp_p.abs()).max()),
          post_max_abs_vs_plain=float((post - post_p).abs().max()),
          den_matmul_max_abs_err_vs_plain=err,
          den_matmul_us=us["kernel"], den_matmul_plain_us=us["plain"])
    return launches, err



# ---- the verification harness (tools.chainverify ... tools.csrdump) -------

VERIFY = WORK / "verify"
KERNEL_COUNTERS = ("den_matmul", "den_matmul_pre", "den_scan_fwd",
                   "den_scan_bwd", "segment_reduce")
FLAGSHIP = str(ROOT / "configs" / "cnn_tdnn.xconfig")
# chainverify's den paths on the egs phase's den.fst and cegs: (tag, flags,
# the route the tool must report, the kernel each path must launch)
CHAINVERIFY_PATHS = (
    ("fused", ["--layout", "structured", "--scan-impl", "fused",
               "--batch", "128"],
     {"layout": "structured", "scan": "fused", "posterior_reduce": None},
     ("den_scan_fwd", "den_scan_bwd")),
    ("loop_kernel", ["--scan-impl", "loop", "--batch", "8",
                     "--split", "kernel"],
     {"layout": "structured", "scan": "loop", "posterior_reduce": None},
     ("den_matmul",)),
    ("loop_pre", ["--scan-impl", "loop", "--batch", "8", "--split", "pre"],
     {"layout": "structured", "scan": "loop", "posterior_reduce": None},
     ("den_matmul_pre",)),
    ("blocked", ["--layout", "blocked", "--batch", "8"],
     {"layout": "blocked", "scan": None, "posterior_reduce": "kernel"},
     ("segment_reduce",)),
)
# soak on the flagship at its default pdfs and batch, cut in epochs and
# checkpoint interval only: killed at step 25 with the last checkpoint at
# step 20 and the next at 40, so the resumed run re-trains steps 21..25+
SOAK_CUTS = {"--epochs": "2", "--ckpt-every": "20"}
# traintest on the flagship over the egs phase's 8 batches of 128: 9 steps,
# so the last step sees the first batch again, at lr 1e-4.  At the JAX
# tool's lr 1e-2 (and at 1e-3) the flagship on the 7052-state den with
# synthetic supervision spikes and climbs, in both packages (PERF.md,
# section 6)
TRAINTEST_STEPS, TRAINTEST_LR = 9, "1e-4"


def card():
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def kernel_launches():
    """The wrappers' launch counts, by the kernels line's names."""
    return {"den_matmul": DenMatmul.launches,
            "den_matmul_pre": DenMatmul.launches_pre,
            "den_scan_fwd": den_scan.fused_forward.launches,
            "den_scan_bwd": den_scan.fused_backward.launches,
            "segment_reduce": segment_reduce.launches}


def zero_launches():
    DenMatmul.launches = DenMatmul.launches_pre = 0
    den_scan.fused_forward.launches = den_scan.fused_backward.launches = 0
    segment_reduce.launches = 0


def run_tool(tool, argv, log, totals):
    """One tool's main(argv) in this process, its output in
    VERIFY/<log>.txt.  Every kernel count is set to 0 just before the run
    and read just after, into `totals`.  Fails on a FAIL line or a nonzero
    exit; returns (main's result, the output, seconds, the run's
    launches)."""
    VERIFY.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    code = 0
    try:
        with contextlib.redirect_stdout(buf):
            res = tool.main(argv)
    except SystemExit as e:
        res, code = None, e.code
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n
    text = buf.getvalue()
    (VERIFY / f"{log}.txt").write_text(text)
    failed = [ln.strip() for ln in text.splitlines()
              if ln.strip().startswith("FAIL")
              or ln.strip() == "SOAK FAIL"]
    if code not in (0, None) or failed:
        raise AssertionError(f"{log}: exit {code}, {failed[:6]}")
    return res, text, seconds, launches


def verify_chain_phase(egs_dir, totals):
    """tools.chainverify at its defaults (strict CPU pass, then the card),
    then on the egs phase's den.fst and cegs once per den path, each route
    asserted; tools.denverify on that den.fst; tools.chaintest on the
    flagship; tools.chainbench --topology phone-lm at production scale."""
    from kaldi_fp16_tpu_torch.tools import (
        chainbench, chaintest, chainverify, denverify,
    )
    res, _, s, n = run_tool(chainverify, [], "chainverify_defaults", totals)
    if res["failures"] or not res["repeats_identical"]:
        raise AssertionError("chainverify at its defaults failed")
    if res["route"]["posterior_reduce"] != "kernel" or not n["segment_reduce"]:
        raise AssertionError(f"chainverify's default den took {res['route']}"
                             f", {n}")
    out = {"defaults": {"route": res["route"], "seconds": s,
                        "strict_fd_err": res["passes"]["strict"]["fd_err"],
                        "device_fd_err": res["passes"]["device"]["fd_err"],
                        "device_den_post_err":
                            res["passes"]["device"]["den_post_err"],
                        "launches": n}}
    den_fst = str(egs_dir / "den.fst")
    common = ["--den-fst", den_fst, "--egs", str(egs_dir / "cegs.1.ark"),
              "--pdfs", str(P), "--skip-strict"]
    for tag, flags, route, kernels in CHAINVERIFY_PATHS:
        res, _, s, n = run_tool(chainverify, common + flags,
                                f"chainverify_{tag}", totals)
        if res["route"] != route:
            raise AssertionError(f"chainverify {tag}: route {res['route']}, "
                                 f"expected {route}")
        if not res["repeats_identical"] or not all(n[k] for k in kernels):
            raise AssertionError(f"chainverify {tag}: repeats identical "
                                 f"{res['repeats_identical']}, launches {n}")
        dp = res["passes"]["device"]
        worst_lp = max(abs(got - ref) for _, got, ref in dp["checks"])
        out[tag] = {"route": res["route"], "seconds": s, "launches": n,
                    "logprob_max_abs_err_vs_fp64": worst_lp,
                    "num_post_err": dp["num_post_err"],
                    "den_post_err": dp["den_post_err"],
                    "fd_err": dp["fd_err"],
                    # the derivative's size at the probed points, beside
                    # the finite differences' error
                    "fd_max_abs_analytic": max(abs(r[4]) for r in dp["fd"])}
    res, _, s, n = run_tool(denverify, ["--den-fst", den_fst, "--pdfs",
                                        str(P)], "denverify", totals)
    out["denverify"] = {"seconds": s, "launches": n,
                        "rows": [{k: r[k] for k in ("name", "err_oracle",
                                                    "err_brute", "grad_err")}
                                 for r in res["rows"]]}
    res, _, s, n = run_tool(chaintest, [
        "--xconfig", FLAGSHIP, "--pdfs", str(P), "--egs",
        str(egs_dir / "cegs.*.ark"), "--den-fst", den_fst], "chaintest",
        totals)
    out["chaintest"] = {"seconds": s, "launches": n,
                        "objf_per_frame": res["objf_per_frame"],
                        "deriv": {k: v for k, v in res["deriv"].items()
                                  if k != "shape"},
                        "memory_mb": res["memory_mb"]}
    _, text, s, n = run_tool(chainbench, ["--topology", "phone-lm"],
                             "chainbench", totals)
    out["chainbench"] = json.loads(text.strip().splitlines()[-1])
    out["chainbench"]["launches"] = n
    phase("verify_chain", card=card(), **out)


def verify_net_phase(totals):
    """tools.fwdtest on the flagship (B = 8, T = 150, 20 iterations) with
    and without --bn-identity, tools.backtest and tools.sgdtest on the
    card, TF32 off."""
    from kaldi_fp16_tpu_torch.tools import backtest, fwdtest, sgdtest
    out = {}
    for tag, extra in (("fwdtest", []), ("fwdtest_bn_identity",
                                         ["--bn-identity"])):
        res, _, s, _ = run_tool(fwdtest, ["--xconfig", FLAGSHIP, "--batch",
                                          "8", "--frames", "150", "--iters",
                                          "20"] + extra, tag, totals)
        if not all(o["finite"] for o in res["outputs"].values()):
            raise AssertionError(f"{tag}: outputs not finite")
        out[tag] = {"frames_per_s": res["frames_per_s"],
                    "outputs": {k: o["shape"] for k, o in
                                res["outputs"].items()}}
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on before backtest")
    res, _, s, _ = run_tool(backtest, [], "backtest", totals)
    out["backtest"] = {"worst_rel_err": res["worst"], "seconds": s}
    res, _, s, _ = run_tool(sgdtest, [], "sgdtest", totals)
    out["sgdtest"] = {"checks": len(res["checks"]), "seconds": s}
    phase("verify_net", card=card(), **out)


def verify_train_phase(egs_dir, totals):
    """tools.traintest on the flagship at B = 128 over the egs phase's
    cegs (fused den route asserted, the first batch's loss must fall by its
    second visit), tools.soak on the
    flagship (SIGKILL and resume, run 1's objf reproduced exactly) and
    tools.abtest --ab grid at its defaults."""
    from kaldi_fp16_tpu_torch.tools import abtest, soak, traintest
    res, _, s, n = run_tool(traintest, [
        "--xconfig", FLAGSHIP, "--den-topology", "phone-lm", "--pdfs",
        str(P), "--egs-dir", str(egs_dir), "--batch", str(B), "--steps",
        str(TRAINTEST_STEPS), "--lr", TRAINTEST_LR, "--bench-json"],
        "traintest", totals)
    if res["den_route"] != "structured den, fused scans":
        raise AssertionError(f"traintest took {res['den_route']}")
    if not res["improved"] or n["den_scan_fwd"] != TRAINTEST_STEPS:
        raise AssertionError(f"traintest: improved {res['improved']}, "
                             f"launches {n}")
    out = {"traintest": {
        "B": B, "steps": TRAINTEST_STEPS, "lr": TRAINTEST_LR,
        "den_route": res["den_route"], "losses": res["losses"],
        "train_audio_sec_per_s_per_chip": res["audio_sec_per_s"],
        "step_ms": res["step_ms"], "timed_steps": res["timed_steps"],
        "phase_ms": res["phase_ms"], "launches": n, "seconds": s}}
    argv = ["--workdir", str(WORK / "soak")]
    for flag, value in SOAK_CUTS.items():
        argv += [flag, value]
    res, _, s, _ = run_tool(soak, argv, "soak", totals)
    if not (res["ok"] and res["replay_exact"] and res["replayed_steps"] > 0):
        raise AssertionError(f"soak: {res}")
    out["soak"] = {"cuts": SOAK_CUTS, "seconds": s,
                   **{k: res[k] for k in (
                       "killed_at_step", "last_ckpt_step", "resumed_at_step",
                       "replayed_steps", "replay_max_objf_diff",
                       "replay_exact", "no_restart", "continuity_ok",
                       "lr_schedule_preserved", "final_objf",
                       "total_steps")}}
    res, text, s, _ = run_tool(abtest, ["--ab", "grid", "--workdir",
                                        str(WORK / "abtest")], "abtest",
                               totals)
    out["abtest"] = {"seconds": s, **json.loads(text.strip().splitlines()[-1])}
    phase("verify_train", card=card(), **out)


def verify_data_phase(egs_dir, totals):
    """The host data tools on the egs phase's files: tools.gputest (to the
    card), tools.dltest plain / --workers 2 / --process-workers 2,
    egstools analyze / verify, nscheck and csrdump."""
    from kaldi_fp16_tpu_torch.tools import (
        csrdump, dltest, egstools, gputest, nscheck,
    )
    arks = str(egs_dir / "cegs.*.ark")
    files = sorted(str(f) for f in egs_dir.glob("cegs.*.ark"))
    res, _, s, _ = run_tool(gputest, ["--egs", arks, "--pdfs", str(P)],
                            "gputest", totals)
    out = {"gputest": {k: res[k] for k in ("parse_ms", "batch_mb",
                                           "batch_ms", "raw_gb_per_s",
                                           "bit_exact")}}
    errs = {}
    for tag, extra in (("plain", []), ("workers_2", ["--workers", "2"]),
                       ("process_workers_2", ["--process-workers", "2"])):
        res, _, s, _ = run_tool(dltest, [arks] + extra, f"dltest_{tag}",
                                totals)
        errs[tag] = res["bf16_max_err"]
        out[f"dltest_{tag}"] = {"batches": res["batches"],
                                "frames_per_s": res["frames_per_s"],
                                "bf16_max_err": res["bf16_max_err"]}
    if len(set(errs.values())) != 1:
        raise AssertionError(f"dltest's loaders disagree: {errs}")
    for cmd in ("analyze", "verify"):
        _, text, s, _ = run_tool(egstools, [cmd] + files, f"egstools_{cmd}",
                                 totals)
        out[f"egstools_{cmd}"] = text.strip().splitlines()[:2]
    _, text, _, _ = run_tool(nscheck, [arks], "nscheck", totals)
    out["nscheck_lines"] = len(text.splitlines())
    _, text, _, _ = run_tool(csrdump, [arks], "csrdump", totals)
    out["csrdump_lines"] = len(text.splitlines())
    phase("verify_data", card=card(), **out)


# ---- the side stack and the measurement tools -----------------------------

# the x-vector phase: XVectorConfig()'s widths with a 1024-speaker head, B
# = 64 utterances of 300 frames drawn as tools.xvectortrain's synth_batch
# does, its schedule (Adam, warmup 10, StepLR 60 x 0.5 from 2e-3); the
# card-vs-CPU loss + grad at B = 4
XV_SPEAKERS, XV_B, XV_T, XV_STEPS, XV_SMALL_B = 1024, 64, 300, 30, 4
# remat against no remat: the JAX package's bars (tests/test_training.py:
# 407-428); REMAT_STEPS of bench.py's step each
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL = 1e-6, 1e-5
REMAT_PARAMS = dict(rtol=1e-5, atol=1e-7)
REMAT_STEPS = 2
MEASURE = WORK / "measure"
# the den_scan kernels a profiled train step must show in its trace
SCAN_KERNEL_NAMES = ("fwd_product_kernel", "fwd_update_kernel",
                     "bwd_product_kernel", "bwd_update_kernel")


def xvector_phase(dev, totals):
    """The x-vector family at XVectorConfig()'s widths (feat 30, TDNN 512 x
    4 + 1500, embedding 512, segments 512, 512) with 1024 speakers: 30
    fp32 Adam steps at B = 64 x 300 frames with tools.xvectortrain's
    schedule (warmup and StepLR); the loss on a fixed batch of 256
    utterances (the tool's evaluation set) must fall.  In 30 steps each
    of the 1024 speakers is drawn about twice, so the training batches'
    own losses stay near ln 1024.  Then one fp32 loss + grad on the card
    and on the CPU from the same weights at B = 4 (SMALL_RTOL), and two
    adam_update steps from those weights on each device, fed the same
    gradients (the CPU's, then the card's), with weight decay 0 and 1e-2:
    parameters, m and v card against CPU at SMALL_RTOL, so the card's
    Adam is the CPU's, which the tests hold to JAX's.
    tools.xvectortrain at its defaults must report ok.  The forward on the
    evaluation batch is timed by utils.profiling.profile_fn."""
    from kaldi_fp16_tpu_torch.tools import xvectortrain
    cfg = XVectorConfig(num_speakers=XV_SPEAKERS)
    rng = np.random.default_rng(0)
    centers = 2.0 * rng.normal(size=(XV_SPEAKERS, cfg.feat_dim))
    eval_feats, eval_labels = (
        torch.from_numpy(a).to(dev) for a in xvectortrain.synth_batch(
            rng, centers, 256, XV_T, cfg.feat_dim))
    params = init_xvector(cfg, torch.Generator().manual_seed(0), dev)

    def eval_loss():
        with torch.no_grad():
            return float(xvector_loss(cfg, params, eval_feats, eval_labels))

    eval_before = eval_loss()
    n_params = sum(w.numel() for p in params.values() for w in p.values())
    opt = init_adam_state(params)
    sched = warmup_lr(step_lr(2e-3, 60, gamma=0.5), 10)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for step in range(XV_STEPS):
        feats, labels = (torch.from_numpy(a).to(dev) for a in
                         xvectortrain.synth_batch(rng, centers, XV_B, XV_T,
                                                  cfg.feat_dim))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt, loss = xvectortrain.train_step(cfg, params, opt, feats, labels,
                                            float(np.float32(sched(step))))
        end.record()
        end.synchronize()
        losses.append(float(loss))
        if step:
            ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    eval_after = eval_loss()
    with torch.no_grad():
        fwd = profile_fn(xvector_forward, cfg, params, eval_feats, iters=5)
    if not (np.all(np.isfinite(losses)) and eval_after < eval_before):
        raise AssertionError(f"x-vector loss did not fall: evaluation "
                             f"{eval_before} -> {eval_after}, training "
                             f"{losses}")

    # fp32 loss + grad, card against CPU, from the same weights
    small = {}
    init = init_xvector(cfg, torch.Generator().manual_seed(1), "cpu")
    feats, labels = xvectortrain.synth_batch(rng, centers, XV_SMALL_B, XV_T,
                                             cfg.feat_dim)
    for tag, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = {k: {n: w.detach().to(d).requires_grad_() for n, w in g.items()}
             for k, g in init.items()}
        loss = xvector_loss(cfg, p, torch.from_numpy(feats).to(d),
                            torch.from_numpy(labels).to(d))
        loss.backward()
        small[tag] = (float(loss.detach()),
                      {f"{k}/{n}": w.grad.cpu().numpy()
                       for k, g in p.items() for n, w in g.items()})
    np.testing.assert_allclose(small["card"][0], small["cpu"][0],
                               rtol=SMALL_RTOL, err_msg="x-vector loss")
    worst = 0.0
    for k, ref in small["cpu"][1].items():
        got = small["card"][1][k]
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=SMALL_RTOL,
                                   atol=SMALL_RTOL * scale, err_msg=k)
        worst = max(worst, float(np.abs(got - ref).max()) / scale)

    adam_worst = {}
    for wd in (0.0, 1e-2):
        state = {}
        for tag, d in (("cpu", torch.device("cpu")), ("card", dev)):
            p = {k: {n: w.detach().clone().to(d) for n, w in g.items()}
                 for k, g in init.items()}
            opt = init_adam_state(p)
            for grads in (small["cpu"][1], small["card"][1]):
                p, opt = adam_update(
                    p, {k: {n: torch.from_numpy(grads[f"{k}/{n}"]).to(d)
                            for n in g} for k, g in p.items()},
                    opt, 1e-3, weight_decay=wd)
            if int(opt["step"]) != 2:
                raise AssertionError(f"adam_update on {tag}: step "
                                     f"{int(opt['step'])}")
            state[tag] = {f"{what}/{k}/{n}": w.cpu().numpy()
                          for what, tree in (("w", p), ("m", opt["m"]),
                                             ("v", opt["v"]))
                          for k, g in tree.items() for n, w in g.items()}
        adam_worst[str(wd)] = 0.0
        for k, ref in state["cpu"].items():
            got = state["card"][k]
            scale = float(np.abs(ref).max()) or 1.0
            np.testing.assert_allclose(got, ref, rtol=SMALL_RTOL,
                                       atol=SMALL_RTOL * scale,
                                       err_msg=f"adam_update wd {wd}: {k}")
            adam_worst[str(wd)] = max(adam_worst[str(wd)],
                                      float(np.abs(got - ref).max()) / scale)

    res, _, s, _ = run_tool(xvectortrain, [], "xvectortrain", totals)
    if not res["ok"]:
        raise AssertionError(f"tools.xvectortrain: {res}")
    phase("xvector", card=card(), parameters=n_params, B=XV_B, T=XV_T,
          speakers=XV_SPEAKERS, steps=XV_STEPS,
          eval_loss={"before": eval_before, "after": eval_after},
          eval_forward_256=fwd,
          losses=losses,
          step_ms=float(np.mean(ms)), step_ms_each=ms,
          max_memory_allocated_bytes=peak,
          card_vs_cpu={"B": XV_SMALL_B, "loss": small["card"][0],
                       "loss_rel_diff": abs(small["card"][0]
                                            - small["cpu"][0])
                       / abs(small["cpu"][0]),
                       "grad_max_abs_diff_over_max": worst,
                       "adam_2_steps_max_abs_diff_over_max": adam_worst},
          xvectortrain={k: v for k, v in res.items() if k != "losses"},
          xvectortrain_seconds=s)


def remat_phase(dev, graph, totals):
    """bench.py's step at flagship width (B = 128, T_in = 150, the default
    den: the fused scans) with remat off and on, from the same weights,
    batch and SpecAugment generator, REMAT_STEPS steps each, cuDNN
    deterministic: losses, grad norms and parameters at the JAX bars, the
    generator's state and the BN buffers equal, 1 + 1 den_scan launches
    per step; peak memory and step ms of each (the recompute rebuilds the
    activations in the backward, so the peak need not fall)."""
    rng = np.random.default_rng(0)
    model = build_model(FLAGSHIP)
    den = DenominatorComputation(graph, leaky=1e-5, device=dev)
    num_graph = bench_num_graph(B, T_OUT, AN, P, rng)
    batch = {
        "features": torch.from_numpy(
            rng.normal(size=(B, T_IN, 40)).astype(np.float32)).to(dev),
        "ivectors": torch.from_numpy(
            rng.normal(size=(B, 100)).astype(np.float32)).to(dev),
        "weights": torch.ones(B, device=dev),
    }
    runs = {}
    zero_launches()
    with train_tool.deterministic_cudnn():
        for remat in (False, True):
            config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                                 frame_subsampling_factor=STRIDE,
                                 left_context=LEFT, remat=remat)
            net, opt, scale = init_train_state(
                model, torch.Generator().manual_seed(0), config, dev)
            step = make_train_step(model, net, den, num_graph,
                                   ChainTrainingOpts(), config,
                                   num_frames_out=T_OUT)
            gen = torch.Generator(device=dev).manual_seed(1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs, ms = [], []
            for _ in range(REMAT_STEPS):
                before = den_scan.fused_forward.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                opt, scale, out = step(opt, scale, batch, generator=gen)
                end.record()
                end.synchronize()
                if den_scan.fused_forward.launches - before != 1:
                    raise AssertionError("a remat-phase step did not take "
                                         "the fused scans")
                outs.append(out)
                ms.append(start.elapsed_time(end))
            runs[remat] = {
                "loss": [float(o.loss) for o in outs],
                "grad_norm": [float(o.grad_norm) for o in outs],
                "ok": all(bool(o.ok) and not bool(o.skipped) for o in outs),
                "params": {k: v.detach().cpu().numpy().copy()
                           for k, v in net.state_dict().items()},
                "generator": gen.get_state().clone(),
                "step_ms": ms,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
            del net, opt, step
            torch.cuda.empty_cache()
    launches = kernel_launches()
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n
    if launches["den_scan_fwd"] != 2 * REMAT_STEPS or \
            launches["den_scan_bwd"] != 2 * REMAT_STEPS:
        raise AssertionError(f"remat phase launches {launches}")
    plain, remat = runs[False], runs[True]
    if not (plain["ok"] and remat["ok"]):
        raise AssertionError("a remat-phase step was skipped or not ok")
    np.testing.assert_allclose(remat["loss"], plain["loss"],
                               rtol=REMAT_LOSS_RTOL, err_msg="remat loss")
    np.testing.assert_allclose(remat["grad_norm"], plain["grad_norm"],
                               rtol=REMAT_GRAD_RTOL,
                               err_msg="remat grad_norm")
    bn = [k for k in plain["params"]
          if k.rsplit(".", 1)[-1] in ("count", "mean", "var")]
    worst = 0.0
    for k, v in plain["params"].items():
        np.testing.assert_allclose(remat["params"][k], v, **REMAT_PARAMS,
                                   err_msg=f"remat {k}")
        worst = max(worst, float(np.abs(remat["params"][k] - v).max()))
    if not all(np.array_equal(remat["params"][k], plain["params"][k])
               for k in bn):
        raise AssertionError("remat changed the BN buffers")
    if not torch.equal(plain["generator"], remat["generator"]):
        raise AssertionError("remat left the SpecAugment generator in "
                             "another state")
    phase("remat", card=card(), B=B, T_in=T_IN, steps=REMAT_STEPS,
          losses=plain["loss"], grad_norms=plain["grad_norm"],
          remat_losses=remat["loss"], param_max_abs_diff=worst,
          bit_identical=all(np.array_equal(remat["params"][k], v)
                            for k, v in plain["params"].items()),
          bn_buffers_equal=True, generator_state_equal=True,
          step_ms={"plain": plain["step_ms"], "remat": remat["step_ms"]},
          max_memory_allocated_bytes={
              "plain": plain["max_memory_allocated_bytes"],
              "remat": remat["max_memory_allocated_bytes"]},
          launches=launches)


# profile_step's variants that run the den (its fused scans: one forward
# and one backward launch per step) and those that do not
PROFILE_STEP_ITERS = 5
DEN_VARIANTS = ("full", "no-num", "lean")


def profile_step_run(tool, totals):
    """tools.profile_step at bench.py's geometry (B = 128, T_in = 150,
    P = 3080), --iters 5 --lean: 1 + 1 den_scan launches per step in
    full, no-num and lean and none in no-den, no-chain and fwd-only, the
    fused scans in full, and a finite loss (fwd-only: output sum) in every
    variant.  Returns each variant's wall and device ms, launches and
    value, and the attribution; no ordering of times is asserted (the step
    is host-bound)."""
    res, text, s, n = run_tool(tool, ["--iters", str(PROFILE_STEP_ITERS),
                                      "--lean"], "profile_step", totals)
    if set(res) != {"full", "no-den", "no-num", "no-chain", "fwd-only",
                    "lean"}:
        raise AssertionError(f"profile_step variants {sorted(res)}")
    steps = PROFILE_STEP_ITERS + 1                  # with the warm-up
    for name, r in res.items():
        want = steps if name in DEN_VARIANTS else 0
        got = (r["launches"]["den_scan_fwd"], r["launches"]["den_scan_bwd"])
        if got != (want, want):
            raise AssertionError(f"profile_step {name}: den_scan launches "
                                 f"{got}, want {(want, want)}")
        value = r["output_sum" if name == "fwd-only" else "loss"]
        if not math.isfinite(value):
            raise AssertionError(f"profile_step {name}: value {value}")
    if res["full"]["scan_used"] != "fused":
        raise AssertionError(f"profile_step full: {res['full']}")
    line = json.loads(text.strip().splitlines()[-1])
    return {"variants": res, "attribution": line["attribution"],
            "seconds": s, "launches": n}


def measure_phase(egs_dir, totals):
    """The measurement twins in this process: trainbench at B = 128
    (plain, --remat, --natural-gradient; 5 iterations) and with the random
    topology (the blocked den, the segment_reduce kernel) at its default
    batch; roofline at B = 128 on every stage (no share over 100 %);
    scalebench at worlds 1 and 2 on the card (NCCL, then two gloo ranks
    sharing it); profile_host on the egs phase's files with --place;
    profile_latdecode at its defaults; profile_den --impls
    high,pallas,fused; profile_step, the in-context ablation of bench.py's
    step, at the JAX tool's defaults with --iters 5 --lean; one trainbench
    step inside utils.profiling.trace, whose Chrome trace must name the
    den_scan kernels."""
    from kaldi_fp16_tpu_torch.tools import (
        profile_den, profile_host, profile_latdecode, profile_step,
        roofline, scalebench, trainbench,
    )
    out = {}
    for tag, extra in (("plain", []), ("remat", ["--remat"]),
                       ("natural_gradient", ["--natural-gradient"])):
        res, _, s, n = run_tool(trainbench, ["--batch", str(B), "--iters",
                                             "5"] + extra,
                                f"trainbench_{tag}", totals)
        if res["detail"]["scan_used"] != "fused" or not n["den_scan_fwd"]:
            raise AssertionError(f"trainbench {tag}: {res['detail']}, {n}")
        out[f"trainbench_{tag}"] = {**res, "seconds": s, "launches": n}
    res, _, s, n = run_tool(trainbench, ["--topology", "random"],
                            "trainbench_random", totals)
    if res["detail"]["posterior_reduce"] != "kernel" or \
            not n["segment_reduce"]:
        raise AssertionError(f"trainbench random: {res['detail']}, {n}")
    out["trainbench_random"] = {**res, "seconds": s, "launches": n}
    res, _, s, n = run_tool(roofline, ["--batch", str(B)], "roofline",
                            totals)
    out["roofline"] = {"rows": res["rows"], "seconds": s}
    res, _, s, _ = run_tool(scalebench, ["--worlds", "1,2"], "scalebench",
                            totals)
    ranks = [(p["devices"], p["backend"], p["device"].split(":")[0])
             for p in res["points"]]
    if ranks != [(1, "nccl", "cuda"), (2, "gloo", "cuda")]:
        raise AssertionError(f"scalebench: worlds, backends, devices "
                             f"{ranks}")
    out["scalebench"] = {**res, "seconds": s}
    res, _, s, _ = run_tool(profile_host, [
        "--egs-dir", str(egs_dir), "--batch", str(B), "--frames-in",
        str(EGS_T_IN), "--frames-out", str(EGS_T_OUT), "--pdfs", str(P),
        "--place"], "profile_host", totals)
    out["profile_host"] = {**res, "seconds": s}
    res, _, s, _ = run_tool(profile_latdecode, [], "profile_latdecode",
                            totals)
    out["profile_latdecode"] = {**res, "seconds": s}
    res, _, s, n = run_tool(profile_den, ["--impls", "high,pallas,fused"],
                            "profile_den", totals)
    out["profile_den"] = {**res, "seconds": s, "launches": n}
    out["profile_step"] = profile_step_run(profile_step, totals)

    logdir = MEASURE / "trace"
    with trace(str(logdir)):
        res, _, _, n = run_tool(trainbench, ["--batch", str(B), "--iters",
                                             "1"], "trainbench_traced",
                                totals)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    missing = [k for k in SCAN_KERNEL_NAMES
               if not any(k in name for name in names)]
    if missing:
        raise AssertionError(f"the trace names no {missing}")
    out["trace"] = {"events": len(events), "scan_kernels_named":
                    list(SCAN_KERNEL_NAMES), "launches": n,
                    "bytes": (logdir / "trace.json").stat().st_size}
    phase("measure", card=card(), **out)


def main():
    dev = device_phase()
    build_phase()
    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(num_pdfs=P), P)
    layout = analyze_chain_structure(graph)
    if layout is None or layout.F != 3526 or graph.num_states != 7052:
        raise AssertionError("phone-LM den graph did not decompose as "
                             "expected (7052 states, F=3526)")
    k = kernel_phase(dev, layout)
    scan = scan_kernels_phase(dev, graph)
    den, pre_launches = den_phase(dev, graph)
    lp_s, post_s, den_f = den_fused_phase(dev, graph, den)
    red_launches, den_b = den_blocked_phase(dev, graph, lp_s, post_s)
    del lp_s, post_s
    red = segment_reduce_phase(dev, den_b)
    del den_b
    small_step_phase(dev)
    launches, losses, _ = train_phase(dev, den, "train",
                                   {"den_matmul": DenMatmul},
                                   {"den_matmul": 2 * T_OUT})
    scan_counts = {"den_scan_fwd": den_scan.fused_forward,
                   "den_scan_bwd": den_scan.fused_backward,
                   "den_matmul": DenMatmul}
    fused_launches, fused_losses, fused = train_phase(
        dev, den_f, "train_fused", scan_counts,
        {"den_scan_fwd": 1, "den_scan_bwd": 1, "den_matmul": 0},
        check_den=den)
    # same seeds, weights, batch and SpecAugment generator as "train"
    np.testing.assert_allclose(fused_losses[0], losses[0], rtol=SMALL_RTOL,
                               err_msg="first loss, fused vs loop den")
    ng_vs_cpu_phase(dev, den_f)
    del den_f
    egs_dir, egs_graph = egs_phase()
    _, den_check, trainer_ref = trainer_phase(egs_dir, egs_graph, dev)
    dp_launches, dryrun_8 = data_parallel_phase(egs_dir, graph, trainer_ref,
                                                dev)
    msp_launches = model_seq_parallel_phase(dev, graph, dryrun_8)
    hclg_graph, hclg_ll, hclg_offline = decode_hclg_phase(dev)
    layouts = decode_layouts_phase(dev, hclg_graph, hclg_ll, hclg_offline)
    decode_parallel_phase(dev, hclg_ll, hclg_offline, layouts)
    del layouts
    decode_tool_phase(egs_dir)
    kaldi_model_phase(egs_dir, dev)
    stream_decode_phase(dev, hclg_graph, hclg_ll, hclg_offline)
    del hclg_graph, hclg_ll, hclg_offline
    torch.cuda.empty_cache()
    stream_encode_phase(dev)
    att_launches = attention_phase(dev, graph, fused)
    sw_launches, sw_err = synthwer_phase(dev)
    tools = {}          # the launches of the tool and side-stack phases
    verify_chain_phase(egs_dir, tools)
    verify_net_phase(tools)
    verify_train_phase(egs_dir, tools)
    verify_data_phase(egs_dir, tools)
    xvector_phase(dev, tools)
    remat_phase(dev, graph, tools)
    measure_phase(egs_dir, tools)
    src = "kaldi_fp16_tpu_torch/csrc/"
    F, n = k["F"], k["n"]
    mm_io = 4 * 2 * F * n                     # v read, out written
    mm_flops = 6 * 2 * F * F * n              # six bf16 products
    mm_bound = {"kernel": bound(4 * F * F + mm_io, mm_flops),
                "pre": bound(3 * 2 * F * F + mm_io, mm_flops)}

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              library_ms):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    print(json.dumps({"kernels": [
        entry("den_matmul", "den_matmul.cu", KERNEL_REPLACES,
              launches["den_matmul"] + sw_launches + tools["den_matmul"]
              + msp_launches["den_matmul"],
              max(k["kernel_max_abs_err_vs_plain"], sw_err),
              k["kernel_kernel_us"] / 1e3, k["kernel_plain_us"] / 1e3,
              mm_bound["kernel"], k["kernel_library_us"] / 1e3),
        entry("den_matmul_pre", "den_matmul.cu", PRE_REPLACES,
              pre_launches + tools["den_matmul_pre"],
              k["pre_max_abs_err_vs_plain"], k["pre_kernel_us"] / 1e3,
              k["pre_plain_us"] / 1e3, mm_bound["pre"],
              k["pre_library_us"] / 1e3),
        entry("den_scan_fwd", "den_scan.cu", SCAN_REPLACES["fwd"],
              fused_launches["den_scan_fwd"] + dp_launches["den_scan_fwd"]
              + msp_launches["den_scan_fwd"] + att_launches["den_scan_fwd"]
              + tools["den_scan_fwd"],
              max(v for errs in (scan["kernel_max_abs_err"],
                                 den_check["scan_max_abs_err"])
                  for n, v in errs.items() if n != "beta_hist"),
              scan["kernel_fwd_ms"], scan["kernel_fwd_plain_ms"],
              scan["fwd_bound"], None),
        entry("den_scan_bwd", "den_scan.cu", SCAN_REPLACES["bwd"],
              fused_launches["den_scan_bwd"] + dp_launches["den_scan_bwd"]
              + msp_launches["den_scan_bwd"] + att_launches["den_scan_bwd"]
              + tools["den_scan_bwd"],
              max(scan["kernel_max_abs_err"]["beta_hist"],
                  den_check["scan_max_abs_err"]["beta_hist"]),
              scan["kernel_bwd_ms"], scan["kernel_bwd_plain_ms"],
              scan["bwd_bound"], None),
        entry("segment_reduce", "segment_reduce.cu", REDUCE_REPLACES,
              red_launches + tools["segment_reduce"]
              + msp_launches["segment_reduce"], red["max_abs_err"],
              red["sorted"]["ms"],
              red["sorted"]["plain_ms"], red["sorted"]["bound"],
              red["sorted"]["library_ms"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
