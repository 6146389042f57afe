#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on a miss:
  1. device   a CUDA device is required; prints nvidia-smi's name and power limit
  2. build    nvcc builds csrc/bp_wmajor.cu, csrc/bp_exact.cu,
              csrc/bp_wide.cu, csrc/bp_study.cu, csrc/bp_study_ms.cu,
              csrc/dsp_loops.cu and csrc/pfb_track.cu, in parallel, into
              gr_ldpc_ece535a_torch/_build/; prints ptxas's summary and the
              tracker kernel's launch at the chain's composed shape and on
              an app segment (C CTAs a cluster, threads, shared memory,
              and cudaOccupancyMaxActiveClusters,
              which must be at least 1), the library's geometry held to
              ops/cuda_dsp.py's mirror; reads each loop kernel's
              recurrence off its SASS (tools/issue_model.py loop_chain: the
              least chain of dependent instructions a sample over the paths
              through the loop, 4 cycles a link; the Costas loop runs four
              samples an iteration); counts
              each study kernel's static SASS instructions (cuobjdump) and
              fails unless every unrolled instance has more than its
              unroll-1 sibling; the SASS of the w-major SPA kernels'
              log tanh(x/2) (bp_phi_probe) by pipe, and of each function of
              the study's check steps (bp_study's probe kernels: on the
              MUFU, no call, its log_tanh_half the shipped one's SASS); every
              study instance's registers, spills and blocks an SM beside the
              shipped tile SPA's, every min-sum study instance's beside the
              shipped tile min-sum's, and every shipped SPA kernel's
              registers and spills held to SHIPPED_SPA_PTXAS, every shipped
              min-sum kernel's (the tile and large-code min-sum, which take
              their check step from csrc/minsum.cuh, the header the min-sum
              study shares) to SHIPPED_MS_PTXAS; how many blocks of
              each w-major tile and of the exact kernels an SM holds
              (occupancy); for block_32_64, sim_50_100 and gen_200_400, the
              instance the tile and exact kernels take (a register tier or
              the table route: the library's dispatch must agree with
              cuda_bp.tier), with its registers, spills and blocks an SM;
              the 28 wide kernels' registers and spills (bp_wide<WR,
              method, state in shared or device memory>)
  phi      the SPA kernels' log tanh(x/2) alone on the card, on 10^5 points
              in [2^-20, 40] and at 0, 1e-30, 87, 88, 1e30, inf and NaN,
              against float64: |error| <= max(2^-16 |phi|, 2^-20), beside
              the error of libm's f32 logf(tanhf); each MUFU function of the
              study's check steps (csrc/bp_study.cu: the explog log tanh,
              tanh(x/2), log((1+T)/(1-T)), log1p(T) - log1p(-T)) at the same
              bar on its domain, infinities and NaN exactly, a subnormal
              argument as 0, and the study's log_tanh_half bit for bit the
              shipped one
  3. kernels  each CUDA kernel against its plain PyTorch version on the same
              rx: the tile kernels at 131,072 codewords, Eb/N0 4 dB, 20
              iterations, both methods x both modes x both forms, plus edge
              cases; the tile SPA against the f32 path of ops/decode.py
              under early exit (no two different valid codewords); the
              exact kernels there (0 mismatching frames) and
              against the f32 path of ops/decode.py; the tile and exact
              min-sum kernels at block_32_64, sim_50_100 (register tiers)
              and gen_200_400 (the table route) at 1, 5 and 20 iterations
              on 4 dB, tied-minima (rx on a 0.5 grid), all-zero, half-zero,
              +-30 x codeword and +-inf/NaN inputs (0 mismatching frames); the large-code kernels
              on gen_256_512 and gen_320_640, and the large min-sum on the
              zero and +-30 x codeword inputs there; each sweep step's
              decoder on the rx that step draws, at the shapes of the
              sweeps of phase 4 (sim_50_100 125,000 x 5, gen_256_512
              131,072 x 20, early exit), and the step's counts (its first
              call eager, then CUDA graph replays) against count_errors;
              impl="split" against the tile; every study instance at
              131,072 x 20 against its IEEE plain version: 0 mismatching
              frames for study_phi_libm (the libm phi the shipped SPA had
              before its SFU check step) and the instances with no
              transcendental, the fixed contract below for every MUFU
              instance, and at 2, 5 and 20 steps at most
              cuda_study.MIRROR_MAX_SHARE of its frames (8 of 131,072) off
              its plain version on the
              kernels' own algorithms, a bar that must lie under half the
              rounding forms' distance from the shipped SPA; study_phi against
              the shipped tile SPA (0: it is that kernel's fixed form), the
              study variants whose arithmetic is study_phi's (or explog's)
              against it (0), and study_phi_libm against the shipped kernel
              (the fixed contract); every study instance at 0 and 1 step and
              on a saturating rx against its plain version on the kernels'
              algorithms (0), and the SPA aggregation-precision instances'
              agreement with the shipped precise SPA (>= 99% for the bf16
              and hi/lo phi forms); every min-sum
              study instance likewise, also at 2 and 19 steps and at an odd
              B (4,097 and 31 frames), study_ms_ref against the shipped
              precise min-sum (0), and the bf16-aggregation instances'
              agreement with it (>= 99%); the ten instances of the loop-unroll
              study (proto_r3c, proto_r4) also at 0, 1, 2 and 5 steps and on
              the saturating rx (the SPA forms at 2 and 5 steps under the
              fixed contract and the mirror bar), each unrolled instance
              against its unroll-1
              sibling at 131,072 x 20 (0 mismatching frames each), and the
              textbook SPA's agreement and frame error share against the sent
              codewords beside the shipped SPA's (no bar).
              The streaming blocks' loop kernels (csrc/dsp_loops.cu,
              tools/dsp_loops_check.py): the AGC on 16,391 samples (four
              whole 4,096-sample tiles and 7) of an impaired stream (BPSK,
              1e-3 cycles/sample carrier offset, noise 0.05, gain 2.5),
              which takes its scan route (agc_scan, and agc_loop never),
              and costas_loop on its output, each against its plain version
              on the card (a launch per torch operation and sample): the
              Costas kernel's output and final state bit for bit, the
              scan's within 1e-5 relative a sample and 1e-6 on the gain,
              and the same bits on two runs; pieces of 7, 4,096, 4,097 and
              8,191 samples, each from the last one's state, against the
              one call (the same bars); the AGC's serial route (agc_loop)
              on an inf sample, an 8-sample burst with rate*|x| > 1 and a
              gain of -0.5, each launching it once and bit for bit with the
              plain version; the Costas kernel's phase wrap against fmodf
              with the sign fix on every float in [-2 pi, 4 pi), and its
              sincosf against sinf and cosf on every float in [-pi, pi],
              with every infinity and NaN: 0 mismatches each; at the
              flowgraph path's shapes see phase 4's leg (c).
              The clock tracker's kernel (csrc/pfb_track.cu,
              tools/pfb_track_check.py) against its plain version on the
              card, one block a call from the plain version's state along
              its trajectory, on the chain's stream after its block AGC,
              CFO estimate and mix (2^21 samples): 64 blocks each at 64
              symbols (rate clip 0.002), 2,048 and 8,192 (2.5e-4); symbols
              within 1e-5, rate within 1e-6, ibase equal, frac within one
              float32 step of the block advance; the same at 64 symbols on
              the stream with a NaN and an inf sample (NaN where the plain
              version's is), and a stream with no whole block (no launch,
              the acquired state); at the main path's shapes, one launch
              over the chain's composed stream (2^24 samples, 1,022 blocks
              of 8,192) and over one DSP-flowgraph segment (126 blocks of
              64) bit for bit the kernel run one block a call from its own
              returned state (symbols and final state); at each cluster
              size (C = 1, 2, 4, 8, 16: 64 to 8,192 symbols a block) the
              same two bars over 16 blocks; one launch over the 64 blocks
              against the plain version's run printed (no bar).
              The w-major kernels against their plain versions: identical
              decisions (min-sum, every comparison), or (SPA, whose log tanh
              runs on the SFU) the precise contracts: early exit at most
              0.1% of frames mismatched and none two different valid
              codewords; fixed iterations at least 99% frame agreement and
              syndrome-success shares within 1%. At the early-exit shapes
              of MIRROR_WITNESS (large codes, 1-2 dB), where two decoders
              whose phi differs in the last bits may each reach a different
              codeword that satisfies H, the two-valid bar gives way: the
              kernel keeps the 0.1% bar against the plain version and the
              whole precise contract against the plain decoder on its own
              log tanh algorithm in IEEE f32 (cuda_bp.log_tanh_half_mirror),
              which must decide each two-valid frame as the kernel does;
              printed there, no bar: of the two-valid frames, how many have
              the kernel and how many the plain version on the sent codeword.
              The wide kernels (csrc/bp_wide.cu, tools/wide_check.py) at
              sim_80211n_1944.bp's step, ieee80211n_1944_r12 131,072 x 20
              at 1.0, 1.5 and 2.0 dB, both methods, early exit on and off:
              the precise contract against their plain versions, and for
              the SPA against the plain decoder on its own log tanh
              algorithm (no frame on two different valid codewords)
  4. paths    each path driven with the launch counts set to 0 just before
              it and read just after; each must launch its kernels:
                forward   entry()'s forward (sum-product) and make_decoder(
                          min-sum, backend="auto") at 131,072 frames, 5 dB
                sweep     run_waterfall("sim_50_100"), the reference
                          experiment at 10^6 frames a point, held within
                          binomial bands of the committed JAX curve; and a
                          gen_256_512 sweep on the large-code kernels (its
                          steps replay the graphs phase 3 captured, and the
                          replays count the launches); and an
                          ieee80211n_1944_r12 sweep on the wide kernels
                          (2 points x 262,144 frames, 20 iterations)
                anchor    tools/anchor.py: that sim_50_100 result against
                          the reference binary ldpc_lapack's committed run
                          (results/reference_lapack_run.json), and
                          run_waterfall("sim_8_16") on ldpc_umfpack's 29
                          points, 10^5 frames a point, 5 iterations, hard,
                          bitflip_mp and min-sum, against its run
                          (reference_umfpack_run.json): at each point the
                          detected FER inside the 99.9% Clopper-Pearson
                          band of the 30-frame count, at most 2 points of
                          a record outside; the violations printed by
                          method
                decode    cuda_decode_*(rx, code) with its default mode,
                          "exact", on the forward's rx
                receive   StreamReceiver.receive at bench.py's receiver
                          shape (block_32_64, 2^19 frames, offset 17,
                          inverted, 6 dB; min-sum and sum-product, 5
                          iterations, early exit, kernel_mode "fast"): the
                          8-chunk pipeline, the two-phase path with
                          weights, receive_dispatch of two segments and
                          receive_collect_many, and 2 stream shards on the
                          card; each must lock at (17, inverted), all give
                          the same frames, accepts and bytes, which are the
                          body kernel's decisions; the kernel against its
                          plain version (min-sum identical, SPA the precise
                          early-exit contract) and against the f32 path
                          (the precise early-exit contract), on the frames
                          cut at the lock (tools/receive_check.py); then
                          entry.dryrun_multichip(4) on the card
                flowgraph the port's blocks (tools/flowgraph_check.py):
                          (a) the image loopback, a 512 x 512 RGB BMP of
                          seed 0 padded to whole frames, FileSource(repeats
                          3) -> LdpcEncoderBlock -> ChannelModelBlock(
                          noise_voltage 0.0631, phase_offset pi) ->
                          LdpcDecoderBlock(method 0 and 1, 5 iterations) ->
                          ImageSink on the card, 589,866 frames a method:
                          every image written equal to the BMP, at least
                          two, the decoder locked inverted, bp_minsum
                          launched under method 0 and bp_sumproduct under 1;
                          (b) 131,072 frames of random bytes through the
                          encoder block and AwgnBlock(6 dB), with a 17-symbol
                          junk prefix, negated, a burst of 12 random-symbol
                          frames at the middle, from a complex64 file
                          through the decoder block on the card and on the
                          CPU (plain versions): the same sync log, with a
                          fall-out and a relock; min-sum identical bytes,
                          sum-product the precise early-exit contract on
                          the frames emitted; (c) examples/example4_full.yaml
                          through load_flowgraph(..., "cuda"), the
                          reference's flagship receiver (encoder, RRC at 2
                          samples a symbol, a channel with a 0.01
                          cycles/sample carrier offset and 50 ppm clock
                          drift, AGC, the FLL role, the clock tracker,
                          Costas, decoder, image and plot sinks into a
                          temporary directory), its source the RGB BMP of
                          seed 0 sent three times, 128 x 128 under method 0
                          (its own, min-sum) and 64 x 64 under method 1: the
                          decoder locks, at least one image written equals
                          the BMP byte for byte, agc_scan, costas_loop and
                          the method's BP kernel launch, agc_loop does not
                          (every AGC chunk takes the scan), and pfb_track
                          once a 16,384-sample segment; after the
                          counts are read, each chunk the AGC and Costas
                          blocks got there (the lengths the path gives,
                          not whole tiles) is held at its own shape: the
                          kernel over it gives the block's output, its
                          first 16,384 samples the plain version's, and the
                          chunk cut 7 samples into its last tile, the two
                          calls give the one call's output and state and
                          the partial tile after the cut the plain
                          version's from the state at the cut (bit for bit
                          for Costas, the scan's bars for the AGC, which
                          must take the scan every call); examples/
                          example2.yaml and example3.yaml on the card and on
                          the CPU at tests/test_graphcfg.py's bars
                chain     the receive DSP chain (tools/chain_check.py): a
                          raw sample stream of random bytes of block_32_64
                          (encode, RRC pulse shaping at 2 samples a symbol,
                          45 taps, fractional_resample(1 + 50e-6),
                          mix(-0.01), noise 0.05 from a seeded generator),
                          all on the card, 131,072 frames through
                          rx_chain_pairs with timing "track" (blocks of
                          8,192 symbols, rate clip 2.5e-4) and "ff", and
                          8,192 frames with the app's default (blocks of
                          64), the tracker's block loop the pfb_track
                          kernel (it must launch); each into
                          StreamReceiver.receive, min-sum
                          and sum-product, 5 iterations: each must lock,
                          recover at least 99% of the sent frames, and
                          emit every frame with its sent bytes (lost frames
                          printed); its payload must be its body decoder's
                          decisions on the frames cut at the lock, and the
                          kernel its plain version's (min-sum identical,
                          SPA the precise early-exit contract); the
                          8,192-frame stream also through the chain and
                          the receive on the CPU: the same lock, frames,
                          accepts and bytes as on the card
                agc edge  the AGC block (blocks/dsp.py AgcBlock2) on the
                          card fed each of the three serial-route inputs:
                          agc_loop must launch once each, and the block's
                          output is the public function's on the card
                parity    tools/parity_f64.py on one batch (block_32_64,
                          131,072 frames of seed 1000, 4 dB, 20
                          iterations, early exit), both methods: the f32
                          path, the tile kernel and its plain version on
                          the card, and the C++ float64 oracle on the
                          host's cores; each path's mismatched share
                          against the oracle, and the kernel's against the
                          f32 path, at most 1e-3; the min-sum kernel the
                          same decisions as its plain version, the SPA
                          kernel none two valid codewords apart from it;
                          each frame on two different valid codewords in
                          any pair diagnosed (tools/twovalid.py) and a
                          boundary frame: its 64 perturbations of 1e-6
                          land on at least two words
                study     the main() of each study script under
                          gr_ldpc_ece535a_torch/tools/ (ablate_pallas,
                          proto_r3b, proto_r4b; fast_kernel_proto, proto_r2,
                          proto_r3 and its main_v2, each of the last three
                          with its sum-product and min-sum kinds; proto_r3c
                          and proto_r4, the loop-unroll study) at
                          131,072 x 20, 4 dB; each times its variants'
                          kernels and plain versions
  5. times    CUDA-event times of kernel and plain version (the wide kernels
              at 131,072 x 20 on ieee80211n_1944_r12, fixed and early exit,
              the plain version's fixed form once), host-clock time of
              the whole forward and of each sweep point; the large-code
              kernels' early exit at the gen_256_512 sweep's shape; the tile
              SPA against study_phi (within STUDY_PHI_TIME of it),
              study_phi_libm and study_stub, interleaved; the tile min-sum
              against study_ms_ref (within STUDY_MS_REF_TIME of it),
              study_ms_stub_check and study_ms_stub_mm, interleaved; each
              SPA kernel's
              MUFU floor (sfu_ms) at the SM clock it ran at, each SPA study
              instance's at the clock the study's instances hold in turn
              back to back, and the exact SPA's MUFU and issue floors of its
              tanhf, division and logf (tools/issue_model.py exact_mix); the
              studies' tables (every SPA row also as a ratio to study_phi,
              beside its MUFU floor; every min-sum row as a ratio to
              study_ms_ref, beside its shared-memory floor, registers,
              spills and blocks an SM);
              the unroll table: each unrolled instance timed against its
              unroll-1 sibling in one interleaved run, with its SASS count,
              registers and spills; the receive's wall by host clock
              (median of 5 after a warm-up), its profiled split and info
              bits/s, and its body kernel on one chunk and on the whole
              body by CUDA events; the flowgraph path's image loopback (its
              phase 4 runs): wall and info bits/s by host clock, the
              decoder block's work() calls by host clock, and its kernel
              alone on the batches it decoded by CUDA events
              (flowgraph_check.kernel_ms); leg (b)'s two runs by host clock;
              leg (c)'s wall and info bits/s sent by host clock, each DSP
              block's and the decoder block's work() by host clock, and the
              decoder's kernel on its batches by CUDA events; the three
              loop kernels (the AGC's scan and serial routes, the Costas
              loop) and their plain versions by CUDA events on the
              16,391-sample stream, and each kernel alone on 2^21 samples
              (the size of leg (c)'s chunks), beside their HBM bound
              (tools/_timing.py loop_bound_ms, 16 bytes a sample) and the
              serial kernels' floor (phase 2's chain, at the SM clock each
              held back to back); the tracker's kernel and its plain
              version by CUDA events at the chain's composed shape (2^24
              samples, 1,022 blocks of 8,192) and on one 16,384-sample
              segment of 64-symbol blocks, beside its bound
              (tools/_timing.py track_bound_ms), its one-SM floor (its
              FMAs at 128 a clock, at the SM clock it held back to back)
              and its C-SM floor (the one-SM floor over the cluster's C);
              the chain path's stages by CUDA events (block AGC, CFO, mix,
              the tracker in all and a block, V&V) in its three settings,
              the chain's samples a second by timing block (256-8,192, on
              the 8,192-frame stream; the composed setting on the
              131,072-frame one), and the chain with the receive by host
              clock (median and spread of 5) in info bits a second
Each kernel's record carries its bound: the larger of its bytes (rx read
once, decisions written once) over HBM_BYTES_S and its f32 operations
(tools/_timing.py OPS_PER_EDGE) over F32_OPS_S, at the shape it was timed;
the two w-major SPA records also carry sfu_ms: the MUFU instructions of
their log tanh (counted in its SASS), two an edge and check step, at 16 a
clock an SM, and so does every SPA study instance's (its check step's
functions, counted in their probes' SASS, tools/issue_model.py
study_sfu_ms); the exact SPA's sfu_ms and issue_ms are the MUFU and all
instructions of its tanhf, IEEE division and logf, once an edge and
iteration, at 16 MUFU and 4 issues a clock an SM; each min-sum record
carries smem_ms: its shared-memory wavefronts (tools/issue_model.py
minsum_wavefronts, exact_minsum_wavefronts; a register tier reads no table
and no -rx) at one a clock an SM, at the SM clock the kernel holds, and so
does every min-sum study instance's (the shipped tile min-sum's two frames
a thread at the instance's own message bytes, cuda_study_ms.message_bytes).
The loop kernels' records carry their times on 2^21 samples (path_ms),
their public function's call beside the kernel (call_ms, path_call_ms) and
the launches on each path that drives them; the serial ones
serial_ms, their serial floor; the
tracker's carries sm_floor_ms, cluster_floor_ms (over its C CTAs) and its
times on one app segment. The
line before the last is the kernels' JSON record, the one before it the
card's name and power limit; the last line is the JSON result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 131072
ITERATIONS = 20
PARITY_EBN0_DB = 4.0           # bench.py's parity point
EE_MAX_MISMATCH = 0.001        # early exit: mismatched frame share
FIXED_MIN_AGREE = 0.99         # fixed iterations: frame agreement
FIXED_MAX_SUCC_GAP = 0.01      # fixed iterations: syndrome-success share gap
FER_MAX = {"sumproduct": 0.03, "minsum": 0.005}   # payload frames, 5 dB
EXACT_MIN_AGREE = 0.999        # exact kernel vs the f32 path: frame agreement
STUDY_PHI_TIME = 0.02          # study_phi vs the shipped tile SPA, interleaved
STUDY_MS_REF_TIME = 0.02       # study_ms_ref vs the shipped tile min-sum, too
# the shipped SPA kernels (their check step from csrc/sfu.cuh, the header
# the study shares): ptxas's registers and spill store/load bytes a row
# weight, as CUDA 12.8's nvcc builds them for sm_90a with the pass counts
# taken at the kernels' ends (phase 2 holds them)
SHIPPED_SPA_PTXAS = {
    "tile": {8: (48, (28, 28)), 7: (57, (0, 0)), 6: (48, (4, 4)),
             5: (48, (0, 0)), 4: (48, (0, 0)), 3: (44, (0, 0)),
             2: (40, (0, 0))},
    "large": {8: (52, (0, 0)), 7: (54, (0, 0)), 6: (56, (0, 0)),
              5: (54, (0, 0)), 4: (54, (0, 0)), 3: (56, (0, 0)),
              2: (54, (0, 0))}}
# the shipped min-sum kernels (their check step from csrc/minsum.cuh, the
# header the min-sum study shares): the tile min-sum bp_minsum_pairs<WR>
# and the large-code bp_kernel<WR, false, 16, 64>, as CUDA 12.8's nvcc
# builds them for sm_90a (phase 2 holds them)
SHIPPED_MS_PTXAS = {
    "pairs": {8: (64, (0, 0)), 7: (80, (0, 0)), 6: (64, (0, 0)),
              5: (59, (0, 0)), 4: (51, (0, 0)), 3: (44, (0, 0)),
              2: (44, (0, 0))},
    "large": {8: (64, (0, 0)), 7: (64, (0, 0)), 6: (56, (0, 0)),
              5: (52, (0, 0)), 4: (54, (0, 0)), 3: (56, (0, 0)),
              2: (55, (0, 0))}}
LARGE_FRAMES = 16384
SWEEP_REF = "results/waterfall_sim_50_100_4dec_1e6.json"
SWEEP_FRAMES = 1_000_000
SWEEP_GRID = np.arange(-7.0, 10.0 + 0.25, 0.5)   # run_waterfall's defaults
SWEEP_ITERS = 5
STEP_FRAMES = 1 << 17
CHAIN_FRAMES = 1 << 17                             # the JAX chain bench's segment
CHAIN_APP_FRAMES = 1 << 13                         # the app's 64-symbol blocks
LARGE_PTS = (1.0, 1.5, 2.0)                        # the gen_256_512 sweep
ANCHOR_FRAMES = 100_000                            # the sim_8_16 anchor sweep
SOURCES = {"": "gr_ldpc_ece535a_torch/csrc/bp_wmajor.cu",
           "_large": "gr_ldpc_ece535a_torch/csrc/bp_wmajor.cu",
           "_exact": "gr_ldpc_ece535a_torch/csrc/bp_exact.cu",
           "_wide": "gr_ldpc_ece535a_torch/csrc/bp_wide.cu"}
# the wide kernels' code: the benchmark's sim_80211n_1944.bp, at its step
WIDE_CODE = "ieee80211n_1944_r12"
WIDE_PTS = (1.0, 1.5, 2.0)                         # the contract's points
WIDE_SWEEP_PTS = (1.5, 2.5)
_PALLAS = "gr_ldpc_ece535a_tpu/ops/pallas_bp.py"
LOOP_SOURCE = "gr_ldpc_ece535a_torch/csrc/dsp_loops.cu"
# no TPU kernel: the JAX package runs both loops as lax.scan recurrences
LOOP_REPLACES = {"agc_scan": "gr_ldpc_ece535a_tpu/ops/dsp.py:113",
                 "agc_loop": "gr_ldpc_ece535a_tpu/ops/dsp.py:113",
                 "costas_loop": "gr_ldpc_ece535a_tpu/ops/dsp.py:130"}
# no TPU kernel: _pfb_core's lax.scan over blocks (the scan at :533)
TRACK_SOURCE = "gr_ldpc_ece535a_torch/csrc/pfb_track.cu"
TRACK_REPLACES = "gr_ldpc_ece535a_tpu/ops/dsp.py:348"
REPLACES = {"bp_sumproduct": f"{_PALLAS}:354", "bp_minsum": f"{_PALLAS}:438",
            "bp_sumproduct_large": f"{_PALLAS}:584",
            "bp_minsum_large": f"{_PALLAS}:668",
            "bp_sumproduct_exact": f"{_PALLAS}:260",
            "bp_minsum_exact": f"{_PALLAS}:207",
            # no TPU kernel: JAX decodes codes past its split envelope on XLA
            "bp_sumproduct_wide": None, "bp_minsum_wide": None}
STUDY_SOURCE = "gr_ldpc_ece535a_torch/csrc/bp_study.cu"
# study instance -> the prototype kernel it stands for (study_phi is also
# proto_r3b.py:192's "full" and proto_r4b.py:34's "phi"; study_phi_libm is
# proto_r3b's base with the libm phi)
STUDY_REPLACES = {
    **{n: "tools/proto_r3b.py:85" for n in (
        "study_phi", "study_phi_x2", "study_explog", "study_explog_x2",
        "study_phi_libm")},
    **{n: "tools/proto_r3b.py:192" for n in (
        "study_stub", "study_phi_noagg", "study_phi_bf16")},
    "study_tanhprod": "tools/proto_r4b.py:34",
    **{f"study_cm{s}": "tools/ablate_pallas.py:27" for s in (
        "", "_no_tanh", "_no_log", "_no_tanh_log", "_no_excl", "_no_matmul",
        "_bf16", "_all_off")},
    "study_sp_split": "tools/fast_kernel_proto.py:77",
    "study_phi_bf16all": "tools/proto_r2.py:238",
    "study_psprod": "tools/proto_r2.py:238",
    "study_phi_hilo": "tools/proto_r3.py:110",
    "study_phi_hilo2": "tools/proto_r3.py:225",
    "study_psprod1p": "tools/proto_r3.py:225",
    **{n: "tools/proto_r3c.py:30" for n in (
        "study_phi_textbook", "study_phi_textbook_u2", "study_phi_textbook_u4")},
    **{n: "tools/proto_r4.py:38" for n in (
        "study_phi_hilo2_u19", "study_phi_bf16all_u19")}}
# the SPA aggregation-precision instances (fast_kernel_proto, proto_r2 and
# proto_r3's sum-product kernels); the bf16 and hi/lo phi forms keep the fast
# contract against the shipped precise SPA, the others are reported
SP_NEW = ("study_sp_split", "study_phi_bf16all", "study_psprod",
          "study_phi_hilo", "study_phi_hilo2", "study_psprod1p")
SP_FAST = ("study_phi_bf16all", "study_phi_hilo", "study_phi_hilo2")
# the phi forms that round the loop's sums (bf16, hi/lo), and the split's
SP_ROUNDED = SP_FAST + ("study_sp_split",)
STUDY_MS_SOURCE = "gr_ldpc_ece535a_torch/csrc/bp_study_ms.cu"
# min-sum study instance -> the prototype kernel it stands for (study_ms_ref
# is the shipped tile min-sum's arithmetic, which proto_r2 "current" computed
# with bf16 products)
STUDY_MS_REPLACES = {
    "study_ms_ref": f"{_PALLAS}:438",
    "study_ms_argmin": "tools/fast_kernel_proto.py:120",
    **{f"study_ms_{v}": "tools/proto_r2.py:80" for v in (
        "current", "stub_check", "stub_mm", "bits", "bf16", "int8", "split")},
    "study_ms_hilo": "tools/proto_r3.py:78",
    **{n: "tools/proto_r3c.py:30" for n in (
        "study_ms_current_u2", "study_ms_current_u4")},
    **{n: "tools/proto_r4.py:38" for n in (
        "study_ms_current_u19", "study_ms_hilo2", "study_ms_hilo2_u19")}}
# the bf16-aggregation candidates: the fast contract against the shipped
# precise min-sum, as the TPU's own fast min-sum kept it
MS_FAST = ("study_ms_current", "study_ms_bits", "study_ms_argmin",
           "study_ms_split", "study_ms_hilo", "study_ms_current_u2",
           "study_ms_current_u4", "study_ms_current_u19", "study_ms_hilo2",
           "study_ms_hilo2_u19")
# the loop-unroll study's new instances (tools/proto_r3c.py, proto_r4.py)
UNROLL_NEW = ("study_phi_textbook", "study_phi_textbook_u2",
              "study_phi_textbook_u4", "study_phi_hilo2_u19",
              "study_phi_bf16all_u19", "study_ms_current_u2",
              "study_ms_current_u4", "study_ms_current_u19", "study_ms_hilo2",
              "study_ms_hilo2_u19")
TEXTBOOK = "study_phi_textbook"      # proto_r3c's sumprod: r enters once
# (code, frames, Eb/N0 dB) of the early-exit comparisons at which the SFU
# SPA kernels decide 1-2 frames as a valid codeword other than the IEEE
# plain version's: the plain decoder on the kernels' own log tanh algorithm
# in IEEE f32 decides those frames as the kernel does, so the difference is
# the algorithm's, not the SFU's (phase 3 checks it there)
MIRROR_WITNESS = {("gen_320_640", LARGE_FRAMES, 2.0),
                  *(("gen_256_512", N_FRAMES, e) for e in LARGE_PTS)}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def clock_line() -> str:
    """The card's SM clock, power draw, temperature and clock-limit reasons
    now, for reading the times beside it (never fails the run)."""
    q = ("clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return f"{q} = {(out.stdout or out.stderr).strip()}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    from gr_ldpc_ece535a_torch.blocks.dsp import AgcBlock2
    from gr_ldpc_ece535a_torch.codes import LdpcCode, get_code, make_ldpc
    from gr_ldpc_ece535a_torch.entry import EBN0_DB, dryrun_multichip, entry
    from gr_ldpc_ece535a_torch.ops import (
        awgn, bpsk_map, decode_minsum, decode_sumproduct, encode_bits,
        encode_to_symbols, make_decoder, pack_bits, syndrome_ok)
    from gr_ldpc_ece535a_torch.ops import (cuda_bp, cuda_dsp, cuda_study,
                                           cuda_study_ms, dsp)
    from gr_ldpc_ece535a_torch.ops._build import build, load_library
    from gr_ldpc_ece535a_torch.ops.layout import (
        check_major_tables, edge_slots, wmajor_tables)
    from gr_ldpc_ece535a_torch.parallel import make_sweep_step
    from gr_ldpc_ece535a_torch.parallel import sweep as psweep
    from gr_ldpc_ece535a_torch.parallel.sweep import count_errors, draw_frames
    from gr_ldpc_ece535a_torch.sim import band_check, run_waterfall
    from gr_ldpc_ece535a_torch.tools import (ablate_pallas, anchor,
                                             bench_chain, chain_check,
                                             dsp_loops_check,
                                             fast_kernel_proto,
                                             flowgraph_check, parity_f64,
                                             pfb_track_check,
                                             proto_r2, proto_r3, proto_r3b,
                                             proto_r3c, proto_r4, proto_r4b,
                                             receive_check, wide_check)
    from gr_ldpc_ece535a_torch.tools._timing import (
        SM_FMA_PER_CLOCK, bins, bound_ms, make_inputs, time_decode)
    from gr_ldpc_ece535a_torch.tools.issue_model import (
        LOOP_LATENCY, by_pipe, exact_floor_ms, exact_minsum_wavefronts,
        exact_mix, loop_chain, minsum_wavefronts, probe_sass, sass_dump,
        sass_functions, sass_instructions, shipped_phi, study_probe_mix,
        study_sfu_ms, under_load, wavefront_ms)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind} x{torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build()
    log(f"[build] {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s; ptxas:")
    regs, spills = {}, {}                    # study instance -> ptxas's numbers
    for _, build_log in built.values():      # one line per kernel
        name, notes = None, []
        for line in build_log.splitlines() + ["Compiling (end)"]:
            # bp_kernel<WR, SP, F, R>, bp_exact_kernel<WR, SP, R, tier>,
            # bp_minsum_pairs<WR>
            kernel = re.search(r"bp_kernelILi(\d+)ELb(\d)ELi(\d+)E", line)
            exact = re.search(r"bp_exact_kernelILi(\d+)ELb(\d)ELi\d+ELi(\d+)E",
                              line)
            pairs = re.search(r"bp_minsum_pairsILi(\d+)E", line)
            wide = re.search(r"bp_wideILi(\d+)ELb(\d)ELb(\d)E", line)
            loop = re.search(r"\d+(agc_loop|costas_loop|pfb_track)_kernel"
                             r"|\d+(agc_scan_\w+?)EP", line)
            study = (cuda_study.instance_of(line)
                     or cuda_study_ms.instance_of(line))
            if "Compiling" in line:
                if name:
                    log(f"    {name}: {'; '.join(notes)}")
                name, notes = None, []
                if pairs:
                    name = f"bp_minsum_pairs<WR={pairs[1]}>"
                elif wide:
                    name = (f"bp_wide<WR={wide[1]}, "
                            f"{'sumproduct' if wide[2] == '1' else 'minsum'}, "
                            f"{'shared' if wide[3] == '1' else 'device'}>")
                elif loop:
                    name = loop[1] or loop[2]
                elif kernel:
                    name = (f"bp_kernel<WR={kernel[1]}, "
                            f"{'sumproduct' if kernel[2] == '1' else 'minsum'}, "
                            f"{ {'32': 'tile', '16': 'large'}[kernel[3]]}>")
                elif exact:
                    name = (f"bp_exact_kernel<WR={exact[1]}, "
                            f"{'sumproduct' if exact[2] == '1' else 'minsum'}, "
                            f"exact, tier {exact[3]}>")
                elif study:
                    name = study
            elif name and ("Used" in line or "spill" in line):
                notes.append(line.split(":", 1)[-1].strip())
                if m := re.search(r"Used (\d+) registers", line):
                    regs[name] = int(m[1])
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line):
                    spills[name] = (int(m[1]), int(m[2]))
    shipped_ptxas = {
        (tile, wr): (regs.get(k := f"bp_kernel<WR={wr}, sumproduct, {tile}>"),
                     spills.get(k))
        for tile, by_wr in SHIPPED_SPA_PTXAS.items() for wr in by_wr}
    if shipped_ptxas != {(tile, wr): v for tile, by_wr
                         in SHIPPED_SPA_PTXAS.items()
                         for wr, v in by_wr.items()}:
        raise AssertionError(f"the shipped SPA kernels' registers and spills "
                             f"moved: {shipped_ptxas}")
    log(f"[build] the shipped SPA kernels' registers and spills as recorded "
        f"(SHIPPED_SPA_PTXAS, {len(shipped_ptxas)} kernels)")
    ms_kernel = {"pairs": "bp_minsum_pairs<WR={}>",
                 "large": "bp_kernel<WR={}, minsum, large>"}
    shipped_ms = {(tile, wr): (regs.get(k := ms_kernel[tile].format(wr)),
                               spills.get(k))
                  for tile, by_wr in SHIPPED_MS_PTXAS.items() for wr in by_wr}
    if shipped_ms != {(tile, wr): v for tile, by_wr in SHIPPED_MS_PTXAS.items()
                      for wr, v in by_wr.items()}:
        raise AssertionError(f"the shipped min-sum kernels' registers and "
                             f"spills moved: {shipped_ms}")
    log(f"[build] the shipped min-sum kernels' registers and spills as "
        f"recorded (SHIPPED_MS_PTXAS, {len(shipped_ms)} kernels)")
    wide_names = sorted(n for n in regs if n.startswith("bp_wide<"))
    if len(wide_names) != 28:
        raise AssertionError(f"the wide library holds {len(wide_names)} "
                             f"kernels, not 7 row weights x 2 methods x 2 forms")
    log(f"[build] the wide kernels (bp_wide<WR, method, state>): registers "
        f"{min(regs[n] for n in wide_names)}-{max(regs[n] for n in wide_names)}, "
        f"spill bytes (stores, loads) "
        f"{sorted({spills.get(n, (0, 0)) for n in wide_names})}")
    wlib, xlib = load_library("bp_wmajor"), load_library("bp_exact")
    slib = cuda_study._study_lib()    # checks its instance table
    mlib = cuda_study_ms._study_ms_lib()
    # each unrolled instance -> its unroll-1 sibling; the unroll must show
    # in the code: more static SASS instructions than the sibling's
    siblings, sass = {}, {}
    for lib_name, mod in (("bp_study", cuda_study),
                          ("bp_study_ms", cuda_study_ms)):
        by_spec = {s: n for n, s in mod.INSTANCES.items()}
        siblings.update({n: by_spec[dataclasses.replace(s, unroll=1)]
                         for n, s in mod.INSTANCES.items() if s.unroll > 1})
        for fn, ops in sass_functions(sass_dump(built[lib_name][0])).items():
            if inst := mod.instance_of(fn):
                sass[inst] = len(ops)
    for name, sib in siblings.items():
        log(f"[build] {name}: {sass[name]} static SASS instructions, "
            f"{sib} {sass[sib]}")
        if not sass[name] > sass[sib]:
            raise AssertionError(f"{name}: no more code than {sib}; the "
                                 f"unroll is not in the kernel")
    # each loop kernel's recurrence: the least dependent chain a sample over
    # the paths through its loop (its serial floor, phase 5)
    chains = {}
    for fn, ins in sass_instructions(sass_dump(built["dsp_loops"][0])).items():
        for name in cuda_dsp.SERIAL:
            if f"{name}_kernel" in fn:
                c = chains[name] = loop_chain(ins, cuda_dsp.UNROLL[name])
                log(f"[build] {name}: recurrence loop {c['body']} "
                    f"instructions at {c['head']:#x}-{c['tail']:#x}, "
                    f"{c['samples']} sample(s) an iteration, {c['paths']} "
                    f"paths; the least dependent chain an iteration "
                    f"{c['iteration_links']} instructions, a sample "
                    f"{c['links']:g}, {c['cycles']:g} cycles at "
                    f"{LOOP_LATENCY} a link; {regs.get(name)} registers")
    if set(chains) != set(cuda_dsp.SERIAL):
        raise AssertionError(f"loop kernels in the SASS: {sorted(chains)}")
    # the tracker's launch at the paths' shapes: the library's geometry is
    # the mirror's, and a cluster of its size fits the card
    tlib = load_library("pfb_track")
    for tag, B, rc in (("composed", 8192, 2.5e-4), ("segment", 64, 0.002)):
        bank = dsp.polyphase_rrc_banks(2, 32)[0]
        tloop = dsp._pfb_loop(1 << 24, bank.shape[1], 2, 32, B, rc)
        geo = (ctypes.c_int * 8)()
        tlib.pfb_track_geometry(B, 2, 32, tloop.ntaps, tloop.width,
                                ctypes.c_float(rc),
                                ctypes.c_float(tloop.gain), geo)
        want = cuda_dsp.track_geometry(B, 2, 32, tloop.ntaps, tloop.width,
                                       rc, tloop.gain)
        if tuple(geo) != tuple(want):
            raise AssertionError(f"pfb_track geometry {tuple(geo)}, the "
                                 f"mirror's {tuple(want)}")
        fits = cuda_dsp.track_clusters(tloop)
        log(f"[build] pfb_track {tag} ({B} symbols a block, 2 samples a "
            f"symbol, 32 phases, {tloop.ntaps} taps, {tloop.width} window "
            f"columns): C {want.C} CTAs a cluster, {want.threads} threads, "
            f"{want.smem} B of shared memory a CTA, "
            f"cudaOccupancyMaxActiveClusters {fits}")
        if fits < 1:
            raise AssertionError(f"no pfb_track cluster fits at {tag}")
    # the SPA kernels' log tanh(x/2): its SASS by pipe; its MUFU count sets
    # their SFU floor (sfu_ms, phase 5)
    phi_ops = shipped_phi(built["bp_wmajor"][0])
    phi_mufu = phi_ops.count("MUFU")
    log(f"[build] log_tanh_half (bp_wmajor.cu), SASS by pipe: "
        f"{by_pipe(phi_ops)}: {' '.join(phi_ops)}")
    if phi_mufu < 1 or "CALL" in phi_ops:
        raise AssertionError("log_tanh_half calls out instead of the SFU")
    # the study's check-step functions (bp_study's probe kernels): each
    # MUFU function on the SFU, no call out, and its log_tanh_half the
    # shipped one's SASS (one header, csrc/sfu.cuh); their MUFU counts set
    # each study instance's MUFU floor (phase 5)
    study_fns = study_probe_mix(built["bp_study"][0])
    study_mufu = {fn: ops.count("MUFU") for fn, ops in study_fns.items()}
    for fn, ops in study_fns.items():
        log(f"[build] {fn} (bp_study.cu probe), SASS by pipe: "
            f"{by_pipe(ops)}: {' '.join(ops)}")
        if fn != "log_tanh_half_libm" and (study_mufu[fn] < 1
                                           or "CALL" in ops):
            raise AssertionError(f"{fn} calls out instead of the SFU")
    if study_fns["log_tanh_half"] != phi_ops:
        raise AssertionError("the study's log_tanh_half is not the shipped "
                             "kernel's")
    gen = {n: LdpcCode.from_h(make_ldpc(m, n, seed=1), name=f"gen_{m}_{n}")
           for m, n in ((200, 400), (256, 512), (320, 640))}
    # blocks an SM of each w-major tile; the large-code kernel also on
    # block_32_64 (impl="split", timed in phase 5 on the same slot count)
    for c, tile in ((get_code("block_32_64"), "tile"), (gen[512], "large"),
                    (get_code("block_32_64"), "large")):
        for method in ("sumproduct", "minsum"):
            blocks, warps = cuda_bp.occupancy(c, tile, method == "sumproduct")
            smem = (cuda_bp.smem_bytes if tile == "tile"
                    else cuda_bp.large_smem_bytes)(c)
            log(f"[occupancy] {tile} {method} {c.name}, {smem} B of shared "
                f"memory a block: {blocks} blocks of {warps} warps an SM "
                f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    for method in ("sumproduct", "minsum"):
        c = get_code("block_32_64")
        blocks, warps = cuda_bp.occupancy(c, "exact", method == "sumproduct")
        log(f"[occupancy] exact {method} {c.name}, "
            f"{cuda_bp.exact_smem_bytes(c)} B of shared memory a block: "
            f"{blocks} blocks of {warps} warps an SM")
    # the instance each code takes: the exact kernels' register tier (lever
    # 1) or their table route (the library's dispatch against
    # cuda_bp.tier), and the tile min-sum (two frames a thread), with
    # ptxas's registers and spills and the blocks an SM of each
    for c in (get_code("block_32_64"), get_code("sim_50_100"), gen[400]):
        t = wmajor_tables(c)
        for method in ("minsum", "sumproduct"):
            sp = method == "sumproduct"
            lib_tier = xlib.bp_exact_tier(int(sp), t.M, t.N)
            if lib_tier != cuda_bp.tier(c, sp):
                raise AssertionError(f"exact {method} {c.name}: dispatch "
                                     f"takes tier {lib_tier}, cuda_bp.tier "
                                     f"{cuda_bp.tier(c, sp)}")
            inst = f"bp_exact_kernel<WR={t.Wr}, {method}, exact, tier {lib_tier}>"
            blocks, warps = cuda_bp.occupancy(c, "exact", sp)
            log(f"[instance] exact {method} {c.name} (M {t.M}, N {t.N}): "
                f"tier {lib_tier} "
                f"{'(registers)' if lib_tier else '(the table route)'}, "
                f"{regs.get(inst, -1)} registers, spills {spills.get(inst)}, "
                f"{blocks} blocks of {warps} warps an SM")
        inst = f"bp_minsum_pairs<WR={t.Wr}>"
        blocks, warps = cuda_bp.occupancy(c, "tile", False)
        log(f"[instance] tile minsum {c.name}: {inst}, {regs.get(inst, -1)} "
            f"registers, spills {spills.get(inst)}, {blocks} blocks of "
            f"{warps} warps an SM")
    # every study instance's ptxas registers and spills and blocks an SM,
    # beside the shipped tile SPA's (study_phi is that kernel's fixed form)
    c = get_code("block_32_64")
    tile_sp = "bp_kernel<WR=6, sumproduct, tile>"
    log(f"[build] study instances at {c.name} (registers, spill store/load "
        f"bytes, blocks an SM): the shipped tile SPA {regs.get(tile_sp, -1)}"
        f", {spills.get(tile_sp)}, {cuda_bp.occupancy(c, 'tile', True)[0]}")
    for n in cuda_study.INSTANCES:
        log(f"    {n:22s} {regs.get(n, -1):3d} {str(spills.get(n)):9s} "
            f"{cuda_study.occupancy(c, n)}")
    # and every min-sum study instance's beside the shipped tile min-sum's
    # (study_ms_ref is its fixed form, two frames a thread)
    tile_ms = "bp_minsum_pairs<WR=6>"
    ms_blocks = {n: cuda_study_ms.occupancy(c, n)
                 for n in cuda_study_ms.INSTANCES}
    log(f"[build] min-sum study instances at {c.name} (registers, spill "
        f"store/load bytes, blocks an SM): the shipped tile min-sum "
        f"{regs.get(tile_ms, -1)}, {spills.get(tile_ms)}, "
        f"{cuda_bp.occupancy(c, 'tile', False)[0]}")
    for n in cuda_study_ms.INSTANCES:
        log(f"    {n:22s} {regs.get(n, -1):3d} {str(spills.get(n)):9s} "
            f"{ms_blocks[n]}")
    for c in [get_code(n) for n in ("block_32_64", "sim_5_10", "sim_8_16",
                                    "sim_24_48", "sim_50_100")] + list(gen.values()):
        t, x = wmajor_tables(c), check_major_tables(c)
        got = (wlib.bp_smem_bytes(t.M, t.N, t.Wr, t.Wc),
               wlib.bp_large_smem_bytes(t.M, t.N, t.Wr, t.Wc),
               xlib.bp_exact_smem_bytes(x.M, x.N, x.Wr, x.Wc))
        want = (cuda_bp.smem_bytes(c), cuda_bp.large_smem_bytes(c),
                cuda_bp.exact_smem_bytes(c))
        if got != want:
            raise AssertionError(f"smem plan differs for {c.name}: {got} {want}")
        for n in cuda_study.INSTANCES:
            if cuda_study.study_supported(c, n):
                got, want = (slib.bp_study_smem_bytes(
                                 cuda_study.kernel_index(n), t.M, t.N, t.Wc),
                             cuda_study.study_smem_bytes(c, n))
                if got != want:
                    raise AssertionError(
                        f"smem plan of {n} differs for {c.name}: {got} {want}")
        for n in cuda_study_ms.INSTANCES:
            if cuda_study_ms.study_ms_supported(c, n):
                got, want = (mlib.bp_study_ms_smem_bytes(
                                 cuda_study_ms.kernel_index(n), t.M, t.N, t.Wc),
                             cuda_study_ms.study_ms_smem_bytes(c, n))
                if got != want:
                    raise AssertionError(
                        f"smem plan of {n} differs for {c.name}: {got} {want}")

    # -- phi: the SPA kernels' log tanh(x/2) against float64 ----------------
    grid = np.geomspace(2.0 ** -20, 40.0, 100_000).astype(np.float32)
    special = np.array([0.0, 1e-30, 87.0, 88.0, 1e30, np.inf, np.nan],
                       np.float32)
    xs = torch.from_numpy(np.concatenate([grid, special])).to(dev)
    with np.errstate(divide="ignore"):          # log(0) = -inf at x = 0
        phi_ref = np.log(np.tanh(xs.cpu().double().numpy() * 0.5))
    phis = {"log_tanh_half (SFU)": cuda_bp.phi_probe(xs),
            "libm logf(tanhf) f32": torch.log(torch.tanh(xs * 0.5))}
    phis = {k: v.cpu().double().numpy() for k, v in phis.items()}
    fin = np.isfinite(phi_ref)
    rel = np.abs(phi_ref) >= 2.0 ** -4           # where the bar is relative
    bar = np.where(fin, np.maximum(2.0 ** -16 * np.abs(phi_ref), 2.0 ** -20),
                   np.inf)                      # specials: checked below
    errs = {}
    for name, y in phis.items():
        with np.errstate(invalid="ignore"):      # -inf - -inf at x = 0
            err = errs[name] = np.where(fin, np.abs(y - phi_ref), 0.0)
        worst = int(np.argmax(err / bar))
        log(f"[phi] {name} vs float64 on {grid.size} points in [2^-20, 40] "
            f"and {special.size} special values: max relative error "
            f"{(err[rel] / np.abs(phi_ref[rel])).max():.4e} where |phi| >= 1/16, "
            f"max absolute {err[fin & ~rel].max():.4e} below; worst "
            f"{err[worst] / bar[worst]:.4f} of the bar max(2^-16 |phi|, "
            f"2^-20), at x = {float(xs[worst])!r}")
    for i, x in enumerate(special.tolist()):
        j = grid.size + i
        log(f"[phi] x = {x!r}: " + ", ".join(
            f"{name} {float(y[j])!r}" for name, y in phis.items())
            + f", float64 {float(phi_ref[j])!r}")
    y = phis["log_tanh_half (SFU)"]
    sp = y[grid.size:]
    if not ((errs["log_tanh_half (SFU)"] <= bar).all() and (y[fin] <= 0).all()
            and sp[0] == -np.inf and (sp[2:6] == 0).all()
            and np.isnan(sp[6])):
        raise AssertionError("log_tanh_half misses float64 beyond its bar, "
                             "or a special value")
    del xs, phis
    # the study's check-step functions (bp_study_probe) against float64,
    # each at its bar max(2^-16 |y|, 2^-20): the two log tanh(x/2) on the
    # grid above, tanh(x/2) on it and its negation, log((1+T)/(1-T)) and
    # log1p(T) - log1p(-T) on T near 0 and near +-1; an infinite or NaN
    # value exactly, and a subnormal argument as 0 (the MUFU flushes it);
    # the study's log_tanh_half bit for bit the shipped kernel's
    ends = np.concatenate([1.0 - np.geomspace(2.0 ** -24, 1.0, 50_000),
                           np.geomspace(2.0 ** -20, 1.0, 50_000)])
    logs = np.concatenate([grid, [0.0, 1e-30, 87.0, 88.0, 1e30, np.inf,
                                  np.nan]])
    domains = {
        "log_tanh_half": logs, "log_tanh_half_explog": logs,
        "tanh_half": np.concatenate([grid, -grid, [0.0, -0.0, 17.5, 88.0,
                                                   np.inf, -np.inf, np.nan]]),
        **dict.fromkeys(("log_ratio", "log1p_diff"), np.concatenate(
            [ends, -ends, [0.0, 1.0, -1.0, cuda_study.PSPROD_CLIP,
                           -cuda_study.PSPROD_CLIP, np.nan]]))}
    for fn, x in domains.items():
        x = np.concatenate([x, [1e-40, 0.0]]).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        yd = cuda_study.sfu_probe(fn, xd)
        y, x64 = yd.cpu().double().numpy(), x.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            ref = (np.tanh(0.5 * x64) if fn == "tanh_half" else
                   np.log1p(x64) - np.log1p(-x64) if fn.startswith("log1p")
                   or fn == "log_ratio" else np.log(np.tanh(0.5 * x64)))
            fin = np.isfinite(ref)
            fin[-2:] = False
            err = np.where(fin, np.abs(y - ref), 0.0)
            bar = np.maximum(2.0 ** -16 * np.abs(ref), 2.0 ** -20)
            worst = int(np.argmax(np.where(fin, err / bar, 0.0)))
            odd = ~fin[:-2] & ~((y[:-2] == ref[:-2])
                                | (np.isnan(y[:-2]) & np.isnan(ref[:-2])))
        log(f"[phi] {fn} (bp_study.cu, SFU) vs float64 on {int(fin.sum())} "
            f"finite points: worst {err[worst] / bar[worst]:.4f} of the bar "
            f"max(2^-16 |y|, 2^-20) at x = {float(x[worst])!r}; "
            f"{int(odd.sum())} infinite or NaN values off; subnormal "
            f"{float(y[-2])!r}, 0 {float(y[-1])!r}")
        if (not (err <= np.where(fin, bar, 0.0)).all() or odd.any()
                or not (y[-2] == y[-1] or np.isnan(y[-2]) and np.isnan(y[-1]))
                or fn.startswith("log_tanh") and not (y[fin] <= 0).all()):
            raise AssertionError(f"{fn} misses float64 beyond its bar, or a "
                                 f"special value")
        if fn == "log_tanh_half" and not torch.equal(
                yd.nan_to_num(), cuda_bp.phi_probe(xd).nan_to_num()):
            raise AssertionError("the study's log_tanh_half differs from the "
                                 "shipped kernel's")

    kernels = {"sumproduct": cuda_bp.cuda_decode_sumproduct,
               "minsum": cuda_bp.cuda_decode_minsum}
    plains = {"sumproduct": cuda_bp.decode_sumproduct_plain,
              "minsum": cuda_bp.decode_minsum_plain}
    exact_plains = {"sumproduct": cuda_bp.decode_sumproduct_exact_plain,
                    "minsum": cuda_bp.decode_minsum_exact_plain}
    f32_paths = {"sumproduct": decode_sumproduct, "minsum": decode_minsum}

    def codewords(code, B, ebn0, seed):
        return make_inputs(code, B, torch.Generator(device=dev).manual_seed(seed),
                           dev, ebn0)

    def minsum_inputs(c, B, seed):
        """rx for the min-sum kernels' rules: 4 dB, rx rounded to multiples
        of 0.5 at 1 dB (rows with tied minima), zero, half-zero, +-30 x
        codeword, and 4 dB with 2% of its entries +inf, -inf or NaN."""
        g = torch.Generator(device=dev).manual_seed(seed)
        cw = bpsk_map(encode_bits(torch.randint(
            0, 2, (B, c.K), generator=g, device=dev, dtype=torch.int8), c))
        rx4 = awgn(g, cw, PARITY_EBN0_DB)
        half = torch.zeros_like(rx4)
        half[B // 2:, :c.N // 2] = 1.0
        special = rx4.clone().view(-1)
        idx = torch.randperm(special.numel(), generator=g,
                             device=dev)[:special.numel() // 50]
        special[idx] = torch.tensor([math.inf, -math.inf, math.nan],
                                    device=dev)[torch.arange(len(idx),
                                                             device=dev) % 3]
        return {"4 dB": rx4, "tied minima": torch.round(awgn(g, cw, 1.0) * 2)
                / 2, "all-zero": torch.zeros_like(rx4), "half-zero": half,
                "+-30 x codeword": 30.0 * cw,
                "+-inf and NaN": special.view(rx4.shape)}

    def precise(c, early_exit):
        """The early-exit / fixed contracts of the precise kernels."""
        B = c["frames"]
        if early_exit:
            return (c["mismatch"] <= EE_MAX_MISMATCH * B
                    and c["both_valid_different"] == 0)
        return (B - c["mismatch"] >= FIXED_MIN_AGREE * B
                and abs(c["succ_kernel"] - c["succ_plain"])
                <= FIXED_MAX_SUCC_GAP)

    def compare(tag, vk, vp, code, early_exit, identical=False,
                min_agree=None, mirror=None, two_valid_only=False, sent=None,
                max_share=None):
        """Kernel vs plain: the four bins, and the contract of the form:
        identical decisions, or (min_agree) an agreement share with no two
        valid codewords, or (max_share) at most that share of mismatching
        frames, or (two_valid_only) no two valid codewords, or the
        precise contracts. ``mirror()``, given at the shapes of
        MIRROR_WITNESS, decodes the same rx with the plain decoder on the
        kernels' own log tanh algorithm: there the kernel keeps the
        mismatched share against the plain version, meets the precise
        contract against that decoder, and that decoder decides each frame
        on which the kernel and the plain version hold two different valid
        codewords as the kernel does; ``sent``, the codewords sent, counts
        those frames with the kernel and with the plain version on it."""
        B = vk.shape[0]
        c = bins(vk, vp, code)
        log(f"[kernels] {tag}: {json.dumps(c)}")
        if identical:
            good = c["mismatch"] == 0
        elif min_agree is not None:
            good = (B - c["mismatch"] >= min_agree * B
                    and c["both_valid_different"] == 0)
        elif max_share is not None:
            good = c["mismatch"] <= max_share * B
        elif two_valid_only:
            good = c["both_valid_different"] == 0
        else:
            good = precise(c, early_exit)
            if mirror is not None:
                vm = mirror()
                m = bins(vk, vm, code)
                two = ((vk != vp).any(1) & syndrome_ok(vk, code.H)
                       & syndrome_ok(vp, code.H))
                other = int((two & (vk != vm).any(1)).sum())
                good = (c["mismatch"] <= EE_MAX_MISMATCH * B
                        and precise(m, early_exit) and other == 0)
                log(f"[kernels] {tag}: against the plain decoder on the "
                    f"kernels' log tanh in IEEE f32: {json.dumps(m)}; of the "
                    f"{c['both_valid_different']} frames on two different "
                    f"valid codewords above, {other} decided otherwise by it")
                if sent is not None:
                    log(f"[kernels] {tag}: of those frames, "
                        f"{int((two & (vk == sent).all(1)).sum())} with the "
                        f"kernel and {int((two & (vp == sent).all(1)).sum())}"
                        f" with the plain version on the sent codeword (no "
                        f"bar)")
        if not good:
            raise AssertionError(f"kernel disagrees with its plain version: {tag}")
        return int((vk.int() - vp.int()).abs().max()) if B else 0

    def mirror_of(method, rx, c, iters, early_exit, ebn0):
        """The SPA mirror decoder for compare at the shapes of
        MIRROR_WITNESS, else None."""
        if (method != "sumproduct" or not early_exit
                or (c.name, rx.shape[0], ebn0) not in MIRROR_WITNESS):
            return None
        return lambda: cuda_bp.decode_sumproduct_phi(rx, c, iters, True)

    def run_pair(method, rx, code, iters, early_exit, mode="precise", **kw):
        vk = kernels[method](rx, code, iters, mode=mode, early_exit=early_exit,
                             **kw)
        if mode == "exact":
            vp = exact_plains[method](rx, code, iters)
        else:
            vp = plains[method](rx, code, iters, early_exit, **kw)
        torch.cuda.synchronize()
        return vk, vp

    max_err = dict.fromkeys((*cuda_bp.KERNELS, *cuda_study.INSTANCES,
                             *cuda_study_ms.INSTANCES), 0)

    # -- 3. kernels vs plain versions ----------------------------------------
    code = get_code("block_32_64")
    rx4 = codewords(code, N_FRAMES, PARITY_EBN0_DB, seed=1000)
    for method in kernels:
        for early_exit in (False, True):
            vp = plains[method](rx4, code, ITERATIONS, early_exit)
            for mode in ("precise", "fast"):
                vk = kernels[method](rx4, code, ITERATIONS, mode=mode,
                                     early_exit=early_exit)
                torch.cuda.synchronize()
                form = "early_exit" if early_exit else "fixed"
                compare(f"{method} {mode} {form} {N_FRAMES}x{ITERATIONS} "
                        f"@{PARITY_EBN0_DB}dB", vk, vp, code, early_exit,
                        identical=method == "minsum")

    zero = torch.zeros((8, code.N), device=dev)
    half = zero.clone()
    half[4:, :32] = 1.0
    edge = [("batch 1", code, codewords(code, 1, PARITY_EBN0_DB, 1), ITERATIONS),
            ("batch 257", code, codewords(code, 257, PARITY_EBN0_DB, 2), ITERATIONS),
            ("all-zero rx", code, zero, 5), ("half-zero rx", code, half, 5)]
    rxi = codewords(code, 4096, PARITY_EBN0_DB, 3)
    edge += [(f"iterations {it}", code, rxi, it) for it in (0, 1, 5)]
    for name in ("sim_50_100", "sim_8_16"):
        other = get_code(name)
        edge.append((name, other, codewords(other, 16384, PARITY_EBN0_DB, 4),
                     ITERATIONS))
    # a generated code at the top of the tile kernel's size gate
    big = gen[400]
    if not cuda_bp.kernel_supported(big):
        raise AssertionError("gen_200_400 should fit the tile kernels' size gate")
    edge.append((f"gen_200_400 E={edge_slots(big)} smem "
                 f"{cuda_bp.smem_bytes(big)} B", big,
                 codewords(big, 4096, PARITY_EBN0_DB, 5), ITERATIONS))
    for tag, c, rx, iters in edge:
        for method in kernels:
            for early_exit in (False, True):
                vk, vp = run_pair(method, rx, c, iters, early_exit)
                compare(f"{method} {'early_exit' if early_exit else 'fixed'} "
                        f"{tag}", vk, vp, c, early_exit,
                        identical=method == "minsum")
    for early_exit in (False, True):
        vk, vp = run_pair("minsum", rxi, code, ITERATIONS, early_exit,
                          norm_offset=0.5)
        compare(f"minsum norm_offset=0.5 "
                f"{'early_exit' if early_exit else 'fixed'}", vk, vp, code,
                early_exit, identical=True)
    # the inputs where log tanh meets its special values (0 -> -inf, the
    # clamp, E = +-inf) decide as the plain version decides them
    sat = 30.0 * bpsk_map(encode_bits(torch.randint(
        0, 2, (64, code.K), generator=torch.Generator(device=dev).manual_seed(8),
        device=dev, dtype=torch.int8), code))
    for tag, rx in (("all-zero rx", zero), ("half-zero rx", half),
                    ("saturating rx (+-30)", sat)):
        for iters in (1, 2, 5, ITERATIONS):
            for early_exit in (False, True):
                vk, vp = run_pair("sumproduct", rx, code, iters, early_exit)
                compare(f"sumproduct {'early_exit' if early_exit else 'fixed'}"
                        f" {tag}, {iters} iterations", vk, vp, code,
                        early_exit, identical=True)
    # the tile SPA against the f32 path of ops/decode.py under early exit:
    # no frame decided as two different valid codewords
    compare(f"sumproduct precise early_exit vs ops.decode f32 path "
            f"{N_FRAMES}x{ITERATIONS} @{PARITY_EBN0_DB}dB",
            kernels["sumproduct"](rx4, code, ITERATIONS, mode="precise",
                                  early_exit=True),
            decode_sumproduct(rx4, code, ITERATIONS, early_exit=True), code,
            True, two_valid_only=True)

    # the exact kernels: their plain versions on every frame, and the f32
    # path of ops/decode.py (whose torch scans may sum in another order)
    for method in kernels:
        name = f"bp_{method}_exact"
        vk, vp = run_pair(method, rx4, code, ITERATIONS, False, mode="exact")
        max_err[name] = compare(f"{method} exact {N_FRAMES}x{ITERATIONS} "
                                f"@{PARITY_EBN0_DB}dB", vk, vp, code, False,
                                identical=True)
        vf = f32_paths[method](rx4, code, ITERATIONS, early_exit=False)
        compare(f"{method} exact vs ops.decode f32 path {N_FRAMES}x"
                f"{ITERATIONS}", vk, vf, code, False, min_agree=EXACT_MIN_AGREE)
        del vp, vf
    exact_edge = [("batch 1", codewords(code, 1, PARITY_EBN0_DB, 1), ITERATIONS),
                  ("batch 257", codewords(code, 257, PARITY_EBN0_DB, 2),
                   ITERATIONS),
                  ("all-zero rx", zero, 5), ("saturating rx (+-30)", sat, 5)]
    exact_edge += [(f"iterations {it}", rxi, it) for it in (0, 1, 5)]
    for tag, rx, iters in exact_edge:
        for method in kernels:
            vk, vp = run_pair(method, rx, code, iters, False, mode="exact")
            compare(f"{method} exact {tag}", vk, vp, code, False,
                    identical=True)

    # the redesigned min-sum kernels (the tile's and the exact one; lever 1
    # keeps a thread's rows in registers, the exact check step is one pass)
    # against their plain versions, 0 mismatched frames, on inputs that
    # reach every rule of the check step: 4 dB, rx on a 0.5 grid (tied
    # minima), zero and half-zero, +-30 x codeword, and +-inf and NaN
    # entries; at block_32_64 and sim_50_100 (register tiers) and
    # gen_200_400 (the table route)
    for c in (code, get_code("sim_50_100"), gen[400]):
        for tag, rx in minsum_inputs(c, 4096, 9).items():
            for iters in (1, 5, ITERATIONS):
                vk, vp = run_pair("minsum", rx, c, iters, False, mode="exact")
                compare(f"minsum exact {c.name} tier "
                        f"{cuda_bp.tier(c, False)} {tag}, {iters} "
                        f"iterations", vk, vp, c, False, identical=True)
                for early_exit in (False, True):
                    vk, vp = run_pair("minsum", rx, c, iters, early_exit)
                    compare(f"minsum {'early_exit' if early_exit else 'fixed'}"
                            f" {c.name} {tag}, {iters} iterations", vk, vp, c,
                            early_exit, identical=True)

    # the large-code kernels on codes beyond the tile
    for c in (gen[512], gen[640]):
        if cuda_bp.kernel_supported(c) or not cuda_bp.large_supported(c):
            raise AssertionError(f"{c.name} should take the large-code kernel")
        rxl = codewords(c, LARGE_FRAMES, 2.0, 6)
        sent = encode_bits(torch.randint(      # rxl's codewords, from its seed
            0, 2, (LARGE_FRAMES, c.K),
            generator=torch.Generator(device=dev).manual_seed(6), device=dev,
            dtype=torch.int8), c)
        for method in kernels:
            for early_exit in (False, True):
                torch.cuda.reset_peak_memory_stats()
                vk, vp = run_pair(method, rxl, c, ITERATIONS, early_exit)
                peak = torch.cuda.max_memory_allocated() / 2**20
                err = compare(
                    f"{method} large {'early_exit' if early_exit else 'fixed'}"
                    f" {c.name} E={edge_slots(c)} smem "
                    f"{cuda_bp.large_smem_bytes(c)} B {LARGE_FRAMES}x"
                    f"{ITERATIONS} @2dB (plain peak {peak:.0f} MiB)", vk, vp,
                    c, early_exit, identical=method == "minsum",
                    mirror=mirror_of(method, rxl, c, ITERATIONS, early_exit,
                                     2.0), sent=sent)
                if c is gen[512] and not early_exit:
                    max_err[f"bp_{method}_large"] = err
        # the large min-sum on exact zeros (sign(0) zeroes the row) and on a
        # saturating rx, as the tile's are checked above
        zl = torch.zeros((40, c.N), device=dev)
        zl[20:, :c.N // 2] = 1.0
        satl = 30.0 * bpsk_map(sent[:40])
        for tag, rx in (("zero rx", zl), ("saturating rx (+-30)", satl)):
            for iters in (1, 2, 5, ITERATIONS):
                for early_exit in (False, True):
                    vk, vp = run_pair("minsum", rx, c, iters, early_exit)
                    form = "early_exit" if early_exit else "fixed"
                    compare(f"minsum large {form} {c.name} {tag}, {iters} "
                            f"iterations", vk, vp, c, early_exit,
                            identical=True)
    # each sweep step's decoder against the plain version on the rx the
    # step draws, at the shapes run_waterfall gives it in phase 4: the
    # reference experiment's 125,000 frames x 5 iterations (a partial last
    # tile) at every point, the gen_256_512 sweep's 131,072 x 20 at each of
    # its points; early exit, the first step of each point
    n_steps = math.ceil(SWEEP_FRAMES / STEP_FRAMES)
    sweep_shapes = [(get_code("sim_50_100"), math.ceil(SWEEP_FRAMES / n_steps),
                     SWEEP_ITERS, SWEEP_GRID),
                    (gen[512], N_FRAMES, ITERATIONS, LARGE_PTS)]
    for c, fps, iters, pts in sweep_shapes:
        for method in kernels:
            step = make_sweep_step(c, dev, method=method, iterations=iters,
                                   frames_per_device=fps)
            peak = 0.0
            for p, e in enumerate(pts):
                u, rxs = draw_frames(c, fps, (0, p, 0), float(e), dev)
                torch.cuda.reset_peak_memory_stats()
                vk = step.decode(rxs)
                vp = plains[method](rxs, c, iters, True)
                torch.cuda.synchronize()
                peak = max(peak, torch.cuda.max_memory_allocated() / 2**20)
                tag = (f"{method} sweep step {c.name} {fps}x{iters} early_exit "
                       f"@{e:+.1f}dB")
                compare(tag, vk, vp, c, True, identical=method == "minsum",
                        mirror=mirror_of(method, rxs, c, iters, True, float(e)),
                        sent=u)
                if step((0, p, 0), float(e)) != count_errors(vk, u, c):
                    raise AssertionError(f"the step decodes other frames: {tag}")
            # the first step captured the graphs that the others replayed
            if not any(work[2:6] == (method, fps, iters, True)
                       for work, _, _ in psweep._GRAPHS):
                raise AssertionError(f"{method} sweep steps {c.name}: no graphs")
            log(f"[kernels] {method} sweep steps {c.name} {fps}x{iters}: "
                f"{len(pts)} points (CUDA graphs after the first), peak "
                f"device memory {peak:.0f} MiB")
    # impl="split" on block_32_64 against the tile kernel (the same arithmetic)
    for method in kernels:
        for early_exit in (False, True):
            vs = kernels[method](rx4, code, ITERATIONS, mode="precise",
                                 early_exit=early_exit, impl="split")
            vg = kernels[method](rx4, code, ITERATIONS, mode="precise",
                                 early_exit=early_exit, impl="gram")
            torch.cuda.synchronize()
            compare(f"{method} impl=split vs impl=gram "
                    f"{'early_exit' if early_exit else 'fixed'} {N_FRAMES}x"
                    f"{ITERATIONS}", vs, vg, code, early_exit, identical=True)

    # the study instances against their plain versions at 131,072 x 20:
    # study_phi_libm and the instances with no transcendental decide as their
    # IEEE plain version on every frame (only identity shows that an
    # instance ran its own arithmetic); each MUFU instance keeps the shipped
    # tile SPA's fixed contract against it, and at 2, 5 and 20 steps decides
    # as its plain version on the kernels' own algorithms (phi="mirror") on
    # all but cuda_study.MIRROR_MAX_SHARE of the frames
    shape = f"{N_FRAMES}x{ITERATIONS} @{PARITY_EBN0_DB}dB"
    for name in cuda_study.INSTANCES:
        vk = cuda_study.study_decode(name, rx4, code, ITERATIONS)
        vp = cuda_study.study_plain(name, rx4, code, ITERATIONS)
        torch.cuda.synchronize()
        sfu = cuda_study.uses_sfu(name)
        max_err[name] = compare(f"{name} vs plain {shape}", vk, vp, code, False,
                                identical=not sfu)
        if not sfu:
            continue
        for steps in (2, 5, ITERATIONS):
            compare(f"{name} vs plain (mirror) {N_FRAMES}x{steps} "
                    f"@{PARITY_EBN0_DB}dB",
                    vk if steps == ITERATIONS
                    else cuda_study.study_decode(name, rx4, code, steps),
                    cuda_study.study_plain(name, rx4, code, steps,
                                           phi="mirror"), code, False,
                    max_share=cuda_study.MIRROR_MAX_SHARE)
    del vk, vp
    # study_phi is the shipped tile SPA's fixed form: it decides every frame
    # as that kernel does, and so do the prototypes' variants of its
    # arithmetic; study_phi_libm, the same with libm's phi, keeps the fixed
    # contract against the shipped kernel
    shipped = kernels["sumproduct"](rx4, code, ITERATIONS, mode="precise")
    phi = cuda_study.study_decode("study_phi", rx4, code, ITERATIONS)
    libm_phi = cuda_study.study_decode("study_phi_libm", rx4, code,
                                       ITERATIONS)
    compare(f"study_phi vs the shipped tile SPA {shape}", phi, shipped, code,
            False, identical=True)
    runs = {"proto_r3b base": proto_r3b.run("base", rx4, code, ITERATIONS),
            "proto_r3b full": proto_r3b.run_abl("full", rx4, code, ITERATIONS),
            "proto_r4b phi": proto_r4b.run("phi", rx4, code, ITERATIONS)}
    for tag, v in runs.items():
        compare(f"{tag} vs study_phi {shape}", v, phi, code, False,
                identical=True)
    compare(f"the shipped tile SPA (SFU phi) vs study_phi_libm (libm phi) "
            f"{shape}", shipped, libm_phi, code, False)
    sp_agree = {n: float((v == shipped).all(1).float().mean())
                for n, v in (("study_phi", phi), ("study_phi_libm", libm_phi))}
    for two, one in (("skew2", "base"), ("skewlog", "explog")):
        compare(f"proto_r3b {two} vs {one} {shape}",
                proto_r3b.run(two, rx4, code, ITERATIONS),
                proto_r3b.run(one, rx4, code, ITERATIONS), code, False,
                identical=True)
    # every instance at 0 and 1 step and on a saturating rx (inf and NaN
    # must pass through kernel and plain version alike) against its plain
    # version on the kernels' algorithms: 0 mismatching frames
    for name in cuda_study.INSTANCES:
        for tag, rx, steps in (("iterations 0", rxi, 0), ("iterations 1", rxi, 1),
                               ("saturating rx (+-30)", sat, ITERATIONS)):
            compare(f"{name} vs plain (mirror) {tag}",
                    cuda_study.study_decode(name, rx, code, steps),
                    cuda_study.study_plain(name, rx, code, steps,
                                           phi="mirror"), code,
                    False, identical=True)
    # the aggregation-precision instances' agreement with the shipped
    # precise SPA on rx4
    for name in SP_NEW:
        sp_agree[name] = float((cuda_study.study_decode(
            name, rx4, code, ITERATIONS) == shipped).all(1).float().mean())
        log(f"[kernels] {name} vs the shipped precise SPA {shape}: frame "
            f"agreement {sp_agree[name]:.5f}")
        if name in SP_FAST and not sp_agree[name] >= FIXED_MIN_AGREE:
            raise AssertionError(f"{name}: agreement {sp_agree[name]} with "
                                 f"the shipped precise SPA")
        # the mirror bar tells a rounding form from the f32 one: were the
        # kernel to drop its bf16 or lo-half rounding, it would decide as
        # the shipped SPA and miss its mirror on more frames than the bar
        if (name in SP_ROUNDED
                and not 1 - sp_agree[name]
                > 2 * cuda_study.MIRROR_MAX_SHARE):
            raise AssertionError(f"{name}: within twice the mirror bar of the "
                                 f"shipped precise SPA; the bar cannot tell "
                                 f"its rounding")
    del shipped, runs, phi, libm_phi
    # the min-sum study: each instance against its plain version (0), the
    # yardstick against the shipped precise min-sum (0), and each instance's
    # agreement with it: the bf16-aggregation candidates keep the fast
    # contract (>= 99%), the others are reported
    shipped = kernels["minsum"](rx4, code, ITERATIONS, mode="precise")
    ms_agree = {}
    for name in cuda_study_ms.INSTANCES:
        vk = cuda_study_ms.study_ms_decode(name, rx4, code, ITERATIONS)
        vp = cuda_study_ms.study_ms_plain(name, rx4, code, ITERATIONS)
        torch.cuda.synchronize()
        max_err[name] = compare(f"{name} vs plain {shape}", vk, vp, code,
                                False, identical=True)
        ms_agree[name] = float((vk == shipped).all(1).float().mean())
        log(f"[kernels] {name} vs the shipped precise min-sum {shape}: "
            f"frame agreement {ms_agree[name]:.5f}")
        if name == "study_ms_ref":
            compare(f"{name} vs the shipped precise min-sum {shape}", vk,
                    shipped, code, False, identical=True)
        elif name in MS_FAST and not ms_agree[name] >= FIXED_MIN_AGREE:
            raise AssertionError(f"{name}: agreement {ms_agree[name]} with "
                                 f"the shipped precise min-sum")
    del shipped, vk, vp
    # every min-sum instance on its two-frame skeleton at few steps (the
    # trailing check step alone, one and 18 full steps before it), on the
    # saturating rx, and at an odd B (4,097 frames: a last block of one
    # frame, whose thread's second frame lies past B; 31: one block)
    # against its plain version: 0 mismatching frames
    rxo = codewords(code, 4097, PARITY_EBN0_DB, 9)
    for name in cuda_study_ms.INSTANCES:
        for tag, rx, steps in (("iterations 0", rxi, 0),
                               ("iterations 1", rxi, 1),
                               ("iterations 2", rxi, 2),
                               ("iterations 19", rxi, 19),
                               ("saturating rx (+-30)", sat, ITERATIONS),
                               ("4097 frames", rxo, ITERATIONS),
                               ("31 frames", rxo[:31], 5)):
            compare(f"{name} vs plain {tag}",
                    cuda_study_ms.study_ms_decode(name, rx, code, steps),
                    cuda_study_ms.study_ms_plain(name, rx, code, steps), code,
                    False, identical=True)
    del rxo
    # the loop-unroll study: the new instances at few steps (the unrolled
    # blocks and the remainder) and on the saturating rx against their plain
    # versions, and each unrolled instance against its unroll-1 sibling: an
    # unroll changes no arithmetic, 0 mismatching frames
    decoders = {**{n: (cuda_study.study_decode, cuda_study.study_plain)
                   for n in cuda_study.INSTANCES},
                **{n: (cuda_study_ms.study_ms_decode,
                       cuda_study_ms.study_ms_plain)
                   for n in cuda_study_ms.INSTANCES}}
    for name in UNROLL_NEW:
        dec, plain = decoders[name]
        # a MUFU instance: 0, 1 step and the saturating rx against the
        # mirror above; at 2 and 5 steps the fixed contract against its IEEE
        # plain version and the mirror bar against its mirror
        sfu = name in cuda_study.INSTANCES and cuda_study.uses_sfu(name)
        for tag, rx, steps in (("iterations 0", rxi, 0), ("iterations 1", rxi, 1),
                               ("iterations 2", rxi, 2), ("iterations 5", rxi, 5),
                               ("saturating rx (+-30)", sat, ITERATIONS)):
            if sfu and steps in (2, 5):
                vk = dec(name, rx, code, steps)
                compare(f"{name} vs plain {tag}", vk,
                        plain(name, rx, code, steps), code, False)
                compare(f"{name} vs plain (mirror) {tag}", vk,
                        plain(name, rx, code, steps, phi="mirror"), code,
                        False, max_share=cuda_study.MIRROR_MAX_SHARE)
            elif not sfu:
                compare(f"{name} vs plain {tag}", dec(name, rx, code, steps),
                        plain(name, rx, code, steps), code, False,
                        identical=True)
    for name, sib in siblings.items():
        dec = decoders[name][0]
        compare(f"{name} vs {sib} {shape}", dec(name, rx4, code, ITERATIONS),
                dec(sib, rx4, code, ITERATIONS), code, False, identical=True)
    # the textbook SPA (r once in the loop, r + sum E < 0) beside the shipped
    # SPA: agreement, and the frame error share against the codewords sent
    # (rx4's first draw, regenerated from its seed); reported, no bar
    sent4 = encode_bits(torch.randint(
        0, 2, (N_FRAMES, code.K),
        generator=torch.Generator(device=dev).manual_seed(1000), device=dev,
        dtype=torch.int8), code)
    if not float(((rx4 > 0).to(torch.int8) == sent4).float().mean()) > 0.9:
        raise AssertionError("the regenerated codewords are not rx4's")
    textbook = {
        "shipped precise SPA": kernels["sumproduct"](rx4, code, ITERATIONS,
                                                     mode="precise"),
        "shipped fast SPA": kernels["sumproduct"](rx4, code, ITERATIONS,
                                                  mode="fast"),
        TEXTBOOK: cuda_study.study_decode(TEXTBOOK, rx4, code, ITERATIONS),
        "study_ms_current": cuda_study_ms.study_ms_decode(
            "study_ms_current", rx4, code, ITERATIONS)}
    shipped = textbook["shipped precise SPA"]
    textbook = {k: (float((v == shipped).all(1).float().mean()),
                    float((v != sent4).any(1).float().mean()))
                for k, v in textbook.items()}
    for k, (agree, fer) in textbook.items():
        log(f"[kernels] {k} {shape}: frame agreement with the shipped "
            f"precise SPA {agree:.5f}, frame error share against the sent "
            f"codewords {fer:.6f}")
    del shipped, sent4

    # the streaming blocks' loop kernels against their plain versions on the
    # card: output and state bit for bit, and uneven pieces, each cut
    # inside a tile, the one call's
    loop_res = dsp_loops_check.check(dev, log=log)
    for name, r in loop_res.items():
        max_err[name] = r["max_abs_err"]
    # the AGC's serial route on the inputs that take it, bit for bit; the
    # Costas kernel's wrap and sincosf over every float of their ranges
    serial_res = dsp_loops_check.serial_route(dev, log=log)
    max_err["agc_loop"] = max(r["max_abs_err"] for r in serial_res.values())
    dsp_loops_check.shortcuts(dev, log=log)
    # the clock tracker's kernel against its plain version, a block a call
    # along the plain version's trajectory, and one launch at the main
    # path's shapes against the kernel a block a call, both at each cluster
    # size
    track_res = pfb_track_check.check(dev, log=log)
    max_err[cuda_dsp.TRACKER] = max(
        r["max_abs_err"] for r in track_res.values() if "max_abs_err" in r)
    # the wide kernels at the shape of sim_80211n_1944.bp's steps (131,072
    # frames x 20 iterations), against their plain versions and the SPA's
    # mirror: the precise contract (tools/wide_check.py)
    wide_code = get_code(WIDE_CODE)
    for row in wide_check.contract(wide_code, STEP_FRAMES, WIDE_PTS, dev,
                                   log=lambda s: log(f"[kernels] wide {s}")):
        name = f"bp_{row['method']}_wide"
        max_err[name] = max(max_err[name], int(row["plain"]["mismatch"] > 0))

    # -- 4. paths -----------------------------------------------------------
    def drive(path, fn, want, launches=(cuda_bp.LAUNCHES,)):
        for counter in launches:
            counter.update(dict.fromkeys(counter, 0))
        out = fn()
        torch.cuda.synchronize()
        counts = {k: n for counter in launches for k, n in counter.items()}
        log(f"[{path}] launches during the path: {counts}")
        for name in want:
            if counts[name] < 1:
                raise AssertionError(f"the {path} path did not launch {name}")
        return out, counts

    forward, (gen_fwd, _) = entry(device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    data = torch.randint(0, 256, (N_FRAMES, code.K // 8), generator=g,
                         device=dev, dtype=torch.uint8)
    rx5 = awgn(torch.Generator(device=dev).manual_seed(2),
               encode_to_symbols(data, code), EBN0_DB)
    decode_ms = make_decoder(code, 0, ITERATIONS, early_exit=False,
                             backend="auto")
    (out_sp, out_ms), fwd_counts = drive(
        "forward", lambda: (forward(gen_fwd, data),
                            pack_bits(decode_ms(rx5)[:, code.M:])),
        ("bp_sumproduct", "bp_minsum"))
    for method, out in (("sumproduct", out_sp), ("minsum", out_ms)):
        if out.shape != data.shape or out.dtype != torch.uint8:
            raise AssertionError(f"{method}: output {out.shape} {out.dtype}")
        fer = float((out != data).any(1).float().mean())
        log(f"[forward] {method}: payload frame error share {fer} over "
            f"{N_FRAMES} frames at {EBN0_DB} dB (limit {FER_MAX[method]})")
        if not fer <= FER_MAX[method]:
            raise AssertionError(f"{method}: payload frame error share {fer}")
    # the kernel against the plain reference decoders of ops/decode.py
    ref = make_decoder(code, "sumproduct", ITERATIONS, early_exit=False,
                       backend="torch")
    compare("sumproduct kernel vs ops.decode reference, 4096 frames @5dB",
            kernels["sumproduct"](rx5[:4096], code, ITERATIONS, mode="precise"),
            ref(rx5[:4096]), code, early_exit=False)
    for method in kernels:
        vk, vp = run_pair(method, rx5, code, ITERATIONS, False)
        max_err[f"bp_{method}"] = compare(
            f"{method} fixed, main-path rx {N_FRAMES} @{EBN0_DB}dB", vk, vp,
            code, early_exit=False)

    ref_curve = json.loads(open(SWEEP_REF).read())
    big = gen[512]
    large_pts = list(LARGE_PTS)

    def sweeps():
        res = run_waterfall("sim_50_100", SWEEP_GRID,
                            frames_per_point=SWEEP_FRAMES,
                            iterations=SWEEP_ITERS,
                            frames_per_step=STEP_FRAMES, device=dev)
        resl = run_waterfall(big, large_pts, frames_per_point=N_FRAMES,
                             iterations=ITERATIONS,
                             methods=("minsum", "sumproduct"), device=dev)
        resw = run_waterfall(WIDE_CODE, list(WIDE_SWEEP_PTS),
                             frames_per_point=2 * STEP_FRAMES,
                             iterations=ITERATIONS,
                             methods=("minsum", "sumproduct"), device=dev)
        return res, resl, resw

    (res, resl, resw), sweep_counts = drive(
        "sweep", sweeps, ("bp_sumproduct", "bp_minsum", "bp_sumproduct_large",
                          "bp_minsum_large", "bp_sumproduct_wide",
                          "bp_minsum_wide"))
    for m in resw.methods:
        log(f"[sweep] {WIDE_CODE} {m}, {ITERATIONS} iterations, "
            f"{resw.frames_per_point} frames: FER {resw.fer[m].tolist()} "
            f"at {list(WIDE_SWEEP_PTS)} dB, "
            f"{sweep_counts[f'bp_{m}_wide']} wide launches")
    misses = band_check(res, ref_curve)
    log(f"[sweep] sim_50_100: {len(res.ebn0_db)} points x "
        f"{len(res.methods)} methods x {res.frames_per_point} frames, "
        f"{len(misses)} outside the 5-sigma bands of {SWEEP_REF}")
    for line in res.to_table().splitlines():
        log(f"    {line}")
    if misses or res.frames_per_point != ref_curve["frames_per_point"]:
        raise AssertionError("sweep outside its band: " + "; ".join(misses))
    for m in resl.methods:
        log(f"[sweep] {big.name} {m}, {ITERATIONS} iterations, "
            f"{resl.frames_per_point} frames: FER {resl.fer[m].tolist()} "
            f"BER {resl.ber[m].tolist()} at {large_pts} dB")
        if not (np.diff(resl.fer[m]) < 0).all():
            raise AssertionError(f"{big.name} {m}: FER does not fall with SNR")

    # the anchor: the sweep's sim_50_100 result against the reference binary
    # ldpc_lapack's committed run, then a sim_8_16 sweep against
    # ldpc_umfpack's
    umf = anchor.load_record("umfpack")["reference_run"]
    res_umf, umf_counts = drive(
        "anchor", lambda: run_waterfall(
            anchor.CODES["umfpack"], umf["ebn0_db"],
            frames_per_point=ANCHOR_FRAMES, iterations=anchor.ITERATIONS,
            methods=tuple(anchor.method_map(umf).values()), device=dev),
        ("bp_minsum",))
    for name, r in (("lapack", res), ("umfpack", res_umf)):
        report = anchor.anchor_check(r, name)
        log(f"[anchor] {r.code_name}, {r.frames_per_point} frames a point, "
            f"against {anchor.RECORDS[name].name}: {anchor.summary(report)}")
        for m, v in report["methods"].items():
            for p in v["violations"]:
                log(f"    {m} at {p['ebn0_db']:+.1f} dB: {p['ours']:.6g} "
                    f"outside [{p['band'][0]:.4g}, {p['band'][1]:.4g}] "
                    f"({p['ref_count']} of {anchor.FRAMES})")
        if report["total_violations"] > anchor.MAX_VIOLATIONS:
            raise AssertionError(f"{r.code_name}: "
                                 f"{report['total_violations']} points "
                                 f"outside the reference run's bands")

    vx, dec_counts = drive(
        "decode", lambda: {m: kernels[m](rx5, code) for m in kernels},
        ("bp_sumproduct_exact", "bp_minsum_exact"))
    for method, v in vx.items():
        compare(f"{method} default (exact) vs ops.decode f32 path, main-path "
                f"rx", v, f32_paths[method](rx5, code, ITERATIONS,
                                            early_exit=False),
                code, False, min_agree=EXACT_MIN_AGREE)
    path_counts = {"": fwd_counts, "_large": sweep_counts,
                   "_exact": dec_counts, "_wide": sweep_counts}
    # the sweep's tile launches (the anchor reads its sim_50_100 result) and
    # the anchor's own sim_8_16 sweep
    for name in ("bp_minsum", "bp_sumproduct"):
        fwd_counts[name] += sweep_counts[name] + umf_counts[name]

    # the streaming receiver at bench.py's receiver shape: every receive
    # path for both methods, then each held to the others and to the plain
    # decoders on the frames cut at the lock
    sent_rx, stream_rx = receive_check.make_stream(code, receive_check.FRAMES,
                                                   dev)
    rx_paths, rx_counts = drive(
        "receive", lambda: {m: receive_check.receive_paths(code, stream_rx, m,
                                                           dev)
                            for m in receive_check.METHODS},
        ("bp_minsum", "bp_sumproduct"))
    for m in receive_check.METHODS:
        receive_check.check(code, stream_rx, sent_rx, rx_paths[m], m, dev,
                            log=log)
    del rx_paths
    for name in ("bp_minsum", "bp_sumproduct"):    # launches on both paths
        fwd_counts[name] += rx_counts[name]
    dryrun_multichip(4, device=dev)

    # the flowgraph path: the image loopback through the port's blocks on
    # the card, both methods (leg a); then the decoder block's sync machine
    # on a recorded stream, on the card and on the CPU, held to each other
    # (leg b); then examples/example4_full.yaml, the receive DSP chain into
    # the decoder block (leg c), and the sync prototypes example2/3.yaml on
    # the card and on the CPU
    def flowgraph_legs():
        loop = {m: flowgraph_check.image_loopback(m, dev, log=log)
                for m in flowgraph_check.KERNEL}
        link = flowgraph_check.make_link(flowgraph_check.FRAMES, dev)
        acq = {m: flowgraph_check.acquisition(m, dev, link=link, log=log)
               for m in flowgraph_check.KERNEL}
        chain = {m: flowgraph_check.dsp_chain(m, dev, log=log)
                 for m in flowgraph_check.KERNEL}
        for d in (dev, "cpu"):
            flowgraph_check.sync_prototypes(d, log=log)
        return loop, acq, chain

    (fg_loop, fg_acq, fg_chain), fg_counts = drive(
        "flowgraph", flowgraph_legs, ("bp_minsum", "bp_sumproduct",
                                      cuda_dsp.SCAN, "costas_loop",
                                      cuda_dsp.TRACKER),
        (cuda_bp.LAUNCHES, cuda_dsp.LAUNCHES))
    for name in ("bp_minsum", "bp_sumproduct"):    # launches on three paths
        fwd_counts[name] += fg_counts[name]
    # the loop kernels at the shapes leg (c) gave them, each chunk the AGC
    # and Costas blocks got against the plain versions (these launches come
    # after the path's counts were read)
    for r in fg_chain.values():
        for name, rec in dsp_loops_check.check_main_path(
                r.pop("loops"), dev, log=log).items():
            max_err[name] = max(max_err[name], rec["max_abs_err"])

    # the AGC block on the inputs that take its serial route
    def agc_edge():
        out = {}
        for name, _ in dsp_loops_check.SERIAL_INPUTS:
            x, g0 = dsp_loops_check.serial_input(name, "cpu")
            block = AgcBlock2(device=dev, **dsp_loops_check.AGC)
            block.gain = g0
            out[name] = (x, g0, block.work(x.numpy())[1])
        return out

    edge_out, edge_counts = drive("agc edge", agc_edge, ("agc_loop",),
                                  (cuda_dsp.LAUNCHES,))
    if edge_counts["agc_loop"] != len(dsp_loops_check.SERIAL_INPUTS):
        raise AssertionError(f"agc edge: agc_loop launched "
                             f"{edge_counts['agc_loop']} times")
    for name, (x, g0, y) in edge_out.items():
        want = dsp.agc(x.to(dev), gain0=g0, **dsp_loops_check.AGC)[0]
        if not np.array_equal(y.view(np.int32), want.cpu().numpy().view(
                np.int32)):
            raise AssertionError(f"agc edge, {name}: the block's output is "
                                 f"not the public function's")
    log(f"[agc edge] the block's outputs are the public function's on the "
        f"card, bit for bit, on {list(edge_out)}")

    # the receive chain: raw sample streams through rx_chain_pairs in three
    # settings, each into the receiver with both methods; each held to the
    # sent frames and its body kernel to the plain version; the app's
    # setting also through the chain and the receive on the CPU
    ch_data, ch_xp = bench_chain.impaired_stream(code, CHAIN_FRAMES, 3, dev)
    app_data, app_xp = bench_chain.impaired_stream(code, CHAIN_APP_FRAMES, 5,
                                                   dev)
    ch_cfg = chain_check.CONFIGS

    def chain_path():
        sp = chain_check.chains(ch_xp, {k: ch_cfg[k] for k in ("track", "ff")})
        sp.update(chain_check.chains(app_xp, {"app": ch_cfg["app"]}))
        return sp, {(tag, m): chain_check.receive(code, s[0], m)
                    for tag, s in sp.items() for m in receive_check.METHODS}

    (ch_sp, ch_res), ch_counts = drive(
        "chain", chain_path, ("bp_minsum", "bp_sumproduct", cuda_dsp.TRACKER),
        (cuda_bp.LAUNCHES, cuda_dsp.LAUNCHES))
    for (tag, m), r in ch_res.items():
        sent = (app_data if tag == "app" else ch_data).cpu().numpy()
        chain_check.check(code, sent, ch_sp[tag][0], r, m, tag, log=log)
    for name in ("bp_minsum", "bp_sumproduct"):    # launches on four paths
        fwd_counts[name] += ch_counts[name]
    t0 = time.perf_counter()
    cpu_sp = chain_check.chains(app_xp.cpu(), {"app": ch_cfg["app"]})["app"]
    log(f"[chain] app on the CPU: the chain in {time.perf_counter() - t0:.1f} "
        f"s; its symbols against the card's: max |difference| "
        f"{float((cpu_sp - ch_sp['app'].cpu()).abs().max()):.3e} over "
        f"{cpu_sp.shape[1]} symbols (card {ch_sp['app'].shape[1]})")
    for m, name in receive_check.METHODS.items():
        r = chain_check.receive(code, cpu_sp[0], m)
        if not chain_check.same_result(ch_res[("app", m)], r):
            raise AssertionError(f"chain app {name}: the CPU's receive differs "
                                 f"from the card's")
        log(f"[chain] app {name}: the CPU's lock, frames, accepts and bytes "
            f"are the card's")
    del ch_sp, ch_res, cpu_sp

    # the parity against the C++ float64 oracle, one batch: the f32 path,
    # the tile kernels and their plain versions on the card, the oracle on
    # the host's cores; every frame on two different valid codewords in any
    # pair diagnosed, and a boundary frame
    par, par_counts = drive("parity", lambda: parity_f64.run_parity(
        1, dev, log=log), ("bp_minsum", "bp_sumproduct"))
    for m, r in par["results"].items():
        log(f"[parity] {m}, {r['frames']} frames: " + "; ".join(
            f"{p} mismatched share {r[p]['mismatch'] / r['frames']:.3g} "
            f"{json.dumps(r[p])}" for p in parity_f64.PAIRS)
            + f"; valid words {json.dumps(r['valid'])} [{card}]")
    log(f"[parity] {len(par['cases'])} frames on two different valid "
        f"codewords, {sum(c['boundary'] for c in par['cases'])} of them "
        f"boundary frames; {par['wall_s']:.1f} s, the oracle "
        f"{par['oracle_wall_s']:.1f} s on {par['oracle_threads']} threads")
    if misses := parity_f64.check(par):
        raise AssertionError("parity against the float64 oracle: "
                             + "; ".join(misses))
    for name in ("bp_minsum", "bp_sumproduct"):    # the parity's launches too
        fwd_counts[name] += par_counts[name]

    # each study script's main at the prototypes' size: its variants'
    # kernels, timed beside their plain versions
    study_rows, study_counts = [], dict.fromkeys(cuda_study.INSTANCES, 0)
    log(f"[study] before: {clock_line()}")
    for tool in (ablate_pallas, proto_r3b, proto_r4b):
        want = {*tool.VARIANTS.values(),
                *getattr(tool, "ABL_VARIANTS", {}).values()}
        rows, counts = drive(
            tool.__name__.rsplit(".", 1)[1],
            functools.partial(tool.main, "cuda", N_FRAMES, ITERATIONS), want,
            (cuda_study.LAUNCHES,))
        study_rows += rows
        for name, n in counts.items():
            study_counts[name] += n
    for row in study_rows:   # the parity candidates against their reference
        if row["tag"].startswith("spa-") and not row["agree"] >= FIXED_MIN_AGREE:
            raise AssertionError(f"{row['tag']} {row['variant']}: agreement "
                                 f"{row['agree']} with the shipped kernel")
    # the main() of fast_kernel_proto, proto_r2 and proto_r3 (and its
    # main_v2), each with its sum-product and min-sum kinds: each must launch
    # every instance it names; the min-sum bf16-aggregation candidates keep
    # the fast contract against their script's reference (the shipped
    # precise min-sum; fast_kernel_proto: the f32 path on its first 4,096
    # frames), and the SPA ones against the shipped precise SPA
    ms_rows, sp_rows = [], []
    ms_counts = dict.fromkeys(cuda_study_ms.INSTANCES, 0)
    for tool, fn in ((fast_kernel_proto, "main"), (proto_r2, "main"),
                     (proto_r3, "main"), (proto_r3, "main_v2")):
        if fn == "main_v2":
            want = set(proto_r3.V2_VARIANTS.values())
        elif tool is fast_kernel_proto:
            want = set(tool.VARIANTS.values())
        else:
            want = {i for v in tool.VARIANTS.values() for i in v.values()}
        if tool is proto_r2:
            want |= set(proto_r2.REF.values())
        name = tool.__name__.rsplit(".", 1)[1]
        rows, counts = drive(
            name if fn == "main" else f"{name}.{fn}",
            functools.partial(getattr(tool, fn), "cuda", N_FRAMES, ITERATIONS),
            want, (cuda_study.LAUNCHES, cuda_study_ms.LAUNCHES))
        ms_rows += [r for r in rows if r["tag"].startswith("ms-")]
        sp_rows += [r for r in rows if r["tag"].startswith("sp-")]
        for inst, n in counts.items():
            (study_counts if inst in study_counts else ms_counts)[inst] += n
    # the loop-unroll study's main: every (kind, unroll) it names; every form
    # but the textbook SPA keeps the fast contract against its reference
    # (the shipped kernel in the script's mode)
    unroll_rows = []
    for tool in (proto_r3c, proto_r4):
        rows, counts = drive(
            tool.__name__.rsplit(".", 1)[1],
            functools.partial(tool.main, "cuda", N_FRAMES, ITERATIONS),
            {i for v in tool.VARIANTS.values() for i in v.values()},
            (cuda_study.LAUNCHES, cuda_study_ms.LAUNCHES))
        unroll_rows += rows
        for inst, n in counts.items():
            (study_counts if inst in study_counts else ms_counts)[inst] += n
    for row in unroll_rows:
        if (not row["instance"].startswith(TEXTBOOK)
                and not row["agree"] >= FIXED_MIN_AGREE):
            raise AssertionError(f"{row['tag']} {row['variant']}: agreement "
                                 f"{row['agree']} with its reference")
    for row in ms_rows:
        if row["instance"] in MS_FAST and not row["agree"] >= FIXED_MIN_AGREE:
            raise AssertionError(f"{row['tag']} {row['variant']}: agreement "
                                 f"{row['agree']} with its reference")
    for row in sp_rows:
        if ((row["instance"] in SP_FAST or row["tag"] == "sp-ref")
                and not row["agree"] >= FIXED_MIN_AGREE):
            raise AssertionError(f"{row['tag']} {row['variant']}: agreement "
                                 f"{row['agree']} with its reference")

    # -- 5. times ---------------------------------------------------------------
    log(f"[times] before: {clock_line()}")

    def pair_ms(tag, k, p, bits):
        p1, k1, k2, p2 = (time_decode(p), time_decode(k), time_decode(k),
                          time_decode(p))
        km, pm = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"[times] {tag}: kernel {k1:.4f} / {k2:.4f} ms "
            f"({bits / (km / 1e3):.4e} info bit/s), plain "
            f"{p1:.4f} / {p2:.4f} ms ({bits / (pm / 1e3):.4e} "
            f"info bit/s) [{card}]")
        return km, pm

    info_bits = N_FRAMES * code.K
    times = {}
    for method in kernels:
        for early_exit in (False, True):
            form = "early_exit" if early_exit else "fixed"
            t = pair_ms(
                f"{method} {form} {shape}",
                lambda: kernels[method](rx4, code, ITERATIONS, mode="precise",
                                        early_exit=early_exit),
                lambda: plains[method](rx4, code, ITERATIONS, early_exit),
                info_bits)
            if not early_exit:
                times[f"bp_{method}"] = t
        times[f"bp_{method}_exact"] = pair_ms(
            f"{method} exact {shape}",
            lambda: kernels[method](rx4, code, ITERATIONS),
            lambda: exact_plains[method](rx4, code, ITERATIONS), info_bits)
        rxl = codewords(big, LARGE_FRAMES, 2.0, 6)
        times[f"bp_{method}_large"] = pair_ms(
            f"{method} large fixed {big.name} {LARGE_FRAMES}x{ITERATIONS} @2dB",
            lambda: kernels[method](rxl, big, ITERATIONS, mode="precise"),
            lambda: plains[method](rxl, big, ITERATIONS, False),
            LARGE_FRAMES * big.K)
        for c, rxt in ((big, codewords(big, N_FRAMES, 2.0, 7)), (code, rx4)):
            for impl in ("gram", "split"):
                if impl == "gram" and not cuda_bp.kernel_supported(c):
                    continue
                ms = time_decode(lambda: kernels[method](
                    rxt, c, ITERATIONS, mode="precise", impl=impl))
                log(f"[times] {method} impl={impl} fixed {c.name} {N_FRAMES}x"
                    f"{ITERATIONS}: kernel {ms:.4f} ms "
                    f"({N_FRAMES * c.K / (ms / 1e3):.4e} info bit/s) [{card}]")
    # the wide kernels at sim_80211n_1944.bp's step, 1.5 dB: fixed and early
    # exit by CUDA events, the plain version's fixed form once
    for row in wide_check.times(wide_code, STEP_FRAMES, 1.5, dev,
                                log=lambda s: log(f"[times] wide {s} [{card}]")):
        times[f"bp_{row['method']}_wide"] = (row["fixed_ms"], row["plain_ms"])

    def interleaved(fns):
        """Each of fns timed twice, in the order last to first, then
        first to last, each time logged; {name: the mean of the two}."""
        order = list(fns)[::-1] + list(fns)
        runs = [(n, time_decode(fns[n])) for n in order]
        mean = {}
        for n in fns:
            ms_n = [t for m, t in runs if m == n]
            mean[n] = sum(ms_n) / 2
            log(f"[times] {n} {shape}, interleaved: {ms_n[0]:.4f} / "
                f"{ms_n[1]:.4f} ms [{card}]")
        return mean

    # the tile SPA against study_phi (its fixed form, which must time within
    # STUDY_PHI_TIME of it), study_phi_libm (the same with the libm phi it
    # had before its SFU check step) and study_stub (the skeleton, no
    # transcendental), interleaved; then each SPA kernel's MUFU floor: the
    # log tanh's MUFU instructions, two an edge and check step, at 16 a
    # clock an SM, at the SM clock the kernel held back to back
    spa = {"tile SPA": lambda: kernels["sumproduct"](rx4, code, ITERATIONS,
                                                       mode="precise"),
           **{n: functools.partial(cuda_study.study_decode, n, rx4, code,
                                   ITERATIONS)
              for n in ("study_phi", "study_phi_libm", "study_stub")}}
    spa_mean = interleaved(spa)
    phi_ratio = spa_mean["study_phi"] / spa_mean["tile SPA"]
    log(f"[times] study_phi / the shipped tile SPA {phi_ratio:.4f}, "
        f"study_phi_libm / study_phi "
        f"{spa_mean['study_phi_libm'] / spa_mean['study_phi']:.4f}, "
        f"study_stub / study_phi "
        f"{spa_mean['study_stub'] / spa_mean['study_phi']:.4f} [{card}]")
    if not abs(phi_ratio - 1) <= STUDY_PHI_TIME:
        raise AssertionError(f"study_phi takes {phi_ratio:.4f} x the shipped "
                             f"tile SPA's time, beyond {STUDY_PHI_TIME}")
    # the tile min-sum against study_ms_ref (its fixed form, which must
    # time within STUDY_MS_REF_TIME of it), study_ms_stub_check (no check
    # step: Lr = Lq / 2) and study_ms_stub_mm (no aggregation: Lq = Lci +
    # the slot's own Lr), interleaved as the SPA's
    msk = {"tile min-sum": lambda: kernels["minsum"](rx4, code, ITERATIONS,
                                                     mode="precise"),
           **{n: functools.partial(cuda_study_ms.study_ms_decode, n, rx4,
                                   code, ITERATIONS)
              for n in ("study_ms_ref", "study_ms_stub_check",
                        "study_ms_stub_mm")}}
    msk_mean = interleaved(msk)
    ref_ratio = msk_mean["study_ms_ref"] / msk_mean["tile min-sum"]
    log(f"[times] study_ms_ref / the shipped tile min-sum {ref_ratio:.4f}, "
        f"study_ms_stub_check / study_ms_ref "
        f"{msk_mean['study_ms_stub_check'] / msk_mean['study_ms_ref']:.4f}, "
        f"study_ms_stub_mm / study_ms_ref "
        f"{msk_mean['study_ms_stub_mm'] / msk_mean['study_ms_ref']:.4f} "
        f"[{card}]")
    if not abs(ref_ratio - 1) <= STUDY_MS_REF_TIME:
        raise AssertionError(f"study_ms_ref takes {ref_ratio:.4f} x the "
                             f"shipped tile min-sum's time, beyond "
                             f"{STUDY_MS_REF_TIME}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_ms = {}
    for name, c, frames, rxt in (("bp_sumproduct", code, N_FRAMES, rx4),
                                 ("bp_sumproduct_large", big, LARGE_FRAMES,
                                  codewords(big, LARGE_FRAMES, 2.0, 6))):
        loaded, samples = under_load(functools.partial(
            kernels["sumproduct"], rxt, c, ITERATIONS, mode="precise"), 2.0)
        mhz = float(np.median([smp[0] for smp in samples]))
        sfu_ms[name] = (phi_mufu * 2 * int(c.H.sum()) * frames * ITERATIONS
                        / (16 * sms * mhz * 1e3))
        log(f"[times] {name} {c.name} {frames}x{ITERATIONS}: {loaded:.4f} ms "
            f"a call back to back at clocks.sm {mhz:.0f} MHz (median of "
            f"{len(samples)}); MUFU floor {sfu_ms[name]:.4f} ms "
            f"({phi_mufu} MUFU a log tanh) [{card}]")
    # the exact SPA's floors: its tanhf, IEEE division and logf (counted in
    # SASS as it writes them) once an edge and iteration, at the SM clock
    # it holds back to back
    parts = {p: by_pipe(ops) for p, ops in exact_mix(probe_sass()).items()}
    libm = {k: sum(c[k] for c in parts.values()) for k in parts["tanhf"]}
    loaded, samples = under_load(functools.partial(
        kernels["sumproduct"], rx4, code, ITERATIONS), 2.0)
    mhz = float(np.median([smp[0] for smp in samples]))
    floor = exact_floor_ms(libm, code, N_FRAMES, ITERATIONS, sms, mhz)
    sfu_ms["bp_sumproduct_exact"] = floor["xu"]
    issue_floor = {"bp_sumproduct_exact": floor["issue"]}
    log(f"[times] bp_sumproduct_exact {code.name} {N_FRAMES}x{ITERATIONS}: "
        f"{loaded:.4f} ms a call back to back at clocks.sm {mhz:.0f} MHz "
        f"(median of {len(samples)}); its libm calls an edge {parts}: MUFU "
        f"floor {floor['xu']:.4f} ms, issue floor {floor['issue']:.4f} ms "
        f"[{card}]")
    # each min-sum kernel's shared-memory floor (smem_ms): its wavefronts
    # (tools/issue_model.py: minsum_wavefronts, exact_minsum_wavefronts;
    # none for the slot tables and -rx of a register tier) at one a clock
    # an SM, at the SM clock the kernel holds back to back; the study's
    # min-sum instances on the shipped tile min-sum's skeleton (two frames
    # a thread) at their own message bytes
    smem_ms = {}
    for name, tile, c, frames, rxt in (
            ("bp_minsum", "tile", code, N_FRAMES, rx4),
            ("bp_minsum_exact", "exact", code, N_FRAMES, rx4),
            ("bp_minsum_large", "large", big, LARGE_FRAMES,
             codewords(big, LARGE_FRAMES, 2.0, 6))):
        loaded, samples = under_load(functools.partial(
            kernels["minsum"], rxt, c, ITERATIONS,
            mode="exact" if tile == "exact" else "precise"), 2.0)
        mhz = float(np.median([smp[0] for smp in samples]))
        tables = tile != "exact" or cuda_bp.tier(c, False) == 0
        waves = (exact_minsum_wavefronts(c, frames, ITERATIONS, tables)
                 if tile == "exact" else
                 minsum_wavefronts(c, frames, ITERATIONS,
                                  "large" if tile == "large" else "pairs"))
        smem_ms[name] = wavefront_ms(waves, sms, mhz)
        log(f"[times] {name} {c.name} {frames}x{ITERATIONS}: {loaded:.4f} ms "
            f"a call back to back at clocks.sm {mhz:.0f} MHz (median of "
            f"{len(samples)}); {waves:.4e} shared-memory wavefronts "
            f"({'tables' if tables else 'registers'}): floor "
            f"{smem_ms[name]:.4f} ms [{card}]")
        if tile == "tile":
            for n in cuda_study_ms.INSTANCES:
                msg_b, q_b = cuda_study_ms.message_bytes(n)
                smem_ms[n] = wavefront_ms(minsum_wavefronts(
                    c, frames, ITERATIONS, "pairs", msg_b, q_b), sms, mhz)
    # each SPA study instance's MUFU floor (sfu_ms): the MUFU instructions
    # of its check step's functions (phase 2's probes) at the evaluations
    # cuda_study.check_functions counts, at 16 a clock an SM, at the SM
    # clock the study's instances hold run in turn back to back
    _, samples = under_load(lambda: [cuda_study.study_decode(
        n, rx4, code, ITERATIONS) for n in cuda_study.INSTANCES], 1.0)
    study_mhz = float(np.median([smp[0] for smp in samples]))
    for n in cuda_study.INSTANCES:
        sfu_ms[n] = study_sfu_ms(study_mufu, cuda_study.check_functions(
            n, code), N_FRAMES, ITERATIONS, sms, study_mhz)
    log(f"[times] the SPA study's instances in turn back to back: clocks.sm "
        f"{study_mhz:.0f} MHz (median of {len(samples)}); MUFU a function "
        f"{study_mufu}; floors (ms) " + ", ".join(
            f"{n} {sfu_ms[n]:.4f}" for n in cuda_study.INSTANCES)
        + f" [{card}]")
    # the large-code kernels at the gen_256_512 sweep's shape (its steps'
    # decode: 131,072 frames, early exit), kernel only
    for method in kernels:
        for p, e in enumerate(LARGE_PTS):
            rxs = draw_frames(big, N_FRAMES, (0, p, 0), float(e), dev)[1]
            ms = time_decode(lambda: kernels[method](
                rxs, big, ITERATIONS, mode="precise", early_exit=True))
            log(f"[times] {method} large early_exit {big.name} {N_FRAMES}x"
                f"{ITERATIONS} @{e:+.1f}dB (a sweep step's decode): kernel "
                f"{ms:.4f} ms [{card}]")
        del rxs
    for _ in range(2):
        forward(gen_fwd, data)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        forward(gen_fwd, data)
    torch.cuda.synchronize()
    fwd = (time.perf_counter() - t0) / reps * 1e3
    log(f"[times] forward (encode, AWGN, sum-product x{ITERATIONS}, pack) "
        f"{N_FRAMES} frames: {fwd:.4f} ms host clock "
        f"({info_bits / (fwd / 1e3):.4e} info bit/s) [{card}]")
    tx5 = encode_to_symbols(data, code)
    bits5 = kernels["sumproduct"](rx5, code, ITERATIONS, mode="precise")
    stages = {"encode_to_symbols": lambda: encode_to_symbols(data, code),
              "awgn": lambda: awgn(gen_fwd, tx5, EBN0_DB),
              "decode (sum-product kernel)":
                  lambda: kernels["sumproduct"](rx5, code, ITERATIONS,
                                                mode="precise"),
              "pack_bits": lambda: pack_bits(bits5[:, code.M:])}
    for name, fn in stages.items():
        log(f"[times] forward stage {name}, {N_FRAMES} frames: "
            f"{time_decode(fn):.4f} ms [{card}]")
    # one step of the reference experiment (125,000 frames, 3 dB), by stage
    sim = get_code("sim_50_100")
    fps = SWEEP_FRAMES // 8
    key = (0, 20, 0)
    u, rxs = draw_frames(sim, fps, key, 3.0, dev)
    parts = {"draw_frames": lambda: draw_frames(sim, fps, key, 3.0, dev),
             "count_errors (one fetch)": lambda: count_errors(u, u, sim)}
    for m in res.methods:
        dec = (functools.partial(kernels[m], code=sim, iterations=5,
                                 mode="precise", early_exit=True)
               if m in kernels else make_decoder(sim, m, 5, backend="torch"))
        parts[f"decode {m}"] = functools.partial(dec, rxs)
    for name, fn in parts.items():
        log(f"[times] sweep step stage {name}, sim_50_100 {fps} frames: "
            f"{time_decode(fn):.4f} ms [{card}]")
    for m in res.methods:
        step = make_sweep_step(sim, dev, method=m, iterations=5,
                               frames_per_device=fps)
        step(key, 3.0)
        t0 = time.perf_counter()
        for _ in range(reps):
            step(key, 3.0)
        log(f"[times] sweep step {m}, sim_50_100 {fps} frames: "
            f"{(time.perf_counter() - t0) / reps * 1e3:.4f} ms host clock "
            f"[{card}]")
    for r in (res, resl):
        per_point = len(r.methods) * r.frames_per_point
        log(f"[times] sweep {r.code_name}: {r.wall_s:.4f} s host clock for "
            f"{len(r.ebn0_db)} points x {len(r.methods)} methods; per point "
            f"(s, frames/s): " + ", ".join(
                f"{e:+.1f} dB {s:.4f} {per_point / s:.4e}"
                for e, s in zip(r.ebn0_db, r.point_wall_s)) + f" [{card}]")
    # the study's table, each variant against its script's first
    # (ablate_pallas baseline; proto_r3b base and proto_r4b phi, study_phi)
    log(f"[study] block_32_64 {shape}, CUDA events, median of 20 "
        f"(plain: of 5) [{card}]")
    # and against study_phi (the shipped tile SPA's fixed form), beside
    # each instance's MUFU floor
    phi_ms = next(r["ms"] for r in study_rows if r["instance"] == "study_phi")
    log(f"    {'script':11s} {'variant':13s} {'instance':21s} {'kernel ms':>9s} "
        f"{'plain ms':>9s} {'Gbit/s':>7s} {'vs first':>8s} {'vs phi':>6s} "
        f"{'sfu ms':>6s} agree")
    firsts = {}
    for row in study_rows:
        first = firsts.setdefault(row["tag"].replace("abl", "spa-precise"),
                                  row["ms"])
        agree = "-" if row["agree"] is None else f"{row['agree']:.5f}"
        log(f"    {row['tag']:11s} {row['variant']:13s} {row['instance']:21s} "
            f"{row['ms']:9.4f} {row['plain_ms']:9.4f} {row['gbit_s']:7.3f} "
            f"{row['ms'] / first:8.3f} {row['ms'] / phi_ms:6.3f} "
            f"{sfu_ms[row['instance']]:6.4f} {agree}")
    for row in study_rows:    # each instance's time: its first variant's row
        times.setdefault(row["instance"], (row["ms"], row["plain_ms"]))
    # the SPA aggregation-precision table, each row against study_phi (the
    # shipped tile SPA's fixed form, proto_r2's sum-product yardstick),
    # beside its MUFU floor; "shipped" is phase 3's agreement with the
    # shipped precise SPA, "agree" the script's own reference's
    # (fast_kernel_proto: the f32 path)
    phi_ms = next(r["ms"] for r in sp_rows if r["tag"] == "sp-ref")
    log(f"[study-sp] block_32_64 {shape}, CUDA events, median of 20 "
        f"(plain: of 5) [{card}]")
    log(f"    {'script':9s} {'variant':10s} {'instance':19s} {'kernel ms':>9s} "
        f"{'plain ms':>9s} {'Gbit/s':>7s} {'vs phi':>6s} {'sfu ms':>6s} "
        f"{'shipped':>7s} agree")
    for row in sp_rows:
        shipped_agree = sp_agree[row["instance"]]
        log(f"    {row['tag']:9s} {row['variant']:10s} {row['instance']:19s} "
            f"{row['ms']:9.4f} {row['plain_ms']:9.4f} {row['gbit_s']:7.3f} "
            f"{row['ms'] / phi_ms:6.3f} {sfu_ms[row['instance']]:6.4f} "
            f"{shipped_agree:7.5f} {row['agree']:.5f}")
    for row in sp_rows:
        times.setdefault(row["instance"], (row["ms"], row["plain_ms"]))
    # the min-sum study's table, each row against study_ms_ref (the shipped
    # tile min-sum's fixed form), beside its shared-memory floor (smem ms),
    # registers, spill store/load bytes and blocks an SM (phase 2);
    # "shipped" is phase 3's agreement with the shipped precise min-sum,
    # "agree" the script's own reference's
    ref_ms = next(r["ms"] for r in ms_rows if r["instance"] == "study_ms_ref")
    log(f"[study-ms] block_32_64 {shape}, CUDA events, median of 20 "
        f"(plain: of 5) [{card}]")
    log(f"    {'script':9s} {'variant':10s} {'instance':19s} {'kernel ms':>9s} "
        f"{'plain ms':>9s} {'Gbit/s':>7s} {'vs ref':>6s} {'smem ms':>7s} "
        f"{'regs':>4s} {'spills':9s} {'blocks':>6s} {'shipped':>7s} agree")
    for row in ms_rows:
        n = row["instance"]
        log(f"    {row['tag']:9s} {row['variant']:10s} {n:19s} "
            f"{row['ms']:9.4f} {row['plain_ms']:9.4f} {row['gbit_s']:7.3f} "
            f"{row['ms'] / ref_ms:6.3f} {smem_ms[n]:7.4f} "
            f"{regs.get(n, -1):4d} {str(spills.get(n)):9s} "
            f"{ms_blocks[n]:6d} {ms_agree[n]:7.5f} {row['agree']:.5f}")
    for row in ms_rows:
        times.setdefault(row["instance"], (row["ms"], row["plain_ms"]))
    # the loop-unroll study's rows, then the unroll table: each unrolled
    # instance against its unroll-1 sibling, timed in one interleaved run
    # (sibling, unrolled, unrolled, sibling; each a median of 20)
    log(f"[study-unroll] block_32_64 {shape}, CUDA events, median of 20 "
        f"(plain: of 5) [{card}]")
    # each row against its study's yardstick (study_phi, study_ms_ref) and
    # beside its floor: the MUFU's (sfu_ms) or shared memory's (smem_ms)
    log(f"    {'script':8s} {'variant':17s} {'instance':21s} {'kernel ms':>9s} "
        f"{'plain ms':>9s} {'Gbit/s':>7s} {'vs yard':>7s} {'floor ms':>8s} "
        f"agree")
    for row in unroll_rows:
        sp = row["instance"] in cuda_study.INSTANCES   # else min-sum
        yard, floor = (phi_ms, sfu_ms) if sp else (ref_ms, smem_ms)
        log(f"    {row['tag']:8s} {row['variant']:17s} {row['instance']:21s} "
            f"{row['ms']:9.4f} {row['plain_ms']:9.4f} {row['gbit_s']:7.3f} "
            f"{row['ms'] / yard:7.3f} {floor[row['instance']]:8.4f} "
            f"{row['agree']:.5f}")
        times.setdefault(row["instance"], (row["ms"], row["plain_ms"]))
    log(f"[unroll] block_32_64 {shape}: unrolled vs unroll-1 sibling, "
        f"interleaved; SASS = static instructions, spills = ptxas store/load "
        f"bytes [{card}]")
    log(f"    {'instance':21s} {'ms':>8s} {'sibling ms':>10s} {'ratio':>6s} "
        f"{'plain ms':>9s} {'SASS':>6s} {'sib SASS':>8s} {'regs':>4s} spills")
    for name, sib in siblings.items():
        dec = decoders[name][0]
        s1, u1, u2, s2 = (time_decode(dec, n, rx4, code, ITERATIONS)
                          for n in (sib, name, name, sib))
        um, sm = (u1 + u2) / 2, (s1 + s2) / 2
        log(f"    {name:21s} {um:8.4f} {sm:10.4f} {um / sm:6.3f} "
            f"{times[name][1]:9.4f} {sass[name]:6d} {sass[sib]:8d} "
            f"{regs.get(name, -1):4d} {spills.get(name)} (sibling {sib}: "
            f"regs {regs.get(sib, -1)}, spills {spills.get(sib)}; "
            f"{s1:.4f} / {u1:.4f} / {u2:.4f} / {s2:.4f} ms)")
    log("    textbook SPA (no bar): " + "; ".join(
        f"{k} agree {a:.5f} FER {f:.6f}" for k, (a, f) in textbook.items()))
    # the receive: its wall, split and info bits/s; its body kernel alone
    for m, name in receive_check.METHODS.items():
        t = receive_check.time_receive(code, stream_rx, m, dev)
        log(f"[times] receive {name} {t['n_frames']} frames (offset "
            f"{receive_check.OFFSET}, inverted, {receive_check.EBN0_DB} dB, "
            f"{receive_check.ITERATIONS} iterations, early exit, fast, 8 "
            f"chunks, bitmask): {t['wall_s'] * 1e3:.4f} ms host clock, "
            f"median of {len(t['walls_s'])} after a warm-up ("
            + " ".join(f"{w * 1e3:.4f}" for w in t["walls_s"]) + f"), "
            f"{t['info_bit_s']:.4e} info bit/s; one profiled receive: "
            + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in t["profiled"].items())
            + f"; in one chunk {t['one_chunk_wall_s'] * 1e3:.4f} ms host "
            f"clock (median of {len(t['walls_s'])}); the body kernel by CUDA "
            f"events: a chunk of "
            f"{t['chunk_frames']} frames {t['chunk_ms']:.4f} ms (x8 "
            f"{8 * t['chunk_ms']:.4f}), the whole body {t['body_ms']:.4f} "
            f"ms [{card}]")
    del stream_rx, sent_rx
    # the flowgraph path's image loopback (phase 4's runs): its wall and
    # info bits/s by host clock, the decoder block's work() calls by host
    # clock; then its kernels alone on the batches it decoded, by CUDA events
    for m, r in fg_loop.items():
        k_ms = flowgraph_check.kernel_ms(r["decode"], r["batches"])
        log(f"[times] flowgraph image loopback {flowgraph_check.KERNEL[m]}: "
            f"{r['frames']} frames in {r['wall_s'] * 1e3:.4f} ms host clock "
            f"({r['info_bit_s']:.4e} info bit/s); the decoder block's work() "
            f"{r['work_s'] * 1e3:.4f} ms host clock "
            f"({100 * r['work_s'] / r['wall_s']:.1f}% of the wall); its "
            f"kernel alone on its {len(r['batches'])} batches "
            f"({sum(len(b) for b in r['batches'])} frames) {k_ms:.4f} ms by "
            f"CUDA events ({100 * k_ms / 1e3 / r['wall_s']:.2f}% of the "
            f"wall) [{card}]")
    del fg_loop
    # leg (c): its wall and info bits/s by host clock, each block's work()
    # by host clock, its decoder's kernel alone on its batches by CUDA events
    for m, r in fg_chain.items():
        k_ms = flowgraph_check.kernel_ms(r["decode"], r["batches"])
        log(f"[times] flowgraph dsp chain (example4_full.yaml) "
            f"{flowgraph_check.KERNEL[m]}, a {r['side']}x{r['side']} BMP x "
            f"{flowgraph_check.REPEATS} ({r['sent_frames']} frames sent), "
            f"{r['images']} images written: {r['wall_s'] * 1e3:.4f} ms host "
            f"clock ({r['info_bit_s']:.4e} info bit/s sent); work() by block, "
            f"host clock: " + ", ".join(
                f"{k} {v * 1e3:.4f} ms ({100 * v / r['wall_s']:.1f}%)"
                for k, v in r["work_s"].items())
            + f"; the decoder's kernel alone on its {len(r['batches'])} "
            f"batches ({sum(len(b) for b in r['batches'])} frames) "
            f"{k_ms:.4f} ms by CUDA events; the tracker "
            f"{r['segments']} segments, {cuda_dsp.TRACKER} launched "
            f"{r['launches'][cuda_dsp.TRACKER]} times [{card}]")
    del fg_chain
    for m, r in fg_acq.items():
        log(f"[times] flowgraph acquisition {flowgraph_check.KERNEL[m]}: "
            f"{r['frames_emitted']} frames emitted, {r['device_s'] * 1e3:.4f}"
            f" ms on the card, {r['cpu_s'] * 1e3:.4f} ms on the cpu (plain "
            f"versions), host clock [{card}]")
    # the receive chain: its stages, its samples a second by timing block,
    # and the chain with the receive by host clock
    for tag, xp_, kw in (("track", ch_xp, ch_cfg["track"]),
                         ("ff", ch_xp, ch_cfg["ff"]),
                         ("app", app_xp, ch_cfg["app"])):
        reps = 3
        st = chain_check.stage_ms(xp_, reps=reps, **kw)
        log(f"[times] chain stages {tag} {kw}, {xp_.shape[1]} samples, CUDA "
            f"events (median of {reps} after a warm-up): " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in st.items()) + f" ms [{card}]")
    for tbs in bench_chain.TIMING_BLOCKS:
        r = bench_chain.chain_rates(app_xp, reps=3, timing_block_syms=tbs)
        log(f"[times] chain, timing block {tbs}, {app_xp.shape[1]} samples: "
            f"{r['ms']['median']:.4f} ms (min {r['ms']['min']:.4f}, max "
            f"{r['ms']['max']:.4f}), {r['samples_s']:.4e} samples/s; the "
            f"half stream {r['half_ms']['median']:.4f} ms; from the "
            f"difference {r['slope_samples_s']} samples/s [{card}]")
    r = bench_chain.chain_rates(ch_xp, reps=3, **ch_cfg["track"])
    log(f"[times] chain composed {ch_cfg['track']}, {ch_xp.shape[1]} samples: "
        f"{r['ms']['median']:.4f} ms (min {r['ms']['min']:.4f}, max "
        f"{r['ms']['max']:.4f}), {r['samples_s']:.4e} samples/s; from the "
        f"difference {r['slope_samples_s']} samples/s [{card}]")
    for m, name in receive_check.METHODS.items():
        chain_check.receive(code, dsp.rx_chain_pairs(
            ch_xp, sps=2, **ch_cfg["track"])[0], m)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = chain_check.receive(code, dsp.rx_chain_pairs(
                ch_xp, sps=2, **ch_cfg["track"])[0], m)
            walls.append(time.perf_counter() - t0)
        sp_ = bench_chain.spread(walls)
        log(f"[times] chain + receive {name}, composed, {CHAIN_FRAMES} frames "
            f"sent, {res.n_frames} after the lock: {sp_['median'] * 1e3:.4f} "
            f"ms host clock, median of 5 after a warm-up (min "
            f"{sp_['min'] * 1e3:.4f}, max {sp_['max'] * 1e3:.4f}), "
            f"{res.n_frames * code.K / sp_['median']:.4e} info bit/s [{card}]")
    del ch_xp, app_xp
    # the streaming blocks' loop kernels: CUDA events beside their plain
    # versions and their HBM bound, at 16,391 samples and 2^21; the serial
    # kernels' floor (phase 2's chain at the SM clock each holds back to
    # back)
    x_loop = dsp_loops_check.impaired_stream(device=dev)
    loop_times = dsp_loops_check.times(x_loop, log=log)
    agc_out = dsp.agc(x_loop, **dsp_loops_check.AGC)[0]
    dlib = load_library("dsp_loops")
    t = loop_times[cuda_dsp.SCAN]
    log(f"[times] {cuda_dsp.SCAN} {x_loop.shape[0]} samples: kernel "
        f"{t['ms']:.4f} ms (its three launches), its call {t['call_ms']:.4f}"
        f" ms (the wrapper and the flag's read-back), plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}); {t['path_samples']} samples: kernel "
        f"{t['path_ms']:.4f} ms, its call {t['path_call_ms']:.4f} ms, bound "
        f"{t['path_bound_ms']:.6f} ms, the kernel "
        f"{t['path_bound_ms'] / t['path_ms']:.3f} of the bound (CUDA events) "
        f"[{card}]")
    for name, fn in (("agc_loop", dsp_loops_check.launcher(
                         dlib, "agc_loop", x_loop, (1.0,))),
                     ("costas_loop", dsp_loops_check.launcher(
                         dlib, "costas_loop", agc_out, (0.0, 0.0)))):
        call_ms, samples = under_load(fn, 2.0)
        mhz = float(np.median([c for c, _, _ in samples])) if samples else \
            float("nan")
        t = loop_times[name]
        n = x_loop.shape[0]
        t["serial_ms"] = n * chains[name]["cycles"] / (mhz * 1e3)
        log(f"[times] {name} {n} samples: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms (CUDA events); back to back "
            f"{call_ms:.4f} ms a launch at SM clock {mhz:.0f} MHz, "
            f"{t['ms'] * mhz * 1e3 / n:.1f} cycles a sample against the "
            f"chain's {chains[name]['cycles']:g} ({chains[name]['links']:g} "
            f"dependent instructions); serial floor {t['serial_ms']:.4f} ms, "
            f"HBM bound {t['bound_ms']:.6f} ms ({t['bound_by']}); "
            f"{t['path_samples']} samples {t['path_ms']:.4f} ms, "
            f"{t['path_ms'] * mhz * 1e3 / t['path_samples']:.1f} cycles a "
            f"sample [{card}]")
    del x_loop, agc_out
    # the clock tracker's kernel: CUDA events beside its plain version and
    # its bound, at the composed shape and on one app segment; its one-SM
    # floor at the SM clock the kernel holds back to back
    track_shapes = pfb_track_check.timed_shapes(dev)
    track_times = pfb_track_check.times(dev, log=log, shapes=track_shapes)
    xp_c, tb_c, rc_c = track_shapes["composed"]
    xpp_c, banks_c, _, loop_c, st_c = pfb_track_check.setup(xp_c, tb_c, rc_c)
    call_ms, samples = under_load(
        lambda: cuda_dsp.pfb_track(xpp_c, *banks_c, st_c, loop_c), 2.0)
    mhz = float(np.median([c for c, _, _ in samples])) if samples else \
        float("nan")
    tc = track_times["composed"]
    tc["C"] = cuda_dsp.track_geometry(
        tb_c, loop_c.sps, loop_c.nfilts, loop_c.ntaps, loop_c.width, rc_c,
        loop_c.gain).C
    tc["sm_floor_ms"] = tc["fmas"] / (SM_FMA_PER_CLOCK * mhz * 1e3)
    tc["cluster_floor_ms"] = tc["sm_floor_ms"] / tc["C"]
    log(f"[times] {cuda_dsp.TRACKER} composed: back to back {call_ms:.4f} ms "
        f"a call at SM clock {mhz:.0f} MHz; {tc['fmas']:.4e} FMAs, one-SM "
        f"floor {tc['sm_floor_ms']:.4f} ms at {SM_FMA_PER_CLOCK} a clock, "
        f"{tc['C']}-SM floor {tc['cluster_floor_ms']:.4f} ms; kernel "
        f"{tc['ms']:.4f} ms = {tc['ms'] / tc['sm_floor_ms']:.3f}x the one-SM "
        f"floor, {tc['ms'] / tc['cluster_floor_ms']:.2f}x the {tc['C']}-SM "
        f"floor, plain {tc['plain_ms']:.4f} ms, bound {tc['bound_ms']:.6f} ms "
        f"({tc['bound_by']}) [{card}]")
    del track_shapes, xp_c, xpp_c, banks_c, st_c
    log(f"[times] after: {clock_line()}")

    def route_of(name):    # "bp_minsum_large" -> "_large", "bp_minsum" -> ""
        return name[name.index("_", 3):] if name.count("_") == 2 else ""

    def kernel_record(name, source, replaces, launches, method, c=code,
                      frames=N_FRAMES):
        """One kernel's entry, its bound at the shape it was timed."""
        bound, by = bound_ms(c, frames, ITERATIONS, method)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_err[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,    # no single PyTorch call decodes BP
                **({"sfu_ms": sfu_ms[name]} if name in sfu_ms else {}),
                **({"smem_ms": smem_ms[name]} if name in smem_ms else {}),
                **({"issue_ms": issue_floor[name]} if name in issue_floor
                   else {})}

    record = {"kernels": [
        kernel_record(name, SOURCES[route_of(name)], REPLACES[name],
                      path_counts[route_of(name)][name],
                      "sumproduct" if "sumproduct" in name else "minsum",
                      *((big, LARGE_FRAMES) if route_of(name) == "_large"
                        else (wide_code, STEP_FRAMES)
                        if route_of(name) == "_wide" else ()))
        for name in cuda_bp.KERNELS] + [
        kernel_record(name, STUDY_SOURCE, STUDY_REPLACES[name],
                      study_counts[name], "sumproduct")
        for name in cuda_study.INSTANCES] + [
        kernel_record(name, STUDY_MS_SOURCE, STUDY_MS_REPLACES[name],
                      ms_counts[name], "minsum")
        for name in cuda_study_ms.INSTANCES] + [
        {"name": name, "route": "cuda", "source": LOOP_SOURCE,
         "replaces": LOOP_REPLACES[name],
         # the scan and Costas on the flowgraph path; the AGC's serial
         # route on the path of the inputs that take it
         "launches": (edge_counts if name == "agc_loop" else fg_counts)[name],
         "launches_by_path": {"flowgraph": fg_counts[name],
                              "agc edge": edge_counts[name]},
         "max_abs_err": max_err[name], "ms": loop_times[name]["ms"],
         "plain_ms": loop_times[name]["plain_ms"],
         "bound_ms": loop_times[name]["bound_ms"],
         "bound_by": loop_times[name]["bound_by"],
         # no PyTorch call runs a feedback loop or a linear recurrence
         "library_ms": None,
         "call_ms": loop_times[name]["call_ms"],
         "path_samples": loop_times[name]["path_samples"],
         "path_ms": loop_times[name]["path_ms"],
         "path_call_ms": loop_times[name]["path_call_ms"],
         "path_bound_ms": loop_times[name]["path_bound_ms"],
         **({"serial_ms": loop_times[name]["serial_ms"]}
            if name in cuda_dsp.SERIAL else {})}
        for name in cuda_dsp.KERNELS] + [
        {"name": cuda_dsp.TRACKER, "route": "cuda", "source": TRACK_SOURCE,
         "replaces": TRACK_REPLACES,
         "launches": fg_counts[cuda_dsp.TRACKER] + ch_counts[cuda_dsp.TRACKER],
         "max_abs_err": max_err[cuda_dsp.TRACKER],
         "ms": track_times["composed"]["ms"],
         "plain_ms": track_times["composed"]["plain_ms"],
         "bound_ms": track_times["composed"]["bound_ms"],
         "bound_by": track_times["composed"]["bound_by"],
         "library_ms": None,   # no PyTorch call runs this feedback loop
         "sm_floor_ms": track_times["composed"]["sm_floor_ms"],
         "C": track_times["composed"]["C"],
         "cluster_floor_ms": track_times["composed"]["cluster_floor_ms"],
         "segment_ms": track_times["segment"]["ms"],
         "segment_plain_ms": track_times["segment"]["plain_ms"]}]}
    log(f"[done] every phase in {time.perf_counter() - t_start:.1f} s, the "
        f"build included")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
