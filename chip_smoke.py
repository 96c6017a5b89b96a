#!/usr/bin/env python3
"""On-card smoke test of jxl_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a), nvcc and
g++. Phases, each printing JSON lines, and any failure ends the run with
a non-zero exit:

1. build   - nvcc builds csrc/epf_gab.cu (K1), csrc/ans_lanes.cu (K2,
             K3) and csrc/lossless_lanes.cu (K4), and g++ the host decoder
             library, all in parallel, from the checkout.
2. kernels - K1 against its plain torch version on the card, at 3840x2160
             for all six stage sets (gaborish on/off x epf_iters 1-3, each
             timed beside its bound), at 1920x1080 (the upsampled VarDCT
             frame's coded size, gaborish + EPF 2 steps: timed, and equal
             to its plain version), at 272x3840 (a 4K band's slab of the
             banded phase: timed, and equal to its plain version) and at
             ragged sizes down to 1x1, 2x3
             and 3x4097, with 1/sigma that includes passthrough pixels; max
             abs difference <= 1e-5, and <= 1e-6 more than 8 px from the
             edge.
             K2 against plain ans_decode_batch, bit for bit (tokens and
             final states): streams of the VarDCT writer's rANS encoder at
             S=135, T=4096 (timed), S=4224, T=1024 (32 streams an SM,
             timed), S=37 and S=37, T=8000 (rows longer than the ring),
             rows cut short, an odd row length, rows of 1
             and 3 bytes, T=0, S=1 and T=31, and random rows with
             arbitrary int32 tables at log_bucket 0, 4, 6 (S=135, T=4096),
             8 and 12; then K2's own path, the batch decode entry point,
             once with its count reset.
             K3 against plain decode_ac_sections, bit for bit (coefficients
             and ok flags), on a 1024x1024 writer stream (16 lanes), on a
             copy with one section corrupted (that lane alone reports not
             ok; the plain version of the 1024x1024 cases on the host), on a stream of 20 KB sections (the stream ring restaged
             over real bytes; plain version on the host), on random lanes
             (tests/test_torch_vardct_streams.py::random_lanes, three
             seeds, and one of 160 clusters whose tables stay in global
             memory), on a two-pass 1024x1024 stream (two lanes a group,
             each pass's coefficients added into the same buffer), and on
             the 3840x2160 stream's 135 lanes, timed with its time per
             step of the longest lane; on the 15 lanes of its group row 1
             into a band-sized buffer, as the banded decode launches it
             (timed; plain version on the host); then on the 270 lanes of
             the same stream in two passes, timed and held against the
             writer's coefficients. Writer streams go in
             with their tables packed on the host, as the decode passes
             them; random lanes without, so the wrapper packs them.
             Kernel times ("ms") are the kernel's mean device time over
             repeated calls, from CUDA events right around its launch;
             "call_ms" is the median CUDA-event-timed wrapper call, its
             host work included.
3. decode  - jxl_tpu_torch.decode_image of a 3840x2160 XYB Modular stream
             (gaborish on, EPF 2 steps) on the card in u8 and f32, held
             against the port's own device="cpu" decode of the same bytes
             (f32 <= 1e-4, u8 <= 1 LSB); K1's count must rise.
4. vardct  - decode_image of a 3840x2160 XYB VarDCT writer stream (DCT8,
             DCT16x16 and every 1x1 transform, EPF sigma per block) on the
             card in u8 and f32, 3 reps each; K1's and K3's counts must
             rise. K3's coefficient buffer must equal the writer's and the
             native host decoder's (JXL_TPU_AC=host) bit for bit, and the
             pixels the port's CPU decode with JXL_TPU_AC=host (f32 <= 1e-4,
             u8 <= 1 LSB).
5. features - decode_image on the card of two streams with the
             single-frame feature stages, 3840x2160 out: a 1920x1080 XYB
             VarDCT frame upsampled 2x with photon noise (K3, then K1 at
             1920x1080, then the upsampling and the noise at 3840x2160) and
             a 3840x2160 XYB Modular frame with an 8-bit alpha channel (K1
             at 3840x2160), u8 and f32, 3 reps each, with the noise field's
             host seconds and its upload; K1's and K3's counts must rise,
             and each decode is held against the port's CPU decode (VarDCT
             with JXL_TPU_AC=host; f32 <= 1e-4, u8 <= 1 LSB). Then each
             step of the upsampled VarDCT render: the host's time to queue
             it, and its device time from CUDA events with the step
             queued behind a spin.
6. layouts - decode_image on the card of the two VarDCT frame layouts of
             recompressed JPEGs and lossy images with alpha, and of a
             chroma-subsampled Modular frame: (a) a 3840x2160
             YCbCr 4:2:0 frame, DCT8 only, no filters (K3, the subsampled
             render, the chroma upsampling); (b) a 1920x1080 YCbCr 4:2:0
             frame with gaborish + EPF (K3, the chroma upsampling, then
             K1); (c) a 3840x2160 XYB frame with an 8-bit alpha in each
             group's modular HF stream (the host AC decode group by group,
             then K1); (d) a 3840x2160 YCbCr 4:2:0 Modular frame with
             gaborish + EPF (the chroma upsampling, then K1); u8 and f32, 3
             reps each, with each stream's K1 and K3 launches (K3 must rise
             on (a) and (b), K1 on (b), (c) and (d), K3 not on (d)),
             K3's buffer of (a) bit for bit against the writer's and the
             host decoder's, and each decode held against the port's CPU
             decode (host AC; f32 <= 1e-4, u8 <= 1 LSB). Then (a)'s render
             taken apart as in features: the chroma upsampling's device
             time beside its bytes bound.
7. frames  - decode_image on the card of three multi-frame streams: an
             XYB VarDCT animation at 1920x1080 (8 frames, the later seven
             960x544 crops at offsets across the canvas, one with a
             negative x0, one past the right edge, blending by REPLACE,
             ADD and MUL over slots 0 and 1), an sRGB Modular animation
             with an 8-bit alpha at 1920x1080 (8 frames, cropped frames
             BLENDing with their alpha) and a 3840x2160 XYB VarDCT frame
             with 7000 16x32 ADD patches from a 1024x512 REFERENCE_ONLY
             Modular atlas saved before the colour transform; u8 and f32,
             3 reps each, with wall time, host_s and MP/s of output. K3
             and K1 must launch once a VarDCT frame and once a filtered
             frame (8 and 8 a decode of the animation, 1 and 1 of the
             patches frame, none of the Modular animation); every frame
             and duration is held against the port's CPU decode (host
             AC; f32 <= 1e-4, u8 <= 1 LSB). Then the blend, slot save and
             patch steps' card time from CUDA events, and those steps
             once more under torch.cuda.set_sync_debug_mode("error"),
             where a host sync fails the run.
8. tools   - decode_image on the card of the coding tools' streams:
             progressive_4k (a 480x270 XYB Modular LF frame, then a
             3840x2160 XYB VarDCT frame that reads its LF from it, two AC
             passes, default filters: K3 over 270 lanes, then K1),
             progressive_rgba_1080p (1920x1080 XYB VarDCT with an 8-bit
             alpha in two passes: the host AC route, then K1), icc_jpeg_4k
             (the 3840x2160 YCbCr 4:2:0 JPEG frame, no filters, with a
             BT.2100 PQ profile embedded: K3) and splines_4k (3840x2160 XYB
             VarDCT with 64 splines: K3, K1, the spline stage); u8 and f32,
             3 reps each, with each stream's K3 and K1 launches a decode
             and K3's lane count; output_icc() against the profile
             written; every decode against the port's CPU decode (host
             AC; f32 <= 1e-4, u8 <= 1 LSB). Then the spline stage's card
             time beside its bytes bound, with the segment and splatted
             pixel counts, and the LF adoption's card time.
9. streaming - the streaming decoder (api/decoder.py:JxlDecoder) and
             the CLI on the card: (a) progressive_4k fed 4 KiB at a time
             (FULL_FRAME), u8 and f32, bit for bit decode_image's, K3 and
             K1 once each for the main frame, with the wall and the
             process() calls; (b) the same stream 64 KiB at a time under
             EAGER with a flush_pixels() at every FRAME_PROGRESSION: each
             flush's wall, K3's lanes at each launch, the LF preview's
             shape, the first flush after the LF frame; every flush within
             f32 1e-4 of the port's CPU JxlDecoder's (host AC) at the same
             bytes, and the final frame bit for bit (a)'s; (c) the 8-frame
             VarDCT animation of the frames phase in three jxlp boxes: a
             frame scan, a seek to visible frame 5 (decode_image's frame
             5), then the whole file a byte at a time through its first 4
             KiB (every frame and duration decode_image's); (d) python -m
             jxl_tpu_torch.cli in a subprocess on the 4K VarDCT stream: its
             PNG equal to decode_image's u8 frame, and --speedtest's MP/s.
10. banded - the banded decode (api/banded.py): (a) decode_image of
             the 4K VarDCT stream, u8 and f32, 5 reps each: walls,
             host_s, peak card memory, K1 and K3 launches a decode (1
             and 1); (b)
             decode_banded of a 7680x4320 VarDCT stream (17 bands) into
             a pinned host array, against decode_image of the same bytes,
             with walls and peak card memory: decode_banded's peak must
             be at most a quarter of decode_image's and within 1.25x of
             its own at 7680x1088; (c) decode_banded of a 4K Modular
             frame with alpha, a 1080p VarDCT frame with noise,
             progressive_4k (LF frame whole, two passes in bands), the
             4K patches frame and a 4K frame of the DCT32 to DCT256
             transforms against decode_image. Band and frame
             agree bit for bit.
11. lossless - the lossless Modular lanes (phase_lossless): a 3840x2160
             lane stream (Gradient leaves for two channels, West for the
             third; 270 gradient and 135 West lanes) decoded with
             JXL_TPU_DEV_LOSSLESS=1 and =0, u8 and f32, 5 reps each: walls,
             host_s, peak card memory, K4 and cumsum launches, bytes up and
             back; the routes bit for bit; a 520x300 lane stream's channels
             against the writer's planes; K4 against its plain version bit
             for bit (the decode's batches, the frame's 270 lanes, a
             2048x2048 lane, the overflow gate's edge and past it, the
             edge sets of strips, widths and odd offsets), timed on the
             frame's lanes and each decode batch beside its bytes and
             chain bounds, with its wrapper call (no sync), its launch
             geometry and occupancy, the plain version and the native host
             loop on the same lanes; the auto rule the walls support.
12. sharded - the multi-process decode on torch.distributed
             (parallel/sharded_render.py, parallel/multihost.py, the lanes
             split of modular/device_lossless.py): world 1 in this process
             on NCCL, then worlds 2 and 4 as spawned processes sharing the
             one card over gloo (halos and gathers staged through
             page-locked host buffers), each running, 3 reps each:
             decode_sharded of the 4K VarDCT stream (each rank K3 over its
             own groups' lanes, its tile's render, the halo exchange, K1,
             colour; 1x1, 1x2 and 2x2 grids), of the 7680x4320 panorama
             (worlds 1 and 4), sharded_filters_and_color and
             sharded_render of seeded 3840x2160 planes (row shards), the
             split of the lossless phase's 270 gradient (K4) and 135 West
             lanes, and decode_animation_multihost of an 8-frame 1920x1080
             VarDCT animation of standalone REPLACE frames (crops at
             negative offsets among them); u8 and f32. Every rank's
             output is held bit for bit against world 1's and its
             one-process counterpart (decode_image, run_filters' K1 then
             colour, render_block, the lanes in one call), with the walls,
             the exchange's bytes and seconds, K1/K3/K4 launches and the
             peak card memory of each rank. Then two NCCL ranks on the one
             card: NCCL refuses them, and the message is recorded.
13. profile - a u8 decode of each stream (Modular, VarDCT, the upsampled
             VarDCT with noise, and the batched route on anim48_512)
             under torch.profiler: device time by operation and the
             card's idle share. It runs right after the build, and no
             other phase opens a profiler session.
14. batched_anim - the batched animation route (render/batch_anim.py,
             render/anim_fold.py) on anim48_512 (48 REPLACE frames of
             512x512, 4 groups each), anim48_256 (48 single-section
             256x256 frames, the fold's case) and crop16_512 (16 frames,
             15 of them 448x320 crops at offsets across the canvas,
             negative ones among them), each by JXL_TPU_BATCH_ANIM=off
             (the per-frame loop), 1 (the batched render, K3 once) and 0
             (the fold where it takes the stream): the routes bit for bit
             in u8 and f32; u8 walls (median of 5 after a warm-up),
             host_s, K3 (and its lanes) and K1 launches a decode, peak
             card memory; the fold's coefficients, LF and HF metadata
             against K3's batched sections on anim48_256; K3 over
             anim48_512's 192 merged lanes against its plain version (on
             the host), timed beside one frame's 4 lanes.
15. host_route - the host render route (utils/devhealth.py,
             JXL_TPU_DEVICE) against the card route on VarDCT stills of
             256x256, 512x512, 1920x1080 and 3840x2160, Modular stills of
             512x512 and 3840x2160 and the three animations of
             batched_anim: each by JXL_TPU_DEVICE=on and =off, u8 and f32
             walls and host_s (medians of 5), K1 and K3 launches (none on
             the host route) and peak card memory of a warm-up decode; the
             routes within u8 1 LSB and f32 1e-4 of each other; the card
             probe's economics (first round trip, launch latency, HtoD and
             DtoH MB/s), the cutoffs this run's walls settle beside the
             committed ones, and the route and u8 wall of auto; a
             512x384 still whose patches read a reference slot, which
             the host route reads from the card under
             JXL_TPU_DEVICE=off.
16. tables - a real encoder's VarDCT coding tables (custom dequant
             matrices of every mode, coded coefficient orders, a
             block-context map over 16 block contexts, four AC
             histogram sets over 64 clusters at log alphabet size 8,
             custom LF quantization; tests/test_torch_vardct_streams.py)
             on tables_4k (3840x2160 XYB), tables_2pass_4k (the same in
             two passes, its orders prefix-coded: the Python HfGlobal
             with the native permutation read), tables_jpeg_4k (a
             3840x2160 YCbCr 4:2:0 recompressed JPEG: RAW quant table,
             coded orders), tables_512 (a 512x512 XYB still, the host
             route under auto) and tables_anim48_512 (48 frames of two
             alternating dequant sets: the batched route, the fold
             declining): every stream once through decode_image with the
             counts zeroed just before (K1 and K3 launches, peak card
             memory), then u8 and f32 walls and host_s (medians of 5,
             beside the default-tables 4K stream), each against the
             port's CPU decode (host AC; f32 <= 1e-4, u8 <= 1 LSB); the
             4K streams' coefficients from K3 on the card and from the
             host AC decoder equal the writer's, and K3 on their first
             four lanes equals its plain version (on the host); K3 on
             tables_4k timed beside its bound with its shared-memory plan
             (tables in global memory); tables_4k by decode_banded and by
             JxlDecoder in 64 KiB pieces equal to decode_image bit for
             bit; HfGlobal's host time with the native permutation read
             against the Python loop it replaced.

Then one line with every kernel's numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Prints no
result without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# int32 on the CUDA cores runs at half the fp32 rate (64 of 128 lanes an
# SM a clock on Hopper)
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
WIDTH, HEIGHT = 3840, 2160
# rows of K1's slab for a band of one group row: 8 halo rows each side
BAND_SLAB_ROWS = 8 + 256 + 8
# integer operations a token, as the kernels' source counts them: K2's
# rANS step (table lookup, state update, renorm read); K3 adds the
# context selection, HybridUint and the coefficient store
K2_OPS_PER_TOKEN = 24
K3_OPS_PER_TOKEN = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def epf_gab_ops_per_px(gab: bool, epf_iters: int) -> int:
    """fp32 operations per pixel of gaborish + EPF as the stage math
    counts them (adds, muls, abs, max, div; selects not counted)."""
    ops = 33 if gab else 0  # per channel 6 adds + 3 muls + 2 adds
    for step, need in ((0, 3), (1, 1), (2, 2)):
        if epf_iters < need:
            continue
        nn, npat = (12, 5) if step == 0 else (4, 5 if step == 1 else 1)
        # per neighbor: 3 channels x (npat sub + npat abs + (npat-1) add
        # + 1 mul), 2 adds over channels, weight mul+add+max, 1 sum add;
        # per pixel: 1/sigma x multiplier, wsum add, per channel nn
        # mul+add and a divide
        ops += nn * (9 * npat + 6) + 2 + 3 * (2 * nn + 1)
    return ops


def epf_gab_bound_ms(h: int, w: int, gab: bool, epf_iters: int) -> tuple:
    """(bound_ms, bound_by): 28 B/px moved once (3 planes + 1/sigma in,
    3 planes out) against the operations at the fp32 peak."""
    t_bytes = 28 * h * w / HBM_BYTES_PER_S
    t_ops = epf_gab_ops_per_px(gab, epf_iters) * h * w / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event-timed calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# cycles the card spins before each timed launch: longer than the host
# takes to queue the launch, so the event before it does not wait on the host
SPIN_CYCLES = 200_000


def device_times(jobs, reps: int = 10) -> dict:
    """{key: mean device time in ms of one kernel launch} for jobs
    [(key, fn, lib, entry)]: `fn` calls a wrapper that launches its kernel
    through the C entry point `entry` of the ctypes library `lib`. For
    `reps` calls after a warm one, that entry point is wrapped so that CUDA
    events on the launch's stream, right before and after it, time the
    kernel alone, without the wrapper's host work; each launch is queued
    behind a spin on the card, so the first event does not wait for the
    host. (torch.profiler's trace has lost every launch of a kernel in a
    session on the H100, so the times do not come from it.)"""
    import torch

    out = {}
    for key, fn, lib, entry in jobs:
        fn()
        launch = getattr(lib, entry)
        pairs = []

        def timed(*args, launch=launch, pairs=pairs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            err = launch(*args)
            b.record()
            pairs.append((a, b))
            return err

        setattr(lib, entry, timed)
        try:
            for _ in range(reps):
                fn()
        finally:
            setattr(lib, entry, launch)
        torch.cuda.synchronize()
        check(len(pairs) == reps, f"{entry} ran {len(pairs)} times in {reps} calls")
        out[key] = sum(a.elapsed_time(b) for a, b in pairs) / reps
    return out


def ptxas_report(log: str) -> list:
    """[(kernel, registers, spill line)] from nvcc's -Xptxas -v output."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], ""
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "ptxas info    : Used" in ln and name:
            out.append([name, ln.split("Used")[1].strip(), spill])
            name = None
    return out


def phase_build():
    from jxl_tpu_torch import native
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.ops import lossless_lanes as LL
    from jxl_tpu_torch.ops import modular_lanes as ML
    from jxl_tpu_torch.ops import vardct_blocks as VB

    errors = []
    secs = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported below; the phase fails
            errors.append(f"{name}: {e}")
        secs[name] = time.perf_counter() - t0

    threads = [
        threading.Thread(target=run, args=("nvcc_epf_gab", K.load)),
        threading.Thread(target=run, args=("nvcc_ans_lanes", AL.load)),
        threading.Thread(target=run, args=("nvcc_lossless_lanes", LL.load)),
        threading.Thread(target=run, args=("nvcc_vardct_blocks", VB.load)),
        threading.Thread(target=run, args=("nvcc_modular_lanes", ML.load)),
        threading.Thread(target=run, args=("gxx_host_decoder", native.get_lib)),
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, "build failed: " + "; ".join(errors))
    ptxas = [r for mod in (K, AL, LL, VB, ML)
             for r in ptxas_report((mod.build_info or {}).get("log", ""))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "parts": secs,
          "ptxas": ptxas})


def _kernel_inputs(h, w, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    planes = rng.normal(0.5, 0.2, size=(3, h, w)).astype(np.float32)
    sigma = rng.uniform(-3.0, -0.5, size=(h, w)).astype(np.float32)
    sigma[rng.random((h, w)) < 0.05] = -5.0  # below MIN_SIGMA: passthrough
    return (torch.from_numpy(planes).to(device), torch.from_numpy(sigma).to(device))


RF = dict(pass0_scale=0.9, pass2_scale=6.5, border_sad_mul=2.0 / 3.0,
          channel_scale=(40.0, 5.0, 3.5))
GAB = ((0.115169525, 0.061248592),) * 3


def phase_kernels():
    """K1 against its plain version at 3840x2160 for all six stage sets
    (gaborish on/off x epf_iters 1-3), each timed beside its bound, and at
    ragged sizes down to 1x1."""
    import torch

    from jxl_tpu_torch.ops import epf_gab as K

    dev = torch.device("cuda")
    results = []
    timed = []  # (index in results, call, kernel name) of the 4K stage sets
    cases = [((HEIGHT, WIDTH), g, it) for g in (True, False) for it in (1, 2, 3)]
    # the upsampled VarDCT frame of the features phase runs K1 at its coded size
    half = (HEIGHT // 2, WIDTH // 2)
    cases.append((half, True, 2))
    # a band of the banded phase: the 8-row tail, 256 rows, the 8-row head
    slab = (BAND_SLAB_ROWS, WIDTH)
    cases.append((slab, True, 2))
    cases += [((777, 1001), True, 3), ((777, 1001), False, 2), ((33, 65), True, 3),
              ((45, 67), True, 3), ((5, 7), True, 3), ((1, 1), True, 2), ((1, 1), True, 3),
              ((2, 3), True, 2), ((2, 3), False, 3), ((3, 4097), True, 2),
              ((3, 4097), True, 3)]
    for i, ((h, w), gab, iters) in enumerate(cases):
        planes, sigma = _kernel_inputs(h, w, 10 + i, dev)
        args = (planes, sigma, GAB if gab else None, iters, RF["pass0_scale"],
                RF["pass2_scale"], RF["border_sad_mul"], RF["channel_scale"])
        before = K.epf_gab.launches
        got = K.epf_gab(*args)
        launches = K.epf_gab.launches - before
        want = K.epf_gab_reference(*args)
        torch.cuda.synchronize()
        d = (got - want).abs()
        err = float(d.max())
        inner = float(d[:, 8:-8, 8:-8].max()) if h > 16 and w > 16 else 0.0
        rec = {"name": "epf_gab", "shape": [3, h, w], "gab": gab, "epf_iters": iters,
               "launches": launches, "max_abs_diff": err, "max_abs_diff_inner": inner}
        if (h, w) in ((HEIGHT, WIDTH), half, slab):
            # every stage set at 4K, and the main one at 1920x1080 and on a
            # 4K band's slab: time it
            # beside its bound, with the geometry of its tile
            # (csrc/kernel_geometry.h; the bytes a pixel are that geometry's
            # model of the traffic, not a reading)
            plan = K.epf_gab_plan(gab, iters)
            emit({"phase": "kernels", "name": "epf_gab", "gab": gab, "epf_iters": iters,
                  "geometry": {k: plan[k] for k in ("halo", "halo_x", "smem_bytes",
                                                    "input_bytes_per_px")}})
            rec["call_ms"] = time_ms(lambda: K.epf_gab(*args))
            timed.append((len(results), lambda args=args: K.epf_gab(*args), K.load(),
                          "epf_gab_launch"))
            rec["plain_ms"] = time_ms(lambda: K.epf_gab_reference(*args), reps=3, warmup=1)
            rec["bound_ms"], rec["bound_by"] = epf_gab_bound_ms(h, w, gab, iters)
            rec["library_ms"] = None  # no single torch call computes gaborish+EPF
        emit({"phase": "kernels", **rec})
        check(launches == 1 and err <= 1e-5 and inner <= 1e-6,
              f"epf_gab disagrees with its plain version at {h}x{w} gab={gab} "
              f"iters={iters}: {err} (inner {inner})")
        check((h, w) not in (half, slab) or err == 0.0,
              f"epf_gab at {h}x{w} is {err} from its plain version")
        results.append(rec)
    for i, ms in device_times(timed).items():
        r = results[i]
        r["kernel_ms"] = ms
        r["share_of_bound"] = r["bound_ms"] / ms
        emit({"phase": "kernels", "name": "epf_gab", "shape": r["shape"], "gab": r["gab"],
              "epf_iters": r["epf_iters"], "kernel_ms": ms, "bound_ms": r["bound_ms"],
              "share_of_bound": r["share_of_bound"]})
    # the main path's configuration: gaborish + EPF 2 steps
    four_k = [r for r in results if "kernel_ms" in r and r["shape"][1:] == [HEIGHT, WIDTH]]
    main_rec = next(r for r in four_k if r["gab"] and r["epf_iters"] == 2)
    main_rec["stage_sets"] = [
        {"stages": ("gaborish+" if r["gab"] else "") + f"epf_iters={r['epf_iters']}",
         **{k: r[k] for k in ("kernel_ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}}
        for r in four_k]
    half_rec = next(r for r in results if "kernel_ms" in r and r["shape"][1:] == list(half))
    slab_rec = next(r for r in results if "kernel_ms" in r and r["shape"][1:] == list(slab))
    return main_rec, half_rec, slab_rec, max(r["max_abs_diff"] for r in results)


def phase_decode(data):
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import epf_gab as K

    mp = WIDTH * HEIGHT / 1e6
    runs = []
    K.epf_gab.launches = 0
    for fmt in ("u8", "f32"):
        for rep in range(2):
            t0 = time.perf_counter()
            img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            out = img.frames[0]
            host = img.timings["host_s"]
            runs.append((fmt, out))
            emit({"phase": "decode", "format": fmt, "rep": rep, "megapixels": mp,
                  "seconds": total, "mp_per_s": mp / total,
                  "host_parse_entropy_s": host, "device_render_s": total - host})
    launches = K.epf_gab.launches
    check(launches > 0, "decode_image did not launch the epf_gab kernel")

    for fmt in ("u8", "f32"):
        got = next(o for f, o in runs if f == fmt)
        check(got.device.type == "cuda", "frames must stay on the card")
        check(tuple(got.shape) == (HEIGHT, WIDTH, 3), f"bad shape {tuple(got.shape)}")
        t0 = time.perf_counter()
        ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
        cpu_s = time.perf_counter() - t0
        a = got.cpu().numpy().astype(np.float64)
        b = ref.numpy().astype(np.float64)
        check(np.isfinite(a).all(), "non-finite output")
        diff = float(np.abs(a - b).max())
        limit = 1.0 if fmt == "u8" else 1e-4
        emit({"phase": "decode", "format": fmt, "vs_cpu_max_abs_diff": diff,
              "limit": limit, "cpu_decode_s": cpu_s, "min": float(a.min()),
              "max": float(a.max())})
        check(diff <= limit, f"{fmt} decode on the card differs from the CPU decode: {diff}")
    return launches


def _k2_streams(S, T, seed):
    """S rANS streams of T tokens each from the VarDCT writer's encoder
    (a flat 40-symbol distribution: a non-trivial alias table), ending in
    the final state 0x130000. Returns (streams (S, L) uint8, table (5, 64)
    int32, tokens (S, T), bytes each stream needs)."""
    import numpy as np

    from jxl_tpu_torch.ops.device_ans import pack_table
    from test_torch_vardct_streams import flat_histogram, inverse_tables, rans_encode_lanes

    h = flat_histogram(40)
    freq, inv = inverse_tables([h])
    tok = np.random.default_rng(seed).integers(0, 40, (S, T))
    state, words, has = rans_encode_lanes(tok, np.zeros((S, T), np.int64), np.full(S, T),
                                          freq, inv)
    datas = [state[s].astype("<u4").tobytes() + words[s][has[s]].astype("<u2").tobytes()
             for s in range(S)]
    streams = np.zeros((S, max(map(len, datas)) + 8), np.uint8)
    for s, d in enumerate(datas):
        streams[s, : len(d)] = np.frombuffer(d, np.uint8)
    return streams, pack_table(h), tok, sum(map(len, datas))


def _k2_cases():
    """(name, streams, table, log_bucket, T, the writer's tokens or None,
    bytes the tokens need, timed) of K2's cases: writer streams (S=135 and
    T=4096, the main case; 32 streams an SM at S=4224; S=37), rows cut
    short so that cursors run past their ends, rows longer than a ring
    (S=37, T=8000), an odd row length, rows
    shorter than the state, T = 0, S = 1, T below a chunk, and random
    rows with arbitrary int32 tables at log_bucket 0, 4, 6, 8 and 12 (the
    writer's tables have 64 buckets: log_bucket 6)."""
    import numpy as np

    from test_torch_vardct_streams import random_int32_table

    def writer(S, T, seed, name=None, timed=False):
        streams, table, tok, nbytes = _k2_streams(S, T, seed)
        return (name or f"writer_S{S}_T{T}", streams, table, 6, T, tok, nbytes, timed)

    yield writer(135, 4096, 1, timed=True)
    yield writer(4224, 1024, 3, timed=True)
    base = writer(37, 1000, 2)
    yield base
    _, streams, table, _, _, tok, nbytes, _ = base
    L = streams.shape[1]
    cut = np.ascontiguousarray(streams[:, : L * 3 // 5])
    yield ("truncated", cut, table, 6, 1200, None, cut.nbytes, False)
    odd = np.zeros((37, L + 1 + L % 2), np.uint8)
    odd[:, :L] = streams
    yield ("odd_L", odd, table, 6, 1000, tok, nbytes, False)
    for n in (1, 3):
        yield (f"L{n}", np.ascontiguousarray(streams[:, :n]), table, 6, 40, None, 37 * n, False)
    yield ("T0", streams, table, 6, 0, None, 0, False)
    # rows past the largest ring (4 KB): restaged over real bytes
    yield writer(37, 8000, 7, name="restaged_S37_T8000")
    yield writer(1, 1000, 4, name="S1")
    yield writer(37, 31, 5, name="T31")
    rng = np.random.default_rng(6)
    for lb in (0, 4, 6, 8, 12):
        S, T = (135, 4096) if lb == 6 else (37, 500)
        rows = rng.integers(0, 256, (S, 4 + 2 * T), dtype=np.uint8)
        yield (f"random_int32_lb{lb}_S{S}_T{T}", rows, random_int32_table(rng, lb), lb, T,
               None, rows.nbytes, False)


def phase_k2():
    """K2 against its plain version, bit for bit, on every case of
    _k2_cases; the S=135 and S=4224 writer cases timed. Then K2's own
    path: the batch decode entry point (no decode path calls K2)."""
    import numpy as np
    import torch

    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ans

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed_cases = {}  # S -> (record, streams, table, T)
    worst = 0
    for name, streams, table, lb, T, tok, nbytes, timed in _k2_cases():
        S = streams.shape[0]
        st, tb = torch.from_numpy(streams).to(dev), torch.from_numpy(table).to(dev)
        got_t, got_f = AL.ans_decode_batch(st, tb, lb, T)
        t0 = time.perf_counter()
        want_t, want_f = device_ans.ans_decode_batch(st, tb, lb, T)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = int((got_t.long() - want_t.long()).abs().max()) if got_t.numel() else 0
        same = torch.equal(got_t, want_t) and torch.equal(got_f, want_f)
        rec = {"phase": "kernels", "name": "ans_decode_batch", "case": name, "S": S, "T": T,
               "L": int(streams.shape[1]), "log_bucket": lb, "bit_exact": same,
               "max_abs_diff": err, "plain_s": plain_s,
               "plan": dict(AL.k2_plan(S, T, int(streams.shape[1]), sms))}
        if name.startswith("restaged"):
            check(rec["plan"]["ring_bytes"] < streams.shape[1], f"{name} fits its ring")
        if tok is not None:
            rec["writer_tokens_and_final_states"] = (
                np.array_equal(got_t.cpu().numpy(), tok) and bool((got_f == 0x130000).all()))
            check(rec["writer_tokens_and_final_states"], f"K2 lost the writer's tokens on {name}")
        check(same, f"ans_decode_batch disagrees with its plain version on {name}")
        worst = max(worst, err)
        if timed:
            rec["kernel_ms"] = device_times(
                [(0, lambda: AL.ans_decode_batch(st, tb, lb, T), AL.load(),
                  "ans_decode_lanes_launch")])[0]
            rec["call_ms"] = time_ms(lambda: AL.ans_decode_batch(st, tb, lb, T), reps=10)
            rec["plain_ms"] = plain_s * 1e3  # one call; the plain version is no yardstick
            # bytes: the stream bytes the tokens need, the table, tokens and
            # final states out; operations: K2_OPS_PER_TOKEN a token
            t_bytes = (nbytes + table.nbytes + S * T * 4 + S * 4) / HBM_BYTES_PER_S
            t_ops = S * T * K2_OPS_PER_TOKEN / INT32_OPS_PER_S
            rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
            rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            rec["ns_per_step"] = rec["kernel_ms"] * 1e6 / T
            # the same launch with T = 0 (the prologue and the launch): what
            # is left is the token loop's
            rec["kernel_ms_T0"] = device_times(
                [(0, lambda: AL.ans_decode_batch(st, tb, lb, 0), AL.load(),
                  "ans_decode_lanes_launch")])[0]
            rec["loop_ns_per_step"] = (rec["kernel_ms"] - rec["kernel_ms_T0"]) * 1e6 / T
            rec["serial_chain_note"] = ("the real limit is each stream's serial chain of T "
                                        "dependent table lookups, not bytes or operations")
            timed_cases[S] = (rec, st, tb, T)
        emit(rec)
    rec, st, tb, T = timed_cases[135]
    wide = timed_cases[4224][0]
    rec["S4224_T1024"] = {k: wide[k] for k in ("kernel_ms", "call_ms", "ns_per_step",
                                              "kernel_ms_T0", "bound_ms", "bound_by")}
    AL.ans_decode_batch.launches = 0
    AL.ans_decode_batch(st, tb, 6, T)  # the path: one batch decode
    torch.cuda.synchronize()
    rec["launches"] = AL.ans_decode_batch.launches
    emit({"phase": "k2_path", "entry": "jxl_tpu_torch.ops.ans_lanes.ans_decode_batch",
          "streams": int(st.shape[0]), "tokens": T, "launches": rec["launches"]})
    check(rec["launches"] == 1, "the batch decode path did not launch K2")
    rec["max_abs_err"] = worst
    return rec


def _vardct_frame(data, device, host_ac: bool = False):
    """The port's parse + AC decode of a VarDCT stream (the path of
    decode_image up to the render)."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    old = os.environ.pop("JXL_TPU_AC", None)
    if host_ac:
        os.environ["JXL_TPU_AC"] = "host"
    try:
        br = BitReader(data)
        fh = FileHeader.read(br)
        br.jump_to_byte_boundary()
        frame = parse_frame(br, fh)
        frame.decode_all_sections(br, device)
    finally:
        os.environ.pop("JXL_TPU_AC", None)
        if old is not None:
            os.environ["JXL_TPU_AC"] = old
    return frame


def _lane_inputs(data, band_row=None):
    """K3's inputs for every (group, pass) section of a VarDCT stream, or,
    with band_row, for those of one group row into a band-sized buffer, as
    the banded decode launches it."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.vardct import device_group

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    frame.decode_hf_global(sections[frame.section_index("hf_global")])
    if band_row is None:
        groups, band = range(frame.header.num_groups), None
    else:
        from jxl_tpu_torch.vardct.device_band import band_groups

        groups = band = band_groups(frame, band_row)
    readers = {(g, p): sections[frame.section_index("hf", group=g, pass_idx=p)]
               for g in groups for p in range(frame.header.passes.num_passes)}
    return device_group.lane_inputs(frame, readers, band=band)


def ac_tokens_per_lane(inputs, coeffs):
    """Tokens each lane decodes (one nonzeros token an item, then one a
    coefficient position up to the item's last nonzero), from the lane
    inputs and the decoded coefficients: what this run's data needs."""
    import numpy as np

    out = []
    for lane in range(inputs["streams"].shape[0]):
        g = inputs["lane_group"][lane]
        items = inputs["items"][g, : inputs["lane_n_items"][lane]].astype(np.int64)
        n = len(items)
        extra = np.zeros(n, np.int64)
        for nc in np.unique(items[:, 4]).tolist():
            m = items[:, 4] == nc
            it = items[m]
            k = np.arange(nc)[None, :]
            oidx = inputs["lane_order_base"][lane] + it[:, 6:7] + k
            idx = (inputs["lane_coeff_base"][lane] + it[:, 7:8]
                   + inputs["orders"][np.minimum(oidx, len(inputs["orders"]) - 1)])
            nz = (coeffs[idx] != 0) & (k >= it[:, 3:4])
            last = np.where(nz.any(1), nc - 1 - np.argmax(nz[:, ::-1], axis=1), -1)
            extra[m] = np.where(last >= 0, last - it[:, 3] + 1, 0)
        out.append(n + int(extra.sum()))
    return out


def two_pass_tokens_per_lane(inp, arrays, kw, packs):
    """Tokens each lane of a two-pass lane set decodes: K3 run on each
    pass's lanes alone (lane g * 2 + p is group g's pass p) gives that
    pass's coefficients, from which ac_tokens_per_lane counts its lanes'
    tokens; the summed buffer would count the other pass's positions."""
    from jxl_tpu_torch.ops import device_ac

    S = inp["streams"].shape[0]
    per_lane = [0] * S
    lane_keys = [k for k in inp if k in ("streams", "start_bits") or k.startswith("lane_")]
    for p in range(2):
        sub = dict(inp, **{k: inp[k][p::2] for k in lane_keys})
        sub_arrays = dict(arrays, **{k: arrays[k][p::2].contiguous() for k in lane_keys})
        coeffs, _ = device_ac.decode_ac_sections(**sub_arrays, **kw, **packs)
        for i, t in enumerate(ac_tokens_per_lane(sub, coeffs.cpu().numpy())):
            per_lane[2 * i + p] = t
    return per_lane


def phase_k3(data4k):
    """K3 against its plain version on a 1024x1024 stream, a corrupted
    copy, a stream of long sections, random lanes (one set with its tables
    in global memory), a two-pass 1024x1024 stream (two lanes a group,
    summed by atomic add) and the 4K stream's lanes; times at the 4K
    shapes, and on the 270 lanes of the 4K stream in two passes, held
    against the writer's coefficients (its plain version would take
    minutes)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS
    from test_torch_vardct_streams import encode_xyb_vardct, long_section_stream, random_lanes

    dev = torch.device("cuda")
    # the plain version of the 1024x1024 and long-section cases runs on the
    # host, where its lockstep steps (a few small ops each) take a third of
    # the card's time, in worker processes beside the card's cases; the 4K
    # case's plain version runs on the card (plain_ms)
    host = torch.device("cpu")
    small, small_coeffs = encode_xyb_vardct(1024, 1024, seed=8, density=0.2)
    # (name, lane inputs, the writer's coefficients, expected ok flags,
    # tables packed on the host, the plain version's device)
    inputs = _lane_inputs(small)
    cases = [("1024x1024", inputs, small_coeffs, "all", True, host)]
    # corrupt lane 5's section in place of the bytes after its header
    end = inputs["lane_end_bits"][5] // 8
    start = inputs["start_bits"][5] // 8 + 40
    corrupt = dict(inputs, streams=inputs["streams"].copy())
    corrupt["streams"][5, start : min(end, start + 12)] ^= 0x5A
    cases.append(("1024x1024_corrupt_lane5", corrupt, None, "lane5", True, host))
    # 20 KB sections: the kernel restages its 8 KB stream ring over real
    # bytes; the plain version's ~30k lockstep steps run faster on the host
    long_data, long_coeffs = long_section_stream()
    long_inp = _lane_inputs(long_data)
    ring_bytes = device_ac.ac_smem_plan(
        C=long_inp["tables"].shape[0], NB=long_inp["n_buckets"], num_bctx=long_inp["num_bctx"],
        NC=len(long_inp["context_map"]))["regions"]["stream"]
    sections = (long_inp["lane_end_bits"] - long_inp["start_bits"]) // 8
    check(sections.min() > 2 * ring_bytes, f"long sections of {sections.tolist()} bytes")
    cases.append(("512x256_long_sections", long_inp, long_coeffs, "all", True, host))
    for seed in (31, 32, 33):
        cases.append((f"random_lanes_seed{seed}", random_lanes(seed), None, None, False, dev))
    many = random_lanes(34, log_alpha=6, clusters=160)
    check(not device_ac.ac_smem_plan(C=160, NB=many["n_buckets"], num_bctx=many["num_bctx"],
                                     NC=len(many["context_map"]))["tab_shared"],
          "the 160-cluster lanes must plan their tables in global memory")
    cases.append(("random_lanes_160_clusters_global_tables", many, None, None, False, dev))
    two, two_coeffs = encode_xyb_vardct(1024, 1024, seed=8, density=0.2, passes=2)
    cases.append(("1024x1024_two_pass", _lane_inputs(two), two_coeffs, "all", True, host))
    cases.append(("3840x2160", _lane_inputs(data4k), None, "all", True, dev))
    # one group row's lanes into a band-sized buffer, as the banded decode
    # launches K3
    cases.append(("3840x2160_band_row1", _lane_inputs(data4k, band_row=1), None, "all", True,
                  host))
    four, four_coeffs = encode_xyb_vardct(WIDTH, HEIGHT, seed=7, passes=2)
    cases.append(("3840x2160_two_pass", _lane_inputs(four), four_coeffs, "all", True, None))
    pool = ProcessPoolExecutor(max_workers=5, mp_context=multiprocessing.get_context("spawn"))
    try:
        host_plain = {
            name: pool.submit(_plain_ac_sections,
                              [np.ascontiguousarray(v) for k, v in inp.items()
                               if k not in LANE_KEYWORDS],
                              {k: inp[k] for k in LANE_KEYWORDS})
            for name, inp, *_, plain_dev in cases if plain_dev == host}
        return _k3_cases(cases, host_plain, host, dev)
    finally:
        pool.shutdown(cancel_futures=True)


def _plain_ac_sections(arrays, kw):
    """decode_ac_sections' plain version on the host, in a worker process:
    (coefficients, ok flags, seconds). arrays: its positional numpy inputs;
    kw: its keywords."""
    import torch

    from jxl_tpu_torch.ops import device_ac

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    coeffs, ok = device_ac.decode_ac_sections_reference(*map(torch.from_numpy, arrays), **kw)
    return coeffs.numpy(), ok.numpy(), time.perf_counter() - t0


def _k3_bound(inp, tokens, lanes) -> tuple:
    """(bound_ms, bound_by) of K3 on lane inputs `inp`: the bytes of each
    section, the items walked, orders, tables, context map and lane arrays
    in, the dense buffer and flags out, against its integer operations a
    token of this run's data."""
    nbytes = (int(inp["lane_end_bits"].sum()) // 8
              + int(inp["lane_n_items"].sum()) * 40 + inp["orders"].nbytes
              + inp["tables"].nbytes + inp["uint_cfgs"].nbytes
              + inp["context_map"].nbytes + 8 * 4 * lanes + inp["total"] * 4 + lanes)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(tokens) * K3_OPS_PER_TOKEN / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _k3_cases(cases, host_plain, host, dev) -> dict:
    """phase_k3's cases, each against its plain version (host_plain:
    {case: future of _plain_ac_sections} for those on the host)."""
    import numpy as np
    import torch

    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS

    worst = 0
    main = two_pass = band = None
    # the card's cases first, while the workers run the host's plain versions
    for name, inp, coeffs, expect, packed, plain_dev in sorted(cases,
                                                               key=lambda c: c[5] == host):
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in inp.items() if k not in LANE_KEYWORDS}
        kw = {k: inp[k] for k in LANE_KEYWORDS}
        packs = {}
        if packed:  # as vardct/device_group.py:run_lanes passes them
            b, c = device_ac.pack_tables(inp["tables"], inp["uint_cfgs"], inp["context_map"])
            packs = dict(packed_buckets=torch.from_numpy(b).to(dev),
                         packed_cfgs=torch.from_numpy(c).to(dev))
        got_c, got_ok = device_ac.decode_ac_sections(**arrays, **kw, **packs)
        ok = got_ok.cpu().numpy()
        rec = {"phase": "kernels", "name": "decode_ac_sections", "case": name,
               "lanes": len(ok), "lanes_not_ok": np.nonzero(~ok)[0].tolist(),
               "nonzero_coefficients": int(torch.count_nonzero(got_c)),
               "tables_packed_on_host": packed}
        if plain_dev == host:
            want_c, want_ok, plain_s = (torch.from_numpy(x) if i < 2 else x
                                        for i, x in enumerate(host_plain[name].result()))
            want_c, want_ok = want_c.to(dev), want_ok.to(dev)
        elif plain_dev is not None:
            t0 = time.perf_counter()
            want_c, want_ok = device_ac.decode_ac_sections_reference(
                *(x.to(plain_dev) for x in arrays.values()), **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            want_c, want_ok = want_c.to(dev), want_ok.to(dev)
        if plain_dev is not None:
            err = int((got_c.long() - want_c.long()).abs().max())
            same = torch.equal(got_c, want_c) and torch.equal(got_ok, want_ok)
            rec.update(bit_exact=same, max_abs_diff=err, plain_device=plain_dev.type,
                       plain_s=plain_s)
            check(same, f"decode_ac_sections disagrees with its plain version on {name}")
            worst = max(worst, err)
        if expect == "lane5":
            check(ok.tolist() == [i != 5 for i in range(len(ok))],
                  f"the corrupted copy must flag lane 5 alone, got {rec['lanes_not_ok']}")
        elif expect == "all":
            check(ok.all(), f"{name}: lanes not ok")
        if coeffs is not None:
            same_writer = np.array_equal(got_c.cpu().numpy(), coeffs)
            rec["equals_writer"] = same_writer
            check(same_writer, f"{name}: not the writer's")
        if name == "3840x2160_two_pass":
            tokens = two_pass_tokens_per_lane(inp, arrays, kw, packs)
            rec["kernel_ms"] = device_times(
                [(0, lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                  AL.load(), "ac_sections_launch")], reps=5)[0]
            rec["call_ms"] = time_ms(lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                                     reps=10, warmup=2)
            rec["bound_ms"], rec["bound_by"] = _k3_bound(inp, tokens, len(ok))
            rec["tokens"] = sum(tokens)
            rec["longest_lane_tokens"] = max(tokens)
            rec["ns_per_step"] = rec["kernel_ms"] * 1e6 / max(tokens)
            two_pass = {k: rec[k] for k in ("lanes", "kernel_ms", "call_ms", "bound_ms",
                                            "bound_by", "tokens", "longest_lane_tokens",
                                            "ns_per_step")}
        if name == "3840x2160":
            plan = device_ac.ac_smem_plan(C=inp["tables"].shape[0], NB=inp["n_buckets"],
                                          num_bctx=inp["num_bctx"], NC=len(inp["context_map"]))
            rec["smem_plan"] = plan
            rec["kernel_ms"] = device_times(
                [(0, lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                  AL.load(), "ac_sections_launch")], reps=5)[0]
            rec["call_ms"] = time_ms(lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                                     reps=10, warmup=2)
            rec["plain_ms"] = plain_s * 1e3  # one call; the plain version is no yardstick
            tokens = ac_tokens_per_lane(inp, got_c.cpu().numpy())
            rec["bound_ms"], rec["bound_by"] = _k3_bound(inp, tokens, len(ok))
            rec["tokens"] = sum(tokens)
            rec["longest_lane_tokens"] = max(tokens)
            rec["ns_per_step"] = rec["kernel_ms"] * 1e6 / max(tokens)
            rec["serial_chain_note"] = ("the real limit is the longest lane's serial chain "
                                        "of dependent token steps, not bytes or operations")
            main = rec
        if name == "3840x2160_band_row1":
            tokens = ac_tokens_per_lane(inp, got_c.cpu().numpy())
            rec["kernel_ms"] = device_times(
                [(0, lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                  AL.load(), "ac_sections_launch")], reps=5)[0]
            rec["call_ms"] = time_ms(lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                                     reps=10, warmup=2)
            rec["bound_ms"], rec["bound_by"] = _k3_bound(inp, tokens, len(ok))
            rec["tokens"] = sum(tokens)
            rec["longest_lane_tokens"] = max(tokens)
            band = {k: rec[k] for k in ("lanes", "kernel_ms", "call_ms", "bound_ms", "bound_by",
                                        "max_abs_diff", "plain_device", "plain_s", "tokens",
                                        "longest_lane_tokens")}
            band["buffer_coefficients"] = inp["total"]
        emit(rec)
    main["max_abs_err"] = worst
    main["two_pass_3840x2160"] = two_pass
    main["band_row1_3840x2160"] = band
    return main


def phase_vardct(data, coeffs):
    """decode_image of the 4K VarDCT stream on the card, checked against
    the writer's coefficients and the port's CPU decode (host AC)."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.ops import vardct_blocks as VB

    mp = WIDTH * HEIGHT / 1e6
    runs = []
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    VB.vardct_blocks.launches = 0
    for fmt in ("u8", "f32"):
        for rep in range(3):
            t0 = time.perf_counter()
            img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            host = img.timings["host_s"]
            runs.append((fmt, img.frames[0]))
            emit({"phase": "vardct", "format": fmt, "rep": rep, "megapixels": mp,
                  "seconds": total, "mp_per_s": mp / total,
                  "host_parse_entropy_s": host, "device_s": total - host})
    launches = {"epf_gab": K.epf_gab.launches,
                "decode_ac_sections": device_ac.decode_ac_sections.launches,
                "ans_decode_batch": AL.ans_decode_batch.launches,
                "vardct_blocks": VB.vardct_blocks.launches,
                "vardct_blocks_per_decode": VB.vardct_blocks.launches / len(runs)}
    emit({"phase": "vardct", "launches": launches})
    check(launches["epf_gab"] > 0, "the VarDCT decode did not launch epf_gab")
    check(launches["decode_ac_sections"] > 0, "the VarDCT decode did not launch K3")
    check(launches["vardct_blocks"] > 0, "the VarDCT decode did not launch K5")

    lanes = _vardct_frame(data, "cuda")
    torch.cuda.synchronize()
    k3 = lanes.device_ac_flat.cpu().numpy()
    host = _vardct_frame(data, "cpu", host_ac=True).host_ac_flat
    same_writer = np.array_equal(k3, coeffs)
    same_host = np.array_equal(k3, host)
    emit({"phase": "vardct", "k3_equals_writer": same_writer, "k3_equals_host_decoder": same_host,
          "nonzero_coefficients": int(np.count_nonzero(coeffs))})
    check(same_writer and same_host, "K3's coefficients differ from the writer's or the host's")

    os.environ["JXL_TPU_AC"] = "host"
    try:
        for fmt in ("u8", "f32"):
            got = next(o for f, o in runs if f == fmt)
            check(got.device.type == "cuda", "frames must stay on the card")
            check(tuple(got.shape) == (HEIGHT, WIDTH, 3), f"bad shape {tuple(got.shape)}")
            t0 = time.perf_counter()
            ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
            cpu_s = time.perf_counter() - t0
            a = got.cpu().numpy().astype(np.float64)
            b = ref.numpy().astype(np.float64)
            check(np.isfinite(a).all(), "non-finite output")
            diff = float(np.abs(a - b).max())
            limit = 1.0 if fmt == "u8" else 1e-4
            emit({"phase": "vardct", "format": fmt, "vs_cpu_host_ac_max_abs_diff": diff,
                  "limit": limit, "cpu_decode_s": cpu_s, "min": float(a.min()),
                  "max": float(a.max())})
            check(diff <= limit, f"{fmt} VarDCT decode on the card differs from the CPU: {diff}")
    finally:
        os.environ.pop("JXL_TPU_AC", None)
    return launches


def phase_k5(data) -> dict:
    """K5 (ops/vardct_blocks.py) over the whole 4K VarDCT frame of `data`:
    the device time of the render's launches (one a transform type), each
    timed with CUDA events right around its ctypes entry point behind a
    spin on the card and summed a frame (`ms`); the event-timed render call
    (`call_ms`, its host tables included); the plain version's render on
    the card (`plain_ms`) and the largest difference from it; the launch
    count; the bound by bytes: each block's 3 x nc int32 coefficients read
    and 3 x nc float32 pixels written once."""
    import torch

    from jxl_tpu_torch.ops import vardct_blocks as VB
    from jxl_tpu_torch.vardct import device_frame as DF

    frame = _vardct_frame(data, "cuda")
    flat = frame.device_ac_flat

    def render():
        return DF.render_vardct_frame_device(frame, flat)

    got = render()
    lib = VB.load()
    launch = lib.vardct_blocks_launch
    pairs = []
    reps = 10

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        err = launch(*args)
        b.record()
        pairs.append((a, b))
        return err

    lib.vardct_blocks_launch = timed
    try:
        for _ in range(reps):
            render()
    finally:
        lib.vardct_blocks_launch = launch
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs) / reps
    call_ms = time_ms(render)
    DF.vardct_blocks = VB.vardct_blocks_reference
    try:
        want = render()
        plain_ms = time_ms(render, reps=5, warmup=1)
    finally:
        DF.vardct_blocks = VB.vardct_blocks
    pixels = got[0].numel()
    moved = 3 * pixels * (4 + 4)
    rec = {"phase": "k5", "launches_per_frame": len(pairs) // reps, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms,
           "max_abs_diff": float((got - want).abs().max()), "bytes": moved,
           "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(rec)
    check(rec["max_abs_diff"] <= 1e-5, f"K5 differs from its plain version: {rec}")
    return rec


def modular_d0_stream(seed: int = 3_125_000_101) -> bytes:
    """A 3840x2160 lossless master of the modular_d0 configuration, from
    the benchmark's frozen writer (portbench/writers/rgb_lossless.py)."""
    from portbench.writers.rgb_lossless import encode_rgb_lossless

    return encode_rgb_lossless(WIDTH, HEIGHT, seed)[0]


def k6_tree_streams(width: int = WIDTH, height: int = HEIGHT) -> list:
    """[(name, codestream)] of 3840x2160 frames whose trees K6 walks past
    its unrolled levels, from tests/test_torch_modular_lanes.py's encoder:
    "deep_tree" (a chain of 15 splits a channel over properties 1-15, all
    14 predictors, WP with its own header) and "wide_tree" (a full tree of
    2047 nodes a channel, from device memory; RCT permutation 13)."""
    from test_torch_modular_lanes import encode_lane_stream

    return [("deep_tree", encode_lane_stream(width, height, 23)),
            ("wide_tree", encode_lane_stream(width, height, 29, tree="wide", rct=13, wp=None))]


def phase_k6(data) -> dict:
    """K6 (ops/modular_lanes.py) over the group streams of the 4K
    modular_d0 frame `data`: the launch's device time, CUDA events right
    around its ctypes entry point behind a spin (`ms`); the event-timed
    wrapper call (`call_ms`: the uploads, the launch and the status read);
    the host's lane plan (`plan_ms`); the plain version on the host
    (`plain_ms`: the native loop lane by lane on one thread) and K6 held to
    it bit for bit; ns a step of the longest lane (`ms` over its samples,
    beside K3's 222 ns a token). Then decode_image on the card against the
    CPU decode, its wall (median of 5), and one traced decode's launches,
    counters (modular_card_streams, modular_tree_samples) and spans
    (frame.modular_groups, render.modular_planes). `k6_trees`: the same
    device time, ns a step and bit-for-bit check on k6_tree_streams()'s
    deeper trees, which walk past K6's unrolled levels."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.modular import group_lanes
    from jxl_tpu_torch.ops import modular_lanes as ML
    from jxl_tpu_torch.utils import trace
    from test_torch_modular_lanes import decode_table, frame_and_sections

    lib = ML.load()
    launch = lib.modular_lanes_launch

    def device_ms(table, shapes, reps=5) -> float:
        pairs = []

        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            err = launch(*args)
            b.record()
            pairs.append((a, b))
            return err

        lib.modular_lanes_launch = timed
        try:
            for _ in range(reps):
                decode_table(table, shapes, "cuda")
        finally:
            lib.modular_lanes_launch = launch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def longest_lane(table) -> int:
        samples = table.chans[:, 3] * table.chans[:, 4]
        return int(np.add.reduceat(samples, table.lanes[:, 5]).max())

    frame, sections = frame_and_sections(data)
    t0 = time.perf_counter()
    for _ in range(5):
        table, shapes = group_lanes.plan(frame, sections)
    plan_ms = (time.perf_counter() - t0) / 5 * 1e3
    got = decode_table(table, shapes, "cuda")
    ms = device_ms(table, shapes)
    call_ms = time_ms(lambda: decode_table(table, shapes, "cuda"), reps=5, warmup=1)
    t0 = time.perf_counter()
    want = decode_table(table, shapes, "cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    samples = table.chans[:, 3] * table.chans[:, 4]
    longest = longest_lane(table)

    trees = {}
    for name, tdata in k6_tree_streams():
        tt, ts = group_lanes.plan(*frame_and_sections(tdata))
        tgot = decode_table(tt, ts, "cuda")
        tms = device_ms(tt, ts, reps=3)
        steps = longest_lane(tt)
        depth = int(tt.chans[:, 9].max())
        trees[name] = {"ms": tms, "ns_per_step": tms * 1e6 / steps, "longest_lane_samples": steps,
                       "subtree_depth": depth, "subtree_nodes": int(tt.chans[:, 7].max()),
                       "bit_for_bit": all(torch.equal(a.cpu(), b) for a, b in
                                          zip(tgot, decode_table(tt, ts, "cpu")))}

    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        out = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cuda").frames[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ref = jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cpu").frames[0]
    decode_same = torch.equal(out.cpu(), ref)
    was = trace.enabled()
    trace.enable()
    trace.reset()
    try:
        before = ML.decode_lanes.launches
        jxl_tpu_torch.decode_image(data, pixel_format="u8", device="cuda")
        torch.cuda.synchronize()
        launches = ML.decode_lanes.launches - before
        counts = dict(trace.metrics.counters)
        spans = {k: v * 1e3 for k, v in trace.host_seconds().items()
                 if k in ("frame.modular_groups", "render.modular_planes", "frame.lf_global",
                          "decode_image")}
    finally:
        trace.enable(was)
        trace.reset()
    rec = {"phase": "k6", "lanes": len(table.lanes), "samples": int(samples.sum()),
           "longest_lane_samples": longest, "ms": ms, "call_ms": call_ms, "plan_ms": plan_ms,
           "plain_ms": plain_ms, "plain_on": "host, one thread", "bit_for_bit": same,
           "ns_per_step": ms * 1e6 / longest,
           "decode_ms": sorted(walls)[len(walls) // 2], "decode_walls_ms": walls,
           "decode_equals_cpu": decode_same, "launches_per_decode": launches,
           "counters": {k: counts.get(k, 0) for k in
                        ("modular_card_streams", "modular_tree_samples",
                         "modular_group_streams")},
           "traced_spans_ms": spans, "bound_by": "the longest lane's chain of dependent steps",
           "k6_trees": trees}
    emit(rec)
    check(same, "K6 differs from its plain version")
    check(all(t["bit_for_bit"] for t in trees.values()),
          f"K6 differs from its plain version on a deeper tree: {trees}")
    check(decode_same, "the card decode differs from the CPU decode")
    check(launches == 1 and counts.get("modular_card_streams") == len(table.lanes),
          f"the decode did not take K6 once over every lane: {rec}")
    return rec


def feature_streams():
    """[(name, codestream, channels out, the writer's AC coefficients or
    None)] of the features phase, both 3840x2160 out: a 1920x1080 XYB
    VarDCT frame upsampled 2x with photon noise (a seeded LUT), and a
    3840x2160 XYB Modular frame with an 8-bit alpha channel."""
    import numpy as np

    from test_torch_streams import encode_xyb_modular
    from test_torch_vardct_streams import encode_xyb_vardct

    lut = np.random.default_rng(7).integers(64, 512, 8).tolist()
    vd, vcoeffs = encode_xyb_vardct(WIDTH // 2, HEIGHT // 2, seed=7, upsampling=2, noise=lut)
    md, _ = encode_xyb_modular(WIDTH, HEIGHT, seed=7, num_ec=1)
    return [("vardct_up2_noise", vd, 3, vcoeffs), ("modular_alpha", md, 4, None)]


def phase_features(streams):
    """decode_image of the feature streams on the card, 3 reps a format,
    held against the port's CPU decode (VarDCT AC on the host decoder);
    K3's coefficients of the upsampled frame (40 lanes) bit for bit
    against the writer's and the host decoder's."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K

    mp = WIDTH * HEIGHT / 1e6
    runs = {}
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    for name, data, _, _ in streams:
        for fmt in ("u8", "f32"):
            for rep in range(3):
                t0 = time.perf_counter()
                img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                host = img.timings["host_s"]
                runs[(name, fmt)] = img.frames[0]
                emit({"phase": "features", "stream": name, "format": fmt, "rep": rep,
                      "megapixels": mp, "seconds": total, "mp_per_s": mp / total,
                      "host_parse_entropy_s": host,
                      "noise_field_host_s": img.timings.get("noise_field_s"),
                      "device_s": total - host})
    launches = {"epf_gab": K.epf_gab.launches,
                "decode_ac_sections": device_ac.decode_ac_sections.launches,
                "ans_decode_batch": AL.ans_decode_batch.launches}
    emit({"phase": "features", "launches": launches})
    check(launches["epf_gab"] > 0, "the feature decodes did not launch epf_gab")
    check(launches["decode_ac_sections"] > 0, "the upsampled VarDCT decode did not launch K3")
    for name, data, _, coeffs in streams:
        if coeffs is None:
            continue
        lanes = _vardct_frame(data, "cuda")
        torch.cuda.synchronize()
        k3 = lanes.device_ac_flat.cpu().numpy()
        host = _vardct_frame(data, "cpu", host_ac=True).host_ac_flat
        same_writer = np.array_equal(k3, coeffs)
        same_host = np.array_equal(k3, host)
        emit({"phase": "features", "stream": name, "lanes": lanes.header.num_groups,
              "k3_equals_writer": same_writer, "k3_equals_host_decoder": same_host,
              "nonzero_coefficients": int(np.count_nonzero(coeffs))})
        check(same_writer and same_host,
              f"{name}: K3's coefficients differ from the writer's or the host's")
    # the noise field's upload: a pinned buffer of its shape, as the decode
    # makes it, copied to the card
    field = torch.empty((3, HEIGHT, WIDTH), dtype=torch.float32, pin_memory=True)
    upload_ms = time_ms(lambda: field.to("cuda", non_blocking=True), reps=5, warmup=1)
    emit({"phase": "features", "noise_field_bytes": field.nbytes,
          "noise_field_upload_ms": upload_ms,
          "upload_gb_per_s": field.nbytes / upload_ms / 1e6})

    os.environ["JXL_TPU_AC"] = "host"
    try:
        for name, data, channels, _ in streams:
            for fmt in ("u8", "f32"):
                got = runs[(name, fmt)]
                check(got.device.type == "cuda", "frames must stay on the card")
                check(tuple(got.shape) == (HEIGHT, WIDTH, channels),
                      f"{name}: bad shape {tuple(got.shape)}")
                t0 = time.perf_counter()
                ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
                cpu_s = time.perf_counter() - t0
                a = got.cpu().numpy().astype(np.float64)
                b = ref.numpy().astype(np.float64)
                check(np.isfinite(a).all(), "non-finite output")
                diff = float(np.abs(a - b).max())
                limit = 1.0 if fmt == "u8" else 1e-4
                emit({"phase": "features", "stream": name, "format": fmt,
                      "vs_cpu_max_abs_diff": diff, "limit": limit, "cpu_decode_s": cpu_s,
                      "min": float(a.min()), "max": float(a.max())})
                check(diff <= limit, f"{name} {fmt} decode on the card differs from the CPU: "
                      f"{diff}")
    finally:
        os.environ.pop("JXL_TPU_AC", None)
    return launches


# the SM clock the breakdown's spins are sized for (an H100 SXM's boost
# clock; a slower clock only makes a spin last longer)
SPIN_CYCLES_PER_S = 1.98e9


def phase_render_breakdown(data, stream: str, phase: str) -> list:
    """A VarDCT render of decode_image taken apart: the host parse with
    the AC decode; then each step (the VarDCT planes, the noise field's
    upload when the frame has noise, each run of stages that run_span runs
    at once: chroma upsampling, K1, each feature stage, the colour
    transform, the u8 conversion) is called once to read how long the host
    takes to queue it, and again behind a spin on the card twice that long,
    so that CUDA events around the second call read the card's time alone.
    The noise field on the host clock. Returns the steps' records."""
    import torch

    from jxl_tpu_torch.features.noise import generate_noise_field
    from jxl_tpu_torch.render.pipeline import (build_render_pipeline, color_transform_stage,
                                               convert_output_stage)
    from jxl_tpu_torch.render.simple import vardct_planes
    from jxl_tpu_torch.render.span_exec import run_span, segments

    dev = torch.device("cuda")
    steps = []

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * host_s + 1e-3) * SPIN_CYCLES_PER_S))
        a.record()
        out = fn()
        b.record()
        steps.append((name, host_s, a, b))
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = _vardct_frame(data, dev)
    torch.cuda.synchronize()
    parse_s = time.perf_counter() - t0
    chans = timed("vardct_planes", lambda: vardct_planes(frame, dev))
    ctx = {"frame": frame}
    field_s = None
    if frame.header.has_noise:
        t0 = time.perf_counter()
        field = generate_noise_field(frame, pin_memory=True)
        field_s = time.perf_counter() - t0
        ctx["noise_field"] = timed("noise_field_upload",
                                   lambda: field.to(dev, non_blocking=True))
    span = build_render_pipeline(frame) + [color_transform_stage(frame),
                                           convert_output_stage("u8", (0, 1, 2))]
    for seg in segments(span):  # the pieces decode_image's run_span runs
        name = "+".join(s.name for s in seg)
        chans = timed(name, lambda seg=seg, chans=chans: run_span(seg, chans, ctx))
    torch.cuda.synchronize()
    records = [{"step": name, "host_queue_ms": host_s * 1e3, "device_ms": a.elapsed_time(b)}
               for name, host_s, a, b in steps]
    emit({"phase": phase, "stream": stream, "format": "u8",
          "host_parse_and_ac_decode_s": parse_s, "noise_field_host_s": field_s,
          "steps": records, "device_ms_total": sum(r["device_ms"] for r in records),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return records


def layout_streams():
    """[(name, codestream, (width, height), channels out, the writer's AC
    coefficients or None)] of the layouts phase: (a) the 3840x2160 YCbCr
    4:2:0 frame of a recompressed JPEG (DCT8, no filters), (b) a 1920x1080
    YCbCr 4:2:0 frame with the default filters, (c) a 3840x2160 XYB frame
    with an 8-bit alpha and the default filters, (d) a 3840x2160 YCbCr
    4:2:0 Modular frame with the default filters
    (tests/test_torch_streams.py:encode_ycbcr_modular)."""
    from test_torch_streams import encode_ycbcr_modular
    from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

    a, a_coeffs = encode_ycbcr_vardct(WIDTH, HEIGHT, seed=7, filters=False)
    b, _ = encode_ycbcr_vardct(WIDTH // 2, HEIGHT // 2, seed=8)
    c, _, _ = encode_xyb_vardct(WIDTH, HEIGHT, seed=9, num_ec=1)
    d, _ = encode_ycbcr_modular(WIDTH, HEIGHT, seed=10, subsampling="420")
    return [("ycbcr420_jpeg", a, (WIDTH, HEIGHT), 3, a_coeffs),
            ("ycbcr420_filtered", b, (WIDTH // 2, HEIGHT // 2), 3, None),
            ("xyb_alpha", c, (WIDTH, HEIGHT), 4, None),
            ("modular_ycbcr420", d, (WIDTH, HEIGHT), 3, None)]


def phase_layouts(streams) -> dict:
    """decode_image of the layout streams on the card, 3 reps a format,
    with each stream's K1 and K3 launches; K3's buffer of the JPEG frame
    against the writer's and the host decoder's; every decode against the
    port's CPU decode (host AC); then the JPEG frame's render taken apart,
    its chroma upsampling timed beside its bytes bound."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K

    runs = {}
    per_stream = {}
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    for name, data, (w, h), _, _ in streams:
        k1, k3 = K.epf_gab.launches, device_ac.decode_ac_sections.launches
        mp = w * h / 1e6
        for fmt in ("u8", "f32"):
            for rep in range(3):
                t0 = time.perf_counter()
                img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                host = img.timings["host_s"]
                runs[(name, fmt)] = img.frames[0]
                emit({"phase": "layouts", "stream": name, "format": fmt, "rep": rep,
                      "megapixels": mp, "seconds": total, "mp_per_s": mp / total,
                      "host_parse_entropy_s": host, "device_s": total - host})
        per_stream[name] = {"epf_gab": K.epf_gab.launches - k1,
                            "decode_ac_sections": device_ac.decode_ac_sections.launches - k3}
        emit({"phase": "layouts", "stream": name, "launches": per_stream[name]})
    launches = {"epf_gab": K.epf_gab.launches,
                "decode_ac_sections": device_ac.decode_ac_sections.launches,
                "ans_decode_batch": AL.ans_decode_batch.launches, "per_stream": per_stream}
    emit({"phase": "layouts", "launches": launches})
    (a, a_data, _, _, a_coeffs), (b, *_), (c, *_), (d, *_) = streams
    check(per_stream[a]["decode_ac_sections"] > 0 and per_stream[b]["decode_ac_sections"] > 0,
          "the YCbCr 4:2:0 decodes did not launch K3")
    check(per_stream[b]["epf_gab"] > 0 and per_stream[c]["epf_gab"] > 0
          and per_stream[d]["epf_gab"] > 0, "the filtered layout decodes did not launch epf_gab")
    check(per_stream[d]["decode_ac_sections"] == 0, "the Modular frame launched K3")

    lanes = _vardct_frame(a_data, "cuda")
    torch.cuda.synchronize()
    k3 = lanes.device_ac_flat.cpu().numpy()
    host = _vardct_frame(a_data, "cpu", host_ac=True).host_ac_flat
    same_writer = np.array_equal(k3, a_coeffs)
    same_host = np.array_equal(k3, host)
    emit({"phase": "layouts", "stream": a, "lanes": lanes.header.num_groups,
          "k3_equals_writer": same_writer, "k3_equals_host_decoder": same_host,
          "nonzero_coefficients": int(np.count_nonzero(a_coeffs))})
    check(same_writer and same_host, f"{a}: K3's coefficients differ from the writer's or the host's")

    os.environ["JXL_TPU_AC"] = "host"
    try:
        for name, data, (w, h), channels, _ in streams:
            for fmt in ("u8", "f32"):
                got = runs[(name, fmt)]
                check(got.device.type == "cuda", "frames must stay on the card")
                check(tuple(got.shape) == (h, w, channels), f"{name}: bad shape {tuple(got.shape)}")
                t0 = time.perf_counter()
                ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames[0]
                cpu_s = time.perf_counter() - t0
                x = got.cpu().numpy().astype(np.float64)
                y = ref.numpy().astype(np.float64)
                check(np.isfinite(x).all(), "non-finite output")
                diff = float(np.abs(x - y).max())
                limit = 1.0 if fmt == "u8" else 1e-4
                emit({"phase": "layouts", "stream": name, "format": fmt,
                      "vs_cpu_max_abs_diff": diff, "limit": limit, "cpu_decode_s": cpu_s,
                      "min": float(x.min()), "max": float(x.max())})
                check(diff <= limit, f"{name} {fmt} decode on the card differs from the CPU: "
                      f"{diff}")
    finally:
        os.environ.pop("JXL_TPU_AC", None)

    steps = [r for r in phase_render_breakdown(a_data, a, "layouts_breakdown")
             if r["step"].startswith("chroma_upsample")]
    # bytes: Cb and Cr read once at a quarter of the frame, written once whole
    nbytes = 2 * 4 * (WIDTH * HEIGHT // 4 + WIDTH * HEIGHT)
    rec = {"phase": "layouts", "stream": a, "chroma_upsample_steps": len(steps),
           "chroma_upsample_device_ms": sum(r["device_ms"] for r in steps),
           "chroma_upsample_host_queue_ms": sum(r["host_queue_ms"] for r in steps),
           "chroma_upsample_bytes": nbytes,
           "chroma_upsample_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(rec)
    check(len(steps) == 4, f"{a}: {len(steps)} chroma upsampling steps, not 4")
    return launches


def frame_streams():
    """[(name, codestream, (width, height), channels out, frames out, K3
    and K1 launches a decode)] of the frames phase
    (tests/test_torch_frame_streams.py): an XYB VarDCT animation at
    1920x1080 whose seven later frames are 960x544 crops blending by
    REPLACE, ADD and MUL; an sRGB Modular animation with alpha at
    1920x1080 whose later frames BLEND; a 3840x2160 XYB VarDCT frame with
    7000 16x32 glyph patches from a 1024x512 REFERENCE_ONLY Modular atlas."""
    from test_torch_frame_streams import anim_rgba_stream, anim_vardct_stream, patches_stream

    half = (WIDTH // 2, HEIGHT // 2)
    crop = (960, 544)
    return [
        ("anim_vardct_1080p", anim_vardct_stream(*half, crop, num_frames=8, seed=7), half, 3,
         8, {"decode_ac_sections": 8, "epf_gab": 8}),
        ("anim_rgba_1080p", anim_rgba_stream(*half, crop, num_frames=8, seed=8), half, 4, 8,
         {"decode_ac_sections": 0, "epf_gab": 0}),
        ("patches_4k", patches_stream(WIDTH, HEIGHT, (1024, 512), 7000, 128, seed=9),
         (WIDTH, HEIGHT), 3, 1, {"decode_ac_sections": 1, "epf_gab": 1}),
    ]


def _timed_call(records, name, fn, sync_debug: bool = False):
    """fn wrapped so that each call is queued behind a spin on the card and
    timed by CUDA events around it (its card time alone), with the host's
    time to queue it: (name, host seconds, start event, end event) go to
    `records`. With sync_debug the call runs under
    torch.cuda.set_sync_debug_mode("error"), so a host sync inside it
    raises."""
    import torch

    def call(*args, **kw):
        torch.cuda._sleep(int(5e-3 * SPIN_CYCLES_PER_S))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if sync_debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            a.record()
            out = fn(*args, **kw)
            b.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        records.append((name, time.perf_counter() - t0, a, b))
        return out
    return call


def _step_totals(records) -> dict:
    """{step: {"calls", "device_ms", "host_queue_ms"}} of _timed_call's
    records (read after a synchronize)."""
    by = {}
    for step, host_s, a, b in records:
        r = by.setdefault(step, {"calls": 0, "device_ms": 0.0, "host_queue_ms": 0.0})
        r["calls"] += 1
        r["device_ms"] += a.elapsed_time(b)
        r["host_queue_ms"] += host_s * 1e3
    return by


def _instrument_frame_steps(records, sync_debug: bool):
    """Wrap the decode's blend (render/simple.py:blend_and_extend), slot
    save (DecoderState.save_reference) and patch stage with _timed_call
    (sync_debug: a host sync inside them raises). Returns a function that
    undoes it."""
    from jxl_tpu_torch.api.state import DecoderState
    from jxl_tpu_torch.render import pipeline, simple

    def timed(name, fn):
        return _timed_call(records, name, fn, sync_debug)

    real_blend = simple.blend_and_extend
    real_save = DecoderState.save_reference
    real_patches = pipeline.patches_stage

    def patches_stage(frame):
        stage = real_patches(frame)
        return pipeline.Stage(stage.name, timed("patches", stage.fn), stage.border, stage.shift,
                              stage.channels)

    simple.blend_and_extend = timed("blend", real_blend)
    DecoderState.save_reference = timed("save", real_save)
    pipeline.patches_stage = patches_stage

    def undo():
        simple.blend_and_extend = real_blend
        DecoderState.save_reference = real_save
        pipeline.patches_stage = real_patches
    return undo


def phase_frames(streams) -> dict:
    """decode_image of the multi-frame streams on the card, u8 and f32, 3
    reps each: wall time, host_s, MP/s of output, each stream's K3 and K1
    launches a decode (8 and 8 for the VarDCT animation, 1 and 1 for the
    patches frame); every frame and duration against the port's CPU decode
    (host AC; f32 <= 1e-4, u8 <= 1 LSB); then one instrumented u8 decode a
    stream: the blend, slot save and patch steps' card time from CUDA
    events, each queued behind a spin, and the same steps again under
    torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K

    runs = {}
    per_stream = {}
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    for name, data, (w, h), _, nframes, expect in streams:
        mp = w * h * nframes / 1e6
        counts = []
        for fmt in ("u8", "f32"):
            for rep in range(3):
                k1, k3 = K.epf_gab.launches, device_ac.decode_ac_sections.launches
                t0 = time.perf_counter()
                img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                host = img.timings["host_s"]
                counts.append({"decode_ac_sections": device_ac.decode_ac_sections.launches - k3,
                               "epf_gab": K.epf_gab.launches - k1})
                runs[(name, fmt)] = img
                emit({"phase": "frames", "stream": name, "format": fmt, "rep": rep,
                      "frames": len(img.frames), "megapixels": mp, "seconds": total,
                      "mp_per_s": mp / total, "host_parse_entropy_s": host,
                      "device_s": total - host})
        per_stream[name] = counts[0]
        emit({"phase": "frames", "stream": name, "launches_per_decode": counts[0],
              "expected": expect})
        check(all(c == expect for c in counts),
              f"{name}: launches a decode {counts}, expected {expect}")
    launches = {"epf_gab": K.epf_gab.launches,
                "decode_ac_sections": device_ac.decode_ac_sections.launches,
                "ans_decode_batch": AL.ans_decode_batch.launches, "per_stream": per_stream}
    emit({"phase": "frames", "launches": launches})

    os.environ["JXL_TPU_AC"] = "host"
    try:
        for name, data, (w, h), channels, nframes, _ in streams:
            for fmt in ("u8", "f32"):
                got = runs[(name, fmt)]
                t0 = time.perf_counter()
                ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu")
                cpu_s = time.perf_counter() - t0
                check(len(got.frames) == len(ref.frames) == nframes,
                      f"{name}: {len(got.frames)} frames on the card, {len(ref.frames)} on the "
                      f"CPU, {nframes} written")
                check(got.durations == ref.durations, f"{name}: durations differ")
                diff = 0.0
                for x, y in zip(got.frames, ref.frames):
                    check(x.device.type == "cuda", "frames must stay on the card")
                    check(tuple(x.shape) == (h, w, channels), f"{name}: bad shape {tuple(x.shape)}")
                    a = x.cpu().numpy().astype(np.float64)
                    check(np.isfinite(a).all(), "non-finite output")
                    diff = max(diff, float(np.abs(a - y.numpy().astype(np.float64)).max()))
                limit = 1.0 if fmt == "u8" else 1e-4
                emit({"phase": "frames", "stream": name, "format": fmt,
                      "vs_cpu_max_abs_diff": diff, "limit": limit, "cpu_decode_s": cpu_s,
                      "durations_ms": got.durations})
                check(diff <= limit, f"{name} {fmt} decode on the card differs from the CPU: "
                      f"{diff}")
    finally:
        os.environ.pop("JXL_TPU_AC", None)

    steps = {}
    for name, data, *_ in streams:
        for sync_debug in (False, True):
            records = []
            undo = _instrument_frame_steps(records, sync_debug)
            try:
                jxl_tpu_torch.decode_image(data, pixel_format="u8")
                torch.cuda.synchronize()
            finally:
                undo()
            if sync_debug:
                emit({"phase": "frames", "stream": name, "sync_debug_error_mode": "no sync",
                      "steps_checked": len(records)})
                continue
            by = _step_totals(records)
            steps[name] = by
            emit({"phase": "frames", "stream": name, "format": "u8", "steps": by})
    check(steps["patches_4k"].get("patches", {}).get("calls") == 1,
          "the patches frame did not run the patch stage")
    check(steps["anim_vardct_1080p"].get("blend", {}).get("calls") == 7,
          "the VarDCT animation did not blend its seven cropped frames")
    return launches


def tool_streams():
    """[(name, codestream, (width, height), channels out, K3 and K1
    launches a decode)] of the tools phase (the coding tools of
    tests/test_torch_{frame,icc,spline}_streams.py): progressive_4k, a
    480x270 XYB Modular LF frame (lf_level 1, no filters) ahead of a
    3840x2160 XYB VarDCT frame that reads its LF from it, in two AC
    passes with the default filters (cjxl -p --progressive_dc=1);
    progressive_rgba_1080p, 1920x1080 XYB VarDCT with an 8-bit alpha in
    two passes (the host AC route); icc_jpeg_4k, the 3840x2160 YCbCr 4:2:0
    frame of a recompressed JPEG without filters, with a BT.2100 PQ
    profile (a 4096-entry curv TRC) embedded; splines_4k, 3840x2160 XYB
    VarDCT with 64 splines of 8-16 control points and sigma 1-4 px."""
    from test_torch_frame_streams import lf_frame_stream
    from test_torch_icc_streams import pq_profile
    from test_torch_spline_streams import splines_stream
    from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

    half = (WIDTH // 2, HEIGHT // 2)
    full = (WIDTH, HEIGHT)
    rgba, _, _ = encode_xyb_vardct(*half, seed=12, num_ec=1, passes=2)
    jpeg, _ = encode_ycbcr_vardct(*full, seed=13, filters=False, icc=pq_profile())
    spl, _ = splines_stream(*full, 64, seed=14)
    return [
        ("progressive_4k", lf_frame_stream(*full, passes=2, seed=11), full, 3,
         {"decode_ac_sections": 1, "epf_gab": 1}),
        ("progressive_rgba_1080p", rgba, half, 4, {"decode_ac_sections": 0, "epf_gab": 1}),
        ("icc_jpeg_4k", jpeg, full, 3, {"decode_ac_sections": 1, "epf_gab": 0}),
        ("splines_4k", spl, full, 3, {"decode_ac_sections": 1, "epf_gab": 1}),
    ]


def _instrument_tool_steps(records, lanes):
    """Wrap the spline stage's body and the LF adoption
    (api/frame.py:Frame._adopt_lf_frame) with _timed_call, and record the
    lane count of each lane decoder run (vardct/device_group.py:run_lanes)
    in `lanes`. Returns a function that undoes it."""
    from jxl_tpu_torch.api.frame import Frame
    from jxl_tpu_torch.render import pipeline
    from jxl_tpu_torch.vardct import device_group

    real_splines = pipeline.splines_stage
    real_adopt = Frame._adopt_lf_frame
    real_run_lanes = device_group.run_lanes

    def splines_stage(frame):
        stage = real_splines(frame)
        return pipeline.Stage(stage.name, _timed_call(records, "splines", stage.fn),
                              stage.border, stage.shift, stage.channels)

    def run_lanes(inputs, device, out=None):
        lanes.append(int(inputs["start_bits"].shape[0]))
        return real_run_lanes(inputs, device, out=out)

    pipeline.splines_stage = splines_stage
    Frame._adopt_lf_frame = _timed_call(records, "adopt_lf_frame", real_adopt)
    device_group.run_lanes = run_lanes

    def undo():
        pipeline.splines_stage = real_splines
        Frame._adopt_lf_frame = real_adopt
        device_group.run_lanes = real_run_lanes
    return undo


def phase_tools(streams) -> dict:
    """decode_image of the coding-tool streams on the card, u8 and f32, 3
    reps each: wall time, host_s, MP/s, each stream's K3 and K1 launches a
    decode and K3's lane count (270 for progressive_4k: two lanes a
    group); the embedded profile's bytes; every decode against the port's
    CPU decode (host AC; f32 <= 1e-4, u8 <= 1 LSB); then one instrumented
    u8 decode a stream: the spline stage's card time beside its bytes
    bound (segments, splatted pixels) and the LF adoption's card time."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.render.pipeline import spline_plan
    from test_torch_icc_streams import pq_profile

    runs = {}
    per_stream = {}
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    for name, data, (w, h), _, expect in streams:
        mp = w * h / 1e6
        counts = []
        for fmt in ("u8", "f32"):
            for rep in range(3):
                k1, k3 = K.epf_gab.launches, device_ac.decode_ac_sections.launches
                t0 = time.perf_counter()
                img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                host = img.timings["host_s"]
                counts.append({"decode_ac_sections": device_ac.decode_ac_sections.launches - k3,
                               "epf_gab": K.epf_gab.launches - k1})
                runs[(name, fmt)] = img
                emit({"phase": "tools", "stream": name, "format": fmt, "rep": rep,
                      "megapixels": mp, "seconds": total, "mp_per_s": mp / total,
                      "host_parse_entropy_s": host, "device_s": total - host})
        per_stream[name] = counts[0]
        emit({"phase": "tools", "stream": name, "launches_per_decode": counts[0],
              "expected": expect})
        check(all(c == expect for c in counts),
              f"{name}: launches a decode {counts}, expected {expect}")
    launches = {"epf_gab": K.epf_gab.launches,
                "decode_ac_sections": device_ac.decode_ac_sections.launches,
                "ans_decode_batch": AL.ans_decode_batch.launches, "per_stream": per_stream}
    emit({"phase": "tools", "launches": launches})
    profile = pq_profile()
    for fmt in ("u8", "f32"):
        img = runs[("icc_jpeg_4k", fmt)]
        same = img.icc_profile == profile and img.output_icc() == profile
        emit({"phase": "tools", "stream": "icc_jpeg_4k", "format": fmt,
              "icc_bytes": len(profile), "output_icc_equals_written": same})
        check(same, "icc_jpeg_4k: the embedded profile is not the one written")

    os.environ["JXL_TPU_AC"] = "host"
    try:
        for name, data, (w, h), channels, _ in streams:
            for fmt in ("u8", "f32"):
                got = runs[(name, fmt)].frames
                t0 = time.perf_counter()
                ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames
                cpu_s = time.perf_counter() - t0
                check(len(got) == len(ref) == 1, f"{name}: {len(got)} frames, not 1")
                x = got[0]
                check(x.device.type == "cuda", "frames must stay on the card")
                check(tuple(x.shape) == (h, w, channels), f"{name}: bad shape {tuple(x.shape)}")
                a = x.cpu().numpy().astype(np.float64)
                check(np.isfinite(a).all(), "non-finite output")
                diff = float(np.abs(a - ref[0].numpy().astype(np.float64)).max())
                limit = 1.0 if fmt == "u8" else 1e-4
                emit({"phase": "tools", "stream": name, "format": fmt,
                      "vs_cpu_max_abs_diff": diff, "limit": limit, "cpu_decode_s": cpu_s,
                      "min": float(a.min()), "max": float(a.max())})
                check(diff <= limit, f"{name} {fmt} decode on the card differs from the CPU: "
                      f"{diff}")
    finally:
        os.environ.pop("JXL_TPU_AC", None)

    steps = {}
    lane_counts = {}
    for name, data, *_ in streams:
        records, lanes = [], []
        undo = _instrument_tool_steps(records, lanes)
        try:
            jxl_tpu_torch.decode_image(data, pixel_format="u8")
            torch.cuda.synchronize()
        finally:
            undo()
        steps[name] = _step_totals(records)
        lane_counts[name] = lanes
        emit({"phase": "tools", "stream": name, "format": "u8", "steps": steps[name],
              "k3_lanes": lanes})
    check(lane_counts["progressive_4k"] == [270],
          f"progressive_4k: K3 ran {lane_counts['progressive_4k']} lanes, not [270]")
    check(steps["progressive_4k"].get("adopt_lf_frame", {}).get("calls") == 1,
          "progressive_4k did not adopt its LF frame")

    # the splines: the draw cache's segments and the pixels their boxes
    # cover, as the stage plans them
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    data = next(d for n, d, *_ in streams if n == "splines_4k")
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    t0 = time.perf_counter()
    frame.decode_lf_global(frame.split_sections(br)[0])
    lf_global_s = time.perf_counter() - t0
    table = frame.lf_global.splines.table
    rows, boxes, chunks = spline_plan(table, HEIGHT, WIDTH)
    pixels = int(boxes[:, 3].sum())
    # bytes: the table and boxes in; each splatted pixel's three planes
    # read and written once
    nbytes = rows.nbytes + boxes.nbytes + pixels * 3 * 4 * 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    # float operations a pixel: position, distance, two fast_erf, the brush
    # and three multiply-adds (about 40)
    t_ops = pixels * 40 / FP32_OPS_PER_S
    st = steps["splines_4k"].get("splines", {})
    check(st.get("calls") == 1, "splines_4k did not run the spline stage")
    rec = {"phase": "tools", "stream": "splines_4k", "splines": len(frame.lf_global.splines.splines),
           "segments": len(table), "segments_on_frame": len(rows), "splat_chunks": len(chunks),
           "splatted_pixels": pixels, "lf_global_with_draw_cache_s": lf_global_s,
           "splines_device_ms": st.get("device_ms"),
           "splines_host_queue_ms": st.get("host_queue_ms"),
           "splines_bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(rec)
    launches["k3_lanes"] = lane_counts
    return launches


def _read_png(path):
    """An 8-bit PNG of filter-0 rows (as jxl_tpu_torch/cli.py writes
    them) as an (h, w, c) uint8 array."""
    import zlib

    import numpy as np

    b = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(b):
        n = int.from_bytes(b[pos : pos + 4], "big")
        tag, payload = b[pos + 4 : pos + 8], b[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            ihdr = payload
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + n
    w, h = int.from_bytes(ihdr[:4], "big"), int.from_bytes(ihdr[4:8], "big")
    check(ihdr[8] == 8, "the PNG is not 8-bit")
    c = {0: 1, 4: 2, 2: 3, 6: 4}[ihdr[9]]
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 1:].reshape(h, w, c)


def _feed(dec, data, chunks, on_event=None) -> int:
    """Drive a JxlDecoder to COMPLETE, feeding `data` in the pieces
    `chunks` yields (sizes); on_event(event, bytes fed) sees every other
    event. Returns the number of process() calls."""
    from jxl_tpu_torch.api.decoder import Event

    pos, calls = 0, 0
    sizes = iter(chunks)
    while True:
        ev = dec.process()
        calls += 1
        if ev is Event.COMPLETE:
            return calls
        if ev is Event.NEED_MORE_INPUT:
            if pos >= len(data):
                dec.end_input()
                continue
            n = next(sizes)
            dec.feed(data[pos : pos + n])
            pos += n
        elif on_event is not None:
            on_event(ev, pos)


# the streaming phase's input pieces: (a) and (b), and (c) after its
# first 4 KiB a byte at a time
STREAM_CHUNK_FULL = 4096
STREAM_CHUNK_FLUSH = 65536


def phase_streaming(progressive, anim, vdata) -> dict:
    """The streaming decoder (api/decoder.py) and the CLI on the card.
    (a) progressive_4k fed 4 KiB at a time, FULL_FRAME, u8 and f32: equal
    to decode_image bit for bit, with its wall, process() calls and K3 and
    K1 launches (1 and 1 for the main frame). (b) the same stream 64 KiB
    at a time, EAGER, a flush at every FRAME_PROGRESSION: each flush's
    wall and K3's lanes at each launch, the LF preview, the first flush
    after the LF frame; every flush within f32 1e-4 of the port's CPU
    JxlDecoder's (host AC) at the same bytes, the final frame equal to
    (a)'s. (c) the 8-frame VarDCT animation in three jxlp boxes: a frame
    scan, a seek to visible frame 5, then a decode fed a byte at a time
    through its first 4 KiB: frames and durations equal to decode_image's.
    (d) python -m jxl_tpu_torch.cli in a subprocess on the 4K VarDCT
    stream: its PNG equal to decode_image's u8 frame, and --speedtest."""
    import tempfile

    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.api.decoder import Event, JxlDecoder, JxlDecoderOptions, ProgressiveMode
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.vardct import device_group
    from test_torch_frame_streams import jxlp_container

    def counts():
        return {"decode_ac_sections": device_ac.decode_ac_sections.launches,
                "epf_gab": K.epf_gab.launches}

    out = {}
    # (a) the main path: counts from 0 around the two streaming decodes
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    full = {}
    for fmt in ("u8", "f32"):
        dec = JxlDecoder(JxlDecoderOptions(pixel_format=fmt))
        per_frame = []
        before = counts()

        def on_event(ev, pos, per_frame=per_frame):
            if ev is Event.FRAME_DONE:
                now = counts()
                per_frame.append({k: now[k] - before[k] for k in now})
                before.update(now)

        t0 = time.perf_counter()
        calls = _feed(dec, progressive, iter(lambda: STREAM_CHUNK_FULL, None), on_event)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full[fmt] = dec.frames
        emit({"phase": "streaming", "part": "a", "format": fmt, "chunk": STREAM_CHUNK_FULL,
              "bytes": len(progressive), "seconds": wall, "process_calls": calls,
              "launches_per_frame": per_frame})
        check(len(dec.frames) == 1, f"(a) {fmt}: {len(dec.frames)} frames")
        check(per_frame[-1] == {"decode_ac_sections": 1, "epf_gab": 1},
              f"(a) {fmt}: the main frame launched {per_frame[-1]}, not K3 once and K1 once")
    launches = counts()
    launches["ans_decode_batch"] = AL.ans_decode_batch.launches
    for fmt in ("u8", "f32"):
        t0 = time.perf_counter()
        ref = jxl_tpu_torch.decode_image(progressive, pixel_format=fmt)
        torch.cuda.synchronize()
        same = torch.equal(full[fmt][0], ref.frames[0])
        emit({"phase": "streaming", "part": "a", "format": fmt,
              "decode_image_seconds": time.perf_counter() - t0, "bit_equal_to_decode_image": same})
        check(same, f"(a) {fmt}: the streaming decode differs from decode_image")
    out["launches"] = launches

    # (b) progressive flushes on the card, then the CPU decoder at the same bytes
    lanes = []
    real_run_lanes = device_group.run_lanes

    def run_lanes(inputs, device, out=None):
        lanes.append(int(inputs["start_bits"].shape[0]))
        return real_run_lanes(inputs, device, out=out)

    def flushed(device):
        dec = JxlDecoder(JxlDecoderOptions(progressive_mode=ProgressiveMode.EAGER), device=device)
        flushes = []
        marks = {}

        def on_event(ev, pos):
            if ev is Event.FRAME_DONE and "lf_done" not in marks:
                marks["lf_done"] = time.perf_counter()
            if ev is not Event.FRAME_PROGRESSION:
                return
            n_lanes = len(lanes)
            t0 = time.perf_counter()
            fl = dec.flush_pixels()
            if device == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            flushes.append({"bytes": pos, "seconds": t1 - t0,
                            "shape": None if fl is None else list(fl.shape),
                            "pixels": None if fl is None else fl.cpu().numpy()})
            if "lf_done" in marks and "first" not in marks and fl is not None:
                marks["first"] = (t1 - marks["lf_done"], t1 - t0)
            flushes[-1]["k3_lanes"] = lanes[n_lanes:]

        _feed(dec, progressive, iter(lambda: STREAM_CHUNK_FLUSH, None), on_event)
        return dec, flushes, marks

    device_group.run_lanes = run_lanes
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    try:
        dec, card, marks = flushed("cuda")
    finally:
        device_group.run_lanes = real_run_lanes
    out["flush_launches"] = counts()
    card_lanes = list(lanes)
    check(out["flush_launches"]["decode_ac_sections"] == len(card_lanes),
          f"(b) K3 launched {out['flush_launches']} times over {card_lanes} lanes")
    check(torch.equal(dec.frames[0], full["f32"][0]),
          "(b) the final frame after the flushes differs from (a)'s")
    main = dec.frame.header
    n_lanes = main.num_groups * main.passes.num_passes
    pv = dec.lf_preview()
    fh = dec.file_header
    check(pv is not None and tuple(pv.shape) == (-(-fh.ysize // 8), -(-fh.xsize // 8), 3),
          "(b) no 1/8 LF preview")
    os.environ["JXL_TPU_AC"] = "host"
    try:
        t0 = time.perf_counter()
        _, cpu, _ = flushed("cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        os.environ.pop("JXL_TPU_AC", None)
    check([f["bytes"] for f in card] == [f["bytes"] for f in cpu],
          "(b) the card and the CPU flushed at different bytes")
    diffs = []
    for a, b in zip(card, cpu):
        check((a["pixels"] is None) == (b["pixels"] is None), "(b) a flush rendered on one side")
        if a["pixels"] is not None:
            check(a["pixels"].shape == b["pixels"].shape, "(b) flush shapes differ")
            diffs.append(float(np.abs(a["pixels"].astype(np.float64) - b["pixels"]).max()))
    check(diffs and max(diffs) <= 1e-4, f"(b) a flush differs from the CPU's: {diffs}")
    check(sum(card_lanes) == n_lanes, f"(b) K3 ran {card_lanes} lanes, not {n_lanes} in all")
    out["flushes"] = len(card)
    out["flush_seconds"] = [f["seconds"] for f in card]
    out["k3_lanes_per_launch"] = card_lanes
    emit({"phase": "streaming", "part": "b", "chunk": STREAM_CHUNK_FLUSH, "flushes": len(card),
          "flush_seconds": out["flush_seconds"], "flush_bytes": [f["bytes"] for f in card],
          "flush_shapes": [f["shape"] for f in card],
          "k3_lanes_per_flush": [f["k3_lanes"] for f in card],
          "k3_lanes_per_launch": card_lanes, "launches": out["flush_launches"],
          "lf_preview_shape": list(pv.shape),
          "first_flush_after_lf_frame_s": marks.get("first", (None,))[0],
          "first_flush_after_lf_frame_flush_s": marks.get("first", (None, None))[1],
          "vs_cpu_max_abs_diff": diffs, "limit": 1e-4, "cpu_flushed_decode_s": cpu_s,
          "final_frame_equals_a": True})

    # (c) the animation in three jxlp boxes: scan, seek, byte-at-a-time
    want = jxl_tpu_torch.decode_image(anim)
    scan = JxlDecoder(JxlDecoderOptions(scan_frames_only=True))
    _feed(scan, anim, iter(lambda: 65536, None))
    offs = [f.codestream_offset for f in scan.scanned_frames]
    wrapped = jxlp_container(anim, [offs[2], offs[5]])
    dec = JxlDecoder(JxlDecoderOptions(scan_frames_only=True))
    _feed(dec, wrapped, iter(lambda: 65536, None))
    check(len(dec.scanned_frames) == 8, f"(c) the scan found {len(dec.scanned_frames)} frames")
    target = dec.scanned_frames[5].seek_target
    t0 = time.perf_counter()
    dec.start_new_frame(target)
    while dec.process() is not Event.COMPLETE:
        pass
    torch.cuda.synchronize()
    seek_s = time.perf_counter() - t0
    check(torch.equal(dec.frames[0], want.frames[5]), "(c) the seek to frame 5 differs")
    dec = JxlDecoder()
    sizes = (1 if i < 4096 else STREAM_CHUNK_FLUSH for i in range(len(wrapped)))
    t0 = time.perf_counter()
    calls = _feed(dec, wrapped, sizes)
    torch.cuda.synchronize()
    byte_s = time.perf_counter() - t0
    same = (len(dec.frames) == 8 and dec.durations == want.durations
            and all(torch.equal(a, b) for a, b in zip(dec.frames, want.frames)))
    check(same, "(c) the jxlp-boxed animation differs from decode_image")
    emit({"phase": "streaming", "part": "c", "jxlp_boxes": 3, "scanned_frames": len(offs),
          "seek_target": target.__dict__, "seek_seconds": seek_s, "seek_equals_frame_5": True,
          "byte_at_a_time_first_bytes": 4096, "process_calls": calls, "seconds": byte_s,
          "frames_equal": same, "durations_ms": dec.durations})

    # (d) the CLI in a subprocess, with this process's environment
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "vardct_4k.jxl")
        png = os.path.join(tmp, "vardct_4k.png")
        with open(src, "wb") as f:
            f.write(vdata)
        here = os.path.dirname(os.path.abspath(__file__))
        runs = {}
        for key, args in (("png", [src, png]), ("speedtest", [src, "--speedtest", "--num_reps",
                                                              "3"])):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "jxl_tpu_torch.cli", *args], cwd=here,
                               capture_output=True, text=True, timeout=300)
            runs[key] = (time.perf_counter() - t0, r.stdout.strip())
            check(r.returncode == 0, f"(d) the CLI {key} run failed: {r.stderr[-2000:]}")
        got = _read_png(png)
    ref = jxl_tpu_torch.decode_image(vdata, pixel_format="u8").frames[0].cpu().numpy()
    same = got.shape == ref.shape and np.array_equal(got, ref)
    check(same, "(d) the CLI's PNG differs from decode_image's u8 frame")
    mp_line = runs["speedtest"][1].splitlines()[-1]
    check("MP/s" in mp_line, f"(d) no MP/s line: {mp_line}")
    emit({"phase": "streaming", "part": "d", "cli_png_seconds": runs["png"][0],
          "cli_png_equals_decode_image_u8": same, "cli_speedtest_seconds": runs["speedtest"][0],
          "speedtest": mp_line})
    out["cli_speedtest"] = mp_line
    return out


def _diff_report(a, b) -> dict:
    """How two equal-shape output tensors differ: bit for bit or not, the
    max abs difference and the count of samples that differ."""
    import torch

    same = bool(torch.equal(a, b))
    d = (a.double() - b.double()).abs()
    return {"bit_for_bit": same, "max_abs_diff": float(d.max()),
            "samples_differ": int((d != 0).sum())}


def _check_same(rep: dict, fmt: str, what: str) -> None:
    """Bit for bit: a band runs the frame's own per-pixel math on products
    of one shape a type (_diff_report's figures go into the message)."""
    check(rep["bit_for_bit"], f"{what} {fmt} not bit for bit: {rep}")


def banded_streams(fstreams, tstreams, mstreams):
    """[(name, codestream, (width, height), channels out, K3 and K1
    launches of decode_banded)] of the banded phase's other band types:
    the features phase's 3840x2160 Modular frame with alpha (no K3), a
    1920x1080 XYB VarDCT frame with photon noise (no upsampling), the
    tools phase's progressive_4k (an LF frame decoded whole, then a
    two-pass VarDCT frame in bands), the frames phase's 4K patches frame
    (a REFERENCE_ONLY atlas decoded whole, then its patches band by band)
    and a 3840x2160 XYB VarDCT frame of the DCT32 to DCT256 transforms
    (transforms="large": a band's batch of each is not the frame's)."""
    import numpy as np

    from test_torch_vardct_streams import encode_xyb_vardct

    half = (WIDTH // 2, HEIGHT // 2)
    full = (WIDTH, HEIGHT)
    lut = np.random.default_rng(7).integers(64, 512, 8).tolist()
    pick = {name: data for name, data, *_ in fstreams + tstreams + mstreams}
    return [
        ("modular_alpha_4k", pick["modular_alpha"], full, 4,
         {"decode_ac_sections": 0, "epf_gab": 9}),
        ("vardct_noise_1080p", encode_xyb_vardct(*half, seed=15, noise=lut)[0], half, 3,
         {"decode_ac_sections": 5, "epf_gab": 5}),
        ("progressive_4k", pick["progressive_4k"], full, 3,
         {"decode_ac_sections": 9, "epf_gab": 9}),
        ("patches_4k", pick["patches_4k"], full, 3, {"decode_ac_sections": 9, "epf_gab": 9}),
        ("vardct_large_4k", encode_xyb_vardct(*full, seed=19, transforms="large")[0], full, 3,
         {"decode_ac_sections": 9, "epf_gab": 9}),
    ]


def phase_banded(vdata, streams) -> dict:
    """The banded decode on the card. (a) decode_image of the 4K VarDCT
    stream, u8 and f32, 5 reps each: wall, host_s, K1 and K3 launches a
    decode (1 and 1), peak card memory. (b) decode_banded of a
    7680x4320 VarDCT stream (17 bands) into a sink that copies each band
    into one pinned host array, against decode_image of the same bytes,
    with both walls and peak card memories, and decode_banded's peak at
    7680x1088 (5 bands): the working set follows the width, not the
    height. (c) decode_banded of the other band types (banded_streams)
    against decode_image. Band and frame agree bit for bit
    (_check_same). Returns the launches of each band path."""
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from test_torch_vardct_streams import encode_xyb_vardct

    def counts():
        return {"decode_ac_sections": device_ac.decode_ac_sections.launches,
                "epf_gab": K.epf_gab.launches}

    def reset():
        K.epf_gab.launches = 0
        device_ac.decode_ac_sections.launches = 0

    def measured(fn):
        """fn() synchronised: (result, wall s, peak card bytes above what
        was allocated before it)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

    out = {}
    AL.ans_decode_batch.launches = 0
    # (a) decode_image of the 4K stream
    mp = WIDTH * HEIGHT / 1e6
    for fmt in ("u8", "f32"):
        for rep in range(5):
            reset()
            img, wall, peak = measured(
                lambda: jxl_tpu_torch.decode_image(vdata, pixel_format=fmt))
            c = counts()
            emit({"phase": "banded", "step": "decode_image_4k", "format": fmt, "rep": rep,
                  "seconds": wall, "mp_per_s": mp / wall,
                  "host_parse_entropy_s": img.timings["host_s"],
                  "peak_card_bytes": peak, "launches": c})
            want = {"decode_ac_sections": 1, "epf_gab": 1}
            check(c == want, f"decode_image: launches {c}, expected {want}")

    # (b) decode_banded at 8K against decode_image of the same bytes
    t0 = time.perf_counter()
    big = encode_xyb_vardct(2 * WIDTH, 2 * HEIGHT, seed=17)[0]
    short = encode_xyb_vardct(2 * WIDTH, 1088, seed=18)[0]
    emit({"phase": "banded", "step": "write_8k", "bytes": len(big), "bytes_7680x1088": len(short),
          "seconds": time.perf_counter() - t0})

    def banded_into(data, host):
        info = {}

        def sink(y0, band):
            host[y0 : y0 + band.shape[0]].copy_(band, non_blocking=True)

        info.update(jxl_tpu_torch.decode_banded(data, sink))
        return info

    host = torch.empty((2 * HEIGHT, 2 * WIDTH, 3), dtype=torch.float32, pin_memory=True)
    small = torch.empty((1088, 2 * WIDTH, 3), dtype=torch.float32, pin_memory=True)
    banded_into(short, small)  # warm
    runs = []
    for rep in range(2):
        reset()
        info, wall, peak = measured(lambda: banded_into(big, host))
        c = counts()
        runs.append(peak)
        emit({"phase": "banded", "step": "decode_banded_8k", "rep": rep, "seconds": wall,
              "mp_per_s": 4 * mp / wall, "peak_card_bytes": peak, "bands": info["bands"],
              "launches": c})
        check(info["bands"] == 17 and c == {"decode_ac_sections": 17, "epf_gab": 17},
              f"decode_banded at 8K: {info}, launches {c}")
    out["decode_banded_8k"] = c
    banded_peak = min(runs)
    whole_peaks = []
    for rep in range(2):
        img, wall, peak = measured(lambda: jxl_tpu_torch.decode_image(big))
        whole_peaks.append(peak)
        emit({"phase": "banded", "step": "decode_image_8k", "rep": rep, "seconds": wall,
              "mp_per_s": 4 * mp / wall, "peak_card_bytes": peak,
              "host_parse_entropy_s": img.timings["host_s"]})
    rep = _diff_report(host.to("cuda"), img.frames[0])
    emit({"phase": "banded", "step": "decode_banded_8k", "vs_decode_image": rep})
    _check_same(rep, "f32", "decode_banded at 8K against decode_image")
    del img
    _, wall, short_peak = measured(lambda: banded_into(short, small))
    emit({"phase": "banded", "step": "decode_banded_7680x1088", "seconds": wall,
          "peak_card_bytes": short_peak})
    ratio = banded_peak / min(whole_peaks)
    growth = banded_peak / short_peak
    emit({"phase": "banded", "step": "peaks", "decode_banded_8k": banded_peak,
          "decode_image_8k": min(whole_peaks), "decode_banded_7680x1088": short_peak,
          "banded_over_whole": ratio, "8k_over_1088": growth})
    check(ratio <= 0.25, f"decode_banded's peak is {ratio:.3f} of decode_image's")
    check(growth <= 1.25, f"decode_banded's peak grows {growth:.3f}x from 1088 to 4320 rows")
    del host, small

    # (c) the other band types
    per_stream = {}
    for name, data, (w, h), channels, expect in streams:
        got = []
        reset()
        info, wall, peak = measured(lambda: jxl_tpu_torch.decode_banded(
            data, lambda y0, band: got.append(band)))
        c = counts()
        img, wall_whole, peak_whole = measured(lambda: jxl_tpu_torch.decode_image(data))
        band = torch.cat(got)
        check(tuple(band.shape) == (h, w, channels), f"{name}: bad shape {tuple(band.shape)}")
        check(bool(torch.isfinite(band).all()), f"{name}: non-finite output")
        rep = _diff_report(band, img.frames[0])
        per_stream[name] = c
        emit({"phase": "banded", "step": "band_types", "stream": name, "bands": info["bands"],
              "seconds": wall, "peak_card_bytes": peak, "decode_image_seconds": wall_whole,
              "decode_image_peak_card_bytes": peak_whole, "launches": c, "expected": expect,
              "vs_decode_image": rep})
        check(c == expect, f"{name}: launches {c}, expected {expect}")
        _check_same(rep, "f32", f"{name} decode_banded against decode_image")
    out["decode_banded_types"] = per_stream
    out["ans_decode_batch"] = AL.ans_decode_batch.launches
    return out


def lossless_stream():
    """The lossless phase's 3840x2160 lane stream
    (tests/test_torch_streams.py, predictors=): Gradient leaves for Y and X,
    West for B, offset 0 and multiplier 1, default filters; 135 groups, so
    270 gradient lanes and 135 West lanes."""
    from test_torch_streams import GRADIENT, WEST, encode_xyb_modular

    return encode_xyb_modular(WIDTH, HEIGHT, seed=21, predictors=(GRADIENT, GRADIENT, WEST),
                              oracle=False)[0]


# dependent integer operations on a gradient sample's chain (compare,
# select, add, the next diagonal's load) and cycles each (Hopper's int32
# latency), at the SM clock SPIN_CYCLES_PER_S
K4_CHAIN_OPS = 4
K4_CYCLES_PER_OP = 4
# integer operations a gradient sample, as csrc/lossless_lanes.cu counts
# them: index, load, min, max, two compares, selects, add, two stores
K4_OPS_PER_SAMPLE = 12


# K4's edge cases, as tests/test_torch_device_lossless.py's K4_EDGE_SETS:
# heights about a strip (32 rows), widths of 1, 2 and 2048, a lane taller
# than a block's eight strips; each set but the last after a 1x1 lane, so
# that its lanes start at odd offsets of the packed buffer (K4's scalar path)
K4_EDGE_SETS = {
    "h_w1": [(1, 1), (1, 1), (31, 1), (32, 1), (33, 1), (257, 1)],
    "h_w2": [(1, 1), (1, 2), (31, 2), (32, 2), (33, 2), (257, 2)],
    "h_w2048": [(1, 1), (1, 2048), (31, 2048), (32, 2048), (33, 2048), (257, 2048)],
    "tall_2048x64": [(1, 1), (2048, 64)],
    "mixed": [(1, 1), (3, 5), (33, 31), (31, 33), (1, 7), (257, 40), (32, 32)],
    # every lane's rows on 16 bytes (widths of 8, sizes of 8): K4's vector path
    "aligned": [(33, 64), (31, 32), (257, 40), (1, 8), (17, 8), (32, 2048), (2048, 64)],
}


def _k4_bounds(dims, wire_bytes: int) -> dict:
    """bound_ms (the larger of the bytes, each residual read once and each
    sample written once, over HBM_BYTES_PER_S, and the integer operations
    over INT32_OPS_PER_S) and chain_bound_ms (the longest lane's h + w - 1
    dependent diagonals at K4_CHAIN_OPS dependent operations a diagonal)."""
    n = sum(h * w for h, w in dims)
    t_bytes = n * (wire_bytes + 4) / HBM_BYTES_PER_S
    t_ops = n * K4_OPS_PER_SAMPLE / INT32_OPS_PER_S
    d = max(h + w - 1 for h, w in dims)
    return {"samples": n, "diagonals": d, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "chain_bound_ms": d * K4_CHAIN_OPS * K4_CYCLES_PER_OP / SPIN_CYCLES_PER_S * 1e3}


def phase_lossless(data) -> dict:
    """The lossless Modular lanes (modular/device_lossless.py) on the card.
    (a) decode_image of the 4K lane stream with JXL_TPU_DEV_LOSSLESS=1 and
    =0, u8 and f32, 5 reps each in turns: walls, host_s, peak card memory,
    K4, cumsum and K1 launches a decode, the bytes uploaded and copied back
    (trace metrics), the host seconds of the lanes' steps (trace spans);
    the two routes bit for bit. (b) a 520x300 lane stream with the
    writer's planes: the lanes' channels equal them. (c) K4
    against gradient_wavefront_plain on the card, bit for bit: each batch
    the 4K decode launched, the frame's 270 gradient lanes in one launch,
    a 2048x2048 lane, lanes at the overflow gate's edge (64x64 and
    2048x2048) and one past it (a wrap), and K4_EDGE_SETS in int16, int32,
    at the gate's edge and past it. (d) K4's device time on the frame's
    lanes and on each batch of the decode (device_times) beside its bounds, its
    wrapper call (once under set_sync_debug_mode("error")), its launch
    geometry, its plain version, the native host reconstruction of the
    same lanes, and the cumsum lanes' card time. (e) the auto rule these
    walls support.
    Returns K4's numbers and launches."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch import native
    from jxl_tpu_torch.modular import device_lossless as DL
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.ops import lossless_lanes as LL
    from jxl_tpu_torch.utils import trace

    mp = WIDTH * HEIGHT / 1e6
    k4 = LL.gradient_wavefront
    dispatch = DL.BatchContext._dispatch
    captured = []  # (predictor, [residual arrays as packed]) of one decode

    def capture(ctx, pred, pend):
        captured.append((pred, [v.copy() for v, _ in sorted(pend, key=lambda p: p[0].shape)]))
        return dispatch(ctx, pred, pend)

    # (a) both routes, in turns
    runs, outs = [], {}
    trace.enable()
    k4.launches = 0
    K.epf_gab.launches = 0
    try:
        for rep in range(5):
            for fmt in ("u8", "f32"):
                for mode in ("1", "0"):
                    os.environ["JXL_TPU_DEV_LOSSLESS"] = mode
                    trace.reset()
                    first = rep == 0 and fmt == "u8" and mode == "1"
                    if first:  # the residuals of one decode's dispatches, for (c) and (d)
                        DL.BatchContext._dispatch = capture
                    k4_before, k1_before = k4.launches, K.epf_gab.launches
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    try:
                        img = jxl_tpu_torch.decode_image(data, pixel_format=fmt)
                        torch.cuda.synchronize()
                    finally:
                        DL.BatchContext._dispatch = dispatch
                    wall = time.perf_counter() - t0
                    m = trace.metrics
                    rec = {"phase": "lossless", "lanes": mode, "format": fmt, "rep": rep,
                           "megapixels": mp, "seconds": wall, "mp_per_s": mp / wall,
                           "host_s": img.timings["host_s"],
                           "peak_card_mb": (torch.cuda.max_memory_allocated() - base) / 1e6,
                           "k4_launches": k4.launches - k4_before,
                           "epf_gab_launches": K.epf_gab.launches - k1_before,
                           "cumsum_calls": int(m.get("lossless_cumsum_calls")),
                           "device_lanes": int(m.get("lossless_device_lanes")),
                           "host_lanes": int(m.get("lossless_host_lanes")),
                           "upload_bytes": int(m.get("lossless_upload_bytes")),
                           "download_bytes": int(m.get("lossless_download_bytes")),
                           # host seconds of the lanes' steps, summed over
                           # the section decode's worker threads
                           "lane_steps_s": {k: v for k, v in trace.host_seconds().items()
                                            if k.startswith("lossless.")}}
                    emit(rec)
                    runs.append(rec)
                    outs.setdefault((fmt, mode), img.frames[0])
    finally:
        trace.enable(False)
        os.environ.pop("JXL_TPU_DEV_LOSSLESS", None)
    launches = {"gradient_wavefront": k4.launches, "epf_gab": K.epf_gab.launches}
    lane_runs = [r for r in runs if r["lanes"] == "1"]
    host_runs = [r for r in runs if r["lanes"] == "0"]
    check(all(r["k4_launches"] > 0 and r["cumsum_calls"] > 0 and r["device_lanes"] == 405
              for r in lane_runs), "the lanes decode did not launch K4 and the cumsums "
          "over the frame's 405 lanes")
    check(all(r["k4_launches"] == 0 and r["device_lanes"] == 0 for r in host_runs),
          "the host decode took the lanes")
    check(all(r["epf_gab_launches"] == 1 for r in runs), "the lossless decodes did not launch K1")
    for fmt in ("u8", "f32"):
        a, b = outs[(fmt, "1")], outs[(fmt, "0")]
        check(tuple(a.shape) == (HEIGHT, WIDTH, 3) and a.device.type == "cuda",
              f"bad lossless frame {tuple(a.shape)} on {a.device}")
        check(bool(torch.isfinite(a.float()).all()), "non-finite output")
        rep = _diff_report(a, b)
        emit({"phase": "lossless", "format": fmt, "lanes_against_host": rep})
        check(rep["bit_for_bit"], f"the lanes decode {fmt} differs from the host decode: {rep}")

    # (b) a small lane stream's channels against the writer's planes
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from test_torch_streams import GRADIENT, NORTH, WEST, encode_xyb_modular

    small, planes = encode_xyb_modular(520, 300, seed=22, predictors=(GRADIENT, WEST, NORTH))
    os.environ["JXL_TPU_DEV_LOSSLESS"] = "1"
    try:
        br = BitReader(small)
        fh = FileHeader.read(br)
        br.jump_to_byte_boundary()
        frame = parse_frame(br, fh)
        before = k4.launches
        frame.decode_all_sections(br, "cuda")
        same = all(np.array_equal(frame.modular_channel(c), planes[c]) for c in range(3))
    finally:
        os.environ.pop("JXL_TPU_DEV_LOSSLESS", None)
    emit({"phase": "lossless", "stream": "520x300", "channels_equal_writer": same,
          "k4_launches": k4.launches - before})
    check(same and k4.launches > before, "the 520x300 lane stream's channels differ from the "
          "writer's planes, or K4 did not run")

    # (c) K4 against its plain version, on the decode's batches packed as
    # the dispatches pack them (int16: the stream's residuals fit)
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)

    def packed(lanes):
        return (torch.from_numpy(np.concatenate([x.reshape(-1) for x in lanes]).astype(np.int16)),
                [x.shape for x in lanes])

    batches = [packed(lanes) for pred, lanes in captured if pred == DL._PRED_GRADIENT]
    west = [lanes for pred, lanes in captured if pred == DL._PRED_WEST]
    check(len(batches) == lane_runs[0]["k4_launches"] and west,
          f"captured {len(batches)} K4 batches and {len(west)} West dispatches")
    frame_res, frame_dims = packed([x for pred, lanes in captured
                                    if pred == DL._PRED_GRADIENT for x in lanes])
    lim64 = (1 << 31) // (3 * (64 + 64 - 1)) - 1
    lim2k = (1 << 31) // (3 * (2048 + 2048 - 1)) - 1
    cases = [(f"decode_batch_{i}", r, dims) for i, (r, dims) in enumerate(batches)]
    cases += [
        ("frame_270_lanes", frame_res, frame_dims),
        ("lane_2048", torch.from_numpy(rng.integers(-255, 256, 2048 * 2048).astype(np.int16)),
         [(2048, 2048)]),
        ("gate_edge_64", torch.from_numpy(rng.choice([-lim64, lim64], 64 * 64).astype(np.int32)),
         [(64, 64)]),
        ("gate_edge_2048",
         torch.from_numpy(rng.choice([-lim2k, lim2k], 2048 * 2048).astype(np.int32)),
         [(2048, 2048)]),
        ("past_gate_256", torch.from_numpy(rng.integers(-(1 << 26), 1 << 26, 256 * 256)
                                           .astype(np.int32)), [(256, 256)]),
    ]
    for name, dims in K4_EDGE_SETS.items():
        n = sum(h * w for h, w in dims)
        lim = (1 << 31) // (3 * max(h + w - 1 for h, w in dims)) - 1
        cases += [
            (f"edge_{name}_int16", torch.from_numpy(rng.integers(-2000, 2000, n).astype(np.int16)),
             dims),
            (f"edge_{name}_int32",
             torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)), dims),
            (f"edge_{name}_gate", torch.from_numpy(rng.choice([-lim, lim], n).astype(np.int32)),
             dims),
            (f"edge_{name}_wrap",
             torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)), dims)]
    check(len(frame_dims) == 270, f"the 4K decode gave K4 {len(frame_dims)} lanes, not 270")
    max_err = 0
    for name, res, dims in cases:
        res = res.to(dev)
        got = LL.gradient_wavefront(res, dims)
        want = LL.gradient_wavefront_plain(res, dims)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        emit({"phase": "lossless", "k4_case": name, "lanes": len(dims),
              "dtype": str(res.dtype).split(".")[-1], "bit_for_bit": bool(torch.equal(got, want)),
              "max_abs_diff": err})
        check(torch.equal(got, want), f"K4 differs from its plain version on {name}")

    # (d) times: K4 on the frame's lanes, its wrapper, the plain version,
    # the native host loop on the same lanes, the cumsum lanes
    fres = frame_res.to(dev)
    fn = lambda: LL.gradient_wavefront(fres, frame_dims)  # noqa: E731
    timed = device_times([("frame", fn, LL.load(), "gradient_wavefront_launch")]
                         + [(f"batch_{i}", lambda r=r.to(dev), d=d: LL.gradient_wavefront(r, d),
                             LL.load(), "gradient_wavefront_launch")
                            for i, (r, d) in enumerate(batches)])
    call_ms = time_ms(fn)
    # the wrapper queues its launch without a wait: no sync in a call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain_ms = time_ms(lambda: LL.gradient_wavefront_plain(fres, frame_dims), reps=3, warmup=1)
    # the launch's geometry, as the card has it
    k4_plan = LL.plan(frame_res.element_size(), max(w for _, w in frame_dims))
    check(all(k4_plan[k] == v for k, v in LL.GEOMETRY.items()),
          f"K4's plan {k4_plan} differs from ops/lossless_lanes.py's GEOMETRY {LL.GEOMETRY}")
    emit({"phase": "lossless", "k4_plan": k4_plan})
    batch_recs = []
    for i, (r, d) in enumerate(batches):
        rd = r.to(dev)
        b = _k4_bounds(d, r.element_size())
        rec = {"lanes": len(d), "ms": timed[f"batch_{i}"],
               "call_ms": time_ms(lambda rd=rd, d=d: LL.gradient_wavefront(rd, d)),
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
               "chain_bound_ms": b["chain_bound_ms"]}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["share_of_chain_bound"] = rec["chain_bound_ms"] / rec["ms"]
        batch_recs.append(rec)
    host = frame_res.to(torch.int32).numpy()
    host_ms = []
    for _ in range(3):
        pos, lanes = 0, []
        for h, w in frame_dims:
            lanes.append(host[pos : pos + h * w].reshape(h, w).copy())
            pos += h * w
        t0 = time.perf_counter()
        for x in lanes:
            native.gradient_reconstruct(x)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    # the West lanes as the dispatch runs them: one cumsum a shape
    shapes = {}
    for lanes in west:
        for x in lanes:
            shapes.setdefault(x.shape, []).append(x)
    cumsum_in = [torch.from_numpy(np.stack(xs).astype(np.int16)).to(dev) for xs in shapes.values()]
    cumsum_ms = sum(time_ms(lambda r=r: LL.cumsum_west(r), reps=5) for r in cumsum_in)
    bounds = _k4_bounds(frame_dims, frame_res.element_size())
    k4_rec = {"ms": timed["frame"], "call_ms": call_ms, "plain_ms": plain_ms,
              "host_native_ms": sorted(host_ms)[1],
              "ms_decode_batches": sum(timed[f"batch_{i}"] for i in range(len(batches))),
              "decode_batches": [len(d) for _, d in batches], "batches": batch_recs,
              "plan": k4_plan,
              "cumsum_west_ms": cumsum_ms, "cumsum_west_calls": len(cumsum_in),
              **bounds, "max_abs_err": max_err}
    k4_rec["share_of_bound"] = k4_rec["bound_ms"] / k4_rec["ms"]
    k4_rec["share_of_chain_bound"] = k4_rec["chain_bound_ms"] / k4_rec["ms"]
    emit({"phase": "lossless", "k4": k4_rec})

    # (e) the auto rule the walls support
    med = {}
    for mode in ("1", "0"):
        for fmt in ("u8", "f32"):
            ws = sorted(r["seconds"] for r in runs if r["lanes"] == mode and r["format"] == fmt)
            med[(mode, fmt)] = ws[len(ws) // 2]
    lanes_win = all(med[("1", f)] < med[("0", f)] for f in ("u8", "f32"))
    emit({"phase": "lossless", "median_s": {f"lanes={m} {f}": v for (m, f), v in med.items()},
          "lanes_win_at_4k": lanes_win, "auto_takes_the_lanes": DL.enabled("cuda")})
    per_decode = [r["k4_launches"] for r in lane_runs]
    # the frame's lanes as the decode packed them, for the sharded phase
    west_lanes = [x for lanes in west for x in sorted(lanes, key=lambda x: x.shape)]
    frame_lanes = {
        "gradient": (DL._PRED_GRADIENT, frame_res.numpy(), [tuple(d) for d in frame_dims]),
        "west": (DL._PRED_WEST, np.concatenate([x.reshape(-1) for x in west_lanes])
                 .astype(np.int16), [x.shape for x in west_lanes])}
    return {"k4": k4_rec, "launches": launches, "k4_launches_per_decode": per_decode[0],
            "frame_lanes": frame_lanes}


# -- the sharded phase: multi-process decode on torch.distributed -------------

SHARD_REPS = 3
SHARD_SEED = 31


def sharded_streams(vdata, lossless_lanes) -> dict:
    """The sharded phase's inputs, made once in the parent and passed to
    every rank: the 4K VarDCT stream (135 groups), the 7680x4320 panorama
    of the banded phase (510 groups), an 8-frame 1920x1080 XYB VarDCT
    animation whose frames stand alone (a full frame, then 960x544 crops
    across the canvas, one at a negative x0 and one at a negative y0,
    every frame REPLACE, none saved), and the lossless phase's 270
    gradient and 135 West lanes (packed as the decode packs them)."""
    from test_torch_frame_streams import anim_crop_replace_stream
    from test_torch_vardct_streams import encode_xyb_vardct

    return {
        "vardct_4k": vdata,
        "vardct_8k": encode_xyb_vardct(7680, 4320, seed=17)[0],
        "anim_1080p": anim_crop_replace_stream(WIDTH // 2, HEIGHT // 2, (960, 544), num_frames=8,
                                               seed=7),
        "lanes": lossless_lanes,
        "planes_hw": (HEIGHT, WIDTH),
    }


def _shard_planes(seed: int, h: int, w: int):
    """Seeded XYB-range planes (3, h, w), their 1/sigma blocks (with
    passthrough blocks) and the blocks expanded to one value a pixel: the
    filters' and the synthetic render's input (4K), made alike on every
    rank."""
    import numpy as np

    rng = np.random.default_rng(seed)
    planes = np.stack([rng.uniform(-0.02, 0.02, (h, w)), rng.uniform(0.0, 0.8, (h, w)),
                       rng.uniform(0.0, 0.8, (h, w))]).astype(np.float32)
    sigma = rng.uniform(0.05, 0.6, (h // 8, w // 8)).astype(np.float32)
    sigma[::7, ::5] = 0.0
    return planes, sigma, np.repeat(np.repeat(sigma, 8, 0), 8, 1)


def _sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU, where the phase
    is rehearsed)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _frame_header_of(data):
    """The port's parsed frame of a one-frame stream, headers only."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    return parse_frame(br, fh)


def _shard_cases(world, inp) -> list:
    """[(case, function of no arguments returning this rank's whole
    output)] of the sharded phase on `world`'s ranks: each output is the
    whole image (frames, samples) every rank ends with."""
    import torch

    from jxl_tpu_torch.modular.device_lossless import split_lanes
    from jxl_tpu_torch.ops.device_render import RenderParams
    from jxl_tpu_torch.parallel import multihost
    from jxl_tpu_torch.parallel import sharded_render as SR

    g1, g2 = SR.make_grid(world), SR.make_grid_2d(world)
    dev = world.device
    rows, cols = inp["planes_hw"]
    planes, sigma, sigma_px = _shard_planes(SHARD_SEED, rows, cols)
    a, b = SR.row_spans(rows, g1.ny)[g1.sy]
    p = torch.from_numpy(planes[:, a:b]).to(dev)
    s_px = torch.from_numpy(sigma_px[a:b]).to(dev)
    s_blk = torch.from_numpy(sigma[a // 8 : -(-b // 8)]).to(dev)
    frame = _frame_header_of(inp["vardct_4k"])
    cases = []
    for fmt in ("u8", "f32"):
        cases.append((f"vardct_4k_{fmt}", lambda fmt=fmt: SR.decode_sharded(
            inp["vardct_4k"], g2, fmt)))
    if world.size in (1, 4):
        for fmt in ("u8", "f32"):
            cases.append((f"vardct_8k_{fmt}", lambda fmt=fmt: SR.decode_sharded(
                inp["vardct_8k"], g2, fmt)))
    for fmt in ("u8", "f32"):
        cases.append((f"filters_4k_{fmt}", lambda fmt=fmt: SR.gather_rows(
            g1, SR.sharded_filters_and_color(g1, frame, p, s_px, rows, fmt))))
    cases.append(("render_4k", lambda: SR.gather_rows(
        g1, SR.sharded_render(g1, RenderParams(), p, s_blk, rows))))
    for name, (pred, res, dims) in inp["lanes"].items():
        r = torch.from_numpy(res)
        cases.append((f"lanes_{name}", lambda pred=pred, r=r, dims=dims: split_lanes(
            world, pred, r, dims)))
    for fmt in ("u8", "f32"):
        cases.append((f"anim_1080p_{fmt}", lambda fmt=fmt: torch.stack(
            multihost.decode_animation_multihost(inp["anim_1080p"], world, fmt))))
    return cases


def shard_references(inp, refdir, dev="cuda") -> dict:
    """Each case's one-process counterpart on the card, saved under
    refdir/one: decode_image's frame or frames, run_filters' K1 then the
    colour and the conversion, render_block of the whole image, the lanes
    in one reconstruct_lanes. Returns {case: seconds of one call}."""
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.modular.device_lossless import reconstruct_lanes
    from jxl_tpu_torch.ops.device_render import RenderParams, render_block
    from jxl_tpu_torch.render.device_band_filters import color_and_convert
    from jxl_tpu_torch.render.device_filters import filter_planes

    dev = torch.device(dev)
    planes, sigma, sigma_px = _shard_planes(SHARD_SEED, *inp["planes_hw"])
    p, s_px = torch.from_numpy(planes).to(dev), torch.from_numpy(sigma_px).to(dev)
    frame = _frame_header_of(inp["vardct_4k"])
    jobs = []
    for fmt in ("u8", "f32"):
        for size in ("4k", "8k"):
            jobs.append((f"vardct_{size}_{fmt}", lambda size=size, fmt=fmt: jxl_tpu_torch.
                         decode_image(inp[f"vardct_{size}"], pixel_format=fmt,
                                      device=dev).frames[0]))
        jobs.append((f"filters_4k_{fmt}", lambda fmt=fmt: torch.stack(color_and_convert(
            frame, filter_planes(frame, p, s_px).unbind(0), 0, fmt))))
        jobs.append((f"anim_1080p_{fmt}", lambda fmt=fmt: torch.stack(jxl_tpu_torch.decode_image(
            inp["anim_1080p"], pixel_format=fmt, device=dev).frames)))
    jobs.append(("render_4k", lambda: render_block(p, torch.from_numpy(sigma).to(dev),
                                                   RenderParams())))
    for name, (pred, res, dims) in inp["lanes"].items():
        jobs.append((f"lanes_{name}", lambda pred=pred, res=res, dims=dims: reconstruct_lanes(
            pred, torch.from_numpy(res).to(dev), dims)))
    os.makedirs(os.path.join(refdir, "one"), exist_ok=True)
    secs = {}
    for name, fn in jobs:
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        secs[name] = time.perf_counter() - t0
        torch.save(out.cpu(), os.path.join(refdir, "one", f"{name}.pt"))
        del out
    return secs


def _shard_rank(world, inp, refdir, reps) -> dict:
    """One rank of a sharded world on the card: every case of _shard_cases
    `reps` times, each rep after a barrier, with its wall (ending in a
    synchronise), the exchange's bytes and seconds, K1, K3 and K4
    launches and the peak card memory above what the rank held before;
    then the last rep's output against the one-process counterpart and,
    but in world 1, world 1's output (refdir/one, refdir/world1: bit for
    bit, max abs difference), and a hash of it. World 1 saves its outputs
    under refdir/world1."""
    import hashlib

    import torch
    import torch.distributed as dist

    from jxl_tpu_torch.ops import device_ac, epf_gab, lossless_lanes

    kernels = {"epf_gab": epf_gab.epf_gab, "decode_ac_sections": device_ac.decode_ac_sections,
               "gradient_wavefront": lossless_lanes.gradient_wavefront}
    for k in kernels.values():
        k.launches = 0
    dev = world.device
    card = dev.type == "cuda"
    out = {"rank": world.rank, "size": world.size, "backend": world.backend,
           "device": str(dev), "staged_through_host": world.staged, "cases": {}}
    for name, fn in _shard_cases(world, inp):
        reps_out, res = [], None
        for _ in range(reps):
            dist.barrier()
            before = {k: f.launches for k, f in kernels.items()}
            world.exchange_bytes, world.exchange_s = 0, 0.0
            _sync(dev)
            if card:
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if card else 0
            t0 = time.perf_counter()
            res = fn()
            _sync(dev)
            reps_out.append({
                "seconds": time.perf_counter() - t0,
                "exchange_bytes": world.exchange_bytes, "exchange_s": world.exchange_s,
                "peak_card_mb": (torch.cuda.max_memory_allocated() - base) / 1e6 if card else None,
                "launches": {k: f.launches - before[k] for k, f in kernels.items()}})
        rec = {"reps": reps_out,
               "sha256": hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16],
               "shape": list(res.shape), "dtype": str(res.dtype).split(".")[-1]}
        for ref in ("one", "world1"):
            path = os.path.join(refdir, ref, f"{name}.pt")
            if world.size > 1 or ref == "one":
                want = torch.load(path).to(world.device)
                rec[f"against_{ref}"] = _diff_report(res, want) if res.shape == want.shape \
                    else {"bit_for_bit": False, "shape": list(want.shape)}
                del want
        if world.size == 1:
            os.makedirs(os.path.join(refdir, "world1"), exist_ok=True)
            torch.save(res.cpu(), os.path.join(refdir, "world1", f"{name}.pt"))
        out["cases"][name] = rec
        del res
        if card:
            torch.cuda.empty_cache()
    out["launches"] = {k: f.launches for k, f in kernels.items()}
    return out


def _nccl_two_ranks(world) -> str:
    """A two-rank all_gather (the NCCL probe's rank function)."""
    import torch

    return str(world.all_gather(torch.ones(4, device=world.device))[1].sum().item())


def _nccl_probe() -> dict:
    """Two NCCL ranks of one communicator on the one card: NCCL refuses
    them (a duplicate GPU); the message is what the phase records."""
    import tempfile

    from jxl_tpu_torch import parallel as P

    probe = {"world_size": 2, "backend": "nccl", "device": "cuda:0 for both ranks"}
    debug = os.environ.get("NCCL_DEBUG")
    os.environ["NCCL_DEBUG"] = "WARN"  # NCCL then keeps the reason for "Last error"
    with tempfile.TemporaryDirectory() as d:
        try:
            probe["result"] = P.run_local_world(_nccl_two_ranks, 2, os.path.join(d, "store"),
                                                backend="nccl", device="cuda", timeout=120)
            probe["refused"] = False
        except RuntimeError as e:
            lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
            first = next((i for i, ln in enumerate(lines) if "DistBackendError" in ln
                          or "NCCL error" in ln), max(len(lines) - 4, 0))
            probe["refused"] = True
            probe["message"] = lines[first : first + 4]
        finally:
            if debug is None:
                os.environ.pop("NCCL_DEBUG")
            else:
                os.environ["NCCL_DEBUG"] = debug
    return probe


def phase_sharded(inp, device="cuda") -> dict:
    """The multi-process decode (parallel/sharded_render.py, the lanes
    split of modular/device_lossless.py, parallel/multihost.py) on the
    card: world 1 in this process on NCCL, then worlds 2 and 4 as spawned
    processes sharing the one card over gloo (each message staged through
    a page-locked host buffer), every world running every case of
    _shard_cases (the 8K frame on worlds 1 and 4) SHARD_REPS times; each
    case's output on every rank against its one-process counterpart and
    world 1's, bit for bit, with walls (the slowest rank a rep), exchange
    bytes and seconds, K1, K3 and K4 launches and the peak card memory a
    rank. Then two NCCL ranks on the one card, whose refusal is recorded.
    Returns the launches on the sharded path (every rank, every rep)."""
    import shutil
    import tempfile

    import torch

    from jxl_tpu_torch import parallel as P

    card = torch.device(device).type == "cuda"
    one_backend = "nccl" if card else "gloo"
    refdir = tempfile.mkdtemp(prefix="jxl_sharded_")
    worlds = {}
    try:
        ref_s = shard_references(inp, refdir, device)
        emit({"phase": "sharded", "step": "one_process_references", "seconds": ref_s})
        if card:
            torch.cuda.empty_cache()
        world = P.init_distributed("file://" + os.path.join(refdir, "store1"), 1, 0,
                                   backend=one_backend, device=device)
        try:
            worlds[1] = [_shard_rank(world, inp, refdir, SHARD_REPS)]
        finally:
            torch.distributed.destroy_process_group()
        if card:
            torch.cuda.empty_cache()
        for n in (2, 4):
            t0 = time.perf_counter()
            worlds[n] = P.run_local_world(_shard_rank, n, os.path.join(refdir, f"store{n}"),
                                          (inp, refdir, SHARD_REPS), backend="gloo",
                                          device=device, timeout=600)
            emit({"phase": "sharded", "step": f"world_{n}", "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(refdir, ignore_errors=True)
    if card:
        emit({"phase": "sharded", "nccl_two_ranks_one_card": _nccl_probe()})
    totals = {"epf_gab": 0, "decode_ac_sections": 0, "gradient_wavefront": 0}
    for n, ranks in worlds.items():
        for name in ranks[0]["cases"]:
            recs = [r["cases"][name] for r in ranks]
            walls = sorted(max(r["reps"][i]["seconds"] for r in recs) for i in range(SHARD_REPS))
            rec = {"phase": "sharded", "world": n, "case": name,
                   "backend": ranks[0]["backend"], "staged_through_host": ranks[0][
                       "staged_through_host"],
                   "wall_s_median": walls[len(walls) // 2], "wall_s": walls,
                   "ranks_hold_the_same_output": len({r["sha256"] for r in recs}) == 1,
                   "shape": recs[0]["shape"], "dtype": recs[0]["dtype"],
                   "per_rank": [{
                       "rank": r["rank"],
                       "exchange_bytes": c["reps"][-1]["exchange_bytes"],
                       "exchange_s": [x["exchange_s"] for x in c["reps"]],
                       "peak_card_mb": max((x["peak_card_mb"] or 0) for x in c["reps"]),
                       "launches": c["reps"][-1]["launches"]}
                       for r, c in zip(ranks, recs)]}
            for ref in ("one", "world1"):
                if f"against_{ref}" in recs[0]:
                    rec[f"against_{ref}"] = [c[f"against_{ref}"] for c in recs]
            emit(rec)
            check(rec["ranks_hold_the_same_output"], f"world {n} {name}: ranks differ")
            for ref in ("one", "world1"):
                for rep in rec.get(f"against_{ref}", []):
                    check(rep["bit_for_bit"], f"world {n} {name} differs from {ref}: {rep}")
        for r in ranks:
            check(r["backend"] == (one_backend if n == 1 else "gloo"),
                  f"world {n} ran {r['backend']}")
            for k in totals:
                totals[k] += r["launches"][k]
        lanes = [r["cases"]["lanes_gradient"]["reps"][-1]["launches"]["gradient_wavefront"]
                 for r in ranks]
        frames = [r["cases"]["vardct_4k_u8"]["reps"][-1]["launches"] for r in ranks]
        check(all(x == 1 for x in lanes), f"world {n}: K4 launches a rank {lanes}")
        check(all(f["epf_gab"] == 1 and f["decode_ac_sections"] == 1 for f in frames),
              f"world {n}: K1/K3 launches a rank of the 4K frame {frames}")
    return totals


def phase_profile(data, stream: str, expect: str) -> None:
    """One u8 decode under torch.profiler: device time by operation, and
    the share of the decode's wall time the card was busy. A trace that
    lost the kernel `expect` (CUPTI may drop a buffer) is taken again,
    once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import jxl_tpu_torch

    jxl_tpu_torch.decode_image(data, pixel_format="u8")  # warm
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            img = jxl_tpu_torch.decode_image(data, pixel_format="u8")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels and copies as the card ran them (the operators that
        # launched them would count the same time again); CUPTI's own buffer
        # request is the profiler's cost, not the decode's
        ops = sorted(((ev.key, ev.device_time_total, ev.count) for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and ev.key != "Activity Buffer Request"),
                     key=lambda t: -t[1])
        if any(expect in k for k, _, _ in ops):
            break
    busy_ms = sum(t[1] for t in ops) / 1e3
    emit({"phase": "profile", "stream": stream, "format": "u8", "wall_ms": wall * 1e3,
          "host_parse_entropy_ms": img.timings["host_s"] * 1e3, "attempts": attempt + 1,
          "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": n} for k, us, n in ops[:10]]})


def batched_anim_streams():
    """[(name, codestream, (width, height), frames, expected launches a
    decode by route)] of the batched_anim phase
    (tests/test_torch_frame_streams.py): anim48_512, 48 full REPLACE
    frames at batchable's 512x512 limit (4 groups a frame, 7 TOC entries,
    so the fold declines it); anim48_256, 48 single-section 256x256 frames
    (the fold's case); crop16_512, 16 frames of which 15 are 448x320
    crops at offsets across the canvas, negative ones among them. Routes:
    JXL_TPU_BATCH_ANIM "off" (the per-frame loop: K3 a multi-section
    frame, none for a single-section one, whose AC it decodes on the
    host), "1" (the batched render, K3 once over every frame's lanes) and
    "0" (the fold where it takes the stream, else as "1"); K1 once a
    frame on every route."""
    from test_torch_frame_streams import anim_crop_replace_stream, anim_replace_stream

    def launches(k3_off, k3_1, k3_0, n):
        return {r: {"decode_ac_sections": k3, "epf_gab": n}
                for r, k3 in (("off", k3_off), ("1", k3_1), ("0", k3_0))}

    return [
        ("anim48_512", anim_replace_stream(512, 512, 48, seed=31), (512, 512), 48,
         launches(48, 1, 1, 48)),
        ("anim48_256", anim_replace_stream(256, 256, 48, seed=32), (256, 256), 48,
         launches(0, 1, 0, 48)),
        ("crop16_512", anim_crop_replace_stream(512, 512, (448, 320), 16, seed=33),
         (512, 512), 16, launches(16, 1, 1, 16)),
    ]


def _batched_lane_inputs(data, frames=None):
    """K3's inputs over every frame's lanes of an animation, merged into
    one launch as render/batch_anim.py:decode_sections launches them (or
    over the first `frames` frames)."""
    from jxl_tpu_torch.api.frame import Frame
    from jxl_tpu_torch.api.simple import scan_frames
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.vardct import device_group

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    recs = scan_frames(data, br.pos, fh)[:frames]
    parts, slot = [], 0
    for header, toc, pos in recs:
        frame = Frame(header, toc, fh, None)
        br.pos = pos
        parts.append((device_group.lane_inputs(frame, frame.decode_vardct_head(br)), slot))
        slot += header.num_groups
    return device_group.merge_lane_inputs(parts, slot)


def _k3_at(inp, dev):
    """K3 over lane inputs `inp` on the card with its tables packed on the
    host, as run_lanes passes them: (coefficients, ok, device ms, call ms,
    the shared-memory plan)."""
    import numpy as np
    import torch

    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS

    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in inp.items() if k not in LANE_KEYWORDS}
    kw = {k: inp[k] for k in LANE_KEYWORDS}
    b, c = device_ac.pack_tables(inp["tables"], inp["uint_cfgs"], inp["context_map"])
    packs = dict(packed_buckets=torch.from_numpy(b).to(dev),
                 packed_cfgs=torch.from_numpy(c).to(dev))

    def call():
        return device_ac.decode_ac_sections(**arrays, **kw, **packs)

    coeffs, ok = call()
    plan = device_ac.ac_smem_plan(C=inp["tables"].shape[0], NB=inp["n_buckets"],
                                  num_bctx=inp["num_bctx"], NC=len(inp["context_map"]))
    plan = {k: plan[k] for k in ("tab_shared", "ctx_slice", "smem_bytes")}
    if dev.type != "cuda":
        return coeffs, ok, None, None, plan
    ms = device_times([(0, call, AL.load(), "ac_sections_launch")], reps=5)[0]
    call_ms = time_ms(call, reps=10, warmup=2)
    return coeffs, ok, ms, call_ms, plan


def _peak_mb(fn, dev):
    """(fn(), peak card memory above what was allocated before, MB; None
    off the card)."""
    import torch

    if dev.type != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e6


def phase_batched_anim(streams, device="cuda") -> dict:
    """The batched animation route (render/batch_anim.py,
    render/anim_fold.py) against the per-frame loop on each stream of
    batched_anim_streams: the gate (routes "1" and "0" equal "off" bit
    for bit in u8 and f32, durations too); u8 walls (median of 5 after a
    warm-up) with host_s, the launches of K3 (with its lanes) and K1 a
    decode, the peak card memory, and the warm-up decode's trace spans
    (host seconds, and the card's time from CUDA events around each:
    the batched route's tables, transforms, filters and colour/output);
    K3 over anim48_512's 192 merged lanes against its plain version (on
    the host, in a worker) bit for bit and timed beside one frame's 4
    lanes; on anim48_256 the fold's
    coefficients, LF and HF metadata against the batched sections' (K3's
    buffer) bit for bit. Returns the launches of the main route ("0", the
    default) summed over the streams, and the K3 record. Rehearse it on
    the CPU with device="cpu", small streams and launches of 0 expected
    (the plain versions count none); its times are then no measurement."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.api.simple import BATCH_ANIM_DEFAULT, scan_frames
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.render.anim_fold import try_anim_fold
    from jxl_tpu_torch.render.batch_anim import decode_sections, fold_coefficients
    from jxl_tpu_torch.utils import trace
    from jxl_tpu_torch.vardct import device_group
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS, check_lane_flags

    dev = torch.device(device)
    merged = _batched_lane_inputs(streams[0][1])
    one = _batched_lane_inputs(streams[0][1], frames=1)
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    plain = pool.submit(_plain_ac_sections,
                        [np.ascontiguousarray(v) for k, v in merged.items()
                         if k not in LANE_KEYWORDS], {k: merged[k] for k in LANE_KEYWORDS})
    lanes_seen = []
    real_k3 = device_ac.decode_ac_sections
    real_run_lanes = device_group.run_lanes

    def counted(inputs, *a, **kw):  # every decode's K3 launch goes through run_lanes
        lanes_seen.append(int(inputs["streams"].shape[0]))
        return real_run_lanes(inputs, *a, **kw)

    main_launches = {"decode_ac_sections": 0, "epf_gab": 0}
    summary = {}
    old_mode = os.environ.pop("JXL_TPU_BATCH_ANIM", None)
    # the card routes: auto sends the per-frame loop's small VarDCT frames
    # to the host route (utils/devhealth.py), which the batched routes do
    # not equal bit for bit; the host_route phase measures that route
    old_device = os.environ.get("JXL_TPU_DEVICE")
    os.environ["JXL_TPU_DEVICE"] = "on"
    device_group.run_lanes = counted
    try:
        for name, data, (w, h), nframes, expect in streams:
            outs, rec = {}, {}
            for route in ("off", "1", "0"):
                os.environ["JXL_TPU_BATCH_ANIM"] = route
                k1, k3 = K.epf_gab.launches, real_k3.launches
                del lanes_seen[:]
                trace.enable(device_events=dev.type == "cuda")
                trace.reset()
                img, peak = _peak_mb(lambda: jxl_tpu_torch.decode_image(
                    data, pixel_format="u8", device=dev), dev)
                counters = {k: v for k, v in trace.metrics.counters.items()
                            if k.startswith(("batch_anim", "anim_fold"))}
                spans = {k: {"host_s": v} for k, v in trace.host_seconds().items()}
                for k, v in trace.device_ms().items():
                    spans[k]["device_span_ms"] = v
                trace.enable(False)
                launches = {"decode_ac_sections": real_k3.launches - k3,
                            "epf_gab": K.epf_gab.launches - k1}
                lanes = list(lanes_seen)
                walls, hosts = [], []
                for _ in range(5):
                    t0 = time.perf_counter()
                    img = jxl_tpu_torch.decode_image(data, pixel_format="u8", device=dev)
                    _sync(dev)
                    walls.append(time.perf_counter() - t0)
                    hosts.append(img.timings["host_s"])
                f32 = jxl_tpu_torch.decode_image(data, pixel_format="f32", device=dev)
                outs[route] = (img, f32)
                rec[route] = {"wall_s_median": float(np.median(walls)), "walls_s": walls,
                              "host_s_median": float(np.median(hosts)),
                              "mp_per_s": w * h * nframes / 1e6 / float(np.median(walls)),
                              "launches": launches, "k3_lanes_per_launch": lanes,
                              "peak_mb": peak, "trace": counters, "spans": spans}
                check(launches == expect[route],
                      f"{name} route {route}: launches {launches}, expected {expect[route]}")
                check(len(img.frames) == nframes and tuple(img.frames[0].shape) == (h, w, 3),
                      f"{name} route {route}: {len(img.frames)} frames of "
                      f"{tuple(img.frames[0].shape)}")
                if route == BATCH_ANIM_DEFAULT:
                    for k in main_launches:
                        main_launches[k] += launches[k]
            ref_u8, ref_f32 = outs["off"]
            for route in ("1", "0"):
                u8, f32 = outs[route]
                same = (u8.durations == ref_u8.durations and f32.durations == ref_f32.durations
                        and all(torch.equal(a, b) for a, b in zip(u8.frames, ref_u8.frames))
                        and all(torch.equal(a, b) for a, b in zip(f32.frames, ref_f32.frames)))
                diff = max(float((a - b).abs().max())
                           for a, b in zip(f32.frames, ref_f32.frames))
                rec[route]["bit_exact_vs_per_frame_loop"] = same
                rec[route]["f32_max_abs_diff_vs_per_frame_loop"] = diff
                check(same, f"{name}: route {route} differs from the per-frame loop ({diff})")
            check(all(np.isfinite(f.cpu().numpy()).all() for f in ref_f32.frames),
                  f"{name}: non-finite output")
            if name == "anim48_256":
                check(rec["0"]["trace"].get("batch_anim_route.fold") == 1,
                      "the fold did not take anim48_256")
            del outs
            emit({"phase": "batched_anim", "stream": name, "frames": nframes,
                  "routes": rec})
            summary[name] = {r: {k: rec[r][k] for k in ("wall_s_median", "host_s_median",
                                                        "launches", "peak_mb")}
                             for r in rec}
    finally:
        device_group.run_lanes = real_run_lanes
        os.environ.pop("JXL_TPU_BATCH_ANIM", None)
        if old_mode is not None:
            os.environ["JXL_TPU_BATCH_ANIM"] = old_mode
        os.environ.pop("JXL_TPU_DEVICE", None)
        if old_device is not None:
            os.environ["JXL_TPU_DEVICE"] = old_device

    # the fold against K3's batched sections on the fold's stream
    data = streams[1][1]
    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    recs = scan_frames(data, br.pos, fh)
    folded = try_anim_fold(fh, data, recs, None, dev)
    check(folded is not None, "the fold declined anim48_256")
    flat_fold, _ = fold_coefficients(folded, dev)
    frames, flat, _, oks = decode_sections(fh, data, recs, None, dev)
    check_lane_flags(oks)
    same_coeffs = torch.equal(flat_fold, flat)
    same_lf = all(np.array_equal(a, b) for fa, fb in zip(folded, frames)
                  for a, b in zip(fa.lf_image, fb.lf_image))
    same_meta = all(np.array_equal(fa.hf_meta[k], fb.hf_meta[k])
                    for fa, fb in zip(folded, frames)
                    for k in ("transform", "raw_quant", "quant_lf", "epf", "ytox", "ytob"))
    emit({"phase": "batched_anim", "stream": "anim48_256", "fold_vs_k3_sections": {
        "coefficients_bit_exact": same_coeffs, "lf_bit_exact": same_lf,
        "hf_metadata_bit_exact": same_meta}})
    check(same_coeffs and same_lf and same_meta,
          "the fold's coefficients, LF or HF metadata differ from the sections'")

    # K3 at the batched route's shape against its plain version
    got_c, got_ok, ms, call_ms, plan = _k3_at(merged, dev)
    _, _, ms_one, call_one, _ = _k3_at(one, dev) if dev.type == "cuda" else (0, 0, 0, 0, 0)
    want_c, want_ok, plain_s = plain.result()
    pool.shutdown()
    same = (np.array_equal(got_c.cpu().numpy(), want_c)
            and np.array_equal(got_ok.cpu().numpy(), want_ok))
    err = int(np.abs(got_c.cpu().numpy().astype(np.int64) - want_c).max())
    check(same and bool(want_ok.all()),
          "K3 over the merged lanes disagrees with its plain version")
    tokens = ac_tokens_per_lane(merged, want_c)
    bound_ms, bound_by = _k3_bound(merged, tokens, len(want_ok))
    k3 = {"lanes": len(want_ok), "frames": streams[0][3], "clusters": merged["tables"].shape[0],
          "smem_plan": plan, "kernel_ms": ms, "call_ms": call_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "plain_host_s": plain_s, "max_abs_diff": err,
          "tokens": sum(tokens), "longest_lane_tokens": max(tokens),
          "ns_per_step": ms * 1e6 / max(tokens) if ms else None,
          "one_frame_lanes": one["streams"].shape[0],
          "one_frame_kernel_ms": ms_one, "one_frame_call_ms": call_one}
    emit({"phase": "batched_anim", "name": "decode_ac_sections", "case": "anim48_512_merged",
          **k3})
    emit({"phase": "batched_anim", "summary": summary, "main_route": BATCH_ANIM_DEFAULT,
          "launches_main_route": main_launches})
    return {"launches": main_launches, "k3": k3}


def host_route_streams(vdata, mdata, astreams):
    """[(name, codestream, size class, (width, height), frames)] of the
    host_route phase: the VarDCT stills 256x256 and 512x512 (thumbnails
    and stickers, where the card route pays its per-frame queueing),
    1920x1080 and the 4K stream of the vardct phase; the Modular stills
    512x512 and the 4K stream of the decode phase; the three animations of
    the batched_anim phase; a 512x384 still whose 120 patches read a
    reference slot (under JXL_TPU_DEVICE=off the slot is held on the card
    while the frame renders on the host)."""
    from test_torch_frame_streams import patches_stream
    from test_torch_streams import encode_xyb_modular
    from test_torch_vardct_streams import encode_xyb_vardct

    out = [(f"vardct_{w}x{h}", encode_xyb_vardct(w, h, seed=seed)[0], "vardct", (w, h), 1)
           for w, h, seed in ((256, 256, 41), (512, 512, 42), (1920, 1080, 43))]
    out.append((f"vardct_{WIDTH}x{HEIGHT}", vdata, "vardct", (WIDTH, HEIGHT), 1))
    out.append(("modular_512x512", encode_xyb_modular(512, 512, seed=44)[0], "modular",
                (512, 512), 1))
    out.append((f"modular_{WIDTH}x{HEIGHT}", mdata, "modular", (WIDTH, HEIGHT), 1))
    out += [(name, data, "animation", wh, n) for name, data, wh, n, _ in astreams]
    out.append(("patches_512x384", patches_stream(512, 384, (320, 64), 120, 30, seed=45),
                "patches", (512, 384), 1))
    return out


def _frame_pixels(data) -> int:
    """The pixels of the largest frame of a stream (width times height of
    its frame headers)."""
    from jxl_tpu_torch.api.simple import scan_frames
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    return max(h.size()[0] * h.size()[1] for h, _, _ in scan_frames(data, br.pos, fh))


def settle_cutoffs(records) -> dict:
    """The auto rule's cutoffs from the walls of one run (PERF.md section
    5): within each size class, in order of frame pixels, the host route
    takes the sizes up to the first stream on which it did not beat the
    card route in both u8 and f32; the cutoff sits one pixel above the
    largest such frame, so below the smallest on which it lost (0: the
    card everywhere). Sizes past the first loss are not extrapolated."""
    out = {}
    for cls in ("vardct", "modular", "animation"):
        rows = sorted((r["frame_pixels"], r["host_wins"]) for r in records if r["class"] == cls)
        cutoff = 0
        for px, won in rows:
            if not won:
                break
            cutoff = px + 1
        out[cls] = cutoff
    return out


def phase_host_route(streams, device="cuda") -> dict:
    """The host render route (JXL_TPU_DEVICE, utils/devhealth.py) against
    the card route on each stream of host_route_streams: (a) decode_image
    with JXL_TPU_DEVICE=on and =off, a warm-up u8 decode (its K1 and K3
    launches and peak card memory), then u8 and f32 walls and host_s,
    medians of 5; (b) the gate, host route against card route, u8 at most
    1 LSB and f32 at most 1e-4 over every frame; (c) the probe's
    economics and the cutoffs this run's walls settle (settle_cutoffs)
    beside the committed ones; (d) the route auto took for each stream
    and its u8 wall, median of 5. The host route must launch neither
    kernel and return frames on the card. Returns the K1 and K3 launches
    of the card route and of the host route summed over the streams, and
    the economics and cutoffs."""
    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.api.simple import scan_frames
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.utils import devhealth

    dev = torch.device(device)
    eco = devhealth.start_probe(dev) if dev.type == "cuda" else None
    emit({"phase": "host_route", "probe": eco})
    totals = {r: {"decode_ac_sections": 0, "epf_gab": 0} for r in ("on", "off")}
    records = []
    old = os.environ.pop("JXL_TPU_DEVICE", None)

    def timed(data, fmt, reps=5):
        walls, hosts, img = [], [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            img = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device=dev)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            hosts.append(img.timings["host_s"])
        return img, walls, hosts

    try:
        for name, data, cls, (w, h), nframes in streams:
            rec = {"stream": name, "class": cls, "frame_pixels": _frame_pixels(data),
                   "frames": nframes}
            outs = {}
            for route in ("on", "off"):
                os.environ["JXL_TPU_DEVICE"] = route
                k1, k3 = K.epf_gab.launches, device_ac.decode_ac_sections.launches
                _, peak = _peak_mb(lambda: jxl_tpu_torch.decode_image(
                    data, pixel_format="u8", device=dev), dev)
                launches = {"decode_ac_sections": device_ac.decode_ac_sections.launches - k3,
                            "epf_gab": K.epf_gab.launches - k1}
                u8, walls8, hosts8 = timed(data, "u8")
                f32, walls32, hosts32 = timed(data, "f32")
                outs[route] = (u8, f32)
                every = {"decode_ac_sections": device_ac.decode_ac_sections.launches - k3,
                         "epf_gab": K.epf_gab.launches - k1}
                for k in launches:
                    totals[route][k] += launches[k]
                rec[route] = {"u8_wall_s_median": float(np.median(walls8)), "u8_walls_s": walls8,
                              "f32_wall_s_median": float(np.median(walls32)),
                              "f32_walls_s": walls32,
                              "u8_host_s_median": float(np.median(hosts8)),
                              "f32_host_s_median": float(np.median(hosts32)),
                              "launches_warmup_u8": launches,
                              "launches_all_11_decodes": every, "peak_mb_u8": peak}
                check(len(u8.frames) == nframes and tuple(u8.frames[0].shape) == (h, w, 3),
                      f"{name} route {route}: {len(u8.frames)} frames of "
                      f"{tuple(u8.frames[0].shape)}")
                check(all(f.device.type == dev.type for f in u8.frames + f32.frames),
                      f"{name} route {route}: frames off the decode's device")
            check(rec["off"]["launches_all_11_decodes"] == {"decode_ac_sections": 0, "epf_gab": 0},
                  f"{name}: the host route launched a kernel: "
                  f"{rec['off']['launches_all_11_decodes']}")
            check(dev.type != "cuda" or rec["on"]["launches_warmup_u8"]["epf_gab"] == nframes,
                  f"{name}: the card route launched K1 {rec['on']['launches_warmup_u8']}")
            u8d = max(float((a.int() - b.int()).abs().max())
                      for a, b in zip(outs["on"][0].frames, outs["off"][0].frames))
            f32d = max(float((a - b).abs().max())
                       for a, b in zip(outs["on"][1].frames, outs["off"][1].frames))
            rec["gate"] = {"u8_max_abs_diff": u8d, "u8_limit": 1,
                           "f32_max_abs_diff": f32d, "f32_limit": 1e-4}
            check(all(np.isfinite(f.cpu().numpy()).all() for f in outs["off"][1].frames),
                  f"{name}: non-finite output on the host route")
            check(u8d <= 1 and f32d <= 1e-4,
                  f"{name}: the host route differs from the card route (u8 {u8d}, f32 {f32d})")
            rec["host_wins"] = (rec["off"]["u8_wall_s_median"] < rec["on"]["u8_wall_s_median"]
                                and rec["off"]["f32_wall_s_median"]
                                < rec["on"]["f32_wall_s_median"])
            del outs
            os.environ["JXL_TPU_DEVICE"] = "auto"
            br = BitReader(data)
            fh = FileHeader.read(br)
            br.jump_to_byte_boundary()
            headers = [hd for hd, _, _ in scan_frames(data, br.pos, fh)]
            # the router's answer as decode_image asks it (a batched
            # animation takes the host only under "off")
            auto_host = (cls != "animation" and devhealth.host_route(
                headers[0], dev, still=devhealth.is_still(fh, headers[0], first=True)))
            _, walls, _ = timed(data, "u8")
            rec["auto"] = {"route": "host" if auto_host else "card",
                           "u8_wall_s_median": float(np.median(walls)), "u8_walls_s": walls}
            emit({"phase": "host_route", **rec})
            records.append(rec)
    finally:
        os.environ.pop("JXL_TPU_DEVICE", None)
        if old is not None:
            os.environ["JXL_TPU_DEVICE"] = old
    settled = settle_cutoffs(records)
    # auto sends only VarDCT stills to the host: 0, the card, for the others
    committed = {"vardct": devhealth.HOST_CUTOFF_VARDCT, "modular": 0, "animation": 0}
    summary = {r["stream"]: {"on_u8": r["on"]["u8_wall_s_median"],
                             "off_u8": r["off"]["u8_wall_s_median"],
                             "on_f32": r["on"]["f32_wall_s_median"],
                             "off_f32": r["off"]["f32_wall_s_median"],
                             "auto_u8": r["auto"]["u8_wall_s_median"],
                             "auto_route": r["auto"]["route"], "host_wins": r["host_wins"]}
               for r in records}
    emit({"phase": "host_route", "summary": summary, "probe": eco,
          "cutoffs_this_run": settled, "cutoffs_committed": committed,
          "launches": totals})
    return {"launches": totals, "probe": eco, "cutoffs_this_run": settled,
            "cutoffs_committed": committed}


TABLES_LF_QUANT = (1 / 2048, 1 / 1024, 1 / 128)
TABLES_KW = dict(dequant="mixed", orders=True, bctx="custom", histograms=4, clusters=64,
                 log_alpha=8, lf_quant=TABLES_LF_QUANT)


def tables_streams(width=WIDTH, height=HEIGHT, small=512, frames=48, **kw):
    """[(name, codestream, the writer's coefficients or None, (width,
    height), frames)] of the tables phase (the streams a real encoder's
    tables make; the sizes are the phase's, smaller and with more writer
    options `kw`, a lower density say, for a rehearsal on the CPU)."""
    from test_torch_frame_streams import anim_replace_stream
    from test_torch_vardct_streams import encode_xyb_vardct, encode_ycbcr_vardct

    tab = dict(TABLES_KW, **kw)
    out = []
    for name, make in (
            ("tables_4k", lambda: encode_xyb_vardct(width, height, seed=51, **tab)),
            ("tables_2pass_4k", lambda: encode_xyb_vardct(width, height, seed=51, passes=2,
                                                          order_codes="prefix", **tab)),
            ("tables_jpeg_4k", lambda: encode_ycbcr_vardct(width, height, seed=52,
                                                           subsampling="420", dequant="raw",
                                                           orders=True, **kw)),
            ("tables_512", lambda: encode_xyb_vardct(small, small, seed=56, **tab))):
        data, coeffs = make()
        size = (small, small) if name == "tables_512" else (width, height)
        out.append((name, data, coeffs, size, 1))
    anim = anim_replace_stream(small, small, frames, seed=53, frame_kw=lambda k: {
        "dequant": "mixed", "tables_seed": 53 + k % 2}, **kw)
    out.append(("tables_anim48_512", anim, None, (small, small), frames))
    return out


def _hf_global_seconds(data, plain: bool, reps: int = 5) -> float:
    """Best of `reps` host seconds of the frame's HfGlobal section read,
    its coefficient orders by the native permutation read or, with plain,
    by the Python loop it replaced (vardct/coeff_order.py)."""
    from jxl_tpu_torch.api.simple import parse_frame
    from jxl_tpu_torch.io.bit_reader import BitReader
    from jxl_tpu_torch.io.headers import FileHeader
    from jxl_tpu_torch.vardct import coeff_order, hf_global

    br = BitReader(data)
    fh = FileHeader.read(br)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    sections = frame.split_sections(br)
    frame.decode_lf_global(sections[frame.section_index("lf_global")])
    for g in range(frame.header.num_lf_groups):
        frame.decode_lf_group(g, sections[frame.section_index("lf", group=g)])
    sec = sections[frame.section_index("hf_global")]
    start = sec.pos
    real = hf_global.decode_coeff_orders
    hf_global.decode_coeff_orders = (coeff_order.decode_coeff_orders_plain if plain
                                     else coeff_order.decode_coeff_orders)
    try:
        best = float("inf")
        for _ in range(reps):
            sec.pos = start
            t0 = time.perf_counter()
            frame.decode_hf_global(sec)
            best = min(best, time.perf_counter() - t0)
    finally:
        hf_global.decode_coeff_orders = real
    return best


def phase_tables(streams, vdata, device="cuda") -> dict:
    """The tables phase (module docstring, 16) on tables_streams' streams,
    beside `vdata`, the default-tables 4K stream. Returns the K1 and K3
    launches of the main-path run and K3's record on tables_4k."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS

    dev = torch.device(device)
    by_name = {name: (data, coeffs, wh, n) for name, data, coeffs, wh, n in streams}
    lane_streams = ("tables_4k", "tables_2pass_4k", "tables_jpeg_4k")
    old_route = os.environ.pop("JXL_TPU_DEVICE", None)  # auto, the default
    # K3's plain version on the first four lanes of each 4K stream, on the
    # host in worker processes, queued once the walls are taken
    subsets = {}
    for name in lane_streams:
        inp = _lane_inputs(by_name[name][0])
        lane_keys = [k for k in inp if k in ("streams", "start_bits") or k.startswith("lane_")]
        subsets[name] = (inp, dict(inp, **{k: inp[k][:4] for k in lane_keys}))
    pool = ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing.get_context("spawn"))

    def queue_plain():
        return {name: pool.submit(_plain_ac_sections,
                                  [np.ascontiguousarray(v) for k, v in sub.items()
                                   if k not in LANE_KEYWORDS],
                                  {k: sub[k] for k in LANE_KEYWORDS})
                for name, (_, sub) in subsets.items()}

    try:
        out = _tables_cases(streams, by_name, vdata, subsets, queue_plain, dev)
    finally:
        pool.shutdown(cancel_futures=True)
        os.environ.pop("JXL_TPU_DEVICE", None)
        if old_route is not None:
            os.environ["JXL_TPU_DEVICE"] = old_route
    return out


def _tables_cases(streams, by_name, vdata, subsets, queue_plain, dev) -> dict:
    """phase_tables' steps (a)-(f); queue_plain() queues K3's plain
    versions on the host ({stream: future of _plain_ac_sections on its
    four lanes}) once the walls are taken, so that no worker shares the
    host's cores with a timed decode."""
    import itertools

    import numpy as np
    import torch

    import jxl_tpu_torch
    from jxl_tpu_torch.api.decoder import JxlDecoder, JxlDecoderOptions
    from jxl_tpu_torch.ops import ans_lanes as AL
    from jxl_tpu_torch.ops import device_ac
    from jxl_tpu_torch.ops import epf_gab as K
    from jxl_tpu_torch.utils import trace
    from jxl_tpu_torch.vardct.device_group import LANE_KEYWORDS

    card = dev.type == "cuda"

    def decode(data, fmt):
        return jxl_tpu_torch.decode_image(data, pixel_format=fmt, device=dev)

    # (a) the main path: each stream once, the counts zeroed just before
    K.epf_gab.launches = 0
    device_ac.decode_ac_sections.launches = 0
    AL.ans_decode_batch.launches = 0
    per = {}
    trace.enable()
    try:
        for name, data, _, _, _ in streams:
            k1, k3 = K.epf_gab.launches, device_ac.decode_ac_sections.launches
            trace.reset()
            _, peak = _peak_mb(lambda: decode(data, "u8"), dev)
            per[name] = {"epf_gab": K.epf_gab.launches - k1,
                         "decode_ac_sections": device_ac.decode_ac_sections.launches - k3,
                         "peak_mb_u8": peak,
                         "anim_fold_fallback": trace.metrics.get("anim_fold_fallback")}
    finally:
        trace.enable(False)
    launches = {"epf_gab": K.epf_gab.launches,
                "decode_ac_sections": device_ac.decode_ac_sections.launches,
                "ans_decode_batch": AL.ans_decode_batch.launches}
    emit({"phase": "tables", "launches": launches, "per_stream": per})
    if card:
        for name in ("tables_4k", "tables_2pass_4k", "tables_jpeg_4k"):
            check(per[name]["decode_ac_sections"] == 1 and per[name]["epf_gab"] == 1,
                  f"{name}: K3 and K1 must launch once: {per[name]}")
        check(per["tables_512"]["decode_ac_sections"] == 0 and per["tables_512"]["epf_gab"] == 0,
              f"tables_512 must take the host route under auto: {per['tables_512']}")
        n = by_name["tables_anim48_512"][3]
        check(per["tables_anim48_512"]["epf_gab"] == n
              and per["tables_anim48_512"]["decode_ac_sections"] >= 1,
              f"tables_anim48_512: K1 once a frame, K3 at least once: {per['tables_anim48_512']}")
    check((per["tables_anim48_512"]["anim_fold_fallback"] or 0) >= 1,
          "the fold must decline the animation of custom dequant tables")

    # (b) walls and host_s, medians of 5, beside the default-tables 4K
    # stream
    walls = {}
    timed = [(name, data, n) for name, data, _, _, n in streams]
    timed.append(("default_tables_4k", vdata, 1))
    routes = {name: ("auto",) for name, *_ in timed}
    routes["tables_512"] = ("auto", "on")
    recs = []
    for name, data, nframes in timed:
        for route in routes[name]:
            os.environ["JXL_TPU_DEVICE"] = route
            rec = {"stream": name, "route": route}
            outs = {}
            for fmt in ("u8", "f32"):
                ws, hs = [], []
                for _ in range(5):
                    t0 = time.perf_counter()
                    img = decode(data, fmt)
                    _sync(dev)
                    ws.append(time.perf_counter() - t0)
                    hs.append(img.timings["host_s"])
                outs[fmt] = img.frames
                rec[f"{fmt}_wall_s_median"] = float(np.median(ws))
                rec[f"{fmt}_walls_s"] = ws
                rec[f"{fmt}_host_s_median"] = float(np.median(hs))
                check(len(img.frames) == nframes and all(f.device.type == dev.type
                                                          for f in img.frames),
                      f"{name}: {len(img.frames)} frames, or frames off the decode's device")
            os.environ.pop("JXL_TPU_DEVICE")
            walls[f"{name}_{route}"] = {k: rec[k] for k in rec if k.endswith("_median")}
            recs.append((name, data, rec, {f: [x.cpu() for x in o] for f, o in outs.items()}))
    plain = queue_plain()
    # (c) each stream against the port's CPU decode (host AC)
    os.environ["JXL_TPU_AC"] = "host"
    try:
        for name, data, rec, outs in recs:
            if name == "default_tables_4k":
                emit({"phase": "tables", **rec})
                continue
            for fmt, limit in (("u8", 1.0), ("f32", 1e-4)):
                ref = jxl_tpu_torch.decode_image(data, pixel_format=fmt, device="cpu").frames
                diff = max(float((a.double() - b.double()).abs().max())
                           for a, b in zip(outs[fmt], ref))
                rec[f"{fmt}_vs_cpu_max_abs_diff"] = diff
                check(all(np.isfinite(f.numpy()).all() for f in outs[fmt]),
                      f"{name}: non-finite output")
                check(diff <= limit, f"{name} {rec['route']} {fmt}: {diff} from the CPU decode")
            emit({"phase": "tables", **rec})
    finally:
        os.environ.pop("JXL_TPU_AC", None)
    del recs

    # (d) the 4K streams' coefficients: K3 on the card and the host AC
    # decoder against the writer's; K3 on four lanes against its plain version
    coeff_checks = {}
    for name, (inp, sub) in subsets.items():
        data, coeffs = by_name[name][:2]
        frame = _vardct_frame(data, dev)
        _sync(dev)
        k3 = frame.device_ac_flat.cpu().numpy()
        host = _vardct_frame(data, "cpu", host_ac=True).host_ac_flat
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in sub.items() if k not in LANE_KEYWORDS}
        kw = {k: sub[k] for k in LANE_KEYWORDS}
        got_c, got_ok = device_ac.decode_ac_sections(**arrays, **kw)
        want_c, want_ok, plain_s = plain[name].result()
        rec = {"k3_equals_writer": bool(np.array_equal(k3, coeffs)),
               "host_ac_equals_writer": bool(np.array_equal(host, coeffs)),
               "k3_4_lanes_equal_plain": bool(np.array_equal(got_c.cpu().numpy(), want_c)
                                              and np.array_equal(got_ok.cpu().numpy(), want_ok)),
               "plain_4_lanes_s": plain_s, "lanes": int(inp["streams"].shape[0]),
               "nonzero_coefficients": int(np.count_nonzero(coeffs))}
        coeff_checks[name] = rec
        emit({"phase": "tables", "stream": name, **rec})
        check(rec["k3_equals_writer"] and rec["host_ac_equals_writer"],
              f"{name}: coefficients differ from the writer's")
        check(rec["k3_4_lanes_equal_plain"], f"{name}: K3 differs from its plain version")

    # K3 on tables_4k's lanes, as the decode launches it: time, bound, plan
    inp = subsets["tables_4k"][0]
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in inp.items() if k not in LANE_KEYWORDS}
    kw = {k: inp[k] for k in LANE_KEYWORDS}
    b, c = device_ac.pack_tables(inp["tables"], inp["uint_cfgs"], inp["context_map"])
    packs = dict(packed_buckets=torch.from_numpy(b).to(dev), packed_cfgs=torch.from_numpy(c).to(dev))
    got_c, _ = device_ac.decode_ac_sections(**arrays, **kw, **packs)
    plan = device_ac.ac_smem_plan(C=inp["tables"].shape[0], NB=inp["n_buckets"],
                                  num_bctx=inp["num_bctx"], NC=len(inp["context_map"]))
    tokens = ac_tokens_per_lane(inp, got_c.cpu().numpy())
    k3 = {"lanes": int(inp["streams"].shape[0]), "clusters": int(inp["tables"].shape[0]),
          "n_buckets": int(inp["n_buckets"]), "num_bctx": int(inp["num_bctx"]),
          "context_map_entries": len(inp["context_map"]),
          "tab_shared": plan["tab_shared"], "ctx_slice": plan["ctx_slice"],
          "smem_bytes": plan["smem_bytes"], "tokens": sum(tokens),
          "longest_lane_tokens": max(tokens)}
    k3["bound_ms"], k3["bound_by"] = _k3_bound(inp, tokens, k3["lanes"])
    check(not plan["tab_shared"] and plan["ctx_slice"] == 16 * 495 + 16,
          f"tables_4k: K3's plan {plan}")
    if card:
        k3["kernel_ms"] = device_times(
            [(0, lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
              AL.load(), "ac_sections_launch")], reps=5)[0]
        k3["call_ms"] = time_ms(lambda: device_ac.decode_ac_sections(**arrays, **kw, **packs),
                                reps=10, warmup=2)
        k3["ns_per_step"] = k3["kernel_ms"] * 1e6 / max(tokens)
        k3["plain_ms_4_lanes_host"] = coeff_checks["tables_4k"]["plain_4_lanes_s"] * 1e3
    emit({"phase": "tables", "k3_tables_3840x2160": k3})

    # (e) tables_4k by decode_banded and by JxlDecoder in 64 KiB pieces
    data = by_name["tables_4k"][0]
    whole = decode(data, "u8").frames[0]
    rows = []
    jxl_tpu_torch.decode_banded(data, lambda y0, band: rows.append(band.clone()),
                                pixel_format="u8", device=dev)
    banded_same = bool(torch.equal(torch.cat(rows).to(whole.device), whole))
    dec = JxlDecoder(JxlDecoderOptions(pixel_format="u8"), device=dev)
    _feed(dec, data, itertools.repeat(STREAM_CHUNK_FLUSH))
    streaming_same = len(dec.frames) == 1 and bool(torch.equal(dec.frames[0], whole))
    emit({"phase": "tables", "stream": "tables_4k", "decode_banded_equal": banded_same,
          "bands": len(rows), "jxl_decoder_64k_equal": streaming_same})
    check(banded_same, "tables_4k: decode_banded differs from decode_image")
    check(streaming_same, "tables_4k: JxlDecoder differs from decode_image")

    # (f) HfGlobal's host seconds: the native permutation read against the
    # Python loop it replaced
    hfg = {name: {"native_s": _hf_global_seconds(by_name[name][0], False),
                  "plain_s": _hf_global_seconds(by_name[name][0], True)}
           for name in ("tables_4k", "tables_2pass_4k")}
    emit({"phase": "tables", "hf_global_seconds": hfg})
    return {"launches": launches, "per_stream": per, "walls": walls, "k3": k3,
            "coefficients": coeff_checks, "hf_global_s": hfg}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    # fail before any output when the package or the stream writer is missing
    import jxl_tpu_torch  # noqa: F401
    import test_torch_streams  # noqa: F401
    import test_torch_frame_streams  # noqa: F401
    import test_torch_icc_streams  # noqa: F401
    import test_torch_spline_streams  # noqa: F401
    import test_torch_vardct_streams  # noqa: F401

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(smi_line, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})

    start = time.perf_counter()
    phase_s = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    run("build", phase_build)
    from test_torch_streams import encode_xyb_modular
    from test_torch_vardct_streams import encode_xyb_vardct

    t0 = time.perf_counter()
    data, _ = encode_xyb_modular(WIDTH, HEIGHT, seed=7)
    emit({"phase": "decode", "step": "write_stream", "bytes": len(data),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    vdata, vcoeffs = encode_xyb_vardct(WIDTH, HEIGHT, seed=7)
    emit({"phase": "vardct", "step": "write_stream", "bytes": len(vdata),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    fstreams = feature_streams()
    emit({"phase": "features", "step": "write_streams",
          "bytes": {name: len(d) for name, d, _, _ in fstreams},
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    lstreams = layout_streams()
    emit({"phase": "layouts", "step": "write_streams",
          "bytes": {name: len(d) for name, d, _, _, _ in lstreams},
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    mstreams = frame_streams()
    emit({"phase": "frames", "step": "write_streams",
          "bytes": {name: len(d) for name, d, *_ in mstreams},
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    tstreams = tool_streams()
    emit({"phase": "tools", "step": "write_streams",
          "bytes": {name: len(d) for name, d, *_ in tstreams},
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    astreams = batched_anim_streams()
    emit({"phase": "batched_anim", "step": "write_streams",
          "bytes": {name: len(d) for name, d, *_ in astreams},
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    tabstreams = tables_streams()
    emit({"phase": "tables", "step": "write_streams",
          "bytes": {name: len(d) for name, d, *_ in tabstreams},
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    kdata = modular_d0_stream()
    emit({"phase": "k6", "step": "write_stream", "bytes": len(kdata),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ldata = lossless_stream()
    emit({"phase": "lossless", "step": "write_stream", "bytes": len(ldata),
          "seconds": time.perf_counter() - t0})
    phase_s["write_streams"] = time.perf_counter() - start - phase_s["build"]
    # the only profiler sessions of the process: CUPTI has dropped events
    # in sessions after the first few
    run("profile", phase_profile, fstreams[0][1], "vardct_up2_noise", "epf_gab_kernel")
    run("profile", phase_profile, data, "modular", "epf_gab_kernel")
    run("profile", phase_profile, vdata, "vardct", "ac_sections_kernel")
    run("profile", phase_profile, astreams[0][1], "anim48_512_batched", "ac_sections_kernel")
    k, k_half, k_slab, max_err = run("kernels", phase_kernels)
    k2 = run("k2", phase_k2)
    k3 = run("k3", phase_k3, vdata)
    modular_launches = run("decode", phase_decode, data)
    vardct_launches = run("vardct", phase_vardct, vdata, vcoeffs)
    k5 = run("k5", phase_k5, vdata)
    k6 = run("k6", phase_k6, kdata)
    feature_launches = run("features", phase_features, fstreams)
    run("features_breakdown", phase_render_breakdown, fstreams[0][1], "vardct_up2_noise",
        "features_breakdown")
    layout_launches = run("layouts", phase_layouts, lstreams)
    frame_launches = run("frames", phase_frames, mstreams)
    tool_launches = run("tools", phase_tools, tstreams)
    streaming = run("streaming", phase_streaming, tstreams[0][1], mstreams[0][1], vdata)
    bstreams = run("banded", banded_streams, fstreams, tstreams, mstreams)
    band_launches = run("banded", phase_banded, vdata, bstreams)
    lossless = run("lossless", phase_lossless, ldata)
    sinputs = run("sharded", sharded_streams, vdata, lossless["frame_lanes"])
    sharded = run("sharded", phase_sharded, sinputs)
    batched = run("batched_anim", phase_batched_anim, astreams)
    hstreams = run("host_route", host_route_streams, vdata, data, astreams)
    host_route = run("host_route", phase_host_route, hstreams)
    tables = run("tables", phase_tables, tabstreams, vdata)
    emit({"phase": "timing", "seconds": phase_s, "total_s": time.perf_counter() - start})
    null_reason = "no single torch call computes a rANS decode"
    emit({"kernels": [
        {"name": "epf_gab", "route": "cuda", "source": "jxl_tpu_torch/csrc/epf_gab.cu",
         "replaces": "jxl_tpu/ops/pallas_epf.py:228", "launches": vardct_launches["epf_gab"],
         "launches_modular_path": modular_launches,
         "launches_features_path": feature_launches["epf_gab"],
         "launches_layouts_path": layout_launches["epf_gab"],
         "launches_frames_path": frame_launches["epf_gab"],
         "launches_tools_path": tool_launches["epf_gab"],
         "launches_streaming_path": streaming["launches"]["epf_gab"],
         "launches_streaming_flush_path": streaming["flush_launches"]["epf_gab"],
         "launches_decode_banded_8k_path": band_launches["decode_banded_8k"]["epf_gab"],
         "launches_decode_banded_types_path": {
             k: v["epf_gab"] for k, v in band_launches["decode_banded_types"].items()},
         "launches_lossless_path": lossless["launches"]["epf_gab"],
         "launches_sharded_path": sharded["epf_gab"],
         "launches_batched_anim_path": batched["launches"]["epf_gab"],
         "launches_host_route_phase_card_route": host_route["launches"]["on"]["epf_gab"],
         "launches_host_route_phase_host_route": host_route["launches"]["off"]["epf_gab"],
         "launches_tables_path": tables["launches"]["epf_gab"],
         "max_abs_err": max_err, "ms": k["kernel_ms"], "call_ms": k["call_ms"],
         "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         "library_note": "no single torch call computes gaborish+EPF",
         "stage_sets": k["stage_sets"],
         "at_1920x1080": {key: k_half[key] for key in ("kernel_ms", "call_ms", "plain_ms",
                                                      "bound_ms", "bound_by", "max_abs_diff")},
         f"band_slab_{BAND_SLAB_ROWS}x{WIDTH}": {
             key: k_slab[key] for key in ("kernel_ms", "call_ms", "plain_ms", "bound_ms",
                                          "bound_by", "max_abs_diff")}},
        {"name": "ans_decode_batch", "route": "cuda", "source": "jxl_tpu_torch/csrc/ans_lanes.cu",
         "replaces": "jxl_tpu/ops/pallas_ans.py:105", "launches": k2["launches"],
         "launches_note": "its own path, the batch decode entry point; no decode path "
                          "calls K2 (streaming path: "
                          f"{streaming['launches']['ans_decode_batch']}; banded paths: "
                          f"{band_launches['ans_decode_batch']}; sharded path: 0, no "
                          "sharded function calls it)",
         "max_abs_err": k2["max_abs_err"], "ms": k2["kernel_ms"], "call_ms": k2["call_ms"],
         "plain_ms": k2["plain_ms"], "ns_per_step": k2["ns_per_step"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
         "library_note": null_reason, "S4224_T1024": k2["S4224_T1024"]},
        {"name": "decode_ac_sections", "route": "cuda",
         "source": "jxl_tpu_torch/csrc/ans_lanes.cu",
         "replaces": "jxl_tpu/ops/device_ac.py:55",
         "launches": vardct_launches["decode_ac_sections"],
         "launches_features_path": feature_launches["decode_ac_sections"],
         "launches_layouts_path": layout_launches["decode_ac_sections"],
         "launches_frames_path": frame_launches["decode_ac_sections"],
         "launches_tools_path": tool_launches["decode_ac_sections"],
         "launches_streaming_path": streaming["launches"]["decode_ac_sections"],
         "launches_streaming_flush_path": streaming["flush_launches"]["decode_ac_sections"],
         "launches_decode_banded_8k_path":
             band_launches["decode_banded_8k"]["decode_ac_sections"],
         "launches_decode_banded_types_path": {
             k: v["decode_ac_sections"] for k, v in band_launches["decode_banded_types"].items()},
         "launches_sharded_path": sharded["decode_ac_sections"],
         "launches_batched_anim_path": batched["launches"]["decode_ac_sections"],
         "launches_host_route_phase_card_route":
             host_route["launches"]["on"]["decode_ac_sections"],
         "launches_host_route_phase_host_route":
             host_route["launches"]["off"]["decode_ac_sections"],
         "launches_tables_path": tables["launches"]["decode_ac_sections"],
         "tables_3840x2160": tables["k3"],
         "batched_anim_512_merged": batched["k3"],
         "k3_lanes_per_launch_streaming_flushes": streaming["k3_lanes_per_launch"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["kernel_ms"], "call_ms": k3["call_ms"],
         "plain_ms": k3["plain_ms"], "ns_per_step": k3["ns_per_step"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
         "library_note": null_reason, "two_pass_3840x2160": k3["two_pass_3840x2160"],
         "band_row1_3840x2160": k3["band_row1_3840x2160"]},
        {"name": "gradient_wavefront", "route": "cuda",
         "source": "jxl_tpu_torch/csrc/lossless_lanes.cu",
         "replaces": "jxl_tpu/modular/device_lossless.py:122",
         "launches": lossless["launches"]["gradient_wavefront"],
         "launches_sharded_path": sharded["gradient_wavefront"],
         "launches_note": "the lossless phase's ten JXL_TPU_DEV_LOSSLESS=1 decodes of the 4K "
                          f"lane stream, {lossless['k4_launches_per_decode']} a decode; none "
                          "on the other phases' streams, whose leaves are not channel-static",
         "max_abs_err": lossless["k4"]["max_abs_err"], "ms": lossless["k4"]["ms"],
         "call_ms": lossless["k4"]["call_ms"], "plain_ms": lossless["k4"]["plain_ms"],
         "bound_ms": lossless["k4"]["bound_ms"], "bound_by": lossless["k4"]["bound_by"],
         "chain_bound_ms": lossless["k4"]["chain_bound_ms"],
         "host_native_ms": lossless["k4"]["host_native_ms"], "library_ms": None,
         "library_note": "no single torch call computes the clamped-gradient recurrence",
         "lanes": 270, "samples": lossless["k4"]["samples"],
         "ms_decode_batches": lossless["k4"]["ms_decode_batches"]},
        {"name": "vardct_blocks", "route": "cuda",
         "source": "jxl_tpu_torch/csrc/vardct_blocks.cu",
         "replaces": "none: jxl_tpu/vardct/device_frame.py writes the stage as XLA",
         "launches": vardct_launches["vardct_blocks_per_decode"],
         "launches_note": "a decode_image of the 4K 4:4:4 VarDCT stream, one a transform "
                          "type",
         "max_abs_err": k5["max_abs_diff"], "ms": k5["ms"], "call_ms": k5["call_ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None,
         "library_note": "no single torch call computes the dequant and the inverse DCTs"},
        {"name": "modular_lanes", "route": "cuda",
         "source": "jxl_tpu_torch/csrc/modular_lanes.cu",
         "replaces": "none: jxl_tpu decodes Modular group streams on the host",
         "launches": k6["launches_per_decode"],
         "launches_note": "a decode_image of the 4K modular_d0 stream; none on the other "
                          "phases' Modular streams (prefix-coded, or JXL_TPU_DEV_LOSSLESS=1)",
         "max_abs_err": 0 if k6["bit_for_bit"] else None, "ms": k6["ms"],
         "call_ms": k6["call_ms"], "plain_ms": k6["plain_ms"], "ns_per_step": k6["ns_per_step"],
         "bound_ms": None, "bound_by": k6["bound_by"], "library_ms": None,
         "library_note": null_reason},
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
