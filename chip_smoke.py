#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``crane_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It needs no network, no checkpoint and no
tokenizer: weights are random, drawn from a seeded ``torch.Generator``, and
requests are token ids (the HTTP phases use a stand-in tokenizer). Phases,
each reported on its own line:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compile the kernels under ``crane_tpu_torch/csrc/`` with ``nvcc``,
   and log the compiled form of each bf16 tensor-core instance (registers,
   spill bytes, shared memory): K2/K3 and K5 at each head dim, K6 at each
   output tile; of every split-KV decode instance (K1, K4 kv8/kv4 at each
   dtype, head dim and group); and of K7's chunkwise kernels (the chunk
   preparation and the state pass at 16 and 32 columns a block);
3. kernels: K1 (decode), K2 (fresh prefill), K3 (continuation), K4
   (quantized decode), K5 (quantized continuation), K6 (quantized-weight
   matmul) and K7 (the GDN scan) against their plain PyTorch versions on
   the card, at the main paths' shapes (K1-K5 also at head_dim 256 with
   Qwen3.5's 8 query / 2 KV heads), each with its time beside the plain
   version's. K7's two routes, the chunkwise kernels on the tensor cores
   and the sequential scan, are each forced at S on both sides of the
   64-step chunk and of the route threshold (128), at B=1 and 8, and held
   to the same tolerances; the route the wrapper takes is timed beside the
   other, the plain scan and the chunked PyTorch route.
   K2, K3 and K5 run the bf16 tensor-core kernels, K6 too from 4 rows:
   K6 is timed at M=8 (decode) and M=256 (a chunk's gate/up, and its down
   projection), beside the bf16 ``torch.mm`` over the dequantized weight;
   K5 beside K3 in bf16 on the same chunk. Ragged cases (a two-row
   300-token prefill, a two-row chunk at other offsets past the buffer's
   end) join K2/K3's checks, and their float32 route (the CUDA-core
   kernel) is checked and timed beside them. One stream at a long
   context: K1, K4 (kv8, kv4) and K1-S/K4-S over one row of 16,000 live
   tokens in a 16,384-slot cache, where the decode kernels split each
   kv-head's range over many blocks (the split count is logged), with a
   window across the splits;
   at the MoE and short-conv paths' shapes: K1, K2 and K3 with LFM2-1.2B's
   32 / 8 heads of 64 and with Qwen3-Next-80B-A3B's 16 / 2 of 256, and K7
   at B=1 S=1000 over 32 value heads (check_family_kernels); at this
   slice's: K1 with Gemma 3n's 8 / 2 heads of 256, scale 1.0 and the
   512-token window over 1200 live slots, and K2 with segments at
   Gemma3-4B's 8 / 4 heads of 256 on a 300-token prompt holding a 256-token
   image block (check_slice_kernels); and K1 and K3 with Qwen2-Audio's 32
   query / 32 KV heads of 128 (group 1) at its transcription prompt
   (check_audio_kernels);
   routes: a tiny model with head_dim 96 and one with 16 query heads on one
   kv-head, whose attention the kernels do not take, run prefill, a chunk
   and decode on the card through the plain versions (counted in
   ``attention_block.plain_routes``) against the CPU, and a direct kernel
   call with their heads raises;
4. model: full-width Qwen3-0.6B; a 300-token prefill on the card agrees
   with the same prefill in float32 on the CPU; 64 greedy tokens through
   ``CausalLM.generate``; prefill ms and decode tok/s, and the prefill's
   device time (``torch.profiler``, as for the 256-token chunks the
   ``launches`` lines count);
5. engine: ``InferenceEngine`` serves six concurrent requests (chunked
   admission, prefix reuse, one sampled request); every request finishes,
   the statistics reconcile, and K1, K2 and K3 were each launched by this
   main path;
6. quantized model: the same weights quantized in situ to int4 (head
   included); the 300-token prefill, and one decode step into an int8 and
   one into an int4 KV cache, agree with the same codes run in float32 on
   the CPU; 64 greedy tokens through ``generate`` on an int4 cache;
7. quantized engine: the six-request mix with int8 weights on an int8 KV
   cache, then with int4 weights on an int4 cache; K4, K5 and K6 were
   launched, at each bit width, by this quantized path;
8. hybrid model: full-width Qwen3.5-0.8B (18 Gated-DeltaNet and 6 gated
   attention layers, head_dim 256) with random bf16 weights in the HF
   layout, mapped by ``map_hf_weights``; the 300-token prefill run in
   float32 on the card (the kernels in float32) agrees with the same
   prefill in float32 on the CPU, and the bf16 prefill's distance from it
   is reported beside the CPU's own bf16 distance (both prefills, and the
   engine below, must launch K7's chunkwise route); 64 greedy tokens
   through ``generate`` in bf16; prefill ms and decode tok/s;
9. hybrid engine: the six-request mix on the hybrid model (prefix reuse
   off); K1, K2, K3 (at head_dim 256) and both K7 routes (the scan for
   the prompts bucketed at 64 tokens) were each launched by this
   hybrid path;
   fuse: the layout ``CRANE_FUSE_PROJ=1`` gives (``models/fuse.py``:
   q|k|v and gate|up as one product each) on the models built above. K6
   at the fused widths (O = 4096 and 6144, M = 1, 8, 256) against its
   plain version and against the unfused products concatenated (bit for
   bit where the kernel splits I the same way at both widths); Qwen3-0.6B
   bf16, w8 kv8 and w4 kv4 fused against unfused (the 300-token prefill's
   logits, 64 greedy tokens under the tie rule), the engine mix fused at
   w4 kv4, Qwen3.5-0.8B's prefill and 16 tokens (its gated q twice as
   wide); K6 launches a w4 kv4 decode step fall by 3 a layer; the graph
   decode step fused beside unfused (B=1 and 8; an A/B in turns in bf16,
   w8 kv8 and w4 kv4); a ``utils/tracing.py`` span in a profiler trace,
   ``utils/timing.py``'s ``marginal_rate`` of graph blocks, and
   ``ops/activations.py`` on the card against the CPU;
10. sp: sequence-parallel serving of full-width Qwen3-0.6B in four slabs on
   the one card (``make_sp_mesh(4, ["cuda:0"] * 4)``). The with-stats
   kernels K1-S, K3-S, K4-S and K5-S (kv8, kv4) against their plain
   versions and their no-stats kernels at a slab's shapes (empty slabs and
   chunks below, inside and past the slab); a 5000-token prompt over three
   slabs in float32 against the unsharded port on the card, on fp, int8 and
   int4 caches; the bf16 engine with two 16,384-token slots serving a
   12,000- and a 300-token prompt against the unsharded engine; the
   with-stats kernels were each launched by this sp path, and K1 and K3
   never were; the decode step's time beside the unsharded one;
11. graphs (within each path above): the path's greedy tokens through CUDA
   graphs (``models/graphs.py``, one replay a decode block) against the
   eager loop on the card, 8 rows with every fourth idle, for Qwen3-0.6B
   bf16, w8 kv8 and w4 kv4, Qwen3.5-0.8B and four sp slabs;
12. spec: speculative decoding on full-width Qwen3-0.6B, bf16 and w4 kv4:
   ``generate(speculative="ngram")`` against plain greedy generate, and the
   8-slot engine with ``speculative="ngram"`` on eight repetitive prompts
   against the plain engine (the engine must run speculative blocks), with
   tokens a weight pass and each run's time a token; the bf16 engine in
   four slabs against the unsharded plain engine, and generate on an int8
   cache in four slabs. A control (w4 kv4 generate whose verify forwards
   write only their first row's K/V) must fail the tie rule below; the
   K/V that plain and speculative generate write for the same tokens (four
   prompts) agree slot by slot (bf16, w4 kv4; check_spec_kv), and the same
   rows shifted
   one slot (a control) do not; the
   sound margin shifts (one context's K/V written by decode steps and by
   one chunk) are logged for the bf16, int8 and int4 caches. K3, K5 kv4,
   K3-S and K5-S kv8 are launched there only by verify forwards; the rows
   of K3 and K5 kv4 at 8 slots x 9 rows and K6 w4 at M=72 and M=9 (timed
   in phase 3, ``check_verify_kernels``) take the launches of the verify
   forwards alone;
13. http: the port's server (``serve/api.py`` over the standard-library
   transport of ``serve/transport.py``) in this process on 127.0.0.1, over
   a threaded engine of phase 5's shape, bf16 and then w4 kv4, with a
   stand-in tokenizer (pure Python; each id decodes to a word of its own,
   so text maps back to ids). Phase 5's greedy prompts go to /generate
   with ``input_ids`` all at once, and their ids equal those of the same
   requests through ``engine.submit``, or part at a tie (the rule below);
   /v1/chat/completions streamed and not (the deltas add up to the
   content), /v1/completions, a stream aborted by /abort_request and one
   whose client closes its socket (/v1/stats counts both aborts and the
   slots come free), 9 concurrent streams on 8 slots, /health_generate.
   K1-K3 (bf16) and K2, K4, K5, K6 (w4 kv4) were launched by the HTTP
   traffic. Logged on the host clock: the time to the first SSE chunk of
   the 300- and the 1000-token prompt over HTTP and through
   ``engine.submit``, and the aggregate tokens/s of 8 HTTP streams against
   8 direct ones;
14. gguf (after paths and oov below): the bf16 model's weights written as
   a q8_0 GGUF file (linears
   q8_0, the rest f32, about 1.1 GB) with this script's own writer,
   loaded by ``loaders/gguf_model.py`` ``from_gguf`` on the card (bf16,
   q8_0 kept as blockwise weights) and on the CPU in float32 as the
   reference (dequantized, by the native or the NumPy route, logged); the
   300-token prefill's logits and 32 greedy tokens against the CPU; 4
   requests served over HTTP; K1-K3 launched and K6 never (blockwise
   linears are plain products); load times, prefill ms and the graph
   decode step beside the bf16 model's;
15. paths (after sp): three served paths the card had not run before, each
   through an existing check: Qwen3.5-0.8B on an int8 KV cache (the engine
   mix and graphs against eager; K4 and K5 at head_dim 256 beside K7),
   Qwen3.5-0.8B in four slabs (its GDN states whole on the lead device)
   and Qwen3-0.6B with int8 ISQ weights in four slabs, each in float32
   against the unsharded model (sp_greedy, compare_sp);
16. oov (after http): a prompt id outside the vocabulary, answered 400 by
   /generate and with an error response by ``engine.submit`` on a running
   engine, which then serves a good request with a fresh engine's tokens;
17. lfm2: LFM2-1.2B at full size (16 layers, 10 of them short conv;
   attention 32 query / 8 KV heads of 64) with random bf16 weights in
   LFM2's HF layout: the 300-token prefill against float32 on the CPU, a
   chunked prompt against the whole one, generate, graphs against eager,
   the engine mix; K1, K2 and K3 at head_dim 64 were launched by it;
18. moe: Qwen3-Next-80B-A3B at full width (512 experts, top-10) and 12 of
   its 48 layers: map_hf_weights on one full-width MoE layer, the prefill of
   its first 4 layers in float32 on the card against the CPU, then the
   12-layer bf16 model: the prefill, generate, graphs against eager, the
   engine mix; K1, K2, K3 (16 / 2 heads of 256), K7 (32 value heads) and
   K8 (every MoE layer) were launched by it, and neither plain MoE
   dispatch; its decode step at 1, 8 and 32 distinct rows beside the bound
   of reading the experts those rows route to;
19. gemma3n: Gemma 3n E4B's text model (transformers' Gemma3nTextConfig()
   defaults: 35 layers, 8 query / 2 KV heads of 256, the last 15 layers
   reading the KV of layers 18 and 19, AltUp, Laurel, per-layer embeddings,
   activation sparsity) with random weights in the HF layout, mapped by
   ``models/gemma3n.py`` ``map_hf_weights``: its first 12 layers (4 of
   them KV-shared) in float32 on the card against the CPU, a prefill
   holding two ids past the 262144-row per-layer table and 4 decode steps;
   then all 35 layers in bf16: a 1000-token prompt in a 2048-slot cache
   (the 512-token window bites), 64 greedy tokens through the decode-step
   graph against the eager step, 4 chat requests through ``TextBackend``
   over HTTP with the stand-in tokenizer; K1 (scale 1.0, the window, the
   shared layers over their source's cache) was launched by it;
20. vlm: Qwen3-VL-2B at full size, its vision tower and a 448-pixel
   image's chat prefill in float32 on the card against the CPU, then bf16
   ``generate`` with the image and with a 4-frame video, decode blocks as
   graphs against eager (K3 for the prefill, K1); Gemma3-4B, image chat in
   bf16 against float32 on the CPU at 6 of 34 text and 4 of 27 SigLIP
   layers, then the whole model in bf16, its fresh prefill launching K2
   with the image block's segments on every layer (K1 for decode);
   PaddleOCR-VL at full size, ``recognize`` of a synthetic 560x420 page in
   float32 on the card against the CPU (K3, K1). Each model's vision
   tower, prefill and decode step are timed, and the device's idle share
   logged;
21. audio: Qwen3-ASR-0.6B whole (``AuTConfig()`` and Qwen3-0.6B, bench.py's
   workload: 20 s of a seeded synthetic waveform, 64 tokens), random weights
   under the names the ``map_*`` functions read: the log-mel, the tower's
   features and the spliced prefill's logits in float32 on the card against
   the CPU, and 64 greedy tokens; then bf16: ``generate`` in decode blocks
   of 16 steps, each block one graph replay (counted), against the eager
   blocks; a WAV upload at 16 kHz and one at 8 kHz (the resample route) to
   /v1/audio/transcriptions of ``build_app(Server(None, asr=...))``, each
   text equal to ``Qwen3AsrAdapter.transcribe``'s; the tower's, the
   prefill's and a block's times and ``generate``'s xRT. Qwen2-Audio-7B
   (transformers' ``Qwen2AudioEncoderConfig()`` encoder, the published text
   shapes): its first 4 encoder and 4 text layers in float32 against the
   CPU (the padded log-mel, the tower, the prefill logits, 16 tokens),
   then the whole model in bf16 (K3 and K1 at 32 / 32 heads of 128; each
   greedy step one graph replay, counted; tokens against the eager steps).
   Whisper large-v3 (a 4 + 4-layer float32 check against the CPU, then
   bf16 whole) and Moonshine tiny (float32 whole, then bf16): encoder
   states, greedy ids, every decoder step one graph replay (counted)
   against the eager steps, the encoder's and a step's times. The native
   VAD net over 10 s: probabilities on the card within 1e-5 of the CPU's,
   identical segments. K1 and K3 were launched by the Qwen3-ASR and the
   Qwen2-Audio paths;
22. tts: Qwen3-TTS at bench.py:399-451's 0.6B-class widths (QWEN3_TTS),
   random weights under the names ``map_talker_weights`` reads, the codec
   head and the code predictor's heads scaled by TTS_PEAK so that sampled
   codes are comparable between runs; the speech decoder, its reference
   encoder and ECAPA at their released shapes. Float32 with the talker cut
   to 4 of 28 layers on the card against the CPU: the prefill, the first
   code-0 logits, 16 frames of codes (equal or tied), the decoder's audio
   of them with cuDNN's TF32 off, ECAPA's x-vector and the reference
   encoder's codes of a 3-s reference. Then bf16 whole: the prefill, a
   16-frame block as one graph replay against eager, the RTF of 64 frames,
   a streaming chunk's decode, a voice-clone loop (one replay a frame),
   and over HTTP (``build_app(Server(None, tts=...))``, frames capped at
   50) a WAV equal to the direct synthesis and a streamed request (time to
   the first PCM chunk). CSM-1B (``CsmConfig()``'s published shapes, Mimi
   at ``MimiConfig()``): float32 with the backbone cut to 4 of 16 layers
   against the CPU (codes, Mimi's audio), then bf16 whole: 24 greedy
   frames, each frame (31 depth recomputes and the backbone step) one
   graph replay against eager, Mimi's decode and the RTF, a voice clone
   through ``audio_context``, and a 2044-id prompt whose 8 frames run past
   the backbone's 2048 rope positions. K1 and K3 were launched by both
   paths; the rows at the predictor's and the depth decoder's shapes
   (check_tts_kernels: K3 at S=2 and K1 over a 32-slot cache with 16 / 8
   heads of 64, K3 at S=32 over 32 slots with 8 / 2 of 128) read their
   path's launches;
23. voxtral: Voxtral-4B TTS at full width (``VoxtralConfig()``: backbone 26
   x 3072 with 32 / 8 heads of 96, acoustic transformer 3 x 3072, codec 8
   layers of 1024; 3.79 B parameters drawn in bf16 on the card), a random
   voice of 32 rows and 30 text ids. Float32 with the backbone cut to 2 of
   26 layers against the CPU: the prefill's last hidden, 4 frames from the
   same noise, teacher-forced with the CPU's codes (semantic logits,
   flow-matched latents, codes equal or tied), the codec's audio (TF32
   off), 1- and 2-frame decodes (the reflect pad as long as the input) and
   the chunked decode against the whole. Then bf16 whole: 64 frames in
   blocks of 16, each block one graph replay, against the eager blocks
   (codes equal), the RTF, a run stopped by END_AUDIO inside a block, the
   codec's ms, the idle share, the ``VoxtralTts`` SDK adapter with the
   stand-in tokenizer. No kernel takes heads of 96: the path's plain
   attention routes must be exactly the backbone's (26 a prefill, 26 a
   frame) and it launches no kernel;
24. kokoro: Kokoro's native net at ``KokoroNetConfig()`` on bench.py's 96
   phoneme ids, float32 card against CPU (features, durations, waveform),
   the synthesis RTF; ``KokoroTts`` end to end through the copied G2P over
   two 510-codepoint chunks;
25. ocr: the native DB detector and SVTR/CTC recognizer at their defaults
   over a synthetic 6623-symbol dictionary and a synthetic page at the
   960-pixel limit, float32 card against CPU (the probability map, the
   regions, the CTC logits, ``PaddleOcrPipeline.recognize``'s regions and
   texts); the nets' ms. Kokoro and OCR launch no kernel;
26. tp (after paths): tensor and data parallelism on meshes of the one
   card (``make_mesh(dp, tp, ["cuda:0"] * n)``), each run against the
   unsharded port on the card (the tie rule in bf16, F32_REL_L2 in
   float32) with every kernel launched once a shard where the unsharded
   run launched it once: Qwen3-0.6B at tp=2 (a 300-token prefill, 64
   greedy tokens, the float32 prefill's logits, the decode step's time
   beside the unsharded one), the engine at dp=2 x tp=2 over phase 5's
   greedy mix on an fp and an int8 cache (graph decode blocks), one
   /generate request to a tp=2 engine over HTTP; Qwen3.5-0.8B at tp=2
   (K7 and K2 per shard); Qwen3-Next-80B-A3B at tp=2, expert parallel,
   its depth cut to 4 layers (the unsharded model shares the card), its
   bf16 and float32 tokens and float32 logits; the
   train step of Qwen3-0.6B in float32 at dp=2 x tp=2 (B=4, S=512, three
   AdamW steps with remat: losses and first-step gradients against the
   unsharded steps, remat against none, attention on the plain route);
   the rows at the per-shard heads (check_tp_kernels: 8 / 4 of 128, 4 / 1
   and 8 / 1 of 256, K7 at 8 value heads) read the tp paths' launches.

Where two paths' greedy tokens part (graphs against eager, speculative
against plain, HTTP against ``engine.submit``, the GGUF model on the card
against the CPU), the first difference must be a tie on the reference path's
own state: its step is replayed over the cache it left, must choose its
token again, and the other token must lie within LOGIT_TIE of it. The TTS
phase rebuilds a frame's logits outside the frame's body for that rule
(``tts_frame_logits``, ``csm_frame_logits``); each is held once a path
against the body's own codes at frames 0 and 1 (``frame_logits_hold``).

Decode blocks run as CUDA graphs on every path; ``graphs.eager()`` gives
the eager loop they are held against. The decode-step lines time both in
this one process, 4 blocks of 8 steps each. Each phase logs its seconds.

Every model path (dense, quantized, hybrid, fuse, sp, the three once-unrun
paths, lfm2, moe, gemma3n, the three vision-language models, Qwen3-ASR,
Qwen2-Audio, Qwen3-TTS, CSM, Kokoro and OCR) must route no attention call
to a plain version, and Voxtral's exactly its backbone's (Gemma 3n's
prefill attention, the vision and audio towers' and Whisper's and
Moonshine's decoders' are plain by design, as in crane_tpu, and not
routed). ``[profile]`` lines split a chunk's, a prefill's
and a decode step's kernel time by kernel family (K1-K7, cuBLAS, aten copy,
elementwise, reduce, index) and name the largest kernels; the decode steps
(bf16 and w4 kv4 at B=1 and B=8 after 300 tokens, and B=1 after 16,000)
also give their wall time on the host clock and the device's idle share,
eager and as graphs.

Every kernel row carries its time beside its plain version's, the library
call's where one PyTorch call computes the same function
(``F.scaled_dot_product_attention`` for K1-K3,
``aten._scaled_dot_product_efficient_attention`` with its log-sum-exp for
K1-S and K3-S, ``torch._weight_int8pack_mm`` for K6 w8 and
``torch._weight_int4pack_mm`` for w4, each where the build has it and it
agrees with the plain version) with ``ms_over_library``, and its bound:
the least time for the bytes it must move at 3.35 TB/s or its operations at
the peak of their type, whichever is larger. K3-S's row also carries its
no-stats launch's time on the same inputs.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero,
and so does a run with no CUDA device, or outside a checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(HERE, "crane_tpu_torch")):
    sys.exit("chip_smoke.py runs from the root of a crane-tpu checkout")
sys.path.insert(0, HERE)

# the kernel bound: a bf16 kernel against its plain version on the same inputs
from crane_tpu_torch.ops.cuda.build import KERNEL_ATOL, KERNEL_RTOL  # noqa: E402

# a float32 kernel against its plain version: the same float32 sums in
# another order, with __expf (as tests/test_torch_cuda.py holds them)
F32_RTOL = 1e-4
F32_ATOL = 1e-5

# K7 against the plain scan: y is written in v's dtype (bf16 here), so it is
# held to the kernel bound above; the final state stays float32 in both and
# differs only by the order of float32 sums over a few hundred steps of a
# contractive update (the chunkwise route's 3xTF32 products are float32 to
# about 2^-21), so it is held to STATE_ATOL + STATE_RTOL * |plain|.
STATE_RTOL = 1e-4
STATE_ATOL = 1e-4

# model check: the card against float32 on the CPU, same weights.
# Activations round to bf16 (2**-9 relative) at every op of 28 layers, so
# the last-token logits may drift by a few percent of their spread: the
# relative L2 error must stay under LOGIT_REL_L2, and the greedy top-1 must
# agree unless the CPU's top two logits lie within LOGIT_TIE of each other
# (then either token is a correct greedy choice within the error bound).
LOGIT_REL_L2 = 5e-2
LOGIT_TIE = 0.05

# Where a path's greedy tokens part from a reference path's (CUDA graphs
# against the eager loop, speculative against plain decoding), the first
# difference must be a tie on the state the reference path itself wrote
# (ties_on_reference_state): the step that chose the reference's token,
# replayed over that path's cache, chooses it again, and the other token
# lies within LOGIT_TIE of it, on every cache.

# the with-stats kernels' softmax max m and sum l against their plain
# versions, where the plain row saw a slot (l > 0): float32 sums of the same
# logits in another order, with __expf
STATS_RTOL = 1e-5
STATS_ATOL = 1e-5

# sequence parallelism on one card, float32: the sp run against the
# unsharded port differs only by the order of the float32 softmax sums
# (the merge), so the logits agree to SP_REL_L2 (by KV cache bits: None
# for an fp cache) and every greedy token is the same unless the unsharded
# run's top two logits lie within SP_TIE. A quantized cache adds a step: a
# key or value that differs by a float32 rounding can round to the
# neighbouring code, which moves it by a whole code step (its row's amax /
# 127 in int8, amax / 7 in int4), and the next layers carry that on; the
# codes that differ between the runs are counted and logged. int4's limit
# is 1e-3 for that reason (the first run read 1.18e-4 at the prefill).
SP_REL_L2 = {None: 1e-4, 8: 1e-4, 4: 1e-3}
SP_TIE = 1e-3

# the card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, dense):
# HBM bytes/s, and FLOP/s by the type the operations are done in (bf16 on
# the tensor cores; float32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


# the source of K4's instances at each cache bit width (the C entries are in
# the int8 one)
K4_SOURCE = {8: "quant_decode_attention.cu", 4: "quant_decode_attention_int4.cu"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# device cycles the card waits before a timed run (about 2.5 ms), so the host
# has enqueued the launches before the first starts: the events then time
# them back to back, not the host's rate of issuing a wrapper's launch (tens
# of microseconds, as long as K5's or K6's kernel)
BACKLOG_CYCLES = 5_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after a warm-up, the launches queued behind a device-side wait."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(BACKLOG_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL) -> float:
    """max |got - ref|, raising unless every element is finite and within
    atol + rtol * |ref| (by default the kernel bound above)."""
    import torch

    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3g} over the bound")
    return err.max().item()


def bound(nbytes: float, flops: float, peak: str = "bf16") -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` operations of type ``peak``, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_work(B, S, Hq, Hkv, D, pairs, kv_rows, kv_bytes, index_bytes, stats=False,
              q_bytes=2):
    """(bytes, FLOPs) of an attention call: q read and out written
    (``q_bytes`` each, 2 in bf16), ``kv_rows`` token rows of K and V read at
    ``kv_bytes`` a token and kv-head (2 D in bf16, 4 D in float32; D or D/2
    codes plus a 4-byte scale quantized), the indices, and with stats m and
    l written (float32); ``pairs`` (query row, visible key) pairs summed over
    the batch, 4 D FLOPs each per query head (q.k and p.v)."""
    nbytes = 2 * B * S * Hq * D * q_bytes + 2 * kv_rows * Hkv * kv_bytes + index_bytes
    if stats:
        nbytes += 2 * B * Hq * S * 4
    return nbytes, 4 * Hq * D * pairs


def kv_token_bytes(D: int, bits: int) -> int:
    """Bytes of one token and kv-head of K (or V) as the cache stores it
    (``bits`` 32: float32)."""
    if bits in (16, 32):
        return bits // 8 * D
    return (D if bits == 8 else D // 2) + 4


def decode_work(q, Hkv, valid, bits=16, stats=False):
    """attn_work of a decode call over the live lengths ``valid``."""
    B, _, Hq, D = q.shape
    live = int(valid.clamp(min=0).sum())
    return attn_work(B, 1, Hq, Hkv, D, live, live, kv_token_bytes(D, bits), 4 * B, stats)


def chunk_work(q, Hkv, T, pos, bits=16, stats=False):
    """attn_work of a continuation chunk at ``pos [B, S]`` over a T-slot
    buffer: each row sees ``min(p, T - 1) + 1`` keys (none below 0), and
    each batch row reads the keys of its furthest query."""
    B, S, Hq, D = q.shape
    seen = (pos.clamp(max=T - 1) + 1).clamp(min=0)
    return attn_work(B, S, Hq, Hkv, D, int(seen.sum()), int(seen.amax(dim=1).sum()),
                     kv_token_bytes(D, bits), 4 * B * S, stats, q_bytes=q.element_size())


def sdpa(q, k, v, mask=None, causal=False):
    """The library yardstick of K1-K3 (timed only, never used by the
    port): PyTorch's fused attention over ``[B, S, H, D]`` layouts, with a
    boolean mask (or causal) and grouped KV heads."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=causal, enable_gqa=True)


def decode_mask(valid, T):
    import torch

    return (torch.arange(T, device=valid.device)[None] < valid[:, None])[:, None, None]


def chunk_mask(pos, T):
    import torch

    t = torch.arange(T, device=pos.device)
    return (t[None, None] <= pos.clamp(max=T - 1)[:, :, None])[:, None]


def timed_row(name, src, replaces, errs, kernel_fn, plain_fn, shape, work, library_fn=None,
              peak="bf16", iters=20) -> dict:
    """The kernel's JSON row: its worst error over the cases, its time
    beside the plain version's (and the library call's, where one computes
    the same function) at ``shape``, taken in turns so drift hits all alike,
    and its bound from ``work`` = (bytes, FLOPs) of that call."""
    ms, plain_ms, library_ms = paired_ms(kernel_fn, plain_fn, library_fn, iters)
    bound_ms, bound_by = bound(*work, peak=peak)
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    log("kernels", f"{name}: max|err| {max(errs):.3g} (bound {KERNEL_ATOL:g} + 2^-6*|ref|), "
                   f"{ms:.4f} ms vs plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms "
                   f"({bound_by}) at {shape}")
    row = {"name": name, "route": "cuda", "source": f"crane_tpu_torch/csrc/{src}",
           "replaces": replaces, "launches": 0, "max_abs_err": max(errs),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    if library_ms is not None:
        row["ms_over_library"] = ms / library_ms
    return row


def paired_ms(kernel_fn, plain_fn, library_fn=None, iters=20):
    """(kernel ms, plain ms, library ms or None), each the mean of two
    timings taken in turns plain, kernel, [library, library,] kernel, plain."""
    order = [plain_fn, kernel_fn] + ([library_fn] * 2 if library_fn else []) + [kernel_fn, plain_fn]
    t = [cuda_ms(f, iters) for f in order]
    library_ms = (t[2] + t[3]) / 2 if library_fn else None
    return (t[1] + t[-2]) / 2, (t[0] + t[-1]) / 2, library_ms


def check_kernels() -> list[dict]:
    """Phase 3: K1-K3 against their plain versions in bf16 at the dense
    path's shapes (Hq=16, Hkv=8, D=128, plus D=64), with the ragged cases
    (a 300-token prefill of two rows, a two-row chunk at other offsets with
    a tail past the buffer). K2 and K3 in bf16 run the tensor-core kernel;
    their float32 route (the CUDA-core kernel) is checked and timed beside
    it. Returns the JSON rows, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    Hq, Hkv = 16, 8
    # K2: fresh prefill, S=1024, with each option
    errs = []
    for D in (64, 128):
        q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
        seg = torch.zeros(1, 1024, dtype=torch.int32, device="cuda")
        seg[0, 100:356] = 1
        seg[0, 700:760] = 2
        for label, seg_arg, kw in (("plain", None, {}), ("window=256", None, {"window": 256}),
                                   ("softcap=30", None, {"softcap": 30.0}),
                                   ("segments", seg, {})):
            got = k23.flash_attention_causal(q, k, v, seg_arg, scale=D ** -0.5, **kw)
            ref = k23.flash_attention_causal_plain(q, k, v, seg_arg, scale=D ** -0.5, **kw)
            errs.append(compare(f"K2 D={D} {label}", got, ref))
        errs += ragged_k2(rnd, Hq, Hkv, D)
    check_float32_route(q, k, v, "B=1 S=1024 Hq=16 Hkv=8 D=128")
    rows = [timed_row("flash_attention_causal", "flash_attention_mma.cu",
                      "crane_tpu/ops/pallas/flash_attention.py:187", errs,
                      lambda: k23.flash_attention_causal(q, k, v, scale=D ** -0.5),
                      lambda: k23.flash_attention_causal_plain(q, k, v, scale=D ** -0.5),
                      "B=1 S=1024 Hq=16 Hkv=8 D=128",
                      attn_work(1, 1024, Hq, Hkv, D, 1024 * 1025 // 2, 1024, 2 * D, 0),
                      lambda: sdpa(q, k, v, causal=True))]

    # K3: a 256-token chunk at offsets 0, 512 and 1000 of a T=2048 buffer
    errs = []
    for D in (64, 128):
        kc, vc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D)
        for off in (0, 512, 1000):
            q = rnd(1, 256, Hq, D)
            pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None].contiguous()
            got = k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5)
            ref = k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5)
            errs.append(compare(f"K3 D={D} offset={off}", got, ref))
        errs += ragged_k3(rnd, Hq, Hkv, D)
    errs += slot_k3(rnd, Hq, Hkv)
    check_float32_route(q, kc, vc, "B=1 S=256 at offset 1000, T=2048, Hq=16 Hkv=8 D=128", pos)
    rows.append(timed_row("flash_attention_cached", "flash_attention_mma.cu",
                          "crane_tpu/ops/pallas/flash_attention.py:384", errs,
                          lambda: k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5),
                          lambda: k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5),
                          "B=1 S=256 at offset 1000, T=2048, Hq=16 Hkv=8 D=128",
                          chunk_work(q, Hkv, 2048, pos),
                          lambda: sdpa(q, kc, vc, mask=chunk_mask(pos, 2048))))

    # K1: B=8 rows over T=2048, ragged kv_valid including 0 and T
    errs = []
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    for D in (64, 128):
        q = rnd(8, 1, Hq, D)
        kc, vc = rnd(8, 2048, Hkv, D), rnd(8, 2048, Hkv, D)
        for label, kw in (("plain", {}), ("window=256", {"window": 256}),
                          ("softcap=30", {"logit_softcap": 30.0})):
            got = k1.fp_decode_attention(q, kc, vc, valid, scale=D ** -0.5, **kw)
            ref = k1.fp_decode_attention_plain(q, kc, vc, valid, scale=D ** -0.5, **kw)
            errs.append(compare(f"K1 D={D} {label}", got, ref))
    rows.append(timed_row("fp_decode_attention", "decode_attention.cu",
                          "crane_tpu/ops/pallas/quant_attention.py:266", errs,
                          lambda: k1.fp_decode_attention(q, kc, vc, valid, scale=D ** -0.5),
                          lambda: k1.fp_decode_attention_plain(q, kc, vc, valid, scale=D ** -0.5),
                          "B=8 T=2048 ragged kv_valid, Hq=16 Hkv=8 D=128",
                          decode_work(q, Hkv, valid),
                          lambda: sdpa(q, kc, vc, mask=decode_mask(valid, 2048))))
    return rows


def ragged_k2(rnd, Hq, Hkv, D) -> list[float]:
    """K2 on a 300-token prefill of two rows (a ragged last row and key
    tile), with a window of 7 (inside one 16-row mma tile), a softcap and
    segments reaching above the diagonal. Returns the errors."""
    import torch

    from crane_tpu_torch.ops.cuda import flash_attention as k23

    q, k, v = rnd(2, 300, Hq, D), rnd(2, 300, Hkv, D), rnd(2, 300, Hkv, D)
    seg = torch.zeros(2, 300, dtype=torch.int32, device="cuda")
    seg[1, 40:290] = 3
    errs = []
    for label, seg_arg, kw in (("", None, {}), (" window=7", None, {"window": 7}),
                               (" softcap=30", None, {"softcap": 30.0}),
                               (" segments", seg, {})):
        errs.append(compare(f"K2 B=2 S=300 D={D}{label}",
                            k23.flash_attention_causal(q, k, v, seg_arg, scale=D ** -0.5, **kw),
                            k23.flash_attention_causal_plain(q, k, v, seg_arg, scale=D ** -0.5,
                                                             **kw)))
    return errs


def ragged_k3(rnd, Hq, Hkv, D) -> list[float]:
    """K3 on a 300-token chunk of two rows at other offsets of a 2048-slot
    buffer, the second running past its end (clamped to T - 1), plain and
    with a window of 7. Returns the errors."""
    import torch

    from crane_tpu_torch.ops.cuda import flash_attention as k23

    kc, vc = rnd(2, 2048, Hkv, D), rnd(2, 2048, Hkv, D)
    q = rnd(2, 300, Hq, D)
    pos = torch.stack([torch.arange(300) + 37, torch.arange(300) + 1900]).to("cuda", torch.int32)
    errs = []
    for label, kw in (("", {}), (" window=7", {"window": 7})):
        errs.append(compare(f"K3 B=2 S=300 offsets 37/1900 D={D}{label}",
                            k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5, **kw),
                            k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5,
                                                             **kw)))
    return errs


def slot_k3(rnd, Hq, Hkv, slots=16, T=4096, S=256, D=128) -> list[float]:
    """K3 as the engine's prefill graphs launch it: a batch-1 chunk over the
    cache row that ``kv_rows`` names on the device (chat's 16-row, 4096-slot
    cache), rows 0 and last at offsets 0, 1000 and T - S, against its plain
    version and bitwise against K3 on the row's view; then its float32
    route. Returns the errors."""
    import torch

    from crane_tpu_torch.ops.cuda import flash_attention as k23

    kc, vc = rnd(slots, T, Hkv, D), rnd(slots, T, Hkv, D)
    q = rnd(1, S, Hq, D)
    errs = []
    for slot in (0, slots - 1):
        rows = torch.tensor([slot], dtype=torch.int32, device="cuda")
        for off in (0, 1000, T - S):
            pos = (torch.arange(S, dtype=torch.int32, device="cuda") + off)[None].contiguous()
            got = k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5, kv_rows=rows)
            label = f"K3 kv_rows=[{slot}] of {slots} offset={off}"
            errs.append(compare(label, got, k23.flash_attention_cached_plain(
                q, kc, vc, pos, scale=D ** -0.5, kv_rows=rows)))
            view = k23.flash_attention_cached(q, kc[slot:slot + 1], vc[slot:slot + 1], pos,
                                              scale=D ** -0.5)
            if not torch.equal(got, view):
                raise AssertionError(f"{label}: differs from K3 on the row's view")
    check_float32_route(q, kc, vc, f"B=1 S={S} at offset {T - S} of row {slots - 1} "
                        f"(kv_rows), {slots} rows of T={T}, Hq={Hq} Hkv={Hkv} D={D}", pos,
                        kv_rows=rows)
    return errs


def check_float32_route(q, k, v, shape, pos=None, kv_rows=None) -> None:
    """The float32 route of K2 (``pos`` None) or K3 (maybe over the rows
    ``kv_rows`` names), the CUDA-core kernel that float32 runs take (the
    float32 checks of phases 8 and 10): held to the float32 tolerance
    against its plain version, timed beside it."""
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    q, k, v = q.float(), k.float(), v.float()
    kw = {} if kv_rows is None else {"kv_rows": kv_rows}
    scale = q.shape[-1] ** -0.5
    if pos is None:
        def kernel():
            return k23.flash_attention_causal(q, k, v, scale=scale)

        def plain():
            return k23.flash_attention_causal_plain(q, k, v, scale=scale)
    else:
        def kernel():
            return k23.flash_attention_cached(q, k, v, pos, scale=scale, **kw)

        def plain():
            return k23.flash_attention_cached_plain(q, k, v, pos, scale=scale, **kw)
    err = compare(f"{'K2' if pos is None else 'K3'} float32 {shape}", kernel(), plain(),
                  rtol=F32_RTOL, atol=F32_ATOL)
    ms, plain_ms, _ = paired_ms(kernel, plain)
    B, S, Hq, D = q.shape
    work = (attn_work(B, S, Hq, k.shape[2], D, B * S * (S + 1) // 2, B * S, 4 * D, 0, q_bytes=4)
            if pos is None else chunk_work(q, k.shape[2], k.shape[1], pos, bits=32))
    bound_ms, bound_by = bound(*work, peak="f32")
    log("kernels", f"{'K2' if pos is None else 'K3'} float32 route (CUDA cores): max|err| "
                   f"{err:.3g}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                   f"({bound_by}, float32 outside the tensor cores) at {shape}")


# kv_valid of the decode kernels' cases: ragged, with an empty and a full row
RAGGED_VALID = [0, 1, 17, 300, 1000, 1500, 2047, 2048]
# (in, out) of Qwen3-0.6B's quantized linears: q, k/v, o, gate/up, down, and
# the int4 head over the vocabulary padded to a multiple of 512
LINEAR_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
                 (1024, 152064)]


def check_quant_kernels() -> list[dict]:
    """Phase 3, quantized half: K6 (w8, w4) at M in {1, 8, 256} on every
    quantized linear of the path, K4 and K5 (kv8, kv4) at D in {64, 128,
    256} with a window and a softcap. Each kernel is held against its plain
    version computed in float32 from the same codes; it is timed against
    the plain version in bf16, the path's dtype, and K6 w8 against
    ``torch._weight_int8pack_mm`` where this build has a CUDA kernel for it.
    One JSON row per kernel and bit width, and one per K4/K5 bit width at
    head_dim 256 (their launches: the wrapper's count on the quantized path,
    which runs them at 128), launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache
    from crane_tpu_torch.ops.linear import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows = []
    for bits in (8, 4):
        errs = []
        for I, O in LINEAR_SHAPES:
            w = quantize_weight(rnd(I, O) * I ** -0.5, bits=bits)
            for M in (1, 8, 256):
                x = rnd(M, I).to(torch.bfloat16)
                got = quant_matmul(x, w.codes, w.scales, bits=bits)
                ref = quant_matmul_plain(x.float(), w.codes, w.scales, bits=bits)
                errs.append(compare(f"K6 w{bits} M={M} I={I} O={O}", got, ref))
                if I == 1024 and O in (3072, 152064) and M in (1, 8):
                    t = [cuda_ms(f) for f in (
                        lambda: quant_matmul_plain(x, w.codes, w.scales, bits=bits),
                        lambda: quant_matmul(x, w.codes, w.scales, bits=bits))]
                    log("kernels", f"K6 w{bits} M={M} I={I} O={O}: {t[1]:.4f} ms vs plain {t[0]:.4f} ms")
        rows.append(k6_row(bits, 8, rnd, errs, "M=8 I=1024 O=3072 (gate/up at 8 slots)"))
        rows.append(k6_row(bits, 256, rnd, errs, "M=256 I=1024 O=3072 (gate/up of a 256-token "
                                                 "chunk)"))

    kws = (("plain", {}), ("window=256", {"window": 256}), ("softcap=30", {"logit_softcap": 30.0}))
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    for bits in (8, 4):
        dec_errs, chunk_errs = [], []
        # head_dim 256 (Qwen3.5's 8/2 heads) first: the rows are timed at
        # the last shape, D=128 with Qwen3-0.6B's 16/8 heads
        for D, Hq, Hkv in ((256, 8, 2), (64, 16, 8), (128, 16, 8)):
            cache = QuantLayerKVCache.empty(8, 2048, Hkv, D, bits=bits, device="cuda")
            kf, vf = rnd(8, 2048, Hkv, D).to(torch.bfloat16), rnd(8, 2048, Hkv, D).to(torch.bfloat16)
            cache.update(kf, vf, 0)
            ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
            row = cache.row(3)
            row_ops = (row.k, row.v, row.k_scale, row.v_scale)
            qd = rnd(8, 1, Hq, D).to(torch.bfloat16)
            qc = rnd(1, 256, Hq, D).to(torch.bfloat16)
            for label, kw in kws:
                got = k45.quant_decode_attention(qd, *ops, valid, bits=bits, scale=D ** -0.5, **kw)
                ref = k45.quant_decode_attention_plain(qd.float(), *ops, valid, bits=bits,
                                                       scale=D ** -0.5, **kw)
                dec_errs.append(compare(f"K4 kv{bits} D={D} {label}", got, ref))
                for off in (0, 512, 1000):
                    pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None]
                    got = k45.quant_cached_attention(qc, *row_ops, pos, bits=bits,
                                                     scale=D ** -0.5, **kw)
                    ref = k45.quant_cached_attention_plain(qc.float(), *row_ops, pos, bits=bits,
                                                           scale=D ** -0.5, **kw)
                    chunk_errs.append(compare(f"K5 kv{bits} D={D} offset={off} {label}", got, ref))
            if D == 256:
                rows.append(timed_row(
                    f"quant_decode_attention[kv{bits}]" + D256, K4_SOURCE[bits],
                    "crane_tpu/ops/pallas/quant_attention.py:367", dec_errs,
                    lambda: k45.quant_decode_attention(qd, *ops, valid, bits=bits,
                                                       scale=D ** -0.5),
                    lambda: k45.quant_decode_attention_plain(qd, *ops, valid, bits=bits,
                                                             scale=D ** -0.5),
                    "B=8 T=2048 ragged kv_valid, Hq=8 Hkv=2 D=256",
                    decode_work(qd, Hkv, valid, bits)))
                rows.append(timed_row(
                    f"quant_cached_attention[kv{bits}]" + D256, "quant_cached_attention_mma.cu",
                    "crane_tpu/ops/pallas/quant_attention.py:647", chunk_errs,
                    lambda: k45.quant_cached_attention(qc, *row_ops, pos, bits=bits,
                                                       scale=D ** -0.5),
                    lambda: k45.quant_cached_attention_plain(qc, *row_ops, pos, bits=bits,
                                                             scale=D ** -0.5),
                    "B=1 S=256 at offset 1000, T=2048, Hq=8 Hkv=2 D=256",
                    chunk_work(qc, Hkv, 2048, pos, bits)))
                k3_yardstick(rows[-1], qc, row_ops, kf[3:4], vf[3:4], pos, bits)
        rows.append(timed_row(
            f"quant_decode_attention[kv{bits}]", K4_SOURCE[bits],
            "crane_tpu/ops/pallas/quant_attention.py:367", dec_errs,
            lambda: k45.quant_decode_attention(qd, *ops, valid, bits=bits, scale=D ** -0.5),
            lambda: k45.quant_decode_attention_plain(qd, *ops, valid, bits=bits, scale=D ** -0.5),
            "B=8 T=2048 ragged kv_valid, Hq=16 Hkv=8 D=128", decode_work(qd, Hkv, valid, bits)))
        rows.append(timed_row(
            f"quant_cached_attention[kv{bits}]", "quant_cached_attention_mma.cu",
            "crane_tpu/ops/pallas/quant_attention.py:647", chunk_errs,
            lambda: k45.quant_cached_attention(qc, *row_ops, pos, bits=bits, scale=D ** -0.5),
            lambda: k45.quant_cached_attention_plain(qc, *row_ops, pos, bits=bits,
                                                     scale=D ** -0.5),
            "B=1 S=256 at offset 1000, T=2048, Hq=16 Hkv=8 D=128",
            chunk_work(qc, Hkv, 2048, pos, bits)))
        k3_yardstick(rows[-1], qc, row_ops, kf[3:4], vf[3:4], pos, bits)
    return rows


VERIFY = "[B8-S9]"  # a verify chunk: 8 slots of spec_k + 1 = 9 rows
M72, M9 = "[M72]", "[M9]"  # a verify forward's rows: 8 slots x 9, and generate's 9


def check_verify_kernels() -> list[dict]:
    """Phase 3, verify shapes: K3 (bf16) and K5 (kv8, kv4) at a speculative
    verify chunk, B=8 rows of S=9 at a different start on each row over
    2048-slot rows (one row ending at the last slot, one at slot 0),
    Qwen3-0.6B's heads (16 on 8, D=128); K6 (w8, w4) at M=72 (eight slots'
    verify) and M=9 (generate's) on gate/up (I=1024, O=3072). Each against
    its plain version (the quantized ones computed in float32 on the same
    codes); rows for K3, K5 kv4, and K6 w4 at both M (the verify shapes the
    spec phase launches), launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache
    from crane_tpu_torch.ops.linear import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(99)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    B, S, T, Hq, Hkv, D = 8, 9, 2048, 16, 8, 128
    starts = torch.tensor([T - S, 0, 17, 300, 640, 1000, 1500, 1999], device="cuda")
    pos = (starts[:, None] + torch.arange(S, device="cuda")[None]).to(torch.int32)
    q = rnd(B, S, Hq, D).to(torch.bfloat16)
    k, v = rnd(B, T, Hkv, D).to(torch.bfloat16), rnd(B, T, Hkv, D).to(torch.bfloat16)
    shape = "B=8 S=9 at ragged starts (one ending at T-1), T=2048, Hq=16 Hkv=8 D=128"
    errs = [compare("K3 verify chunk", k23.flash_attention_cached(q, k, v, pos, scale=D ** -0.5),
                    k23.flash_attention_cached_plain(q, k, v, pos, scale=D ** -0.5))]
    rows = [timed_row("flash_attention_cached" + VERIFY, "flash_attention_mma.cu",
                      "crane_tpu/ops/pallas/flash_attention.py:384", errs,
                      lambda: k23.flash_attention_cached(q, k, v, pos, scale=D ** -0.5),
                      lambda: k23.flash_attention_cached_plain(q, k, v, pos, scale=D ** -0.5),
                      shape, chunk_work(q, Hkv, T, pos),
                      lambda: sdpa(q, k, v, mask=chunk_mask(pos, T)))]
    for bits in (8, 4):
        cache = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device="cuda")
        cache.update(k, v, 0)
        ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        errs = [compare(f"K5 kv{bits} verify chunk",
                        k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5),
                        k45.quant_cached_attention_plain(q.float(), *ops, pos, bits=bits,
                                                         scale=D ** -0.5))]
        if bits == 4:
            rows.append(timed_row(
                f"quant_cached_attention[kv{bits}]" + VERIFY, "quant_cached_attention_mma.cu",
                "crane_tpu/ops/pallas/quant_attention.py:647", errs,
                lambda: k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5),
                lambda: k45.quant_cached_attention_plain(q, *ops, pos, bits=bits,
                                                         scale=D ** -0.5),
                shape, chunk_work(q, Hkv, T, pos, bits)))
    for bits in (8, 4):
        w = quantize_weight(rnd(1024, 3072) * 1024 ** -0.5, bits=bits)
        for M, tag in ((72, M72), (9, M9)):
            x = rnd(M, 1024).to(torch.bfloat16)
            errs = [compare(f"K6 w{bits} M={M}", quant_matmul(x, w.codes, w.scales, bits=bits),
                            quant_matmul_plain(x.float(), w.codes, w.scales, bits=bits))]
            if bits == 4:
                library = int4pack_mm(x, w)
                rows.append(timed_row(
                    f"quant_matmul[w{bits}]" + tag, "quant_matmul_mma.cu",
                    "crane_tpu/ops/pallas/quant_matmul.py:115", errs,
                    lambda: quant_matmul(x, w.codes, w.scales, bits=bits),
                    lambda: quant_matmul_plain(x, w.codes, w.scales, bits=bits),
                    f"M={M} I=1024 O=3072 (gate/up of a verify forward)",
                    (M * 1024 * 2 + 1024 * 3072 * bits // 8 + 3072 * 4 + M * 3072 * 2,
                     2 * M * 1024 * 3072), library))
    return rows


def k3_yardstick(row, q, ops, k, v, pos, bits) -> None:
    """K5's yardstick: K3 in bf16 on the same chunk over the bf16 K/V that
    were quantized into ``ops``, timed in turns with K5 in this call (the
    same tile loop over rows as stored instead of unpacked codes)."""
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda import quant_attention as k45

    scale = q.shape[-1] ** -0.5
    ms, k3_ms, _ = paired_ms(lambda: k45.quant_cached_attention(q, *ops, pos, bits=bits,
                                                                scale=scale),
                             lambda: k23.flash_attention_cached(q, k, v, pos, scale=scale))
    row["k3_bf16_ms"] = k3_ms
    row["ms_over_k3"] = ms / k3_ms
    log("kernels", f"{row['name']}: {ms:.4f} ms vs K3 in bf16 on the same chunk {k3_ms:.4f} ms "
                   f"({ms / k3_ms:.2f}x)")


# a K6 row at M=256 carries this suffix: read_launches reads the wrapper's
# count (the chunk's K6 launches run at M=256)
M256 = "[M256]"


def k6_row(bits, M, rnd, errs, shape) -> dict:
    """K6's JSON row at M rows of gate/up (I=1024, O=3072), timed against
    the plain version and the library call (``int4pack_mm`` /
    ``int8pack_mm``) where one computes the same function. At M=256 the
    down projection (I=3072, O=1024) is timed too, and the tensor cores'
    ceiling at both shapes (bf16 ``torch.mm`` over the weight dequantized
    once; another function, so it is logged and kept out of library_ms)."""
    import torch

    from crane_tpu_torch.ops.cuda.quant_matmul import (
        MMA_MIN_M,
        quant_matmul,
        quant_matmul_plain,
    )
    from crane_tpu_torch.ops.linear import quantize_weight

    def case(I, O):
        w = quantize_weight(rnd(I, O) * I ** -0.5, bits=bits)
        x = rnd(M, I).to(torch.bfloat16)
        work = (M * I * 2 + I * O * bits // 8 + O * 4 + M * O * 2, 2 * M * I * O)
        return w, x, work

    w, x, work = case(1024, 3072)
    library = int4pack_mm(x, w) if bits == 4 else int8pack_mm(x, w)
    row = timed_row(f"quant_matmul[w{bits}]" + ("" if M == 8 else M256),
                    "quant_matmul.cu" if M < MMA_MIN_M else "quant_matmul_mma.cu",
                    "crane_tpu/ops/pallas/quant_matmul.py:" + ("102" if bits == 8 else "115"),
                    errs, lambda: quant_matmul(x, w.codes, w.scales, bits=bits),
                    lambda: quant_matmul_plain(x, w.codes, w.scales, bits=bits), shape, work,
                    library)
    if M == 8:
        return row
    dense = w.dequant(torch.float32).to(torch.bfloat16)
    row["dense_mm_ms"] = cuda_ms(lambda: torch.mm(x, dense))
    wd, xd, work = case(3072, 1024)
    dense_d = wd.dequant(torch.float32).to(torch.bfloat16)
    ms, plain_ms, mm_ms = paired_ms(lambda: quant_matmul(xd, wd.codes, wd.scales, bits=bits),
                                    lambda: quant_matmul_plain(xd, wd.codes, wd.scales, bits=bits),
                                    lambda: torch.mm(xd, dense_d))
    bound_ms, _ = bound(*work)
    row.update(down_ms=ms, down_plain_ms=plain_ms, down_bound_ms=bound_ms, down_dense_mm_ms=mm_ms)
    log("kernels", f"K6 w{bits} M={M}: bf16 torch.mm over the dequantized weight (the tensor "
                   f"cores' ceiling, not the same function) {row['dense_mm_ms']:.4f} ms at "
                   f"I=1024 O=3072; down projection I=3072 O=1024: {ms:.4f} ms vs plain "
                   f"{plain_ms:.4f} ms, torch.mm {mm_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return row


def int8pack_mm(x, w):
    """K6 w8's library yardstick (timed only, never used by the port):
    ``torch._weight_int8pack_mm`` on the codes as ``[O, I]`` and the scales
    in x's dtype, where this build registers a CUDA kernel for it (checked
    against the plain version first); else None, and the log says so."""
    import torch

    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        log("kernels", "K6 w8: this torch build has no CUDA kernel for "
                       "aten::_weight_int8pack_mm; no library time")
        return None
    codes_t = w.codes.t().contiguous()
    scales = w.scales.reshape(-1).to(x.dtype)

    def fn():
        return torch._weight_int8pack_mm(x, codes_t, scales)

    return checked_library("w8", "_weight_int8pack_mm", fn, x, w, 8)


def int4pack_mm(x, w):
    """K6 w4's library yardstick (timed only, never used by the port):
    ``torch._weight_int4pack_mm``, whose weight is unsigned 4-bit q with
    ``(q - 8) * scale + zero`` per group: q = code + 8, the column's scale
    repeated over 256-row groups, zero 0, so it computes ``(x @ codes) *
    scales``. Where this build registers a CUDA kernel and the call agrees
    with the plain version; else None, and the log says why."""
    import torch

    from crane_tpu_torch.ops.linear import unpack_int4_rows

    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int4pack_mm", "CUDA"):
        log("kernels", "K6 w4: this torch build has no CUDA kernel for "
                       "aten::_weight_int4pack_mm; no library time")
        return None
    I, O = 2 * w.codes.shape[0], w.codes.shape[1]
    group = 256
    q = (unpack_int4_rows(w.codes).to(torch.int32) + 8).t().contiguous()  # [O, I] in 0..15
    try:
        packed = torch._convert_weight_to_int4pack(
            (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    except RuntimeError as e:
        log("kernels", f"K6 w4: _convert_weight_to_int4pack refused the codes ({e}); "
                       f"no library time")
        return None
    scales = w.scales.reshape(1, O, 1).expand(I // group, O, 1)
    scale_zeros = torch.cat([scales, torch.zeros_like(scales)], dim=2).to(x.dtype).contiguous()

    def fn():
        return torch._weight_int4pack_mm(x, packed, group, scale_zeros)

    return checked_library("w4", "_weight_int4pack_mm", fn, x, w, 4)


def checked_library(variant, op, fn, x, w, bits):
    """``fn`` where it computes K6's function within the kernel bound of the
    plain version (the library rounds the scale to bf16, so it may not);
    else None, logged with the error."""
    from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul_plain

    try:
        err = compare(f"K6 {variant} library call ({op})", fn(),
                      quant_matmul_plain(x.float(), w.codes, w.scales, bits=bits))
    except (AssertionError, RuntimeError) as e:
        log("kernels", f"K6 {variant} at M={x.shape[0]}: {op} does not give the same function "
                       f"here ({e}); no library time")
        return None
    log("kernels", f"K6 {variant} library call {op} computes the same function at "
                   f"M={x.shape[0]}: max|err| {err:.3g}")
    return fn


# the head_dim 256 rows of K1-K3 count the launches of the hybrid path,
# under the wrapper's own counter
D256 = "[D256]"


def check_d256_kernels() -> list[dict]:
    """Phase 3, head_dim 256: K2, K3 and K1 in bf16 with Qwen3.5's 8 query
    and 2 KV heads (G = 4), with each option, at the shapes of the hybrid
    path (a 1024-token prefill, 256-token chunks into a 2048-slot row, 8
    ragged decode rows), and K2/K3's ragged cases and float32 route as in
    check_kernels. One JSON row each, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    gen = torch.Generator(device="cuda").manual_seed(2560)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    Hq, Hkv, D = 8, 2, 256
    scale = D ** -0.5
    q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
    seg = torch.zeros(1, 1024, dtype=torch.int32, device="cuda")
    seg[0, 100:356] = 1
    errs = []
    for label, seg_arg, kw in (("plain", None, {}), ("window=256", None, {"window": 256}),
                               ("softcap=30", None, {"softcap": 30.0}), ("segments", seg, {})):
        errs.append(compare(f"K2 D=256 {label}",
                            k23.flash_attention_causal(q, k, v, seg_arg, scale=scale, **kw),
                            k23.flash_attention_causal_plain(q, k, v, seg_arg, scale=scale, **kw)))
    errs += ragged_k2(rnd, Hq, Hkv, D)
    check_float32_route(q, k, v, "B=1 S=1024 Hq=8 Hkv=2 D=256")
    rows = [timed_row("flash_attention_causal" + D256, "flash_attention_mma.cu",
                      "crane_tpu/ops/pallas/flash_attention.py:187", errs,
                      lambda: k23.flash_attention_causal(q, k, v, scale=scale),
                      lambda: k23.flash_attention_causal_plain(q, k, v, scale=scale),
                      "B=1 S=1024 Hq=8 Hkv=2 D=256",
                      attn_work(1, 1024, Hq, Hkv, D, 1024 * 1025 // 2, 1024, 2 * D, 0),
                      lambda: sdpa(q, k, v, causal=True))]

    errs = []
    kc, vc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D)
    for off in (0, 512, 1000):
        qc = rnd(1, 256, Hq, D)
        pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None].contiguous()
        for label, kw in (("plain", {}), ("window=256", {"window": 256})):
            errs.append(compare(f"K3 D=256 offset={off} {label}",
                                k23.flash_attention_cached(qc, kc, vc, pos, scale=scale, **kw),
                                k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale,
                                                                 **kw)))
    errs += ragged_k3(rnd, Hq, Hkv, D)
    check_float32_route(qc, kc, vc, "B=1 S=256 at offset 1000, T=2048, Hq=8 Hkv=2 D=256", pos)
    rows.append(timed_row("flash_attention_cached" + D256, "flash_attention_mma.cu",
                          "crane_tpu/ops/pallas/flash_attention.py:384", errs,
                          lambda: k23.flash_attention_cached(qc, kc, vc, pos, scale=scale),
                          lambda: k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale),
                          "B=1 S=256 at offset 1000, T=2048, Hq=8 Hkv=2 D=256",
                          chunk_work(qc, Hkv, 2048, pos),
                          lambda: sdpa(qc, kc, vc, mask=chunk_mask(pos, 2048))))

    errs = []
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    qd = rnd(8, 1, Hq, D)
    kc, vc = rnd(8, 2048, Hkv, D), rnd(8, 2048, Hkv, D)
    for label, kw in (("plain", {}), ("window=256", {"window": 256}),
                      ("softcap=30", {"logit_softcap": 30.0})):
        errs.append(compare(f"K1 D=256 {label}",
                            k1.fp_decode_attention(qd, kc, vc, valid, scale=scale, **kw),
                            k1.fp_decode_attention_plain(qd, kc, vc, valid, scale=scale, **kw)))
    rows.append(timed_row("fp_decode_attention" + D256, "decode_attention.cu",
                          "crane_tpu/ops/pallas/quant_attention.py:266", errs,
                          lambda: k1.fp_decode_attention(qd, kc, vc, valid, scale=scale),
                          lambda: k1.fp_decode_attention_plain(qd, kc, vc, valid, scale=scale),
                          "B=8 T=2048 ragged kv_valid, Hq=8 Hkv=2 D=256",
                          decode_work(qd, Hkv, valid),
                          lambda: sdpa(qd, kc, vc, mask=decode_mask(valid, 2048))))
    return rows


# the one-stream decode rows: one row of 16,000 live tokens in a 16,384-slot
# cache (the split route); each row's name carries this suffix, and
# read_launches reads the wrapper's count on the row's path
LONG = "[B1-16K]"
LONG_T, LONG_LIVE = 16384, 16000


def check_long_decode() -> dict[str, list[dict]]:
    """Phase 3, one stream at a long context: K1 (Qwen3-0.6B's 16/8 heads of
    128 and Qwen3.5-0.8B's 8/2 of 256), K4 (kv8, kv4, at both) and K1-S/K4-S
    (16/8 heads) in bf16 over one row of LONG_LIVE live tokens in a
    LONG_T-slot cache, where the decode kernels split each kv-head's range
    over many blocks (decode_splits, logged); a window of 1000 across the
    splits is checked too. Each against its plain version (K4 on the same
    codes in float32), timed beside it and, for K1, SDPA (K1-S: the
    efficient-attention call with its log-sum-exp, stats_library). Returns
    the JSON rows by the path whose launches they read: dense (K1 at 128),
    hybrid (K1 at 256), quantized (K4) and sp (the -S forms)."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache

    gen = torch.Generator(device="cuda").manual_seed(16000)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = {"dense": [], "hybrid": [], "quantized": [], "sp": []}
    valid = torch.tensor([LONG_LIVE], dtype=torch.int32, device="cuda")
    for D, Hq, Hkv in ((128, 16, 8), (256, 8, 2)):
        scale = D ** -0.5
        d256 = D256 if D == 256 else ""
        shape = f"B=1 T={LONG_T} live {LONG_LIVE}, Hq={Hq} Hkv={Hkv} D={D}"
        q, k, v = rnd(1, 1, Hq, D), rnd(1, LONG_T, Hkv, D), rnd(1, LONG_T, Hkv, D)
        splits = {bits: k1.decode_split_count(q, Hkv, LONG_T, bits) for bits in (16, 8, 4)}
        if min(splits.values()) <= 1:
            raise AssertionError(f"{shape}: the decode kernels did not split ({splits})")
        log("kernels", f"{shape}: n_split by cache bits {json.dumps(splits)} on "
                       f"{k1.sm_count(0)} SMs (Hkv = {Hkv} blocks a split)")
        errs = [compare(f"K1 {shape}{label}",
                        k1.fp_decode_attention(q, k, v, valid, scale=scale, **kw),
                        k1.fp_decode_attention_plain(q, k, v, valid, scale=scale, **kw))
                for label, kw in (("", {}), (" window=1000", {"window": 1000}))]
        rows["dense" if D == 128 else "hybrid"].append(timed_row(
            "fp_decode_attention" + d256 + LONG, "decode_attention.cu",
            "crane_tpu/ops/pallas/quant_attention.py:266", errs,
            lambda: k1.fp_decode_attention(q, k, v, valid, scale=scale),
            lambda: k1.fp_decode_attention_plain(q, k, v, valid, scale=scale), shape,
            decode_work(q, Hkv, valid), lambda: sdpa(q, k, v, mask=decode_mask(valid, LONG_T))))
        if D == 128:
            got = k1.fp_decode_attention_with_stats(q, k, v, valid, scale=scale)
            ref = k1.fp_decode_attention_with_stats_plain(q, k, v, valid, scale=scale)
            err = check_with_stats(f"K1-S {shape}", got, ref,
                                   k1.fp_decode_attention(q, k, v, valid, scale=scale))
            visible = (torch.arange(LONG_T, device="cuda")[None] < valid[:, None])[:, None]
            rows["sp"].append(timed_row(
                "fp_decode_attention_with_stats" + LONG, "decode_attention.cu",
                "crane_tpu/ops/pallas/quant_attention.py:266", [err],
                lambda: k1.fp_decode_attention_with_stats(q, k, v, valid, scale=scale),
                lambda: k1.fp_decode_attention_with_stats_plain(q, k, v, valid, scale=scale),
                shape, decode_work(q, Hkv, valid, stats=True),
                stats_library(f"K1-S {shape}", q, k, v, visible, ref)))
        for bits in (8, 4):
            cache = QuantLayerKVCache.empty(1, LONG_T, Hkv, D, bits=bits, device="cuda")
            cache.update(k, v, 0)
            ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
            errs = [compare(f"K4 kv{bits} {shape}{label}",
                            k45.quant_decode_attention(q, *ops, valid, bits=bits, scale=scale,
                                                       **kw),
                            k45.quant_decode_attention_plain(q.float(), *ops, valid, bits=bits,
                                                             scale=scale, **kw))
                    for label, kw in (("", {}), (" window=1000", {"window": 1000}))]
            rows["quantized"].append(timed_row(
                f"quant_decode_attention[kv{bits}]" + d256 + LONG, K4_SOURCE[bits],
                "crane_tpu/ops/pallas/quant_attention.py:367", errs,
                lambda: k45.quant_decode_attention(q, *ops, valid, bits=bits, scale=scale),
                lambda: k45.quant_decode_attention_plain(q, *ops, valid, bits=bits, scale=scale),
                shape, decode_work(q, Hkv, valid, bits)))
            if D == 128:
                got = k45.quant_decode_attention_with_stats(q, *ops, valid, bits=bits,
                                                            scale=scale)
                ref = k45.quant_decode_attention_with_stats_plain(q.float(), *ops, valid,
                                                                  bits=bits, scale=scale)
                err = check_with_stats(f"K4-S kv{bits} {shape}", got, ref,
                                       k45.quant_decode_attention(q, *ops, valid, bits=bits,
                                                                  scale=scale))
                rows["sp"].append(timed_row(
                    f"quant_decode_attention_with_stats[kv{bits}]" + LONG,
                    K4_SOURCE[bits], "crane_tpu/ops/pallas/quant_attention.py:367",
                    [err], lambda: k45.quant_decode_attention_with_stats(
                        q, *ops, valid, bits=bits, scale=scale),
                    lambda: k45.quant_decode_attention_with_stats_plain(
                        q, *ops, valid, bits=bits, scale=scale),
                    shape, decode_work(q, Hkv, valid, bits, stats=True)))
    return rows


# K7's cases: (B, S) at H=16, K=V=128 (Qwen3.5-0.8B's GDN heads), bf16 q, k,
# v: S on both sides of the chunk (64) and of the route threshold (128)
GDN_CASES = ((1, 1), (1, 64), (1, 65), (1, 128), (1, 256), (1, 300), (1, 1000),
             (8, 64), (8, 65), (8, 256))


def gdn_work(B, S, H, K, V) -> tuple[float, float]:
    """(bytes, operations) of a K7 call with bf16 q, k, v: q, k, v read and
    y written (2 bytes each), g and beta read and the final state written
    (float32); per step and head about 7 K V operations (decay, k.S, the
    rank-1 update, q.S)."""
    return (B * S * H * (2 * K + V) * 2 + 2 * B * S * H * 4 + B * S * H * V * 2
            + B * H * K * V * 4, 7 * B * S * H * K * V)


def check_gdn_kernel() -> list[dict]:
    """Phase 3, K7: both routes, the chunkwise kernels and the sequential
    scan, each forced at every GDN_CASES shape, against the plain version
    (the step-by-step recurrence), zero and random initial states at B=1:
    y to the kernel bound, the state to STATE_ATOL + STATE_RTOL |plain|. The
    route the wrapper takes is timed at each shape beside the other route,
    the plain scan and the chunked route. Returns the two JSON rows
    (launches 0): the chunkwise route timed at B=1 S=1000, the scan at B=1
    S=64 (the bucket of a 17- or 64-token prompt)."""
    import torch

    from crane_tpu_torch.ops.cuda.gdn_scan import (
        ROUTES,
        gdn_route,
        gdn_scan_plain,
        gdn_scan_route,
    )
    from crane_tpu_torch.ops.gdn import gdn_recurrence_chunked

    gen = torch.Generator(device="cuda").manual_seed(77)
    H, K, V = 16, 128, 128
    errs = {route: [] for route in ROUTES}
    rows = {}
    for B, S in GDN_CASES:
        q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for d in (K, K, V))
        g = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.5
        beta = torch.rand(B, S, H, generator=gen, device="cuda")
        inits = (None, torch.randn(B, H, K, V, generator=gen, device="cuda") * 0.3) \
            if B == 1 else (None,)
        for s0 in inits:
            yr, sr = gdn_scan_plain(q, k, v, g, beta, s0)
            for route in ROUTES:
                label = f"K7 {route} B={B} S={S} {'init state' if s0 is not None else 'zero state'}"
                y, st = gdn_scan_route(route, q, k, v, g, beta, s0)
                errs[route].append(compare(f"{label} y", y, yr))
                compare(f"{label} state", st, sr, rtol=STATE_RTOL, atol=STATE_ATOL)
        route = gdn_route(S)
        other = next(r for r in ROUTES if r != route)
        it = 2 if S >= 300 else 5  # the plain scan runs S steps of small launches
        p1, ch1, o1, k1_ms, k2_ms, o2, ch2, p2 = (
            cuda_ms(f, n, warmup=1) for f, n in (
                (lambda: gdn_scan_plain(q, k, v, g, beta), it),
                (lambda: gdn_recurrence_chunked(q, k, v, g, beta), 5),
                (lambda: gdn_scan_route(other, q, k, v, g, beta), 20),
                (lambda: gdn_scan_route(route, q, k, v, g, beta), 20),
                (lambda: gdn_scan_route(route, q, k, v, g, beta), 20),
                (lambda: gdn_scan_route(other, q, k, v, g, beta), 20),
                (lambda: gdn_recurrence_chunked(q, k, v, g, beta), 5),
                (lambda: gdn_scan_plain(q, k, v, g, beta), it)))
        ms, plain_ms, chunked_ms = (k1_ms + k2_ms) / 2, (p1 + p2) / 2, (ch1 + ch2) / 2
        bound_ms, bound_by = bound(*gdn_work(B, S, H, K, V), peak="tf32")
        f32_ms, _ = bound(*gdn_work(B, S, H, K, V), peak="f32")
        log("kernels", f"K7 B={B} S={S} H={H} K=V={K}: the {route} route {ms:.4f} ms, the "
                       f"{other} route {(o1 + o2) / 2:.4f} ms, plain {plain_ms:.4f} ms, chunked "
                       f"route {chunked_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, TF32 "
                       f"tensor-core rate), {f32_ms:.4f} ms at the float32 CUDA-core rate")
        if (B, S) in ((1, 1000), (1, 64)):
            src = "gdn_chunk.cu" if route == "chunk" else "gdn_scan.cu"
            rows[route] = {"name": f"gdn_scan[{route}]", "route": "cuda",
                           "source": f"crane_tpu_torch/csrc/{src}",
                           "replaces": "crane_tpu/ops/pallas/gdn_scan.py:126", "launches": 0,
                           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": None, "chunked_ms": chunked_ms,
                           "f32_bound_ms": f32_ms, "shape": f"B={B} S={S} H={H} K=V={K}"}
    for route in ROUTES:
        rows[route]["max_abs_err"] = max(errs[route])
        log("kernels", f"gdn_scan[{route}]: max|err| of y {max(errs[route]):.3g} (bound "
                       f"{KERNEL_ATOL:g} + 2^-6*|ref|), state within {STATE_ATOL:g} + "
                       f"{STATE_RTOL:g}*|ref| at every case")
    return [rows["chunk"], rows["scan"]]


def check_model():
    """Phase 4: full-width Qwen3-0.6B, random bf16 weights on the card."""
    import torch

    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import QWEN3_0_6B, init_params
    from crane_tpu_torch.ops.sampling import SamplingParams

    cfg = QWEN3_0_6B
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    lm = CausalLM(cfg, params, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen, device="cuda").tolist()

    # the same prefill on the card (kernels, bf16) and on the CPU (plain
    # versions, float32), on the same weights
    cache = lm.init_cache(1, 512)
    logits_gpu, _ = lm.prefill(cache, [prompt], [300])
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    lm_cpu = CausalLM(cfg, cpu_params, dtype=torch.float32)
    logits_cpu, _ = lm_cpu.prefill(lm_cpu.init_cache(1, 512), [prompt], [300])
    del lm_cpu, cpu_params
    compare_logits("model", "prefill logits card bf16 vs cpu f32", logits_gpu[0], logits_cpu[0])

    log_device_ms("Qwen3-0.6B bf16", "the 300-token prefill (bucket 512)",
                  lambda: lm.prefill(lm.init_cache(1, 512), [prompt], [300]))
    prefill_ms, decode_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("model", f"Qwen3-0.6B bf16, {cfg.num_layers} layers: prefill 300 tokens (bucket 512) "
                 f"{prefill_ms:.2f} ms, decode 63 tokens at batch 1 {decode_tps:.1f} tok/s; "
                 f"generate(64) matches")
    return lm


# Qwen3.5-0.8B's text model, as its published config.json gives it
# (huggingface.co/Qwen/Qwen3.5-0.8B, "text_config"): 24 layers as
# [gdn, gdn, gdn, full] x 6, hidden 1024, MLP 3584, 8 query / 2 KV heads of
# 256 with a sigmoid output gate and rotary on a quarter of each head
# (rot_dim 64, theta 1e7), 16 key and 16 value GDN heads of 128 with a
# 4-tap conv, vocabulary 248320, tied head, unit-offset RMSNorm (eps 1e-6).
# The text weights come to ~0.75 B parameters.
QWEN3_5_0_8B = {
    "model_type": "qwen3_5", "vocab_size": 248320, "hidden_size": 1024,
    "num_hidden_layers": 24, "num_attention_heads": 8, "num_key_value_heads": 2,
    "head_dim": 256, "intermediate_size": 3584, "rms_norm_eps": 1e-6,
    "rope_theta": 10000000.0, "partial_rotary_factor": 0.25,
    "max_position_embeddings": 262144, "tie_word_embeddings": True,
    "layer_types": (["linear_attention"] * 3 + ["full_attention"]) * 6,
    "linear_num_key_heads": 16, "linear_num_value_heads": 16,
    "linear_key_head_dim": 128, "linear_value_head_dim": 128,
    "linear_conv_kernel_dim": 4,
}


def check_hybrid_model():
    """Phase 8: full-width Qwen3.5-0.8B on the card. Random weights in the
    HF layout from a seeded generator go through map_hf_weights in bf16.

    The prefill check runs the same weights in float32 on the card and on
    the CPU. In bf16 this random-weight hybrid cannot meet LOGIT_REL_L2 on
    any device: its q and k are nearly orthogonal, so q . S cancels to a
    few hundredths of its terms and the gated RMSNorm rescales the result,
    magnifying every bf16 rounding upstream of it (on the CPU alone, bf16
    against float32 reads about 0.08 at 24 layers; the dense Qwen3-0.6B
    reads about 0.017). So the bf16 prefill's distance from the float32
    reference is measured and logged beside the CPU's own bf16 distance,
    and bf16 stays the path that generate and the engine drive."""
    import torch

    from crane_tpu_torch.models.auto import map_hf_weights, transformer_config_from_hf
    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import hf_state_dict

    cfg = transformer_config_from_hf(QWEN3_5_0_8B)
    gen = torch.Generator(device="cuda").manual_seed(35)
    params = map_hf_weights(cfg, hf_state_dict(cfg, gen, torch.bfloat16), torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    lm = CausalLM(cfg, params, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen, device="cuda").tolist()

    def prefill(model):
        return model.prefill(model.init_cache(1, 512), [prompt], [300])[0][0]

    logits_bf16 = k7_routes_launched("Qwen3.5-0.8B bf16 prefill", lambda: prefill(lm))
    logits_f32 = k7_routes_launched(
        "Qwen3.5-0.8B float32 prefill on the card",
        lambda: prefill(CausalLM(cfg, _tree(params, lambda t: t.float()), dtype=torch.float32)))
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    logits_cpu = prefill(CausalLM(cfg, cpu_params, dtype=torch.float32))
    logits_cpu_bf16 = prefill(CausalLM(cfg, _tree(params, lambda t: t.cpu()), dtype=torch.bfloat16))
    del cpu_params
    compare_logits("hybrid-model", "Qwen3.5-0.8B prefill logits card f32 vs cpu f32",
                   logits_f32, logits_cpu)
    for label, got in (("card bf16", logits_bf16), ("cpu bf16", logits_cpu_bf16)):
        rel_l2, top = logits_distance(got, logits_cpu)
        log("hybrid-model", f"Qwen3.5-0.8B prefill logits {label} vs cpu f32: rel L2 {rel_l2:.4g}, "
                            f"top-1 {top} vs {int(logits_cpu.argmax())}")

    log_device_ms("Qwen3.5-0.8B bf16", "the 300-token prefill (bucket 512)", lambda: prefill(lm))
    prefill_ms, decode_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("hybrid-model", f"Qwen3.5-0.8B bf16, {cfg.num_layers} layers ({n_params / 1e9:.3f} B "
                        f"parameters): prefill 300 tokens (bucket 512) {prefill_ms:.2f} ms, "
                        f"decode 63 tokens at batch 1 {decode_tps:.1f} tok/s; generate(64) matches")
    return lm


def k7_routes_launched(label, run):
    """Run ``run``, log the K7 launches it made by route, and fail unless
    the chunkwise route was among them. Returns what ``run`` returns."""
    from crane_tpu_torch.ops import cuda as kernels

    before = kernels.launch_counts()
    out = run()
    after = kernels.launch_counts()
    made = {r: after[f"gdn_scan[{r}]"] - before[f"gdn_scan[{r}]"] for r in ("chunk", "scan")}
    log("launches", f"{label}: K7 launches by route {json.dumps(made)}")
    if made["chunk"] <= 0:
        raise AssertionError(f"{label} never launched K7's chunkwise route")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def logits_distance(got, ref) -> tuple[float, int]:
    """(relative L2 error, greedy top-1) of finite card logits against the
    CPU reference; raises on non-finite logits or a shape mismatch."""
    import torch

    got, ref = got.float().cpu(), ref.float().cpu()
    if not torch.isfinite(got).all() or got.shape != ref.shape:
        raise AssertionError(f"card logits not finite or of shape {tuple(got.shape)}")
    return ((got - ref).norm() / ref.norm()).item(), int(got.argmax())


def compare_logits(phase: str, label: str, got, ref) -> None:
    """Card logits against the CPU float32 reference: finite, of the vocab's
    shape, relative L2 error within LOGIT_REL_L2, and the same greedy top-1
    unless the reference's top two lie within LOGIT_TIE."""
    rel_l2, _ = logits_distance(got, ref)
    got, ref = got.float().cpu(), ref.float().cpu()
    top2 = ref.topk(2)
    margin = (top2.values[0] - top2.values[1]).item()
    top_gpu, top_cpu = int(got.argmax()), int(top2.indices[0])
    tie_ok = ref[top_gpu].item() >= top2.values[0].item() - LOGIT_TIE
    log(phase, f"{label}: rel L2 {rel_l2:.4g} (limit {LOGIT_REL_L2:g}), "
               f"max|err| {(got - ref).abs().max().item():.4g}, logit std {ref.std().item():.4g}, "
               f"top-1 card {top_gpu} cpu {top_cpu}, cpu top-2 margin {margin:.4g}")
    if rel_l2 > LOGIT_REL_L2:
        raise AssertionError(f"{label}: card logits disagree with the CPU float32 reference")
    if top_gpu != top_cpu and not (margin < LOGIT_TIE and tie_ok):
        raise AssertionError(f"{label}: greedy top-1 of the card disagrees with the CPU reference")


def time_generate(lm, prompt, gen_cfg) -> tuple[float, float]:
    """The generate path's own steps, timed: prefill ms and decode tok/s at
    batch 1 (host clock, synchronised), the decode as one block of n - 1
    steps (one CUDA-graph replay; the first run captures it, the second is
    the measurement); then ``generate`` must return the same greedy
    tokens."""
    import torch

    from crane_tpu_torch.ops.sampling import SamplingParams

    n = gen_cfg.max_new_tokens
    padded = [prompt + [0] * (512 - len(prompt))]
    cache = lm.init_cache(1, 512, quant_bits=gen_cfg.kv_quant_bits)
    sp = SamplingParams.make(1, do_sample=False, device=lm.device)
    gen_dec = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):  # the second run is the measurement
        cache.lengths.zero_()  # a fresh prefill from 0: the same cache, the same graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cache, padded, [len(prompt)])
        first = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        recent = torch.full((1, 64), -1, dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        toks, _, _ = lm.decode_steps(cache, first, recent, sp, gen_dec, n - 1)
        manual = [int(first[0])] + toks[0].tolist()
        decode_s = time.perf_counter() - t0
    out = lm.generate(prompt, gen_cfg)
    if out != manual or len(out) != n or not all(0 <= t < lm.config.vocab_size for t in out):
        raise AssertionError("generate() disagrees with its own prefill + decode steps")
    return prefill_ms, (n - 1) / decode_s


def check_quant_model(lm):
    """Phase 6: the bf16 model's weights quantized in situ to int4 on the
    card (the tied head too); the same codes, with float32 scales and every
    other weight in float32, on the CPU. The 300-token prefill, card against
    CPU; then one decode step into the card's int8 and into its int4 KV
    cache after that prefill, against the same step on the CPU over a copy
    of the same cache (the KV codes are the card's: a bf16 key and its
    float32 counterpart can round to neighbouring int4 codes, which is the
    cache's quantization error, not the step's); then 64 greedy tokens
    through generate on an int4 cache."""
    import torch

    from crane_tpu_torch.models.auto import quantize_params
    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
    from crane_tpu_torch.ops.kv_cache import KVCache, QuantLayerKVCache
    from crane_tpu_torch.ops.linear import QuantizedWeight

    cfg = lm.config
    params = quantize_params(lm.params, bits=4)
    if not isinstance(params.get("lm_head"), QuantizedWeight):
        raise AssertionError("int4 ISQ did not quantize the tied head")
    lm4 = CausalLM(cfg, params, dtype=torch.bfloat16)
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    cpu4 = CausalLM(cfg, cpu_params, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen).tolist()

    caches = {}
    for kv_bits in (8, 4):  # the prefill attends its own K/V, whatever the cache
        logits_gpu, caches[kv_bits] = lm4.prefill(lm4.init_cache(1, 512, quant_bits=kv_bits),
                                                  [prompt], [300])
    logits_cpu, _ = cpu4.prefill(cpu4.init_cache(1, 512), [prompt], [300])
    compare_logits("quant-model", "int4-weight prefill logits card bf16 vs cpu f32",
                   logits_gpu[0], logits_cpu[0])

    nxt = int(logits_cpu[0].argmax())
    for kv_bits, cache in caches.items():
        cpu_cache = KVCache(
            layers=tuple(QuantLayerKVCache(k=c.k.cpu(), v=c.v.cpu(), k_scale=c.k_scale.cpu(),
                                           v_scale=c.v_scale.cpu(), bits=c.bits,
                                           n_kv_heads=c.n_kv_heads) for c in cache.layers),
            lengths=cache.lengths.cpu())
        logits = []
        for model, c in ((lm4, cache), (cpu4, cpu_cache)):
            tok = torch.tensor([[nxt]], dtype=torch.int32, device=model.device)
            hidden, _ = forward_hidden(cfg, model.params, tok, c, c.lengths, model.rope)
            logits.append(lm_logits(cfg, model.params, hidden)[0, 0])
        compare_logits("quant-model",
                       f"decode step on the int{kv_bits} KV cache card bf16 vs cpu f32", *logits)
    del cpu4, cpu_params, caches

    prefill_ms, decode_tps = time_generate(lm4, prompt, GenerationConfig.greedy(64, kv_quant_bits=4))
    log("quant-model", f"Qwen3-0.6B int4 weights on an int4 KV cache: prefill 300 tokens "
                       f"(bucket 512) {prefill_ms:.2f} ms, decode 63 tokens at batch 1 "
                       f"{decode_tps:.1f} tok/s; generate(64) matches")
    return params


def _tree(tree, fn):
    """``fn`` over every dense tensor of a parameter tree; a QuantizedWeight
    moves to the CPU with its int8 codes and float32 scales unchanged."""
    from crane_tpu_torch.ops.linear import QuantizedWeight

    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, fn) for v in tree)
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(codes=tree.codes.cpu(), scales=tree.scales.cpu(),
                               block=tree.block, bits=tree.bits)
    return fn(tree)


def check_engine(lm, phase: str = "engine", kv_quant_bits: int | None = None) -> None:
    """Phases 5, 7 and 9 (and the MoE, LFM2 and int8-hybrid paths):
    concurrent requests through the serving engine, on an fp or an int8/int4
    KV cache. A model with recurrent layers (GDN or short conv) keeps prefix
    reuse off, so the follow-up is admitted whole, in chunks."""
    import torch

    from crane_tpu_torch.serve.engine import (
        EngineRequest,
        FinishReason,
        InferenceEngine,
        SamplingOptions,
    )

    vocab = lm.config.vocab_size
    gen = torch.Generator().manual_seed(7)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    sampled = SamplingOptions(temperature=0.8, top_p=0.9, top_k=0,
                              repetition_penalty=1.1, do_sample=True)
    requests = [
        EngineRequest("p17", ids(17), 32, greedy),
        EngineRequest("p64", ids(64), 32, greedy),
        EngineRequest("p300", ids(300), 32, greedy),   # two chunks: K2 then K3 (or K5)
        EngineRequest("p1000", ids(1000), 24, greedy),  # four chunks
        EngineRequest("sampled", ids(120), 32, sampled),
    ]
    engine = InferenceEngine(lm, max_slots=8, max_seq_len=2048, prefill_chunk=256,
                             kv_quant_bits=kv_quant_bits)
    engine.warmup()
    queues = {r.request_id: engine.submit(r) for r in requests}
    results: dict[str, dict] = {rid: {"tokens": [], "reason": None} for rid in queues}
    followup = None
    t0 = time.perf_counter()
    for _ in range(20000):
        busy = engine.step()
        for rid, q in queues.items():
            while not q.empty():
                r = q.get_nowait()
                if r.error is not None:
                    raise AssertionError(f"request {rid} failed: {r.error}")
                if r.token is not None:
                    results[rid]["tokens"].append(r.token)
                if r.finished:
                    results[rid]["reason"] = r.finish_reason
        if followup is None and results["p300"]["reason"] is not None:
            # a later turn of the same conversation: the finished request's
            # prompt and output plus 300 new tokens, so the admission reuses
            # the resident prefix and continues through K3 (or K5); a hybrid
            # model admits it whole, in chunks
            prev = requests[2].prompt_ids + results["p300"]["tokens"]
            followup = EngineRequest("followup", prev + ids(300), 16, greedy)
            queues["followup"] = engine.submit(followup)
            results["followup"] = {"tokens": [], "reason": None}
        if followup is not None and not busy and engine.request_q.empty() \
                and all(r["reason"] is not None for r in results.values()):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    asked = {r.request_id: r.max_new_tokens for r in requests + [followup]}
    for rid, res in results.items():
        toks = res["tokens"]
        if res["reason"] != FinishReason.LENGTH or len(toks) != asked[rid] \
                or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{rid}: {len(toks)} of {asked[rid]} tokens, finish {res['reason']}")
    s = engine.stats
    prompt_total = sum(len(r.prompt_ids) for r in requests + [followup])
    recurrent = lm.config.has_recurrent_layers
    reuse_ok = (s.prefix_hits == s.prefix_tokens_reused == 0 and not engine.prefix_cache
                if recurrent else s.prefix_hits == 1 and s.prefix_tokens_reused >= 256)
    if not (s.requests_received == s.requests_completed == len(asked)
            and s.requests_failed == s.requests_aborted == 0
            and s.generated_tokens == sum(asked.values())
            and s.prompt_tokens == prompt_total and reuse_ok):
        raise AssertionError(f"engine stats do not reconcile: {s.snapshot()}")
    log(phase, f"{len(asked)} requests finished in {wall:.2f} s, "
               f"{s.generated_tokens} tokens; prefix reuse {s.prefix_tokens_reused} tokens; "
               f"stats {json.dumps(s.snapshot())}")


# local lengths of the sp decode rows at a 4096-token slab (Qwen3-0.6B at
# four slabs of a 16,384-token slot): ragged, with an empty slab and a full
SLAB_VALID = [0, 1, 17, 300, 1000, 2048, 4095, 4096]
# slab-local starts of the sp chunk cases (256 tokens): wholly before the
# slab, from below into it, inside it, and from inside past its end
CHUNK_STARTS = (-300, -128, 1000, 3968)


def check_with_stats(label, got, ref, no_stats) -> float:
    """A with-stats kernel's (out, m, l) against its plain version's: out to
    the kernel bound and bitwise the no-stats kernel's output; m and l to
    STATS_ATOL + STATS_RTOL |plain| where the plain row saw a slot (l > 0),
    and m = -inf, l = 0, out = 0 where it saw none. Returns max |err| of out."""
    import torch

    out, m, l = got
    r_out, r_m, r_l = ref
    if not torch.equal(out, no_stats):
        raise AssertionError(f"{label}: out differs from the no-stats kernel's")
    err = compare(f"{label} out", out, r_out)
    seen = r_l > 0
    if seen.any():  # a chunk wholly before the slab sees nothing
        compare(f"{label} m", m[seen], r_m[seen], rtol=STATS_RTOL, atol=STATS_ATOL)
        compare(f"{label} l", l[seen], r_l[seen], rtol=STATS_RTOL, atol=STATS_ATOL)
    heads = seen[..., None].transpose(1, 2) if out.shape[1] > 1 else seen[:, None, :, None]
    if (l[~seen] != 0).any() or (m[~seen] != -torch.inf).any() \
            or (out.float() * ~heads).abs().max() != 0:
        raise AssertionError(f"{label}: a row that saw no slot is not (0, -inf, 0)")
    return err


def check_stats_kernels() -> list[dict]:
    """Phase 10, kernels: K1-S (bf16 cache) and K4-S (kv8, kv4) at B=8 over a
    4096-token slab at the local lengths SLAB_VALID; K3-S and K5-S on a
    256-token chunk at each of CHUNK_STARTS, slab-local; Qwen3-0.6B's 16/8
    heads of 128. Each against its plain version and its no-stats kernel.
    One JSON row per kernel and bit width (decode timed as above, chunks at
    start 1000), launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache

    gen = torch.Generator(device="cuda").manual_seed(4096)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    B, T, Hq, Hkv, D = 8, 4096, 16, 8, 128
    scale = D ** -0.5
    k, v = rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    qd, qc = rnd(B, 1, Hq, D), rnd(1, 256, Hq, D)
    valid = torch.tensor(SLAB_VALID, dtype=torch.int32, device="cuda")
    rows = []
    for bits in (16, 8, 4):
        if bits == 16:
            ops, plain_q = (k, v, None, None), (lambda q: q)
            names = ("fp_decode_attention_with_stats", "flash_attention_cached_with_stats")
            srcs = ("decode_attention.cu", "flash_attention_mma.cu")
            lines = ("266", "647")
        else:
            cache = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device="cuda")
            cache.update(k, v, 0)
            ops, plain_q = (cache.k, cache.v, cache.k_scale, cache.v_scale), (lambda q: q.float())
            names = (f"quant_decode_attention_with_stats[kv{bits}]",
                     f"quant_cached_attention_with_stats[kv{bits}]")
            srcs = (K4_SOURCE[bits], "quant_cached_attention_mma.cu")
            lines = ("367", "647")
        row_ops = tuple(None if t is None else t[3:4] for t in ops)

        def dec_kernel():
            return k45.decode_attention_with_stats(qd, *ops, valid, bits=bits, scale=scale)

        ref = plain_with_stats(True, bits, plain_q(qd), ops, valid, scale)
        errs = [check_with_stats(f"{names[0]} B=8 T=4096", dec_kernel(), ref,
                                 no_stats_kernel(True, bits, qd, ops, valid, scale))]
        library = None
        if bits == 16:
            visible = (torch.arange(T, device="cuda")[None] < valid[:, None])[:, None]
            library = stats_library(names[0], qd, k, v, visible, ref)
        rows.append(timed_row(
            names[0], srcs[0], f"crane_tpu/ops/pallas/quant_attention.py:{lines[0]}", errs,
            dec_kernel, lambda: plain_with_stats(True, bits, plain_q(qd), ops, valid, scale),
            "B=8 slab T=4096, local lengths 0..4096, Hq=16 Hkv=8 D=128",
            decode_work(qd, Hkv, valid, bits, stats=True), library))

        errs = []
        for start in CHUNK_STARTS:
            pos = (torch.arange(256, dtype=torch.int32, device="cuda") + start)[None]
            got = k45.cached_attention_with_stats(qc, *row_ops, pos, bits=bits, scale=scale)
            ref = plain_with_stats(False, bits, plain_q(qc), row_ops, pos, scale)
            errs.append(check_with_stats(f"{names[1]} start {start}", got, ref,
                                         no_stats_kernel(False, bits, qc, row_ops, pos, scale)))
        pos = (torch.arange(256, dtype=torch.int32, device="cuda") + 1000)[None]

        def chunk_kernel():
            return k45.cached_attention_with_stats(qc, *row_ops, pos, bits=bits, scale=scale)

        library = None
        if bits == 16:
            visible = torch.arange(T, device="cuda")[None, None] <= pos.clamp(max=T - 1)[..., None]
            library = stats_library(names[1], qc, k[3:4], v[3:4], visible,
                                    plain_with_stats(False, bits, qc, row_ops, pos, scale))
        rows.append(timed_row(
            names[1], srcs[1], f"crane_tpu/ops/pallas/quant_attention.py:{lines[1]}", errs,
            chunk_kernel, lambda: plain_with_stats(False, bits, plain_q(qc), row_ops, pos, scale),
            "B=1 S=256 at slab-local 1000, slab T=4096, Hq=16 Hkv=8 D=128",
            chunk_work(qc, Hkv, T, pos, bits, stats=True), library))
        # the stats' cost: the with-stats launch against its no-stats launch on
        # the same inputs, in alternating pairs, the median of each
        with_ms, without_ms = [], []
        for i in range(STATS_PAIRS):
            pair = (chunk_kernel, lambda: no_stats_kernel(False, bits, qc, row_ops, pos, scale))
            t = [cuda_ms(f) for f in (pair if i % 2 == 0 else pair[::-1])]
            with_ms.append(t[0] if i % 2 == 0 else t[1])
            without_ms.append(t[1] if i % 2 == 0 else t[0])
        stats_ms, no_stats_ms = median(with_ms), median(without_ms)
        rows[-1]["no_stats_ms"] = no_stats_ms
        rows[-1]["ms_over_no_stats"] = stats_ms / no_stats_ms
        log("kernels", f"{names[1]}: {stats_ms:.4f} ms vs its no-stats launch {no_stats_ms:.4f} "
                       f"ms on the same inputs (medians of {STATS_PAIRS} alternating pairs)")
    return rows


# the library's log-sum-exp against the plain m + log l of a with-stats
# kernel: both float32 over the same bf16 logits, summed in other orders
LSE_RTOL = 1e-4
LSE_ATOL = 1e-4


def stats_library(label, q, k, v, visible, ref):
    """The library yardstick of K1-S and K3-S (timed only, never used by
    the port): ``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp=True``, whose log-sum-exp is m + log l. The G query
    heads of a kv-head enter as G * S query rows of that head (q reordered
    once, outside the timing), so K/V are views, never copied; ``visible
    [B, S, T]`` becomes an additive mask. Returns the call where its output
    and log-sum-exp agree with the plain with-stats ``ref`` (out to the
    kernel bound and the log-sum-exp to LSE_ATOL + LSE_RTOL |ref| where a
    row saw a slot; the library gives no defined result for a row that saw
    none), else None, logged with the reason."""
    import torch

    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * G, D)
    bias = torch.zeros(B, 1, S, T, dtype=q.dtype, device=q.device)
    bias = bias.masked_fill(~visible[:, None], -torch.inf).repeat_interleave(G, dim=2)
    bias = bias.expand(B, Hkv, S * G, T)

    def fn():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qg, k.transpose(1, 2), v.transpose(1, 2), bias, True, scale=D ** -0.5)

    try:
        out, lse = fn()[:2]
        out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)
        lse = lse[:, :, :S * G].reshape(B, Hkv, S, G).permute(0, 1, 3, 2).reshape(B, Hq, S)
        r_out, r_m, r_l = ref
        r_m, r_l = (x.reshape(B, Hq, S) for x in (r_m, r_l))
        seen = r_l > 0
        rows_seen = seen.transpose(1, 2)  # [B, S, Hq]
        err = compare(f"{label} library out", out[rows_seen], r_out[rows_seen])
        compare(f"{label} library log-sum-exp", lse[seen], (r_m + torch.log(r_l))[seen],
                rtol=LSE_RTOL, atol=LSE_ATOL)
    except (AssertionError, RuntimeError) as e:
        log("kernels", f"{label}: _scaled_dot_product_efficient_attention does not give the same "
                       f"function here ({e}); no library time")
        return None
    log("kernels", f"{label}: _scaled_dot_product_efficient_attention with compute_log_sumexp "
                   f"gives the same out (max|err| {err:.3g}) and m + log l on the rows that saw "
                   f"a slot")
    return fn


# alternating pairs timing a with-stats launch against its no-stats launch
STATS_PAIRS = 6


def median(xs):
    xs = sorted(xs)
    return (xs[len(xs) // 2] + xs[(len(xs) - 1) // 2]) / 2


def no_stats_kernel(decode: bool, bits, q, ops, idx, scale):
    """The no-stats kernel (K1 or K4 for ``decode``, else K3 or K5) on the
    same inputs as its with-stats form."""
    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda import quant_attention as k45

    if bits == 16:
        fn = k1.fp_decode_attention if decode else k23.flash_attention_cached
        return fn(q, ops[0], ops[1], idx, scale=scale)
    fn = k45.quant_decode_attention if decode else k45.quant_cached_attention
    return fn(q, *ops, idx, bits=bits, scale=scale)


def plain_with_stats(decode: bool, bits, q, ops, idx, scale):
    """The with-stats plain version of K1-S/K4-S (``decode``) or K3-S/K5-S
    on the card's tensors."""
    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda import quant_attention as k45

    if bits == 16:
        if decode:
            return k1.fp_decode_attention_with_stats_plain(q, ops[0], ops[1], idx, scale=scale)
        return k23.flash_attention_cached_with_stats_plain(q, ops[0], ops[1], idx, scale=scale)
    fn = (k45.quant_decode_attention_with_stats_plain if decode
          else k45.quant_cached_attention_with_stats_plain)
    return fn(q, *ops, idx, bits=bits, scale=scale)


def sp_greedy(model, prompt, kv_bits, steps, feed=None):
    """The float32 sp check's run of one model: a 4096-token fresh prefill
    (K2), the prompt's rest as one continuation chunk (K3 or K5; K3-S or
    K5-S on an sp model), then ``steps`` greedy decode steps, each fed the
    token ``feed`` gives (the unsharded run's) or its own. Returns (logits
    after the prefill and each step's, the cache)."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits

    cfg = model.config
    cache = model.init_cache(1, 8192, quant_bits=kv_bits)
    _, cache = model.prefill(cache, [prompt[:4096]], [4096])
    rest = prompt[4096:]
    logits, cache = model.prefill(cache, [rest + [0] * (1024 - len(rest))], [len(rest)],
                                  start=4096)
    out = [logits[0]]
    for s in range(steps):
        tok = feed[s] if feed is not None else int(out[-1].argmax())
        t = torch.tensor([[tok]], dtype=torch.int32, device=model.device)
        hidden, cache = forward_hidden(cfg, model.params, t, cache, cache.lengths, model.rope)
        out.append(lm_logits(cfg, model.params, hidden)[0, 0])
    return out, cache


def code_flips(sp_cache, cache) -> tuple[int, int]:
    """(bytes that differ, bytes) between an sp run's quantized K/V codes,
    its slabs laid end to end, and an unsharded run's, over the live
    tokens."""
    import torch

    live = int(cache.lengths[0])
    differ = total = 0
    for sp_layer, layer in zip(sp_cache.layers, cache.layers):
        for name in ("k", "v"):
            a = torch.cat([getattr(s, name) for s in sp_layer.slabs], dim=1)[:, :live]
            b = getattr(layer, name)[:, :live]
            differ += int((a != b).sum())
            total += b.numel()
    return differ, total


def compare_sp(label, got, ref, limit) -> None:
    """An sp run's logits against the unsharded run's, step by step: finite,
    relative L2 within ``limit``, and the same greedy token unless the
    unsharded top two lie within SP_TIE."""
    worst = 0.0
    for s, (g, r) in enumerate(zip(got, ref)):
        rel_l2, top = logits_distance(g, r)
        worst = max(worst, rel_l2)
        top2 = r.float().topk(2)
        if rel_l2 > limit:
            raise AssertionError(f"{label} step {s}: rel L2 {rel_l2:.3g} over {limit:g}")
        if top != int(top2.indices[0]) and (top2.values[0] - top2.values[1]).item() >= SP_TIE:
            raise AssertionError(f"{label} step {s}: greedy token {top} vs {int(top2.indices[0])}")
    log("sp", f"{label}: {len(got) - 1} steps, logits rel L2 prefill "
              f"{logits_distance(got[0], ref[0])[0]:.3g}, last step "
              f"{logits_distance(got[-1], ref[-1])[0]:.3g}, worst {worst:.3g} (limit {limit:g}); "
              f"greedy tokens agree")


def sp_engine_run(lm, prompts, phase):
    """The bf16 sp engine mix: two slots of 16,384 tokens, 256-token chunks,
    32 greedy tokens per prompt. Returns (tokens per request, decode step ms
    with both slots live afterwards)."""
    import torch

    from crane_tpu_torch.serve.engine import (
        EngineRequest,
        FinishReason,
        InferenceEngine,
        SamplingOptions,
    )

    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    engine = InferenceEngine(lm, max_slots=2, max_seq_len=16384, prefill_chunk=256)
    engine.warmup()
    queues = {rid: engine.submit(EngineRequest(rid, p, 32, greedy)) for rid, p in prompts.items()}
    toks = {rid: [] for rid in prompts}
    done = {}
    t0 = time.perf_counter()
    for _ in range(20000):
        busy = engine.step()
        for rid, q in queues.items():
            while not q.empty():
                r = q.get_nowait()
                if r.error is not None:
                    raise AssertionError(f"{phase} {rid}: {r.error}")
                if r.token is not None:
                    toks[rid].append(r.token)
                if r.finished:
                    done[rid] = r.finish_reason
        if len(done) == len(prompts) and not busy and engine.request_q.empty():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = engine.stats
    if not (all(done.get(rid) == FinishReason.LENGTH and len(toks[rid]) == 32 for rid in prompts)
            and s.requests_received == s.requests_completed == len(prompts)
            and s.requests_failed == s.requests_aborted == 0
            and s.generated_tokens == 32 * len(prompts)
            and s.prompt_tokens == sum(len(p) for p in prompts.values())):
        raise AssertionError(f"{phase}: requests or stats do not reconcile: {s.snapshot()}")
    contexts = engine.cache.lengths.tolist()
    steps = 8
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, engine.cache, engine.recent = engine.lm.decode_active(
        engine.cache, engine.cur_tokens, engine.recent, engine.sp, engine.generator,
        [True, True], steps)
    out.cpu()
    step_ms = (time.perf_counter() - t1) / steps * 1e3
    log(phase, f"{len(prompts)} requests finished in {wall:.2f} s; a decode step with both "
               f"slots live at contexts {contexts}: {step_ms:.2f} ms (host clock)")
    return toks, step_ms


def launches_per(model, label, kv_bits=None) -> dict[str, int]:
    """Log the kernels one B=1 decode step and one 256-token continuation
    chunk launch, read from the launch counters (outside any main-path
    window), and the chunk's device time (log_device_ms). Returns the
    step's launches."""
    import torch

    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.ops.sampling import SamplingParams

    ids = [i % model.config.vocab_size for i in range(1, 513)]
    cache = model.init_cache(1, 2048, quant_bits=kv_bits)
    _, cache = model.prefill(cache, [ids], [512])
    kernels.reset_launch_counts()
    model.decode_steps(cache, torch.ones(1, dtype=torch.int32, device=model.device),
                       torch.full((1, 8), -1, dtype=torch.int32, device=model.device),
                       SamplingParams.make(1, do_sample=False, device=model.device),
                       torch.Generator(device=model.device), 1)
    step = {k: n for k, n in kernels.launch_counts().items() if n}
    kernels.reset_launch_counts()
    model.prefill(cache, [ids[:256]], [256], start=513)
    chunk = {k: n for k, n in kernels.launch_counts().items() if n}
    log("launches", f"{label}: per decode step {json.dumps(step)}, "
                    f"per 256-token chunk {json.dumps(chunk)}")
    log_device_ms(label, "a 256-token chunk at 513 of a 2048-slot row",
                  lambda: model.prefill(cache, [ids[:256]], [256], start=513))
    return step


STEP_BLOCK = 8  # decode steps a timed block runs (the engine's decode_tokens_per_seq)


# (B, T, context) of log_decode_steps' decode steps: B=1 and B=8 after a
# 300-token prefill into 2048-slot rows, and B=1 after LONG_LIVE tokens in a
# LONG_T-slot row, where the decode kernels split
DECODE_SHAPES = ((1, 2048, 300), (8, 2048, 300), (1, LONG_T, LONG_LIVE))


# blocks of STEP_BLOCK steps log_decode_steps times on the host clock, by
# mode: an eager step is the host's dispatch of thousands of launches, tens
# of milliseconds, so two blocks read it as well as four
TIMED_BLOCKS = {"eager": 2, "graph": 4}


def log_decode_steps(model, label, kv_bits=None, shapes=DECODE_SHAPES,
                     modes=("eager", "graph"), distinct=False) -> dict:
    """[profile] lines of a decode step, the eager loop beside the CUDA
    graph (``modes``), in this one process: the kernels' device time by
    family (log_device_ms, over one block of STEP_BLOCK steps) and the wall
    time a step on the host clock (TIMED_BLOCKS[mode] blocks after a
    synchronize, ended by one), at each of ``shapes``. With ``distinct``
    each row has a prompt and a first token of its own (an MoE's rows then
    route to experts of their own). The device idle share is 1 - busy / wall.
    Where the profiler sees no device time inside a graph replay, the
    graph's busy time is the eager block's (the same kernels), and the line
    says so. Returns {(B, T): {mode: (wall ms, busy ms)}}."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.ops.sampling import SamplingParams

    dev = model.device
    table = {}
    V = model.config.vocab_size
    for B, T, ctx in shapes:
        rows = [[(i + (7919 * b if distinct else 0)) % V for i in range(1, ctx + 1)]
                for b in range(B)]
        _, cache = model.prefill(model.init_cache(B, T, quant_bits=kv_bits), rows, [ctx] * B)
        tokens = (torch.arange(B, dtype=torch.int32, device=dev) % V + 1 if distinct
                  else torch.ones(B, dtype=torch.int32, device=dev))
        recent = torch.full((B, 8), -1, dtype=torch.int32, device=dev)
        sp = SamplingParams.make(B, do_sample=False, device=dev)
        gen = torch.Generator(device=dev)
        what = f"a decode step at B={B} after {ctx} tokens in {T}-slot rows"
        table[(B, T)] = {}
        for mode in modes:
            def block():
                model.decode_steps(cache, tokens, recent, sp, gen, STEP_BLOCK)

            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                families = log_device_ms(label, f"{what}, {mode}, a block of {STEP_BLOCK} steps",
                                         block)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TIMED_BLOCKS[mode]):
                    block()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / (TIMED_BLOCKS[mode] * STEP_BLOCK) * 1e3
            busy = sum(families.values()) / STEP_BLOCK
            source = ""
            if not busy and mode == "graph" and "eager" in table[(B, T)]:
                busy, source = table[(B, T)]["eager"][1], " (busy: the eager block's kernels)"
            table[(B, T)][mode] = (wall, busy)
            idle = (f", device busy {busy:.4f} ms, idle {1 - busy / wall:.1%}{source}"
                    if busy else "")
            log("profile", f"{label}, {what}, {mode}: {wall:.3f} ms a step on the host "
                           f"clock{idle}; K1 + K4 "
                           f"{(families.get('K1', 0.0) + families.get('K4', 0.0)) / STEP_BLOCK:.4f}"
                           f" ms a step")
        if len(table[(B, T)]) < 2:
            del cache
            continue
        eager, graph = table[(B, T)]["eager"], table[(B, T)]["graph"]
        log("profile", f"{label}, {what}: graph {graph[0]:.3f} ms vs eager {eager[0]:.3f} ms a "
                       f"step ({eager[0] / graph[0]:.2f}x)")
        del cache
    return table


def clone_layers(layers) -> list:
    """A copy of a cache's layers (each tensor field cloned)."""
    import dataclasses

    import torch

    return [dataclasses.replace(layer, **{
        f.name: getattr(layer, f.name).clone() for f in dataclasses.fields(layer)
        if isinstance(getattr(layer, f.name), torch.Tensor)}) for layer in layers]


def replay_logits(model, layers, B, steps: dict):
    """One decode step over ``layers``, B rows of a cache as a path left
    them: row r (a key of ``steps``, mapped to its context) decodes its
    context's last token at that token's position, over the row's earlier
    K/V as they are; the other rows are inactive. Returns float32 logits
    ``[B, V]``."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
    from crane_tpu_torch.ops.kv_cache import KVCache

    dev = model.device
    toks = torch.zeros((B, 1), dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    active = torch.zeros((B,), dtype=torch.bool)
    for r, ctx in steps.items():
        toks[r, 0], pos[r], active[r] = ctx[-1], len(ctx) - 1, True
    toks, pos, active = toks.to(dev), pos.to(dev), active.to(dev)
    hidden, _ = forward_hidden(model.config, model.params, toks,
                               KVCache(layers=layers, lengths=pos.clone()), pos, model.rope,
                               active=active)
    return lm_logits(model.config, model.params, hidden)[:, 0].float()


def ties_on_reference_state(model, label, layers, B, parts: dict, bound: float) -> dict:
    """Where two paths' greedy tokens part, a tie on the reference path's
    own state. ``parts`` maps a row of the reference path's cache
    (``layers``, B rows, as that path left them) to (context, tokens,
    reference tokens): the two lists that followed the context, each token
    chosen by a decode step of the one before (the first by the context's
    prefill). Where a row's lists part, at step j, that step of the
    reference path is replayed (:func:`replay_logits`): it must choose the
    reference's token again, and the other token's logit must lie within
    ``bound`` of it. Returns {row: (j, gap)} for the rows that part."""
    steps, firsts = {}, {}
    for r, (ctx, got, ref) in parts.items():
        j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
        if j is None:
            if len(got) != len(ref):
                raise AssertionError(f"{label} row {r}: {len(got)} tokens vs {len(ref)}")
            continue
        steps[r] = list(ctx) + list(ref[:j])
        firsts[r] = (j, got[j], ref[j])
    if not steps:
        return {}
    logits = replay_logits(model, layers, B, steps)
    ties = {}
    for r, (j, got_j, ref_j) in firsts.items():
        row = logits[r]
        gap = (row[ref_j] - row[got_j]).item()
        top = int(row.argmax())
        if top != ref_j:
            raise AssertionError(f"{label} row {r}: step {j}: the replayed step chose {top}, "
                                 f"the reference path {ref_j}")
        if gap >= bound:
            raise AssertionError(f"{label} row {r}: step {j}: token {got_j} vs {ref_j}, logit "
                                 f"gap {gap:.4g} on the reference path's state is no tie "
                                 f"(bound {bound})")
        ties[r] = (j, round(gap, 4))
    return ties


def sound_shifts(model, layers, B, rows: dict, steps) -> list[float]:
    """How far two sound states of one context move a step's top-two
    margin. ``rows`` maps a row of ``layers`` (a cache as the reference
    path left it) to (prompt, tokens): the prompt's K/V written by its
    prefill, token i's at position len(prompt) + i by the decode step of
    token i + 1. At each step j of ``steps`` (2 <= j < len(tokens)) the
    step choosing token j is replayed on that state (P), then on the same
    rows with tokens 0..j-2 rewritten by one chunk (C: a verify or a
    continuation writes so, K3/K5 and K6 at M = B (j - 1)); the shift is
    |margin_P - margin_C| for P's top two. Overwrites the rows' decoded
    positions. Returns the shifts, every row at every step."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden
    from crane_tpu_torch.ops.kv_cache import KVCache

    dev = model.device
    margins = {}
    for j in steps:
        logits = replay_logits(model, layers, B, {r: p + t[:j] for r, (p, t) in rows.items()})
        top = logits.topk(2)
        margins[j] = (top.indices, top.values[:, 0] - top.values[:, 1])
    live = torch.tensor(sorted(rows), device=dev)
    active = torch.zeros((B,), dtype=torch.bool, device=dev)
    active[live] = True
    starts = torch.zeros((B,), dtype=torch.int32)
    for r, (p, _) in rows.items():
        starts[r] = len(p)
    starts = starts.to(dev)
    shifts = []
    for j in steps:
        chunk = torch.zeros((B, j - 1), dtype=torch.int32)
        for r, (_, t) in rows.items():
            chunk[r] = torch.tensor(t[:j - 1], dtype=torch.int32)
        forward_hidden(model.config, model.params, chunk.to(dev),
                       KVCache(layers=layers, lengths=starts.clone()), starts, model.rope,
                       active=active)
        logits = replay_logits(model, layers, B, {r: p + t[:j] for r, (p, t) in rows.items()})
        idx, m_p = margins[j]
        pair = logits.gather(1, idx)
        shifts += (m_p - (pair[:, 0] - pair[:, 1]))[live].abs().tolist()
    return shifts


def log_sound_shifts(label, shifts) -> None:
    """Log the shifts of :func:`sound_shifts`: how much of LOGIT_TIE two
    sound states of one context use up on this cache."""
    shifts = sorted(shifts)
    log("spec", f"{label}: sound margin shifts (decode-step vs chunk-written K/V), "
                f"{len(shifts)} steps: median {shifts[len(shifts) // 2]:.4f}, max "
                f"{shifts[-1]:.4f} (LOGIT_TIE {LOGIT_TIE})")


@contextlib.contextmanager
def verify_writes_first_row_only():
    """The control's fault: a per-row write of several tokens (a verify
    chunk's K/V) stores only its first token's, so accepted drafts leave
    their slots as they were."""
    import torch

    from crane_tpu_torch.ops.kv_cache import LayerKVCache, QuantLayerKVCache

    saved ={cls: cls.update for cls in (LayerKVCache, QuantLayerKVCache)}

    def first_row(update):
        def wrapper(self, k_new, v_new, positions, row=None):
            if isinstance(positions, torch.Tensor) and k_new.shape[1] > 1:
                k_new, v_new = k_new[:, :1], v_new[:, :1]
            return update(self, k_new, v_new, positions, row)
        return wrapper

    for cls, update in saved.items():
        cls.update = first_row(update)
    try:
        yield
    finally:
        for cls, update in saved.items():
            cls.update = update


def graph_vs_eager(model, label, kv_bits=None, B=8, T=2048, blocks=2) -> None:
    """Phase 'graphs': one served decode path's greedy tokens through CUDA
    graphs against the eager loop on the card. B rows after a ragged
    prefill (300 - 29 i tokens), every fourth row idle, ``blocks`` masked
    blocks of STEP_BLOCK steps each way. Where a row's tokens part, the
    first difference must be a tie within LOGIT_TIE on the eager loop's
    own state (:func:`ties_on_reference_state`): the two write the same
    K/V, on every cache."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.ops.sampling import SamplingParams

    dev, vocab = model.device, model.config.vocab_size
    lens = [300 - 29 * i for i in range(B)]
    rows = [[(7919 * i + 104729 * j) % vocab for j in range(n)] for i, n in enumerate(lens)]
    padded = [r + [0] * (512 - len(r)) for r in rows]

    def run(eager):
        logits, cache = model.prefill(model.init_cache(B, T, quant_bits=kv_bits), padded, lens)
        toks = logits.argmax(-1).to(torch.int32)
        first = toks.tolist()
        recent = torch.full((B, 64), -1, dtype=torch.int32, device=dev)
        sp = SamplingParams.make(B, do_sample=False, device=dev)
        active = torch.tensor([i % 4 != 3 for i in range(B)], device=dev)
        gen = torch.Generator(device=dev)
        outs = []
        with graphs.eager() if eager else contextlib.nullcontext():
            for _ in range(blocks):
                out, cache, recent = model.decode_active(cache, toks, recent, sp, gen, active,
                                                         STEP_BLOCK)
                toks = out[:, -1]
                outs.append(out)
        return first, torch.cat(outs, dim=1).cpu(), cache

    t0 = time.perf_counter()
    first, got, got_cache = run(False)
    got_len = got_cache.lengths.cpu()
    del got_cache
    _, ref, ref_cache = run(True)
    if not torch.equal(got_len, ref_cache.lengths.cpu()):
        raise AssertionError(f"graphs {label}: lengths {got_len.tolist()} vs eager "
                             f"{ref_cache.lengths.tolist()}")
    parted = ties_on_reference_state(
        model, f"graphs {label}", ref_cache.layers, B,
        {r: (rows[r] + [first[r]], got[r].tolist(), ref[r].tolist()) for r in range(B)},
        LOGIT_TIE)
    log("graphs", f"{label}: {B} rows (every fourth idle) x {blocks} blocks of {STEP_BLOCK} greedy "
                  f"steps, CUDA graphs vs the eager loop: "
                  f"{'tokens identical' if not parted else f'first differences at ties {parted}'}"
                  f"; lengths equal ({time.perf_counter() - t0:.1f} s)")


def serve_greedy(engine, prompts: dict, n: int) -> tuple[dict, float]:
    """Serve greedy requests of ``n`` tokens on a warmed engine: (tokens by
    request, wall seconds, synchronised)."""
    import torch

    from crane_tpu_torch.serve.engine import EngineRequest, FinishReason, SamplingOptions

    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queues = {rid: engine.submit(EngineRequest(rid, p, n, greedy)) for rid, p in prompts.items()}
    toks, done = {rid: [] for rid in prompts}, {}
    for _ in range(50000):
        busy = engine.step()
        for rid, q in queues.items():
            while not q.empty():
                r = q.get_nowait()
                if r.error is not None:
                    raise AssertionError(f"{rid}: {r.error}")
                if r.token is not None:
                    toks[rid].append(r.token)
                if r.finished:
                    done[rid] = r.finish_reason
        if len(done) == len(prompts) and not busy and engine.request_q.empty():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(done.get(rid) != FinishReason.LENGTH or len(toks[rid]) != n for rid in prompts):
        raise AssertionError(f"requests did not finish with {n} tokens: {done}")
    return toks, wall


def repetitive_prompts(vocab, seed, count, base=120):
    """``count`` prompts, each a random 24 + 8 i token segment repeated to
    base + 16 i tokens: prompt lookup finds n-grams to draft from."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i in range(count):
        seg = torch.randint(0, vocab, (24 + 8 * i,), generator=gen).tolist()
        out[f"r{i}"] = (seg * 16)[:base + 16 * i]
    return out


def counted_calls(obj, name, launches: dict, calls: list | None = None):
    """Wrap ``obj.name`` (an instance attribute over the method) to add each
    call's kernel launches to ``launches`` and count it in ``calls``; undo
    with ``del obj.name``."""
    from crane_tpu_torch.ops import cuda as kernels

    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        before = kernels.launch_counts()
        out = fn(*a, **kw)
        for k, v in kernels.launch_counts().items():
            if v != before[k]:
                launches[k] = launches.get(k, 0) + v - before[k]
        if calls is not None:
            calls.append(1)
        return out

    setattr(obj, name, wrapper)


def spec_generate(model, label, kv_bits=None, reference=None, n=128, calibrate=False,
                  control=False) -> dict:
    """generate(speculative="ngram") against plain greedy generate (of
    ``reference``, by default the same model) on a repetitive 180-token
    prompt: equal tokens, or a first difference at a tie on plain's own
    state (:func:`ties_on_reference_state`, LOGIT_TIE). Logs
    the tokens a weight pass (decode tokens over verify forwards) and each
    run's decode wall time a token (from the prefill's end, synchronised,
    to generate's return; the second of two runs, so no capture is timed).
    ``calibrate`` logs the sound shifts on plain's state
    (:func:`sound_shifts`); ``control`` runs speculation again with its
    verify forwards writing only their first row's K/V, which must fail the
    tie check. Returns the timed run's verify forwards' launches (M = k + 1
    = 9 rows each)."""
    import torch

    from crane_tpu_torch.models.causal_lm import GenerationConfig
    from crane_tpu_torch.utils.buckets import bucket_length

    reference = reference or model
    prompt = repetitive_prompts(model.config.vocab_size, 21, 1, base=180)["r0"]
    plain_key = (bucket_length(len(prompt) + n, floor=256), kv_bits)  # generate's cache
    prefilled = []

    def prefill_done(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            prefilled.append(time.perf_counter())
            return out
        return wrapper

    for m in {id(model): model, id(reference): reference}.values():
        m.prefill = prefill_done(m.prefill)
    try:
        for _ in range(2):
            calls, launches, runs = [], {}, {}
            counted_calls(model, "verify_step", launches, calls)
            for name, m, spec in (("plain", reference, None), ("spec", model, "ngram")):
                out = m.generate(prompt, GenerationConfig.greedy(n, kv_quant_bits=kv_bits,
                                                                 speculative=spec))
                runs[name] = (out, (time.perf_counter() - prefilled[-1]) / (len(out) - 1) * 1e3)
                if name == "plain":
                    state = clone_layers(reference._generate_caches[plain_key][0].layers)
            del model.verify_step
    finally:
        for m in (model, reference):
            m.__dict__.pop("prefill", None)
            m.__dict__.pop("verify_step", None)
    (plain, plain_ms), (spec, spec_ms) = runs["plain"], runs["spec"]
    tie = ties_on_reference_state(reference, f"spec generate {label}", state, 1,
                                  {0: (prompt, spec, plain)}, LOGIT_TIE).get(0)
    log("spec", f"{label}: generate({n}) speculative vs plain greedy: "
                f"{'tokens equal' if tie is None else f'first difference at a tie {tie}'}; "
                f"{(len(spec) - 1) / max(len(calls), 1):.3f} tokens a weight pass "
                f"({len(spec) - 1} decode tokens, {len(calls)} verify forwards); decode "
                f"{spec_ms:.3f} ms a token speculative vs {plain_ms:.3f} ms plain (host clock, "
                f"batch 1)")
    if control:
        model.release_graphs()
        with verify_writes_first_row_only():
            bad = model.generate(prompt, GenerationConfig.greedy(n, kv_quant_bits=kv_bits,
                                                                 speculative="ngram"))
        model.release_graphs()
        caught = ties_on_reference_state(reference, f"control {label}", state, 1,
                                         {0: (prompt, bad, plain)}, float("inf")).get(0)
        if caught is None or caught[1] < LOGIT_TIE:
            raise AssertionError(f"control {label}: speculation whose verify forwards write "
                                 f"only their first row's K/V passes the tie check ({caught})")
        log("spec", f"{label}: control, verify forwards that write only their first row's "
                    f"K/V: first difference {caught} is no tie, as it must not be")
    if calibrate:
        log_sound_shifts(f"{label} generate",
                         sound_shifts(reference, state, 1, {0: (prompt, plain)}, range(2, n, 4)))
    return launches


def spec_engine(model, label, kv_bits=None, reference=None, n=96, calibrate=False,
                kept=None) -> dict:
    """The 8-slot engine with speculative="ngram" on eight repetitive greedy
    prompts against the plain engine (of ``reference``, by default the same
    model): each request's tokens equal, or part at a tie on the plain
    engine's own state (LOGIT_TIE); spec_steps > 0. Logs
    tokens a weight pass (spec_tokens / spec_steps, all streams of a
    batched verify, and a stream), each engine's wall time and decode time
    a token, and the kernels the served speculative blocks launched (their
    verify forwards, 8 slots x 9 rows). ``calibrate`` measures the sound
    shifts on the plain engine's state. ``kept``, a dict, carries the plain
    engine's run (its tokens and a copy of its cache as serving left it) to
    a later call with the same reference, bits and ``n``, which serves the
    speculative engine alone. Returns those launches."""
    import torch

    from crane_tpu_torch.serve.engine import InferenceEngine

    reference = reference or model
    prompts = repetitive_prompts(model.config.vocab_size, 8, 8)
    key = (id(reference), kv_bits, n)
    # name -> (cache layers, stats, tokens, wall s, slot of each request)
    runs, launches, warm_s = {}, {}, {}
    if kept is not None and key in kept:
        runs["plain"] = kept.pop(key)
    for name, m, kw in (("plain", reference, {}), ("spec", model, {"speculative": "ngram"})):
        if name in runs:
            continue
        # every prompt fits one 256-token chunk: the chunk only bounds the
        # prefill buckets a graph-taking model captures at warmup
        engine = InferenceEngine(m, max_slots=8, max_seq_len=2048, prefill_chunk=256,
                                 kv_quant_bits=kv_bits, **kw)
        t0 = time.perf_counter()
        engine.warmup()
        warm_s[name] = f"{time.perf_counter() - t0:.2f} s"
        slots, emit = {}, engine._emit

        def emit_noting_slot(seq, token, slots=slots, emit=emit):
            slots[seq.request_id] = seq.slot
            return emit(seq, token)

        engine._emit = emit_noting_slot
        if name == "spec":
            counted_calls(m, "spec_rounds", launches)
            spec_k = engine.spec_k
        try:
            toks, wall = serve_greedy(engine, prompts, n)
        finally:
            m.__dict__.pop("spec_rounds", None)
        runs[name] = (engine.cache.layers, engine.stats, toks, wall, slots)
        if name == "plain" and kept is not None:
            kept[key] = (clone_layers(engine.cache.layers), engine.stats, toks, wall, slots)
        del engine
    (plain_layers, plain_stats, ref_toks, plain_wall, at) = runs["plain"]
    (_, s, got_toks, spec_wall, _) = runs["spec"]
    by_slot = {at[rid]: rid for rid in prompts}
    ties = ties_on_reference_state(
        reference, f"spec engine {label}", plain_layers, 8,
        {at[rid]: (p, got_toks[rid], ref_toks[rid]) for rid, p in prompts.items()},
        LOGIT_TIE)
    ties = {by_slot[r]: tie for r, tie in ties.items()}
    if s.spec_steps <= 0:
        raise AssertionError(f"spec engine {label}: no speculative block ran")
    tokens = 8 * n
    log("spec", f"{label}: 8-slot engine, 8 greedy requests x {n} tokens, speculative vs plain: "
                f"{'tokens equal' if not ties else f'first differences at ties {ties}'}; "
                f"spec_steps {s.spec_steps}, spec_tokens {s.spec_tokens}: "
                f"{s.spec_tokens / s.spec_steps:.3f} tokens a weight pass over the batch, "
                f"{s.spec_tokens / s.spec_steps / 8:.3f} a stream; wall {spec_wall:.3f} s vs "
                f"{plain_wall:.3f} s plain ({spec_wall / tokens * 1e3:.3f} vs "
                f"{plain_wall / tokens * 1e3:.3f} ms a token); decode time "
                f"{s.decode_time_s / tokens * 1e3:.3f} vs "
                f"{plain_stats.decode_time_s / tokens * 1e3:.3f} ms a token (host clock); "
                f"warmup {warm_s['spec']} vs {warm_s.get('plain', 'the kept run')} plain")
    log("launches", f"spec {label}: the served speculative blocks ({s.spec_steps} verify "
                    f"forwards of 8 x {spec_k + 1} rows) launched {json.dumps(launches)}")
    attention = ("flash_attention_cached_with_stats" if getattr(model, "mesh", None) and
                 kv_bits is None else "flash_attention_cached" if kv_bits is None else
                 f"quant_cached_attention[kv{kv_bits}]")
    if launches.get(attention, 0) <= 0:
        raise AssertionError(f"spec {label}: the verify forwards never launched {attention}")
    if calibrate:
        log_sound_shifts(f"{label} engine",
                         sound_shifts(reference, plain_layers, 8,
                                      {at[rid]: (p, ref_toks[rid]) for rid, p in prompts.items()},
                                      range(2, n, 3)))
    del runs, plain_layers
    torch.cuda.synchronize()
    return launches


def check_spec(lm, lm4, rows: list[dict]) -> None:
    """Phase 'spec': speculative decoding on full-width Qwen3-0.6B, bf16 and
    w4 kv4 (spec_generate, spec_engine), and in four sequence slabs on the
    card (the bf16 engine against the unsharded plain engine, and generate
    on an int8 cache). The sound shifts are logged once for each cache (the
    bf16 and w4 kv4 engines, the int8 generate), and the w4 kv4 generate
    runs the control. ``rows`` (the verify-shape rows) get
    the launches of the verify forwards alone: K3 and K5 kv4 at 8 slots x 9
    rows and K6 w4 at M=72 from the served speculative blocks, K6 w4 at M=9
    from generate's verify forwards."""
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm

    reset_counts()
    spec_generate(lm, "Qwen3-0.6B bf16")
    kept = {}  # the bf16 plain engine's run, the 4-slab engine's reference too
    bf16_blocks = spec_engine(lm, "Qwen3-0.6B bf16", calibrate=True, kept=kept)
    lm.release_graphs()
    w4_verify = spec_generate(lm4, "Qwen3-0.6B w4 kv4", 4, control=True)
    w4_blocks = spec_engine(lm4, "Qwen3-0.6B w4 kv4", 4, calibrate=True)
    lm4.release_graphs()
    slm = sp_shard_lm(lm, make_sp_mesh(4, ["cuda:0"] * 4))
    spec_engine(slm, "Qwen3-0.6B bf16, 4 slabs", None, reference=lm, kept=kept)
    spec_generate(slm, "Qwen3-0.6B bf16 on an int8 cache, 4 slabs", 8, reference=lm,
                  calibrate=True)
    slm.release_graphs()
    lm.release_graphs()
    counts = kernels.launch_counts()
    log("launches", f"spec path: {json.dumps(counts)}")
    for name in ("flash_attention_cached_with_stats", "quant_cached_attention_with_stats[kv8]"):
        if counts[name] <= 0:
            raise AssertionError(f"the sp verify forwards never launched {name}")
    verify = {"flash_attention_cached" + VERIFY: bf16_blocks.get("flash_attention_cached", 0),
              "quant_cached_attention[kv4]" + VERIFY: w4_blocks.get("quant_cached_attention[kv4]",
                                                                    0),
              "quant_matmul[w4]" + M72: w4_blocks.get("quant_matmul[w4]", 0),
              "quant_matmul[w4]" + M9: w4_verify.get("quant_matmul[w4]", 0)}
    for row in rows:
        row["launches"] = verify[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched by a verify forward")
    no_plain_routes("spec path")


# ── phases 'http' and 'gguf': the server over HTTP, and a GGUF file ──────

class StandInTokenizer:
    """The smoke run's tokenizer (the machine with the card has none): pure
    Python, and invertible on ids. Each id decodes to the word ``t<id>``
    after a space, so text from the server maps back to its ids exactly
    (:meth:`ids`); a word of that form encodes to its id, any other word to
    a fixed id of its characters. ``apply_chat_template`` writes a
    ``role: content`` line a message, then ``assistant:``."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        out = []
        for w in text.split():
            if w[0] == "t" and w[1:].isdigit() and int(w[1:]) < self.vocab:
                out.append(int(w[1:]))
            else:
                out.append(sum((i + 1) * ord(c) for i, c in enumerate(w)) % self.vocab)
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(f" t{int(i)}" for i in ids)

    def apply_chat_template(self, messages, tools=None, add_generation_prompt=True, **kw) -> str:
        text = "".join(f"{m['role']}: {m['content']}\n" for m in messages)
        return text + ("assistant:" if add_generation_prompt else "")

    @staticmethod
    def ids(text: str) -> list[int]:
        return [int(w[1:]) for w in text.split()]


def http_json(port: int, method: str, path: str, body=None) -> tuple[int, dict]:
    """One request to the server on 127.0.0.1:``port``: (status, JSON body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def http_stream(port: int, path: str, body: dict, hang_up_after: int | None = None,
                on_event=None) -> dict:
    """A streamed request: its SSE events, the seconds from sending it to
    the first ``data:`` line (host clock), and whether ``[DONE]`` came.
    ``hang_up_after`` events, the client closes its socket mid-stream;
    ``on_event`` is called after each event."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    events, t_first, done = [], None, False
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200 or not r.getheader("Content-Type", "").startswith("text/event-stream"):
            raise AssertionError(f"{path}: status {r.status}, {r.read()[:300]!r}")
        while line := r.readline():
            if not line.startswith(b"data: "):
                continue
            if t_first is None:
                t_first = time.perf_counter() - t0
            if line.strip() == b"data: [DONE]":
                done = True
                break
            events.append(json.loads(line[6:]))
            if on_event is not None:
                on_event()
            if hang_up_after is not None and len(events) >= hang_up_after:
                break
    finally:
        conn.close()
    return {"events": events, "t_first": t_first, "done": done,
            "wall": time.perf_counter() - t0}


def chat_text(events) -> str:
    return "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events if e.get("choices"))


def wait_stats(port: int, cond, what: str, timeout: float = 60.0) -> dict:
    """Poll /v1/stats until ``cond(stats)``; fail after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while True:
        _, stats = http_json(port, "GET", "/v1/stats")
        if cond(stats):
            return stats
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: /v1/stats never showed it: {stats}")
        time.sleep(0.05)


def check_engine_prompts(vocab: int) -> tuple[dict, list[int]]:
    """check_engine's greedy prompts ({rid: (ids, max new tokens)}) and the
    300 ids its follow-up appends, drawn from its generator in its order."""
    import torch

    gen = torch.Generator().manual_seed(7)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    prompts = {"p17": (ids(17), 32), "p64": (ids(64), 32), "p300": (ids(300), 32),
               "p1000": (ids(1000), 24)}
    ids(120)  # check_engine's sampled request, not sent here
    return prompts, ids(300)


def slot_rows(layers, slot: int) -> list:
    """A copy of one slot's row of a cache's layers (every tensor field
    leads with the slot axis)."""
    import dataclasses

    import torch

    return [dataclasses.replace(layer, **{
        f.name: getattr(layer, f.name)[slot:slot + 1].clone()
        for f in dataclasses.fields(layer)
        if isinstance(getattr(layer, f.name), torch.Tensor)}) for layer in layers]


GREEDY_HTTP = {"temperature": 0, "repetition_penalty": 1.0}


def direct_engine_run(lm, kv_bits, prompts: dict, tail: list[int], firsts: dict | None = None):
    """The reference for the HTTP run: check_engine's greedy requests through
    ``engine.submit`` on a fresh engine of its shape, stepped inline; when
    p300 finishes, the follow-up (its prompt, its tokens and ``tail``) is
    submitted. Returns the tokens by request and, for each request, its
    slot's cache row as the request left it (copied when it finished).
    ``firsts``, if given, gets each request's admission logits (float32,
    on the CPU): those that chose its first token. The launch counters are
    zeroed after the engine's warmup, so a caller reads serving's launches
    alone: warmup's prefills differ by path (a model whose slot prefills are
    graphs warms every bucket, others one of each kind)."""
    import torch

    from crane_tpu_torch.serve.engine import (
        EngineRequest,
        FinishReason,
        InferenceEngine,
        SamplingOptions,
    )

    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    engine = InferenceEngine(lm, max_slots=8, max_seq_len=2048, prefill_chunk=256,
                             kv_quant_bits=kv_bits)
    engine.warmup()
    reset_counts()
    slots, emit = {}, engine._emit

    def emit_noting_slot(seq, token):
        slots[seq.request_id] = seq.slot
        return emit(seq, token)

    engine._emit = emit_noting_slot
    if firsts is not None:
        admit = engine._finish_admission

        def admit_noting_logits(seq, logits, ctx):
            firsts[seq.request_id] = logits[0].float().cpu()
            return admit(seq, logits, ctx)

        engine._finish_admission = admit_noting_logits
    asked = {rid: n for rid, (_, n) in prompts.items()}
    queues = {rid: engine.submit(EngineRequest(rid, p, n, greedy))
              for rid, (p, n) in prompts.items()}
    toks, rows = {rid: [] for rid in queues}, {}
    for _ in range(20000):
        busy = engine.step()
        for rid, q in list(queues.items()):
            while not q.empty():
                r = q.get_nowait()
                if r.error is not None:
                    raise AssertionError(f"direct {rid}: {r.error}")
                if r.token is not None:
                    toks[rid].append(r.token)
                if r.finished:
                    if r.finish_reason != FinishReason.LENGTH or len(toks[rid]) != asked[rid]:
                        raise AssertionError(f"direct {rid}: {len(toks[rid])} tokens, "
                                             f"{r.finish_reason}")
                    rows[rid] = slot_rows(engine.cache.layers, slots[rid])
        if "p300" in rows and "followup" not in queues:
            follow = prompts["p300"][0] + toks["p300"] + tail
            asked["followup"] = 16
            queues["followup"] = engine.submit(EngineRequest("followup", follow, 16, greedy))
            toks["followup"] = []
        if len(rows) == len(prompts) + 1 and not busy and engine.request_q.empty():
            break
    torch.cuda.synchronize()
    if len(rows) != len(prompts) + 1:
        raise AssertionError(f"direct run: finished {sorted(rows)}")
    del engine
    lm.release_graphs()
    return toks, rows


def http_generate_run(port: int, prompts: dict, tail: list[int], direct: dict) -> dict:
    """check_engine's greedy requests to /generate with ``input_ids``, all at
    once (a thread each); p300's thread sends the follow-up when its answer
    comes, built from the direct run's p300 tokens so both runs serve one
    follow-up prompt. Returns the token ids of each answer (the stand-in
    tokenizer's text mapped back)."""
    import concurrent.futures

    def ask(rid, ids, n):
        status, body = http_json(port, "POST", "/generate", {
            "input_ids": ids, "rid": f"http-{rid}",
            "sampling_params": {"max_new_tokens": n, **GREEDY_HTTP}})
        got = StandInTokenizer.ids(body.get("text", "")) if status == 200 else None
        meta = body.get("meta_info", {}) if status == 200 else {}
        if got is None or len(got) != n or meta.get("completion_tokens") != n \
                or meta.get("finish_reason") != {"type": "length"} \
                or meta.get("prompt_tokens") != len(ids):
            raise AssertionError(f"/generate {rid}: status {status}, {str(body)[:300]}")
        return got

    def ask_then_follow(rid, ids, n):
        out = {rid: ask(rid, ids, n)}
        if rid == "p300":
            out["followup"] = ask("followup", ids + direct["p300"] + tail, 16)
        return out

    toks = {}
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        for fut in [pool.submit(ask_then_follow, rid, p, n) for rid, (p, n) in prompts.items()]:
            toks.update(fut.result(timeout=600))
    return toks


def ttft_direct(engine, ids: list[int], n: int) -> float:
    """Seconds (host clock) from ``engine.submit`` to the first token of a
    greedy request on a running engine; drains the request."""
    import uuid

    from crane_tpu_torch.serve.engine import EngineRequest, SamplingOptions

    t0 = time.perf_counter()
    q = engine.submit(EngineRequest(f"direct-{uuid.uuid4().hex[:8]}", ids, n,
                                    SamplingOptions(do_sample=False, repetition_penalty=1.0)))
    t_first = None
    while True:
        r = q.get(timeout=300)
        if r.error is not None:
            raise AssertionError(f"direct request failed: {r.error}")
        if t_first is None and r.token is not None:
            t_first = time.perf_counter() - t0
        if r.finished:
            return t_first


def throughput_direct(engine, prompts: list[list[int]], n: int) -> float:
    """Aggregate tokens/s (host clock) of greedy requests of ``n`` tokens
    submitted together to a running engine, until the last finishes."""
    import uuid

    from crane_tpu_torch.serve.engine import EngineRequest, SamplingOptions

    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    t0 = time.perf_counter()
    queues = [engine.submit(EngineRequest(f"tp-{uuid.uuid4().hex[:8]}", p, n, greedy))
              for p in prompts]
    total = 0
    for q in queues:
        while True:
            r = q.get(timeout=300)
            if r.error is not None:
                raise AssertionError(f"direct request failed: {r.error}")
            total += r.token is not None
            if r.finished:
                break
    wall = time.perf_counter() - t0
    if total != n * len(prompts):
        raise AssertionError(f"direct streams gave {total} tokens, not {n * len(prompts)}")
    return total / wall


def throughput_http(port: int, prompts: list[list[int]], n: int) -> float:
    """Aggregate tokens/s (host clock) of streamed /generate requests of
    ``n`` tokens sent together, a thread each, until the last [DONE]."""
    import concurrent.futures

    body = {"stream": True, "sampling_params": {"max_new_tokens": n, **GREEDY_HTTP}}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        runs = [f.result(timeout=600) for f in [
            pool.submit(http_stream, port, "/generate", {**body, "input_ids": p})
            for p in prompts]]
    wall = time.perf_counter() - t0
    total = sum(len(StandInTokenizer.ids(r["events"][-1]["text"])) for r in runs if r["events"])
    if total != n * len(prompts) or not all(r["done"] for r in runs):
        raise AssertionError(f"HTTP streams gave {total} tokens, not {n * len(prompts)}")
    return total / wall


def serve_http(lm, kv_bits=None):
    """A warmed engine of check_engine's shape on its own thread, and the
    port's server over it on a free local port. Returns (engine, server)."""
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.engine import InferenceEngine
    from crane_tpu_torch.serve.transport import BackgroundServer

    engine = InferenceEngine(lm, max_slots=8, max_seq_len=2048, prefill_chunk=256,
                             kv_quant_bits=kv_bits)
    engine.warmup()
    engine.start()
    return engine, BackgroundServer(build_app(Server(engine, model_name="qwen3-0.6b-random")))


def check_http(lm, label: str, kv_bits=None) -> dict[str, int]:
    """Phase 'http' on one model: the port's server in this process on
    127.0.0.1 (a free port) over a threaded engine of check_engine's shape
    (8 slots, 2048 tokens, 256-token chunks), with the stand-in tokenizer.

    - check_engine's greedy prompts (17, 64, 300 and 1000 tokens, and the
      follow-up that reuses 320) go to /generate with ``input_ids`` all at
      once; their ids equal those of the same requests through
      ``engine.submit`` on a fresh engine (direct_engine_run), or part at a
      tie on that engine's own cache rows (ties_on_reference_state);
    - /v1/chat/completions streamed and not: the deltas add up to the
      content; /v1/completions; a stream aborted by /abort_request and one
      whose client closes its socket: /v1/stats counts both aborts and the
      slots come free; 9 concurrent streams on 8 slots all finish;
      /health_generate; the statistics reconcile.

    The kernel counts cover the HTTP traffic only (returned). Then, on the
    host clock: the time to the first SSE chunk of the 300- and the
    1000-token prompt over HTTP and through ``engine.submit`` on the same
    engine (the prefix cache flushed before each, median of 5 in turns),
    and the aggregate tokens/s of 8 HTTP streams against 8 direct ones."""
    import concurrent.futures
    import threading

    import torch

    from crane_tpu_torch.ops import cuda as kernels

    vocab = lm.config.vocab_size
    lm.tokenizer = StandInTokenizer(vocab)
    prompts, tail = check_engine_prompts(vocab)
    t0 = time.perf_counter()
    direct, rows = direct_engine_run(lm, kv_bits, prompts, tail)
    engine, srv = serve_http(lm, kv_bits)
    port = srv.port
    try:
        reset_counts()
        got = http_generate_run(port, prompts, tail, direct)
        contexts = {rid: p for rid, (p, _) in prompts.items()}
        contexts["followup"] = contexts["p300"] + direct["p300"] + tail
        ties = {}
        for rid, ctx in contexts.items():
            tie = ties_on_reference_state(lm, f"http {label} {rid}", rows[rid], 1,
                                          {0: (ctx, got[rid], direct[rid])}, LOGIT_TIE)
            if tie:
                ties[rid] = tie[0]
        log("http", f"{label}: /generate with input_ids, {len(got)} concurrent greedy requests "
                    f"(17, 64, 300, 1000 tokens and the follow-up), ids vs engine.submit: "
                    f"{'identical' if not ties else f'first differences at ties {ties}'}")

        chat = {"messages": [{"role": "user", "content": "t11 t12 t13 hello"}],
                "max_tokens": 24, **GREEDY_HTTP}
        streamed = http_stream(port, "/v1/chat/completions",
                               {**chat, "stream": True, "stream_options": {"include_usage": True}})
        status, whole = http_json(port, "POST", "/v1/chat/completions", chat)
        content = whole["choices"][0]["message"]["content"] if status == 200 else None
        usage = [e["usage"] for e in streamed["events"] if e.get("usage")]
        if content is None or chat_text(streamed["events"]) != content \
                or len(StandInTokenizer.ids(content)) != 24 or not streamed["done"] \
                or whole["choices"][0]["finish_reason"] != "length" \
                or usage != [whole["usage"]] or usage[0]["completion_tokens"] != 24:
            raise AssertionError(f"chat {label}: streamed {streamed['events'][:3]} ... vs "
                                 f"{status} {str(whole)[:300]}")
        status, comp = http_json(port, "POST", "/v1/completions",
                                 {"prompt": "t5 t6 t7 t8", "max_tokens": 8, **GREEDY_HTTP})
        if status != 200 or comp["usage"]["completion_tokens"] != 8 \
                or len(StandInTokenizer.ids(comp["choices"][0]["text"])) != 8 \
                or comp["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"completions {label}: {status} {str(comp)[:300]}")

        # two streams aborted mid-way: by /abort_request, and by the client
        # closing its socket
        _, before = http_json(port, "GET", "/v1/stats")
        first = threading.Event()
        out = {}

        def long_stream():
            out["run"] = http_stream(port, "/generate", {
                "input_ids": contexts["p17"], "rid": "http-abort", "stream": True,
                "sampling_params": {"max_new_tokens": 1500, **GREEDY_HTTP}}, on_event=first.set)

        reader = threading.Thread(target=long_stream)
        reader.start()
        if not first.wait(120):
            raise AssertionError("the stream to abort never began")
        status, body = http_json(port, "POST", "/abort_request", {"rid": "http-abort"})
        reader.join(120)
        run = out.get("run")
        if reader.is_alive() or status != 200 or run is None or not run["done"] \
                or len(StandInTokenizer.ids(run["events"][-1]["text"])) >= 1500:
            raise AssertionError(f"abort_request {label}: {status} {body}, stream {run and len(run['events'])}")
        wait_stats(port, lambda s: s["requests_aborted"] == before["requests_aborted"] + 1
                   and s["running"] == 0, f"{label} /abort_request")
        cut = http_stream(port, "/v1/chat/completions",
                          {**chat, "max_tokens": 1500, "stream": True}, hang_up_after=2)
        stats = wait_stats(port, lambda s: s["requests_aborted"] == before["requests_aborted"] + 2
                           and s["running"] == 0, f"{label} client hang-up")
        log("http", f"{label}: chat streamed == not streamed (24 tokens), completions; a stream "
                    f"aborted by /abort_request after {len(run['events'])} chunks and one whose "
                    f"client hung up after {len(cut['events'])}: aborted "
                    f"{stats['requests_aborted']}, running {stats['running']}")

        def nth(i):
            return http_stream(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": f"t{100 + i} t{200 + i} stream {i}"}],
                "max_tokens": 48, "stream": True, "stream_options": {"include_usage": True},
                **GREEDY_HTTP})

        with concurrent.futures.ThreadPoolExecutor(9) as pool:
            nine = [f.result(timeout=600) for f in [pool.submit(nth, i) for i in range(9)]]
        for i, run in enumerate(nine):
            usage = [e["usage"] for e in run["events"] if e.get("usage")]
            if not run["done"] or not usage or usage[0]["completion_tokens"] != 48 \
                    or len(StandInTokenizer.ids(chat_text(run["events"]))) != 48:
                raise AssertionError(f"stream {i} of 9 on 8 slots: {run['events'][-2:]}")
        status, health = http_json(port, "GET", "/health_generate")
        if status != 200 or health != {"status": "ok"}:
            raise AssertionError(f"/health_generate: {status} {health}")
        stats = wait_stats(port, lambda s: s["running"] == 0 and s["waiting"] == 0, "idle")
        if stats["requests_failed"] or stats["requests_received"] != stats["requests_completed"] \
                + stats["requests_aborted"]:
            raise AssertionError(f"{label}: server statistics do not reconcile: {stats}")
        counts = kernels.launch_counts()
        log("http", f"{label}: 9 concurrent streams on 8 slots finished (48 tokens each); "
                    f"/health_generate ok; stats {json.dumps(stats)}; HTTP traffic "
                    f"{time.perf_counter() - t0:.1f} s with the direct run")

        gen = torch.Generator().manual_seed(12)
        ttft = {}
        for rid in ("p300", "p1000"):
            ids = contexts[rid]
            h, d = [], []
            for _ in range(5):
                http_json(port, "POST", "/flush_cache")
                h.append(http_stream(port, "/generate", {
                    "input_ids": ids, "stream": True,
                    "sampling_params": {"max_new_tokens": 4, **GREEDY_HTTP}})["t_first"])
                engine.clear_prefix_cache()
                d.append(ttft_direct(engine, ids, 4))
            ttft[rid] = (median(h) * 1e3, median(d) * 1e3)
        streams = [torch.randint(0, vocab, (128,), generator=gen).tolist() for _ in range(8)]
        tps = {"http": [], "direct": []}
        for way in ("http", "direct", "direct", "http"):
            tps[way].append(throughput_http(port, streams, 128) if way == "http"
                            else throughput_direct(engine, streams, 128))
        log("http", f"{label}: time to the first chunk (host clock, median of 5, prefix cache "
                    f"flushed): 300 tokens {ttft['p300'][0]:.2f} ms over HTTP vs "
                    f"{ttft['p300'][1]:.2f} ms through engine.submit; 1000 tokens "
                    f"{ttft['p1000'][0]:.2f} vs {ttft['p1000'][1]:.2f} ms; 8 streams x 128 "
                    f"tokens: {', '.join(f'{x:.1f}' for x in tps['http'])} tok/s over HTTP vs "
                    f"{', '.join(f'{x:.1f}' for x in tps['direct'])} tok/s direct "
                    f"(runs http, direct, direct, http)")
    finally:
        srv.close()
        engine.stop()
        lm.release_graphs()
        lm.tokenizer = None
    return counts


def require_none_launched(path: str) -> None:
    """Fail if the path launched any kernel: no kernel lies on it."""
    from crane_tpu_torch.ops import cuda as kernels

    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    if launched:
        raise AssertionError(f"the {path} launched kernels: {launched}")
    log("launches", f"{path}: no kernel launched (none lies on it)")


def require_launched(path: str, counts: dict[str, int], names) -> None:
    """Fail if a kernel of ``names`` was not launched on ``path``."""
    log("launches", f"{path}: {json.dumps({k: n for k, n in counts.items() if n})}")
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched by the {path}")


def gguf_value(v) -> bytes:
    import struct

    if isinstance(v, int):
        return struct.pack("<II", 4, v)
    if isinstance(v, float):
        return struct.pack("<If", 6, v)
    if isinstance(v, str):
        b = v.encode()
        return struct.pack("<IQ", 8, len(b)) + b
    raise TypeError(type(v))


def write_gguf(path: str, metadata: dict, tensors: dict) -> int:
    """A GGUF v3 file: ``tensors`` maps a name to (ggml type, row-major
    shape, raw bytes); data aligned to 32 bytes. Returns its size."""
    import struct

    align = 32

    def text(s):
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    head = struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(metadata))
    head += b"".join(text(k) + gguf_value(v) for k, v in metadata.items())
    off = 0
    for name, (ggml_type, shape, raw) in tensors.items():
        head += text(name) + struct.pack("<I", len(shape))
        head += b"".join(struct.pack("<Q", d) for d in reversed(shape))
        head += struct.pack("<IQ", ggml_type, off)
        off += -(-len(raw) // align) * align
    size = 0
    with open(path, "wb") as f:
        for part in [head + b"\0" * (-len(head) % align)] + [
                r for _, _, raw in tensors.values() for r in (raw, b"\0" * (-len(raw) % align))]:
            f.write(part)
            size += len(part)
    return size


def qwen3_gguf(lm, path: str) -> int:
    """``lm``'s weights as a llama.cpp ``qwen3`` GGUF (tests/test_gguf_model.py's
    layout): the 2-D linears q8_0, everything else f32. Returns its size."""
    import torch

    from crane_tpu_torch.loaders.gguf import GGML_F32, GGML_Q8_0, quantize_q8_0

    cfg, p = lm.config, lm.params
    tensors = {}

    def put(name, t, q8=False):
        a = t.detach().to("cpu", torch.float32).contiguous().numpy()
        tensors[name] = ((GGML_Q8_0, a.shape, quantize_q8_0(a).tobytes()) if q8
                         else (GGML_F32, a.shape, a.tobytes()))

    put("token_embd.weight", p["embed"])
    put("output_norm.weight", p["final_norm"])
    for i, layer in enumerate(p["layers"]):
        b, attn, mlp = f"blk.{i}.", layer["attn"], layer["mlp"]
        for name, w in (("attn_q", attn["wq"]), ("attn_k", attn["wk"]), ("attn_v", attn["wv"]),
                        ("attn_output", attn["wo"]), ("ffn_gate", mlp["gate"]),
                        ("ffn_up", mlp["up"]), ("ffn_down", mlp["down"])):
            put(f"{b}{name}.weight", w.T, q8=True)  # GGUF keeps HF's [out, in]
        put(b + "attn_q_norm.weight", attn["q_norm"])
        put(b + "attn_k_norm.weight", attn["k_norm"])
        put(b + "attn_norm.weight", layer["input_ln"])
        put(b + "ffn_norm.weight", layer["post_ln"])
    a = "qwen3."
    metadata = {
        "general.architecture": "qwen3", a + "block_count": cfg.num_layers,
        a + "embedding_length": cfg.hidden_size, a + "feed_forward_length": cfg.intermediate_size,
        a + "attention.head_count": cfg.num_heads, a + "attention.head_count_kv": cfg.num_kv_heads,
        a + "attention.key_length": cfg.head_dim,
        a + "attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        a + "rope.freq_base": float(cfg.rope_theta),
        a + "context_length": cfg.max_position_embeddings, a + "vocab_size": cfg.vocab_size,
    }
    return write_gguf(path, metadata, tensors)


def check_gguf(lm) -> None:
    """Phase 'gguf': full-width Qwen3-0.6B (``lm``'s weights) written as a
    q8_0 GGUF (qwen3_gguf, about 1.1 GB) under ``build/``, loaded with the
    port's ``from_gguf`` on the card in bf16 (the q8_0 linears kept as
    blockwise QuantizedWeights) and on the CPU in float32 as the reference
    (dequantized, by the route ``dequant_route`` names). The 300-token
    prefill's logits by compare_logits; 32 greedy tokens by the tie rule on
    the CPU's own cache; then 4 requests over HTTP from the card model, and
    the load times, prefill ms and graph decode step beside the bf16
    model's. The path launches K1-K3 and never K6."""
    import concurrent.futures
    import tempfile

    import torch

    from crane_tpu_torch.generation.config import GenerationConfig
    from crane_tpu_torch.loaders.gguf import dequant_route
    from crane_tpu_torch.loaders.gguf_model import from_gguf
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.ops.linear import QuantizedWeight
    from crane_tpu_torch.ops.sampling import SamplingParams

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "qwen3-0.6b-q8_0.gguf")
        t0 = time.perf_counter()
        size = qwen3_gguf(lm, path)
        write_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        card = from_gguf(path, dtype=torch.bfloat16, device=lm.device)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = from_gguf(path, dtype=torch.float32, keep_quant=False, device="cpu")
        cpu_s = time.perf_counter() - t0
    route = dequant_route()
    cfg = card.config
    wq = card.params["layers"][0]["attn"]["wq"]
    if not (isinstance(wq, QuantizedWeight) and (wq.block, wq.bits) == (32, 8)) \
            or (cfg.num_layers, cfg.hidden_size, cfg.vocab_size) != (
                lm.config.num_layers, lm.config.hidden_size, lm.config.vocab_size) \
            or not cfg.tie_word_embeddings or card.device != lm.device:
        raise AssertionError(f"from_gguf: {cfg}, wq {type(wq).__name__}")
    log("gguf", f"wrote {size / 1e9:.3f} GB (q8_0 linears, f32 rest) in {write_s:.1f} s; "
                f"from_gguf on the card (bf16, q8_0 kept blockwise) {card_s:.2f} s, on the CPU "
                f"(float32, dequantized by the {route} route) {cpu_s:.2f} s")

    prompt = torch.randint(0, cfg.vocab_size, (300,),
                           generator=torch.Generator().manual_seed(11)).tolist()
    logits_card, _ = card.prefill(card.init_cache(1, 512), [prompt], [300])
    cache = cpu.init_cache(1, 512)
    logits_cpu, cache = cpu.prefill(cache, [prompt], [300])
    compare_logits("gguf", "q8_0 GGUF prefill logits card bf16 vs cpu f32",
                   logits_card[0], logits_cpu[0])
    card_toks = card.generate(prompt, GenerationConfig.greedy(32))
    first = logits_cpu.argmax(-1).to(torch.int32)
    toks, cache, _ = cpu.decode_steps(cache, first, torch.full((1, 64), -1, dtype=torch.int32),
                                      SamplingParams.make(1, do_sample=False, device="cpu"),
                                      torch.Generator(), 31)
    cpu_toks = [int(first[0])] + toks[0].tolist()
    ties = ties_on_reference_state(cpu, "gguf greedy card vs cpu", cache.layers, 1,
                                   {0: (prompt, card_toks, cpu_toks)}, LOGIT_TIE)
    log("gguf", f"32 greedy tokens, card bf16 vs cpu f32: "
                f"{'identical' if not ties else f'first difference at a tie {ties[0]}'}")
    del cpu, cache

    card.tokenizer = StandInTokenizer(cfg.vocab_size)
    engine, srv = serve_http(card)
    try:
        gen = torch.Generator().manual_seed(13)
        asks = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
                for n in (17, 64, 300, 600)]

        def ask(ids):
            return http_json(srv.port, "POST", "/generate", {
                "input_ids": ids, "sampling_params": {"max_new_tokens": 16, **GREEDY_HTTP}})

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            answers = [f.result(timeout=600) for f in [pool.submit(ask, a) for a in asks]]
        for ids, (status, body) in zip(asks, answers):
            if status != 200 or len(StandInTokenizer.ids(body["text"])) != 16 \
                    or body["meta_info"]["finish_reason"] != {"type": "length"}:
                raise AssertionError(f"GGUF over HTTP: {status} {str(body)[:300]}")
    finally:
        srv.close()
        engine.stop()
        card.release_graphs()
        card.tokenizer = None
    counts = kernels.launch_counts()
    require_launched("gguf path", counts, ("fp_decode_attention", "flash_attention_causal",
                                           "flash_attention_cached"))
    if counts["quant_matmul[w8]"] or counts["quant_matmul[w4]"]:
        raise AssertionError("a blockwise GGUF linear reached K6")
    no_plain_routes("gguf path")
    log("gguf", "4 concurrent /generate requests (17, 64, 300, 600 tokens) of 16 tokens each "
                "served from the GGUF model")

    prompt_ms, tps = time_generate(card, prompt, GenerationConfig.greedy(64))
    ref_ms, ref_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("gguf", f"q8_0 GGUF (blockwise linears) vs the bf16 model, batch 1: prefill 300 tokens "
                f"(bucket 512) {prompt_ms:.2f} vs {ref_ms:.2f} ms; graph decode step "
                f"{1e3 / tps:.3f} vs {1e3 / ref_tps:.3f} ms ({tps:.1f} vs {ref_tps:.1f} tok/s)")
    card.release_graphs()
    lm.release_graphs()
    del card
    torch.cuda.synchronize()


# device kernels by family, the first match of a name's words (the port's
# kernels by their __global__ names; the rest PyTorch's own kernels)
KERNEL_FAMILIES = (
    ("K6", ("quant_matmul",)),
    ("K5", ("quant_cached", "QuantTiles")),
    ("K4", ("quant_decode", "QuantRows")),
    ("K2/K3", ("flash_attention", "flash_mma")),
    ("K1", ("decode_attention", "FpRows")),
    ("K7", ("gdn_scan", "gdn_chunk")),
    ("K8", ("moe_expert", "moe_group", "moe_combine")),
    ("cuBLAS", ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")),
    ("aten copy", ("copy", "Copy")),
    ("aten reduce", ("reduce", "softmax", "Softmax")),
    ("aten index", ("index", "gather", "scatter", "Index")),
    ("aten elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the attention families, summed as the chunk's attention time
ATTENTION_FAMILIES = ("K5", "K4", "K2/K3", "K1")


def kernel_family(name: str) -> str:
    return next((fam for fam, words in KERNEL_FAMILIES if any(w in name for w in words)),
                "other")


def device_events(prof) -> list:
    """The device's events of a ``torch.profiler`` run (kernels, copies and
    sets), as the profiler's own tables count them: no host event, no
    user-annotated range, no event the profiler hides."""
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
            and not getattr(e, "is_hidden_event", lambda: False)() and not e.is_async()]


def log_device_ms(label, what, run) -> dict[str, float]:
    """Log the device time of one call of ``run``: its kernels' own times
    summed from ``torch.profiler`` (device-side events only), by family
    (KERNEL_FAMILIES), the attention kernels' part, and the largest kernels
    by name; "not measured" where the profiler saw no device time. Returns
    ms by family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    families: dict[str, float] = {}
    by_name: dict[str, tuple[float, int]] = {}
    # the recorded device events summed as they stand: key_averages() builds
    # an object for each, tens of seconds for a TTS block's ~60,000 kernels
    for event in device_events(prof):
        ms, name = event.duration_ns() / 1e6, event.name()
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + ms, n + 1)
    names = [(ms, n, name) for name, (ms, n) in by_name.items()]
    total = sum(families.values())
    if total <= 0:
        log("profile", f"{label}, {what}: device time not measured (the profiler saw no "
                       f"device time)")
        return {}
    attention = sum(families.get(f, 0.0) for f in ATTENTION_FAMILIES)
    by_family = ", ".join(f"{f} {ms:.3f}" for f, ms in sorted(families.items(),
                                                               key=lambda kv: -kv[1]))
    top = "; ".join(f"{ms:.3f} ms x{n} {key[:90]}" for ms, n, key in sorted(names)[::-1][:6])
    log("profile", f"{label}, {what}: {total:.3f} ms of kernel time (summed), {attention:.3f} ms "
                   f"in attention kernels; by family (ms): {by_family}; largest: {top}")
    return families


def check_sp(lm, rows: list[dict]) -> None:
    """Phase 10: sequence-parallel serving of full-width Qwen3-0.6B on the
    one card, four slabs (make_sp_mesh(4, ["cuda:0"] * 4)).

    Float32: a 5000-token prompt into an 8192-token cache (four slabs of
    2048; the prompt spans three), as a 4096-token prefill and a 904-token
    continuation chunk, then 16 greedy steps on an fp cache and 8 on int8
    and int4 caches; each against the unsharded port on the same card
    (compare_sp). bf16: the engine with two slots of 16,384 tokens serves a
    12,000- and a 300-token prompt, against the unsharded engine. The
    with-stats kernels' launches are counted over the sp runs only, and K1
    and K3 must not have run there (every layer of this model is sharded).
    ``rows`` (the with-stats kernels') get their launches."""
    import torch

    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm

    mesh = make_sp_mesh(4, ["cuda:0"] * 4)
    counts: dict[str, int] = {}

    def sp_path(fn):
        kernels.reset_launch_counts()
        res = fn()
        for name, n in kernels.launch_counts().items():
            counts[name] = counts.get(name, 0) + n
        return res

    cfg = lm.config
    gen = torch.Generator().manual_seed(10)
    lm32 = CausalLM(cfg, _tree(lm.params, lambda t: t.float()), dtype=torch.float32)
    slm32 = sp_shard_lm(lm32, mesh)
    prompt = torch.randint(0, cfg.vocab_size, (5000,), generator=gen).tolist()
    for kv_bits, steps in ((None, 16), (8, 8), (4, 8)):
        ref, ref_cache = sp_greedy(lm32, prompt, kv_bits, steps)
        feed = [int(x.argmax()) for x in ref[:-1]]
        got, got_cache = sp_path(lambda: sp_greedy(slm32, prompt, kv_bits, steps, feed))
        label = f"float32, {'fp' if kv_bits is None else f'int{kv_bits}'} cache"
        if kv_bits is not None:
            differ, total = code_flips(got_cache, ref_cache)
            log("sp", f"{label}: {differ} of {total} K/V code bytes differ between the sp and "
                      f"the unsharded run")
        compare_sp(f"{label}, 5000-token prompt over 3 of 4 slabs", got, ref, SP_REL_L2[kv_bits])
        del ref, got, ref_cache, got_cache
    del lm32, slm32

    slm = sp_shard_lm(lm, mesh)
    prompts = {"long": torch.randint(0, cfg.vocab_size, (12000,), generator=gen).tolist(),
               "short": torch.randint(0, cfg.vocab_size, (300,), generator=gen).tolist()}
    ref_toks, ref_ms = sp_engine_run(lm, prompts, "sp-engine unsharded")
    got_toks, sp_ms = sp_path(lambda: sp_engine_run(slm, prompts, "sp-engine 4 slabs"))
    for rid, p in prompts.items():
        got, ref = got_toks[rid], ref_toks[rid]
        j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
        if j is None:
            continue
        # the first differing step: both models' logits on the common
        # context, within the logit rules, and the two tokens a near-tie of
        # the unsharded model's logits
        ctx = p + ref[:j]
        logits = [m.prefill(m.init_cache(1, 16384), [ctx], [len(ctx)])[0][0] for m in (slm, lm)]
        compare_logits("sp", f"engine {rid} step {j}: sp vs unsharded bf16", *logits)
        gap = (logits[1][ref[j]] - logits[1][got[j]]).item()
        if abs(gap) >= LOGIT_TIE:
            raise AssertionError(f"sp engine {rid} step {j}: token {got[j]} vs {ref[j]}, "
                                 f"logit gap {gap:.3g} is no tie")
    log("sp", f"engine tokens agree with the unsharded engine (LOGIT_REL_L2 / LOGIT_TIE at a "
              f"first difference); decode step {sp_ms:.2f} ms in 4 slabs vs {ref_ms:.2f} ms unsharded")

    if counts["fp_decode_attention"] or counts["flash_attention_cached"]:
        raise AssertionError("K1 or K3 ran on a sequence-sharded layer")
    if counts["flash_attention_causal"] <= 0:
        raise AssertionError("the sp path never launched K2")
    read_launches("sp path", rows, counts)
    launches_per(lm, "Qwen3-0.6B bf16 unsharded")
    launches_per(slm, "Qwen3-0.6B bf16, 4 slabs")


def log_build_info() -> None:
    """The [build] lines: the compiled form of each tensor-core instance
    (cudaFuncGetAttributes): K2/K3 and K5 at each head dim, K5 at each bit
    width, K6 at each output tile and bit width."""
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.cuda.quant_matmul import MMA_TILES
    from crane_tpu_torch.ops.cuda.quant_matmul import mma_kernel_info as k6_info

    def line(what, info):
        log("build", f"bf16 tensor-core {what}: {info['registers']} registers and "
                     f"{info['local_bytes']} local (spill) bytes a thread, {info['smem_bytes']} "
                     f"shared-memory bytes and {info['threads']} threads a block")

    for D in k23.HEAD_DIMS:
        line(f"K2/K3 at head_dim {D}", k23.mma_kernel_info(D))
        for bits in (8, 4):
            line(f"K5 kv{bits} at head_dim {D}", k45.mma_kernel_info(D, bits))
    for tile, (rows, cols) in enumerate(MMA_TILES):
        for bits in (8, 4):
            line(f"K6 w{bits} at a {rows} x {cols} output tile", k6_info(tile, bits))
    log_decode_build_info()
    import torch

    from crane_tpu_torch.ops.cuda import moe as k8
    from crane_tpu_torch.ops.cuda.gdn_scan import KEY_DIMS, chunk_kernel_info

    for gate_up in (True, False):
        for bm in k8.ROW_TILES:
            info = k8.kernel_info(gate_up, bm)
            line(f"K8 {'gate|up' if gate_up else 'down'} at a {info['rows']} x {info['cols']} "
                 f"tile", info)
            if info["local_bytes"]:
                raise AssertionError(f"K8 spills at row tile {bm}: {info}")

    for K in KEY_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for kernel, info in chunk_kernel_info(dtype, K).items():
                log("build", f"K7 chunkwise {kernel} at K={K}, v {str(dtype).removeprefix('torch.')}: "
                             f"{info['registers']} registers and {info['local_bytes']} local (spill) "
                             f"bytes a thread, {info['smem_bytes']} shared-memory bytes and "
                             f"{info['threads']} threads a block")


def log_decode_build_info() -> None:
    """The [build] lines of the split-KV decode kernels: for K1 and K4 (kv8,
    kv4) at each dtype and head dim, the registers of the instances at
    G = 1..8, their largest local (spill) bytes and shared memory."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import quant_attention as k45

    spills = []
    for dtype in (torch.bfloat16, torch.float32):
        for D in k1.HEAD_DIMS:
            for bits in (16, 8, 4):
                infos = [k1.kernel_info(dtype, D, G) if bits == 16 else
                         k45.decode_kernel_info(dtype, bits, D, G)
                         for G in range(1, k1.MAX_GROUP + 1)]
                name = "K1" if bits == 16 else f"K4 kv{bits}"
                local = max(i["local_bytes"] for i in infos)
                if local:
                    spills.append(f"{name} {dtype} D={D}")
                log("build", f"{name} {str(dtype).removeprefix('torch.')} at head_dim {D}: "
                             f"registers at G=1..8 {[i['registers'] for i in infos]}, local "
                             f"(spill) bytes at most {local}, shared memory "
                             f"{[i['smem_bytes'] for i in infos]} bytes, "
                             f"{infos[0]['threads']} threads a block")
    log("build", f"decode instances that spill: {spills or 'none'}")


# the attention heads of the MoE and short-conv paths: LFM2-1.2B's 32 query /
# 8 KV heads of 64 and Qwen3-Next-80B-A3B's 16 / 2 of 256, and K7 over
# Qwen3-Next's 32 value heads; each row's name carries its tag, and
# read_launches reads the wrapper's count on the path that runs the shape
LFM2_HEADS = "[D64-32/8]"
NEXT_HEADS = "[D256-16/2]"
H32 = "[H32]"


def check_family_kernels() -> dict[str, list[dict]]:
    """Phase 3 at the MoE and short-conv paths' shapes: K2 (S=1024), K3 (a
    256-token chunk at offsets 0 and 1000 of a 2048-slot row) and K1 (B=8
    rows over T=2048, ragged kv_valid) in bf16, with LFM2-1.2B's heads and
    with Qwen3-Next-80B-A3B's, each with and without a window; and K7 at
    B=1 S=1000 over Qwen3-Next's 32 value heads of K=V=128 (its 16 key heads
    repeated, as gdn_block hands them to the kernel), zero and random
    initial state. Each against its plain version, timed beside it and
    SDPA (K1-K3). Returns the JSON rows by the path whose launches they
    read, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda.gdn_scan import gdn_route, gdn_scan, gdn_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(1108)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = {"lfm2": [], "moe": []}
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    for path, tag, (Hq, Hkv, D) in (("lfm2", LFM2_HEADS, (32, 8, 64)),
                                    ("moe", NEXT_HEADS, (16, 2, 256))):
        scale = D ** -0.5
        heads = f"Hq={Hq} Hkv={Hkv} D={D}"
        windows = (("", {}), (" window=256", {"window": 256}))
        q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
        errs = [compare(f"K2 {heads}{label}",
                        k23.flash_attention_causal(q, k, v, scale=scale, **kw),
                        k23.flash_attention_causal_plain(q, k, v, scale=scale, **kw))
                for label, kw in windows]
        rows[path].append(timed_row(
            "flash_attention_causal" + tag, "flash_attention_mma.cu",
            "crane_tpu/ops/pallas/flash_attention.py:187", errs,
            lambda: k23.flash_attention_causal(q, k, v, scale=scale),
            lambda: k23.flash_attention_causal_plain(q, k, v, scale=scale),
            f"B=1 S=1024 {heads}", attn_work(1, 1024, Hq, Hkv, D, 1024 * 1025 // 2, 1024, 2 * D, 0),
            lambda: sdpa(q, k, v, causal=True)))

        kc, vc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D)
        errs = []
        for off in (0, 1000):
            qc = rnd(1, 256, Hq, D)
            pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None].contiguous()
            errs += [compare(f"K3 {heads} offset={off}{label}",
                             k23.flash_attention_cached(qc, kc, vc, pos, scale=scale, **kw),
                             k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale, **kw))
                     for label, kw in windows]
        rows[path].append(timed_row(
            "flash_attention_cached" + tag, "flash_attention_mma.cu",
            "crane_tpu/ops/pallas/flash_attention.py:384", errs,
            lambda: k23.flash_attention_cached(qc, kc, vc, pos, scale=scale),
            lambda: k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale),
            f"B=1 S=256 at offset 1000, T=2048, {heads}", chunk_work(qc, Hkv, 2048, pos),
            lambda: sdpa(qc, kc, vc, mask=chunk_mask(pos, 2048))))

        qd = rnd(8, 1, Hq, D)
        kd, vd = rnd(8, 2048, Hkv, D), rnd(8, 2048, Hkv, D)
        errs = [compare(f"K1 {heads}{label}",
                        k1.fp_decode_attention(qd, kd, vd, valid, scale=scale, **kw),
                        k1.fp_decode_attention_plain(qd, kd, vd, valid, scale=scale, **kw))
                for label, kw in windows]
        rows[path].append(timed_row(
            "fp_decode_attention" + tag, "decode_attention.cu",
            "crane_tpu/ops/pallas/quant_attention.py:266", errs,
            lambda: k1.fp_decode_attention(qd, kd, vd, valid, scale=scale),
            lambda: k1.fp_decode_attention_plain(qd, kd, vd, valid, scale=scale),
            f"B=8 T=2048 ragged kv_valid, {heads}", decode_work(qd, Hkv, valid),
            lambda: sdpa(qd, kd, vd, mask=decode_mask(valid, 2048))))

    B, S, H, K, V = 1, 1000, 32, 128, 128
    q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").to(torch.bfloat16)
               for d in (K, K, V))
    g = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.5
    beta = torch.rand(B, S, H, generator=gen, device="cuda")
    errs = []
    for s0 in (None, torch.randn(B, H, K, V, generator=gen, device="cuda") * 0.3):
        label = f"K7 B={B} S={S} H={H} K=V={K} {'init state' if s0 is not None else 'zero state'}"
        y, st = gdn_scan(q, k, v, g, beta, s0)
        yr, sr = gdn_scan_plain(q, k, v, g, beta, s0)
        errs.append(compare(f"{label} y", y, yr))
        compare(f"{label} state", st, sr, rtol=STATE_RTOL, atol=STATE_ATOL)
    route = gdn_route(S)
    p1, k1_ms, k2_ms, p2 = (cuda_ms(f, n, warmup=1) for f, n in (
        (lambda: gdn_scan_plain(q, k, v, g, beta), 2), (lambda: gdn_scan(q, k, v, g, beta), 20),
        (lambda: gdn_scan(q, k, v, g, beta), 20), (lambda: gdn_scan_plain(q, k, v, g, beta), 2)))
    ms, plain_ms = (k1_ms + k2_ms) / 2, (p1 + p2) / 2
    bound_ms, bound_by = bound(*gdn_work(B, S, H, K, V), peak="tf32")
    shape = f"B={B} S={S} H={H} K=V={K}"
    log("kernels", f"K7 {shape}: the {route} route {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
                   f"{bound_ms:.4f} ms ({bound_by}, TF32 tensor-core rate); max|err| of y "
                   f"{max(errs):.3g}, state within {STATE_ATOL:g} + {STATE_RTOL:g}*|ref|")
    rows["moe"].append({"name": f"gdn_scan[{route}]" + H32, "route": "cuda",
                        "source": "crane_tpu_torch/csrc/gdn_chunk.cu",
                        "replaces": "crane_tpu/ops/pallas/gdn_scan.py:126", "launches": 0,
                        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        "shape": shape})
    return rows


# K8's rows carry their shape after this (read_launches reads the name before it)
K8_AT = " @ "
# (experts, picks, hidden, expert width) of K8's rows: Qwen3-Next-80B-A3B's
# experts and LFM2-24B-A2B's
K8_SHAPES = {"Qwen3-Next": (512, 10, 2048, 512), "LFM2-24B-A2B": (64, 4, 2048, 1536)}


def check_moe_kernels() -> list[dict]:
    """K8 (the routed experts) at both expert shapes, over T = 1, 8 and 32
    rows (decode steps) and 512 (a prefill chunk), in bf16 with random
    router picks (the top k of a softmax over random scores, renormalised):
    against its plain version, timed beside it and, as yardsticks, the dense
    dispatch (every expert on every row: the card's route before K8) and
    the ragged one (``torch._grouped_mm``), at the bound of the distinct
    routed experts' bytes or the routed operations, the larger. Returns the
    JSON rows (``moe_experts[gate_up]``, launches 0; ``library_ms`` the
    dense dispatch's, ``ragged_ms``)."""
    import dataclasses

    import torch

    from crane_tpu_torch.models.modules import transformer as ttf
    from crane_tpu_torch.ops.cuda import moe as k8

    gen = torch.Generator(device="cuda").manual_seed(2408)

    def weights(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * shape[-2] ** -0.5).to(
            torch.bfloat16)

    rows = []
    for label, (n, k, E, I) in K8_SHAPES.items():
        cfg = dataclasses.replace(moe_config(1), num_experts=n, num_experts_per_tok=k,
                                  moe_intermediate_size=I)
        p = {"experts_gate": weights(n, E, I), "experts_up": weights(n, E, I),
             "experts_down": weights(n, I, E)}
        for T in (1, 8, 32, 512):
            x = torch.randn(T, E, generator=gen, device="cuda").to(torch.bfloat16)
            probs = torch.softmax(torch.randn(T, n, generator=gen, device="cuda") * 3, -1)
            w, sel = torch.topk(probs, k, dim=-1)
            w = w / w.sum(-1, keepdim=True)
            args = (x, w, sel, p["experts_gate"], p["experts_up"], p["experts_down"])
            err = compare(f"K8 {label} T={T}", k8.moe_experts(*args), k8.moe_experts_plain(*args))
            # in turns: plain, K8, dense, ragged, ragged, dense, K8, plain (the plain
            # version, one host loop over the experts, twice a turn)
            fns = (lambda: k8.moe_experts_plain(*args), lambda: k8.moe_experts(*args),
                   lambda: ttf._moe_dispatch_dense(cfg, p, x, w, sel),
                   lambda: ttf._moe_dispatch_ragged(cfg, p, x, w, sel))
            t = [cuda_ms(fns[i], 2, warmup=1) if i == 0 else cuda_ms(fns[i])
                 for i in (0, 1, 2, 3, 3, 2, 1, 0)]
            plain_ms, ms, dense_ms, ragged_ms = ((t[i] + t[7 - i]) / 2 for i in range(4))
            routed = int(torch.unique(sel).numel())
            bound_ms, bound_by = bound(routed * 3 * E * I * 2 + 2 * T * E * 2, 6 * T * k * E * I)
            plan = k8.mma_plan(T, k, n, E, I,
                               torch.cuda.get_device_properties(0).multi_processor_count)
            shape = f"{label} T={T}: {routed} of {n} experts of {I} routed (top-{k}), E={E}"
            log("kernels", f"K8 {shape}: max|err| {err:.3g}, {ms:.4f} ms vs plain {plain_ms:.4f} "
                           f"ms, dense dispatch {dense_ms:.4f} ms ({ms / dense_ms:.2f}x), ragged "
                           f"(torch._grouped_mm) {ragged_ms:.4f} ms, bound {bound_ms:.4f} ms "
                           f"({bound_by}, {ms / bound_ms:.2f}x); plan {json.dumps(plan)}")
            rows.append({"name": f"moe_experts[gate_up]{K8_AT}{label} T={T}", "route": "cuda",
                         "source": "crane_tpu_torch/csrc/moe_experts.cu",
                         "replaces": "none (XLA's dispatch in moe_block)", "launches": 0,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": dense_ms,
                         "ms_over_library": ms / dense_ms, "ragged_ms": ragged_ms,
                         "shape": shape})
        del p
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def plain_moe_on_card():
    """Counts the calls of the plain MoE dispatches on a CUDA tensor inside
    (the card runs K8; a CPU reference keeps the dense dispatch)."""
    from crane_tpu_torch.models.modules import transformer as ttf

    calls = {"dense": 0, "ragged": 0}
    saved = ttf._moe_dispatch_dense, ttf._moe_dispatch_ragged

    def counted(name, fn):
        def call(cfg, p, xt, *args, **kw):
            calls[name] += int(xt.is_cuda)
            return fn(cfg, p, xt, *args, **kw)
        return call

    ttf._moe_dispatch_dense = counted("dense", saved[0])
    ttf._moe_dispatch_ragged = counted("ragged", saved[1])
    try:
        yield calls
    finally:
        ttf._moe_dispatch_dense, ttf._moe_dispatch_ragged = saved


# Qwen3-Next-80B-A3B's text model, the published config as transformers'
# Qwen3NextConfig defaults give it: 48 layers as [gdn, gdn, gdn, full] x 12,
# hidden 2048, 16 query / 2 KV heads of 256 with a sigmoid output gate and
# rotary on a quarter of each head, 16 key and 32 value GDN heads of 128
# with a 4-tap conv, every layer a sparse MoE of 512 experts of 512 with
# top-10 routing renormalised and one shared expert of 512, vocabulary
# 151936, untied head. Its 48 layers hold 155 GB of experts in bf16, over
# one card's 80 GB: the smoke run keeps every width and cuts the depth to
# MOE_LAYERS (3 of the 12 blocks; 38.7 GB of experts).
QWEN3_NEXT_80B_A3B = {
    "model_type": "qwen3_next", "vocab_size": 151936, "hidden_size": 2048,
    "num_hidden_layers": 48, "num_attention_heads": 16, "num_key_value_heads": 2,
    "head_dim": 256, "intermediate_size": 5632, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "partial_rotary_factor": 0.25, "max_position_embeddings": 32768,
    "tie_word_embeddings": False,
    "layer_types": (["linear_attention"] * 3 + ["full_attention"]) * 12,
    "linear_num_key_heads": 16, "linear_num_value_heads": 32, "linear_key_head_dim": 128,
    "linear_value_head_dim": 128, "linear_conv_kernel_dim": 4,
    "num_experts": 512, "num_experts_per_tok": 10, "moe_intermediate_size": 512,
    "shared_expert_intermediate_size": 512, "norm_topk_prob": True, "decoder_sparse_step": 1,
    "mlp_only_layers": [],
}
MOE_LAYERS = 12
# the float32 check's depth: one [gdn, gdn, gdn, full] block, whose experts
# take 25.8 GB in float32 on the card and again on the host
MOE_F32_LAYERS = 4


def moe_config(layers: int):
    """QWEN3_NEXT_80B_A3B cut to its first ``layers`` layers."""
    from crane_tpu_torch.models.auto import transformer_config_from_hf

    hf = dict(QWEN3_NEXT_80B_A3B, num_hidden_layers=layers,
              layer_types=QWEN3_NEXT_80B_A3B["layer_types"][:layers])
    return transformer_config_from_hf(hf)


def tree_shapes(tree, path="") -> list:
    """(path, shape, dtype) of every leaf of a parameter tree, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_shapes(tree[k], f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in tree_shapes(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape), tree.dtype)]


def expert_bytes(params) -> int:
    """Bytes of the stacked experts of every layer."""
    return sum(t.numel() * t.element_size() for layer in params["layers"]
               for name, t in layer["mlp"].items() if name.startswith("experts_"))


def check_moe_mapping() -> None:
    """``map_hf_weights`` on one full-width MoE layer in the HF layout: a
    seeded checkpoint of one GDN layer (512 experts, each its own gate, up
    and down tensors) mapped on the card, against init_params' tree for the
    same config: the same paths, shapes and dtypes, and each stacked expert
    (the first, one inside, the last) its HF tensor transposed."""
    import torch

    from crane_tpu_torch.models.auto import map_hf_weights
    from crane_tpu_torch.models.init import hf_state_dict, init_params

    cfg = moe_config(1)
    t0 = time.perf_counter()
    sd = hf_state_dict(cfg, torch.Generator(device="cuda").manual_seed(81), torch.bfloat16)
    params = map_hf_weights(cfg, sd, torch.bfloat16, "cuda")
    drawn = init_params(cfg, torch.Generator(device="cuda").manual_seed(81), device="cuda")
    if tree_shapes(params) != tree_shapes(drawn):
        raise AssertionError("map_hf_weights' MoE tree differs from init_params'")
    del drawn
    mlp, lp = params["layers"][0]["mlp"], "model.layers.0.mlp."
    pairs = [(mlp["router"], sd[lp + "gate.weight"]),
             (mlp["shared_gate"], sd[lp + "shared_expert_gate.weight"])]
    for e in (0, 255, 511):
        for name, hf_name in (("experts_gate", "gate_proj"), ("experts_up", "up_proj"),
                              ("experts_down", "down_proj")):
            pairs.append((mlp[name][e], sd[f"{lp}experts.{e}.{hf_name}.weight"]))
    if not all(torch.equal(got, ref.T) for got, ref in pairs):
        raise AssertionError("a mapped expert or router is not its HF tensor transposed")
    n_hf = sum(1 for name in sd if ".experts." in name)
    del sd, params
    torch.cuda.empty_cache()
    log("moe", f"map_hf_weights on one full-width MoE layer ({n_hf} HF expert tensors): the "
               f"tree equals init_params', each stacked expert its HF tensor transposed "
               f"({time.perf_counter() - t0:.1f} s)")


def prefill_300(model, prompt):
    """The smoke run's 300-token prefill into a fresh 512-slot row: last
    logits ``[V]``."""
    return model.prefill(model.init_cache(1, 512), [prompt], [len(prompt)])[0][0]


def sync_ms(run) -> float:
    """Host-clock ms of ``run`` between two synchronises."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_moe_model():
    """Phase 'moe': Qwen3-Next-80B-A3B at full width and MOE_LAYERS of its
    48 layers, random bf16 weights drawn on the card by ``init_params`` in
    the stacked tree (the HF layout would hold every expert twice while it
    is mapped; ``check_moe_mapping`` holds the mapping on one layer).

    Random routers put near-ties into the top-10, which bf16 and float32
    can break apart, so the check against the CPU runs in float32 on both
    sides, over the first MOE_F32_LAYERS layers (the CPU's float32 copy of
    all 12 would not fit its host): the 300-token prefill's logits to
    LOGIT_REL_L2 with the greedy top-1 (K8's float32 form on the card, the
    dense dispatch on the CPU); the bf16 prefill's distance from the CPU is
    logged beside it. The 12-layer bf16 model then runs the 300-token
    prefill (its device time by kernel family, one K8 call a layer) and 64
    greedy tokens through ``generate`` (graph decode against its own
    prefill and decode steps)."""
    import dataclasses

    import torch

    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import init_params
    from crane_tpu_torch.ops import cuda as kernels

    check_moe_mapping()
    cfg = moe_config(MOE_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(80)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log("moe", f"Qwen3-Next-80B-A3B at {cfg.num_layers} of 48 layers, full width (hidden "
               f"{cfg.hidden_size}, {cfg.num_experts} experts of {cfg.moe_intermediate_size}, "
               f"top-{cfg.num_experts_per_tok}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
               f"{cfg.head_dim}, GDN {cfg.gdn.num_k_heads}/{cfg.gdn.num_v_heads}): "
               f"{n_params / 1e9:.2f} B parameters, experts {expert_bytes(params) / 1e9:.2f} GB "
               f"bf16, drawn in {time.perf_counter() - t0:.1f} s; "
               f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the card")
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen, device="cuda").tolist()

    cfg4 = dataclasses.replace(cfg, num_layers=MOE_F32_LAYERS,
                               layer_types=cfg.layer_types[:MOE_F32_LAYERS])
    part = dict(params, layers=params["layers"][:MOE_F32_LAYERS])
    logits_bf16 = prefill_300(CausalLM(cfg4, part, dtype=torch.bfloat16), prompt)
    logits_f32 = k7_routes_launched(
        f"Qwen3-Next {MOE_F32_LAYERS} layers float32 prefill on the card",
        lambda: prefill_300(CausalLM(cfg4, _tree(part, lambda t: t.float()),
                                     dtype=torch.float32), prompt))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    logits_cpu = prefill_300(CausalLM(cfg4, _tree(part, lambda t: t.to("cpu", torch.float32)),
                                      dtype=torch.float32), prompt)
    log("moe", f"the CPU's float32 prefill of {MOE_F32_LAYERS} layers took "
               f"{time.perf_counter() - t0:.1f} s")
    compare_logits("moe", f"Qwen3-Next {MOE_F32_LAYERS} layers prefill logits card f32 vs cpu f32",
                   logits_f32, logits_cpu)
    rel_l2, top = logits_distance(logits_bf16, logits_cpu)
    log("moe", f"Qwen3-Next {MOE_F32_LAYERS} layers prefill logits card bf16 vs cpu f32: rel L2 "
               f"{rel_l2:.4g}, top-1 {top} vs {int(logits_cpu.argmax())}")
    del part, logits_cpu

    lm = CausalLM(cfg, params, dtype=torch.bfloat16)
    before = kernels.launch_counts()["moe_experts[gate_up]"]
    logits = k7_routes_launched(f"Qwen3-Next {MOE_LAYERS} layers bf16 prefill",
                                lambda: prefill_300(lm, prompt))
    if kernels.launch_counts()["moe_experts[gate_up]"] - before != MOE_LAYERS:
        raise AssertionError("the bf16 prefill did not run K8 once a layer")
    logits_distance(logits, logits)  # finite, of the vocab's shape
    log_device_ms(f"Qwen3-Next {MOE_LAYERS} layers bf16", "the 300-token prefill",
                  lambda: prefill_300(lm, prompt))
    log("moe", f"Qwen3-Next {MOE_LAYERS} layers bf16, the 300-token prefill: "
               f"{sync_ms(lambda: prefill_300(lm, prompt)):.1f} ms (host clock)")
    prefill_ms, decode_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("moe", f"Qwen3-Next {MOE_LAYERS} layers bf16: prefill 300 tokens (bucket 512) "
               f"{prefill_ms:.2f} ms, decode 63 tokens at batch 1 {decode_tps:.1f} tok/s; "
               f"generate(64) matches")
    return lm


def log_moe_decode(lm) -> None:
    """A decode step of the MoE model beside its bound, at 1, 8 and 32 rows
    of their own (log_decode_steps, graphs): K8 reads only the experts the
    rows route to, so the step's bound is every other weight but the
    embedding, read once, and the experts the rows route to, n (1 - (1 -
    k / n)^B) a layer when the router spreads the rows evenly (a random
    router does), at 3.35 TB/s. The dense dispatch's bound (every expert)
    is logged beside it."""
    params = lm.params
    cfg = lm.config
    experts = expert_bytes(params)
    weights = sum(t.numel() * t.element_size() for t in _leaves(params)) \
        - params["embed"].numel() * params["embed"].element_size()
    table = log_decode_steps(lm, f"Qwen3-Next {MOE_LAYERS} layers bf16", modes=("graph",),
                             shapes=((1, 2048, 300), (8, 2048, 300), (32, 2048, 300)),
                             distinct=True)
    n, k = cfg.num_experts, cfg.num_experts_per_tok
    for (B, _), modes in table.items():
        routed = 1 - (1 - k / n) ** B
        step_bytes = weights - experts + experts * routed
        ms = modes["graph"][0]
        log("profile", f"Qwen3-Next {MOE_LAYERS} layers bf16, a K8 decode step at B={B}: "
                       f"{ms:.3f} ms (graph, host clock) against its bound "
                       f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms ({step_bytes / 1e9:.2f} GB: "
                       f"{routed:.1%} of the experts' {experts / 1e9:.2f} GB and the other "
                       f"weights), {ms / (step_bytes / HBM_BYTES_PER_S * 1e3):.2f}x; every expert "
                       f"read, as the dense dispatch did: {weights / HBM_BYTES_PER_S * 1e3:.2f} ms")


# LFM2-1.2B, as its published config.json gives it (huggingface.co/
# LiquidAI/LFM2-1.2B): 16 layers, full attention at 2, 5, 8, 10, 12 and 14
# and a short conv (L = 3) elsewhere, hidden 2048, 32 query / 8 KV heads of
# 64, vocabulary 65536, tied head, intermediate_size 12288 with
# block_auto_adjust_ff_dim, so its MLP weights are LFM2_FF wide (HF
# Lfm2MLP: int(2 * 12288 / 3), rounded up to a multiple of 256).
LFM2_1_2B = {
    "model_type": "lfm2", "vocab_size": 65536, "hidden_size": 2048, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8, "intermediate_size": 12288,
    "block_auto_adjust_ff_dim": True, "block_ffn_dim_multiplier": 1.0, "block_multiple_of": 256,
    "norm_eps": 1e-5, "rope_theta": 1000000.0, "max_position_embeddings": 128000,
    "conv_L_cache": 3, "conv_bias": False, "tie_word_embeddings": True,
    "layer_types": ["full_attention" if i in (2, 5, 8, 10, 12, 14) else "conv"
                    for i in range(16)],
}
LFM2_FF = 8192


def check_lfm2_model():
    """Phase 'lfm2': LFM2-1.2B at full size, random bf16 weights in the HF
    layout (LFM2's own names) from a seeded generator, mapped by
    ``map_hf_weights``. The weights are drawn at the published checkpoint's
    widths: the MLP LFM2_FF wide, while the config (as ``crane_tpu`` reads
    it, ignoring ``block_auto_adjust_ff_dim``) says 12288, as a published
    checkpoint loads. The 300-token prefill in bf16 against float32 on the
    CPU (LOGIT_REL_L2, greedy top-1); the same prompt as a 256-token slot
    prefill and a 44-token continuation chunk into a 2-slot cache against
    one whole slot prefill; 64 greedy tokens through ``generate``."""
    import dataclasses

    import torch

    from crane_tpu_torch.models.auto import map_hf_weights, transformer_config_from_hf
    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import hf_state_dict

    cfg = transformer_config_from_hf(LFM2_1_2B)
    drawn = dataclasses.replace(cfg, intermediate_size=LFM2_FF)
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = map_hf_weights(cfg, hf_state_dict(drawn, gen, torch.bfloat16), torch.bfloat16, "cuda")
    if params["layers"][0]["mlp"]["gate"].shape[1] != LFM2_FF or cfg.intermediate_size != 12288:
        raise AssertionError("LFM2's MLP weights are not the checkpoint's width")
    n_params = sum(t.numel() for t in _leaves(params))
    lm = CausalLM(cfg, params, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen, device="cuda").tolist()

    logits_gpu = prefill_300(lm, prompt)
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    logits_cpu = prefill_300(CausalLM(cfg, cpu_params, dtype=torch.float32), prompt)
    del cpu_params
    compare_logits("lfm2", "LFM2-1.2B prefill logits card bf16 vs cpu f32", logits_gpu, logits_cpu)

    whole, first, rest = [prompt + [0] * 212], [prompt[:256]], [prompt[256:] + [0] * 20]
    logits_whole, _ = lm.prefill_slot(lm.init_cache(2, 2048), whole, 1, 300)
    _, cache = lm.prefill_slot(lm.init_cache(2, 2048), first, 1, 256)
    logits_chunked, cache = lm.prefill_slot_continue(cache, rest, 1, 256, 44)
    compare_logits("lfm2", "LFM2-1.2B a 256-token slot prefill + a 44-token chunk vs the whole "
                           "300-token slot prefill", logits_chunked[0], logits_whole[0])

    log_device_ms("LFM2-1.2B bf16", "the 300-token prefill", lambda: prefill_300(lm, prompt))
    prefill_ms, decode_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("lfm2", f"LFM2-1.2B bf16, {cfg.num_layers} layers ({n_params / 1e9:.3f} B parameters, "
                f"MLP {LFM2_FF} wide): prefill 300 tokens (bucket 512) {prefill_ms:.2f} ms, "
                f"decode 63 tokens at batch 1 {decode_tps:.1f} tok/s; generate(64) matches")
    return lm


def check_oov(lm) -> None:
    """Phase 'oov': a prompt id outside the vocabulary on a running engine.
    The port's server over a threaded engine (serve_http) answers 400 to
    /generate with such ``input_ids``; ``engine.submit`` ends one with an
    id of ``vocab`` and one with -1 in an error response; a good prompt
    submitted after them is served, the engine thread still alive, and its
    16 greedy tokens equal those of the same request alone on a fresh
    engine of the same shape stepped inline (the card's CUDA context still
    works: no device-side assert ran)."""
    import torch

    from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions

    vocab = lm.config.vocab_size
    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    good = torch.randint(0, vocab, (40,), generator=torch.Generator().manual_seed(13)).tolist()
    bad = {"oov-high": good[:20] + [vocab] + good[20:], "oov-negative": [-1] + good}

    def answer(q) -> tuple[list[int], str | None]:
        toks = []
        while True:
            r = q.get(timeout=120)  # raises if the engine does not answer
            if r.token is not None:
                toks.append(r.token)
            if r.finished or r.error is not None:
                return toks, r.error

    lm.tokenizer = StandInTokenizer(vocab)
    engine, srv = serve_http(lm)
    try:
        status, body = http_json(srv.port, "POST", "/generate", {
            "input_ids": bad["oov-high"],
            "sampling_params": {"max_new_tokens": 16, "temperature": 0,
                                "repetition_penalty": 1.0}})
        if status != 400 or "vocabulary" not in json.dumps(body):
            raise AssertionError(f"/generate with an id of {vocab}: {status} {body}")
        errors = {}
        for rid, ids in bad.items():
            toks, errors[rid] = answer(engine.submit(EngineRequest(rid, ids, 16, greedy)))
            if toks or not errors[rid] or "vocabulary" not in errors[rid]:
                raise AssertionError(f"{rid}: tokens {toks}, error {errors[rid]!r}")
        served, err = answer(engine.submit(EngineRequest("good", good, 16, greedy)))
        if err is not None or len(served) != 16 or not engine._thread.is_alive():
            raise AssertionError(f"the request after the bad ones: {len(served)} tokens, "
                                 f"error {err!r}, engine thread alive "
                                 f"{engine._thread.is_alive()}")
    finally:
        srv.close()
        engine.stop()
        lm.tokenizer = None
    torch.cuda.synchronize()
    fresh = InferenceEngine(lm, max_slots=8, max_seq_len=2048, prefill_chunk=256)
    fresh.warmup()
    alone, _ = serve_greedy(fresh, {"good": good}, 16)
    if alone["good"] != served:
        raise AssertionError(f"after the bad requests {served} vs a fresh engine {alone['good']}")
    lm.release_graphs()
    log("oov", f"/generate answered 400 to an id of {vocab}; engine.submit answered "
               f"{json.dumps(errors)}; the next request's 16 greedy tokens equal a fresh "
               f"engine's, the engine thread alive")


def check_unrun_paths(lm, lm35) -> None:
    """Phase 'paths': three served paths the card had not run before, each
    through an existing check.

    - Qwen3.5-0.8B (bf16) on an int8 KV cache: its attention layers keep
      codes (K4 and K5 at head_dim 256), its GDN layers their states; the
      engine mix (check_engine) and graphs against eager (graph_vs_eager);
    - Qwen3.5-0.8B in four slabs on the one card (sequence parallelism;
      its attention layers' caches split into slabs, K1-S and K3-S, its GDN
      states whole on the lead device): sp_greedy's 5000-token prompt and
      8 greedy steps in float32 against the unsharded model (compare_sp);
    - Qwen3-0.6B with int8 ISQ weights (quantized from its float32
      weights) in four slabs: the same against the unsharded w8 model (K6
      in float32 on both sides).

    Returns nothing; the launches each made are logged and required."""
    import torch

    from crane_tpu_torch.models.auto import quantize_params
    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm

    reset_counts()
    check_engine(lm35, "paths hybrid kv8", kv_quant_bits=8)
    graph_vs_eager(lm35, "Qwen3.5-0.8B bf16 kv8", kv_bits=8)
    require_launched("Qwen3.5-0.8B int8 KV path", kernels.launch_counts(), (
        "quant_decode_attention[kv8]", "quant_cached_attention[kv8]", "flash_attention_causal",
        "gdn_scan[chunk]"))
    no_plain_routes("Qwen3.5-0.8B int8 KV path")
    lm35.release_graphs()

    mesh = make_sp_mesh(4, ["cuda:0"] * 4)
    gen = torch.Generator().manual_seed(14)
    for label, model, need in (
            ("Qwen3.5-0.8B float32",
             CausalLM(lm35.config, _tree(lm35.params, lambda t: t.float()), dtype=torch.float32),
             ("fp_decode_attention_with_stats", "flash_attention_cached_with_stats",
              "gdn_scan[chunk]")),
            ("Qwen3-0.6B w8 float32",
             CausalLM(lm.config, quantize_params(_tree(lm.params, lambda t: t.float()), bits=8),
                      dtype=torch.float32),
             ("fp_decode_attention_with_stats", "flash_attention_cached_with_stats",
              "quant_matmul[w8]"))):
        prompt = torch.randint(0, model.config.vocab_size, (5000,), generator=gen).tolist()
        ref, _ = sp_greedy(model, prompt, None, 8)
        feed = [int(x.argmax()) for x in ref[:-1]]
        reset_counts()
        got, _ = sp_greedy(sp_shard_lm(model, mesh), prompt, None, 8, feed)
        counts = kernels.launch_counts()
        compare_sp(f"{label}, 5000-token prompt over 3 of 4 slabs", got, ref, SP_REL_L2[None])
        require_launched(f"{label} sp path", counts, need)
        if counts["fp_decode_attention"] or counts["flash_attention_cached"]:
            raise AssertionError(f"{label}: K1 or K3 ran on a sequence-sharded layer")
        no_plain_routes(f"{label} sp path")
        del model, ref, got
    torch.cuda.empty_cache()


def reset_counts() -> None:
    """Zero the kernels' launch counters and the attention router's count of
    calls routed to a plain version by shape."""
    from crane_tpu_torch.models.modules.transformer import attention_block
    from crane_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    for kind in attention_block.plain_routes:
        attention_block.plain_routes[kind] = 0


def no_plain_routes(path: str) -> None:
    """Fail if the path routed any attention call to a plain version: every
    model the smoke run drives has heads the kernels take. A path whose
    counts show no attention launch either says that it made no attention
    call."""
    from crane_tpu_torch.models.modules.transformer import attention_block
    from crane_tpu_torch.ops import cuda as kernels

    if any(attention_block.plain_routes.values()):
        raise AssertionError(f"the {path} routed attention to a plain version: "
                             f"{attention_block.plain_routes}")
    launched = {k: n for k, n in kernels.launch_counts().items() if n and "attention" in k}
    if not launched:
        log("routes", f"{path}: no attention call was made (no attention kernel launched, "
                      f"plain routes {json.dumps(attention_block.plain_routes)})")
        return
    log("routes", f"{path}: every attention call went to a kernel (plain routes "
                  f"{json.dumps(attention_block.plain_routes)})")


# tiny llama-like configs whose heads the kernels do not take: head_dim 96,
# and 16 query heads on one kv-head (over the decode kernels' group of 8),
# with the kinds of attention call that go to a plain version
ROUTED_CONFIGS = {
    "head_dim 96": (dict(num_heads=4, num_kv_heads=2, head_dim=96), {"decode", "prefill", "chunk"}),
    "16 query heads on 1 kv-head": (dict(num_heads=16, num_kv_heads=1, head_dim=64), {"decode"}),
}


def check_routed_configs() -> None:
    """Phase 'routes': attention routed by shape. Each ROUTED_CONFIGS model,
    float32 on the card and on the CPU with the same weights: a fresh
    40-token prefill, a 12-token continuation chunk and a decode step agree
    (hidden states to 1e-4), and generate gives the same 16 greedy tokens;
    the attention calls of the kinds the kernels do not take went to the
    plain versions (attention_block.plain_routes), and a direct kernel call
    with those heads still raises."""
    import dataclasses

    import torch

    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import QWEN3_TINY, init_params
    from crane_tpu_torch.models.modules.transformer import (
        attention_block,
        forward_hidden,
        make_cache,
    )
    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    for name, (fields, kinds) in ROUTED_CONFIGS.items():
        cfg = dataclasses.replace(QWEN3_TINY, qk_norm=False, max_position_embeddings=512,
                                  **fields)
        params = init_params(cfg, torch.Generator().manual_seed(11), device="cpu",
                             dtype=torch.float32)
        models = (CausalLM(cfg, params, dtype=torch.float32),
                  CausalLM(cfg, _tree(params, lambda t: t.to("cuda")), dtype=torch.float32))
        gen = torch.Generator().manual_seed(5)
        steps = [(torch.randint(1, 500, (2, 20), generator=gen), 0, False),
                 (torch.randint(1, 500, (2, 12), generator=gen), 20, True),
                 (torch.randint(1, 500, (2, 1), generator=gen), 32, True)]
        reset_counts()
        hidden = {}
        for lm in models:
            cache = make_cache(cfg, 2, 48, torch.float32, device=lm.device)
            hidden[lm.device.type] = []
            for toks, start, read in steps:
                pos = torch.full((2,), start, dtype=torch.int32, device=lm.device) \
                    if toks.shape[1] == 1 else start
                h, cache = forward_hidden(cfg, lm.params, toks.to(lm.device, torch.int32),
                                          cache, pos, lm.rope, read_cache=read)
                hidden[lm.device.type].append(h)
        for h_gpu, h_cpu in zip(hidden["cuda"], hidden["cpu"]):
            compare(f"routes {name} hidden", h_gpu.cpu(), h_cpu, rtol=1e-4, atol=1e-4)
        prompt = torch.randint(1, 500, (40,), generator=gen).tolist()
        toks = [lm.generate(prompt, GenerationConfig.greedy(16)) for lm in models]
        if toks[0] != toks[1]:
            raise AssertionError(f"routes {name}: greedy tokens on the card {toks[1]} vs the "
                                 f"CPU {toks[0]}")
        routed = {k for k, n in attention_block.plain_routes.items() if n}
        if routed != kinds:
            raise AssertionError(f"routes {name}: plain routes {attention_block.plain_routes}, "
                                 f"expected {sorted(kinds)}")
        D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        q = torch.zeros(1, 1, Hq, D, device="cuda")
        kv = torch.zeros(1, 4, Hkv, D, device="cuda")
        try:
            if D in k23.HEAD_DIMS:
                k1.fp_decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32, device="cuda"),
                                       scale=0.1)
            else:
                k23.flash_attention_causal(q, kv[:, :1], kv[:, :1], scale=0.1)
            raise AssertionError(f"routes {name}: a direct kernel call with these heads ran")
        except ValueError:
            pass
        log("routes", f"{name} (head_dim {D}, {Hq}/{Hkv} heads), float32: prefill, chunk and "
                      f"decode agree with the CPU, generate(16) tokens equal; plain routes "
                      f"{json.dumps(attention_block.plain_routes)}; a direct kernel call raises")


def read_launches(path: str, rows: list[dict], counts: dict[str, int]) -> None:
    """Each row's launches from the path that drove it (a head_dim 256 or an
    M=256 row reads its wrapper's counter); fail for a kernel that path
    never launched."""
    log("launches", f"{path}: {json.dumps(counts)}")
    for row in rows:
        name = row["name"]
        for tag in (*FUSED_TAGS, LONG, D256, M256, LFM2_HEADS, NEXT_HEADS, H32, G3N_HEADS,
                    SEG_HEADS, MHA_HEADS, PRED_PREFILL, PRED_STEP, DEPTH_CHUNK, TP_06, TP_35,
                    TP_NEXT, TP_H8):
            name = name.removesuffix(tag)
        row["launches"] = counts[name.split(K8_AT)[0]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched by the {path}")


# ---------------------------------------------------------------------------
# Phases 19 (gemma3n) and 20 (vlm): Gemma 3n and the vision-language models

# Gemma 3n E4B's text model: transformers' Gemma3nTextConfig() defaults
# (transformers 4.57.6): 35 layers, every fifth full attention and the rest
# sliding (window 512), the last 15 sharing the KV of layers 18 and 19,
# activation sparsity 0.95 on the first 10, vocabulary 262400 with a
# per-layer table of 262144 rows.
GEMMA3N_E4B = {
    "model_type": "gemma3n_text", "vocab_size": 262400, "vocab_size_per_layer_input": 262144,
    "hidden_size": 2048, "hidden_size_per_layer_input": 256, "num_hidden_layers": 35,
    "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 256,
    "intermediate_size": [16384] * 35, "sliding_window": 512, "num_kv_shared_layers": 15,
    "laurel_rank": 64, "altup_num_inputs": 4, "altup_active_idx": 0,
    "altup_correct_scale": True, "rope_theta": 1_000_000.0, "rope_local_base_freq": 10_000.0,
    "rms_norm_eps": 1e-6, "final_logit_softcapping": 30.0, "max_position_embeddings": 32768,
    "activation_sparsity_pattern": [0.95] * 10 + [0.0] * 25,
    "layer_types": ["full_attention" if (i + 1) % 5 == 0 else "sliding_attention"
                    for i in range(35)],
    "tie_word_embeddings": True,
}
# the float32 check's cut: every width kept, the first 12 layers with the
# last 4 of them KV-shared (both attention types, the sparse layers 0-9 and
# two dense ones); 10.8 GB in float32 on the card and again on the host
GEMMA3N_F32_LAYERS, GEMMA3N_F32_SHARED = 12, 4
GEMMA3N_PROMPT, GEMMA3N_CACHE, GEMMA3N_NEW = 1000, 2048, 64

# Qwen3-VL-2B-Instruct: the text shapes of bench.py's vl mode, and the
# published vision_config (depth 24, hidden 1024, MLP 4096, 16 heads, patch
# 16, temporal patch 2, merge 2, out 2048, 2304 position embeddings,
# DeepStack taps after blocks 5, 11, 17); the published special ids
QWEN3_VL_2B = {
    "model_type": "qwen3_vl", "tie_word_embeddings": True,
    "text_config": {
        "vocab_size": 151936, "hidden_size": 2048, "num_hidden_layers": 28,
        "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 128,
        "intermediate_size": 6144, "rms_norm_eps": 1e-6, "rope_theta": 5_000_000.0,
        "max_position_embeddings": 262144, "tie_word_embeddings": True,
        "rope_scaling": {"rope_type": "default", "mrope_section": [24, 20, 20],
                         "mrope_interleaved": True}},
    "vision_config": {
        "depth": 24, "hidden_size": 1024, "intermediate_size": 4096, "num_heads": 16,
        "patch_size": 16, "temporal_patch_size": 2, "spatial_merge_size": 2,
        "out_hidden_size": 2048, "num_position_embeddings": 2304,
        "deepstack_visual_indexes": [5, 11, 17], "hidden_act": "gelu_pytorch_tanh"},
    "image_token_id": 151655, "video_token_id": 151656, "vision_start_token_id": 151652,
}
QWEN3_VL_VISION_END = 151653
QWEN3_VL_IMAGE = 448  # 28 x 28 patches of 16, 196 image tokens
QWEN3_VL_FRAMES, QWEN3_VL_FRAME = 4, 224  # a video of 2 temporal patches, 49 tokens each

# Gemma3-4B (google/gemma-3-4b-it config.json): text 34 layers, hidden 2560,
# 8 query / 4 KV heads of 256, MLP 10240, every sixth layer full attention
# and the rest sliding (window 1024), linear rope scaling 8 on the full
# layers; SigLIP-so400m at 896 px in patches of 14 (4096 patches), 27
# layers of 1152, 16 heads, MLP 4304; 256 tokens an image
GEMMA3_4B = {
    "model_type": "gemma3",
    "text_config": {
        "vocab_size": 262208, "hidden_size": 2560, "intermediate_size": 10240,
        "num_hidden_layers": 34, "num_attention_heads": 8, "num_key_value_heads": 4,
        "head_dim": 256, "rms_norm_eps": 1e-6, "rope_theta": 1_000_000.0,
        "rope_local_base_freq": 10_000.0, "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "sliding_window": 1024, "query_pre_attn_scalar": 256,
        "max_position_embeddings": 131072, "tie_word_embeddings": True,
        "layer_types": ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                        for i in range(34)]},
    "vision_config": {
        "hidden_size": 1152, "num_hidden_layers": 27, "num_attention_heads": 16,
        "intermediate_size": 4304, "image_size": 896, "patch_size": 14, "layer_norm_eps": 1e-6},
    "mm_tokens_per_image": 256, "image_token_index": 262144,
    "boi_token_index": 255999, "eoi_token_index": 256000,
}
# the bf16-against-CPU check's cut: 6 of 34 text layers (five sliding, one
# full) and 4 of 27 SigLIP layers, every width kept
GEMMA3_F32_TEXT_LAYERS, GEMMA3_F32_VISION_LAYERS = 6, 4

# PaddleOCR-VL (PaddlePaddle/PaddleOCR-VL config.json): an ERNIE-4.5-0.3B
# decoder (18 layers of 1024, 16 query / 2 KV heads of 128, MLP 3072,
# vocabulary 103424) and a NaViT tower of SigLIP-so400m shape (27 layers of
# 1152, 16 heads, MLP 4304, patch 14, a 27 x 27 position table) with the 2x2
# merge projector into 1024
PADDLEOCR_VL = {
    "model_type": "paddleocr_vl", "vocab_size": 103424, "hidden_size": 1024,
    "num_hidden_layers": 18, "num_attention_heads": 16, "num_key_value_heads": 2,
    "head_dim": 128, "intermediate_size": 3072, "rms_norm_eps": 1e-5, "rope_theta": 500_000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": True,
    "image_token_id": 100295,
    "vision_config": {
        "num_hidden_layers": 27, "hidden_size": 1152, "intermediate_size": 4304,
        "num_attention_heads": 16, "patch_size": 14, "spatial_merge_size": 2,
        "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6, "image_size": 384},
}
PADDLE_PAGE = (560, 420)  # a synthetic page, 40 x 30 patches, 300 image tokens
PADDLE_NEW = 16

# float32 on the card against float32 on the CPU, the same weights: the
# same sums in another order (cuBLAS and the kernels' float32 routes), so
# the logits and features agree to F32_REL_L2
F32_REL_L2 = 1e-3

# kernel-row tags of this slice's shapes
G3N_HEADS = "[D256-8/2 scale1 w512]"
SEG_HEADS = "[D256-8/4 segments]"


def draw_checkpoint(shapes: dict, gen, dtype, tables=()) -> dict:
    """Random HF tensors of the given shapes on ``gen``'s device: weights
    of two or more dims normal with std fan_in ** -0.5 (fan_in their
    product past the first), the embedding and position tables in
    ``tables`` with std 0.02, biases zero, other 1-D weights (norms,
    scales) one."""
    import torch

    sd = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            sd[name] = torch.full(shape, 0.0 if name.endswith("bias") else 1.0, dtype=dtype,
                                  device=gen.device)
            continue
        std = 0.02 if name in tables else torch.Size(shape[1:]).numel() ** -0.5
        sd[name] = (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)
    return sd


def rel_l2(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        raise AssertionError(f"not finite or of shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    return ((got - ref).norm() / ref.norm()).item()


def check_f32(phase: str, label: str, got, ref, limit: float = F32_REL_L2,
              versus: str = "float32 card vs CPU") -> float:
    """float32 card output against float32 on the CPU (or the reference
    ``versus`` names): finite, same shape, relative L2 within ``limit``."""
    err = rel_l2(got, ref)
    log(phase, f"{label}: rel L2 {err:.3g} (limit {limit:g}), {versus}")
    if err > limit:
        raise AssertionError(f"{label}: {versus} disagree")
    return err


def tie_at_first_difference(phase, label, ref_toks, other_toks, ref_logits) -> None:
    """Where two greedy token lists part, the reference path's step is
    replayed (``ref_logits(i)``, the logits that chose ``ref_toks[i]`` on
    the reference path's own state): it must choose its token again, and
    the other token must lie within LOGIT_TIE of it."""
    n = min(len(ref_toks), len(other_toks))
    i = next((j for j in range(n) if ref_toks[j] != other_toks[j]), None)
    if i is None:
        if len(ref_toks) != len(other_toks):
            raise AssertionError(f"{label}: {len(other_toks)} tokens vs {len(ref_toks)}")
        log(phase, f"{label}: {n} greedy tokens identical")
        return
    logits = ref_logits(i).float().cpu()
    ref_t, other_t = ref_toks[i], other_toks[i]
    gap = (logits[ref_t] - logits[other_t]).item()
    log(phase, f"{label}: tokens part at step {i} ({ref_t} vs {other_t}); replayed, the "
               f"reference chooses {int(logits.argmax())} and the gap is {gap:.4g} (tie "
               f"{LOGIT_TIE})")
    if int(logits.argmax()) != ref_t or gap > LOGIT_TIE:
        raise AssertionError(f"{label}: the paths part at step {i} without a tie")


def log_busy(phase: str, label: str, what: str, run) -> None:
    """The wall time of ``run`` (host clock, synchronised), the kernel time
    the profiler sums for it, and the device's idle share between them."""
    wall = sync_ms(run)
    fam = log_device_ms(label, what, run)
    busy = sum(fam.values())
    if busy > 0:
        log(phase, f"{label}, {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                   f"{1 - busy / wall:.3f}")


def check_slice_kernels() -> list[dict]:
    """Phase 3 at this slice's shapes: K1 with Gemma 3n's 8 query / 2 KV
    heads of 256, scale 1.0, over 1200 live slots of a 2048-slot cache,
    with the sliding window of 512 (the row) and without; K2 with segments
    at Gemma3-4B's 8 / 4 heads of 256 on a 300-token prompt whose 256 image
    tokens form one bidirectional segment. Each against its plain version,
    timed beside it and SDPA (with the window's or the segments' boolean
    mask). Returns the rows, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    gen = torch.Generator(device="cuda").manual_seed(1912)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = []
    T, live, W = 2048, 1200, 512
    q, k, v = rnd(1, 1, 8, 256), rnd(1, T, 2, 256), rnd(1, T, 2, 256)
    valid = torch.tensor([live], dtype=torch.int32, device="cuda")
    errs = [compare(f"K1 Gemma 3n heads scale 1.0{label}",
                    k1.fp_decode_attention(q, k, v, valid, scale=1.0, **kw),
                    k1.fp_decode_attention_plain(q, k, v, valid, scale=1.0, **kw))
            for label, kw in (("", {}), (f" window {W}", {"window": W}))]
    t = torch.arange(T, device="cuda")
    window_mask = ((t < live) & (t >= live - W))[None, None, None]
    rows.append(timed_row(
        "fp_decode_attention" + G3N_HEADS, "decode_attention.cu",
        "crane_tpu/ops/pallas/quant_attention.py:266", errs,
        lambda: k1.fp_decode_attention(q, k, v, valid, scale=1.0, window=W),
        lambda: k1.fp_decode_attention_plain(q, k, v, valid, scale=1.0, window=W),
        f"B=1 T={T}, {live} live slots, window {W}, Hq=8 Hkv=2 D=256",
        decode_work(q, 2, valid.clamp(max=W)),
        lambda: sdpa(q, k, v, mask=window_mask)))

    S, lo, hi = 300, 20, 276
    q, k, v = rnd(1, S, 8, 256), rnd(1, S, 4, 256), rnd(1, S, 4, 256)
    seg = torch.zeros(1, S, dtype=torch.int32, device="cuda")
    seg[0, lo:hi] = 1
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) | ((seg[0, :, None] == seg[0, None, :]) & (seg[0, :, None] > 0))
    pairs = int(mask.sum())
    errs = [compare("K2 Gemma3-4B heads with segments",
                    k23.flash_attention_causal(q, k, v, seg, scale=256 ** -0.5),
                    k23.flash_attention_causal_plain(q, k, v, seg, scale=256 ** -0.5)),
            compare("K2 Gemma3-4B heads with segments, window 64",
                    k23.flash_attention_causal(q, k, v, seg, scale=256 ** -0.5, window=64),
                    k23.flash_attention_causal_plain(q, k, v, seg, scale=256 ** -0.5, window=64))]
    rows.append(timed_row(
        "flash_attention_causal" + SEG_HEADS, "flash_attention_mma.cu",
        "crane_tpu/ops/pallas/flash_attention.py:187", errs,
        lambda: k23.flash_attention_causal(q, k, v, seg, scale=256 ** -0.5),
        lambda: k23.flash_attention_causal_plain(q, k, v, seg, scale=256 ** -0.5),
        f"B=1 S={S}, one segment of {hi - lo} tokens, Hq=8 Hkv=4 D=256",
        attn_work(1, S, 8, 4, 256, pairs, S, 2 * 256, 4 * S),
        lambda: sdpa(q, k, v, mask=mask[None, None])))
    return rows


def gemma3n_config(layers: int | None = None, shared: int | None = None) -> dict:
    """GEMMA3N_E4B, or its first ``layers`` layers with the last ``shared``
    of them KV-shared."""
    if layers is None:
        return GEMMA3N_E4B
    cut = {k: (v[:layers] if isinstance(v, list) else v) for k, v in GEMMA3N_E4B.items()}
    return dict(cut, num_hidden_layers=layers, num_kv_shared_layers=shared)


def gemma3n_model(hf: dict, seed: int, dtype, max_seq: int):
    """A Gemma3nLM of config ``hf`` on the card, from a random checkpoint in
    the HF layout mapped by ``map_hf_weights``."""
    import torch

    from crane_tpu_torch.models import gemma3n as g3n

    cfg = g3n.config_from_hf(hf)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = draw_checkpoint(g3n.hf_shapes(cfg, hf["laurel_rank"]), gen, dtype,
                         tables=("model.embed_tokens.weight",
                                 "model.embed_tokens_per_layer.weight"))
    params = g3n.map_hf_weights(cfg, sd, dtype, "cuda")
    del sd
    torch.cuda.empty_cache()
    return g3n.Gemma3nLM(cfg, params, max_seq=max_seq)


def gemma3n_prompt(cfg, n: int, seed: int) -> list[int]:
    """``n`` seeded ids with two past the per-layer table (in
    [vocab_size_per_layer_input, vocab_size)), at positions 3 and n - 2."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size_per_layer_input, (n,), generator=g).tolist()
    ids[3], ids[n - 2] = cfg.vocab_size_per_layer_input + 7, cfg.vocab_size - 1
    return ids


def gemma3n_replay(lm, prompt, toks):
    """The eager path's logits that chose ``toks[i]``: a prefill, then
    ``toks[:i]`` decoded step by step."""
    def logits_at(i):
        cache = lm.new_cache()
        logits, cache = lm.prefill([prompt], cache, last_only=True)
        for j, t in enumerate(toks[:i]):
            logits, cache = lm.decode_step([[t]], cache, [len(prompt) + j])
        return logits[0]
    return logits_at


def check_gemma3n_model():
    """Phase 'gemma3n': Gemma 3n E4B's text model (GEMMA3N_E4B) with random
    weights in the HF layout. First GEMMA3N_F32_LAYERS layers in float32:
    a prefill holding two ids past the per-layer table, and 4 decode steps
    (K1 with scale 1.0, on the shared layers over their source's cache) on
    the card against the CPU. Then the whole model in bf16: a
    GEMMA3N_PROMPT-token prefill in a GEMMA3N_CACHE-slot cache (the sliding
    window bites), GEMMA3N_NEW greedy tokens through the decode-step graph
    against the eager step (the tie rule), and the step's times. Returns
    the bf16 model."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models.gemma3n import Gemma3nLM

    t0 = time.perf_counter()
    lm32 = gemma3n_model(gemma3n_config(GEMMA3N_F32_LAYERS, GEMMA3N_F32_SHARED), 19,
                         torch.float32, 64)
    cpu = Gemma3nLM(lm32.cfg, _tree(lm32.params, lambda t: t.cpu()), max_seq=64)
    prompt = gemma3n_prompt(lm32.cfg, 40, 1)
    logits_gpu, cache_gpu = lm32.prefill([prompt], lm32.new_cache(), last_only=True)
    logits_cpu, cache_cpu = cpu.prefill([prompt], cpu.new_cache(), last_only=True)
    check_f32("gemma3n", f"{GEMMA3N_F32_LAYERS}-layer prefill of {len(prompt)} tokens, two of "
                         f"them past the per-layer table", logits_gpu, logits_cpu)
    tok = int(logits_cpu[0].argmax())
    for j in range(4):
        step_gpu = lm32.decode_graph([[tok]], cache_gpu, [len(prompt) + j])
        step_cpu, cache_cpu = cpu.decode_step([[tok]], cache_cpu, [len(prompt) + j])
        check_f32("gemma3n", f"decode step {j} (K1, scale 1.0; layers {lm32.cfg.first_shared_layer}"
                             f"-{lm32.cfg.num_layers - 1} read layers "
                             f"{sorted({lm32.cfg.kv_source(i) for i in range(lm32.cfg.first_shared_layer, lm32.cfg.num_layers)})})",
                  step_gpu, step_cpu)
        tok = int(step_cpu[0].argmax())
    lm32.release_graphs()
    del lm32, cpu, cache_gpu, cache_cpu
    torch.cuda.empty_cache()
    log("gemma3n", f"float32 check done in {time.perf_counter() - t0:.1f} s")

    lm = gemma3n_model(gemma3n_config(), 20, torch.bfloat16, GEMMA3N_CACHE)
    n_params = sum(t.numel() for t in _leaves(lm.params))
    prompt = gemma3n_prompt(lm.cfg, GEMMA3N_PROMPT, 2)
    logits, _ = lm.prefill([prompt], lm.new_cache(), last_only=True)
    if not bool(logits.isfinite().all()):
        raise AssertionError("Gemma 3n's bf16 prefill logits are not finite")
    prefill_ms = sync_ms(lambda: lm.prefill([prompt], lm.new_cache(), last_only=True))
    t1 = time.perf_counter()
    toks = lm.generate_greedy([prompt], GEMMA3N_NEW)
    graph_s = time.perf_counter() - t1
    with graphs.eager():
        t1 = time.perf_counter()
        eager = lm.generate_greedy([prompt], GEMMA3N_NEW)
        eager_s = time.perf_counter() - t1
    if not all(0 <= t < lm.cfg.vocab_size for t in toks):
        raise AssertionError("Gemma 3n generated an id outside the vocabulary")
    tie_at_first_difference("gemma3n", f"Gemma 3n bf16 {GEMMA3N_NEW} tokens, graphs vs eager",
                            eager, toks, gemma3n_replay(lm, prompt, eager))
    cache = lm._generate_caches[lm.max_seq]
    pos = [len(prompt) + GEMMA3N_NEW]
    step_graph = sync_ms(lambda: [lm.decode_graph([[5]], cache, pos) for _ in range(8)]) / 8
    with graphs.eager():
        step_eager = sync_ms(lambda: [lm.decode_graph([[5]], cache, pos) for _ in range(8)]) / 8
    log_busy("gemma3n", "Gemma 3n bf16", f"8 graph decode steps after {pos[0]} tokens",
             lambda: [lm.decode_graph([[5]], cache, pos) for _ in range(8)])
    log("gemma3n", f"Gemma 3n E4B text, {lm.cfg.num_layers} layers, bf16 ({n_params / 1e9:.3f} B "
                   f"parameters): prefill {GEMMA3N_PROMPT} tokens {prefill_ms:.1f} ms (window "
                   f"{lm.cfg.sliding_window}, {GEMMA3N_CACHE}-slot cache); decode step {step_graph:.3f} "
                   f"ms as a graph vs {step_eager:.3f} ms eager; generate({GEMMA3N_NEW}) "
                   f"{graph_s:.2f} s with graphs, {eager_s:.2f} s eager")
    return lm


def check_gemma3n_http(lm) -> None:
    """Gemma 3n served through ``TextBackend`` (no engine) over HTTP with
    the stand-in tokenizer: 4 chat requests, 2 streamed, one holding an id
    past the per-layer table; each answer's ids equal ``generate_greedy``
    on the same prompt ids."""
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.backend import TextBackend
    from crane_tpu_torch.serve.transport import BackgroundServer

    tok = StandInTokenizer(lm.cfg.vocab_size)
    server = Server(None, model_name="gemma3n", text_backend=TextBackend(lm, tok, name="gemma3n"))
    http_server = BackgroundServer(build_app(server))
    try:
        for r in range(4):
            ids = gemma3n_prompt(lm.cfg, 24 + 8 * r, 40 + r)
            messages = [{"role": "user", "content": " ".join(f"t{i}" for i in ids)}]
            body = {"messages": messages, "max_tokens": 16, "stream": r % 2 == 1}
            if r % 2:
                text = chat_text(http_stream(http_server.port, "/v1/chat/completions", body)["events"])
            else:
                status, answer = http_json(http_server.port, "POST", "/v1/chat/completions", body)
                if status != 200:
                    raise AssertionError(f"gemma3n chat: status {status}, {answer}")
                text = answer["choices"][0]["message"]["content"]
            want = lm.generate_greedy([tok.encode(tok.apply_chat_template(messages))], 16)
            if tok.ids(text) != want:
                raise AssertionError(f"gemma3n over HTTP: {tok.ids(text)} vs {want}")
    finally:
        http_server.close()
    log("gemma3n", "4 chat requests (2 streamed) through TextBackend over HTTP: ids equal "
                   "generate_greedy's")


def qwen3_vl_vision_shapes(vcfg) -> dict:
    """Name -> shape of the ``model.visual.`` tensors of an HF Qwen3-VL
    checkpoint (``[out, in]`` linears, the Conv3d patch embed)."""
    E, I, unit = vcfg.hidden_size, vcfg.intermediate_size, vcfg.merge_unit
    p = "model.visual."
    shapes = {p + "patch_embed.proj.weight": (E, vcfg.in_channels, vcfg.temporal_patch_size,
                                              vcfg.patch_size, vcfg.patch_size),
              p + "patch_embed.proj.bias": (E,),
              p + "pos_embed.weight": (vcfg.num_position_embeddings, E)}
    for i in range(vcfg.depth):
        b = f"{p}blocks.{i}."
        shapes.update({b + "norm1.weight": (E,), b + "norm1.bias": (E,),
                       b + "norm2.weight": (E,), b + "norm2.bias": (E,),
                       b + "attn.qkv.weight": (3 * E, E), b + "attn.qkv.bias": (3 * E,),
                       b + "attn.proj.weight": (E, E), b + "attn.proj.bias": (E,),
                       b + "mlp.linear_fc1.weight": (I, E), b + "mlp.linear_fc1.bias": (I,),
                       b + "mlp.linear_fc2.weight": (E, I), b + "mlp.linear_fc2.bias": (E,)})
    mergers = [("merger", E)] + [(f"deepstack_merger_list.{j}", unit * E)
                                 for j in range(len(vcfg.deepstack_indexes))]
    for name, norm in mergers:
        m = f"{p}{name}."
        shapes.update({m + "norm.weight": (norm,), m + "norm.bias": (norm,),
                       m + "linear_fc1.weight": (unit * E, unit * E),
                       m + "linear_fc1.bias": (unit * E,),
                       m + "linear_fc2.weight": (vcfg.out_hidden_size, unit * E),
                       m + "linear_fc2.bias": (vcfg.out_hidden_size,)})
    return shapes


def siglip_layer_shapes(prefix: str, layers: int, E: int, I: int) -> dict:
    """Name -> shape of a SigLIP encoder's layers in the HF layout."""
    shapes = {}
    for i in range(layers):
        lp = f"{prefix}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            shapes.update({f"{lp}{n}.weight": (E,), f"{lp}{n}.bias": (E,)})
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes.update({f"{lp}self_attn.{n}.weight": (E, E), f"{lp}self_attn.{n}.bias": (E,)})
        shapes.update({lp + "mlp.fc1.weight": (I, E), lp + "mlp.fc1.bias": (I,),
                       lp + "mlp.fc2.weight": (E, I), lp + "mlp.fc2.bias": (E,)})
    shapes.update({prefix + "post_layernorm.weight": (E,), prefix + "post_layernorm.bias": (E,)})
    return shapes


def random_pixels(shape, seed: int):
    """Normalized pixels (a clipped standard normal) from a seeded CPU
    generator, as a numpy array."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).clamp(-2, 2).numpy()


def vlm_ids(n_text: int, seed: int, vocab: int, spans) -> list[int]:
    """Seeded text ids around the visual ``spans`` (each a list of ids),
    ``n_text`` ids before the first span and 6 after each."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, min(vocab, 100000), (n_text,), generator=g).tolist()
    for span in spans:
        ids += span + torch.randint(3, min(vocab, 100000), (6,), generator=g).tolist()
    return ids


def qwen3_vl_replay(model, ids, images, videos, toks):
    """The eager path's logits that chose ``toks[i]``: Qwen3-VL's prefill,
    then ``toks[:i]`` decoded one step at a time (the decode body's MRoPE
    position: lengths + delta)."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits, make_cache
    from crane_tpu_torch.ops.rope import mrope_cos_sin
    from crane_tpu_torch.utils.buckets import bucket_length

    cfg = model.config

    def logits_at(i):
        with torch.no_grad():
            S = len(ids)
            embeds, cos, sin, deep, delta = model.prompt_inputs(ids, images, videos)
            cache = make_cache(cfg, 1, bucket_length(S + len(toks), floor=256), model.dtype,
                               device=model.device)
            logits, cache = model.prefill(cache, embeds, cos, sin, deep, S)
            for t in toks[:i]:
                p = (cache.lengths + delta).to(torch.int32)
                c1, s1 = mrope_cos_sin(p[None, :, None].expand(3, -1, 1), cfg.rot_dim,
                                       model.mrope_section, theta=cfg.rope_theta)
                hidden, cache = forward_hidden(
                    cfg, model.params, torch.tensor([[t]], dtype=torch.int32, device=model.device),
                    cache, cache.lengths, model.rope, rope_embeds={"cos": c1, "sin": s1})
                logits = lm_logits(cfg, model.params, hidden)[:, 0]
            return logits[0]
    return logits_at


def qwen3_vl_model(tparams, vparams, dtype):
    from crane_tpu_torch.models import qwen3_vl as q

    hf = QWEN3_VL_2B
    return q.Qwen3VLModel(q.text_config_from_hf(hf), q.vision_config_from_hf(hf), tparams,
                          vparams, mrope_section=tuple(hf["text_config"]["rope_scaling"]["mrope_section"]),
                          image_token_id=hf["image_token_id"], video_token_id=hf["video_token_id"],
                          vision_start_token_id=hf["vision_start_token_id"], dtype=dtype)


def check_qwen3_vl() -> None:
    """Qwen3-VL-2B (QWEN3_VL_2B) at full size, random weights in the HF
    layout: the vision tower and the image-chat prefill of a
    QWEN3_VL_IMAGE-pixel image in float32 on the card against the CPU;
    then bf16 ``generate`` with the image and with a video of
    QWEN3_VL_FRAMES frames, decode blocks as graphs against eager (the tie
    rule); the tower's, the prefill's and a decode step's times."""
    import torch

    from crane_tpu_torch.generation.config import GenerationConfig
    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import qwen3_vl as q
    from crane_tpu_torch.models.auto import map_hf_weights
    from crane_tpu_torch.models.image_processing import patchify
    from crane_tpu_torch.models.init import hf_state_dict

    hf = QWEN3_VL_2B
    tcfg, vcfg = q.text_config_from_hf(hf), q.vision_config_from_hf(hf)
    gen = torch.Generator(device="cuda").manual_seed(21)
    tparams = map_hf_weights(tcfg, hf_state_dict(tcfg, gen, torch.float32), torch.float32, "cuda")
    vparams = q.map_vision_weights(vcfg, draw_checkpoint(
        qwen3_vl_vision_shapes(vcfg), gen, torch.float32, tables=("model.visual.pos_embed.weight",)),
        torch.float32, "cuda")
    gpu = qwen3_vl_model(tparams, vparams, torch.float32)
    cpu = qwen3_vl_model(_tree(tparams, lambda t: t.cpu()), _tree(vparams, lambda t: t.cpu()),
                         torch.float32)
    side = QWEN3_VL_IMAGE
    patches, grid = patchify(random_pixels((1, 3, side, side), 5), vcfg.patch_size,
                             vcfg.spatial_merge_size, vcfg.temporal_patch_size)
    n_img = grid[0] * (grid[1] // 2) * (grid[2] // 2)
    ids = vlm_ids(20, 6, tcfg.vocab_size, [[hf["vision_start_token_id"]]
                                           + [hf["image_token_id"]] * n_img + [QWEN3_VL_VISION_END]])
    images = [(patches, grid)]
    t0 = time.perf_counter()
    (f_gpu, d_gpu), (f_cpu, d_cpu) = gpu.encode_images(patches, grid), cpu.encode_images(patches, grid)
    check_f32("vlm", f"Qwen3-VL-2B vision tower, {patches.shape[0]} patches -> {n_img} tokens",
              f_gpu, f_cpu)
    check_f32("vlm", "Qwen3-VL-2B DeepStack features (3 taps)", d_gpu, d_cpu)
    logits = []
    for model in (gpu, cpu):
        embeds, cos, sin, deep, _ = model.prompt_inputs(ids, images)
        cache = model.lm.init_cache(1, 512)
        logits.append(model.prefill(cache, embeds, cos, sin, deep, len(ids))[0])
    check_f32("vlm", f"Qwen3-VL-2B image-chat prefill logits, {len(ids)} tokens", *logits)
    log("vlm", f"Qwen3-VL-2B float32 check done in {time.perf_counter() - t0:.1f} s")
    del cpu, gpu, logits
    model = qwen3_vl_model(_tree(tparams, lambda t: t.to(torch.bfloat16)),
                           _tree(vparams, lambda t: t.to(torch.bfloat16)), torch.bfloat16)
    del tparams, vparams
    torch.cuda.empty_cache()

    frames = random_pixels((QWEN3_VL_FRAMES, 3, QWEN3_VL_FRAME, QWEN3_VL_FRAME), 7)
    vpatches, vgrid = patchify(frames, vcfg.patch_size, vcfg.spatial_merge_size,
                               vcfg.temporal_patch_size)
    per_frame = (vgrid[1] // 2) * (vgrid[2] // 2)
    span = [hf["vision_start_token_id"]] + [hf["video_token_id"]] * per_frame + [QWEN3_VL_VISION_END]
    vids = vlm_ids(12, 8, tcfg.vocab_size, [span] * vgrid[0])
    for label, p_ids, kw, n in (("image", ids, {"images": images}, 32),
                                (f"video of {QWEN3_VL_FRAMES} frames", vids,
                                 {"videos": [(vpatches, vgrid)]}, 16)):
        gen_cfg = GenerationConfig.greedy(n)
        toks = model.generate(p_ids, gen=gen_cfg, **kw)
        with graphs.eager():
            eager = model.generate(p_ids, gen=gen_cfg, **kw)
        tie_at_first_difference("vlm", f"Qwen3-VL-2B bf16 {label}, {n} tokens, graphs vs eager",
                                eager, toks, qwen3_vl_replay(model, p_ids, kw.get("images"),
                                                             kw.get("videos"), eager))
    vision_ms = sync_ms(lambda: model.encode_images(patches, grid))
    embeds, cos, sin, deep, delta = model.prompt_inputs(ids, images)
    cache = model.lm.init_cache(1, 512)
    prefill_ms = sync_ms(lambda: model.prefill(cache, embeds, cos, sin, deep, len(ids)))
    cur = torch.tensor([5], dtype=torch.int32, device=model.device)
    pd = torch.tensor([delta], dtype=torch.int32, device=model.device)

    def block():
        cache.lengths.fill_(len(ids))
        model.decode_block(cache, cur, pd)

    block()  # capture
    step_graph = sync_ms(block) / 8
    with graphs.eager():
        step_eager = sync_ms(block) / 8
    log_busy("vlm", "Qwen3-VL-2B bf16", "a graph decode block of 8 steps", block)
    model.release_graphs()
    log("vlm", f"Qwen3-VL-2B bf16: vision tower {vision_ms:.2f} ms ({patches.shape[0]} patches), "
               f"image-chat prefill {prefill_ms:.2f} ms ({len(ids)} tokens), decode step "
               f"{step_graph:.3f} ms as a graph vs {step_eager:.3f} ms eager")


def gemma3_model(hf: dict, seed: int, dtype, text_layers=None, vision_layers=None):
    """A Gemma3VLModel of ``hf`` on the card (its first ``text_layers`` /
    ``vision_layers`` layers where given) from a random HF checkpoint mapped
    by the port's ``map_*`` functions."""
    import torch

    from crane_tpu_torch.models import gemma3_vl as g3
    from crane_tpu_torch.models.auto import map_hf_weights
    from crane_tpu_torch.models.init import hf_state_dict

    tc, vc = dict(hf["text_config"]), dict(hf["vision_config"])
    if text_layers is not None:
        tc.update(num_hidden_layers=text_layers, layer_types=tc["layer_types"][:text_layers])
    if vision_layers is not None:
        vc.update(num_hidden_layers=vision_layers)
    hf = dict(hf, text_config=tc, vision_config=vc)
    tcfg, vcfg = g3.text_config_from_hf(hf), g3.siglip_config_from_hf(hf)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = hf_state_dict(tcfg, gen, dtype)
    for i in range(tcfg.num_layers):
        for n in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
            sd[f"model.layers.{i}.{n}.weight"] = torch.zeros(tcfg.hidden_size, dtype=dtype,
                                                             device="cuda")
    params = map_hf_weights(tcfg, sd, dtype, "cuda")
    vt = "model.vision_tower.vision_model."
    E, P, n = vcfg.hidden_size, vcfg.patch_size, vcfg.patches_per_side
    shapes = {vt + "embeddings.patch_embedding.weight": (E, 3, P, P),
              vt + "embeddings.patch_embedding.bias": (E,),
              vt + "embeddings.position_embedding.weight": (n * n, E),
              **siglip_layer_shapes(vt, vcfg.num_layers, E, vcfg.intermediate_size),
              "model.multi_modal_projector.mm_soft_emb_norm.weight": (E,),
              "model.multi_modal_projector.mm_input_projection_weight": (E, tcfg.hidden_size)}
    vsd = draw_checkpoint(shapes, gen, dtype, tables=(vt + "embeddings.position_embedding.weight",))
    vsd["model.multi_modal_projector.mm_soft_emb_norm.weight"].zero_()  # unit-offset norm
    vparams = g3.map_siglip_weights(vcfg, vsd, dtype, "cuda")
    del sd, vsd
    return g3.Gemma3VLModel(tcfg, vcfg, params, vparams, image_token_id=hf["image_token_index"],
                            mm_tokens_per_image=hf["mm_tokens_per_image"], dtype=dtype)


def greedy_step_ms(programs, cfg, params, rope, cache, start: int):
    """The ms of one ``greedy_decode_step`` (8 in a row after ``start``
    tokens of ``cache``) as a graph replay and eagerly, and the graph run
    (the first call, which captures, is not timed)."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models.modules.embeds_decode import greedy_decode_step

    cur = torch.tensor([5], dtype=torch.int32, device="cuda")

    def steps():
        cache.lengths.fill_(start)
        for _ in range(8):
            greedy_decode_step(programs, cfg, params, rope, cache, cur)

    steps()  # capture
    graph = sync_ms(steps) / 8
    with graphs.eager():
        eager = sync_ms(steps) / 8
    return graph, eager, steps


def gemma3_replay(model, ids, pixels, toks):
    """The eager path's logits that chose ``toks[i]``: the fresh prefill
    (segments to K2), then ``toks[:i]`` decoded step by step."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
    from crane_tpu_torch.utils.buckets import bucket_length

    embeds, extra, seg = model.prompt_inputs(ids, pixels)
    cfg, params = model.config, model.params

    def logits_at(i):
        with torch.no_grad():
            cache = model.lm.init_cache(1, bucket_length(len(ids) + len(toks), floor=256))
            logits, cache = model.prefill(cache, embeds, extra, seg, len(ids))
            for t in toks[:i]:
                hidden, cache = forward_hidden(
                    cfg, params, torch.tensor([[t]], dtype=torch.int32, device="cuda"),
                    cache, cache.lengths, model.rope)
                logits = lm_logits(cfg, params, hidden)[:, 0]
            return logits[0]
    return logits_at


def check_gemma3_vl() -> None:
    """Gemma3-4B (GEMMA3_4B): image chat in bf16 on the card against
    float32 on the CPU at GEMMA3_F32_TEXT_LAYERS / GEMMA3_F32_VISION_LAYERS
    layers (every width kept), the prefill's last logits; then the whole
    model in bf16: an image-chat generate whose fresh prefill passes the
    image block's segments to K2, its decode steps as graphs against the
    eager steps (the tie rule); the tower's, the prefill's and a decode
    step's times."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models.causal_lm import GenerationConfig
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    hf = GEMMA3_4B
    vc = hf["vision_config"]
    pixels = random_pixels((1, 3, vc["image_size"], vc["image_size"]), 9)
    span = [hf["boi_token_index"]] + [hf["image_token_index"]] * hf["mm_tokens_per_image"] \
        + [hf["eoi_token_index"]]
    ids = vlm_ids(30, 10, hf["text_config"]["vocab_size"], [span])
    t0 = time.perf_counter()
    gpu = gemma3_model(hf, 22, torch.float32, GEMMA3_F32_TEXT_LAYERS, GEMMA3_F32_VISION_LAYERS)
    cpu_params = _tree(gpu.params, lambda t: t.cpu())
    cpu_vparams = _tree(gpu.vision_params, lambda t: t.cpu())
    bf16 = type(gpu)(gpu.config, gpu.vision_config, _tree(gpu.params, lambda t: t.to(torch.bfloat16)),
                     _tree(gpu.vision_params, lambda t: t.to(torch.bfloat16)),
                     image_token_id=gpu.image_token_id,
                     mm_tokens_per_image=gpu.mm_tokens_per_image, dtype=torch.bfloat16)
    cpu = type(gpu)(gpu.config, gpu.vision_config, cpu_params, cpu_vparams,
                    image_token_id=gpu.image_token_id, mm_tokens_per_image=gpu.mm_tokens_per_image,
                    dtype=torch.float32)
    del gpu
    logits = []
    for model in (bf16, cpu):
        embeds, extra, seg = model.prompt_inputs(ids, pixels)
        logits.append(model.prefill(model.lm.init_cache(1, 512), embeds, extra, seg, len(ids))[0][0])
    compare_logits("vlm", f"Gemma3-4B at {GEMMA3_F32_TEXT_LAYERS} text / "
                          f"{GEMMA3_F32_VISION_LAYERS} SigLIP layers, image-chat prefill logits "
                          f"({len(ids)} tokens), card bf16 vs cpu f32", *logits)
    del bf16, cpu, cpu_params, cpu_vparams
    torch.cuda.empty_cache()
    log("vlm", f"Gemma3-4B check at the cut depth done in {time.perf_counter() - t0:.1f} s")

    model = gemma3_model(hf, 23, torch.bfloat16)
    before = k23.flash_attention_causal.segment_launches
    toks = model.generate(ids, pixels=pixels, gen=GenerationConfig.greedy(16))
    seg_launches = k23.flash_attention_causal.segment_launches - before
    if seg_launches != model.config.num_layers:
        raise AssertionError(f"Gemma3-4B's prefill launched K2 with segments {seg_launches} "
                             f"times, not once a layer")
    if len(toks) != 16 or not all(0 <= t < model.config.vocab_size for t in toks):
        raise AssertionError(f"Gemma3-4B generated {toks}")
    with graphs.eager():
        eager = model.generate(ids, pixels=pixels, gen=GenerationConfig.greedy(16))
    tie_at_first_difference("vlm", "Gemma3-4B bf16 image chat, 16 tokens, graphs vs eager",
                            eager, toks, gemma3_replay(model, ids, pixels, eager))
    vision_ms = sync_ms(lambda: model.encode_images(pixels))
    embeds, extra, seg = model.prompt_inputs(ids, pixels)
    cache = model.lm.init_cache(1, 512)
    prefill_ms = sync_ms(lambda: model.prefill(cache, embeds, extra, seg, len(ids)))
    step_ms, step_eager, steps = greedy_step_ms(model._programs, model.config, model.params,
                                                model.rope, cache, len(ids))
    log_busy("vlm", "Gemma3-4B bf16", "the image-chat prefill",
             lambda: model.prefill(cache, embeds, extra, seg, len(ids)))
    log_busy("vlm", "Gemma3-4B bf16", "8 graph decode steps", steps)
    model.release_graphs()
    log("vlm", f"Gemma3-4B bf16, {model.config.num_layers} layers + {model.vision_config.num_layers} "
               f"SigLIP layers: vision tower {vision_ms:.2f} ms "
               f"({model.vision_config.patches_per_side ** 2} patches -> "
               f"{model.mm_tokens_per_image} tokens), "
               f"image-chat prefill {prefill_ms:.2f} ms ({len(ids)} tokens, K2 with segments "
               f"{seg_launches} launches), decode step {step_ms:.3f} ms as a graph vs "
               f"{step_eager:.3f} ms eager; generate(16) {toks[:6]}...")


class PageTokenizer(StandInTokenizer):
    """The stand-in tokenizer with PaddleOCR-VL's special tokens: the
    sentence start is id 1, ``</s>`` id 2 (the EOS)."""

    SPECIAL = {"<|begin_of_sentence|>": 1, "</s>": 2}

    def token_to_id(self, token: str):
        return self.SPECIAL.get(token)


def synthetic_page(seed: int, size: tuple[int, int] = PADDLE_PAGE):
    """A white page (``size`` pixels, uint8 HWC) with dark lines of seeded
    lengths, as a numpy array."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h, w = size
    page = torch.full((h, w, 3), 255, dtype=torch.uint8)
    for row in range(30, h - 30, 28):
        n = int(torch.randint(w // 3, w - 40, (1,), generator=g))
        page[row:row + 12, 20:20 + n] = torch.randint(0, 90, (12, n, 3), generator=g,
                                                      dtype=torch.uint8)
    return page.numpy()


def paddle_replay(model, feats, ids, toks):
    """The reference path's logits that chose ``toks[i]``: the embeds
    prefill, then ``toks[:i]`` decoded."""
    import torch
    import torch.nn.functional as F

    from crane_tpu_torch.models.modules.embeds_decode import embeds_prefill
    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits, make_cache
    from crane_tpu_torch.utils.buckets import bucket_length

    lm = model.lm

    def logits_at(i):
        with torch.no_grad():
            S = len(ids)
            ids_t = torch.tensor(ids, device=lm.device).long()
            embeds = lm.params["embed"][ids_t][None].to(model.dtype)
            pos = (ids_t == model.image_token_id).nonzero()[:, 0]
            embeds[0, pos] = feats.to(model.dtype)
            embeds = F.pad(embeds, (0, 0, 0, bucket_length(S, floor=64) - S))
            cache = make_cache(lm.config, 1, bucket_length(S + len(toks) + 1, floor=256),
                               model.dtype, device=lm.device)
            logits, cache = embeds_prefill(lm.config, lm.params, lm.rope, cache, embeds, S)
            for t in toks[:i]:
                hidden, cache = forward_hidden(
                    lm.config, lm.params, torch.tensor([[t]], dtype=torch.int32, device=lm.device),
                    cache, cache.lengths, lm.rope)
                logits = lm_logits(lm.config, lm.params, hidden)[:, 0]
            return logits[0]
    return logits_at


def check_paddleocr_vl() -> None:
    """PaddleOCR-VL (PADDLEOCR_VL) at full size, random weights in its HF
    layout mapped by ``map_navit_weights`` and ``map_hf_weights``, float32
    on the card against float32 on the CPU: ``recognize`` of a synthetic
    page (preprocessing, the NaViT tower, the spliced prefill over the
    cache, PADDLE_NEW greedy steps, graphs on the card), its features and
    token ids (the tie rule), and the card's graph steps against its eager
    steps (the tie rule); the tower's, the prefill's and a decode step's
    times."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import paddleocr_vl as po
    from crane_tpu_torch.models.auto import map_hf_weights
    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.models.init import hf_state_dict

    hf = PADDLEOCR_VL
    vcfg, tcfg = po.navit_config_from_hf(hf), po.text_config_from_hf(hf)
    gen = torch.Generator(device="cuda").manual_seed(24)
    E, I, P = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size
    side = hf["vision_config"]["image_size"] // P
    wide = vcfg.merge_unit * E
    shapes = {"visual.vision_model.embeddings.patch_embedding.weight": (E, 3, P, P),
              "visual.vision_model.embeddings.patch_embedding.bias": (E,),
              "visual.vision_model.embeddings.position_embedding.weight": (side * side, E),
              **siglip_layer_shapes("visual.vision_model.", vcfg.depth, E, I),
              "mlp_AR.linear_1.weight": (wide, wide), "mlp_AR.linear_1.bias": (wide,),
              "mlp_AR.linear_2.weight": (tcfg.hidden_size, wide),
              "mlp_AR.linear_2.bias": (tcfg.hidden_size,)}
    sd = draw_checkpoint(shapes, gen, torch.float32,
                         tables=("visual.vision_model.embeddings.position_embedding.weight",))
    sd.update(hf_state_dict(tcfg, gen, torch.float32))
    v_sd, text_sd = po.split_state_dict(sd)
    vparams = po.map_navit_weights(vcfg, v_sd, torch.float32, "cuda")
    tparams = map_hf_weights(tcfg, text_sd, torch.float32, "cuda")
    del sd, v_sd, text_sd
    tok = PageTokenizer(tcfg.vocab_size)

    def model(tp, vp):
        lm = CausalLM(tcfg, tp, tokenizer=tok, eos_token_ids=(2,), dtype=torch.float32)
        return po.PaddleOcrVL(lm, vcfg, vp, image_token_id=hf["image_token_id"],
                              dtype=torch.float32)

    gpu = model(tparams, vparams)
    cpu = model(_tree(tparams, lambda t: t.cpu()), _tree(vparams, lambda t: t.cpu()))
    page = synthetic_page(11)
    patches, grid = po.preprocess_image(page)
    t0 = time.perf_counter()
    feats = [m.encode_patches(patches, grid) for m in (gpu, cpu)]
    n = feats[0].shape[0]
    check_f32("vlm", f"PaddleOCR-VL NaViT tower, a {PADDLE_PAGE[0]}x{PADDLE_PAGE[1]} page, "
                     f"{patches.shape[0]} patches -> {n} tokens", *feats)
    ids = gpu.build_prompt_ids(n, "ocr")
    toks = [list(m.recognize_ids(f, ids, PADDLE_NEW)) for m, f in zip((gpu, cpu), feats)]
    tie_at_first_difference("vlm", f"PaddleOCR-VL recognize, {PADDLE_NEW} tokens, card vs CPU",
                            toks[1], toks[0], paddle_replay(cpu, feats[1], ids, toks[1]))
    text = gpu.recognize(page, max_new_tokens=PADDLE_NEW)
    if tok.ids(text) != [t for t in toks[0] if t != 2]:
        raise AssertionError("PaddleOCR-VL recognize() disagrees with its own token ids")
    with graphs.eager():
        eager = list(gpu.recognize_ids(feats[0], ids, PADDLE_NEW))
    tie_at_first_difference("vlm", f"PaddleOCR-VL recognize, {PADDLE_NEW} tokens, graphs vs "
                                   f"eager on the card", eager, toks[0],
                            paddle_replay(gpu, feats[0], ids, eager))
    log("vlm", f"PaddleOCR-VL float32 check done in {time.perf_counter() - t0:.1f} s")
    del cpu
    vision_ms = sync_ms(lambda: gpu.encode_patches(patches, grid))
    decode_ms = sync_ms(lambda: list(gpu.recognize_ids(feats[0], ids, PADDLE_NEW)))
    lm = gpu.lm
    step_ms, step_eager, steps = greedy_step_ms(gpu._programs, lm.config, lm.params, lm.rope,
                                                lm.init_cache(1, 512), len(ids))
    log_busy("vlm", "PaddleOCR-VL float32", "the NaViT tower",
             lambda: gpu.encode_patches(patches, grid))
    log_busy("vlm", "PaddleOCR-VL float32", "8 graph decode steps", steps)
    gpu.release_graphs()
    log("vlm", f"PaddleOCR-VL float32, {tcfg.num_layers} decoder layers + {vcfg.depth} NaViT "
               f"layers: vision tower {vision_ms:.2f} ms ({patches.shape[0]} patches), prefill "
               f"({len(ids)} tokens) + {PADDLE_NEW} greedy steps {decode_ms:.1f} ms, decode "
               f"step {step_ms:.3f} ms as a graph vs {step_eager:.3f} ms eager; "
               f"recognize: {text[:60]!r}...")


# ---------------------------------------------------------------------------
# Phase 21 (audio): speech recognition. Qwen3-ASR-0.6B whole (bench.py's
# workload, served over HTTP), Qwen2-Audio-7B, Whisper large-v3, Moonshine
# tiny, the native VAD

# bench.py's Qwen3-ASR workload (bench.py:494-528): 20 s of audio, 64 tokens
ASR_AUDIO_S = 20.0
ASR_NEW = 64

# Qwen2-Audio-7B: the encoder is transformers 4.57.6's
# Qwen2AudioEncoderConfig() defaults (whisper-large-v3's encoder); the text
# model is Qwen2-Audio-7B's published text_config as far as it can be
# stated without a download (unverified here)
QWEN2_AUDIO_ENCODER = {"d_model": 1280, "encoder_layers": 32, "encoder_attention_heads": 20,
                       "encoder_ffn_dim": 5120, "num_mel_bins": 128, "max_source_positions": 1500}
QWEN2_AUDIO_TEXT = {
    "model_type": "qwen2", "vocab_size": 156032, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "max_position_embeddings": 8192,
    "tie_word_embeddings": False,
}
QWEN2_AUDIO_S = 10.0  # seconds of audio: 250 audio tokens
QWEN2_AUDIO_NEW = 32

# Whisper large-v3 (openai/whisper-large-v3 config.json) and Moonshine tiny
# (transformers 4.57.6's MoonshineConfig() defaults)
WHISPER_LARGE_V3 = {
    "vocab_size": 51866, "d_model": 1280, "encoder_layers": 32, "decoder_layers": 32,
    "encoder_attention_heads": 20, "encoder_ffn_dim": 5120, "num_mel_bins": 128,
    "max_source_positions": 1500, "max_target_positions": 448,
    "decoder_start_token_id": 50258, "eos_token_id": 50257,
}
MOONSHINE_TINY = {
    "vocab_size": 32768, "hidden_size": 288, "intermediate_size": 1152,
    "encoder_num_hidden_layers": 6, "decoder_num_hidden_layers": 6,
    "encoder_num_attention_heads": 8, "decoder_num_attention_heads": 8,
    "partial_rotary_factor": 0.9, "rope_theta": 10000.0, "decoder_start_token_id": 1,
    "eos_token_id": 2,
}
SPEECH_NEW = 24  # greedy tokens of the Whisper and Moonshine checks

# the float32 check of Qwen2-Audio and Whisper against the CPU runs their
# first 4 encoder and 4 text (decoder) layers, every width kept
AUDIO_F32_LAYERS = 4

# the kernel rows at Qwen2-Audio's text heads (group 1)
MHA_HEADS = "[D128-32/32]"


class SpeechTokenizer(StandInTokenizer):
    """The stand-in tokenizer with the audio prompts' special tokens as
    single ids (Qwen's: ``<|audio_pad|>`` and ``<|AUDIO|>`` at 151646, as
    bench.py's workload and Qwen2-Audio's ``audio_token_index``), so
    ``build_prompt`` encodes exactly."""

    SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|audio_start|>": 151647,
               "<|audio_end|>": 151648, "<|audio_pad|>": 151646, "<|AUDIO|>": 151646}

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        out = []
        while True:
            hits = [(text.find(t), t) for t in self.SPECIAL if t in text]
            if not hits:
                return out + super().encode(text)
            at, token = min(hits)
            out += super().encode(text[:at]) + [self.SPECIAL[token]]
            text = text[at + len(token):]

    def token_to_id(self, token: str):
        return self.SPECIAL.get(token)


def speech_wave(seconds: float, seed: int, rate: int = 16000):
    """A seeded synthetic utterance at ``rate``: three tones, on for the
    first 0.6 s of every second (so the VAD sees speech and pauses), plus
    noise; float32 numpy."""
    import torch

    g = torch.Generator().manual_seed(seed)
    t = torch.arange(int(seconds * rate), dtype=torch.float64) / rate
    x = sum(a * torch.sin(2 * torch.pi * f * t) for a, f in ((0.3, 220.0), (0.2, 1330.0),
                                                           (0.1, 3100.0)))
    x = x * ((t % 1.0) < 0.6) + 0.02 * torch.randn(len(t), generator=g, dtype=torch.float64)
    return x.float().numpy()


def encoder_layer_shapes(prefix: str, layers: int, d: int, f: int, k_bias: bool,
                         cross: bool = False) -> dict:
    """HF names and shapes of Whisper-style pre-LN layers (AuT, Qwen2-Audio's
    and Whisper's encoders; with ``cross`` Whisper's decoder layers)."""
    shapes = {}
    for i in range(layers):
        lp = f"{prefix}layers.{i}."
        for attn in ("self_attn", "encoder_attn") if cross else ("self_attn",):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                shapes[f"{lp}{attn}.{proj}.weight"] = (d, d)
                if proj != "k_proj" or k_bias:
                    shapes[f"{lp}{attn}.{proj}.bias"] = (d,)
            shapes[f"{lp}{attn}_layer_norm.weight"] = shapes[f"{lp}{attn}_layer_norm.bias"] = (d,)
        shapes.update({lp + "final_layer_norm.weight": (d,), lp + "final_layer_norm.bias": (d,),
                       lp + "fc1.weight": (f, d), lp + "fc1.bias": (f,),
                       lp + "fc2.weight": (d, f), lp + "fc2.bias": (d,)})
    return shapes


def aut_shapes(acfg) -> dict:
    """Qwen3-ASR's tower and projector under the names ``map_aut_weights``
    reads (tower-relative, the projector under ``_projector.``)."""
    C, d = acfg.downsample_hidden_size, acfg.d_model
    shapes = {"conv2d1.weight": (C, 1, 3, 3), "conv2d2.weight": (C, C, 3, 3),
              "conv2d3.weight": (C, C, 3, 3), "conv_out.weight": (d, C * acfg.post_conv_mel_bins),
              "ln_post.weight": (d,), "ln_post.bias": (d,),
              "_projector.linear_1.weight": (d, d), "_projector.linear_1.bias": (d,),
              "_projector.linear_2.weight": (acfg.output_dim, d),
              "_projector.linear_2.bias": (acfg.output_dim,)}
    for i in (1, 2, 3):
        shapes[f"conv2d{i}.bias"] = (C,)
    shapes.update(encoder_layer_shapes("", acfg.num_layers, d, acfg.ffn_dim, k_bias=True))
    return shapes


def asr_replay(model, ids, feats, toks):
    """The reference path's logits that chose ``toks[i]`` (Qwen3-ASR or
    Qwen2-Audio): the spliced prefill, then ``toks[:i]`` decoded one step
    at a time, eagerly."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits

    def logits_at(i):
        with torch.no_grad():
            logits, cache = model.prefill(ids, feats, len(toks))
            for t in toks[:i]:
                hidden, cache = forward_hidden(
                    model.config, model.params,
                    torch.tensor([[t]], dtype=torch.int32, device=model.device),
                    cache, cache.lengths, model.rope)
                logits = lm_logits(model.config, model.params, hidden)[:, 0]
            return logits[0]
    return logits_at


def multipart_wav(samples, rate: int) -> tuple[dict, bytes]:
    """A multipart/form-data body whose ``file`` part is ``samples`` as a
    WAV at ``rate``."""
    from crane_tpu_torch.audio.pcm import encode_wav

    boundary = "crane-audio"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"model\"\r\n\r\nasr\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
        + encode_wav(samples, rate) + f"\r\n--{boundary}--\r\n".encode()
    return {"Content-Type": f"multipart/form-data; boundary={boundary}"}, body


def http_raw(port: int, path: str, headers: dict, body: bytes) -> tuple[int, dict]:
    """POST ``body`` as it is: (status, JSON body)."""
    status, _, data = http_raw_bytes(port, path, headers, body)
    return status, json.loads(data)


def qwen3_asr_model(tparams, aparams, dtype):
    from crane_tpu_torch.models import qwen3_asr as qa
    from crane_tpu_torch.models.init import QWEN3_0_6B

    return qa.Qwen3AsrModel(QWEN3_0_6B, qa.AuTConfig(), {**tparams, "audio": aparams},
                            audio_token_id=SpeechTokenizer.SPECIAL["<|audio_pad|>"],
                            tokenizer=SpeechTokenizer(QWEN3_0_6B.vocab_size), dtype=dtype)


def check_qwen3_asr() -> dict[str, int]:
    """Qwen3-ASR-0.6B whole (``AuTConfig()`` and QWEN3_0_6B, bench.py's
    shapes), random weights under the names the ``map_*`` functions read:
    in float32 on the card against the CPU, the log-mel, the tower's
    features and the spliced prefill's logits (F32_REL_L2) and 64 greedy
    tokens (the tie rule); then in bf16: 64 tokens as graph blocks against
    the eager blocks (the tie rule), each block one replay of 16 steps;
    transcriptions over HTTP (16 kHz, and 8 kHz through the resample route)
    against ``Qwen3AsrAdapter.transcribe``; the tower's, the prefill's and
    a block's times and the xRT of ``generate``. Returns the bf16 path's
    launch counts."""
    import torch

    from crane_tpu_torch.audio.mel import log_mel_spectrogram
    from crane_tpu_torch.audio.pcm import decode_wav, encode_wav, resample
    from crane_tpu_torch.generation.config import TranscribeOptions
    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import qwen3_asr as qa
    from crane_tpu_torch.models.auto import map_hf_weights
    from crane_tpu_torch.models.init import QWEN3_0_6B, hf_state_dict
    from crane_tpu_torch.models.modules.embeds_decode import greedy_decode_block
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.sdk.audio import Qwen3AsrAdapter
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    acfg = qa.AuTConfig()
    gen = torch.Generator(device="cuda").manual_seed(31)
    tparams = map_hf_weights(QWEN3_0_6B, hf_state_dict(QWEN3_0_6B, gen, torch.float32),
                             torch.float32, "cuda")
    aparams = qa.map_aut_weights(acfg, draw_checkpoint(aut_shapes(acfg), gen, torch.float32),
                                 torch.float32, "cuda")
    gpu = qwen3_asr_model(tparams, aparams, torch.float32)
    cpu = qwen3_asr_model(_tree(tparams, lambda t: t.cpu()), _tree(aparams, lambda t: t.cpu()),
                          torch.float32)
    wav = speech_wave(ASR_AUDIO_S, 13)
    t0 = time.perf_counter()
    mels = [log_mel_spectrogram(gpu.mel_config, torch.as_tensor(wav, device=d))
            for d in ("cuda", "cpu")]
    check_f32("audio", f"Qwen3-ASR log-mel of {ASR_AUDIO_S:g} s, {tuple(mels[1].shape)}", *mels)
    feats = [m.encode_audio(wav) for m in (gpu, cpu)]
    n = feats[1].shape[0]
    check_f32("audio", f"Qwen3-ASR-0.6B AuT tower and projector, {n} audio tokens", *feats)
    ids = gpu.tokenizer.encode(gpu.build_prompt(gpu.n_audio_tokens(len(wav))))
    logits = [m.prefill(ids, f, ASR_NEW)[0] for m, f in zip((gpu, cpu), feats)]
    check_f32("audio", f"Qwen3-ASR-0.6B spliced prefill logits, {len(ids)} tokens", *logits)
    toks = [m.generate(ids, wav, max_new_tokens=ASR_NEW) for m in (gpu, cpu)]
    tie_at_first_difference("audio", f"Qwen3-ASR-0.6B float32, {ASR_NEW} tokens, card vs CPU",
                            toks[1], toks[0], asr_replay(cpu, ids, feats[1], toks[1]))
    log("audio", f"Qwen3-ASR-0.6B float32 check done in {time.perf_counter() - t0:.1f} s")
    del gpu, cpu, feats, logits
    model = qwen3_asr_model(_tree(tparams, lambda t: t.to(torch.bfloat16)),
                            _tree(aparams, lambda t: t.to(torch.bfloat16)), torch.bfloat16)
    del tparams, aparams
    torch.cuda.empty_cache()

    # the main path: counted from here to the HTTP transcriptions
    reset_counts()
    replays = graphs.replays
    toks = model.generate(ids, wav, max_new_tokens=ASR_NEW)
    blocks = graphs.replays - replays
    want = -(-(ASR_NEW - 1) // qa.DECODE_BLOCK)
    if blocks != want or len(toks) != ASR_NEW:
        raise AssertionError(f"Qwen3-ASR: {len(toks)} tokens in {blocks} graph replays, "
                             f"expected {ASR_NEW} in {want}")
    log("audio", f"Qwen3-ASR-0.6B bf16: {ASR_NEW} tokens in {blocks} graph replays of "
                 f"{qa.DECODE_BLOCK} steps")
    with graphs.eager():
        eager = model.generate(ids, wav, max_new_tokens=ASR_NEW)
    feats = model.encode_audio(wav)
    tie_at_first_difference("audio", f"Qwen3-ASR-0.6B bf16, {ASR_NEW} tokens, graphs vs eager",
                            eager, toks, asr_replay(model, ids, feats, eager))

    asr = Qwen3AsrAdapter(model)
    with BackgroundServer(build_app(Server(None, asr=asr))) as srv:
        for rate in (16000, 8000):
            clip = speech_wave(4.0, 17, rate)
            t1 = time.perf_counter()
            status, body = http_raw(srv.port, "/v1/audio/transcriptions", *multipart_wav(clip, rate))
            http_s = time.perf_counter() - t1
            x, r = decode_wav(encode_wav(clip, rate))
            direct = asr.transcribe(resample(x, r, 16000) if r != 16000 else x,
                                    TranscribeOptions()).text
            if status != 200 or body.get("text") != direct:
                raise AssertionError(f"Qwen3-ASR over HTTP at {rate} Hz: {status} "
                                     f"{str(body)[:200]} vs direct {direct[:200]!r}")
            log("audio", f"Qwen3-ASR over HTTP, a 4 s WAV at {rate} Hz: the text equals "
                         f"Qwen3AsrAdapter.transcribe ({len(direct.split())} tokens, "
                         f"{http_s:.2f} s a request)")
    counts = kernels.launch_counts()

    tower_ms = sync_ms(lambda: model.encode_audio(wav))
    prefill_ms = sync_ms(lambda: model.prefill(ids, feats, ASR_NEW))
    _, cache = model.prefill(ids, feats, ASR_NEW)
    cur = torch.tensor([5], dtype=torch.int32, device="cuda")

    def block():
        cache.lengths.fill_(len(ids))
        greedy_decode_block(model._programs, model.config, model.params, model.rope, cache, cur,
                            qa.DECODE_BLOCK)

    block()  # the block over this cache is captured
    block_ms = sync_ms(block)
    with graphs.eager():
        block_eager = sync_ms(block)
    runs = sorted(sync_ms(lambda: model.generate(ids, wav, max_new_tokens=ASR_NEW))
                  for _ in range(3))
    log_busy("audio", "Qwen3-ASR-0.6B bf16", f"generate of {ASR_NEW} tokens",
             lambda: model.generate(ids, wav, max_new_tokens=ASR_NEW))
    model.release_graphs()
    log("audio", f"Qwen3-ASR-0.6B bf16, {ASR_AUDIO_S:g} s of audio ({n} audio tokens, prompt "
                 f"{len(ids)}): AuT tower {tower_ms:.2f} ms, prefill {prefill_ms:.2f} ms, a "
                 f"{qa.DECODE_BLOCK}-step block {block_ms:.3f} ms as one graph replay vs "
                 f"{block_eager:.3f} ms eager; generate of {ASR_NEW} tokens {runs[1]:.1f} ms "
                 f"(median of 3), xRT {ASR_AUDIO_S / (runs[1] / 1e3):.1f} (audio seconds a wall "
                 f"second)")
    return counts


def qwen2_audio_prompt(n: int) -> list[int]:
    """Qwen2-Audio's transcription prompt for ``n`` audio tokens, as the
    stand-in tokenizer encodes it."""
    from crane_tpu_torch.models.qwen2_audio import AudioLLM

    return SpeechTokenizer(QWEN2_AUDIO_TEXT["vocab_size"]).encode(AudioLLM.build_prompt(n))


def qwen2_audio_model(seed: int, dtype, layers: int | None = None):
    """Qwen2-Audio-7B (QWEN2_AUDIO_ENCODER, QWEN2_AUDIO_TEXT), or its first
    ``layers`` encoder and text layers, random weights under the names
    ``map_audio_weights`` and ``map_hf_weights`` read (the text model's
    q/k/v biases drawn beside ``hf_state_dict``'s tensors), on the card."""
    import torch

    from crane_tpu_torch.models import qwen2_audio as q2
    from crane_tpu_torch.models.auto import map_hf_weights, transformer_config_from_hf
    from crane_tpu_torch.models.init import hf_state_dict

    enc = dict(QWEN2_AUDIO_ENCODER)
    text = dict(QWEN2_AUDIO_TEXT)
    if layers is not None:
        enc["encoder_layers"] = text["num_hidden_layers"] = layers
    acfg = q2.audio_config_from_hf({"audio_config": enc})
    tcfg = transformer_config_from_hf(text)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, E = acfg.d_model, tcfg.hidden_size
    a_shapes = {"conv1.weight": (d, acfg.num_mel_bins, 3), "conv1.bias": (d,),
                "conv2.weight": (d, d, 3), "conv2.bias": (d,),
                "embed_positions.weight": (acfg.max_source_positions, d),
                "layer_norm.weight": (d,), "layer_norm.bias": (d,),
                **encoder_layer_shapes("", acfg.num_layers, d, acfg.ffn_dim, k_bias=False)}
    a_sd = draw_checkpoint(a_shapes, gen, dtype, tables=("embed_positions.weight",))
    proj_sd = draw_checkpoint({"linear.weight": (E, d), "linear.bias": (E,)}, gen, dtype)
    text_sd = hf_state_dict(tcfg, gen, dtype)
    for i in range(tcfg.num_layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            text_sd[f"model.layers.{i}.self_attn.{proj}.bias"] = (
                torch.randn(E, generator=gen, device="cuda") * 0.02).to(dtype)
    params = map_hf_weights(tcfg, text_sd, dtype, "cuda")
    del text_sd
    params.update(q2.map_audio_weights(acfg, a_sd, proj_sd, dtype, "cuda"))
    return q2.AudioLLM(tcfg, acfg, params, audio_token_id=SpeechTokenizer.SPECIAL["<|AUDIO|>"],
                       tokenizer=SpeechTokenizer(tcfg.vocab_size), dtype=dtype)


def check_qwen2_audio() -> dict[str, int]:
    """Qwen2-Audio-7B: its first AUDIO_F32_LAYERS encoder and text layers
    (every width kept) in float32 on the card against the CPU (the padded
    log-mel, the tower and projector, the spliced prefill's logits, 16
    greedy tokens under the tie rule); then the whole model in bf16: the
    tower's and the prefill's times (K3 at 32 / 32 heads of 128), each
    greedy step one graph replay (K1 at 32 / 32), tokens against the eager
    steps (the tie rule), a step's time as a graph and eager. Returns the
    bf16 path's launch counts."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import qwen2_audio as q2
    from crane_tpu_torch.ops import cuda as kernels

    gpu = qwen2_audio_model(41, torch.float32, AUDIO_F32_LAYERS)
    cpu = q2.AudioLLM(gpu.config, gpu.audio_config, _tree(gpu.params, lambda t: t.cpu()),
                      audio_token_id=gpu.audio_token_id, tokenizer=gpu.tokenizer,
                      dtype=torch.float32)
    wav = speech_wave(QWEN2_AUDIO_S, 19)
    t0 = time.perf_counter()
    mels = [m.extract_features(wav) for m in (gpu, cpu)]
    mel_len = mels[0][1]
    n = q2.audio_feature_lengths(mel_len)
    check_f32("audio", f"Qwen2-Audio log-mel padded to {mels[1][0].shape[-1]} frames",
              mels[0][0], mels[1][0])
    feats = [q2.encode_project(m.audio_config, m.params, mel)[0, :n]
             for m, (mel, _) in zip((gpu, cpu), mels)]
    label = f"Qwen2-Audio, {AUDIO_F32_LAYERS} encoder + {AUDIO_F32_LAYERS} text layers"
    check_f32("audio", f"{label}: tower and projector, {n} audio tokens", *feats)
    ids = qwen2_audio_prompt(n)
    logits = [m.prefill(ids, f, 16)[0] for m, f in zip((gpu, cpu), feats)]
    check_f32("audio", f"{label}: spliced prefill logits, {len(ids)} tokens", *logits)
    toks = [m.generate_from_features(ids, f, max_new_tokens=16) for m, f in zip((gpu, cpu), feats)]
    tie_at_first_difference("audio", f"{label}, float32, 16 tokens, card vs CPU", toks[1], toks[0],
                            asr_replay(cpu, ids, feats[1], toks[1]))
    log("audio", f"Qwen2-Audio float32 check done in {time.perf_counter() - t0:.1f} s")
    del gpu, cpu, feats, logits
    torch.cuda.empty_cache()

    model = qwen2_audio_model(43, torch.bfloat16)
    mel, _ = model.extract_features(wav)
    reset_counts()
    feats = q2.encode_project(model.audio_config, model.params, mel.to(torch.bfloat16))[0, :n]
    replays = graphs.replays
    toks = model.generate_from_features(ids, feats, max_new_tokens=QWEN2_AUDIO_NEW)
    steps = graphs.replays - replays
    if steps != len(toks) - 1:
        raise AssertionError(f"Qwen2-Audio: {len(toks)} tokens but {steps} graph replays")
    with graphs.eager():
        eager = model.generate_from_features(ids, feats, max_new_tokens=QWEN2_AUDIO_NEW)
    tie_at_first_difference("audio", f"Qwen2-Audio-7B bf16, {QWEN2_AUDIO_NEW} tokens, graphs vs "
                                     f"eager ({steps} steps, each one graph replay)", eager, toks,
                            asr_replay(model, ids, feats, eager))
    counts = kernels.launch_counts()

    tower_ms = sync_ms(lambda: q2.encode_project(model.audio_config, model.params,
                                                 mel.to(torch.bfloat16)))
    prefill_ms = sync_ms(lambda: model.prefill(ids, feats, QWEN2_AUDIO_NEW))
    _, cache = model.prefill(ids, feats, QWEN2_AUDIO_NEW)
    step_ms, step_eager, steps_fn = greedy_step_ms(model._programs, model.config, model.params,
                                                   model.rope, cache, len(ids))
    log_busy("audio", "Qwen2-Audio-7B bf16", "8 graph decode steps", steps_fn)
    model.release_graphs()
    log("audio", f"Qwen2-Audio-7B bf16 (32 + 32 layers): tower {tower_ms:.2f} ms (1500 "
                 f"positions), prefill {prefill_ms:.2f} ms ({len(ids)} tokens), decode step "
                 f"{step_ms:.3f} ms as a graph vs {step_eager:.3f} ms eager")
    return counts


def whisper_model(seed: int, dtype, layers: int | None = None):
    """Whisper large-v3 (WHISPER_LARGE_V3), or its first ``layers`` encoder
    and decoder layers, random weights under the names
    ``map_whisper_weights`` reads, on the card."""
    import torch

    from crane_tpu_torch.models import whisper as wh

    hf = dict(WHISPER_LARGE_V3)
    if layers is not None:
        hf["encoder_layers"] = hf["decoder_layers"] = layers
    cfg = wh.config_from_hf(hf)
    d, f = cfg.d_model, cfg.ffn_dim
    shapes = {"model.encoder.conv1.weight": (d, cfg.num_mel_bins, 3), "model.encoder.conv1.bias": (d,),
              "model.encoder.conv2.weight": (d, d, 3), "model.encoder.conv2.bias": (d,),
              "model.encoder.embed_positions.weight": (cfg.max_source_positions, d),
              "model.encoder.layer_norm.weight": (d,), "model.encoder.layer_norm.bias": (d,),
              "model.decoder.embed_tokens.weight": (cfg.vocab_size, d),
              "model.decoder.embed_positions.weight": (cfg.max_target_positions, d),
              "model.decoder.layer_norm.weight": (d,), "model.decoder.layer_norm.bias": (d,),
              **encoder_layer_shapes("model.encoder.", cfg.encoder_layers, d, f, k_bias=False),
              **encoder_layer_shapes("model.decoder.", cfg.decoder_layers, d, f, k_bias=False,
                                     cross=True)}
    tables = ("model.encoder.embed_positions.weight", "model.decoder.embed_tokens.weight",
              "model.decoder.embed_positions.weight")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = draw_checkpoint(shapes, gen, dtype, tables=tables)
    return wh.WhisperModel(cfg, wh.map_whisper_weights(cfg, sd, dtype, "cuda"), dtype=dtype)


def moonshine_model(seed: int, dtype):
    """Moonshine tiny (MOONSHINE_TINY), random weights under the names
    ``map_moonshine_weights`` reads (the head tied), on the card."""
    import torch

    from crane_tpu_torch.models import moonshine as ms

    cfg = ms.config_from_hf(MOONSHINE_TINY)
    d, f = cfg.hidden_size, cfg.intermediate_size
    e, dd = "model.encoder.", "model.decoder."
    shapes = {e + "conv1.weight": (d, 1, 127), e + "conv2.weight": (2 * d, d, 7),
              e + "conv2.bias": (2 * d,), e + "conv3.weight": (d, 2 * d, 3), e + "conv3.bias": (d,),
              e + "groupnorm.weight": (d,), e + "groupnorm.bias": (d,),
              e + "layer_norm.weight": (d,), dd + "norm.weight": (d,),
              dd + "embed_tokens.weight": (cfg.vocab_size, d)}
    for prefix, n, cross, up in ((e, cfg.encoder_layers, False, f), (dd, cfg.decoder_layers, True,
                                                                        2 * f)):
        for i in range(n):
            lp = f"{prefix}layers.{i}."
            for attn in ("self_attn", "encoder_attn") if cross else ("self_attn",):
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                    shapes[f"{lp}{attn}.{proj}.weight"] = (d, d)
            names = ("input_layernorm", "post_attention_layernorm") + (
                ("final_layernorm",) if cross else ())
            shapes.update({f"{lp}{nm}.weight": (d,) for nm in names})
            shapes.update({lp + "mlp.fc1.weight": (up, d), lp + "mlp.fc1.bias": (up,),
                           lp + "mlp.fc2.weight": (d, f), lp + "mlp.fc2.bias": (d,)})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = draw_checkpoint(shapes, gen, dtype, tables=(dd + "embed_tokens.weight",))
    return ms.MoonshineModel(cfg, ms.map_moonshine_weights(cfg, sd, dtype, "cuda"), dtype=dtype)


def whisper_replay(model, mel, toks):
    """Whisper's logits that chose ``toks[i]``: the start token, then
    ``toks[:i]`` decoded one step at a time, eagerly."""
    import torch

    from crane_tpu_torch.models import whisper as wh

    cfg = model.config

    def logits_at(i):
        with torch.no_grad():
            _, kv = wh.encode_kv(cfg, model.params, mel.to(model.dtype))
            cache = model._decoder_cache()
            seq = [cfg.decoder_start_token_id, *toks[:i]]
            logits, cache = wh.decode_logits(cfg, model.params, cache,
                                             torch.tensor([seq[:1]], device=model.device), kv)
            for t in seq[1:]:
                logits, cache = wh.decode_logits(cfg, model.params, cache,
                                                 torch.tensor([[t]], device=model.device), kv)
            return logits[0]
    return logits_at


def moonshine_replay(model, wav, toks):
    """Moonshine's logits that chose ``toks[i]``: the start token, then
    ``toks[:i]`` decoded one step at a time, eagerly."""
    import torch

    from crane_tpu_torch.models import moonshine as ms
    from crane_tpu_torch.utils.buckets import bucket_length

    cfg = model.config

    def logits_at(i):
        with torch.no_grad():
            wav_t = torch.as_tensor(wav, device=model.device).to(model.dtype)[None]
            _, kv = ms.encode_and_kv(cfg, model.params, wav_t)
            slots = bucket_length(len(toks) + 8, floor=64)
            cache = model._cache(slots)
            rope = ms.rope_tables(cfg, slots, model.device)
            for t in [cfg.decoder_start_token_id, *toks[:i]]:
                logits = ms.decode_logits(cfg, model.params, cache,
                                          torch.tensor([t], dtype=torch.int32, device=model.device),
                                          kv, rope)
                cache.lengths += 1
            return logits[0]
    return logits_at


def speech_step_ms(model, cache, enc_len: int, start: int):
    """One decoder step of a Whisper or Moonshine model (8 in a row after
    ``start`` tokens), as a graph replay and eagerly, and the graph run."""
    import torch

    from crane_tpu_torch.models import graphs

    cur = torch.tensor([5], dtype=torch.int32, device="cuda")

    def steps():
        cache.lengths.fill_(start)
        for _ in range(8):
            model.step(cache, cur, enc_len)

    steps()
    graph = sync_ms(steps) / 8
    with graphs.eager():
        eager = sync_ms(steps) / 8
    return graph, eager, steps


def check_speech_decoders() -> None:
    """Whisper large-v3 and Moonshine tiny: in float32 on the card against
    the CPU (Whisper at its first AUDIO_F32_LAYERS encoder and decoder
    layers, Moonshine whole), the encoder states (F32_REL_L2) and
    SPEECH_NEW greedy ids (the tie rule); then in bf16 (Whisper whole):
    the encoder's time, each greedy step one graph replay (counted), ids
    against the eager steps (the tie rule), a step's time as a graph and
    eager."""
    import torch

    from crane_tpu_torch.generation.config import TranscribeOptions
    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import moonshine as ms
    from crane_tpu_torch.models import whisper as wh

    def on_cpu(model):
        return type(model)(model.config, _tree(model.params, lambda t: t.cpu()), dtype=model.dtype)

    def counted_steps(model, run):
        calls = []
        step = model.step
        model.step = lambda *a: calls.append(1) or step(*a)
        replays = graphs.replays
        try:
            out = run()
        finally:
            model.step = step
        if graphs.replays - replays != len(calls):
            raise AssertionError(f"{len(calls)} decode steps but {graphs.replays - replays} "
                                 f"graph replays")
        return out, len(calls)

    wav = speech_wave(10.0, 23)
    # Whisper: float32 at AUDIO_F32_LAYERS layers, then bf16 whole
    gpu = whisper_model(51, torch.float32, AUDIO_F32_LAYERS)
    cpu = on_cpu(gpu)
    t0 = time.perf_counter()
    mels = [m.extract_features(wav) for m in (gpu, cpu)]
    check_f32("audio", "Whisper log-mel, 30 s window", *mels)
    label = f"Whisper large-v3, {AUDIO_F32_LAYERS} + {AUDIO_F32_LAYERS} layers"
    check_f32("audio", f"{label}: encoder states",
              *[wh.encode_kv(m.config, m.params, mel)[0] for m, mel in zip((gpu, cpu), mels)])
    toks = [m.transcribe_features(mel, max_new_tokens=SPEECH_NEW) for m, mel in zip((gpu, cpu), mels)]
    tie_at_first_difference("audio", f"{label}, float32, {SPEECH_NEW} tokens, card vs CPU", toks[1],
                            toks[0], whisper_replay(cpu, mels[1], toks[1]))
    log("audio", f"Whisper float32 check done in {time.perf_counter() - t0:.1f} s")
    del gpu, cpu
    model = whisper_model(53, torch.bfloat16)
    mel = mels[0]
    toks, steps = counted_steps(model, lambda: model.transcribe_features(
        mel, max_new_tokens=SPEECH_NEW))
    with graphs.eager():
        eager = model.transcribe_features(mel, max_new_tokens=SPEECH_NEW)
    tie_at_first_difference("audio", f"Whisper large-v3 bf16, {len(toks)} tokens, graphs vs eager "
                                     f"({steps} steps, each one graph replay)", eager, toks,
                            whisper_replay(model, mel, eager))
    encoder_ms = sync_ms(lambda: wh.encode_kv(model.config, model.params, mel.to(torch.bfloat16)))
    step_ms, step_eager, steps_fn = speech_step_ms(model, model._decoder_cache(),
                                                   model.config.max_source_positions, 4)
    log_busy("audio", "Whisper large-v3 bf16", "8 graph decode steps", steps_fn)
    model.release_graphs()
    log("audio", f"Whisper large-v3 bf16 (32 + 32 layers): encoder {encoder_ms:.2f} ms (1500 "
                 f"positions), decode step {step_ms:.3f} ms as a graph vs {step_eager:.3f} ms "
                 f"eager")
    del model
    torch.cuda.empty_cache()

    # Moonshine tiny: float32 whole, then bf16
    gpu = moonshine_model(61, torch.float32)
    cpu = on_cpu(gpu)
    opts = TranscribeOptions(max_new_tokens=SPEECH_NEW)
    check_f32("audio", "Moonshine tiny: encoder states, 10 s",
              *[ms.encode(m.config, m.params, torch.as_tensor(wav, device=m.device)[None])
                for m in (gpu, cpu)])
    toks = [m.transcribe_ids(wav, opts) for m in (gpu, cpu)]
    tie_at_first_difference("audio", f"Moonshine tiny float32, {len(toks[1])} tokens, card vs CPU",
                            toks[1], toks[0], moonshine_replay(cpu, wav, toks[1]))
    model = moonshine_model(63, torch.bfloat16)
    toks, steps = counted_steps(model, lambda: model.transcribe_ids(wav, opts))
    with graphs.eager():
        eager = model.transcribe_ids(wav, opts)
    tie_at_first_difference("audio", f"Moonshine tiny bf16, {len(toks)} tokens, graphs vs eager "
                                     f"({steps} steps, each one graph replay)", eager, toks,
                            moonshine_replay(model, wav, eager))
    wav_t = torch.as_tensor(wav, device="cuda").to(torch.bfloat16)[None]
    encoder_ms = sync_ms(lambda: ms.encode_and_kv(model.config, model.params, wav_t))
    enc_len = ms.encode_and_kv(model.config, model.params, wav_t)[0].shape[1]
    slots = max(model._caches)
    step_ms, step_eager, _ = speech_step_ms(model, model._cache(slots), enc_len, 4)
    model.release_graphs()
    log("audio", f"Moonshine tiny bf16: encoder {encoder_ms:.2f} ms (10 s, {enc_len} positions), "
                 f"decode step {step_ms:.3f} ms as a graph vs {step_eager:.3f} ms eager")


def check_vad() -> None:
    """The native VAD net (its default draw) on the card and on the CPU with
    the same weights, over 10 s of audio in 512-sample chunks: the speech
    probabilities within 1e-5, and ``Vad.segment_audio`` gives identical
    segments (its threshold put between two of the CPU's probabilities, at
    least 1e-4 from every one, so the comparison is not a tie)."""
    import torch

    from crane_tpu_torch.models import silero_vad as sv

    cpu = sv.VadModel(seed=7, device="cpu")
    gpu = sv.VadModel(seed=7, device="cuda")
    wav = speech_wave(10.0, 29)
    w = sv.VadConfig().window_size_samples
    probs = {}
    t0 = time.perf_counter()
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        state, ps = m.initial_state(), []
        for i in range(0, len(wav) - w + 1, w):
            p, state = m(wav[i:i + w], state)
            ps.append(p)
        probs[name] = torch.tensor(ps, dtype=torch.float64)
    card_s = time.perf_counter() - t0
    err = (probs["cuda"] - probs["cpu"]).abs().max().item()
    log("audio", f"VAD net: {len(probs['cpu'])} chunks of {w}, max |p card - p CPU| {err:.3g} "
                 f"(limit 1e-5); p in [{probs['cpu'].min():.4f}, {probs['cpu'].max():.4f}]")
    if err > 1e-5:
        raise AssertionError("the VAD net's probabilities on the card disagree with the CPU's")
    # the threshold in the widest gap between neighbouring probabilities,
    # the hysteresis's lower one in the widest gap below it
    ps = probs["cpu"].sort().values
    gaps = ps.diff()
    j = int(gaps[1:-1].argmax()) + 1
    k = int(gaps[:j].argmax()) if j > 1 else 0
    if min(gaps[j], gaps[k]) < 2e-4:
        raise AssertionError("no gap of 2e-4 between the VAD's probabilities for a threshold")
    threshold = float(ps[j] + ps[j + 1]) / 2
    offset = threshold - float(ps[k] + ps[k + 1]) / 2
    cfg = dict(threshold=threshold, neg_threshold_offset=offset, min_speech_duration_ms=60,
               min_silence_duration_ms=60)
    segs = [sv.Vad(sv.VadConfig(**cfg), model=m).segment_audio(wav) for m in (gpu, cpu)]
    if [(s.start, s.end) for s in segs[0]] != [(s.start, s.end) for s in segs[1]]:
        raise AssertionError(f"VAD segments on the card {segs[0]} vs the CPU {segs[1]}")
    log("audio", f"VAD segment_audio over 10 s at threshold {threshold:.5f}: {len(segs[0])} "
                 f"segments, identical on the card and the CPU ({card_s:.1f} s for both nets)")


def check_audio_kernels() -> list[dict]:
    """Phase 3 at this slice's shapes: K1 and K3 with Qwen2-Audio's text
    heads, 32 query / 32 KV heads of 128 (group 1), at its transcription
    prompt (QWEN2_AUDIO_S of audio): K3 over the prefill's 64-floor bucket
    at positions 0.. in the cache of ``bucket_length(S + new, 256)`` slots,
    K1 at B=1 over the prompt's live length; each against its plain
    version (also at other lengths), timed beside it and SDPA. Returns the
    rows, launches 0."""
    import torch

    from crane_tpu_torch.models.qwen2_audio import audio_feature_lengths
    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.utils.buckets import bucket_length

    gen = torch.Generator(device="cuda").manual_seed(1313)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    H, D = 32, 128
    S = len(qwen2_audio_prompt(audio_feature_lengths(int(QWEN2_AUDIO_S * 100))))
    Sb, T = bucket_length(S, floor=64), bucket_length(S + QWEN2_AUDIO_NEW, floor=256)
    kc, vc = rnd(1, T, H, D), rnd(1, T, H, D)
    q = rnd(1, Sb, H, D)
    errs = []
    for off in (0, 64, T - Sb):
        pos = (torch.arange(Sb, dtype=torch.int32, device="cuda") + off)[None].contiguous()
        errs.append(compare(f"K3 32/32 heads, offset {off}",
                            k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5),
                            k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5)))
    pos = torch.arange(Sb, dtype=torch.int32, device="cuda")[None].contiguous()
    rows = [timed_row(
        "flash_attention_cached" + MHA_HEADS, "flash_attention_mma.cu",
        "crane_tpu/ops/pallas/flash_attention.py:384", errs,
        lambda: k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5),
        lambda: k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5),
        f"B=1 S={Sb} (a {S}-token prompt) at positions 0.., T={T}, Hq=32 Hkv=32 D=128",
        chunk_work(q, H, T, pos), lambda: sdpa(q, kc, vc, mask=chunk_mask(pos, T)))]
    q1 = rnd(1, 1, H, D)
    errs = []
    for live in (1, S, T):
        v = torch.tensor([live], dtype=torch.int32, device="cuda")
        errs.append(compare(f"K1 32/32 heads, {live} live",
                            k1.fp_decode_attention(q1, kc, vc, v, scale=D ** -0.5),
                            k1.fp_decode_attention_plain(q1, kc, vc, v, scale=D ** -0.5)))
    valid = torch.tensor([S], dtype=torch.int32, device="cuda")
    rows.append(timed_row(
        "fp_decode_attention" + MHA_HEADS, "decode_attention.cu",
        "crane_tpu/ops/pallas/quant_attention.py:266", errs,
        lambda: k1.fp_decode_attention(q1, kc, vc, valid, scale=D ** -0.5),
        lambda: k1.fp_decode_attention_plain(q1, kc, vc, valid, scale=D ** -0.5),
        f"B=1 T={T}, {S} live slots, Hq=32 Hkv=32 D=128", decode_work(q1, H, valid),
        lambda: sdpa(q1, kc, vc, mask=decode_mask(valid, T))))
    return rows


# ---------------------------------------------------------------------------
# Phase 22 (tts): speech out. Qwen3-TTS at bench.py's 0.6B-class widths,
# served over /v1/audio/speech, and CSM-1B with the Mimi codec

# Qwen3-TTS at bench.py:399-451's widths (the 0.6B-class talker: 28 layers
# of 1024, 16 / 8 heads of 128, MLP 3072, codec vocabulary 3072, 16 code
# groups, text table 151936 x 2048; the code predictor: 6 layers of 1024,
# 16 / 8 heads of 64), with a code predictor vocabulary of 2048 (the speech
# decoder's codebook size, so every predicted code decodes) and control ids
# in the top 1024 of the codec vocabulary (EOS 2150)
QWEN3_TTS = {
    "talker": dict(vocab_size=3072, hidden_size=1024, num_layers=28, num_heads=16,
                   num_kv_heads=8, head_dim=128, intermediate_size=3072, rope_theta=1e6,
                   qk_norm=True),
    "predictor": dict(vocab_size=2048, hidden_size=1024, num_layers=6, num_heads=16,
                      num_kv_heads=8, head_dim=64, intermediate_size=3072, rope_theta=1e6,
                      qk_norm=True),
    "groups": 16, "text_vocab": 151936, "text_hidden": 2048,
    "specials": dict(vocab_size=3072, codec_eos=2150, codec_think=2154, codec_nothink=2155,
                     codec_think_bos=2156, codec_think_eos=2157, codec_pad=2148, codec_bos=2149,
                     language_ids={"english": 2050}, speaker_ids={}, spk_is_dialect={}),
}
# the codec head and the code predictor's 15 heads are scaled by TTS_PEAK in
# the drawn checkpoint: a logit gap of the unscaled heads' 1e-5 is then 10
# in the sampler's units, so top-k 50 at temperature 0.9 takes the argmax
# but for a near-tie, and two runs with different generators (the card's,
# the CPU's) give the same codes; a tie is judged in the unscaled units
TTS_PEAK = 1e6
TTS_TEXT = 20  # text ids of a request
TTS_BLOCK = 16  # frames a block (generate_speech_codes)
TTS_F32_FRAMES = 16
TTS_F32_LAYERS = 4  # of the talker's 28, for the float32 check against the CPU
TTS_FRAMES = 64  # generate_speech_codes for the RTF: 5.12 s of audio
TTS_HTTP_FRAMES = 50  # the frame cap over HTTP (random weights rarely sample EOS)
FRAME_S = 0.08  # 12.5 Hz

# CSM-1B: transformers 4.57.6's CsmConfig() defaults (its published
# config): backbone 16 layers of 2048, 32 / 8 heads of 64, MLP 8192; depth
# decoder 4 layers of 1024, 8 / 2 heads of 128, MLP 8192; 32 codebooks of
# 2051; text vocabulary 128256; the codec MimiConfig()
CSM_1B = {
    "model_type": "csm", "num_codebooks": 32, "vocab_size": 2051, "text_vocab_size": 128256,
    "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5,
    "rope_theta": 500000, "max_position_embeddings": 2048, "codebook_eos_token_id": 0,
    "audio_token_id": 128002, "audio_eos_token_id": 128003,
    "depth_decoder_config": {
        "num_codebooks": 32, "vocab_size": 2051, "backbone_hidden_size": 2048,
        "hidden_size": 1024, "intermediate_size": 8192, "num_hidden_layers": 4,
        "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 128,
        "rms_norm_eps": 1e-5, "rope_theta": 500000, "max_position_embeddings": 33},
    "codec_config": {
        "sampling_rate": 24000, "hidden_size": 512, "num_filters": 64, "num_residual_layers": 1,
        "upsampling_ratios": [8, 6, 5, 4], "kernel_size": 7, "last_kernel_size": 3,
        "residual_kernel_size": 3, "dilation_growth_rate": 2, "codebook_size": 2048,
        "codebook_dim": 256, "num_quantizers": 32, "num_semantic_quantizers": 1,
        "num_hidden_layers": 8, "num_attention_heads": 8, "head_dim": 64,
        "intermediate_size": 2048, "rope_theta": 10000.0, "sliding_window": 250,
        "norm_eps": 1e-5, "upsample_groups": 512},
}
CSM_FRAMES = 24
CSM_F32_LAYERS = 4  # of the backbone's 16, for the float32 check (depth and codec whole)
CSM_F32_FRAMES = 2  # each frame 31 recomputes of the depth decoder on the CPU

# kernel-row tags of this slice's shapes: the code predictor's two-token
# prefill and its steps over the 32-slot cache, CSM's depth recompute
PRED_PREFILL = "[D64-16/8 S2 T32]"
PRED_STEP = "[D64-16/8 T32]"
DEPTH_CHUNK = "[D128-8/2 S32 T32]"


def check_tts_kernels() -> list[dict]:
    """Phase 3 at this slice's shapes, the kernels' smallest yet: K3 at S=2
    over a 32-slot cache with 16 / 8 heads of 64 (the code predictor's
    prefill, positions 0 and 1; also at 30 and 31), K1 at B=1 over that
    cache (its steps, 3 to 17 live slots), K3 at S=32 over a 32-slot cache
    with 8 / 2 heads of 128 (CSM's depth recompute); each against its plain
    version, timed beside it and SDPA. Returns the rows, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    gen = torch.Generator(device="cuda").manual_seed(1414)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def positions(start, S):
        return (torch.arange(S, dtype=torch.int32, device="cuda") + start)[None].contiguous()

    rows = []
    T = 32
    for tag, (Hq, Hkv, D, S, starts) in ((PRED_PREFILL, (16, 8, 64, 2, (0, 30))),
                                         (DEPTH_CHUNK, (8, 2, 128, 32, (0,)))):
        kc, vc, q = rnd(1, T, Hkv, D), rnd(1, T, Hkv, D), rnd(1, S, Hq, D)
        errs = [compare(f"K3 {tag} at {s}",
                        k23.flash_attention_cached(q, kc, vc, positions(s, S), scale=D ** -0.5),
                        k23.flash_attention_cached_plain(q, kc, vc, positions(s, S),
                                                         scale=D ** -0.5))
                for s in starts]
        pos = positions(0, S)
        rows.append(timed_row(
            "flash_attention_cached" + tag, "flash_attention_mma.cu",
            "crane_tpu/ops/pallas/flash_attention.py:384", errs,
            lambda q=q, kc=kc, vc=vc, pos=pos, D=D: k23.flash_attention_cached(
                q, kc, vc, pos, scale=D ** -0.5),
            lambda q=q, kc=kc, vc=vc, pos=pos, D=D: k23.flash_attention_cached_plain(
                q, kc, vc, pos, scale=D ** -0.5),
            f"B=1 S={S} at positions 0.., T={T}, Hq={Hq} Hkv={Hkv} D={D}",
            chunk_work(q, Hkv, T, pos),
            lambda q=q, kc=kc, vc=vc, pos=pos: sdpa(q, kc, vc, mask=chunk_mask(pos, T))))
    kc, vc, q1 = rnd(1, T, 8, 64), rnd(1, T, 8, 64), rnd(1, 1, 16, 64)
    errs = []
    for live in (3, 10, 17, T):
        v = torch.tensor([live], dtype=torch.int32, device="cuda")
        errs.append(compare(f"K1 {PRED_STEP}, {live} live",
                            k1.fp_decode_attention(q1, kc, vc, v, scale=64 ** -0.5),
                            k1.fp_decode_attention_plain(q1, kc, vc, v, scale=64 ** -0.5)))
    valid = torch.tensor([17], dtype=torch.int32, device="cuda")
    rows.insert(1, timed_row(
        "fp_decode_attention" + PRED_STEP, "decode_attention.cu",
        "crane_tpu/ops/pallas/quant_attention.py:266", errs,
        lambda: k1.fp_decode_attention(q1, kc, vc, valid, scale=64 ** -0.5),
        lambda: k1.fp_decode_attention_plain(q1, kc, vc, valid, scale=64 ** -0.5),
        f"B=1 T={T}, 17 live slots (the predictor's last step), Hq=16 Hkv=8 D=64",
        decode_work(q1, 8, valid), lambda: sdpa(q1, kc, vc, mask=decode_mask(valid, T))))
    return rows


def stack_state_dict(cfg, gen, prefix: str) -> dict:
    """A transformer stack's layers and final norm in the HF layout
    (``models/init.py`` ``hf_state_dict``, float32 on ``gen``'s device)
    under ``prefix`` in place of ``model.``; no embedding, no head."""
    import torch

    from crane_tpu_torch.models.init import hf_state_dict

    return {prefix + k[len("model."):]: v
            for k, v in hf_state_dict(cfg, gen, torch.float32).items()
            if k.startswith("model.") and "embed_tokens" not in k}


def qwen3_tts_state_dict(gen) -> dict:
    """QWEN3_TTS's talker and code predictor under the names
    ``map_talker_weights`` reads, drawn on ``gen``'s device in float32, the
    codec head and the predictor's heads scaled by TTS_PEAK."""
    import torch

    from crane_tpu_torch.models.modules.transformer import TransformerConfig

    tcfg, pcfg = (TransformerConfig(**QWEN3_TTS["talker"]),
                  TransformerConfig(**QWEN3_TTS["predictor"]))
    E, V, PV, TV, TD = (tcfg.hidden_size, tcfg.vocab_size, pcfg.vocab_size,
                        QWEN3_TTS["text_vocab"], QWEN3_TTS["text_hidden"])
    n = QWEN3_TTS["groups"] - 1
    shapes = {"talker.model.codec_embedding.weight": (V, E),
              "talker.model.text_embedding.weight": (TV, TD),
              "talker.codec_head.weight": (V, E),
              "talker.text_projection.linear_fc1.weight": (TD, TD),
              "talker.text_projection.linear_fc1.bias": (TD,),
              "talker.text_projection.linear_fc2.weight": (E, TD),
              "talker.text_projection.linear_fc2.bias": (E,)}
    for i in range(n):
        shapes[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = (PV, E)
        shapes[f"talker.code_predictor.lm_head.{i}.weight"] = (PV, pcfg.hidden_size)
    tables = [k for k in shapes if "embedding" in k]
    sd = draw_checkpoint(shapes, gen, torch.float32, tables)
    sd.update(stack_state_dict(tcfg, gen, "talker.model."))
    sd.update(stack_state_dict(pcfg, gen, "talker.code_predictor.model."))
    for k in sd:
        if k == "talker.codec_head.weight" or "code_predictor.lm_head" in k:
            sd[k] = sd[k] * TTS_PEAK
    return sd


def qwen3_tts_model(sd, dtype, device, talker_layers=None, decoder=None):
    """A Qwen3TTSModel from QWEN3_TTS's drawn state dict (the talker cut to
    ``talker_layers``), in ``dtype`` on ``device``, with the stand-in
    tokenizer."""
    import dataclasses

    from crane_tpu_torch.models import qwen3_tts as qt
    from crane_tpu_torch.models.modules.transformer import TransformerConfig

    tcfg = TransformerConfig(**QWEN3_TTS["talker"])
    if talker_layers is not None:
        tcfg = dataclasses.replace(tcfg, num_layers=talker_layers)
    pcfg = TransformerConfig(**QWEN3_TTS["predictor"])
    params = qt.map_talker_weights(tcfg, pcfg, sd, QWEN3_TTS["groups"], dtype, device)
    return qt.Qwen3TTSModel(tcfg, pcfg, qt.TalkerSpecials(**QWEN3_TTS["specials"]), params,
                            num_code_groups=QWEN3_TTS["groups"],
                            tokenizer=StandInTokenizer(QWEN3_TTS["text_vocab"]),
                            decoder=decoder, dtype=dtype)


def tts_frame_logits(model, ids, codes, f):
    """The logits that chose frame ``f`` on ``model``'s own eager path,
    with ``codes[:f]`` fed back: code 0's (the suppress masks and the
    repetition penalty applied) ``[V]``, and the predictor's ``[groups -
    1, PV]`` with frame f's codes fed, the predictor's two-token prefill
    and its steps as the frame runs them."""
    import torch

    from crane_tpu_torch.generation.config import SpeechOptions
    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import qwen3_tts as qt
    from crane_tpu_torch.ops.kv_cache import KVCache
    from crane_tpu_torch.ops.sampling import apply_repetition_penalty

    G, dev, dt = model.num_code_groups, model.device, model.dtype
    opts = SpeechOptions(max_new_tokens=len(codes) + 1)
    talker, pred = model.params["talker"], model.params["pred"]

    def proj(x):
        return x if "mtp_w" not in pred else x @ pred["mtp_w"] + pred["mtp_b"]

    with torch.no_grad(), graphs.eager():
        state = model.prepare_streaming(ids, "english", None, opts)
        h, cache = state.past_hidden, state.cache
        for step in range(f + 1):
            frame = torch.as_tensor(codes[step], device=dev).long() \
                if step < len(codes) else None
            if step == f:
                c0 = (h[:, 0] @ talker["codec_head"]).float() + model._suppress[None]
                if step < 2:
                    c0 = c0 + model._eos_suppress[None]
                recent = torch.full((1, qt.REP_WINDOW), -1, dtype=torch.int32, device=dev)
                past = torch.as_tensor(codes, device=dev)[:f, 0][-qt.REP_WINDOW:]
                if len(past):
                    recent[0, -len(past):] = past.to(torch.int32)
                c0 = apply_repetition_penalty(c0, recent, state.sp.repetition_penalty)[0]
                if frame is None:
                    return c0, None
                e0 = pred["codec_embedding0"][frame[:1]][:, None]
                pc = KVCache(layers=model._pred_cache.layers,
                             lengths=torch.zeros((1,), dtype=torch.int32, device=dev))
                ph, pc = qt.forward_hidden(model.pcfg, pred["tree"],
                                           torch.zeros((1, 2), dtype=torch.int32, device=dev),
                                           pc, 0, model.pred_rope,
                                           inputs_embeds=proj(torch.cat([h, e0], 1)).to(dt))
                hh, groups = ph[:, -1:], []
                for g in range(G - 1):
                    groups.append((hh[:, 0] @ pred["lm_heads"][g]).float()[0])
                    emb = proj(pred["codec_embeddings"][g][frame[g + 1:g + 2]][:, None]).to(dt)
                    hh, pc = qt._step_embed(model.pcfg, pred["tree"], model.pred_rope, pc, emb)
                return c0, torch.stack(groups)
            emb = pred["codec_embedding0"][frame[0]] + sum(
                pred["codec_embeddings"][g][frame[g + 1]] for g in range(G - 1))
            guidance = state.trailing[0, step] if step < state.trailing.shape[1] \
                else state.tts_pad_embed[0, 0]
            h, cache = qt._step_embed(model.tcfg, talker["tree"], model.rope, cache,
                                      (emb + guidance)[None, None].to(dt))


def frame_logits_hold(label, logits_of, codes, unit: float = 1.0) -> None:
    """The tie rule's own check, once a phase: the logits that a frame
    helper (``tts_frame_logits``, ``csm_frame_logits``) rebuilds outside the
    frame's body choose the codes the body chose at frames 0 and 1, each
    code its logits' argmax or within LOGIT_TIE of it (in ``unit``s of the
    logits), so a helper that drifts from the body fails here, where no
    codes part."""
    worst = 0.0
    for f in range(min(2, len(codes))):
        c0, rest = logits_of(f)
        for g, logits in enumerate([c0, *rest]):
            logits = logits.float().cpu()
            worst = max(worst, (logits.max() - logits[int(codes[f][g])]).item() / unit)
    log("tts", f"{label}: the tie helper's logits at frames 0 and 1 choose the path's codes "
               f"(the largest gap to a chosen code {worst:.3g}, tie {LOGIT_TIE})")
    if not worst <= LOGIT_TIE:
        raise AssertionError(f"{label}: the tie helper's logits part from the frame's body")


def tts_codes_tied(phase, label, model, ids, ref, other) -> None:
    """Where two paths' sampled codes part, the reference path's logits at
    the first difference (``tts_frame_logits`` on its model; a path that
    ended takes EOS there) put the two codes within LOGIT_TIE of each other
    in the unscaled heads' units (the logit gap over TTS_PEAK)."""
    import torch

    ref, other = torch.as_tensor(ref), torch.as_tensor(other)
    n = min(len(ref), len(other))
    diff = torch.nonzero(ref[:n] != other[:n])
    if not len(diff) and len(ref) == len(other):
        log(phase, f"{label}: {len(ref)} frames x {ref.shape[1]} codes identical")
        return
    eos = model.sp_tokens.codec_eos
    if len(diff):
        f, g = (int(x) for x in diff[0])
        a, b = int(ref[f, g]), int(other[f, g])
    else:  # one path sampled EOS where the other went on
        f, g = n, 0
        a = int(ref[f, 0]) if len(ref) > n else eos
        b = int(other[f, 0]) if len(other) > n else eos
    c0, groups = tts_frame_logits(model, ids, ref, f)
    logits = (c0 if g == 0 else groups[g - 1]).cpu()
    gap = abs((logits[a] - logits[b]).item()) / TTS_PEAK
    log(phase, f"{label}: codes part at frame {f}, group {g} ({a} vs {b}); the reference's "
               f"logits there put them {gap:.4g} apart in the unscaled heads' units (tie "
               f"{LOGIT_TIE})")
    if not gap <= LOGIT_TIE:
        raise AssertionError(f"{label}: the codes part at frame {f}, group {g} without a tie")


def encoder_codes_tied(label, enc, wav, ref, other) -> None:
    """Where two runs' reference-encoder codes part, the distances of the two
    codewords on the reference run (the CPU's ``enc``) at the first
    difference of each frame's branch lie within 1e-4 of each other,
    relative."""
    import torch

    from crane_tpu_torch.models import speech_tokenizer as st

    ref, other = torch.as_tensor(ref).long(), torch.as_tensor(other).long()
    if torch.equal(ref, other):
        log("tts", f"{label}: {tuple(ref.shape)} codes identical")
        return
    cfg, p = enc.config, enc.params
    with torch.no_grad():
        x = torch.as_tensor(wav, dtype=torch.float32)[None, None]
        h = st.encoder_seanet(cfg, p, x)
        h = st.encoder_transformer(cfg, p["transformer"], h.transpose(1, 2)).transpose(1, 2)
        worst = 0.0
        for branch, q0, nq in ((p["semantic"], 0, cfg.num_semantic_quantizers),
                               (p["acoustic"], cfg.num_semantic_quantizers,
                                cfg.valid_num_quantizers - cfg.num_semantic_quantizers)):
            res = torch.einsum("bdt,nd->btn", h, branch["input_proj"])[0]
            parted = torch.zeros(res.shape[0], dtype=torch.bool)
            for q in range(nq):
                emb = st.codebook_table(branch["layers"][q])
                d = st.codeword_distances(res[None], emb)[0]
                for t in torch.nonzero((ref[:, q0 + q] != other[:, q0 + q]) & ~parted)[:, 0]:
                    da, db = d[t, ref[t, q0 + q]].item(), d[t, other[t, q0 + q]].item()
                    worst = max(worst, abs(da - db) / max(abs(da), abs(db), 1e-30))
                    parted[t] = True
                res = res - emb[ref[:, q0 + q]]
    log("tts", f"{label}: {int((ref != other).sum())} of {ref.numel()} codes part; at each "
               f"chain's first, the codewords' distances lie {worst:.3g} apart (relative; "
               f"tie 1e-4)")
    if worst > 1e-4:
        raise AssertionError(f"{label}: reference codes part without a tie")


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN's float32 convolutions with TF32 allowed or not, inside (the
    package leaves the setting at PyTorch's default, allowed)."""
    import torch

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class CappedTts:
    """A Tts adapter with each request's frames capped at ``frames`` (the
    handler asks for 2048, and random weights rarely sample EOS); the
    adapter and the handler stay as they are."""

    def __init__(self, tts, frames: int):
        self.tts, self.frames = tts, frames

    def _options(self, options):
        import dataclasses

        from crane_tpu_torch.generation.config import SpeechOptions

        return dataclasses.replace(options or SpeechOptions(), max_new_tokens=self.frames)

    def audio_info(self):
        return self.tts.audio_info()

    def voices(self):
        return self.tts.voices()

    def supports_voice_cloning(self):
        return self.tts.supports_voice_cloning()

    def generate_speech(self, text, options=None):
        return self.tts.generate_speech(text, self._options(options))

    def generate_speech_stream(self, text, options=None):
        return self.tts.generate_speech_stream(text, self._options(options))


def http_pcm(port: int, body: dict) -> tuple[float, bytes]:
    """POST a streamed /v1/audio/speech: (seconds to the first PCM bytes,
    all the bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/audio/speech", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            raise AssertionError(f"streamed speech: {r.status} {r.read()[:200]!r}")
        first, data = None, b""
        while True:
            chunk = r.read1(1 << 16)
            if not chunk:
                return first, data
            if first is None:
                first = time.perf_counter() - t0
            data += chunk
    finally:
        conn.close()


def check_qwen3_tts() -> dict[str, int]:
    """Qwen3-TTS at QWEN3_TTS's widths, random weights (QWEN3_TTS's drawn
    checkpoint; the speech decoder, reference encoder and ECAPA at their
    released shapes from the port's seeded ``random_*_state_dict``). Float32
    on the card against the CPU with the talker cut to TTS_F32_LAYERS: the
    prefill's last hidden state and the first frame's code-0 logits
    (F32_REL_L2), TTS_F32_FRAMES frames of codes (equal, or tied:
    ``tts_codes_tied``), the speech decoder's audio for those frames with
    TF32 off (F32_REL_L2; with TF32 on logged); voice clone's ECAPA
    embedding of a 3-s reference and the reference encoder's codes
    (``encoder_codes_tied``). Then bf16 whole: the prefill's ms, one
    16-frame block as one replay against eager (the tie rule), the blocks'
    ms, ``generate_speech_codes`` of TTS_FRAMES frames and its RTF, a
    streaming chunk's decode; a voice-clone loop (one replay a frame); over
    HTTP through ``build_app(Server(None, tts=...))`` (CappedTts) a WAV
    equal to ``Qwen3Tts.generate_speech``'s and a streamed request (time to
    the first PCM chunk, 1920 samples a frame). Returns the bf16 path's
    launch counts (the main path: the direct synthesis and HTTP)."""
    import torch

    from crane_tpu_torch.audio.pcm import encode_wav
    from crane_tpu_torch.generation.config import SpeechOptions
    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import speaker_encoder as se
    from crane_tpu_torch.models import speech_tokenizer as st
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.sdk.audio import Qwen3Tts
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(41)
    sd = qwen3_tts_state_dict(gen)
    dcfg, ecfg, scfg = st.SpeechDecoderConfig(), st.SpeechEncoderConfig(), se.EcapaConfig()
    # the decoder drawn with fan-in scales (crane_tpu's dry-run std of 0.05
    # grows its activations to ~1e6 and clips every sample), its output conv
    # scaled by 0.01 so that the random audio sits inside the clip (rms
    # ~0.1) and the float32 check compares samples
    dec_sd = draw_checkpoint(st.decoder_state_shapes(dcfg), gen, torch.float32)
    dec_sd[f"decoder.decoder.{len(dcfg.upsample_rates) + 2}.conv.weight"] *= 0.01
    decoders = [st.SpeechTokenizerDecoder(dcfg, st.map_decoder_weights(dcfg, dec_sd, device=d))
                for d in ("cuda", "cpu")]
    del dec_sd
    tok = StandInTokenizer(QWEN3_TTS["text_vocab"])
    ids = torch.randint(0, QWEN3_TTS["text_vocab"], (TTS_TEXT,),
                        generator=torch.Generator().manual_seed(43)).tolist()
    text = tok.decode(ids)
    log("tts", f"Qwen3-TTS checkpoint drawn and the speech decoder mapped in "
               f"{time.perf_counter() - t0:.1f} s")

    # float32, card against the CPU, the talker cut to TTS_F32_LAYERS
    t0 = time.perf_counter()
    models = [qwen3_tts_model(sd, torch.float32, d, TTS_F32_LAYERS, dec)
              for d, dec in zip(("cuda", "cpu"), decoders)]
    opts = SpeechOptions(max_new_tokens=TTS_F32_FRAMES, seed=0, language="english")
    states = [m.prepare_streaming(ids, "english", None, opts) for m in models]
    check_f32("tts", f"Qwen3-TTS talker ({TTS_F32_LAYERS} of 28 layers) prefill's last hidden "
                     f"state, {len(ids)} text ids", *(s.past_hidden for s in states))
    check_f32("tts", "Qwen3-TTS first frame's code-0 logits (unmasked)",
              *((s.past_hidden[:, 0] @ m.params["talker"]["codec_head"]).float()
                for s, m in zip(states, models)))
    with graphs.eager():  # numerics here; graphs against eager below, in bf16
        codes = [m.generate_speech_codes(ids, "english", None, opts) for m in models]
    tts_codes_tied("tts", f"Qwen3-TTS float32, {TTS_F32_FRAMES} frames, card vs CPU", models[1],
                   ids, codes[1], codes[0])
    frame_logits_hold("Qwen3-TTS float32 on the card",
                      lambda f: tts_frame_logits(models[0], ids, codes[0], f), codes[0],
                      unit=TTS_PEAK)
    cpu_audio = torch.as_tensor(decoders[1].decode(codes[1][None]))
    for tf32 in (False, True):
        with cudnn_tf32(tf32):
            audio = torch.as_tensor(decoders[0].decode(codes[1][None]))
        label = (f"speech decoder audio of {len(codes[1])} frames ({audio.shape[1]} samples), "
                 f"cuDNN TF32 {'on' if tf32 else 'off'}")
        if tf32:
            log("tts", f"{label}: rel L2 {rel_l2(audio, cpu_audio):.3g} against the CPU (logged, "
                       f"not held)")
        else:
            check_f32("tts", label, audio, cpu_audio)
    clipped = float((cpu_audio.abs() >= 1.0).float().mean())
    log("tts", f"the decoded audio: rms {cpu_audio.pow(2).mean().sqrt().item():.4g}, clipped "
               f"share {clipped:.4g}")
    del models, states

    # voice clone's encoders, float32, card against the CPU
    ecapa_sd = se.random_speaker_encoder_state_dict(scfg, 44)
    ecapas = [se.SpeakerEncoder(scfg, se.map_speaker_encoder_weights(scfg, ecapa_sd, device=d))
              for d in ("cuda", "cpu")]
    encoders = [st.SpeechTokenizerEncoder(ecfg, st.init_encoder_params(ecfg, 45, d))
                for d in ("cuda", "cpu")]
    ref_wav = speech_wave(3.0, 46, 24000)
    with cudnn_tf32(False):
        check_f32("tts", "ECAPA x-vector of a 3-s 24 kHz reference, cuDNN TF32 off",
                  *(torch.as_tensor(e(ref_wav)) for e in ecapas))
        ref_codes = [e.encode(ref_wav) for e in encoders]
    encoder_codes_tied(f"the reference encoder's codes of 3 s, {ref_codes[1].shape}",
                       encoders[1], ref_wav, ref_codes[1], ref_codes[0])
    log("tts", f"Qwen3-TTS float32 checks done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # bf16, the whole talker: the main path is counted from here
    model = qwen3_tts_model(sd, torch.bfloat16, "cuda", decoder=decoders[0])
    model.speaker_encoder, model.ref_encoder = ecapas[0], encoders[0]
    del sd, ecapas, encoders, decoders
    torch.cuda.empty_cache()
    reset_counts()
    opts = SpeechOptions(max_new_tokens=TTS_FRAMES, seed=0)
    prefill_ms = sorted(sync_ms(lambda: model.prepare_streaming(ids, "english", None, opts))
                        for _ in range(3))[1]
    blocks = {}
    for mode in ("capture", "graph", "eager"):
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            state = model.prepare_streaming(ids, "english", None, opts)
            replays = graphs.replays
            out = []
            ms = sync_ms(lambda: out.append(model.generate_frames(state, TTS_BLOCK)))
            blocks[mode] = (out[0], graphs.replays - replays, ms)
    if blocks["graph"][1] != 1 or blocks["eager"][1] != 0:
        raise AssertionError(f"Qwen3-TTS: a block took {blocks['graph'][1]} replays")
    tts_codes_tied("tts", f"Qwen3-TTS bf16, one {TTS_BLOCK}-frame block, graph vs eager", model,
                   ids, blocks["eager"][0], blocks["graph"][0])
    block_ms, block_eager = blocks["graph"][2], blocks["eager"][2]
    log("tts", f"Qwen3-TTS bf16: the block's first call (its capture) took "
               f"{blocks['capture'][2] / 1e3:.1f} s")
    log("time", f"tts: the bf16 model mapped and its blocks run in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    def block():
        model.generate_frames(model.prepare_streaming(ids, "english", None, opts), TTS_BLOCK)
    state = model.prepare_streaming(ids, "english", None, opts)
    before = kernels.launch_counts()
    model.generate_frames(state, 1)
    per_frame = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    log("tts", f"Qwen3-TTS bf16: one frame's launches {json.dumps(per_frame)}")
    runs, n_frames = [], 0
    for _ in range(3):
        t1 = time.perf_counter()
        c = model.generate_speech_codes(ids, "english", None, opts, block_frames=TTS_BLOCK)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
        n_frames = len(c)
    gen_s = sorted(runs)[1]
    chunk = c[None, :50]
    chunk_ms = sorted(sync_ms(lambda: model.decoder.decode_chunk(chunk, 25)) for _ in range(3))[1]
    log_busy("tts", "Qwen3-TTS bf16", f"a prefill and one {TTS_BLOCK}-frame block", block)
    log("tts", f"Qwen3-TTS bf16 ({len(ids)} text ids): prefill {prefill_ms:.2f} ms, a "
               f"{TTS_BLOCK}-frame block {block_ms:.1f} ms as one graph replay vs "
               f"{block_eager:.1f} ms eager ({block_ms / TTS_BLOCK:.2f} ms a frame); "
               f"generate_speech_codes of {n_frames} frames {gen_s * 1e3:.1f} ms (median of 3), "
               f"RTF {gen_s / (n_frames * FRAME_S):.4f} (synthesis seconds an audio second); a "
               f"streaming chunk's decode (25 new + 25 context frames, float32) {chunk_ms:.2f} ms")

    log("time", f"tts: launches a frame, the RTF, a chunk's decode and the busy share in "
                f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # voice clone once: ECAPA, the reference encoder, the ICL prompt, one
    # replay a frame
    replays = graphs.replays
    clone = model.generate_voice_clone_codes(
        ids[:8], ids[8:12], model.encode_reference(ref_wav), model.speaker_encoder(ref_wav),
        "english", SpeechOptions(max_new_tokens=8, seed=1))
    if graphs.replays - replays != len(clone) + (len(clone) < 8):
        raise AssertionError(f"voice clone: {len(clone)} frames in "
                             f"{graphs.replays - replays} replays")
    log("tts", f"Qwen3-TTS voice clone (ICL over {len(model.encode_reference(ref_wav))} "
               f"reference frames): {len(clone)} frames, one replay a frame")

    log("time", f"tts: the voice clone in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # over HTTP: the WAV equals the direct synthesis; the stream's first chunk
    tts = CappedTts(Qwen3Tts(model), TTS_HTTP_FRAMES)
    direct = tts.generate_speech(text, SpeechOptions())
    t1 = time.perf_counter()
    list(tts.generate_speech_stream(text, SpeechOptions()))  # its block captures
    log("tts", f"Qwen3-TTS: the first stream (its {Qwen3Tts(model).stream_frames}-frame block "
               f"captured) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    stream = iter(tts.generate_speech_stream(text, SpeechOptions()))
    first_chunk = next(stream)
    first_direct = time.perf_counter() - t1
    rest = [first_chunk] + list(stream)
    with BackgroundServer(build_app(Server(None, tts=tts))) as srv:
        status, _, wav = http_raw_bytes(srv.port, "/v1/audio/speech",
                                        {"Content-Type": "application/json"},
                                        json.dumps({"input": text}).encode())
        first_http, pcm = http_pcm(srv.port, {"input": text, "stream": True})
    if status != 200 or wav != encode_wav(direct, 24000):
        raise AssertionError(f"Qwen3-TTS over HTTP: {status}, {len(wav)} bytes against the direct "
                             f"synthesis' {len(encode_wav(direct, 24000))}")
    frames = len(direct) // 1920
    if len(direct) != frames * 1920 or len(pcm) != 2 * len(direct) \
            or sum(len(x) for x in rest) != len(direct):
        raise AssertionError(f"Qwen3-TTS stream: {len(pcm)} bytes for {len(direct)} samples")
    log("tts", f"Qwen3-TTS over HTTP ({frames} frames, {frames * FRAME_S:.2f} s of audio): the WAV "
               f"equals Qwen3Tts.generate_speech; streamed, {len(rest)} PCM chunks of 1920 samples "
               f"a frame, the first after {first_http * 1e3:.1f} ms over HTTP "
               f"({first_direct * 1e3:.1f} ms direct)")
    log("time", f"tts: the synthesis over HTTP and streamed in {time.perf_counter() - t0:.1f} s")
    counts = kernels.launch_counts()
    model.release_graphs()
    return counts


def http_raw_bytes(port: int, path: str, headers: dict, body: bytes) -> tuple[int, dict, bytes]:
    """POST ``body``: (status, headers, the response's bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def mimi_shapes(c: dict) -> dict:
    """An HF MimiModel's state-dict names and shapes at the config ``c``, as
    ``models/mimi.py`` ``map_mimi_weights`` reads them."""
    nf, H, ratios = c["num_filters"], c["hidden_size"], c["upsampling_ratios"]
    k, rk, lk = c["kernel_size"], c["residual_kernel_size"], c["last_kernel_size"]
    shapes = {}

    def conv(name, cout, cin, kk, bias=True):
        shapes[name + ".conv.weight"] = (cout, cin, kk)
        if bias:
            shapes[name + ".conv.bias"] = (cout,)

    def res(prefix, idx, ch):
        conv(f"{prefix}.layers.{idx}.block.1", ch // 2, ch, rk)
        conv(f"{prefix}.layers.{idx}.block.3", ch, ch // 2, 1)

    conv("encoder.layers.0", nf, 1, k)
    idx, ch = 1, nf
    for r in reversed(ratios):
        res("encoder", idx, ch)
        conv(f"encoder.layers.{idx + 2}", 2 * ch, ch, 2 * r)
        idx, ch = idx + 3, 2 * ch
    conv(f"encoder.layers.{idx + 1}", H, ch, lk)
    conv("decoder.layers.0", ch, H, k)
    idx = 1
    for r in ratios:
        conv(f"decoder.layers.{idx + 1}", ch, ch // 2, 2 * r, bias=False)  # [Cin, Cout, k]
        shapes[f"decoder.layers.{idx + 1}.conv.bias"] = (ch // 2,)
        res("decoder", idx + 2, ch // 2)
        idx, ch = idx + 3, ch // 2
    conv(f"decoder.layers.{idx + 1}", 1, nf, lk)
    for name in ("encoder_transformer", "decoder_transformer"):
        for i in range(c["num_hidden_layers"]):
            lp = f"{name}.layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
                shapes[lp + f"self_attn.{n}.weight"] = (H, H)
            shapes[lp + "mlp.fc1.weight"] = (c["intermediate_size"], H)
            shapes[lp + "mlp.fc2.weight"] = (H, c["intermediate_size"])
            for n in ("input_layernorm", "post_attention_layernorm"):
                shapes[lp + n + ".weight"] = shapes[lp + n + ".bias"] = (H,)
            shapes[lp + "self_attn_layer_scale.scale"] = shapes[lp + "mlp_layer_scale.scale"] = (H,)
    dim, n_sem = c["codebook_dim"], c["num_semantic_quantizers"]
    for name, n in (("semantic", n_sem), ("acoustic", c["num_quantizers"] - n_sem)):
        q = f"quantizer.{name}_residual_vector_quantizer."
        shapes[q + "input_proj.weight"] = (dim, H, 1)
        shapes[q + "output_proj.weight"] = (H, dim, 1)
        for i in range(n):
            shapes[q + f"layers.{i}.codebook.embed_sum"] = (c["codebook_size"], dim)
            shapes[q + f"layers.{i}.codebook.cluster_usage"] = (c["codebook_size"],)
    shapes["downsample.conv.weight"] = (H, H, 4)
    shapes["upsample.conv.weight"] = (H, H // c["upsample_groups"], 4)
    return shapes


def csm_state_dict(gen) -> dict:
    """CSM_1B under the names ``map_csm_weights`` and ``map_mimi_weights``
    read, drawn on ``gen``'s device in float32 (the codebooks' embedding
    sums with std 1, the codebook heads with std 1024 ** -0.5), saved with
    tied codebook tables as transformers saves it (no backbone audio
    table)."""
    import torch

    from crane_tpu_torch.models.csm_tts import csm_config_from_hf

    cfg = csm_config_from_hf(CSM_1B)
    K, Va, E = cfg.num_codebooks, cfg.audio_vocab_size, cfg.backbone.hidden_size
    Dd = cfg.depth.hidden_size
    shapes = {"embed_text_tokens.weight": (cfg.text_vocab_size, E),
              # the depth decoder embeds at the backbone's width, then projects
              "depth_decoder.model.embed_tokens.weight": (K * Va, E),
              "depth_decoder.model.inputs_embeds_projector.weight": (Dd, E),
              "lm_head.weight": (Va, E)}
    codec = {"codec_model." + n: s for n, s in mimi_shapes(CSM_1B["codec_config"]).items()}
    sd = draw_checkpoint({**shapes, **codec}, gen, torch.float32,
                         ["embed_text_tokens.weight", "depth_decoder.model.embed_tokens.weight"])
    sd["depth_decoder.codebooks_head.weight"] = torch.randn(
        (K - 1, Dd, Va), generator=gen, device=gen.device) * Dd ** -0.5
    for name in codec:
        if name.endswith("embed_sum"):
            sd[name] = torch.randn(codec[name], generator=gen, device=gen.device)
    sd.update(stack_state_dict(cfg.backbone, gen, "backbone_model."))
    sd.update(stack_state_dict(cfg.depth, gen, "depth_decoder.model."))
    return sd


def csm_model(sd, dtype, device, backbone_layers=None):
    """A CsmTtsModel from CSM_1B's drawn state dict (the backbone cut to
    ``backbone_layers``), in ``dtype`` on ``device``, with the Mimi codec in
    float32."""
    import dataclasses

    from crane_tpu_torch.models import csm_tts as ct
    from crane_tpu_torch.models.mimi import MimiCodec, map_mimi_weights, mimi_config_from_hf

    cfg = ct.csm_config_from_hf(CSM_1B)
    if backbone_layers is not None:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, num_layers=backbone_layers))
    ccfg = mimi_config_from_hf(CSM_1B["codec_config"])
    codec = MimiCodec(ccfg, map_mimi_weights(
        ccfg, {k[len("codec_model."):]: v for k, v in sd.items() if k.startswith("codec_model.")},
        device=device))
    return ct.CsmTtsModel(cfg, ct.map_csm_weights(cfg, sd, dtype, device), codec=codec,
                          dtype=dtype)


def csm_frame_logits(model, ids, codes, f):
    """The logits that chose frame ``f`` on ``model``'s own eager path with
    ``codes[:f]`` fed back: code 0's ``[Va]`` (the backbone's head) and the
    depth decoder's ``[K - 1, Va]`` over frame f's codes (one recompute of
    all K positions: position i sees only the positions up to i, as in
    each of the frame's recomputes)."""
    import torch
    import torch.nn.functional as F

    from crane_tpu_torch.models import csm_tts as ct
    from crane_tpu_torch.models.modules.transformer import forward_hidden, make_cache
    from crane_tpu_torch.ops.kv_cache import KVCache
    from crane_tpu_torch.utils.buckets import bucket_length

    cfg, p, dev = model.config, model.params, model.device
    K, Va = cfg.num_codebooks, cfg.audio_vocab_size
    with torch.no_grad():
        S = len(ids)
        embeds = F.pad(model.prompt_embeds(ids, None), (0, 0, 0, bucket_length(S, floor=32) - S))
        cache = make_cache(cfg.backbone, 1, bucket_length(S + len(codes) + 1, floor=256),
                           model.dtype, device=dev)
        h, cache = ct._backbone_prefill(cfg.backbone, p["backbone"], model.rope, cache,
                                        embeds.to(model.dtype), S)
        for step in range(f):
            frame = torch.as_tensor(codes[step], device=dev)
            h, cache = ct._backbone_step(cfg.backbone, p["backbone"], model.rope, cache,
                                         model.frame_embed(frame).to(model.dtype))
        c0 = h @ p["lm_head"]
        frame = torch.as_tensor(codes[f], device=dev).long()
        seq = torch.cat([(h @ p["depth_projector"])[None],
                         p["depth_embed"][frame[:K - 1] + torch.arange(K - 1, device=dev) * Va]
                         @ p["depth_projector"]])
        hd, _ = forward_hidden(cfg.depth, p["depth"], torch.zeros((1, K), dtype=torch.int32,
                                                                  device=dev),
                               KVCache(layers=make_cache(cfg.depth, 1, K, model.dtype,
                                                         device=dev).layers,
                                       lengths=torch.zeros((1,), dtype=torch.int32, device=dev)),
                               0, model.depth_rope, inputs_embeds=seq[None])
        depth = torch.stack([hd[0, i] @ p["codebooks_head"][i - 1] for i in range(1, K)])
    return c0, depth


def csm_codes_tied(label, model, ids, ref, other) -> None:
    """Where two greedy paths' CSM codes part, the reference path's logits
    at the first difference (``csm_frame_logits``; a path that stopped
    takes EOS, code 0 = 0) choose its code again and put the other within
    LOGIT_TIE."""
    import torch

    ref, other = torch.as_tensor(ref), torch.as_tensor(other)
    n = min(len(ref), len(other))
    diff = torch.nonzero(ref[:n] != other[:n])
    if not len(diff) and len(ref) == len(other):
        log("tts", f"{label}: {len(ref)} frames x {ref.shape[1]} codes identical")
        return
    eos = model.config.codebook_eos_token_id
    if len(diff):
        f, g = (int(x) for x in diff[0])
        a, b = int(ref[f, g]), int(other[f, g])
    else:
        f, g = n, 0
        a = int(ref[f, 0]) if len(ref) > n else eos
        b = int(other[f, 0]) if len(other) > n else eos
    codes = ref if len(ref) > f else torch.cat([ref, torch.zeros_like(ref[:1])])
    c0, depth = csm_frame_logits(model, ids, codes, f)
    logits = (c0 if g == 0 else depth[g - 1]).float().cpu()
    gap = (logits[a] - logits[b]).item()
    log("tts", f"{label}: codes part at frame {f}, codebook {g} ({a} vs {b}); replayed, the "
               f"reference chooses {int(logits.argmax())} and the gap is {gap:.4g} (tie "
               f"{LOGIT_TIE})")
    if int(logits.argmax()) != a or gap > LOGIT_TIE:
        raise AssertionError(f"{label}: the codes part at frame {f} without a tie")


def check_csm() -> dict[str, int]:
    """CSM-1B (CSM_1B, Mimi at MimiConfig()), random weights under the
    names the ``map_*`` functions read. Float32 with the backbone cut to
    CSM_F32_LAYERS (depth decoder and codec whole) on the card against the
    CPU: CSM_F32_FRAMES greedy frames (equal, or tied: ``csm_codes_tied``)
    and Mimi's audio of the CPU's codes with TF32 off (F32_REL_L2). Then
    bf16 whole: CSM_FRAMES greedy frames, each frame one graph replay
    (counted), against the eager frames (the tie rule); a frame's ms as a
    replay and eager, Mimi's decode, the RTF; voice clone once through
    ``audio_context`` (a 2-s reference encoded by Mimi on the card).
    Returns the bf16 path's launch counts."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(51)
    sd = csm_state_dict(gen)
    ids = torch.randint(0, 128000, (TTS_TEXT,), generator=torch.Generator().manual_seed(52)).tolist()
    models = [csm_model(sd, torch.float32, d, CSM_F32_LAYERS) for d in ("cuda", "cpu")]
    with graphs.eager():  # numerics here; graphs against eager below, in bf16
        codes = [m.generate_codes(ids, max_frames=CSM_F32_FRAMES) for m in models]
    csm_codes_tied(f"CSM-1B float32 (backbone {CSM_F32_LAYERS} of 16 layers), "
                   f"{CSM_F32_FRAMES} frames, card vs CPU", models[1], ids, codes[1], codes[0])
    frame_logits_hold("CSM-1B float32 on the card",
                      lambda f: csm_frame_logits(models[0], ids, codes[0], f), codes[0])
    if len(codes[1]):
        with cudnn_tf32(False):
            audio = [torch.as_tensor(m.codec.decode(codes[1].T[None])) for m in models]
        check_f32("tts", f"Mimi's audio of {len(codes[1])} frames, cuDNN TF32 off", *audio)
    log("tts", f"CSM-1B float32 checks done in {time.perf_counter() - t0:.1f} s")
    del models
    t0 = time.perf_counter()

    model = csm_model(sd, torch.bfloat16, "cuda")
    del sd
    torch.cuda.empty_cache()
    reset_counts()
    replays = graphs.replays
    toks = model.generate_codes(ids, max_frames=CSM_FRAMES)
    if graphs.replays - replays != len(toks):
        raise AssertionError(f"CSM: {len(toks)} frames in {graphs.replays - replays} replays")
    eager = []
    with graphs.eager():
        total_eager = sync_ms(lambda: eager.append(model.generate_codes(ids,
                                                                        max_frames=CSM_FRAMES)))
    eager = eager[0]
    csm_codes_tied(f"CSM-1B bf16, {CSM_FRAMES} frames, graphs vs eager", model, ids, eager, toks)
    counts = kernels.launch_counts()

    launched = []
    for frames in (1, 2):
        before = kernels.launch_counts()
        model.generate_codes(ids, max_frames=frames)
        launched.append({k: n - before[k] for k, n in kernels.launch_counts().items()})
    per_frame = {k: n - launched[0][k] for k, n in launched[1].items() if n != launched[0][k]}
    log("tts", f"CSM-1B bf16: one frame's launches {json.dumps(per_frame)}")
    total = sorted(sync_ms(lambda: model.generate_codes(ids, max_frames=CSM_FRAMES))
                   for _ in range(3))[1]
    prefill = sorted(sync_ms(lambda: model.generate_codes(ids, max_frames=0)) for _ in range(3))[1]
    frame_ms, eager_ms = (total - prefill) / CSM_FRAMES, (total_eager - prefill) / CSM_FRAMES
    decode_ms = sorted(sync_ms(lambda: model.codec.chunked_decode(toks.T[None], 300, 25))
                       for _ in range(3))[1]
    log_busy("tts", "CSM-1B bf16", f"{CSM_FRAMES} frames", lambda: model.generate_codes(
        ids, max_frames=CSM_FRAMES))
    n = max(len(toks), 1)
    log("tts", f"CSM-1B bf16 ({len(ids)} text ids, {len(toks)} frames): prefill {prefill:.2f} ms, "
               f"a frame (31 depth recomputes and a backbone step) {frame_ms:.2f} ms as one graph "
               f"replay vs {eager_ms:.2f} ms eager; Mimi's decode of the frames {decode_ms:.2f} ms; "
               f"RTF {(total + decode_ms) / 1e3 / (n * FRAME_S):.4f}")

    log("time", f"tts: CSM-1B bf16 mapped, run against eager and timed in "
                f"{time.perf_counter() - t0:.1f} s")

    # voice clone once: a 2-s reference, encoded by Mimi on the card, spliced
    # at the audio tokens
    cfg = model.config
    wav = speech_wave(2.0, 53, 24000)
    n_audio = model.codec.encode(wav[None], num_quantizers=cfg.num_codebooks).shape[-1]
    clone_ids = ids[:8] + [cfg.audio_token_id] * n_audio + [cfg.audio_eos_token_id] + ids[8:12]
    clone = model.generate_codes(clone_ids, audio_context=wav, max_frames=4)
    log("tts", f"CSM-1B voice clone through audio_context ({n_audio} reference frames): "
               f"{len(clone)} frames")

    # a prompt that ends 4 positions short of the backbone's rope table: its
    # frames' positions run past it and read the table's last row, as
    # crane_tpu's gather does (an index past the table would assert on the
    # card and end the process)
    max_pos = cfg.backbone.max_position_embeddings
    long_ids = (ids * (max_pos // len(ids) + 1))[:max_pos - 4]
    far = model.generate_codes(long_ids, max_frames=8, stop_on_eos=False)
    if far.shape != (8, cfg.num_codebooks) or far.min() < 0 or far.max() >= cfg.audio_vocab_size:
        raise AssertionError(f"CSM past its rope table: codes {far.shape}, {far.min()}..{far.max()}")
    log("tts", f"CSM-1B, {len(long_ids)} prompt ids and 8 frames (positions up to "
               f"{len(long_ids) + 7} of a {max_pos}-row rope table): codes in range, the "
               f"process goes on")
    model.release_graphs()
    return counts


# ---------------------------------------------------------------------------
# Phases 23 (voxtral), 24 (kokoro) and 25 (ocr): the rest of speech and
# vision. No kernel lies on these paths: Voxtral's backbone has heads of 96,
# which no attention kernel takes (plain, counted in plain_routes, as
# crane_tpu sends them to XLA's gqa_attention); its acoustic transformer and
# codec, Kokoro's net and the OCR nets are plain PyTorch, as they are plain
# einsums and convs in crane_tpu.

VOX_F32_LAYERS = 2  # of the backbone's 26, for the float32 check (acoustic and codec whole)
VOX_F32_FRAMES = 4
VOX_TEXT = 30  # text ids of a request
VOX_VOICE_ROWS = 32  # rows of the random voice embedding (the released voices are not here)
VOX_FRAMES = 64  # frames of a run: 5.12 s of audio
VOX_BLOCK = 16  # frames a block (one graph replay)
VOX_END_FRAME = 21  # the END_AUDIO run stops at or before this frame (the second block)
VOX_FRAME_S = 0.08  # 12.5 Hz, 1920 samples at 24 kHz
# a semantic code whose float32 logit lies this close to the chosen one's, or
# an acoustic latent this close (in FSQ levels) to a rounding boundary, may
# go either way between the card and the CPU (the tie rule)
SEM_TIE = 1e-3
FSQ_TIE = 1e-3

KOKORO_IDS = 96  # bench.py's phoneme ids (bench_kokoro): ~a sentence
KOKORO_DURATION_BIAS = 2.0  # added to the duration head's bias: 1-3 frames a phoneme
KOKORO_TIE = 1e-4  # a duration value this close to a .5 boundary may round either way
# an in-memory Kokoro vocabulary: "$" (pad/BOS/EOS), punctuation, the
# normalizer's single-codepoint letters and the phonemizer's IPA
KOKORO_VOCAB = "$;:,.!?¡¿—…\"«»“” AIOQWYabcdefhijklmnopqrstuvwxyzæçðøħŋœɐɑɒɔɕɖəɚɛɜɞɟɡɣɤɥɨɪɬɭɮɯɰɱɲɳɴɸɹɻɽɾʀʁʃʈʉʊʋʌʎʒʔʕʤʧʰʲˈˌːʼ̃θχ"

OCR_CLASSES = 6623  # PaddleOCR's ppocr_keys_v1.txt symbols (plus the blank and the space)
OCR_PAGE = (720, 960)  # a synthetic page at the pipeline's 960-pixel limit
OCR_TIE = 1e-4  # a probability this close to the detector's 0.3 threshold may fall either way


def voxtral_frames(model, ids, noises, forced=None):
    """VoxtralTts's frame loop on ``model``'s device, eagerly, from the
    given noise (one ``[36]`` float32 tensor a frame): the prefill's last
    hidden and, per frame, (semantic logits, acoustic latent, codes). With
    ``forced`` (a list of code tensors) each decode step takes those codes
    instead of the frame's own, so every frame is computed from the same
    history as the run that gave them."""
    import torch

    from crane_tpu_torch.models import voxtral_tts as vt
    from crane_tpu_torch.models.modules.transformer import forward_hidden

    cfg, p, dev = model.cfg, model.params, model.device
    with torch.no_grad():
        h = first = model.prefill(ids, "smoke")
        cache = model._cache
        tokens = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        frames = []
        for i, noise in enumerate(noises):
            logits = vt.predict_semantic_logits(cfg, p["acoustic"], h[0])
            latent = vt.flow_latent(cfg, p["acoustic"], h[0], noise.to(dev, model.dtype),
                                    model._time_tokens)
            codes = torch.cat([logits.argmax().to(torch.int32)[None],
                               vt.fsq_quantize(latent, cfg.fsq_levels)])
            frames.append((logits, latent, codes))
            step = codes if forced is None else forced[i].to(dev)
            emb = vt.embed_frame_codes(p["codebook_table"], model.offsets, step)
            hidden, cache = forward_hidden(model.llm_cfg, p["llm"], tokens, cache, cache.lengths,
                                           model.rope, inputs_embeds=emb[None, None, :])
            h = hidden[:, -1]
    return first, frames


def voxtral_codes_tied(label, ref, other, levels: int) -> None:
    """Each frame's codes on the card equal the CPU's, or part at a tie: a
    semantic code whose CPU logit lies within SEM_TIE of the chosen one, an
    acoustic code one level off where the CPU's latent lies within FSQ_TIE
    (in levels) of the rounding boundary."""
    import torch

    ties = 0
    for f, ((logits, latent, codes), (_, _, got)) in enumerate(zip(ref, other)):
        got = got.cpu()
        for j in torch.nonzero(got != codes).flatten().tolist():
            if j == 0:
                gap = (logits[codes[0]] - logits[got[0]]).item()
                ok = gap <= SEM_TIE
                what = f"semantic code {int(codes[0])} vs {int(got[0])}, logit gap {gap:.3g}"
            else:
                half = (levels - 1) / 2.0
                u = float(latent[j - 1].clamp(-1, 1) * half + half)
                off = abs(u % 1.0 - 0.5)
                ok = abs(int(codes[j]) - int(got[j])) == 1 and off <= FSQ_TIE
                what = f"acoustic code {j}: {int(codes[j])} vs {int(got[j])}, {off:.3g} from a boundary"
            log("voxtral", f"{label}: frame {f} parts, {what}")
            if not ok:
                raise AssertionError(f"{label}: frame {f} parts without a tie")
            ties += 1
    log("voxtral", f"{label}: {len(ref)} frames x {len(ref[0][2])} codes equal but {ties} ties")


def tree_to(tree, device):
    """A parameter tree moved to ``device``, its ``None`` leaves kept (a
    Voxtral codec's last stage has no upsampling conv)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device) for v in tree)
    return None if tree is None else tree.to(device)


def random_codes(cfg, n: int, seed: int):
    """Codes ``[1, n, 37]`` of the codec's ranges (+2 offsets), seeded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sem = torch.randint(2, cfg.semantic_valid_end, (1, n, 1), generator=g)
    ac = torch.randint(2, 2 + cfg.fsq_levels, (1, n, cfg.n_acoustic), generator=g)
    return torch.cat([sem, ac], -1).to(torch.int32)


def check_voxtral_f32() -> None:
    """Voxtral's float32 checks, card against CPU, the backbone cut to
    VOX_F32_LAYERS of 26 (the acoustic transformer and the codec whole):
    the prefill's last hidden state, then VOX_F32_FRAMES frames from the
    same noise, teacher-forced with the CPU's codes (each frame's semantic
    logits and acoustic latent within F32_REL_L2, its codes equal or tied:
    ``voxtral_codes_tied``); the codec's audio of those frames with cuDNN's
    TF32 off; the codec chunked (16 new frames, 16 of context) against
    whole on 40 frames, and 1- and 2-frame decodes (the reflect pad as long
    as the input) against the CPU."""
    import dataclasses

    import torch

    from crane_tpu_torch.models import voxtral_tts as vt

    t0 = time.perf_counter()
    cfg = dataclasses.replace(vt.VoxtralConfig(), n_layers=VOX_F32_LAYERS)
    params = vt.init_voxtral_params(cfg, seed=61, dtype=torch.float32, device="cuda")
    g = torch.Generator().manual_seed(62)
    voice = torch.randn(VOX_VOICE_ROWS, cfg.dim, generator=g) * 0.02
    ids = torch.randint(0, cfg.vocab_size, (VOX_TEXT,), generator=g).tolist()
    models = [vt.VoxtralTts(cfg, tree_to(params, d), voices={"smoke": voice}) for d in ("cuda", "cpu")]
    del params
    noises = [torch.randn(cfg.n_acoustic, generator=g) for _ in range(VOX_F32_FRAMES)]
    log("time", f"voxtral: the float32 model ({VOX_F32_LAYERS} backbone layers) drawn and copied "
                f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    h_cpu, ref = voxtral_frames(models[1], ids, noises)
    log("time", f"voxtral: {VOX_F32_FRAMES} float32 frames on the CPU in "
                f"{time.perf_counter() - t0:.1f} s")
    h_gpu, got = voxtral_frames(models[0], ids, noises, forced=[c for _, _, c in ref])
    label = f"Voxtral float32 ({VOX_F32_LAYERS} of 26 backbone layers)"
    check_f32("voxtral", f"{label} prefill's last hidden, {VOX_VOICE_ROWS} voice rows + "
                         f"{len(ids)} text ids + 5 specials", h_gpu, h_cpu)
    for f in (0, VOX_F32_FRAMES - 1):
        finite = torch.isfinite(ref[f][0])
        check_f32("voxtral", f"{label} frame {f} semantic logits", got[f][0].cpu()[finite],
                  ref[f][0][finite])
        check_f32("voxtral", f"{label} frame {f} flow-matched latent (same noise)", got[f][1],
                  ref[f][1])
    voxtral_codes_tied(f"{label}, teacher-forced", ref, got, cfg.fsq_levels)
    codes = torch.stack([c for _, _, c in ref])[None]
    cpu_pcm = vt.codec_decode(cfg, models[1].params["codec"], codes)
    with cudnn_tf32(False):
        check_f32("voxtral", f"codec audio of {VOX_F32_FRAMES} frames, cuDNN TF32 off",
                  vt.codec_decode(cfg, models[0].params["codec"], codes.cuda()), cpu_pcm)
        for n in (1, 2):  # the input conv's reflect pad as long as the input
            short = random_codes(cfg, n, 63 + n)
            check_f32("voxtral", f"codec audio of a {n}-frame input (reflect pad >= its length)",
                      vt.codec_decode(cfg, models[0].params["codec"], short.cuda()),
                      vt.codec_decode(cfg, models[1].params["codec"], short))
        long = random_codes(cfg, 40, 66).cuda()
        check_f32("voxtral", "codec_chunked_decode (16 new + 16 context frames) vs codec_decode, "
                             "40 frames on the card",
                  vt.codec_chunked_decode(cfg, models[0].params["codec"], long, chunk_size=16,
                                          left_context=16),
                  vt.codec_decode(cfg, models[0].params["codec"], long))
    log("voxtral", f"the codec audio: rms {cpu_pcm.pow(2).mean().sqrt().item():.4g}, max "
                   f"{cpu_pcm.abs().max().item():.4g}")
    log("time", f"voxtral: float32 checks done in {time.perf_counter() - t0:.1f} s")


def check_voxtral() -> dict[str, int]:
    """Voxtral-4B TTS at full width (``VoxtralConfig()``: backbone 26 x
    3072 with 32 / 8 heads of 96, acoustic transformer 3 x 3072, codec 8
    layers of 1024), random bf16 weights drawn on the card, a random voice
    of VOX_VOICE_ROWS rows and VOX_TEXT text ids. After ``check_voxtral_f32``:
    the prefill's ms; ``generate_codes`` of VOX_FRAMES frames in blocks of
    VOX_BLOCK, each block one graph replay (counted), against the eager
    blocks on the card (codes equal); the RTF; a block's ms both ways; a
    run stopped by END_AUDIO inside a block (the semantic head's END column
    raised to just above the column of the code chosen at VOX_END_FRAME),
    graph against eager; the codec's ms; the device's idle share; the
    ``VoxtralTts`` SDK adapter with the stand-in tokenizer against
    ``generate``. The plain attention routes must be exactly the backbone's
    (26 "chunk" calls a prefill, 26 "decode" calls a frame run) and no
    kernel launched. Returns the launch counts."""
    import torch

    from crane_tpu_torch.generation.config import SpeechOptions
    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models import voxtral_tts as vt
    from crane_tpu_torch.models.modules.transformer import attention_block
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.sdk.audio import VoxtralTts

    check_voxtral_f32()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = vt.VoxtralConfig()
    params = vt.init_voxtral_params(cfg, seed=71, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params) if t is not None)
    g = torch.Generator().manual_seed(72)
    voice = torch.randn(VOX_VOICE_ROWS, cfg.dim, generator=g) * 0.02
    ids = torch.randint(0, cfg.vocab_size, (VOX_TEXT,), generator=g).tolist()
    model = vt.VoxtralTts(cfg, params, voices={"smoke": voice})
    torch.cuda.synchronize()
    log("voxtral", f"Voxtral-4B bf16: {n_params / 1e9:.3f} B parameters drawn on the card in "
                   f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    reset_counts()
    prefills, blocks = [], {"graph": 0, "eager": 0}
    counted_calls(model, "prefill", {}, prefills)

    def run(mode):
        """generate_codes of VOX_FRAMES frames, graph or eager: (codes, ms,
        blocks run). A block runs to its end, END_AUDIO or not."""
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            replays, out = graphs.replays, []
            ms = sync_ms(lambda: out.append(model.generate_codes(
                ids, voice="smoke", max_frames=VOX_FRAMES, block_frames=VOX_BLOCK)))
        n = min(len(out[0]) // VOX_BLOCK + 1, VOX_FRAMES // VOX_BLOCK)
        if mode == "graph" and graphs.replays - replays != n:
            raise AssertionError(f"Voxtral: {graphs.replays - replays} replays for {n} blocks")
        blocks[mode] += n
        return out[0], ms, n

    prefill_ms = sorted(sync_ms(lambda: model.prefill(ids, "smoke")) for _ in range(3))[1]
    captures = graphs.captures
    codes, capture_ms, _ = run("graph")
    capture_s = capture_ms / 1e3
    runs = [run("graph") for _ in range(3)]
    graph_codes, gen_ms, n_replays = sorted(runs, key=lambda r: r[1])[1]
    eager_codes, eager_ms, _ = run("eager")
    if graphs.captures - captures != 1 or n_replays != VOX_FRAMES // VOX_BLOCK:
        raise AssertionError(f"Voxtral: {graphs.captures - captures} captures, {n_replays} replays "
                             f"for {VOX_FRAMES} frames")
    for other in [codes] + [r[0] for r in runs]:
        if not torch.equal(torch.as_tensor(other), torch.as_tensor(eager_codes)):
            raise AssertionError("Voxtral bf16: the graph blocks' codes differ from the eager loop's")
    if len(eager_codes) != VOX_FRAMES:
        raise AssertionError(f"Voxtral: {len(eager_codes)} frames of {VOX_FRAMES}")
    block_ms = (gen_ms - prefill_ms) / (VOX_FRAMES // VOX_BLOCK)
    block_eager = (eager_ms - prefill_ms) / (VOX_FRAMES // VOX_BLOCK)
    rtf = gen_ms / 1e3 / (VOX_FRAMES * VOX_FRAME_S)
    log("voxtral", f"Voxtral-4B bf16: {VOX_FRAMES} frames, codes equal in {n_replays} graph "
                   f"replays and eagerly; the block's capture (first run) {capture_s:.1f} s")
    log("time", f"voxtral: the bf16 runs in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # END_AUDIO inside a block: its column raised to 1.01 x the column of the
    # code chosen at VOX_END_FRAME, which wins there (its logit the largest,
    # and positive) and wherever that code's logit lies within 1% of the top
    head = model.params["acoustic"]["semantic_head"]
    saved = head[:, vt.END_AUDIO_CODE].clone()
    head[:, vt.END_AUDIO_CODE] = head[:, int(eager_codes[VOX_END_FRAME, 0])] * 1.01
    ended = {mode: run(mode)[0] for mode in ("graph", "eager")}
    head[:, vt.END_AUDIO_CODE] = saved
    k = len(ended["eager"])
    if not torch.equal(torch.as_tensor(ended["graph"]), torch.as_tensor(ended["eager"])) \
            or not 1 <= k <= VOX_END_FRAME \
            or not torch.equal(torch.as_tensor(ended["eager"]), torch.as_tensor(eager_codes[:k])):
        raise AssertionError(f"Voxtral END_AUDIO run: {len(ended['graph'])} graph frames, {k} eager")
    log("voxtral", f"Voxtral-4B bf16, END_AUDIO raised: both ways stop after {k} frames (frame "
                   f"{k % VOX_BLOCK} of block {k // VOX_BLOCK}), their codes the plain run's")

    full = torch.as_tensor(eager_codes, device="cuda")[None]
    codec_ms = sorted(sync_ms(lambda: vt.codec_decode(cfg, model.params["codec"], full))
                      for _ in range(3))[1]
    pcm = vt.codec_decode(cfg, model.params["codec"], full).float()
    if pcm.shape != (1, VOX_FRAMES * 1920) or not bool(pcm.isfinite().all()):
        raise AssertionError(f"Voxtral codec: {tuple(pcm.shape)}")
    log_busy("voxtral", "Voxtral-4B bf16", f"a prefill and one {VOX_BLOCK}-frame block",
             lambda: model.generate_codes(ids, voice="smoke", max_frames=VOX_BLOCK,
                                          block_frames=VOX_BLOCK))
    blocks["graph"] += 3  # log_busy runs it three times, each one replay

    # the SDK adapter with the stand-in tokenizer: the same audio as generate
    model.tokenizer = StandInTokenizer(cfg.vocab_size)
    wav = VoxtralTts(model, max_frames=VOX_BLOCK).generate_speech(
        model.tokenizer.decode(ids), SpeechOptions(voice="smoke"))
    ref, sr = model.generate(ids, voice="smoke", max_frames=VOX_BLOCK, seed=0)
    blocks["graph"] += 2
    if sr != 24_000 or wav.shape != ref.shape or not bool((torch.as_tensor(wav)
                                                           == torch.as_tensor(ref)).all()):
        raise AssertionError("Voxtral SDK adapter: its audio differs from generate's")

    layers = cfg.n_layers
    want = {"prefill": 0, "chunk": layers * len(prefills),
            "decode": layers * VOX_BLOCK * (blocks["graph"] + blocks["eager"])}
    routes = dict(attention_block.plain_routes)
    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    log("routes", f"Voxtral path: plain routes {json.dumps(routes)}; the backbone's calls "
                  f"{json.dumps(want)} ({len(prefills)} prefills, {blocks['graph']} replayed and "
                  f"{blocks['eager']} eager blocks of {VOX_BLOCK} frames); launches "
                  f"{json.dumps(launched)}")
    if routes != want:
        raise AssertionError("the Voxtral path's plain routes are not exactly the backbone's")
    if launched:
        raise AssertionError(f"the Voxtral path launched kernels: {launched}")
    del model.prefill
    log("voxtral", f"Voxtral-4B bf16 ({VOX_VOICE_ROWS} voice rows + {len(ids)} text ids): prefill "
                   f"{prefill_ms:.2f} ms; a {VOX_BLOCK}-frame block {block_ms:.1f} ms as one graph "
                   f"replay vs {block_eager:.1f} ms eager ({block_ms / VOX_BLOCK:.2f} ms a frame); "
                   f"generate_codes of {VOX_FRAMES} frames {gen_ms:.1f} ms (median of 3), RTF "
                   f"{rtf:.4f} (synthesis seconds an audio second; eager "
                   f"{eager_ms / 1e3 / (VOX_FRAMES * VOX_FRAME_S):.4f}); the codec's decode of "
                   f"{VOX_FRAMES} frames {codec_ms:.2f} ms; audio rms "
                   f"{pcm.pow(2).mean().sqrt().item():.4g}; graphs: {graphs.replays} replays in "
                   f"the process, the block captured once in {capture_s:.1f} s")
    log("time", f"voxtral: END, codec, busy share and the SDK in {time.perf_counter() - t0:.1f} s")
    counts = kernels.launch_counts()
    model.release_graphs()
    return counts


def kokoro_inputs(cfg):
    """bench.py's Kokoro workload (bench_kokoro): from numpy's generator
    seeded 0, the style ``[256]``, then 96 phoneme ids in [1, vocab)."""
    import numpy as np

    rng = np.random.default_rng(0)
    style = rng.standard_normal(256)
    return rng.integers(1, cfg.vocab_size, KOKORO_IDS), style


def check_kokoro() -> None:
    """Kokoro's native net at ``KokoroNetConfig()`` (vocabulary 178, dim
    128, hop 600), random weights at crane_tpu's scales with the duration
    head's bias raised by KOKORO_DURATION_BIAS (1-3 frames a phoneme), on
    bench.py's workload shape (96 phoneme ids, a random style row). Float32
    card against CPU: the encoder's features, the durations equal (or tied
    within KOKORO_TIE of a .5 boundary), the waveform within F32_REL_L2 with
    cuDNN's TF32 off; the synthesis RTF on the card; ``KokoroTts``
    end to end through the copied ``text/g2p.Phonemizer`` with an in-memory
    vocabulary and a random voice pack, on a text of two 510-codepoint
    chunks, the card's waveform against the CPU's."""
    import torch

    from crane_tpu_torch.models import kokoro_tts as kt
    from crane_tpu_torch.text.g2p import Phonemizer

    t0 = time.perf_counter()
    cfg = kt.KokoroNetConfig()
    params = kt.init_kokoro_net(cfg, seed=81, device="cpu")
    params["duration"]["b2"] += KOKORO_DURATION_BIAS
    synths = [kt.KokoroSynthesizer(cfg, tree_to(params, d)) for d in ("cuda", "cpu")]
    ids, style = kokoro_inputs(cfg)
    with cudnn_tf32(False):
        (feats, durs, st), (rfeats, rdurs, rst) = (s.features(ids, style) for s in synths)
        check_f32("kokoro", f"Kokoro encoder features of {len(ids)} phoneme ids", feats, rfeats)
        values = kt.duration_values(synths[1].params["duration"], rfeats, rst, 1.0)
        diff = torch.nonzero(durs.cpu() != rdurs).flatten().tolist()
        for i in diff:
            off = abs(float(values[i]) % 1.0 - 0.5)
            log("kokoro", f"duration {i}: {int(durs[i])} vs {int(rdurs[i])}, {off:.3g} from .5")
            if off > KOKORO_TIE or abs(int(durs[i]) - int(rdurs[i])) != 1:
                raise AssertionError("Kokoro durations part without a tie")
        log("kokoro", f"Kokoro durations: {int(rdurs.sum())} frames for {len(ids)} phonemes, "
                      f"{len(diff)} ties, per-phoneme counts {torch.bincount(rdurs.long()).tolist()}")
        wav = synths[0].synthesize(feats, rdurs.numpy(), st)
        ref = synths[1].synthesize(rfeats, rdurs.numpy(), rst)
        check_f32("kokoro", f"Kokoro waveform ({len(ref)} samples), cuDNN TF32 off",
                  torch.as_tensor(wav), torch.as_tensor(ref))
    log("kokoro", f"the waveform: rms {torch.as_tensor(ref).pow(2).mean().sqrt().item():.4g}, "
                  f"|x| > 0.99 share {(torch.as_tensor(ref).abs() > 0.99).float().mean().item():.4g}")
    synth = synths[0]
    synth(ids, style)  # warm
    ms = sorted(sync_ms(lambda: synth(ids, style)) for _ in range(5))[2]
    audio_s = len(ref) / 24_000
    log("kokoro", f"Kokoro synthesis on the card (float32, {len(ids)} ids, {audio_s:.2f} s of "
                  f"audio): {ms:.2f} ms (median of 5), RTF {ms / 1e3 / audio_s:.4f}")
    log_busy("kokoro", "Kokoro float32", f"{len(ids)} ids to {audio_s:.2f} s of audio",
             lambda: synth(ids, style))

    # the pipeline end to end: text -> IPA -> normalized phonemes -> two chunks
    vocab = {c: i for i, c in enumerate(dict.fromkeys(KOKORO_VOCAB))}
    g = torch.Generator().manual_seed(82)
    voices = {"af_heart": torch.randn(510, kt.STYLE_DIM, generator=g).numpy()}
    text = ("The quick brown fox jumps over the lazy dog near the riverbank, while seventeen "
            "curious engineers measured forty two kilometers of cable. ") * 5
    tts = [kt.KokoroTts(vocab, voices, s, phonemizer=Phonemizer()) for s in synths]
    phonemes = kt.KokoroIpaNormalizer("en_us", vocab).normalize(Phonemizer().phonemize(text))
    chunks = kt.chunk_phonemes(phonemes)
    if len(chunks) != 2:
        raise AssertionError(f"Kokoro: {len(chunks)} chunks of {len(phonemes)} codepoints")
    with cudnn_tf32(False):
        t1 = time.perf_counter()
        got, sr = tts[0].generate_speech(text)
        card_s = time.perf_counter() - t1
        want, _ = tts[1].generate_speech(text)
    check_f32("kokoro", f"KokoroTts.generate_speech of {len(text)} characters ({len(phonemes)} "
                        f"phoneme codepoints in {len(chunks)} chunks, {len(got) / sr:.2f} s)",
              torch.as_tensor(got), torch.as_tensor(want))
    log("kokoro", f"KokoroTts end to end on the card: {card_s * 1e3:.1f} ms host clock, RTF "
                  f"{card_s / (len(got) / sr):.4f}")
    log("time", f"kokoro: done in {time.perf_counter() - t0:.1f} s")


def check_ocr() -> None:
    """The native OCR nets at their defaults (detector 24 channels;
    recognizer 64 channels, 2 layers, 4 heads) over a synthetic dictionary
    of OCR_CLASSES symbols and a synthetic page at the 960-pixel limit. The
    detector's head is rescaled on the CPU's map of this page (its logits
    standardized, times -3) so that random weights outline the page's text
    lines. Float32 card against CPU (cuDNN TF32 off): the probability map,
    the regions (equal, or parting only where a pixel lies within OCR_TIE of
    the 0.3 threshold), the CTC logits of the CPU's crops, and
    ``PaddleOcrPipeline.recognize``'s regions and texts. The detector's and
    the recognizer's ms on the card."""
    import torch

    from crane_tpu_torch.ocr import nets, pipeline

    t0 = time.perf_counter()
    det = nets.init_detector_params(24, seed=91, device="cpu")
    rec = nets.init_recognizer_params(OCR_CLASSES + 2, seed=92, device="cpu")
    dictionary = [""] + [chr(0x4E00 + i) for i in range(OCR_CLASSES)] + [" "]
    img = synthetic_page(93, OCR_PAGE)
    x, size = pipeline.detect_preprocess(img)
    xt = torch.from_numpy(x)
    z = torch.logit(nets.db_detector(det, xt).double())
    s = -3.0 / z.std().item()
    det["head2"] = {"w": det["head2"]["w"] * s, "b": (det["head2"]["b"] - z.mean().item()) * s}
    dets = [tree_to(det, d) for d in ("cuda", "cpu")]
    recs = [tree_to(rec, d) for d in ("cuda", "cpu")]
    with cudnn_tf32(False):
        probs = [nets.db_detector(d, xt.to(d["stem"]["w"].device)).cpu()[0, 0] for d in dets]
        check_f32("ocr", f"DB detector probability map of a {OCR_PAGE[1]}x{OCR_PAGE[0]} page "
                         f"({tuple(x.shape)})", probs[0], probs[1])
        boxes = [pipeline.db_regions(p.numpy(), size, (img.shape[1], img.shape[0])) for p in probs]
        coords = [[b[:4] for b in bx] for bx in boxes]
        if coords[0] != coords[1]:
            # a tie: a pixel on the other side of the 0.3 threshold, or a
            # component's mean score at the 0.6 box threshold, within OCR_TIE
            flips = (probs[0] > 0.3) != (probs[1] > 0.3)
            near = (probs[1][flips] - 0.3).abs().min().item() if bool(flips.any()) else 1.0
            at_box = min(abs(b[4] - 0.6) for bx in boxes for b in bx)
            log("ocr", f"regions part: {int(flips.sum())} pixels on the other side of 0.3, the "
                       f"nearest {near:.3g} from it; a box score {at_box:.3g} from 0.6")
            if min(near, at_box) > OCR_TIE:
                raise AssertionError("the OCR regions part without a tie")
        else:
            worst = max(abs(a[4] - b[4]) for a, b in zip(*boxes))
            log("ocr", f"DB regions: {len(boxes[1])} boxes, equal on the card and the CPU "
                       f"(scores within {worst:.3g})")
        batch, _ = pipeline.prepare_crops(img, boxes[1])
        logits = [nets.ctc_recognizer(r, torch.from_numpy(batch).to(r["c1"]["w"].device)).cpu()
                  for r in recs]
        check_f32("ocr", f"CTC recognizer logits of {batch.shape[0]} crops ({tuple(batch.shape)}, "
                         f"{OCR_CLASSES + 2} classes)", logits[0], logits[1])
        pipes = [pipeline.PaddleOcrPipeline(nets.NetCallable(nets.db_detector, d),
                                            nets.NetCallable(nets.ctc_recognizer, r),
                                            dictionary, rec_batch_size=8)
                 for d, r in zip(dets, recs)]
        docs = [p.recognize(img) for p in pipes]
    regions = [[(r.left, r.top, r.right, r.bottom, r.text) for r in d.regions] for d in docs]
    if coords[0] == coords[1] and regions[0] != regions[1]:
        raise AssertionError("PaddleOcrPipeline.recognize: the card's regions or texts differ")
    if not regions[1]:
        raise AssertionError("the OCR page gave no region")
    log("ocr", f"PaddleOcrPipeline.recognize: {len(regions[1])} regions, "
               f"{sum(len(r[4]) for r in regions[1])} characters, identical on the card and the "
               f"CPU (the first boxes {coords[1][:3]})")
    xd = xt.cuda()
    bd = torch.from_numpy(batch).cuda()
    det_ms = sorted(sync_ms(lambda: nets.db_detector(dets[0], xd)) for _ in range(5))[2]
    rec_ms = sorted(sync_ms(lambda: nets.ctc_recognizer(recs[0], bd)) for _ in range(5))[2]
    page_ms = sorted(sync_ms(lambda: pipes[0].recognize(img)) for _ in range(3))[1]
    log("ocr", f"OCR on the card (float32): the detector {det_ms:.2f} ms at {tuple(x.shape)}, the "
               f"recognizer {rec_ms:.2f} ms for {batch.shape[0]} crops {tuple(batch.shape)}; "
               f"recognize of the page {page_ms:.1f} ms host clock (preprocessing, DB regions and "
               f"crops on the host)")
    log_busy("ocr", "OCR detector", f"one page {tuple(x.shape)}",
             lambda: nets.db_detector(dets[0], xd))
    log("time", f"ocr: done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 'spec', the K/V check: speculative against plain decoding, slot by slot

# the largest per-slot relative distance between the K/V that speculative
# and plain decoding write for the same tokens (ops/kv_cache.py
# slot_errors): the two compute a slot's K/V in other products (a verify
# chunk of k + 1 rows, one row a step), which may round apart in bf16, and
# an int4 code may land one step over; a K/V written one slot off reads near
# 1 or more (the control)
SPEC_KV_BOUND = {"bf16": 0.05, "w4 kv4": 0.2}


def shifted_layers(layers) -> list:
    """The control's fault: every slot's K/V (codes and scales) moved one
    slot on, as a verify that wrote its rows one position late would
    leave them."""
    import dataclasses

    import torch

    return [dataclasses.replace(layer, **{
        f.name: torch.roll(getattr(layer, f.name), 1, dims=2 if f.name.endswith("scale") else 1)
        for f in dataclasses.fields(layer) if isinstance(getattr(layer, f.name), torch.Tensor)})
        for layer in layers]


def check_spec_kv(lm, lm4) -> None:
    """The same greedy tokens decoded plainly and speculatively (generate,
    spec_k 8, on four repetitive prompts of 180-228 tokens) in bf16 and in
    w4 kv4: the K/V rows each path left in generate's kept cache agree slot
    by slot within SPEC_KV_BOUND, over every slot both wrote for the same
    tokens (up to a first difference of the tokens, which the tie rule of
    spec_generate judges). The control, the speculative rows shifted one
    slot, must exceed the bound."""
    import torch

    from crane_tpu_torch.models.causal_lm import GenerationConfig
    from crane_tpu_torch.ops.kv_cache import slot_errors
    from crane_tpu_torch.utils.buckets import bucket_length

    n = 128
    for label, model, kv_bits in (("bf16", lm, None), ("w4 kv4", lm4, 4)):
        errs, ctrls, decoded = [], [], 0
        for prompt in repetitive_prompts(model.config.vocab_size, 31, 4, base=180).values():
            key = (bucket_length(len(prompt) + n, floor=256), kv_bits)
            plain = model.generate(prompt, GenerationConfig.greedy(n, kv_quant_bits=kv_bits))
            cache = model._generate_caches[key][0]
            plain_layers = clone_layers(cache.layers)
            spec = model.generate(prompt, GenerationConfig.greedy(n, speculative="ngram",
                                                                  kv_quant_bits=kv_bits))
            if model._generate_caches[key][0] is not cache:
                raise AssertionError("plain and speculative generate used different caches")
            j = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b), n - 1)
            live = len(prompt) + min(j, n - 1)  # the slots of the same tokens
            decoded += live - len(prompt)
            errs.append(slot_errors(cache.layers, plain_layers, 0, live))
            ctrls.append(slot_errors(shifted_layers(cache.layers), plain_layers, 0, live))
        errs, ctrls = torch.cat(errs), torch.cat(ctrls)
        bound_ = SPEC_KV_BOUND[label]
        log("spec", f"Qwen3-0.6B {label}: K/V of {errs.numel()} slots of 4 prompts ({decoded} "
                    f"of them decoded), speculative vs plain: largest per-slot rel L2 "
                    f"{errs.max().item():.4g} (mean {errs.mean().item():.4g}, bound {bound_}); "
                    f"the control shifted one slot: largest {ctrls.max().item():.4g}, median "
                    f"{ctrls.median().item():.4g}")
        if errs.max().item() >= bound_:
            raise AssertionError(f"spec K/V {label}: a slot parts from plain decoding's")
        if ctrls.max().item() <= bound_:
            raise AssertionError(f"spec K/V {label}: the shifted control passed the check")
        model.release_graphs()


# ---------------------------------------------------------------------------
# Phase 'tp': tensor and data parallelism on the one card

# kernel-row tags of the tp path's per-shard shapes
TP_06 = "[tp2 D128-8/4]"  # Qwen3-0.6B's 16 / 8 heads at tp=2
TP_35 = "[tp2 D256-4/1]"  # Qwen3.5-0.8B's 8 / 2 at tp=2
TP_NEXT = "[tp2 D256-8/1]"  # Qwen3-Next-80B-A3B's 16 / 2 at tp=2
TP_H8 = "[tp2 H8]"  # Qwen3.5-0.8B's 16 GDN value heads at tp=2
TP_VALID = [1, 300, 1500, 2048]  # a dp group's 4 decode rows of 8 slots
TP_VERSUS = "float32 tp=2 vs unsharded on the card"
# Qwen3-Next's depth in the tp check: one [gdn, gdn, gdn, full] block, so the
# unsharded model and its shards (12.9 GB of bf16 weights each) share the card
TP_MOE_LAYERS = 4
# the train step against the unsharded step, float32 both: sums in other
# orders (tests/test_parallel.py's loss bar)
TRAIN_LOSS_RTOL = 1e-5
# what the train check may leave allocated once it returns (autograd's
# cuBLAS workspaces); a reference cycle through its frames held 17 GB
TRAIN_HELD_GB = 1.0


def tp_attention_rows(rnd, tag, Hq, Hkv, D, kinds) -> list[dict]:
    """K2 (S=1024), K3 (a 256-token chunk at offsets 0 and 1000 of a
    2048-slot row) and K1 (a dp group's 4 rows over T=2048, ragged) in bf16
    at one shard's heads, the ``kinds`` of them, each against its plain
    version and timed beside it and SDPA."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    scale, heads = D ** -0.5, f"Hq={Hq} Hkv={Hkv} D={D}"
    rows = []
    if "prefill" in kinds:
        q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
        errs = [compare(f"K2 {heads}", k23.flash_attention_causal(q, k, v, scale=scale),
                        k23.flash_attention_causal_plain(q, k, v, scale=scale))]
        rows.append(timed_row(
            "flash_attention_causal" + tag, "flash_attention_mma.cu",
            "crane_tpu/ops/pallas/flash_attention.py:187", errs,
            lambda: k23.flash_attention_causal(q, k, v, scale=scale),
            lambda: k23.flash_attention_causal_plain(q, k, v, scale=scale),
            f"B=1 S=1024 {heads}", attn_work(1, 1024, Hq, Hkv, D, 1024 * 1025 // 2, 1024, 2 * D, 0),
            lambda: sdpa(q, k, v, causal=True)))
    if "chunk" in kinds:
        kc, vc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D)
        errs = []
        for off in (0, 1000):
            qc = rnd(1, 256, Hq, D)
            pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None].contiguous()
            errs.append(compare(f"K3 {heads} offset={off}",
                                k23.flash_attention_cached(qc, kc, vc, pos, scale=scale),
                                k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale)))
        rows.append(timed_row(
            "flash_attention_cached" + tag, "flash_attention_mma.cu",
            "crane_tpu/ops/pallas/flash_attention.py:384", errs,
            lambda: k23.flash_attention_cached(qc, kc, vc, pos, scale=scale),
            lambda: k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale),
            f"B=1 S=256 at offset 1000, T=2048, {heads}", chunk_work(qc, Hkv, 2048, pos),
            lambda: sdpa(qc, kc, vc, mask=chunk_mask(pos, 2048))))
    if "decode" in kinds:
        valid = torch.tensor(TP_VALID, dtype=torch.int32, device="cuda")
        qd, kd, vd = rnd(4, 1, Hq, D), rnd(4, 2048, Hkv, D), rnd(4, 2048, Hkv, D)
        errs = [compare(f"K1 {heads}", k1.fp_decode_attention(qd, kd, vd, valid, scale=scale),
                        k1.fp_decode_attention_plain(qd, kd, vd, valid, scale=scale))]
        rows.append(timed_row(
            "fp_decode_attention" + tag, "decode_attention.cu",
            "crane_tpu/ops/pallas/quant_attention.py:266", errs,
            lambda: k1.fp_decode_attention(qd, kd, vd, valid, scale=scale),
            lambda: k1.fp_decode_attention_plain(qd, kd, vd, valid, scale=scale),
            f"B=4 T=2048 ragged kv_valid, {heads}", decode_work(qd, Hkv, valid),
            lambda: sdpa(qd, kd, vd, mask=decode_mask(valid, 2048))))
    return rows


def check_tp_kernels() -> dict[str, list[dict]]:
    """Phase 3 at the tp path's per-shard shapes, which no earlier path
    gave the kernels: Qwen3-0.6B's heads at tp=2 (8 / 4 of 128: K1 over a
    dp group's 4 rows, K2, K3; K4 and K5 kv8), Qwen3.5-0.8B's (4 / 1 of
    256: K1, K2; K7 at 8 value heads over the 512-token prefill bucket) and
    Qwen3-Next's (8 / 1 of 256: K1, K2). Each against its plain version,
    timed beside it (and SDPA for K1-K3). Returns the rows by the path
    whose launches they read, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.cuda.gdn_scan import gdn_route, gdn_scan, gdn_scan_plain
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache

    gen = torch.Generator(device="cuda").manual_seed(1216)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    every = ("prefill", "chunk", "decode")
    rows = {"dense": tp_attention_rows(rnd, TP_06, 8, 4, 128, every),
            "hybrid": tp_attention_rows(rnd, TP_35, 4, 1, 256, ("prefill", "decode")),
            "moe": tp_attention_rows(rnd, TP_NEXT, 8, 1, 256, ("prefill", "decode"))}

    Hq, Hkv, D, bits = 8, 4, 128, 8
    cache = QuantLayerKVCache.empty(4, 2048, Hkv, D, bits=bits, device="cuda")
    kf, vf = rnd(4, 2048, Hkv, D), rnd(4, 2048, Hkv, D)
    cache.update(kf, vf, 0)
    ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    row = cache.row(1)
    row_ops = (row.k, row.v, row.k_scale, row.v_scale)
    valid = torch.tensor(TP_VALID, dtype=torch.int32, device="cuda")
    qd, qc = rnd(4, 1, Hq, D), rnd(1, 256, Hq, D)
    pos = (torch.arange(256, dtype=torch.int32, device="cuda") + 1000)[None]
    kw = dict(bits=bits, scale=D ** -0.5)
    errs = [compare("K4 kv8 tp2", k45.quant_decode_attention(qd, *ops, valid, **kw),
                    k45.quant_decode_attention_plain(qd.float(), *ops, valid, **kw))]
    rows["dense"].append(timed_row(
        "quant_decode_attention[kv8]" + TP_06, K4_SOURCE[bits],
        "crane_tpu/ops/pallas/quant_attention.py:367", errs,
        lambda: k45.quant_decode_attention(qd, *ops, valid, **kw),
        lambda: k45.quant_decode_attention_plain(qd, *ops, valid, **kw),
        f"B=4 T=2048 ragged kv_valid, Hq={Hq} Hkv={Hkv} D={D}",
        decode_work(qd, Hkv, valid, bits)))
    errs = [compare("K5 kv8 tp2", k45.quant_cached_attention(qc, *row_ops, pos, **kw),
                    k45.quant_cached_attention_plain(qc.float(), *row_ops, pos, **kw))]
    rows["dense"].append(timed_row(
        "quant_cached_attention[kv8]" + TP_06, "quant_cached_attention_mma.cu",
        "crane_tpu/ops/pallas/quant_attention.py:647", errs,
        lambda: k45.quant_cached_attention(qc, *row_ops, pos, **kw),
        lambda: k45.quant_cached_attention_plain(qc, *row_ops, pos, **kw),
        f"B=1 S=256 at offset 1000, T=2048, Hq={Hq} Hkv={Hkv} D={D}",
        chunk_work(qc, Hkv, 2048, pos, bits)))

    B, S, H, K, V = 1, 512, 8, 128, 128
    q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").to(torch.bfloat16)
               for d in (K, K, V))
    g = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.5
    beta = torch.rand(B, S, H, generator=gen, device="cuda")
    y, st = gdn_scan(q, k, v, g, beta)
    yr, sr = gdn_scan_plain(q, k, v, g, beta)
    err = compare(f"K7 tp2 B={B} S={S} H={H} y", y, yr)
    compare(f"K7 tp2 B={B} S={S} H={H} state", st, sr, rtol=STATE_RTOL, atol=STATE_ATOL)
    route = gdn_route(S)
    p1, k1_ms, k2_ms, p2 = (cuda_ms(f, n, warmup=1) for f, n in (
        (lambda: gdn_scan_plain(q, k, v, g, beta), 2), (lambda: gdn_scan(q, k, v, g, beta), 20),
        (lambda: gdn_scan(q, k, v, g, beta), 20), (lambda: gdn_scan_plain(q, k, v, g, beta), 2)))
    ms, plain_ms = (k1_ms + k2_ms) / 2, (p1 + p2) / 2
    bound_ms, bound_by = bound(*gdn_work(B, S, H, K, V), peak="tf32")
    shape = f"B={B} S={S} H={H} K=V={K}"
    log("kernels", f"K7 {shape} (tp=2): the {route} route {ms:.4f} ms vs plain {plain_ms:.4f} "
                   f"ms, bound {bound_ms:.4f} ms ({bound_by}); max|err| of y {err:.3g}")
    rows["hybrid"].append({"name": f"gdn_scan[{route}]" + TP_H8, "route": "cuda",
                           "source": "crane_tpu_torch/csrc/gdn_chunk.cu",
                           "replaces": "crane_tpu/ops/pallas/gdn_scan.py:126", "launches": 0,
                           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                           "shape": shape})
    return rows


def counted(run):
    """(what ``run`` returns, the launches it made, its plain routes), the
    counts zeroed just before it."""
    from crane_tpu_torch.models import graphs

    reset_counts()
    out = run()
    launches, routes = graphs.counts()
    launches.pop(graphs.SEGMENTS)
    return out, launches, routes


def require_scaled(label: str, got: dict, ref: dict, factor) -> None:
    """Every kernel's launches on the sharded run equal ``factor`` (a
    number, or a dict by kernel name) times the unsharded run's: one launch
    a shard where the unsharded model made one."""
    made = {k: (ref[k], n) for k, n in got.items() if n or ref[k]}
    log("launches", f"{label}: unsharded vs sharded {json.dumps(made)}")
    for name, (r, n) in made.items():
        f = factor.get(name, 0) if isinstance(factor, dict) else factor
        if n != f * r or r <= 0:
            raise AssertionError(f"{label}: {name} launched {n} times, want {f} x {r}")


def generate_step_logits(model, prompt, ref, i, kv_bits=None):
    """The logits that chose ``ref[i]`` in ``model.generate(prompt,
    greedy(len(ref), kv_quant_bits=kv_bits))``, recomputed on that path's
    own state: its prefill into a cache of generate's size and kind, then
    decode steps fed ``ref[:i]``."""
    import torch

    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
    from crane_tpu_torch.utils.buckets import bucket_length

    max_seq = bucket_length(len(prompt) + len(ref), floor=256)
    padded = prompt + [0] * (bucket_length(len(prompt), floor=64, ceiling=max_seq) - len(prompt))
    with torch.no_grad():
        logits, cache = model.prefill(model.init_cache(1, max_seq, quant_bits=kv_bits), [padded],
                                      [len(prompt)])
        logits = logits[0]
        for t in ref[:i]:
            tok = torch.tensor([[t]], dtype=torch.int32, device=model.device)
            hidden, cache = forward_hidden(model.config, model.params, tok, cache, cache.lengths,
                                           model.rope)
            logits = lm_logits(model.config, model.params, hidden)[0, 0]
    return logits


def greedy_tied(label, ref_model, prompt, ref, got) -> None:
    """The sharded greedy tokens ``got`` against the unsharded ``ref``: equal,
    or parting at a tie on the unsharded generate's own state."""
    tie_at_first_difference("tp", label, ref, got,
                            lambda i: generate_step_logits(ref_model, prompt, ref, i))


def tp_generate(label, lm, slm, prompt, n, factor=2) -> dict:
    """greedy generate of ``n`` tokens on the unsharded and the sharded
    model: the tokens tied, every kernel launched ``factor`` times as
    often. Returns the sharded run's launches."""
    from crane_tpu_torch.models.causal_lm import GenerationConfig

    ref, ref_counts, _ = counted(lambda: lm.generate(prompt, GenerationConfig.greedy(n)))
    got, got_counts, routes = counted(lambda: slm.generate(prompt, GenerationConfig.greedy(n)))
    greedy_tied(label, lm, prompt, ref, got)
    require_scaled(label, got_counts, ref_counts, factor)
    if any(routes.values()):
        raise AssertionError(f"{label} routed attention to a plain version: {routes}")
    return got_counts


def engine_tie(label, lm, ctx, got, ref, rows, first_logits):
    """An engine request's greedy tokens ``got`` against the unsharded
    engine's ``ref``: None where they agree, else (step, gap) of a tie on
    the unsharded engine's own state. A first token comes from the
    admission's prefill, so its own logits (``first_logits``, recorded by
    direct_engine_run) judge it; a later one, the replayed decode step over
    the request's cache row ``rows`` (ties_on_reference_state)."""
    if got[:1] != ref[:1]:
        gap = (first_logits[ref[0]] - first_logits[got[0]]).item()
        if int(first_logits.argmax()) != ref[0] or gap >= LOGIT_TIE:
            raise AssertionError(f"{label}: first token {got[0]} vs {ref[0]}, admission logit "
                                 f"gap {gap:.4g} is no tie")
        return 0, round(gap, 4)
    tie = ties_on_reference_state(lm, label, rows, 1, {0: (ctx, got, ref)}, LOGIT_TIE)
    return tie.get(0)


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def check_tp(lm, lm35, rows: dict) -> None:
    """Phase 'tp': tensor and data parallelism on the one card, over meshes
    of ``["cuda:0"] * n`` (``make_mesh``), each run against the unsharded
    port on the same card, under the tie rule in bf16 and F32_REL_L2 in
    float32, and each kernel launched once a shard where the unsharded run
    launched it once:

    - Qwen3-0.6B bf16 at tp=2: a 300-token prefill and 64 greedy tokens;
      its float32 prefill's logits; the engine at dp=2 x tp=2 over the mix
      of check_engine_prompts on an fp and an int8 cache (decode blocks as
      graphs); one /generate request over HTTP to a tp=2 engine;
    - Qwen3.5-0.8B bf16 at tp=2: prefill and 32 greedy tokens (K7 and K2
      per shard);
    - Qwen3-Next-80B-A3B at tp=2 and TP_MOE_LAYERS layers, expert
      parallel (256 experts a shard), K8 on each shard's experts
      (``expert_offset``, float32 partials): 16 greedy tokens in
      bf16 and in float32, and the float32 prefill's logits;
    - the train step: Qwen3-0.6B in float32 at full width, dp=2 x tp=2, B=4,
      S=512, three AdamW steps with remat against the unsharded model's
      steps (the losses of each step to TRAIN_LOSS_RTOL, the first step's
      gradients per weight to F32_REL_L2, and with and without remat alike),
      attention on the plain route by argument; a kernel wrapper given
      inputs that require grad raises; the check leaves under
      TRAIN_HELD_GB allocated once it returns, with no garbage collection.

    ``rows`` (check_tp_kernels') get the launches of the tp paths."""
    import torch

    from crane_tpu_torch.models import graphs
    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import init_params
    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.parallel.inference import shard_lm
    from crane_tpu_torch.parallel.sharding import make_mesh

    def mesh(dp, tp):
        return make_mesh(dp, tp, ["cuda:0"] * (dp * tp))

    totals: dict[str, dict] = {"dense": {}, "hybrid": {}, "moe": {}}
    cfg = lm.config
    gen = torch.Generator().manual_seed(16)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen).tolist()

    # Qwen3-0.6B at tp=2: generate, the float32 prefill, the decode step's time
    t0 = time.perf_counter()
    slm = shard_lm(lm, mesh(1, 2))
    add_counts(totals["dense"], tp_generate("Qwen3-0.6B bf16 tp=2 generate(64)", lm, slm,
                                            prompt, 64))
    times = {name: time_generate(m, prompt, GenerationConfig.greedy(16))
             for name, m in (("unsharded", lm), ("tp=2", slm))}
    log("tp", "Qwen3-0.6B bf16 batch 1, one graph block of 15 decode steps (host clock): "
              + ", ".join(f"{name} {1e3 / tps:.3f} ms a step (prefill 300 tokens {ms:.2f} ms)"
                          for name, (ms, tps) in times.items()))
    lm32 = CausalLM(cfg, _tree(lm.params, lambda t: t.float()), dtype=torch.float32)
    check_f32("tp", "Qwen3-0.6B float32 300-token prefill logits",
              prefill_300(shard_lm(lm32, mesh(1, 2)), prompt), prefill_300(lm32, prompt),
              versus=TP_VERSUS)
    del lm32
    slm.release_graphs()
    lm.release_graphs()
    log("time", f"tp: Qwen3-0.6B generate and float32 prefill {time.perf_counter() - t0:.1f} s")

    # the engine at dp=2 x tp=2 on an fp and an int8 cache
    t0 = time.perf_counter()
    prompts, tail = check_engine_prompts(cfg.vocab_size)
    slm22 = shard_lm(lm, mesh(2, 2))
    direct = None
    for kv_bits, decode, others in ((None, "fp_decode_attention", (
            "flash_attention_causal", "flash_attention_cached")), (8, "quant_decode_attention[kv8]", (
            "flash_attention_causal", "quant_cached_attention[kv8]"))):
        label = f"Qwen3-0.6B dp=2 x tp=2 engine, {'int8' if kv_bits else 'fp'} cache"
        firsts = {}
        (ref, rows_ref), ref_counts, _ = counted(
            lambda: direct_engine_run(lm, kv_bits, prompts, tail, firsts))
        replays = graphs.replays
        (got, _), got_counts, routes = counted(
            lambda: direct_engine_run(slm22, kv_bits, prompts, tail))
        if graphs.replays == replays:
            raise AssertionError(f"{label}: no decode block ran as a graph")
        # a decode step runs every slot on both groups' shards, a slot's
        # prefill or chunk on its group's shards only
        require_scaled(label, got_counts, ref_counts, {decode: 4, **dict.fromkeys(others, 2)})
        if any(routes.values()):
            raise AssertionError(f"{label} routed attention to a plain version: {routes}")
        ties = {}
        for rid, (ids, _) in list(prompts.items()) + [("followup", (None, 16))]:
            if rid == "followup":
                if got["p300"] != ref["p300"]:
                    continue  # the follow-up prompts differ (p300 parted at a tie)
                ids = prompts["p300"][0] + ref["p300"] + tail
            tie = engine_tie(f"{label} {rid}", lm, ids, got[rid], ref[rid], rows_ref[rid],
                             firsts[rid])
            if tie:
                ties[rid] = tie
        log("tp", f"{label}: {len(got)} greedy requests (17, 64, 300, 1000 tokens and the "
                  f"follow-up) vs the unsharded engine: "
                  f"{'identical' if not ties else f'first differences at ties {ties}'}; "
                  f"{graphs.replays - replays} graph replays")
        add_counts(totals["dense"], got_counts)
        if kv_bits is None:
            direct = (ref, rows_ref, firsts)
    del slm22
    log("time", f"tp: the dp=2 x tp=2 engines {time.perf_counter() - t0:.1f} s")

    # one request over HTTP to a tp=2 engine, against the unsharded engine's
    t0 = time.perf_counter()
    slm.tokenizer = StandInTokenizer(cfg.vocab_size)
    engine, srv = serve_http(slm)
    try:
        reset_counts()
        ids, n = prompts["p300"]
        status, body = http_json(srv.port, "POST", "/generate", {
            "input_ids": ids, "rid": "tp-http",
            "sampling_params": {"max_new_tokens": n, **GREEDY_HTTP}})
        got = StandInTokenizer.ids(body.get("text", "")) if status == 200 else None
        if got is None or len(got) != n:
            raise AssertionError(f"tp /generate: status {status}, {str(body)[:300]}")
        add_counts(totals["dense"], kernels.launch_counts())
        tie = engine_tie("tp=2 /generate p300", lm, ids, got, direct[0]["p300"],
                         direct[1]["p300"], direct[2]["p300"])
        log("tp", f"/generate to a tp=2 engine, 300-token prompt, {n} tokens vs the unsharded "
                  f"engine: {'identical' if not tie else f'first difference at a tie {tie}'}")
    finally:
        srv.close()
        engine.stop()
        slm.release_graphs()
        slm.tokenizer = None
    del slm
    log("time", f"tp: HTTP {time.perf_counter() - t0:.1f} s")

    # Qwen3.5-0.8B at tp=2
    t0 = time.perf_counter()
    prompt35 = torch.randint(0, lm35.config.vocab_size, (300,), generator=gen).tolist()
    slm35 = shard_lm(lm35, mesh(1, 2))
    add_counts(totals["hybrid"], tp_generate("Qwen3.5-0.8B bf16 tp=2 generate(32)", lm35, slm35,
                                             prompt35, 32))
    slm35.release_graphs()
    lm35.release_graphs()
    del slm35
    log("time", f"tp: Qwen3.5-0.8B {time.perf_counter() - t0:.1f} s")

    # Qwen3-Next-80B-A3B at TP_MOE_LAYERS layers, tp=2, expert parallel:
    # bf16 and float32 tokens under the tie rule, float32 logits too
    t0 = time.perf_counter()
    cfg_n = moe_config(TP_MOE_LAYERS)
    gen_n = torch.Generator(device="cuda").manual_seed(81)
    params_n = init_params(cfg_n, gen_n, device="cuda", dtype=torch.bfloat16)
    prompt_n = torch.randint(0, cfg_n.vocab_size, (300,), generator=gen).tolist()
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "float32"
        lmn = CausalLM(cfg_n, params_n if dtype == torch.bfloat16 else _tree(
            params_n, lambda t: t.float()), dtype=dtype)
        if dtype == torch.float32:
            del params_n
        slmn = shard_lm(lmn, mesh(1, 2))
        experts = slmn.params.trees[0][1]["layers"][0]["mlp"]["experts_gate"].shape[0]
        log("tp", f"Qwen3-Next-80B-A3B at {TP_MOE_LAYERS} of 48 layers, full width, {name}, "
                  f"tp=2: {experts} experts a shard; {torch.cuda.memory_allocated() / 1e9:.1f} GB "
                  f"allocated on the card with the unsharded model beside it")
        label = f"Qwen3-Next {TP_MOE_LAYERS} layers {name} tp=2"
        if dtype == torch.float32:
            check_f32("tp", f"{label} 300-token prefill logits", prefill_300(slmn, prompt_n),
                      prefill_300(lmn, prompt_n), versus=TP_VERSUS)
        add_counts(totals["moe"], tp_generate(f"{label} generate(16)", lmn, slmn, prompt_n, 16))
        lmn.release_graphs()
        slmn.release_graphs()
        del lmn, slmn
        torch.cuda.empty_cache()
    log("time", f"tp: Qwen3-Next {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    check_tp_train(lm, mesh(2, 2))
    held = (torch.cuda.memory_allocated() - before) / 1e9
    log("tp", f"memory allocated on the card across the train check, with no garbage "
              f"collection: {held:+.3f} GB (limit +{TRAIN_HELD_GB} GB)")
    if held > TRAIN_HELD_GB:
        raise AssertionError("the train step's tensors outlive it (a reference cycle)")
    torch.cuda.empty_cache()
    log("time", f"tp: the train step {time.perf_counter() - t0:.1f} s")

    for path, label in (("dense", "tp path, Qwen3-0.6B"), ("hybrid", "tp path, Qwen3.5-0.8B"),
                        ("moe", "tp path, Qwen3-Next")):
        read_launches(label, rows[path], totals[path])
    log("tp", f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the card after the "
              f"phase")


def check_tp_train(lm, mesh) -> None:
    """check_tp's train step (see there)."""
    import torch

    from crane_tpu_torch.models.modules.transformer import attention_block, make_rope_tables
    from crane_tpu_torch.ops.cuda.flash_attention import flash_attention_causal
    from crane_tpu_torch.parallel import train
    from crane_tpu_torch.parallel.sharding import gather_params, leaves, shard_params

    cfg = lm.config
    gen = torch.Generator().manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen, dtype=torch.int32)
    tokens = tokens.to("cuda")
    rope = make_rope_tables(cfg, device="cuda")

    def fresh():  # float32 copies, apart from the served model's weights
        return _tree(lm.params, lambda t: t.to(torch.float32, copy=True))

    def worst(got: dict, ref: dict) -> float:
        return max(rel_l2(got[k], ref[k]) for k in ref)

    # the unsharded model: first-step gradients with and without remat
    params = fresh()
    train.train_parameters(params)
    grads = {}
    for remat in (True, False):
        before = attention_block.plain_routes["chunk"]
        loss = train.next_token_loss(cfg, params, rope, tokens, remat=remat)
        loss.backward()
        grads[remat] = {k: x.grad.clone() for k, x in leaves(params)}
        for x in (x for _, x in leaves(params)):
            x.grad = None
        routes = attention_block.plain_routes["chunk"] - before
    log("tp", f"train step: the unsharded first-step gradients with and without remat: worst "
              f"per-weight rel L2 {worst(grads[False], grads[True]):.3g} "
              f"(limit {F32_REL_L2:g}); attention on the plain route ({routes} calls a "
              f"forward without remat, counted in plain_routes)")
    if worst(grads[False], grads[True]) > F32_REL_L2:
        raise AssertionError("train step: remat changes the gradients")

    del grads[False]
    losses, firsts = {}, {}
    for name in ("unsharded", "dp=2 x tp=2"):
        p = params if name == "unsharded" else shard_params(cfg, fresh(), mesh)
        params = None
        optimizer = torch.optim.AdamW(train.train_parameters(p), lr=1e-4, weight_decay=1e-4)

        def read_first(opt, args, kwargs, p=p, name=name):
            """The first step's gradients, as the optimizer is about to take
            them (summed over the copies on the mesh)."""
            if name not in firsts:
                firsts[name] = dict(leaves(gather_params(cfg, p, grads=True))) \
                    if name != "unsharded" else {k: x.grad.clone() for k, x in leaves(p)}

        optimizer.register_step_pre_hook(read_first)
        step = train.make_train_step(cfg, optimizer)
        losses[name] = [float(step(p, rope, tokens)) for _ in range(3)]
        del optimizer, step, p
        torch.cuda.empty_cache()
    ref, got = losses["unsharded"], losses["dp=2 x tp=2"]
    err = worst(firsts["dp=2 x tp=2"], firsts["unsharded"])
    log("tp", f"train step, Qwen3-0.6B float32, B=4 S=512, AdamW(lr 1e-4, weight decay 1e-4), "
              f"remat: losses unsharded {ref} vs dp=2 x tp=2 {got}; first-step gradients worst "
              f"per-weight rel L2 {err:.3g} (limit {F32_REL_L2:g})")
    if any(abs(a - b) > TRAIN_LOSS_RTOL * abs(a) for a, b in zip(ref, got)):
        raise AssertionError("train step: the sharded losses part from the unsharded ones")
    if err > F32_REL_L2:
        raise AssertionError("train step: the sharded gradients part from the unsharded ones")
    q = torch.randn(1, 256, 16, 128, device="cuda", requires_grad=True)
    k = torch.randn(1, 256, 8, 128, device="cuda")
    try:
        flash_attention_causal(q, k, k, scale=128 ** -0.5)
    except RuntimeError as e:
        log("tp", f"K2 given a query that requires grad raises: {e}")
    else:
        raise AssertionError("K2 took a query that requires grad")


# ---------------------------------------------------------------------------
# Phase 'fuse': wq|wk|wv and gate|up as one product each (models/fuse.py)

# Qwen3-0.6B's fused K6 shapes at I = 1024: q|k|v (2048 + 1024 + 1024) and
# gate|up (3072 + 3072); a row's name carries the kind and M
FUSED_PARTS = {"qkv": (2048, 1024, 1024), "gate_up": (3072, 3072)}
FUSED_M = (1, 8, 256)
FUSED_TAGS = tuple(f"[{kind} M{M}]" for kind in FUSED_PARTS for M in FUSED_M)
# fused against unfused in bf16, on one card: the same weights, K6 bit for
# bit where its split of I matches (check_fused_k6), cuBLAS free to choose
# another algorithm for the wider bf16 product and the plain prefill
# product at M = 300: the last-token logits agree to FUSE_REL_L2, greedy
# tokens by the tie rule
FUSE_REL_L2 = 1e-3
# Qwen3.5-0.8B's random-weight hybrid magnifies every bf16 rounding about 5x
# the dense model's (bf16 against float32: about 0.08 at 24 layers against
# 0.017; check_hybrid_model), so its bar is 5x the dense one
FUSE_REL_L2_35 = 5e-3
FUSE_NEW = 64  # greedy tokens of the fused-against-unfused generate
FUSE_NEW_35 = 16  # Qwen3.5-0.8B's


def mma_tiles_ran(calls) -> list | None:
    """The output tile (rows, cols) of the tensor-core K6 instance each of
    ``calls`` launched, in order, read from the kernel names of one
    ``torch.profiler`` trace; None unless the trace holds one such kernel a
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    kernel = "quant_matmul_mma_kernel<"  # <rows, cols, int4>
    found = sorted((e.start_ns(), e.name().split(kernel, 1)[1].split(","))
                   for e in device_events(prof) if kernel in e.name())
    if len(found) != len(calls):
        return None
    return [(int(args[0]), int(args[1])) for _, args in found]


def check_fused_k6() -> list[dict]:
    """Phase 3 at the fused widths: K6 (w8, w4) at M in FUSED_M on
    Qwen3-0.6B's fused q|k|v (O = 4096) and gate|up (O = 6144), each fused
    weight built by fuse_layer from the separately quantized parts. Each
    against its plain version (float32 on the same codes), and against the
    unfused products concatenated: bit for bit where the reduction over I
    runs in the same order at both widths (the CUDA-core kernel below
    MMA_MIN_M rows; the tensor-core kernel where mma_plan splits I over the
    same cluster at both widths), else within the kernel bound; the plans
    are logged. One row per bit width, kind and M, timed against the plain
    version and the library call where one computes the same function
    (``int8pack_mm``, ``int4pack_mm``), launches 0. The tensor-core
    instance each product launched is read from one profiler trace and held
    to mma_plan's tile."""
    import torch

    from crane_tpu_torch.models.fuse import fuse_layer
    from crane_tpu_torch.ops.cuda.quant_matmul import (
        MMA_MIN_M,
        MMA_TILES,
        mma_plan,
        quant_matmul,
        quant_matmul_plain,
    )
    from crane_tpu_torch.ops.linear import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(4096)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows, tensor_core = [], []
    for bits in (8, 4):
        for kind, outs in FUSED_PARTS.items():
            parts = [quantize_weight(rnd(1024, o) * 1024 ** -0.5, bits=bits) for o in outs]
            layer = ({"attn": dict(zip(("wq", "wk", "wv"), parts))} if kind == "qkv"
                     else {"mlp": dict(zip(("gate", "up"), parts))})
            fused = fuse_layer(layer)
            w = fused["attn"]["wqkv"] if kind == "qkv" else fused["mlp"]["gate_up"]
            I, O = w.shape
            if w.packed != (bits == 4) or O != sum(outs):
                raise AssertionError(f"fused w{bits} {kind}: shape {w.shape}, packed {w.packed}")
            for M in FUSED_M:
                x = rnd(M, I).to(torch.bfloat16)
                name = f"K6 w{bits} {kind} M={M} I={I} O={O}"
                got = quant_matmul(x, w.codes, w.scales, bits=bits)
                err = compare(name, got, quant_matmul_plain(x.float(), w.codes, w.scales,
                                                            bits=bits))
                plan = mma_plan(M, I, O, bits, sms)
                o, verdicts = 0, []
                for p in parts:
                    ref = quant_matmul(x, p.codes, p.scales, bits=bits)
                    piece = got[:, o:o + p.shape[1]]
                    o += p.shape[1]
                    if M < MMA_MIN_M:
                        same_order, where = True, "CUDA-core kernel"
                    else:
                        part_plan = mma_plan(M, I, p.shape[1], bits, sms)
                        same_order = part_plan[1] == plan[1]
                        where = (f"tiles {MMA_TILES[part_plan[0]]} / {MMA_TILES[plan[0]]}, "
                                 f"split {part_plan[1]} / {plan[1]}")
                    equal = torch.equal(piece, ref)
                    if same_order and not equal:
                        raise AssertionError(f"{name}: the columns of O={p.shape[1]} differ from "
                                             f"the unfused product in the same order ({where})")
                    if not equal:
                        compare(f"{name} vs unfused O={p.shape[1]}", piece, ref)
                    same = "bit-equal" if equal else f"{int((piece != ref).sum())} elements differ"
                    verdicts.append(f"O={p.shape[1]}: {same} ({where})")
                if M >= MMA_MIN_M:
                    tensor_core.append((name, [
                        (lambda x=x, q=q, b=bits: quant_matmul(x, q.codes, q.scales, bits=b),
                         MMA_TILES[mma_plan(M, I, q.shape[1], bits, sms)[0]])
                        for q in [w] + parts]))
                log("kernels", f"{name}: max|err| {err:.3g} vs plain; against the unfused "
                               f"products (part / fused): {'; '.join(verdicts)}")
                library = int4pack_mm(x, w) if bits == 4 else int8pack_mm(x, w)
                rows.append(timed_row(
                    f"quant_matmul[w{bits}][{kind} M{M}]",
                    "quant_matmul.cu" if M < MMA_MIN_M else "quant_matmul_mma.cu",
                    "crane_tpu/ops/pallas/quant_matmul.py:" + ("102" if bits == 8 else "115"),
                    [err], lambda: quant_matmul(x, w.codes, w.scales, bits=bits),
                    lambda: quant_matmul_plain(x, w.codes, w.scales, bits=bits),
                    f"M={M} I={I} O={O} (fused {kind})",
                    (M * I * 2 + I * O * bits // 8 + O * 4 + M * O * 2, 2 * M * I * O),
                    library))
    # the tensor-core instance each product launched, from one trace
    tiles = mma_tiles_ran([call for _, calls in tensor_core for call, _ in calls])
    for name, calls in tensor_core:
        planned = [tile for _, tile in calls]
        if tiles is None:
            log("kernels", f"{name}: the tiles that ran: not measured (no kernel in the trace)")
            continue
        ran, tiles = tiles[:len(calls)], tiles[len(calls):]
        if ran != planned:
            raise AssertionError(f"{name}: the tiles that ran, {ran} (fused, then the parts), "
                                 f"are not mma_plan's {planned}")
        log("kernels", f"{name}: the tiles that ran (fused, then the parts): {ran}, as planned")
    return rows


def fused_model(lm):
    """``lm``'s model with its projections fused (a new tree; the weights'
    bytes as they are), its quantized codes checked against the parts'."""
    import torch

    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.ops.linear import QuantizedWeight

    fused = CausalLM(lm.config, lm.params, dtype=lm.dtype, fuse=True)
    for lf, lu in zip(fused.params["layers"], lm.params["layers"]):
        for part, key, names in (("attn", "wqkv", ("wq", "wk", "wv")),
                                 ("mlp", "gate_up", ("gate", "up"))):
            if part not in lf or names[0] not in lu.get(part, {}):
                continue  # a GDN layer has no q|k|v
            w = lf[part][key]
            ws = [lu[part][n] for n in names]
            if isinstance(w, QuantizedWeight):
                same = (torch.equal(w.codes, torch.cat([u.codes for u in ws], 1))
                        and torch.equal(w.scales, torch.cat([u.scales for u in ws], 1)))
            else:
                same = torch.equal(w, torch.cat(ws, 1))
            if not same:
                raise AssertionError(f"fused {key} is not its parts concatenated")
    return fused


def greedy_blocks(model, prompt, n, kv_bits=None):
    """(the prefill's last-token logits, ``n`` greedy tokens, the cache, a
    block): the prompt's fresh prefill into a 512-slot row, then decode
    steps in graph blocks of STEP_BLOCK (one capture, then replays), as
    generate's tokens (graph_vs_eager holds a block against the eager
    loop). ``block()`` replays that program once more at the prompt's end
    (the row rewound there) and returns its tokens."""
    import torch

    from crane_tpu_torch.ops.sampling import SamplingParams

    dev = model.device
    logits, cache = model.prefill(model.init_cache(1, 512, quant_bits=kv_bits), [prompt],
                                  [len(prompt)])
    tok = logits.argmax(-1).to(torch.int32)
    toks = [int(tok[0])]
    recent = torch.full((1, 64), -1, dtype=torch.int32, device=dev)
    sp = SamplingParams.make(1, do_sample=False, device=dev)
    gen = torch.Generator(device=dev)
    while len(toks) < n:
        out, cache, recent = model.decode_steps(cache, tok, recent, sp, gen, STEP_BLOCK)
        toks += out[0].tolist()
        tok = out[:, -1]

    def block():
        cache.lengths.fill_(len(prompt))
        return model.decode_steps(cache, tok, recent, sp, gen, STEP_BLOCK)[0]

    return logits[0], toks[:n], cache, block


def fused_against_unfused(label, lm, fused, prompt, n, kv_bits=None,
                          limit=FUSE_REL_L2) -> tuple:
    """The 300-token prefill's last-token logits within ``limit`` of the
    unfused model's, then ``n`` greedy tokens (greedy_blocks) equal, or
    parting at a tie on the unfused path's own state: its prefill logits
    for the first token, its replayed decode step over its cache
    (ties_on_reference_state) for a later one. Returns the two paths'
    blocks (unfused, fused)."""
    ref_logits, ref, ref_cache, ref_block = greedy_blocks(lm, prompt, n, kv_bits)
    logits, got, _, block = greedy_blocks(fused, prompt, n, kv_bits)
    err = rel_l2(logits, ref_logits)
    log("fuse", f"{label}: 300-token prefill logits fused vs unfused rel L2 {err:.4g} (limit "
                f"{limit:g})")
    if err > limit:
        raise AssertionError(f"{label}: fused prefill logits disagree with the unfused model's")
    if got[0] != ref[0]:
        tie_at_first_difference("fuse", f"{label} greedy({n}) fused vs unfused", ref, got,
                                lambda i: ref_logits)
        return ref_block, block
    parted = ties_on_reference_state(lm, f"{label} fused vs unfused", ref_cache.layers, 1,
                                     {0: (prompt + ref[:1], got[1:], ref[1:])}, LOGIT_TIE)
    log("fuse", f"{label}: {n} greedy tokens fused vs unfused: "
                f"{'identical' if not parted else f'first difference at a tie {parted}'}")
    return ref_block, block


def fuse_ab(blocks: dict) -> None:
    """The fused/unfused A/B of a graph decode step at B=1 after 300
    tokens, on the programs fused_against_unfused ran (``blocks``: label ->
    (unfused block, fused block)): unfused, fused, fused, unfused in turns,
    CUDA events over 5 blocks of STEP_BLOCK steps each (behind the
    device-side wait); ms a step each way and their ratio."""
    for label, (unfused, fused) in blocks.items():
        t = {"unfused": [], "fused": []}
        for k, block in (("unfused", unfused), ("fused", fused), ("fused", fused),
                         ("unfused", unfused)):
            t[k].append(cuda_ms(block, iters=5, warmup=2) / STEP_BLOCK)
        u, f = (sum(t[k]) / 2 for k in ("unfused", "fused"))
        log("fuse", f"A/B {label} B=1, a graph decode step after 300 tokens (CUDA events, in "
                    f"turns u f f u): unfused {t['unfused'][0]:.4f} / {t['unfused'][1]:.4f} ms, "
                    f"fused {t['fused'][0]:.4f} / {t['fused'][1]:.4f} ms; fused / unfused "
                    f"{f / u:.4f}")


def check_span_and_rate(label, block) -> None:
    """utils/tracing.py's span around one graph block (``block()``, which
    returns its tokens): its name must appear among the events of a
    torch.profiler trace, and report() is logged; utils/timing.py's
    marginal_rate of graph blocks (2 against 10, each chain ended by one
    host sync) beside the CUDA-event ms of a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from crane_tpu_torch.utils import timing, tracing

    name = "fused_decode_block"
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span(name):
            timing.host_sync(block())
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    if name not in names or tracing.stats()[name][0] != 1:
        raise AssertionError(f"span {name!r} is not in the profiler's trace")
    log("tracing", f"span {name!r} found in the torch.profiler trace; report():\n"
                   f"{tracing.report()}")
    rate = timing.marginal_rate(lambda: block, 2, 10)
    ms = cuda_ms(block, iters=10, warmup=1) / STEP_BLOCK
    log("timing", f"{label}: marginal_rate of graph blocks {rate:.3f} blocks/s, "
                  f"{1e3 / (rate * STEP_BLOCK):.4f} ms a step (host clock, one sync a chain) vs "
                  f"{ms:.4f} ms a step by CUDA events")
    tracing.reset()
    torch.cuda.synchronize()


def check_activations() -> None:
    """ops/activations.py on the card against the CPU, on the same inputs:
    snake (some alpha == 0, the identity) and atan2 (the four quadrants, the
    axes, the origin), in float32 (1e-5: sin and atan2 of two libraries)
    and in bf16 (one bf16 rounding of the float32 result)."""
    import torch

    from crane_tpu_torch.ops.activations import atan2, snake

    gen = torch.Generator().manual_seed(17)
    x = torch.randn(4, 64, 1000, generator=gen) * 3
    alpha = torch.rand(64, 1, generator=gen) + 0.1
    alpha[[3, 40]] = 0.0
    y2, x2 = torch.randn(10000, generator=gen), torch.randn(10000, generator=gen)
    y2[:9] = torch.tensor([1.0, 1.0, -1.0, -1.0, 0.0, 0.0, 2.0, -2.0, 0.0])
    x2[:9] = torch.tensor([1.0, -1.0, -1.0, 1.0, 3.0, -3.0, 0.0, 0.0, 0.0])
    for dtype, tol in ((torch.float32, (1e-5, 1e-5)), (torch.bfloat16, (2 ** -8, 2 ** -8))):
        for name, fn, args in (("snake", snake, (x.to(dtype), alpha)),
                               ("atan2", atan2, (y2.to(dtype), x2.to(dtype)))):
            got = fn(*(a.cuda() for a in args))
            ref = fn(*args)
            if got.dtype != ref.dtype:
                raise AssertionError(f"{name} {dtype}: {got.dtype} on the card")
            err = compare(f"{name} {dtype} card vs CPU", got.cpu(), ref, rtol=tol[0], atol=tol[1])
            log("activations", f"{name} {str(dtype).removeprefix('torch.')} card vs CPU: "
                               f"max|err| {err:.3g} over {ref.numel()} elements")
        ident = snake(x.to(dtype).cuda(), alpha.cuda())[:, [3, 40]].cpu()
        if not torch.equal(ident, x.to(dtype)[:, [3, 40]]):
            raise AssertionError(f"snake {dtype}: alpha == 0 is not the identity on the card")


def check_fuse(lm, lm8, lm4, lm35, rows: list[dict], unfused_w4: dict) -> None:
    """Phase 'fuse': the fused projections (CRANE_FUSE_PROJ's layout) on the
    models the earlier phases built. The main path, its counts zeroed just
    before it: Qwen3-0.6B bf16, w8 kv8 and w4 kv4 fused against unfused
    (fused_against_unfused: the 300-token prefill and FUSE_NEW greedy
    tokens in graph blocks), the engine mix once fused at w4 kv4, and
    Qwen3.5-0.8B's prefill and FUSE_NEW_35 tokens (its gated q is 2 H D
    wide; its GDN layers fuse the MLP only). Then the K6 launches of a B=1
    w4 kv4 decode step, fused against unfused (3 fewer a layer), the graph
    decode step fused beside unfused (log_decode_steps at B=1 and 8, w4
    kv4, and fuse_ab's A/B at B=1 in bf16, w8 kv8 and w4 kv4), a tracing
    span, timing's marginal rate and the activations on the card. The
    unfused w4 kv4 model's step launches and graph steps are the quantized
    phase's (``unfused_w4``: launches_per's "step", log_decode_steps'
    "table")."""
    import torch

    from crane_tpu_torch.ops import cuda as kernels

    cfg = lm.config
    fused = {"bf16": fused_model(lm), "w8 kv8": fused_model(lm8), "w4 kv4": fused_model(lm4)}
    fused35 = fused_model(lm35)
    gen = torch.Generator().manual_seed(300)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen).tolist()
    prompt35 = torch.randint(0, lm35.config.vocab_size, (300,), generator=gen).tolist()

    reset_counts()
    blocks = {label: fused_against_unfused(f"Qwen3-0.6B {label}", unfused, fused[label], prompt,
                                           FUSE_NEW, kv_bits)
              for label, unfused, kv_bits in (("bf16", lm, None), ("w8 kv8", lm8, 8),
                                              ("w4 kv4", lm4, 4))}
    check_engine(fused["w4 kv4"], "fuse-engine w4 kv4", kv_quant_bits=4)
    k7_routes_launched("Qwen3.5-0.8B fused", lambda: fused_against_unfused(
        "Qwen3.5-0.8B bf16", lm35, fused35, prompt35, FUSE_NEW_35, limit=FUSE_REL_L2_35))
    counts = kernels.launch_counts()
    read_launches("fuse path", rows, counts)
    require_launched("fuse path", counts, (
        "fp_decode_attention", "flash_attention_causal", "quant_decode_attention[kv8]",
        "quant_decode_attention[kv4]", "quant_cached_attention[kv4]", "quant_matmul[w8]",
        "quant_matmul[w4]", "gdn_scan[chunk]"))
    no_plain_routes("fuse path")

    k6 = {"unfused": unfused_w4["step"].get("quant_matmul[w4]", 0),
          "fused": launches_per(fused["w4 kv4"], "Qwen3-0.6B w4 kv4 fused",
                                kv_bits=4).get("quant_matmul[w4]", 0)}
    log("launches", f"Qwen3-0.6B w4 kv4, K6 a B=1 decode step: unfused {k6['unfused']}, fused "
                    f"{k6['fused']}")
    if k6["unfused"] - k6["fused"] != 3 * cfg.num_layers:
        raise AssertionError(f"K6 launches a decode step {k6['unfused']} -> {k6['fused']}, want "
                             f"{3 * cfg.num_layers} fewer")
    table = log_decode_steps(fused["w4 kv4"], "Qwen3-0.6B w4 kv4 fused", kv_bits=4,
                             shapes=DECODE_SHAPES[:2], modes=("graph",))
    for (B, T), modes in table.items():
        wall, busy = modes["graph"]
        ref_wall, ref_busy = unfused_w4["table"][(B, T)]["graph"]
        log("fuse", f"Qwen3-0.6B w4 kv4 graph step at B={B} (host clock; busy from the "
                    f"profiler): fused {wall:.3f} ms, busy {busy:.4f}; unfused (phase "
                    f"quantized) {ref_wall:.3f} ms, busy {ref_busy:.4f}")
    fuse_ab(blocks)
    check_span_and_rate("Qwen3-0.6B w4 kv4 fused, B=1", blocks["w4 kv4"][1])
    check_activations()
    for model in (lm, lm8, lm4, lm35, fused35, *fused.values()):
        model.release_graphs()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible", file=sys.stderr)
        return 2

    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.ops.cuda import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    build.lib()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
                 f"({build.library_path().name})")
    log_build_info()

    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(phase):
        nonlocal t_phase
        phase_s[phase] = time.perf_counter() - t_phase
        log("time", f"phase {phase} ran in {phase_s[phase]:.1f} s")
        t_phase = time.perf_counter()

    rows = check_kernels()
    quant_rows = check_quant_kernels()
    hybrid_rows = check_d256_kernels() + check_gdn_kernel()
    long_rows = check_long_decode()
    verify_rows = check_verify_kernels()
    rows += long_rows["dense"]
    quant_rows += long_rows["quantized"]
    hybrid_rows += long_rows["hybrid"]
    family_rows = check_family_kernels()
    family_rows["moe"] += check_moe_kernels()
    tp_rows = check_tp_kernels()
    slice_rows = check_slice_kernels()
    audio_rows = check_audio_kernels()
    tts_rows = check_tts_kernels()
    fuse_rows = check_fused_k6()
    check_routed_configs()
    phase_done("kernels")

    # the dense main path: bf16 generation and serving (K1, K2, K3)
    reset_counts()
    lm = check_model()
    check_engine(lm)
    read_launches("dense path", rows, kernels.launch_counts())
    no_plain_routes("dense path")
    graph_vs_eager(lm, "Qwen3-0.6B bf16")
    log_decode_steps(lm, "Qwen3-0.6B bf16")
    lm.release_graphs()
    phase_done("dense")

    # the quantized main path: int4 and int8 ISQ weights on int8 and int4
    # KV caches (K2 for fresh prefills, K4, K5 and K6 at each bit width)
    from crane_tpu_torch.models.auto import quantize_params
    from crane_tpu_torch.models.causal_lm import CausalLM

    reset_counts()
    params4 = check_quant_model(lm)
    lm8 = CausalLM(lm.config, quantize_params(lm.params, bits=8), dtype=torch.bfloat16)
    check_engine(lm8, "quant-engine w8 kv8", kv_quant_bits=8)
    lm4 = CausalLM(lm.config, params4, dtype=torch.bfloat16)
    check_engine(lm4, "quant-engine w4 kv4", kv_quant_bits=4)
    counts = kernels.launch_counts()
    if counts["flash_attention_causal"] <= 0:
        raise AssertionError("the quantized path never launched K2")
    read_launches("quantized path", quant_rows, counts)
    no_plain_routes("quantized path")
    graph_vs_eager(lm8, "Qwen3-0.6B w8 kv8", kv_bits=8)
    launches_per(lm8, "Qwen3-0.6B w8", kv_bits=8)
    lm8.release_graphs()
    graph_vs_eager(lm4, "Qwen3-0.6B w4 kv4", kv_bits=4)
    unfused_w4 = {"step": launches_per(lm4, "Qwen3-0.6B w4", kv_bits=4),
                  "table": log_decode_steps(lm4, "Qwen3-0.6B w4 kv4", kv_bits=4)}
    lm4.release_graphs()
    phase_done("quantized")

    # the hybrid main path: Qwen3.5-0.8B generation and serving (K1, K2, K3
    # at head_dim 256; K7 for every GDN prefill and continuation chunk)
    reset_counts()
    lm35 = check_hybrid_model()
    k7_routes_launched("Qwen3.5-0.8B engine", lambda: check_engine(lm35, "hybrid-engine"))
    read_launches("hybrid path", hybrid_rows, kernels.launch_counts())
    no_plain_routes("hybrid path")
    graph_vs_eager(lm35, "Qwen3.5-0.8B bf16")
    launches_per(lm35, "Qwen3.5-0.8B bf16")
    lm35.release_graphs()
    phase_done("hybrid")

    # the fused projections (CRANE_FUSE_PROJ's layout) on the models the
    # quantized and hybrid phases built: K6 at the fused widths (O = 4096,
    # 6144), K1-K5 fed slices of one product, K7 beside a fused MLP
    check_fuse(lm, lm8, lm4, lm35, fuse_rows, unfused_w4)
    del lm8
    torch.cuda.empty_cache()
    phase_done("fuse")

    # the sequence-parallel main path: Qwen3-0.6B in four slabs on the card
    # (K2 for fresh prompts; K1-S, K3-S, K4-S and K5-S over the slabs)
    from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm

    sp_rows = check_stats_kernels() + long_rows["sp"]
    reset_counts()
    check_sp(lm, sp_rows)
    no_plain_routes("sp path")
    graph_vs_eager(sp_shard_lm(lm, make_sp_mesh(4, ["cuda:0"] * 4)), "Qwen3-0.6B bf16, 4 slabs")
    lm.release_graphs()
    phase_done("sp")

    # paths the card had not run: an int8 KV cache on the hybrid, the
    # hybrid in four slabs, int8 ISQ weights in four slabs
    check_unrun_paths(lm, lm35)
    phase_done("paths")

    # tensor and data parallelism on the card: Qwen3-0.6B, Qwen3.5-0.8B and
    # Qwen3-Next over meshes of cuda:0 (K1-K5 and K7 per shard at local
    # heads), and the dp x tp train step (attention on the plain route)
    check_tp(lm, lm35, tp_rows)
    del lm35
    torch.cuda.empty_cache()
    phase_done("tp")

    # speculative decoding: verify forwards (K3, K5, K3-S, K5-S; K6 at
    # B (k + 1) rows) inside chained propose/verify graphs
    check_spec(lm, lm4, verify_rows)
    check_spec_kv(lm, lm4)
    phase_done("spec")

    # the server over HTTP (the main path's last link): K1-K3 in bf16, and
    # K2, K4, K5 and K6 in w4 kv4, counted over the HTTP traffic alone
    counts = check_http(lm, "Qwen3-0.6B bf16")
    require_launched("http path, bf16", counts, (
        "fp_decode_attention", "flash_attention_causal", "flash_attention_cached"))
    no_plain_routes("http path, bf16")
    counts = check_http(lm4, "Qwen3-0.6B w4 kv4", kv_bits=4)
    require_launched("http path, w4 kv4", counts, (
        "flash_attention_causal", "quant_decode_attention[kv4]", "quant_cached_attention[kv4]",
        "quant_matmul[w4]"))
    no_plain_routes("http path, w4 kv4")
    del lm4, params4
    phase_done("http")

    # a prompt id outside the vocabulary: 400 over HTTP, an error response
    # from engine.submit, and the engine serves the next request
    check_oov(lm)
    phase_done("oov")

    # a q8_0 GGUF file of the same weights, on the card against the CPU,
    # and served over HTTP (K1-K3; blockwise linears, no K6)
    check_gguf(lm)
    del lm
    torch.cuda.empty_cache()
    phase_done("gguf")

    # the short-conv main path: LFM2-1.2B generation and serving (K1, K2
    # and K3 at head_dim 64, 32 query / 8 KV heads)
    reset_counts()
    lm_conv = check_lfm2_model()
    check_engine(lm_conv, "lfm2-engine")
    graph_vs_eager(lm_conv, "LFM2-1.2B bf16")
    read_launches("lfm2 path", family_rows["lfm2"], kernels.launch_counts())
    no_plain_routes("lfm2 path")
    log_decode_steps(lm_conv, "LFM2-1.2B bf16", shapes=DECODE_SHAPES[:2])
    del lm_conv
    torch.cuda.empty_cache()
    phase_done("lfm2")

    # the MoE main path: Qwen3-Next-80B-A3B at 12 layers, generation and
    # serving (K1, K2, K3 at head_dim 256 with 16 / 2 heads; K7 over 32
    # value heads; K8 in every MoE layer, eager prefills and decode replays)
    reset_counts()
    with plain_moe_on_card() as plain_moe:
        lm_moe = check_moe_model()
        check_engine(lm_moe, "moe-engine")
        graph_vs_eager(lm_moe, f"Qwen3-Next {MOE_LAYERS} layers bf16")
    read_launches("moe path", family_rows["moe"], kernels.launch_counts())
    require_launched("moe path", kernels.launch_counts(), (
        "moe_experts[group]", "moe_experts[gate_up]", "moe_experts[down]"))
    if any(plain_moe.values()):
        raise AssertionError(f"the moe path ran a plain MoE dispatch on the card: {plain_moe}")
    no_plain_routes("moe path")
    log_moe_decode(lm_moe)
    del lm_moe
    torch.cuda.empty_cache()
    phase_done("moe")

    # Gemma 3n E4B through TextBackend: K1 at 8 / 2 heads of 256 with scale
    # 1.0 and the window, on the shared layers over their source's cache
    reset_counts()
    lm_g3n = check_gemma3n_model()
    check_gemma3n_http(lm_g3n)
    read_launches("gemma3n path", slice_rows[:1], kernels.launch_counts())
    no_plain_routes("gemma3n path")
    del lm_g3n
    torch.cuda.empty_cache()
    phase_done("gemma3n")

    # the vision-language models: Qwen3-VL (K3 prefill, K1 in decode-block
    # graphs), Gemma3-VL (K2 with segments, K1), PaddleOCR-VL (K3, K1)
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    segment_launches = 0
    for label, check, names in (
            ("Qwen3-VL path", check_qwen3_vl, ("fp_decode_attention", "flash_attention_cached")),
            ("Gemma3-VL path", check_gemma3_vl, ("fp_decode_attention", "flash_attention_causal")),
            ("PaddleOCR-VL path", check_paddleocr_vl,
             ("fp_decode_attention", "flash_attention_cached"))):
        reset_counts()
        check()
        counts = kernels.launch_counts()
        require_launched(label, counts, names)
        no_plain_routes(label)
        log("launches", f"{label}: K2 with segments "
                        f"{k23.flash_attention_causal.segment_launches}")
        segment_launches += k23.flash_attention_causal.segment_launches
        torch.cuda.empty_cache()
    # the K2 row at Gemma3-4B's heads reads its launches given segments
    read_launches("vlm path", slice_rows[1:], {"flash_attention_causal": segment_launches})
    phase_done("vlm")

    # audio in: Qwen3-ASR-0.6B served over HTTP (K3 for the spliced
    # prefill, K1 in graph blocks of 16 steps), Qwen2-Audio-7B (K3 and K1 at
    # 32 / 32 heads of 128), Whisper large-v3, Moonshine tiny, the VAD net;
    # each path's counts are zeroed just before its main path
    for label, check in (("Qwen3-ASR path", check_qwen3_asr),
                         ("Qwen2-Audio path", check_qwen2_audio)):
        counts = check()
        require_launched(label, counts, ("fp_decode_attention", "flash_attention_cached"))
        no_plain_routes(label)
        torch.cuda.empty_cache()
    # the rows at Qwen2-Audio's heads read its path's launches
    read_launches("Qwen2-Audio path", audio_rows, counts)
    check_speech_decoders()
    check_vad()
    torch.cuda.empty_cache()
    phase_done("audio")

    # speech out: Qwen3-TTS served over /v1/audio/speech (K3 for the talker's
    # prefill; in each frame block's replay K3 at S=2 and K1 over the
    # predictor's 32 slots, K1 for the talker's step) and CSM-1B with Mimi
    # (K3 at S=32 over the depth cache, K1 for the backbone's step); each
    # path's counts are zeroed just before its main path
    for label, check, rows_of in (("Qwen3-TTS path", check_qwen3_tts, tts_rows[:2]),
                                  ("CSM path", check_csm, tts_rows[2:])):
        counts = check()
        require_launched(label, counts, ("fp_decode_attention", "flash_attention_cached"))
        no_plain_routes(label)
        read_launches(label, rows_of, counts)
        torch.cuda.empty_cache()
    phase_done("tts")

    # the rest of speech and vision, which launch no kernel: Voxtral-4B TTS
    # (its backbone's heads of 96 routed plain by shape, and only those),
    # Kokoro's net and the OCR nets; the counts are zeroed in check_voxtral
    # just before its main path
    check_voxtral()
    torch.cuda.empty_cache()
    phase_done("voxtral")
    for label, check in (("kokoro", check_kokoro), ("ocr", check_ocr)):
        reset_counts()
        check()
        require_none_launched(f"{label} path")
        no_plain_routes(f"{label} path")
        torch.cuda.empty_cache()
        phase_done(label)
    log("time", f"phases (s): {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")

    rows += quant_rows + hybrid_rows + sp_rows + verify_rows + family_rows["lfm2"] \
        + family_rows["moe"] + slice_rows + audio_rows + tts_rows + tp_rows["dense"] \
        + tp_rows["hybrid"] + tp_rows["moe"] + fuse_rows
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
