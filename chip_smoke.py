#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (built for Hopper, ``sm_90a``) and ``nvcc``; takes no
arguments.  It drives the port's main paths — the Keyword Transformer
served offline through ``repro_torch.runtime``, streamed hop by hop, and
trained with quantisation-aware training, the dense LM (internlm2-1.8b
at full width, on the float and on the int8 KV cache) and the moe LM
(granite-moe-3b-a800m at full width) served with continuous batching, the recurrent LMs (rwkv6-3b and hymba-1.5b at
full width) served as one drain batch, the encoder-decoder
(whisper-large-v3 at full width) run at module level under the ``cuda``
plan's ``exec_cfg``, nemotron-4-340b's layers at full width (2 of 96,
the attention at head_dim 192), and the dense LM trained (internlm2-1.8b
at full width, float and QAT on the ``cuda`` backend) — on the card, and is the
quickest proof that the port still builds and starts there:

1. ``device``          the card, its power limit, TF32 off.
2. ``build``           compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc``
                       into ``build/repro_torch/libkernels.so`` and loads it.
3. ``kernels``         every kernel against its plain PyTorch version on
                       CUDA tensors, ``torch.equal`` (the softmax, GELU
                       and matmul are exact by construction), at the
                       main-path shapes of both
                       KWT models for batch 1 / 8 / 64 / 4096 (KWT-1's
                       matmuls also with int4 per-channel weights), at
                       ragged shapes and at the edges of the softmax's slab
                       path and the GELU's 16-byte vectors (short and
                       ragged slabs, rows packed several to a warp, the
                       slab limit, misaligned views, lengths off the vector
                       width); times each beside its plain version, one
                       PyTorch library call and its memory/compute bound.
   The matmul takes the float activation (quantised by eq 9 in the
   kernel; the input of the cuda plans) and the int8 one, int8 and
   nibble-packed int4 weights (unpacked in the kernel), per-column
   exponents over -8..8, activations on exact .5 ties and beyond the clip
   edges, int4 payloads of odd K * N; beside its time ``torch._int_mm``
   (the same int8 product; where it refuses a shape, its error) and f32
   ``torch.matmul``, the faster of them as ``library_ms``.
   At the dense LM's shapes (internlm2-1.8b): the matmul's K-looped path
   for the packed head ``[B, 2048] @ [2048, 92544]`` at B = 4 and 64 with
   per-channel exponents, float32 and bf16 activations (beside
   ``torch._int_mm`` and bf16 ``torch.matmul``), a K of 1000 and K = 8192,
   int4 weights at K = 2048 and at an odd K * N (the K loop's byte-by-byte
   weight staging, which N = 300 takes too);
   the masked softmax (``approx.masked_softmax(mode="cuda")``) on causal
   prefill rows and per-lane decode rows of 33, 256 and 1024 keys, beside
   ``torch.softmax``; the causal GQA attention (2, 16, 8, 1024, 1024, 128)
   on strided views, beside SDPA.  The kernels line carries these rows
   under ``lm``.  The moe router's unmasked Q8.24 rows of 40 experts
   (granite-moe-3b-a800m) at a decode step of 4 slots ``[4, 40]`` and a
   join prefill of 4 x 63 tokens ``[252, 40]``, variant ``fixed router``,
   beside ``torch.softmax``, under ``moe``.  The recurrent LMs' heads at a
   decode step of 4 lanes — rwkv6-3b ``[4, 2560] @ [2560, 65536]`` and
   hymba-1.5b ``[4, 1600] @ [1600, 32128]`` (a K that is no multiple of
   the 256-wide slab), float32 and bf16 activations — under ``rwkv`` and
   ``hybrid``, and hymba's masked softmax rows of 25 heads / 5 KV over its
   ring of 128 slots: the causal prefill of 63 tokens and a ring-decode
   step with one validity bound for every lane, under ``hybrid``.
   ``lut_attention`` cannot be ``torch.equal``: the kernel's own order of
   the dot over D moves an occasional score across a 1/32 LUT bin.  In
   its LUT mode it is held to its plain version, the same online softmax
   over the same key tiles (``ref.lut_attention_tiled``), at a tight bound
   measured on the card (``ATTN_TIGHT_*`` below), which only rescaling at
   the reference's tile edges meets, and to the reference's oracle
   (``ref.lut_attention``, one softmax over all keys) at the reference's
   0.05; in its exact mode to both at 2e-5 (at the KWT shapes, where some
   rows spread wider than the kernel's clip of ``m - s`` at 10, to the
   tiled version, which has the clip).  At the KWT shapes, the reference's
   sweep shapes (causal and not, several key tiles included), ragged
   shapes and key tiles of 8, 27 and 99 keys against depths of 8, 64 and
   72, each also on strided views in the layer's ``[B, L, H, D]`` layout
   (the output laid out so that the layer's reshape is a view); bf16 must
   come out finite.  Its row carries the bytes bound beside the float32
   operations bound.
4. ``perf``            the cost model (``repro_torch.perf``) on the card: the
                       measured roofline envelope (``perf.calibrate``; a
                       reading over 1.05x the H100's datasheet FP32 peak or
                       HBM rate fails, as a timing fault), then every serve
                       plan of phases 5 and 6 (KWT-Tiny at B = 1, 64 and
                       4096, KWT-1 at B = 1 and 64) priced by
                       ``perf.engine_cost`` — the same ``to_dict()`` on the
                       card as for the same weights on the CPU, products at
                       the analytic count, the walk leaving the launch
                       counters as they were — beside its p50 against the
                       H100's datasheet roof and the measured one
                       (``roofline_terms``); one KWT-1 hop of 64 lanes the
                       same way (``perf.stream_hop_cost``, its stage weights
                       on the H100); a ``StreamLanes`` cell on the card
                       whose span-less slow hops make the flight recorder
                       dump, attributed by the cost model's stage weights
                       to the stage the same cell on the CPU names.
5. ``serve_kwt_tiny``  KWT-Tiny (full width and depth) under the ``cuda``
6. ``serve_kwt_1``     backend, then KWT-1 (12 layers, d 64): request
                       batches through ``Engine.forward``, under
                       ``attention="xla"`` (logits ``torch.equal`` to the
                       ``lut`` backend on the card) and ``"flash_lut"``
                       (logits within ``FLASH_*`` of ``lut`` +
                       ``flash_lut`` on the card); close to the same plan
                       on the CPU; the launch counters of the four
                       wrappers rise by exactly the expected numbers;
                       each plan's line holds its launches and its ATen
                       ops per forward.
7. ``stream_kwt_tiny`` the always-on stream through ``Engine.stream_step``
8. ``stream_kwt_1``    under ``cuda`` + ``xla`` and ``cuda`` + ``flash_lut``:
                       numpy-seeded audio for 64 lanes in chunks of 1, 2
                       and 5 hops; on every hop once a lane is warm the
                       logits are ``torch.equal`` to ``Engine.forward`` of
                       the feature ring's window; counters rise per hop as
                       per forward; one lane is reset mid-stream and
                       re-warms; p50 ms per hop and the real-time factor.

   The stream phases also hold the streaming MFCC frames ``torch.equal`` to
   the offline frames of the same audio: the frontend runs its FFT and both
   products on blocks of a fixed shape on the card (``stream.features``), so a
   frame's features do not depend on how many frames share the call.
9. ``cell_kwt_tiny``   the always-on server through its launcher,
                       ``repro_torch.launch.stream_serve.main``, under
                       ``--backend cuda``: 24 seeded event streams on 8
                       slots, the degrade stage on, tracing on (the lanes go
                       through ``Engine.stream_step`` and its spans); the
                       Chrome trace and the ``.prom`` / ``.metrics.json``
                       exports pass ``repro_torch.telemetry.check``; the hop
                       ledger is exact (``cell_hops_total`` = the offered
                       hops); the ``serve_done`` line's fields are printed.
10. ``cell_kwt_1``     KWT-1 at full width and depth in a ``ServeCell`` of
                       64 slots of seeded event streams, under ``cuda`` +
                       ``xla`` and ``cuda`` + ``flash_lut``: joint,
                       pipelined (featurise on a side CUDA stream, encode on
                       the current one) and feature-ingest lanes on the same
                       chunks give events and scores ``np.array_equal``; a
                       packed artifact published mid-stream to the watch
                       directory is installed by ``maybe_swap`` (generation
                       + 1, exact hop ledger); one lane evicted and
                       re-joined comes back zeroed; a corrupted artifact
                       raises ``SwapRejected``, raises ``swap_failures`` by
                       one, leaves the old engine serving and makes the
                       flight recorder write one ``swap_failure`` dump;
                       ``compile_model(taps=True)`` serves logits
                       ``torch.equal`` to the untapped plan, every tap
                       finite; p50 ms per hop and the real-time factor of the
                       joint and the pipelined lanes; 20 more joint and
                       pipelined hops under ``torch.profiler`` (the card's
                       busy share; their launches count as lane hops).
11. ``train_kwt_tiny`` quantisation-aware training through the launcher,
                       ``repro_torch.launch.train.main``, under
                       ``--qat-backend cuda`` (the LUT softmax and GELU
                       kernels in every training forward, behind their
                       straight-through estimators) with the KWT-1 teacher:
                       a run that fails at step 35, its rerun, which must
                       resume from step 30 (the newest step complete in
                       every tree), and an uninterrupted run of the same
                       seed, whose params must be ``torch.equal``; the loss
                       falls; the export's QAT eval is ``torch.equal`` to
                       the non-executing ``lut`` engine, the ``cuda`` plan
                       within 0.35 of it, and the artifact read back from
                       disk deploys bit-identically on that plan.
12. ``train_kwt_1``    KWT-1 (12 layers, 40x98, 35 classes) trained the same
                       way for 10 steps.
   In both: the STE Functions at the step's own shapes (forward
   ``torch.equal`` to the plain version, input gradient ``torch.equal`` to
   ``torch.autograd.grad`` of the exact op, one launch in the forward and
   none in the backward); one QAT step under ``cuda`` and one under ``lut``
   from the same params and batch (loss, gradients, new params and moments
   ``torch.equal``); p50 ms per QAT step and ATen ops per step, the
   student alone and (KWT-Tiny) with the teacher.

13. ``lm_internlm2``   internlm2-1.8b at full width (24 layers, d 2048, 16
                       heads / 8 KV, head_dim 128, d_ff 8192, vocab 92544,
                       bf16; random weights drawn on the card from a seed)
                       served through ``repro_torch.launch.serve --backend
                       cuda``: 8 requests on 4 slots, KV caches of 256,
                       tracing on, every request served, the artifacts
                       valid; the launches equal one softmax per layer and
                       one matmul (the packed head) per prefill and decode
                       step.  Then on the same plan: prefill of S - 1
                       tokens + one ``decode_step`` against ``forward``'s
                       last logits (``LM_DECODE_REL``; the ``float`` plan
                       at float32 activations to rel 1e-4), and a per-lane
                       step equal to the scalar one; the same requests
                       in two orders give equal tokens; ``cuda`` against
                       ``lut`` (recorded; apart by design); the
                       ``flash_lut`` forward at B = 2, S = 1024 against the
                       ``xla`` one (``LM_FLASH_*``; one attention launch
                       per layer, counted on the path); p50 ms per decode
                       step and per prefill, ATen ops per step; the
                       forward of its 4 x 63 prefill tokens priced by
                       ``perf.engine_cost`` (products at the hand count)
                       beside its p50 against the H100's bf16 and float32
                       roofs and the calibrated one (the moe and recurrent
                       phases price theirs the same way).
    ``lm_int8_kv``     the same weights on the int8 KV cache
                       (``QuantConfig(quantize_kv_cache=True)``): the 8
                       requests on 4 slots, KV 256, through
                       ``compile_model`` + ``LMScheduler`` (the
                       ``lm_int8_kv`` path: one softmax per layer and one
                       head matmul per call, no GELU, no attention); the
                       leaves int8 codes / float32 scales and their bytes
                       against the float32 cache's; ``_q8_vec`` on the card
                       ``torch.equal`` to the CPU's on layer 0's real keys
                       and values (their round trip recorded); prefill +
                       decode against forward (``LM_KV8_DECODE_REL``) and
                       a per-lane step equal to the scalar one; the int8
                       cache against the float one, teacher-forced
                       (``LM_KV8_*``) and over the same schedule
                       (recorded); p50 per prefill and decode step of both
                       caches in turns.
14. ``lm_dense_smoke`` the five dense smoke configs and the two moe ones
                       (granite-moe, deepseek-moe with its 2 shared
                       experts) under ``float``, ``lut`` and ``cuda``:
                       decode == forward within the reference's rel 1e-4
                       (moe at the drop-free capacity factor 8.0), and the
                       card against the same plan on the CPU (the ``cuda``
                       plan there through its kernels' plain versions):
                       1e-4 on ``float``, two steps of the head's eq-9
                       input on the integer plans (``LM_SMOKE_*``); every
                       plan priced by ``perf.engine_cost`` the same on the
                       card as on the CPU, the three plans' products
                       equal; the int8 KV cache on internlm2, granite-moe
                       and hymba (and across its ring's wrap), card against
                       CPU (``SMOKE_INT8``).
15. ``lm_granite_moe`` granite-moe-3b-a800m at full width (32 layers, d
                       1536, 24 heads / 8 KV, 40 experts padded to 48,
                       top-8, expert_d_ff 512, vocab 49155, bf16; random
                       weights drawn on the card from a seed) served
                       through ``repro_torch.launch.serve --backend cuda``:
                       8 requests on 4 slots, KV 256, tracing on, every
                       request served, the artifacts valid; the launches
                       equal two softmaxes per layer (attention + router)
                       and one matmul per prefill and decode step.  Then,
                       at the drop-free capacity factor 8.0 (a plan that
                       shares the weights): prefill + decode against
                       forward (``MOE_DECODE_REL`` on ``cuda``,
                       ``MOE_F32_DECODE_REL`` and every route equal on
                       ``cuda`` at float32 activations, rel 1e-4 on
                       ``float`` at float32 activations), a per-lane step
                       equal to the scalar one, the same requests in two
                       orders equal; at the config's 1.25, recorded: the
                       dropped (token, slot) pairs of one 4 x 63 prefill
                       and whether two orders differ (ROADMAP C8); the
                       softmax kernel ``torch.equal`` to its plain version
                       on every layer's router logits of that prefill;
                       ``cuda`` against ``lut`` (recorded); p50 ms per
                       decode step and per prefill, ATen ops per step, peak
                       GB.
16. ``lm_rwkv6``       rwkv6-3b at full width (32 layers, d 2560, 40 heads
17. ``lm_hymba``       of 64, d_ff 8960, vocab 65536, bf16), then
                       hymba-1.5b at full width (32 layers, d 1600, 25 heads
                       / 5 KV, mamba state 16, window 2048, vocab 32001,
                       bf16); weights drawn on the card from a seed by the
                       port's ``init_params`` (the models' own decays).
                       Served as the reference serves the recurrent
                       families (``LMScheduler`` refuses them, as it does
                       there): ``compile_model(backend="cuda")``, one
                       ``Engine.prefill`` of 4 requests of 63 tokens, then
                       64 greedy ``decode_step`` calls; every request gets
                       its 64 tokens; the launches equal one matmul (the
                       head) per call, and for hymba one softmax per layer
                       per call.  Then on the same weights: the head
                       kernel ``torch.equal`` to its plain version on the
                       real final hidden states of a prefill and of a
                       decode step; hymba's softmax kernel ``torch.equal``
                       to its plain version on every layer's real masked
                       scores of a prefill and of a ring-decode step;
                       prefill of 63 + one decode step against
                       ``forward`` of 64, and a prefill of 63 split in two
                       against one (state continuity): on ``cuda`` within
                       ``RECURRENT_DECODE_REL`` / ``_CONTINUITY_REL``, the
                       greedy tokens equal or near ties; on ``float`` at
                       float32 activations within rel 1e-4, the greedy
                       tokens equal; for rwkv a per-lane
                       step equal to the scalar one; ``cuda`` against
                       ``lut`` (recorded); p50 ms per decode step and per
                       prefill, ATen ops per step, peak GB and seconds.
18. ``lm_whisper``     whisper-large-v3 at full width (32 encoder and 32
                       decoder layers, d 1280, 20 heads of 64, d_ff 5120,
                       enc_seq 1500, vocab 51866, bf16; weights drawn on
                       the card by the port's ``init_params`` from a seed;
                       the stub frontend's frames from a numpy seed), run
                       as the reference runs the family (ROADMAP C11): the
                       module's ``prefill`` and ``decode_step`` with float
                       params under ``runtime.get_backend("cuda")
                       .configure(cfg)``, 4 clips, a 4-token prompt, 60
                       greedy steps, then one ``flash_lut`` forward
                       (``encode`` + ``decode_train``); the launches equal
                       per prefill a softmax per encoder query chunk and
                       two per decoder layer, a GELU per layer, per step
                       two softmaxes and a GELU per decoder layer, per
                       flash forward an attention per layer.  Then on the
                       same weights: the softmax kernel ``torch.equal`` on
                       real encoder chunks of 1500-key scores and on every
                       decoder layer's cross-attention rows of a decode
                       step, the GELU kernel on real encoder MLP inputs,
                       the attention on the first encoder layer's real q,
                       k, v at key tiles of 4 (bf16 and float32 copies,
                       the tight terms in float32); prefill + decode
                       against ``decode_train`` (``WHISPER_DECODE_REL`` on
                       ``cuda``, the reference's 1e-3 on ``float`` at
                       float32); ``flash_lut`` against ``xla``
                       (``WHISPER_FLASH_*``); ``cuda`` against ``lut``
                       and their greedy tokens (recorded); p50 ms of
                       ``encode``, ``prefill`` and ``decode_step``, ATen
                       ops per step, peak GB.
    ``lm_nemotron``    nemotron-4-340b at full width (d 18432, 96 heads / 8
                       KV at head_dim 192, d_ff 73728, vocab 256000, bf16,
                       squared ReLU, LayerNorm), the depth cut to 2 of 96
                       layers; weights drawn on the card from a seed and
                       quantised once, every plan compiled from the packed
                       tree, one at a time.  The ``cuda`` + ``flash_lut``
                       forward of 2 x 1024 tokens (the attention at
                       head_dim 192 once a layer, the K = 18432 head once),
                       against ``cuda`` + ``xla`` (``LM_FLASH_*``) and
                       ``lut`` + ``flash_lut`` (recorded); prefill + decode
                       against forward (``NEMOTRON_DECODE_REL``; at float32
                       activations ``LM_DECODE_REL``), per-lane == scalar;
                       8 requests on 4 slots through ``LMScheduler``,
                       tokens served == budgets; p50 ms per forward and per
                       decode step, ATen ops per step, peak GB.

19. ``train_lm``       LM training (ROADMAP A3.4): internlm2-1.8b at full
                       width (bf16 params drawn on the card from a seed,
                       remat on as the config sets it) trained by
                       ``repro_torch.launch.train`` for 8 steps of 8 x 256
                       tokens, every loss finite (p50 ms per step,
                       tokens/s, peak memory, ATen ops per step with the
                       backward and AdamW); at float32 (seed 1, 4 x 256
                       tokens) one backward's gradient against a central
                       difference along a seeded direction (``FD_*``) and
                       the loss ``torch.equal`` and the gradients within
                       ``REMAT_GRAD_RTOL`` with remat on and off; the same
                       command under ``--qat --qat-backend cuda`` for 3
                       steps ending in ``qat.export``: the softmax launched
                       exactly twice a layer a step (the forward's, and
                       the backward's rerun of each checkpointed layer,
                       whose STE forward is the kernel), every softmax call
                       of one more step ``torch.equal`` to its plain
                       version and each rerun fed its forward's input;
                       the six smoke configs (internlm2, granite-moe,
                       rwkv6-3b, hymba-1.5b, whisper-large-v3, qwen2.5-14b
                       with int8 moments) one float and one ``cuda`` QAT
                       step each on the card against the CPU on the plain
                       versions (``SMOKE_TRAIN_*``), the card's launches
                       equal to the CPU's wrapper calls (the router's
                       softmax on granite-moe, the GELU on whisper); a
                       smoke LM's QAT run failing at step 5, resumed from
                       step 4 and ``torch.equal`` to an uninterrupted run.
20. ``lm_scores_bf16`` the reference's bf16 score path (``scores_dtype``
                       ``"bfloat16"``: the score product rounded to bf16,
                       the exact softmax in bf16) on ``lm_internlm2``'s
                       weights: a forward of 4 x 63 tokens on ``float``
                       with bf16 and with float32 scores (the logits'
                       max-abs gap and argmax agreement, the p50 of each),
                       and on ``cuda`` the softmax kernel on every layer's
                       bf16-rounded rows ``torch.equal`` to its plain
                       version.
21. ``examples``       the eight example twins (``repro_torch.examples``),
                       each ``main`` in-process on the card with the
                       reference's defaults but: quickstart, stream_kws
                       and cell_flight_drill ``--backend cuda``,
                       train_kws_qat ``--qat-backend cuda
                       --check-backends``, quantize_eval on kwt-tiny and on
                       internlm2-1.8b; each exits 0 (stream_kws hits every
                       keyword, cell_soak's hop ledger is exact,
                       train_kws_qat's export contract holds on ``cuda``),
                       its wall time and printed lines recorded; each
                       twin's launches equal the count worked out from its
                       forwards and steps (the four KWT twins on ``cuda``
                       launch the softmax, the GELU and the matmul; the
                       others launch nothing); the first call of each
                       kernel in the quickstart run ``torch.equal`` to its
                       plain version on the same inputs.
22. ``analysis``       the static-analysis passes (``repro_torch.analysis``)
                       on the card: ``check_engine`` on KWT-Tiny and KWT-1
                       (full width, numpy-seeded weights) under ``float``,
                       ``lut`` and ``cuda`` (``xla`` and ``flash_lut``) and
                       on internlm2-1.8b at full width on ``cuda``
                       (``lm_internlm2``'s weights), each verdict and every
                       pass's metrics equal to the same plan on the CPU
                       (the ``cuda`` plans through their kernels' plain
                       versions); every plan PASS, the integer plans'
                       ``float_leak_count`` 0, KWT-Tiny ``lut`` inside the
                       64 kB gate; each ``cuda`` plan's kernel geometry
                       rows (the launchers' C queries) equal to the CPU's
                       (the Python mirrors); ``float_leak`` and ``unsat_shift`` make their
                       pass FAIL on KWT-Tiny ``lut`` and ``cuda``,
                       ``big_lut`` the budget on ``lut`` (``cuda``: its
                       table is information only); the CLI ``python -m
                       repro_torch.analysis check`` exits 0 clean and 1
                       under each mutation.  Its path's launches are those
                       of ``check_engine`` on the card's ``cuda`` plans:
                       four forwards a KWT plan (residency runs the
                       forward, ``embed_frames`` and ``encode_window``;
                       budget and geometry one forward each), three an LM.
23. ``compress``       the error-feedback compressed gradient sync
                       (``repro_torch.dist.compress``) on the card: the
                       sync of KWT-1's weights and residuals, int8 and
                       int4, per tensor and per channel, ``torch.equal``
                       to the CPU's on the same leaves, with ``Q(c) + e' =
                       c`` exact; internlm2-1.8b at full width trained 3
                       steps of 8 x 256 tokens by ``launch.train
                       --compressed-grads --grad-bits 4
                       --per-channel-scales`` (peak memory, p50 a step, the
                       sync alone timed on the run's weights and residuals),
                       and KWT-1 QAT on ``--qat-backend cuda`` with and
                       without ``--compressed-grads`` (the compressed run
                       is the path; the p50s side by side).
24. ``geometry_mirror`` every launch of the kernel table's untimed checks
                       (3) and of the analysis phase (22), logged by
                       ``kernels._launch.LOG`` (pointers by their
                       alignment), held to its kernel's C geometry query:
                       each wrapper's Python mirror (``geometry``) gives
                       the launcher's grid, threads, shared memory and
                       variant, with the card's occupancy, at every shape;
                       at every wide attention launch the mirror's
                       (item, key tile) steps (``lut_attention.tile_steps``)
                       equal those of the kernel's own item order
                       (``lut_attention_wide_steps``).
                       The log is off in every other phase and inside
                       every timing, so no timed launch pays for it.
25. ``mesh``           the sharded step (ROADMAP A4.2 / A4.3) on a one-rank
                       NCCL mesh ``(data, model) = (1, 1)`` on the card
                       (NCCL refuses two ranks on one card; the multi-rank
                       contract is held over gloo CPU ranks by
                       ``tests/test_torch_mesh.py``): internlm2-1.8b at
                       full width, 2 steps of 8 x 256 through
                       ``launch.train --data 1 --model 1`` (params and
                       optimizer state placed as ``DTensor`` s by their
                       specs) against the same 2 steps off the mesh —
                       losses and every parameter ``torch.equal``, p50 ms
                       a step, peak GB, ATen ops a step side by side;
                       granite-moe-3b-a800m at full width, a prefill of
                       4 x 63 and a decode step through the
                       expert-parallel branch against the local branch
                       (logits and dropped slots equal); KWT-1 QAT on
                       ``--qat-backend cuda`` on the mesh against off it,
                       plain and with ``--compressed-grads`` (the ring
                       over the mesh's data axis), ``torch.equal``.  The
                       mesh runs are the ``mesh`` path.
26. ``dryrun``         the dry run and program pricing (ROADMAP A4.4), on
                       the host's cores beside the card: (a) ``python -m
                       repro_torch.launch.dryrun --mesh single --force``
                       in a subprocess (its fake 512-rank world needs a
                       process of its own), a worker a core, over the 32
                       assigned cells lowered on the (16, 16) production
                       mesh and priced on the H100 model — per cell rank
                       0's peak GB with and without donation, whether
                       each fits 80 GB, the three roofline terms and the
                       dominant one, collective bytes by kind,
                       model_to_hlo and seconds; (b) ``train_lm``'s
                       float step (internlm2-1.8b at full width, 8 x 256)
                       lowered on the one-device mesh
                       (``steps.lower_program`` on meta tensors) beside
                       the card's run of it: ATen ops walked against
                       counted (by name where they differ), the reckoned
                       peak against ``torch.cuda.max_memory_allocated``,
                       the roofline time against the measured p50, with
                       the card's name and power limit.  It fails if the
                       ops differ, if the peak without donation lies
                       over 5 % from the card's, if the roofline lies
                       above the p50, or if the phase takes over its
                       180 s.  It launches no kernel.

   ``lm_dense_smoke`` (14) also runs the rwkv6-3b smoke config (and its
   fused-projection and padded-head variants) and the hymba-1.5b smoke
   config, and 20 tokens of hymba decoded into its ring of 8 slots on the
   card against ``forward`` (the ring wraps twice), and the whisper smoke
   config at module level under the float, lut and cuda plans (decode ==
   forward within the reference's 1e-3, card against CPU), and again on
   the int8 self cache.  The kernel
   phase (3) also holds and times the whisper shapes: the softmax on an
   encoder query chunk ``[40960, 1500]`` and cross rows ``[80, 1500]``,
   the GELU in bf16 at ``[6000, 5120]`` and ``[4, 5120]``, the attention
   ``(4, 20, 20, 1500, 1500, 64)`` at key tiles of 4 (under ``encdec``),
   and nemotron-4-340b's (under ``nemotron``): the head ``[B, 18432] @
   [18432, 256000]`` at B = 4 and 64, float32 and bf16 activations, the
   causal GQA attention ``(2, 96, 8, 1024, 1024, 192)`` in float32 and
   bf16, and the wide attention's edges at D of 136, 192, 200 and 256
   (key tiles of 4, 32 and 128, one query, causal and not, LUT and
   exact; causal Lq < Lk with a last block past Lq, and Lq > Lk, whose
   first rows see no key and must be 0; depths of 131 and 250, off the
   16-byte vectors).  Each attention row carries its launch geometry,
   the kernel instance included, and a wide row ``tile_steps``: the
   (item, key tile) steps its blocks walk, those of a walk over every
   tile and the busiest block's, walked on the host by the kernel's own
   item order (``lut_attention_wide_steps``; the wide kernel skips the
   tiles a causal block cannot see).  Phase 2 reports ptxas' registers,
   spills and stack of each of the wide kernel's eight instances
   (``wide_attention``) and fails without them.

The serve phases (5, 6), the stream phases (7, 8), the cell phases (9, 10),
the train phases (11, 12), the LM server with its ``flash_lut`` forward
(13), the int8-cache scheduler run (``lm_int8_kv``), the moe server
(15), the two recurrent LMs' drain batches (16, 17), the whisper
clips with their ``flash_lut`` forward (18), nemotron's ``flash_lut``
forward and served requests (``lm_nemotron``), the LM launcher's runs
(19: internlm2's float and QAT runs, the smoke LM's three), the
example twins (21) and the mesh runs (25) are the main
paths: the
counters go to 0
just before each group and are read just after it; the launches of the
stream phases' check forwards, of the cell phase's checks (hot-swap's warm
and probe forwards, the refused artifact's, the taps plan's) and of the
train phases' checks (and of the LM phases' checks after their served
runs and of ``train_lm``'s checks) are taken out of their paths' counts, which must then
equal what the steps, hops and runs launched.  Every path's
count must equal what that path is expected to launch (the train path
launches the softmax and the GELU ``n_layers`` times a step and neither
the matmul nor the attention; the LM train path the softmax twice a layer
a step under remat, once without, and nothing else), and every kernel must
be launched by some path.  Any failing phase lets its exception out (non-zero exit); nothing
falls back to the CPU.  Each phase prints one JSON line; the line before
the last is ``{"kernels": [...]}`` with, per kernel, its launches on the
main paths, its error against the plain version and its times; the last
line is ``{"ok": true, "device": {...}}``.

Timing, two figures per call: ``ms``, CUDA events around a run of
back-to-back calls of the wrapper (at the smallest shapes the cost of one
call from Python, not of the arithmetic), and ``device_ms``, the same run
of calls captured once in a CUDA graph and its replays timed with events
(the device's time alone; the capture calls the wrappers, so the launch
counters rise then, before they are reset for the main paths, and not at
replay).  The library call gets both (``library_ms``,
``library_device_ms``).  Median over several runs, after a warm-up;
inputs stay resident (the L2 cache is not flushed: on the main path a
kernel's input was just written by the op before it).

Bounds: the larger of bytes moved (each input read once, each output
written once) over 3.35 TB/s and operations over the peak for their type
(1978.9 TOP/s int8 for the matmul's multiply-adds, 67 TFLOP/s for the
elementwise float32/int32 work; the attention's products, 2 * B * H * D
operations a (query, key) pair the mask lets through for each of QK^T
and P.V, at a third of the TF32 tensor-core rate, 164.9 TFLOP/s — both
kernels take float32 products as 3xTF32 — but in bf16 QK^T at the bf16
rate, exact products, and P.V at a third of it, 329.8 TFLOP/s (p in
three bf16 parts); each attention row also gives the bytes alone,
``bytes_bound_ms``, and both shares of ``device_ms``), the published
rates of an H100 SXM at its full 700 W limit
(``repro_torch.perf.roofline``'s ``H100_*`` constants beside ``H100``;
the per-element operation counts of the softmax and the GELU are
``repro_torch.perf.cost``'s).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import io
import json
import os
import re
import statistics
import tempfile
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import cell as cellmod  # noqa: E402
from repro_torch import convert, perf, qat, runtime, telemetry  # noqa: E402
from repro_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import QuantConfig, ShapeSpec  # noqa: E402
from repro_torch.core import approx, quant  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import geometry as an_geometry  # noqa: E402
from repro_torch.analysis import mutations as an_mutations  # noqa: E402
from repro_torch.analysis.__main__ import main as analysis_cli  # noqa: E402
from repro_torch.dist import compress  # noqa: E402
from repro_torch.kernels import _launch as kernel_launch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import lut_attention as lut_attn  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import stream_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import kwt  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import transformer as lm_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.perf import cost as perf_cost  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402
from repro_torch.qat import train as qat_train  # noqa: E402
from repro_torch.stream import detector  # noqa: E402
from repro_torch.stream import engine as stream  # noqa: E402
from repro_torch.stream import features  # noqa: E402
from repro_torch.telemetry import check as telemetry_check  # noqa: E402

qat_export = importlib.import_module("repro_torch.qat.export")

# the H100 SXM's published rates and the kernels' per-element operation
# counts, from the cost model (repro_torch.perf)
HBM_BYTES_PER_S = roofline.H100_HBM_BW
INT8_OPS_PER_S = roofline.H100_PEAK_OPS_INT8
F32_OPS_PER_S = roofline.H100_PEAK_FLOPS_FP32
BF16_OPS_PER_S = roofline.H100_PEAK_FLOPS_BF16
# float32 products to float32 accuracy on the tensor cores: 3xTF32
TF32X3_OPS_PER_S = roofline.H100_PEAK_FLOPS_TF32 / 3
SOFTMAX_OPS_PER_ELEM = perf_cost.SOFTMAX_OPS_PER_ELEM   # fixed, float
GELU_OPS_PER_ELEM = perf_cost.GELU_OPS_PER_ELEM         # nearest, interp

BATCHES = (1, 8, 64, 4096)
TINY_LUT_ATOL = 2.0 ** -5     # card vs CPU, same plan: one activation LSB
KWT1_LUT_ATOL = 0.5           # 12 layers amplify an LSB flip; see PERF.md
KWT1_MIN_ARGMAX_AGREE = 0.75
CPU_BATCHES = (1, 8)          # batches also answered by the same plan on the CPU

# lut_attention against its plain version, the online softmax over the
# same key tiles (ref.lut_attention_tiled), and, LUT mode, the oracle
ATTN_EXACT_TOL = 2e-5         # rtol and atol, exact mode (the reference's)
ATTN_LUT_ATOL = 0.05          # LUT mode against the oracle: the
                              # reference's own bound
# LUT mode against the tiled version, tight: within
# 1.2e-6 but where a score lands on a 1/32 bin edge, which moves its row
# by up to a few 1e-4 (measured on the card at the KWT shapes, PERF.md:
# 4.9e-4, one row of 99 at KWT-1 B = 1, 99.0 % of elements within 1e-5).  Rescaling
# at other key-tile edges than the reference's leaves about half of the
# elements outside 1e-5 (tests/test_torch_attention.py), so these terms
# hold the kernel to the reference's edges where the keys are several tiles.
# They hold bfloat16 operands too: whisper's encoder shape at key tiles of 4
# measured 9.8e-4 / 0.99933 on random and 3.9e-3 / 0.99982 on the model's
# own q, k, v (PERF.md).
ATTN_TIGHT_ATOL = 0.01
ATTN_TIGHT_MIN_SHARE = 0.98   # share of elements within 1e-5
# cuda + flash_lut logits against lut + flash_lut (kernel vs plain
# attention, then the same integer pipeline), card and CPU alike; measured
# (PERF.md): KWT-Tiny 0.0 at every batch, KWT-1 0.0 at B = 1 and 0.1455
# at B = 64 (argmax agreement 0.969, 2 of 64 rows) — an attention output
# moved one activation LSB and 11 layers amplified it.  KWT-1's limits are
# about twice the measured distance, and 4 of 64 rows.
FLASH_TINY_ATOL = 2.0 ** -5   # one activation LSB
FLASH_KWT1_ATOL = 0.3
FLASH_KWT1_MIN_ARGMAX_AGREE = 0.9


def emit(obj) -> None:
    """One JSON line on standard output; also appended to the file named
    by ``$CHIP_SMOKE_OUT`` when that is set (the lines are long)."""
    line = json.dumps(obj)
    print(line, flush=True)
    path = os.environ.get("CHIP_SMOKE_OUT")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")


# the launches phase 24 holds to their geometry queries
GEO_LOG: set = set()


@contextlib.contextmanager
def launch_log(on: bool):
    """Inside the block every launch is logged into GEO_LOG (``on``) or
    none is: the log is on around the untimed checks of the kernel table
    and the analysis phase only, and off inside every timing."""
    prev = kernel_launch.LOG
    kernel_launch.LOG = GEO_LOG if on else None
    try:
        yield
    finally:
        kernel_launch.LOG = prev


@launch_log(False)
def time_ms(fn, numel_hint: int) -> float:
    """Median milliseconds of one call: events around runs of calls."""
    per_run = 20 if numel_hint < (1 << 22) else 4
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) / per_run)
    return statistics.median(runs)


@launch_log(False)
def device_ms(fn, numel_hint: int) -> float:
    """Median milliseconds of one call on the device alone: a run of calls
    captured in a CUDA graph, the replays timed with events.  The wrappers
    launch on the current stream, which under capture is the capturing
    one."""
    per_run = 20 if numel_hint < (1 << 22) else 4
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_run):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) / per_run)
    graph.reset()
    return statistics.median(runs)


def timings(fn, plain, library, numel_hint: int) -> dict:
    """The wrapper's, the plain version's and the library call's times."""
    return {"ms": time_ms(fn, numel_hint),
            "device_ms": device_ms(fn, numel_hint),
            "plain_ms": time_ms(plain, numel_hint),
            "library_ms": time_ms(library, numel_hint),
            "library_device_ms": device_ms(library, numel_hint)}


def bound(nbytes: int, nops: float, ops_per_s: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def require_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.equal(got, want):
        raise AssertionError(
            f"{what}: kernel differs from its plain version "
            f"(max abs err {max_abs_err(got, want)}, dtypes {got.dtype}/"
            f"{want.dtype}, shapes {tuple(got.shape)}/{tuple(want.shape)})")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    # Full float32: TF32 in the score product would move logits far beyond
    # every tolerance below, and the exact-integer float32 products of the
    # plain versions need every mantissa bit.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0)),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvidia_smi": smi,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}
    emit(info)
    return info


def wide_instances(lines) -> list:
    """ptxas' report (``-Xptxas -v``) of each instance of the wide
    attention kernel (``attn_wide_kernel<DT, NT, bf16>``): registers,
    spill stores and loads, stack frame and static shared memory, in
    bytes."""
    out, cur = [], None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            w = re.search(r"attn_wide_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          m.group(1))
            cur = None
            if w:
                dtype = "bf16" if w.group(3) == "1" else "float32"
                cur = {"kernel": f"attn_wide_kernel<{w.group(1)}, "
                                 f"{w.group(2)}, {dtype}>"}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            sm = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m.group(1)),
                       smem_static=int(sm.group(1)) if sm else 0)
            cur = None
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load()
    log = build.build_dir() / "build.log"
    lines = log.read_text().splitlines() if log.exists() else []
    used = [ln.strip() for ln in lines
            if "Used" in ln and "registers" in ln]
    wide = wide_instances(lines)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "nvcc_seconds": None if build.build_seconds is None
          else round(build.build_seconds, 2),
          "library": str(build.build_dir() / "libkernels.so"),
          "sources": [str(s.relative_to(Path(__file__).resolve().parent))
                      for s in build.sources()],
          "wide_attention": wide, "ptxas": used})
    if not log.exists():
        raise AssertionError(f"no ptxas report at {log}")
    if len(wide) != 8:
        raise AssertionError(f"ptxas reported {len(wide)} instances of "
                             "attn_wide_kernel, not 8")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def model_shapes(cfg, b: int) -> dict:
    """The shapes the main path hands each kernel for a batch of ``b``."""
    f, t = cfg.input_dim
    s, d, dh, ff = t + 1, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"softmax": (b * s, s), "gelu": (b * s, ff),
            "attention": (b, h, kv, s, s, dh),
            "matmul": [("proj", b * t, f, d), ("qkv", b * s, d, dh),
                       ("wo", b * s, dh, d), ("w1", b * s, d, ff),
                       ("w2", b * s, ff, d), ("head", b, d, cfg.n_classes)]}


def check_softmax(dev, gen, m, n, fixed, timed, offset=0):
    """``offset`` > 0: ``x`` is a contiguous view that starts ``offset``
    floats into a buffer, so not on a 16-byte boundary."""
    buf = torch.randn((m * n + offset,), generator=gen, device=dev) * 4.0
    x = buf[offset:].view(m, n)
    if offset and x.data_ptr() % 16 == 0:
        raise AssertionError(f"offset {offset}: the view is 16-byte aligned")
    if m > 2 and n > 1:
        x[0] = 0.0                                      # flat row, largest sum
        x[1, 0] = 60.0                                  # one dominant lane
    got, want = ops.lut_softmax(x, fixed=fixed), ref.lut_softmax(x, fixed=fixed)
    row = {"variant": "fixed" if fixed else "float", "shape": [m, n],
           "slab_rows": slab_rows(n, x.data_ptr() % 16 == 0),
           "equal": True, "max_abs_err": require_equal(
               f"lut_softmax fixed={fixed} {m}x{n} offset {offset}", got, want)}
    if offset:
        row["offset"] = offset
    del got, want
    if timed:
        nbytes = 2 * 4 * m * n + perf_cost.SOFTMAX_LUT_BYTES
        b_ms, by = bound(nbytes, SOFTMAX_OPS_PER_ELEM[fixed] * m * n, F32_OPS_PER_S)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
            lambda: ops.lut_softmax(x, fixed=fixed),
            lambda: ref.lut_softmax(x, fixed=fixed),
            lambda: torch.softmax(x, dim=-1), m * n))
    return row


def check_gelu(dev, gen, shape, interp, dtype, timed, offset=0):
    """``offset`` > 0: ``x`` is a contiguous view that starts ``offset``
    elements into a buffer, so not on a 16-byte boundary."""
    numel = int(np.prod(shape))
    buf = (torch.randn((numel + offset,), generator=gen, device=dev) * 3.0).to(dtype)
    x = buf[offset:].view(shape)
    if offset and x.data_ptr() % 16 == 0:
        raise AssertionError(f"offset {offset}: the view is 16-byte aligned")
    flat = x.reshape(-1)
    edges = torch.tensor([-1.857, 1.595, -1.8570001, 1.5950001, 0.0, -10.0, 10.0],
                         device=dev).to(dtype)
    flat[:min(7, flat.numel())] = edges[:flat.numel()]
    got, want = ops.lut_gelu(x, interp=interp), ref.lut_gelu(x, interp=interp)
    name = str(dtype).split(".")[1]
    row = {"variant": "interp" if interp else "nearest", "dtype": name,
           "shape": list(shape), "equal": True, "max_abs_err": require_equal(
               f"lut_gelu interp={interp} {name} {shape} offset {offset}",
               got, want)}
    if offset:
        row["offset"] = offset
    del got, want
    if timed:
        nbytes = 2 * x.element_size() * numel + perf_cost.GELU_LUT_BYTES
        b_ms, by = bound(nbytes, GELU_OPS_PER_ELEM[interp] * numel, F32_OPS_PER_S)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
            lambda: ops.lut_gelu(x, interp=interp),
            lambda: ref.lut_gelu(x, interp=interp),
            lambda: torch.nn.functional.gelu(x), numel))
    return row


def _rand_i8(gen, shape, dev, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


def matmul_activations(gen, m, k, dev, bits=8):
    """Float activations for the fused eq-9 quantiser: normal values, and
    in front the quantiser's edges — exact .5 ties (``x * 2^5 + 0.5`` an
    integer), values just inside and beyond the clip edges, and far
    beyond them."""
    x = torch.randn((m, k), generator=gen, device=dev) * 2.0
    lo, hi = quant.int_range(bits)
    s = 2.0 ** 5
    edges = torch.tensor([0.5 / s, -0.5 / s, 1.5 / s, -1.5 / s, (hi + 0.5) / s,
                          (lo - 0.5) / s, (hi - 0.5) / s, (lo + 0.5) / s,
                          (hi + 1) / s, (lo - 1) / s, 1e6, -1e6], device=dev)
    flat = x.view(-1)
    flat[:min(edges.numel(), flat.numel())] = edges[:flat.numel()]
    return x


def matmul_library(x_int, grid, numel_hint: int, float_dtype=torch.float32
                   ) -> dict:
    """The library calls beside the matmul: ``torch._int_mm`` (the same
    int8 x int8 -> int32 product; where it refuses the shape, its error
    text) and ``torch.matmul`` over the same integer grids in
    ``float_dtype`` (float32, or bfloat16 for the LM's head, whose
    activation is bf16); ``library_ms`` / ``library_device_ms`` are the
    faster of the two on the device, ``library_call`` names it."""
    out = {}
    try:
        torch._int_mm(x_int, grid)
        torch.cuda.synchronize()
        out.update(int_mm_ms=time_ms(lambda: torch._int_mm(x_int, grid),
                                     numel_hint),
                   int_mm_device_ms=device_ms(
                       lambda: torch._int_mm(x_int, grid), numel_hint))
    except RuntimeError as e:
        out["int_mm_error"] = str(e).splitlines()[0][:200]
    xf, wf = x_int.to(float_dtype), grid.to(float_dtype)
    fm = "f32_matmul" if float_dtype == torch.float32 else "bf16_matmul"
    out.update({f"{fm}_ms": time_ms(lambda: torch.matmul(xf, wf), numel_hint),
                f"{fm}_device_ms": device_ms(lambda: torch.matmul(xf, wf),
                                             numel_hint)})
    del xf, wf
    best = fm
    if "int_mm_device_ms" in out and \
            out["int_mm_device_ms"] <= out[f"{fm}_device_ms"]:
        best = "int_mm"
    out.update(library_call={"int_mm": "torch._int_mm",
                             "f32_matmul": "torch.matmul (float32)",
                             "bf16_matmul": "torch.matmul (bfloat16)"}[best],
               library_ms=out[f"{best}_ms"],
               library_device_ms=out[f"{best}_device_ms"])
    return out


def check_matmul(dev, gen, tag, m, k, n, *, bits=8, per_channel=False,
                 residual_bits=16, x_float=False, axis_range=(-2, 3),
                 timed=False, x_dtype=torch.float32):
    """The f32-epilogue mode through the public wrapper, QTensor weight
    (an int4 one nibble-packed, unpacked by the kernel), the activation
    as int8 or (``x_float``) as float32 quantised by the kernel; against
    the plain version of the same input modes (``quantize_act``, then
    ``unpack_po2``, then the integer matmul), ``torch.equal``."""
    lo, hi = quant.int_range(bits)
    x = matmul_activations(gen, m, k, dev).to(x_dtype) if x_float else \
        _rand_i8(gen, (m, k), dev)
    grid = _rand_i8(gen, (k, n), dev, lo, hi + 1)
    axis = _rand_i8(gen, (n,), dev, *axis_range) if per_channel else None
    w = quant.QTensor.store(grid, 6, bits=bits, axis_exponents=axis)
    w_shape = w.logical_shape if w.packed else None
    got = ops.int8_matmul(x, w, x_exp=5, residual_bits=residual_bits)

    def plain():
        # the wrapper casts a bf16 activation to float32 before the launch
        return ref.int8_matmul_io(x.float() if x_float else x, w.values,
                                  shift=0,
                                  clip16=residual_bits == 16, out_exp=11,
                                  axis_exponents=axis, x_exp=5,
                                  w_shape=w_shape)

    want = plain()
    row = {"variant": f"f32 int{bits}" + (" per-channel" if per_channel else "")
           + f" residual{residual_bits}" + (" float-x" if x_float else "")
           + (" bf16-x" if x_dtype == torch.bfloat16 else ""),
           "tag": tag, "shape_mkn": [m, k, n], "input": (
               "bfloat16 x, cast to float32 and quantised in the kernel"
               if x_dtype == torch.bfloat16 else "float32 x, quantised in "
               "the kernel") if x_float else "int8 x",
           "equal": True, "max_abs_err": require_equal(
               f"int8_matmul {tag} {(m, k, n)} int{bits} pc={per_channel} "
               f"rb={residual_bits} float_x={x_float}", got, want)}
    if residual_bits == 16 and k >= 8 and not per_channel:
        row["clip_hit"] = bool((want.abs() >= 32767 * 2.0 ** -11).any())
    del got, want
    if timed:
        nbytes = (x.element_size() if x_float else 1) * m * k \
            + w.values.numel() + 4 * m * n + (n if per_channel else 0)
        b_ms, by = bound(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        x_int = quant.quantize_act(x, 5).to(torch.int8) if x_float else x
        hint = m * max(k, n)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by,
                   ms=time_ms(lambda: ops.int8_matmul(
                       x, w, x_exp=5, residual_bits=residual_bits), hint),
                   device_ms=device_ms(lambda: ops.int8_matmul(
                       x, w, x_exp=5, residual_bits=residual_bits), hint),
                   plain_ms=time_ms(plain, hint),
                   **matmul_library(x_int, grid, hint, float_dtype=x_dtype
                                    if x_float else torch.float32))
    return row


def check_matmul_raw(dev, gen, m, k, n, shift, out_int16):
    x, w = _rand_i8(gen, (m, k), dev), _rand_i8(gen, (k, n), dev)
    got = ops.int8_matmul_raw(x, w, shift=shift, out_int16=out_int16)
    want = ref.int8_matmul_raw(x, w, shift=shift, out_int16=out_int16)
    return {"variant": "raw int16" if out_int16 else "raw int32",
            "shape_mkn": [m, k, n], "shift": shift, "equal": True,
            "max_abs_err": require_equal(
                f"int8_matmul_raw {(m, k, n)} shift={shift} i16={out_int16}",
                got, want)}


def check_attention(dev, gen, shape, causal, use_lut, *, dtype=torch.float32,
                    timed=False, exact_vs_oracle=True, strided=False,
                    qkv=None):
    """The wrapper against its plain version ``ref.lut_attention_tiled`` at
    the wrapper's key tile and against the reference's oracle
    ``ref.lut_attention``, on the same CUDA tensors.  ``shape`` = (b, hq,
    hkv, lq, lk, d).  The exact mode keeps the reference kernel's clip of
    ``m - s`` at 10, which the oracle lacks: ``exact_vs_oracle=False``
    where rows spread wider.
    ``strided``: q, k, v are views of ``[B, L, H, D]`` tensors transposed,
    as the layer passes them, and the output must be laid out so that the
    layer's ``transpose(1, 2).reshape(B, L, H * D)`` is a view.  ``qkv``:
    a model's own (q, k, v) in place of random ones.  The LUT mode is held
    to the tight terms against the tiled version and to the reference's
    0.05 against the oracle, in float32 and bfloat16 alike; ``plain_ms``
    times the tiled version."""
    b, hq, hkv, lq, lk, d = shape
    if qkv is not None:
        q, k, v = qkv
        dtype = q.dtype
    elif strided:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   .transpose(1, 2)
                   for s in ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d)))
    else:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    mode = "lut" if use_lut else "exact"
    block_k = ops.fit_block(lk, ops.ATTN_BLOCK_K)
    got = ops.lut_attention(q, k, v, causal=causal, use_lut=use_lut)
    if strided and got.transpose(1, 2).reshape(b, lq, hq * d).data_ptr() \
            != got.data_ptr():
        raise AssertionError(f"lut_attention {shape}: the output of strided "
                             "operands is not laid out [B, L, H, D]")
    want = ref.lut_attention_tiled(q, k, v, causal=causal, use_lut=use_lut,
                                   block_k=block_k)
    oracle = ref.lut_attention(q, k, v, causal=causal, softmax_mode=mode)
    oracle_err = max_abs_err(got, oracle)
    torch.cuda.synchronize()
    what = f"lut_attention {mode} causal={causal} {shape} {dtype}"
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} out")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    share = float((diff <= 1e-5).double().mean()) if diff.numel() else 1.0
    if use_lut:
        ok = err <= ATTN_TIGHT_ATOL and share >= ATTN_TIGHT_MIN_SHARE \
            and oracle_err <= ATTN_LUT_ATOL
    elif dtype == torch.float32:
        ok = all(bool(torch.allclose(got, w, rtol=ATTN_EXACT_TOL,
                                     atol=ATTN_EXACT_TOL))
                 for w in ((want, oracle) if exact_vs_oracle else (want,)))
    else:
        raise ValueError(f"{what}: the exact mode has terms in float32 only")
    if not ok:
        raise AssertionError(f"{what}: max abs err {err}, share within "
                             f"1e-5 {share} (tiled version), max abs err "
                             f"{oracle_err} (oracle)")
    # causal with Lq > Lk: the first Lq - Lk rows see no key, and are 0
    unseen = max(0, lq - lk) if causal else 0
    if unseen and bool(got[:, :, :unseen].any()):
        raise AssertionError(f"{what}: a row that sees no key is not 0")
    row = {"variant": mode + (" causal" if causal else "")
           + (" strided" if strided else ""),
           "dtype": str(dtype).split(".")[1], "shape_bhhlld": list(shape),
           "block_k": block_k, "equal": False,
           # (grid, threads, shared memory, kernel instance) of the launch
           "geometry": an_geometry.c_query(
               "lut_attention", (b, hq, hkv, lq, lk, d, block_k))[1],
           "max_abs_err": err, "within_1e-5": share,
           "oracle_max_abs_err": oracle_err}
    if unseen:
        row["rows_seeing_no_key"] = unseen
    if d > lut_attn.NARROW_D:
        # the wide kernel's (item, key tile) steps: those its blocks walk,
        # those of a walk over every tile, the busiest block's, by the
        # kernel's own item order (phase geometry_mirror holds the Python
        # mirror to it)
        row["tile_steps"] = an_geometry.c_wide_steps(
            (b, hq, hkv, lq, lk, d, block_k, int(causal)))
    del got, want, oracle, diff
    if timed:
        nbytes = q.element_size() * (2 * b * hq * lq * d + 2 * b * hkv * lk * d) \
            + perf_cost.EXP_LUT_BYTES
        # the (query, key) pairs the inputs need: under a causal mask
        # (queries right-aligned) query i sees min(lk, i + 1 + lk - lq) keys
        pairs = lq * lk if not causal else sum(
            max(0, min(lk, i + 1 + lk - lq)) for i in range(lq))
        # QK^T and P.V, 2 * d operations a pair each.  float32 products
        # are taken to float32 accuracy on the tensor cores as 3xTF32 (both
        # kernels): a third of the TF32 rate.  bf16 q and k multiply
        # exactly with a float32 sum, so QK^T may run at the bf16 rate;
        # P.V keeps p at float32 accuracy against bf16 v, p = hi + mid +
        # lo in three bf16 products (the wide kernel): a third of it
        bf16 = q.dtype == torch.bfloat16
        qk_rate = BF16_OPS_PER_S if bf16 else TF32X3_OPS_PER_S
        pv_rate = BF16_OPS_PER_S / 3 if bf16 else TF32X3_OPS_PER_S
        pv = 2.0 * b * hq * pairs * d
        b_ms, by = bound(nbytes, pv * (1.0 + pv_rate / qk_rate), pv_rate)
        numel = b * hq * lq * lk
        row["pairs_per_head"] = pairs

        def sdpa(q, k, v, is_causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=is_causal, enable_gqa=hq != hkv)
        # the bytes alone, beside the float32 operations bound kept from
        # the first slices: what a tensor-core design is held to
        row.update(bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
            lambda: ops.lut_attention(q, k, v, causal=causal, use_lut=use_lut),
            lambda: ref.lut_attention_tiled(q, k, v, causal=causal,
                                            use_lut=use_lut, block_k=block_k),
            lambda: sdpa(q, k, v, is_causal=causal), numel))
        # the shares of the device time that the two bounds are
        row.update(bound_share=b_ms / row["device_ms"],
                   bytes_bound_share=row["bytes_bound_ms"] / row["device_ms"])
    return row


def slab_rows(n: int, aligned: bool) -> int:
    """The softmax launcher's rows per slab for rows of ``n`` floats at a
    16-byte aligned base or not, 0 for its global path."""
    return build.load().lut_softmax_slab_rows(n, int(aligned))


def max_slab_n() -> int:
    """The longest row the softmax's slab path takes."""
    n = 1
    while slab_rows(n + 1, True):
        n += 1
    return n


def softmax_edge_shapes() -> list:
    """(m, n, offset): the first ragged list, then for each row length the
    slab path's edges at its rows per slab R — one row, M < R, M = R, a
    short last slab either side of 3 R, and 40000 R + 1 (every warp walks
    several slabs, round its ring of stages more than once); rows of
    <= 16 floats, several to a warp; the slab limit and one
    above it (the global path); views that start off a 16-byte boundary
    (the global path)."""
    shapes = [(m, n, 0) for m, n in ((1000, 1000), (7, 1), (1, 1), (5, 4099),
                                     (33, 65), (3, 16384))]
    limit = max_slab_n()
    for n in (1, 3, 8, 13, 16, 17, 27, 64, 99, limit):
        r = slab_rows(n, True)
        shapes += [(m, n, 0) for m in (1, r - 1, r, 3 * r - 1, 3 * r + 1,
                                       40000 * r + 1)]
    n = limit + 1
    shapes += [(4, n, 0), (9, n, 0), (40001, n, 0)]
    shapes += [(81, 99, 1), (300, 13, 2), (9, limit, 3),
               (1000, 27, 1)]
    return shapes


def gelu_edge_shapes() -> list:
    """(shape, dtype, offset): the first ragged list in both dtypes, then
    lengths that leave 1, 3 and 7 elements past the last whole vector
    (4 f32 or 8 bf16 a vector), among them arrays shorter than a vector
    and a bf16 array of many thousand blocks, and views that start off a
    16-byte boundary, among them views that end before the next boundary
    (all head, no whole vector)."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(s, d, 0) for s in ((3, 5), (1,), (257, 33), (1000003,))
              for d in (f32, bf16)]
    shapes += [((n,), f32, 0) for n in (3, 4097, 4099, 65543)]
    shapes += [((n,), bf16, 0) for n in (7, 8193, 8195, 8199, 8650759)]
    shapes += [((4099,), f32, o) for o in (1, 2, 3)]
    shapes += [((12345,), bf16, o) for o in (1, 3, 7)]
    shapes += [((3,), bf16, 5), ((37, 11), f32, 2)]
    shapes += [((2,), f32, 1), ((1,), f32, 3), ((2,), f32, 2),
               ((3,), bf16, 1), ((6,), bf16, 1), ((1,), bf16, 7)]
    return shapes


# the reference's sweep (tests/test_kernels.py): MHA, GQA, MQA, decode and
# the multi-tile long key axis; then ragged shapes
ATTN_SWEEP = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 64, 64, 32),
              (1, 8, 1, 128, 128, 64), (2, 4, 2, 1, 64, 32),
              (1, 2, 2, 64, 256, 32)]
ATTN_RAGGED = [(3, 2, 1, 27, 27, 8), (1, 2, 2, 30, 1000, 32),
               (2, 2, 1, 27, 27, 72), (1, 4, 2, 40, 20, 16)]
# key tiles of 8, 27 and 99 keys (fit_block(1000, 128) = 8) against depths
# of 8, 64 and 72: a partial fragment of keys, one of depth, both, GQA
ATTN_BK_D = [(2, 2, 1, lq, lk, d) for lq, lk in ((30, 1000), (27, 27),
                                                 (99, 99))
             for d in (8, 64, 72)]
# int4 payloads with an odd K * N (a padded last nibble)
MATMUL_ODD = [(7, 13, 9), (100, 99, 35), (3, 1, 1), (6272, 40, 63)]


def phase_kernels(dev, configs) -> dict:
    """Returns, per kernel, its checked-and-timed rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"lut_softmax": [], "lut_gelu": [], "int8_matmul": [],
            "lut_attention": []}
    for cfg in configs:
        for b in BATCHES:
            sh = model_shapes(cfg, b)
            # the LUT mode is the one the main path runs, and is timed
            for use_lut in (True, False):
                r = check_attention(dev, gen, sh["attention"], False, use_lut,
                                    timed=use_lut, exact_vs_oracle=False)
                rows["lut_attention"].append(
                    {"model": cfg.name, "batch": b, **r})
            for fixed in (True, False):
                r = check_softmax(dev, gen, *sh["softmax"], fixed, timed=True)
                rows["lut_softmax"].append({"model": cfg.name, "batch": b, **r})
            for interp in (False, True):
                r = check_gelu(dev, gen, sh["gelu"], interp, torch.float32, True)
                rows["lut_gelu"].append({"model": cfg.name, "batch": b, **r})
            # the layer's strided views, held to the same terms
            r = check_attention(dev, gen, sh["attention"], False, True,
                                strided=True)
            rows["lut_attention"].append({"model": cfg.name, "batch": b, **r})
            for tag, m, k, n in sh["matmul"]:
                # the float activation is what the cuda plans pass (timed
                # as the main path's); the int8 one is int8_matmul_raw's
                # and a QTensor activation's input, timed beside it
                for x_float in (True, False):
                    r = check_matmul(dev, gen, tag, m, k, n, x_float=x_float,
                                     timed=True)
                    rows["int8_matmul"].append(
                        {"model": cfg.name, "batch": b, **r})
                if cfg.n_layers > 1:    # the int4 per-channel plan served below
                    r = check_matmul(dev, gen, tag, m, k, n, bits=4,
                                     per_channel=True, x_float=True,
                                     timed=True)
                    rows["int8_matmul"].append(
                        {"model": cfg.name, "batch": b, **r})
    # ragged shapes, the edges of the softmax's slab path and of the GELU's
    # vectors, and the options the main path does not take
    for m, n, offset in softmax_edge_shapes():
        for fixed in (True, False):
            rows["lut_softmax"].append(
                check_softmax(dev, gen, m, n, fixed, False, offset))
    for shape, dtype, offset in gelu_edge_shapes():
        for interp in (False, True):
            rows["lut_gelu"].append(
                check_gelu(dev, gen, shape, interp, dtype, False, offset))
    for m, k, n in [(33, 17, 5), (257, 256, 35), (1, 1, 1),
                    (64, 300, 129)] + MATMUL_ODD:
        for bits, pc in ((8, False), (8, True), (4, False), (4, True)):
            for rb in (16, 32):
                for x_float in (False, True):
                    # per-channel exponents over -8..8 in both input modes
                    rows["int8_matmul"].append(check_matmul(
                        dev, gen, "ragged", m, k, n, bits=bits,
                        per_channel=pc, residual_bits=rb, x_float=x_float,
                        axis_range=(-8, 9)))
        for shift, i16 in ((0, False), (5, False), (5, True), (0, True),
                           (-3, False), (-9, True)):
            rows["int8_matmul"].append(
                check_matmul_raw(dev, gen, m, k, n, shift, i16))
    for shape in ATTN_SWEEP + ATTN_RAGGED:
        for causal in (True, False):
            for use_lut in (True, False):
                rows["lut_attention"].append(
                    check_attention(dev, gen, shape, causal, use_lut))
    for shape in ATTN_BK_D:
        for causal, use_lut in ((True, True), (False, True), (False, False)):
            for strided in (False, True):
                rows["lut_attention"].append(check_attention(
                    dev, gen, shape, causal, use_lut, strided=strided))
    for causal in (True, False):
        rows["lut_attention"].append(check_attention(
            dev, gen, (1, 2, 2, 32, 32, 32), causal, True,
            dtype=torch.bfloat16))
    lm_kernel_rows(dev, gen, rows)
    emit({"phase": "kernels", "all_checks_passed": True,
          "checks": {k: len(v) for k, v in rows.items()}, "rows": rows})
    return rows

# the dense LM's shapes (internlm2-1.8b at full width): the head's
# [B, 2048] @ [2048, 92544] at a decode step of 4 slots and at 64 rows, a K
# that is not a multiple of 32, and the MLP's K = 8192; masked softmax rows
# of a decode step (per-lane validity) and of a prefill (causal); the
# flash-LUT attention's causal GQA at D = 128
LM_NAME = "internlm2-1.8b"
LM_HEAD_ROWS = (4, 64)
# (tag, M, K, N, weight bits); the int4 rows and N = 300 take the K loop's
# byte-by-byte weight staging, the others its 16-byte cp.async
LM_MATMUL_EXTRA = [("ragged_k", 5, 1000, 300, 8), ("k8192", 4, 8192, 2048, 8),
                   ("k8192", 64, 8192, 2048, 8), ("int4_k", 64, 2048, 1024, 4),
                   ("int4_odd_kn", 3, 301, 7, 4)]
LM_SOFTMAX_SK = (33, 256, 1024)
LM_SLOTS = 4
LM_ATTENTION = (2, 16, 8, 1024, 1024, 128)
# the moe router's rows (granite-moe-3b-a800m, 40 experts, unmasked Q8.24):
# a decode step of 4 slots and a join prefill of 4 x 63 tokens
MOE_NAME = "granite-moe-3b-a800m"
MOE_ROUTER_ROWS = (LM_SLOTS, LM_SLOTS * 63)
# the recurrent LMs' drain batch (phases lm_rwkv6 and lm_hymba): 4 lanes,
# prompts of 63 tokens, 64 decode steps, a decode state of 128 slots (for
# hymba a ring of min(128, 2048) slots)
RWKV_NAME = "rwkv6-3b"
HYMBA_NAME = "hymba-1.5b"
RECURRENT_LANES = 4
RECURRENT_PROMPT = 63
RECURRENT_STEPS = 64
RECURRENT_SLOTS = 128
# the encoder-decoder (phase lm_whisper): 4 clips of the stub frontend's
# frames [4, 1500, 1280], a 4-token prompt, 60 greedy decode steps, caches
# of 64 slots; the encoder's score rows come in query chunks of
# layers.Q_CHUNK (512) against all 1500 keys, and its flash-LUT attention
# takes key tiles of fit_block(1500, 128) = 4
WHISPER_NAME = "whisper-large-v3"
WHISPER_CLIPS = 4
WHISPER_PROMPT = 4
WHISPER_STEPS = 60
WHISPER_MAX_LEN = 64


def masked_plain(s, mask):
    """``approx.masked_softmax(s, mask, mode="cuda")`` with the kernel's
    plain version in the kernel's place."""
    sm = torch.where(mask, s, torch.finfo(torch.float32).min)
    out = torch.where(mask, ref.lut_softmax(sm, fixed=True), 0.0)
    return out / out.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def check_masked_softmax(dev, gen, kind, sk, groups, lanes, model=LM_NAME,
                         sq=None):
    """The cuda masked softmax (``approx.masked_softmax(mode="cuda")``: the
    kernel on the masked scores, then zeroed and renormalised) against the
    same with the kernel's plain version, on the card, ``torch.equal``.
    ``groups``: (KV heads, queries per KV head).  ``causal``: one prefill
    of ``sq`` queries (default ``sk``) against ``sk`` keys; ``per_lane``: one decode query
    per lane against a cache of ``sk`` slots, each lane valid up to its
    own depth; ``ring``: one decode query per lane against a ring of
    ``sk`` slots, every lane valid up to one shared bound (hybrid)."""
    sq = (sq or sk) if kind == "causal" else 1
    kv, g = groups
    s = torch.randn((lanes, kv, g, sq, sk), generator=gen,
                    device=dev) * 3.0
    kpos = torch.arange(sk, device=dev)
    if kind == "causal":
        mask = (torch.arange(sq, device=dev)[:, None] >= kpos)[None, None, None]
    elif kind == "ring":
        mask = (kpos < sk // 2 + 1)[None, :].expand(sq, sk)[None, None, None]
    else:
        depth = torch.randint(1, sk + 1, (lanes,), generator=gen, device=dev)
        mask = (kpos < depth[:, None, None]).expand(lanes, sq, sk)[:, None, None]
    got = approx.masked_softmax(s, mask, mode="cuda")
    sm = torch.where(mask, s, torch.finfo(torch.float32).min)

    def plain():
        return masked_plain(s, mask)

    row = {"variant": f"fixed masked {kind}", "model": model,
           "shape": [s.numel() // sk, sk], "equal": True,
           "max_abs_err": require_equal(f"masked lut_softmax {kind} sk={sk}",
                                        got, plain())}
    m, n = s.numel() // sk, sk
    x = sm.reshape(m, n)
    nbytes = 2 * 4 * m * n + perf_cost.SOFTMAX_LUT_BYTES
    b_ms, by = bound(nbytes, SOFTMAX_OPS_PER_ELEM[True] * m * n, F32_OPS_PER_S)
    row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
        lambda: ops.lut_softmax(x, fixed=True),
        lambda: ref.lut_softmax(x, fixed=True),
        lambda: torch.softmax(x, dim=-1), m * n))
    return row


def lm_kernel_rows(dev, gen, rows) -> None:
    """The kernels at the dense LM's shapes and the moe router's, appended
    to ``rows``."""
    cfg = registry.get(LM_NAME).config
    d, v = cfg.d_model, cfg.padded_vocab
    for m in LM_HEAD_ROWS:
        for x_dtype in (torch.float32, torch.bfloat16):
            r = check_matmul(dev, gen, "lm_head", m, d, v, per_channel=True,
                             x_float=True, axis_range=(-8, 9), timed=True,
                             x_dtype=x_dtype)
            rows["int8_matmul"].append({"model": LM_NAME, "batch": m, **r})
    for tag, m, k, n, bits in LM_MATMUL_EXTRA:
        r = check_matmul(dev, gen, tag, m, k, n, bits=bits, per_channel=True,
                         x_float=True, axis_range=(-8, 9), timed=True)
        rows["int8_matmul"].append({"model": LM_NAME, "batch": m, **r})
    for sk in LM_SOFTMAX_SK:
        for kind in ("causal", "per_lane"):
            rows["lut_softmax"].append(check_masked_softmax(
                dev, gen, kind, sk, (cfg.n_kv_heads,
                                     cfg.n_heads // cfg.n_kv_heads),
                LM_SLOTS))
    r = check_attention(dev, gen, LM_ATTENTION, True, True, timed=True,
                        strided=True)
    rows["lut_attention"].append({"model": LM_NAME, "batch": LM_ATTENTION[0],
                                  **r})
    experts = registry.get(MOE_NAME).config.n_experts
    for m in MOE_ROUTER_ROWS:
        r = check_softmax(dev, gen, m, experts, True, timed=True)
        rows["lut_softmax"].append({**r, "model": MOE_NAME, "batch": m,
                                    "variant": "fixed router"})
    # the recurrent LMs: the heads at a decode step of 4 lanes, hymba's
    # masked softmax rows (prefill and ring decode)
    for name in (RWKV_NAME, HYMBA_NAME):
        rc = registry.get(name).config
        for x_dtype in (torch.float32, torch.bfloat16):
            r = check_matmul(dev, gen, "lm_head", RECURRENT_LANES, rc.d_model,
                             rc.padded_vocab, per_channel=True, x_float=True,
                             axis_range=(-8, 9), timed=True, x_dtype=x_dtype)
            rows["int8_matmul"].append({"model": name,
                                        "batch": RECURRENT_LANES, **r})
    hc = registry.get(HYMBA_NAME).config
    for kind in ("causal", "ring"):
        # the prefill's 63 queries and the decode step's one, against the
        # ring's 128 slots
        rows["lut_softmax"].append({**check_masked_softmax(
            dev, gen, kind, RECURRENT_SLOTS,
            (hc.n_kv_heads, hc.n_heads // hc.n_kv_heads), RECURRENT_LANES,
            HYMBA_NAME, sq=RECURRENT_PROMPT), "batch": RECURRENT_LANES})
    whisper_kernel_rows(dev, gen, rows)
    nemotron_kernel_rows(dev, gen, rows)


# the wide attention kernel's edges (128 < D <= 256, phase kernels): depths
# either side of its two builds (DT 24 up to 192, DT 32 up to 256) against
# key tiles of 4 (fit_block(132, 128)), 32 (160 keys) and 128 (256 keys),
# and one query against two tiles of 128 keys (a decode step of 16 lanes);
# GQA 2 to 1; (b, hq, hkv, lq, lk).  Each has 128 rows or more: a score
# that the kernel's order of the dot moves across a LUT bin moves its row,
# and the tight share counts elements
NEMOTRON_EDGE_D = (136, 192, 200, 256)
NEMOTRON_EDGE_SHAPES = ((2, 4, 2, 64, 132), (2, 4, 2, 64, 160),
                        (2, 4, 2, 64, 256), (16, 8, 2, 1, 256))
# and the causal skip's edges: Lq < Lk with the last block of rows partly
# past Lq, and Lq > Lk, whose first 128 rows see no key (their output is 0)
NEMOTRON_EDGE_CAUSAL = ((2, 4, 2, 200, 256), (2, 4, 2, 256, 128))
# depths off the 16-byte vectors, one a build (DT 24, 32): the wide
# kernel's element-wise staging and output stores
NEMOTRON_EDGE_ODD_D = (131, 250)
# bf16 at ragged depths (Q's depth past D is zero in shared memory) where
# each block takes several items, the last split's rows partly past Lq in
# the second
NEMOTRON_EDGE_ITEMS = ((2, 96, 8, 256, 256), (2, 96, 8, 200, 256))
NEMOTRON_EDGE_ITEMS_D = (136, 200)


def nemotron_edge_cases():
    """The wide kernel's edge rows, ``(shape, causal, use_lut, dtype,
    strided)`` with ``shape`` = (b, hq, hkv, lq, lk, d), in the order the
    kernel phase draws their inputs: new cases go last, so that earlier
    rows keep their draws (a row of 128 queries loses 0.8 % of its share
    for each query a LUT bin moves, PERF.md)."""
    f32, bf16 = torch.float32, torch.bfloat16
    for d in NEMOTRON_EDGE_D:
        for edge in NEMOTRON_EDGE_SHAPES:
            for causal, use_lut in ((True, True), (False, True),
                                    (False, False)):
                yield (*edge, d), causal, use_lut, f32, edge[3] > 1
        yield (2, 4, 2, 64, 256, d), True, True, bf16, False
    for d in NEMOTRON_EDGE_D:
        for edge in NEMOTRON_EDGE_CAUSAL:
            for use_lut, dtype in ((True, f32), (False, f32), (True, bf16)):
                yield (*edge, d), True, use_lut, dtype, True
    for d in NEMOTRON_EDGE_ODD_D:
        for use_lut, dtype in ((True, f32), (False, f32), (True, bf16)):
            yield (2, 4, 2, 64, 256, d), True, use_lut, dtype, True
    for d in NEMOTRON_EDGE_ITEMS_D:
        for edge in NEMOTRON_EDGE_ITEMS:
            yield (*edge, d), True, True, bf16, True


def nemotron_kernel_rows(dev, gen, rows) -> None:
    """nemotron-4-340b's shapes: the head ``[B, 18432] @ [18432, 256000]``
    at LM_HEAD_ROWS, per channel, float32 and bf16 activations; the causal
    GQA attention ``(2, 96, 8, 1024, 1024, 192)`` on strided views,
    float32 and bf16, timed; and the wide kernel's edges
    (:func:`nemotron_edge_cases`)."""
    cfg = registry.get(NEMOTRON_NAME).config
    for m in LM_HEAD_ROWS:
        for x_dtype in (torch.float32, torch.bfloat16):
            r = check_matmul(dev, gen, "lm_head", m, cfg.d_model,
                             cfg.padded_vocab, per_channel=True, x_float=True,
                             axis_range=(-8, 9), timed=True, x_dtype=x_dtype)
            rows["int8_matmul"].append({"model": NEMOTRON_NAME, "batch": m,
                                        **r})
            gc.collect()
            torch.cuda.empty_cache()
    shape = (LM_FLASH_TOKENS[0], cfg.n_heads, cfg.n_kv_heads,
             LM_FLASH_TOKENS[1], LM_FLASH_TOKENS[1], cfg.resolved_head_dim)
    for dtype in (torch.float32, torch.bfloat16):
        r = check_attention(dev, gen, shape, True, True, dtype=dtype,
                            timed=True, strided=True)
        rows["lut_attention"].append({**r, "model": NEMOTRON_NAME,
                                      "batch": shape[0]})
    for shape, causal, use_lut, dtype, strided in nemotron_edge_cases():
        rows["lut_attention"].append(check_attention(
            dev, gen, shape, causal, use_lut, dtype=dtype, strided=strided))


def whisper_kernel_rows(dev, gen, rows) -> None:
    """The encoder-decoder's shapes (whisper-large-v3, 4 clips): the
    unmasked Q8.24 softmax on an encoder query chunk ``[4 * 20 * 512,
    1500]`` (the kernel's global path: rows above its slab limit) and on a
    decode step's cross-attention rows ``[4 * 20, 1500]``; the GELU in
    bf16 on the encoder's MLP ``[4 * 1500, 5120]`` and a decode step's
    ``[4, 5120]``; the non-causal flash-LUT attention ``(4, 20, 20, 1500,
    1500, 64)`` on strided views at key tiles of 4 (375 online rescales a
    row), float32 under the tight terms and bf16 (the path's dtype)."""
    cfg = registry.get(WHISPER_NAME).config
    h, n, ff = cfg.n_heads, cfg.enc_seq, cfg.d_ff
    b = WHISPER_CLIPS
    for m, variant in ((b * h * lm_layers.Q_CHUNK, "fixed encoder"),
                       (b * h, "fixed cross")):
        r = check_softmax(dev, gen, m, n, True, timed=True)
        rows["lut_softmax"].append({**r, "model": WHISPER_NAME, "batch": b,
                                    "variant": variant})
    for shape in ((b * n, ff), (b, ff)):
        r = check_gelu(dev, gen, shape, False, torch.bfloat16, True)
        rows["lut_gelu"].append({**r, "model": WHISPER_NAME, "batch": b,
                                 "variant": "nearest bf16"})
    shape = (b, h, h, n, n, cfg.resolved_head_dim)
    for dtype in (torch.float32, torch.bfloat16):
        r = check_attention(dev, gen, shape, False, True, dtype=dtype,
                            timed=True, strided=True)
        rows["lut_attention"].append({**r, "model": WHISPER_NAME, "batch": b})


# ---------------------------------------------------------------------------
# phase 4: the cost model and the rooflines on the card
# ---------------------------------------------------------------------------

# over the datasheet by more than this, a calibration reading is a timing
# fault, not a fast card
CALIBRATION_SLACK = 1.05
# (model, recipe label, recipe keywords, attention, batches): the serve
# plans of phases 5 and 6
PERF_PLANS = [
    ("kwt-tiny", "int8 (Table V)", None, "xla", (1, 64, 4096)),
    ("kwt-tiny", "int8 (Table V)", None, "flash_lut", (1, 64, 4096)),
    ("kwt-1", "int8 (Table V defaults)", None, "xla", (1, 64)),
    ("kwt-1", "int8 (Table V defaults)", None, "flash_lut", (1, 64)),
    ("kwt-1", "int4 per-channel",
     dict(bits=4, weight_exponent=4, per_channel=True), "xla", (1, 64)),
]
PERF_REQUESTS = 5             # timed forwards (or hops) per p50, after 2
PERF_HOP_LANES = 64
PERF_CELL_SLOTS = 8


def analytic_matmul_flops(cfg, batch: int) -> int:
    """The products of one KWT forward counted by hand: patch embed,
    Q/K/V, scores, attention-weighted values, wo, the MLP and the head."""
    f, t_in = cfg.input_dim
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    t = t_in + 1
    per_layer = (3 * 2 * t * d * (h * dh) + 2 * 2 * h * t * t * dh
                 + 2 * t * (h * dh) * d + 2 * 2 * t * d * cfg.d_ff)
    return batch * (2 * t_in * d * f + cfg.n_layers * per_layer
                    + 2 * d * cfg.n_classes)


def require_same_cost(what: str, card, cpu) -> dict:
    """The card's CostReport.to_dict() must be the CPU's, line for line."""
    got, want = card.to_dict(), cpu.to_dict()
    if got != want:
        a = {(r["stage"], r["op"]): r for r in got["lines"]}
        b = {(r["stage"], r["op"]): r for r in want["lines"]}
        diff = {f"{k[0]}/{k[1]}": (a.get(k), b.get(k))
                for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)}
        raise AssertionError(f"{what}: the cost model prices the card's plan "
                             f"otherwise than the CPU's: {diff}")
    return got


def p50_ms(fn) -> float:
    for _ in range(2):
        fn()
    lat = []
    for _ in range(PERF_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def roofline_rows(rep, ms: float, measured) -> dict:
    return {"h100": perf.roofline_terms(rep.flops, rep.bytes, ms * 1e-3,
                                        perf.H100),
            "measured": perf.roofline_terms(rep.flops, rep.bytes, ms * 1e-3,
                                            measured)}


# the float32 roof: the LM plans' blocks are a float32 view multiplied
# with TF32 off, outside the tensor cores' bf16 rate that perf.H100 carries
H100_FP32 = perf.MachineModel(name="h100-sxm-fp32",
                              peak_flops=roofline.H100_PEAK_FLOPS_FP32,
                              mem_bw=roofline.H100_HBM_BW,
                              clock_hz=roofline.H100_CLOCK_HZ)


def analytic_lm_matmul_flops(cfg, batch: int, t: int) -> int:
    """A dense LM forward's products over ``t`` tokens counted by hand
    (tests/test_torch_perf.py checks the formula on the smoke config):
    Q, K, V and O, the full ``t x t`` score and value products, the gated
    MLP, the untied head."""
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    per_layer = (2 * t * d * h * dh + 2 * 2 * t * d * kv * dh
                 + 2 * 2 * h * t * t * dh + 2 * t * h * dh * d
                 + 3 * 2 * t * d * f)
    return batch * (cfg.n_layers * per_layer + 2 * t * d * cfg.padded_vocab)


def price_lm_forward(eng, tokens, roof, what: str, analytic=None) -> dict:
    """``perf.engine_cost`` of ``eng.forward`` on ``tokens`` (a phase's
    4 x 63 prompts) beside that forward's p50: the cost's totals and lines
    and the roofline terms against the H100's datasheet (bf16 and float32
    rates) and the calibrated roof.  The walk must leave the launch
    counters as they were; ``analytic``, where given, must be the
    products' count."""
    x = torch.as_tensor(tokens).to(eng.device)
    before = ops.launch_counts()
    rep = perf.engine_cost(eng, x=x)
    if ops.launch_counts() != before:
        raise AssertionError(f"{what}: the walk moved the counters")
    if analytic is not None and rep.matmul_flops != analytic:
        raise AssertionError(f"{what}: matmul_flops {rep.matmul_flops}, "
                             f"analytic {analytic}")
    ms = p50_ms(lambda: eng.forward(x))
    return {"tokens": list(x.shape), "p50_ms": ms,
            "matmul_flops_analytic": analytic, "cost": rep.to_dict(),
            "h100_fp32": perf.roofline_terms(rep.flops, rep.bytes, ms * 1e-3,
                                             H100_FP32),
            **roofline_rows(rep, ms, roof)}


def flight_attribution(eng, fcfg, tmp: str) -> dict:
    """A span-less slow-hop dump of a StreamLanes cell on ``eng``'s
    device: every hop is over a budget of 1e-9 ms, no tracer is active,
    so the recorder attributes by the stage weights the lanes installed."""
    dev = eng.device
    cell = cellmod.ServeCell(eng, slots=PERF_CELL_SLOTS,
                             registry=telemetry.Registry(),
                             flight=telemetry.FlightConfig(
                                 dump_dir=os.path.join(tmp, dev.type),
                                 min_hops=2))
    lanes = cell.stream_lanes(fcfg, detector.DetectorConfig())
    if not callable(cell.flight.stage_weights):
        raise AssertionError("StreamLanes installed no lazy stage weights")
    cell.metrics.latency_budget.set(1e-9)
    rng = np.random.default_rng(5)
    for lane in range(PERF_CELL_SLOTS):
        lanes.join(lane)
    while not cell.flight.dumps:
        if lanes.cell.metrics.hops.value > 8 * PERF_CELL_SLOTS:
            raise AssertionError(f"{dev}: no slow-hop dump in 8 hops")
        lanes.hop(rng.normal(0, 0.1, (PERF_CELL_SLOTS, fcfg.hop_len))
                  .astype(np.float32))
    with open(cell.flight.dumps[0]) as fh:
        art = json.load(fh)
    att = art["attribution"]
    if att["method"] != "cost-model-weights" or \
            set(att["stage_ms"]) != set(cell.flight.stage_weights):
        raise AssertionError(f"{dev}: the dump is not attributed by the cost "
                             f"model's weights: {att}")
    return {"reason": art["reason"], "attribution": att,
            "stage_weights": cell.flight.stage_weights}


def phase_perf(dev, info: dict):
    """The cost model and the rooflines on the card: the measured
    envelope (no reading over the datasheet), every serve plan's cost
    priced the same on the card and on the CPU with its products at the
    analytic count, its p50 against the H100's datasheet roof and the
    measured one; one KWT-1 hop of 64 lanes the same way with its stage
    weights; a StreamLanes flight dump on the card attributed by the cost
    model to the stage the same cell on the CPU names.  Returns the
    measured envelope (the LM phases price their forwards against it)."""
    measured = perf.calibrate(device=dev)
    if measured.peak_flops > CALIBRATION_SLACK * roofline.H100_PEAK_FLOPS_FP32 \
            or measured.mem_bw > CALIBRATION_SLACK * roofline.H100_HBM_BW:
        raise AssertionError(f"calibration over the datasheet: {measured}")
    out = {"phase": "perf", "card": info["name"],
           "nvidia_smi": info["nvidia_smi"], "measured": measured.to_dict(),
           "datasheet": perf.H100.to_dict(),
           "fp32_peak_share": measured.peak_flops
           / roofline.H100_PEAK_FLOPS_FP32,
           "hbm_share": measured.mem_bw / roofline.H100_HBM_BW, "plans": []}
    rng = np.random.default_rng(6)
    trees = {}
    for name, label, recipe_kw, attention, batches in PERF_PLANS:
        cfg = registry.get(name).config
        if name not in trees:
            trees[name] = seeded_params(cfg, 0, dev)
        recipe = None if recipe_kw is None else \
            runtime.QuantRecipe.from_config(cfg, **recipe_kw)
        eng = runtime.compile_model(
            cfg, convert.from_numpy_tree(trees[name], dev), backend="cuda",
            recipe=recipe, attention=attention, device=dev)
        twin = runtime.compile_model(
            cfg, convert.from_numpy_tree(trees[name], "cpu"), backend="cuda",
            recipe=recipe, attention=attention, device="cpu",
            plain_kernels=True)
        for b in batches:
            what = f"{name} {label} {attention} B={b}"
            before = ops.launch_counts()
            rep = perf.engine_cost(eng, batch=b)
            if ops.launch_counts() != before:
                raise AssertionError(f"{what}: the walk moved the counters")
            cost = require_same_cost(what, rep,
                                     perf.engine_cost(twin, batch=b))
            want = analytic_matmul_flops(cfg, b)
            if rep.matmul_flops != want:
                raise AssertionError(f"{what}: matmul_flops "
                                     f"{rep.matmul_flops}, analytic {want}")
            x = rng.normal(0, 0.5, (b, *cfg.input_dim)).astype(np.float32)
            ms = p50_ms(lambda: eng.forward(x))
            out["plans"].append({"model": name, "recipe": label,
                                 "attention": attention, "batch": b,
                                 "p50_ms": ms, "cost": cost,
                                 **roofline_rows(rep, ms, measured)})
    # one KWT-1 hop of 64 lanes, and the flight dump, under cuda + xla
    cfg = registry.get("kwt-1").config
    fcfg = features.FrontendConfig(n_mfcc=cfg.input_dim[0])
    eng = runtime.compile_model(cfg, convert.from_numpy_tree(trees["kwt-1"],
                                                             dev),
                                backend="cuda", device=dev)
    twin = runtime.compile_model(
        cfg, convert.from_numpy_tree(trees["kwt-1"], "cpu"), backend="cuda",
        device="cpu", plain_kernels=True)
    rep = perf.stream_hop_cost(eng, fcfg, batch=PERF_HOP_LANES)
    cost = require_same_cost("kwt-1 hop", rep, perf.stream_hop_cost(
        twin, fcfg, batch=PERF_HOP_LANES))
    state = stream.init_stream_state(cfg, fcfg, PERF_HOP_LANES,
                                     keep_features=False, device=dev)
    chunk = torch.from_numpy((0.1 * rng.normal(size=(
        PERF_HOP_LANES, fcfg.hop_len))).astype(np.float32)).to(dev)

    def one_hop():
        nonlocal state
        state, _ = eng.stream_step(state, chunk, fcfg)

    ms = p50_ms(one_hop)
    out["hop"] = {"model": "kwt-1", "lanes": PERF_HOP_LANES, "p50_ms": ms,
                  "cost": cost, "stage_weights_h100":
                  rep.stage_weights(perf.H100),
                  **roofline_rows(rep, ms, measured)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_perf_",
                                     dir=build.build_dir()) as tmp:
        on_card = flight_attribution(eng, fcfg, tmp)
        on_cpu = flight_attribution(twin, fcfg, tmp)
    if on_card["attribution"]["slowest_stage"] != \
            on_cpu["attribution"]["slowest_stage"]:
        raise AssertionError(f"the card's dump names another slowest stage "
                             f"than the CPU's: {on_card} / {on_cpu}")
    out["flight"] = {"card": on_card, "cpu": on_cpu}
    emit(out)
    return measured


# ---------------------------------------------------------------------------
# phases 5 + 6: the main path
# ---------------------------------------------------------------------------

def seeded_params(cfg, seed: int, dev):
    """Weights from a numpy seed in the port's own tree layout: every
    leaf random (fan-in scaled matrices, small biases, LayerNorm scales
    around 1), so that no bias or scale is hidden by a zero or a one."""
    layout = kwt.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    rng = np.random.default_rng(seed)

    def leaf(t):
        scale = 1.0 / np.sqrt(t.shape[0]) if t.ndim > 1 else 0.1
        return rng.normal(0, scale, tuple(t.shape)).astype(np.float32)

    tree = tree_map(leaf, layout)
    for bp in tree["blocks"]:
        for ln in ("ln1", "ln2"):
            bp[ln]["scale"] = (1.0 + bp[ln]["scale"]).astype(np.float32)
    return tree


class CountOps(TorchDispatchMode):
    """Counts the ATen ops one forward dispatches (kernel launches made
    through ``ctypes`` are not ATen ops and are counted by the wrappers)."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        self.names[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def expected_launches(cfg, forwards: int, attention: str = "xla") -> dict:
    """Per forward (or stream hop): one GELU per layer, and one softmax per
    layer under ``attention="xla"`` or one attention launch per layer
    under ``"flash_lut"``; every linear is a matmul launch — patch embed,
    head, and Q, K, V, wo, w1, w2 per layer (Q/K/V go as three launches)."""
    flash = attention == "flash_lut"
    return {"lut_softmax": 0 if flash else cfg.n_layers * forwards,
            "lut_gelu": cfg.n_layers * forwards,
            "int8_matmul": (2 + 6 * cfg.n_layers) * forwards,
            "lut_attention": cfg.n_layers * forwards if flash else 0}


def check_flash_logits(what, cfg, got, want) -> dict:
    """cuda + flash_lut against lut + flash_lut: kernel against plain
    attention, then the same integer pipeline, in which a moved LSB of
    the attention output can be amplified by the layers after it."""
    got, want = got.cpu(), want.cpu()
    diff = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    tol = FLASH_TINY_ATOL if cfg.n_layers == 1 else FLASH_KWT1_ATOL
    if diff > tol or (cfg.n_layers > 1 and agree < FLASH_KWT1_MIN_ARGMAX_AGREE):
        raise AssertionError(f"{what}: cuda + flash_lut logits {diff} from lut "
                             f"+ flash_lut (tolerance {tol}), argmax "
                             f"agreement {agree}")
    return {"max_abs": diff, "argmax_agree": agree}


def phase_serve(name: str, dev, batches, recipes, requests=3) -> dict:
    cfg = registry.get(name).config
    np_tree = seeded_params(cfg, 0, dev)
    rng = np.random.default_rng(1)
    out = {"phase": f"serve_{cfg.name.replace('-', '_')}", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "plans": []}
    expected = {}
    for label, recipe_kw, attention in recipes:
        params = convert.from_numpy_tree(np_tree, dev)
        recipe = None if recipe_kw is None else \
            runtime.QuantRecipe.from_config(cfg, **recipe_kw)
        eng = runtime.compile_model(cfg, params, backend="cuda",
                                    recipe=recipe, attention=attention,
                                    device=dev)
        plain = runtime.compile_model(cfg, params, backend="lut",
                                      recipe=recipe, attention=attention,
                                      device=dev)
        on_cpu = runtime.compile_model(
            cfg, convert.from_numpy_tree(np_tree, "cpu"), backend="lut",
            recipe=recipe, attention=attention, device="cpu")
        flash = attention == "flash_lut"
        plan = {"recipe": label, "attention": attention,
                "describe": eng.describe(),
                "rom_bytes": eng.rom_bytes, "lut_bytes": eng.lut_bytes,
                "param_bytes": eng.param_bytes, "batches": []}
        with CountOps() as counter:
            eng.forward(np.zeros((1, *cfg.input_dim), np.float32))
        plan["aten_ops_per_forward"] = counter.n
        for b in batches:
            before = ops.launch_counts()
            lat, logits, vs_plain = [], None, []
            for _ in range(requests):
                mfcc = rng.normal(0, 0.5, (b, *cfg.input_dim)).astype(np.float32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = eng.forward(mfcc)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                if tuple(logits.shape) != (b, cfg.n_classes) or \
                        not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"{cfg.name} B={b}: bad logits")
                want = plain.forward(mfcc)
                if flash:
                    vs_plain.append(check_flash_logits(
                        f"{cfg.name} {label} B={b}", cfg, logits, want))
                elif not torch.equal(logits, want):
                    raise AssertionError(
                        f"{cfg.name} {label} B={b}: cuda plan differs from the "
                        f"lut plan on the card by {max_abs_err(logits, want)}; "
                        "with the kernel phase passing, a wrapper hands its "
                        "kernel other operands than the plain path gets")
            after = ops.launch_counts()
            rose = {k: after[k] - before[k] for k in after}
            want_rise = expected_launches(cfg, requests, attention)
            if rose != want_rise:
                raise AssertionError(f"{cfg.name} B={b}: launch counters rose "
                                     f"by {rose}, expected {want_rise}")
            entry = {"batch": b, "requests": requests,
                     "p50_ms": statistics.median(lat), "launches": rose}
            if flash:
                entry["vs_lut_flash_on_card"] = {
                    "max_abs": max(v["max_abs"] for v in vs_plain),
                    "argmax_agree": min(v["argmax_agree"] for v in vs_plain)}
            if b in CPU_BATCHES:
                ref_logits = on_cpu.forward(mfcc)
                if flash:
                    v = check_flash_logits(f"{cfg.name} {label} B={b} vs CPU",
                                           cfg, logits, ref_logits)
                    entry.update(vs_cpu_max_abs=v["max_abs"],
                                 vs_cpu_argmax_agree=v["argmax_agree"])
                else:
                    diff = (logits.cpu() - ref_logits).abs()
                    agree = float((logits.cpu().argmax(-1)
                                   == ref_logits.argmax(-1)).float().mean())
                    entry.update(vs_cpu_max_abs=float(diff.max()),
                                 vs_cpu_argmax_agree=agree)
                    tol = TINY_LUT_ATOL if cfg.n_layers == 1 else KWT1_LUT_ATOL
                    if float(diff.max()) > tol or (
                            cfg.n_layers > 1 and agree < KWT1_MIN_ARGMAX_AGREE):
                        raise AssertionError(
                            f"{cfg.name} {label} B={b}: card vs CPU lut plan "
                            f"max abs {float(diff.max())} (tolerance {tol}), "
                            f"argmax agreement {agree}")
            plan["batches"].append(entry)
        plan["launches"] = {k: sum(e["launches"][k] for e in plan["batches"])
                            for k in ops.launch_counts()}
        out["plans"].append(plan)
        # the path's count: the request forwards and the one that counted
        # ATen ops
        want = expected_launches(cfg, 1 + requests * len(batches), attention)
        expected = {k: expected.get(k, 0) + want[k] for k in want}
    emit(out)
    return expected


# ---------------------------------------------------------------------------
# phases 7 + 8: the always-on stream
# ---------------------------------------------------------------------------

STREAM_CHUNKS = (1, 2, 5)     # hops per stream_step, cycled
RESET_LANE = 3


def _rise(before: dict) -> dict:
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after}


def phase_stream(name: str, dev, lanes: int, hops: int, reset_at: int) -> dict:
    """Stream ``lanes`` lanes of seeded audio through ``Engine.stream_step``
    for ``hops`` hops in chunks cycling through ``STREAM_CHUNKS``, under the
    cuda backend with both attention realisations.  On every hop, the
    logits of every warm lane must be ``torch.equal`` to ``Engine.forward``
    of the feature ring's window (a lane that is not warm holds zeroed
    embeddings where the window holds zeroed features, whose embedding is
    the bias).  Lane ``RESET_LANE`` is reset at hop ``reset_at`` and must
    be warm again at the end.

    The check forwards launch kernels too: the phase returns, besides its
    line, the launches of its ``stream_step`` calls and those of its check
    forwards, so that the main path's count can leave the latter out."""
    cfg = registry.get(name).config
    fcfg = features.FrontendConfig(n_mfcc=cfg.input_dim[0])
    t, hop = stream.window_frames(cfg), fcfg.hop_len
    if hops < reset_at + t:
        raise ValueError("the reset lane would not re-warm")
    np_tree = seeded_params(cfg, 0, dev)
    rng = np.random.default_rng(2)
    audio = torch.from_numpy((0.1 * rng.normal(size=(lanes, hops * hop)))
                             .astype(np.float32)).to(dev)
    hop_ms = 1e3 * hop / fcfg.sample_rate
    out = {"phase": f"stream_{cfg.name.replace('-', '_')}", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_mfcc": fcfg.n_mfcc, "window_frames": t, "lanes": lanes,
           "hops": hops, "chunk_hops": list(STREAM_CHUNKS),
           "reset": {"lane": RESET_LANE, "at_hop": reset_at}, "plans": []}
    steps_rose = dict.fromkeys(ops.launch_counts(), 0)
    checks_rose = dict.fromkeys(steps_rose, 0)
    expected = dict.fromkeys(steps_rose, 0)
    for attention in ("xla", "flash_lut"):
        eng = runtime.compile_model(cfg, convert.from_numpy_tree(np_tree, dev),
                                    backend="cuda", attention=attention,
                                    device=dev)
        state = stream.init_stream_state(cfg, fcfg, lanes, device=dev)
        per_hop = expected_launches(cfg, 1, attention)
        lat, rtf, ks, checked, step, i, reset = [], [], [], 0, 0, 0, False
        first_warm = None
        while i < hops:
            k = min(STREAM_CHUNKS[step % len(STREAM_CHUNKS)], hops - i)
            if not reset and i >= reset_at:
                state = stream.reset_lane(state, RESET_LANE)
                warm = stream.warm(state).cpu()
                if bool(warm[RESET_LANE]) or not bool(warm.sum() == lanes - 1):
                    raise AssertionError(f"reset_lane left warm = {warm}")
                reset = True
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, logits = eng.stream_step(state, audio[:, i * hop:(i + k) * hop],
                                            fcfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rose = _rise(before)
            if rose != per_hop:
                raise AssertionError(f"{cfg.name} {attention} hop {i}: counters "
                                     f"rose by {rose}, expected {per_hop}")
            steps_rose = {n: steps_rose[n] + rose[n] for n in rose}
            expected = {n: expected[n] + per_hop[n] for n in per_hop}
            lat.append(ms)
            rtf.append(ms / (k * hop_ms))
            ks.append(k)
            i, step = i + k, step + 1
            if tuple(logits.shape) != (lanes, cfg.n_classes) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{cfg.name} hop {i}: bad logits")
            warm = stream.warm(state)
            if bool(warm.any()):
                first_warm = i if first_warm is None else first_warm
                before = ops.launch_counts()
                want = eng.forward(stream.window_mfcc(state))
                rose = _rise(before)
                if rose != per_hop:
                    raise AssertionError(f"the check forward launched {rose}")
                checks_rose = {n: checks_rose[n] + rose[n] for n in rose}
                if not torch.equal(logits[warm], want[warm]):
                    raise AssertionError(
                        f"{cfg.name} {attention} hop {i}: streaming logits "
                        f"differ from the offline forward of the window by "
                        f"{max_abs_err(logits, want)}")
                checked += 1
        if not bool(stream.warm(state).all()):
            raise AssertionError(f"lane {RESET_LANE} did not re-warm")
        off = features.mfcc(audio, fcfg)[..., -t:]
        frames = stream.window_mfcc(state)
        frames_err = max_abs_err(frames, off)
        if not torch.equal(frames, off):
            raise AssertionError(
                f"{cfg.name} {attention}: streaming MFCC frames differ from "
                f"the offline ones by {frames_err}")
        out["plans"].append({
            "attention": attention, "describe": eng.describe(),
            "steps": step, "first_warm_hop": first_warm,
            "warm_steps_checked_equal": checked,
            "p50_ms_per_step": statistics.median(lat),
            "p50_rtf": statistics.median(rtf),
            "p50_ms_by_chunk": {k: statistics.median(
                [m for m, kk in zip(lat, ks) if kk == k]) for k in STREAM_CHUNKS},
            "launches_per_step": per_hop,
            "frames_vs_offline_mfcc": {"max_abs": frames_err,
                                       "equal": True}})
    out["launches"] = steps_rose
    out["check_forward_launches"] = checks_rose
    emit(out)
    return steps_rose, checks_rose, expected


# ---------------------------------------------------------------------------
# phases 9 + 10: the always-on server (the serving cell)
# ---------------------------------------------------------------------------

CELL_TINY_ARGS = ["--arch", "kwt-tiny", "--backend", "cuda", "--streams", "24",
                  "--slots", "8", "--hops", "60", "--chunk-hops", "1",
                  "--train-steps", "20", "--degrade-queue", "8",
                  "--degrade-chunk-hops", "2", "--seed", "0"]
CELL_KWT1_SLOTS = 64
CELL_KWT1_HOPS = 120          # > 98 frames of window + 5 of smoothing
CELL_KWT1_SWAP_AT, CELL_KWT1_RESET_AT = 40, 70
CELL_RESET_LANE = 5
# the keyword class is one of 35: on random weights its smoothed posterior
# stays between 0.003 and 0.037 (measured on the card, PERF.md), so the
# detector fires at 0.005 and releases below 0.004
CELL_KWT1_DETECTOR = dict(smooth_hops=5, on_threshold=0.005,
                          off_threshold=0.004, refractory_hops=10)


def run_serve(argv: list) -> tuple:
    """``launch.stream_serve.main(argv)`` with its log lines kept out of
    this script's output (they are returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fired = stream_serve.main(argv)
    return fired, buf.getvalue()


def log_fields(log: str, event: str) -> dict:
    """The ``key=value`` fields of the last ``event=<event>`` log line."""
    line = [ln for ln in log.splitlines() if ln.startswith(f"event={event} ")][-1]
    return dict(p.split("=", 1) for p in line.split()[2:])


def phase_cell_kwt_tiny(dev, tmp: str) -> tuple:
    """KWT-Tiny served by the launcher, ``repro_torch.launch.stream_serve``,
    under ``--backend cuda``: 24 streams on 8 slots, the degrade stage on,
    tracing on.  The artifacts must pass the port's validators, the hop
    ledger must be exact, and the cell's launches must be one hop's worth
    per engine step.  Returns the line, the launches and the expected."""
    cfg = registry.get("kwt-tiny").smoke
    trace = os.path.join(tmp, "cell_kwt_tiny.json")
    argv = CELL_TINY_ARGS + ["--telemetry-out", trace]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    fired, log = run_serve(argv)
    seconds = time.perf_counter() - t0
    path = _rise(before)
    done = log_fields(log, "serve_done")
    checked = telemetry_check.check_artifacts(trace, require_metrics=True)
    metrics = json.loads(Path(trace).with_suffix(".metrics.json").read_text())
    hops_total = metrics["cell_hops_total"]["value"]
    if not (int(done["ingested_hops"]) == int(done["offered_hops"])
            == hops_total) or metrics["cell_dropped_hops_total"]["value"]:
        raise AssertionError(f"hop ledger: ingested {done['ingested_hops']}, "
                             f"offered {done['offered_hops']}, counter "
                             f"{hops_total}")
    steps_run = metrics["cell_hop_latency_ms"]["summary"]["n"]
    expected = expected_launches(cfg, steps_run)
    if path != expected:
        raise AssertionError(f"the launcher's cell launched {path}, expected "
                             f"{expected} ({steps_run} engine steps)")
    events = json.loads(Path(trace).read_text())["traceEvents"]
    spans = {(e["name"], e.get("args", {}).get("parent")) for e in events}
    if not {("stream_step", "hop"), ("hop", "stream_step")} <= spans:
        raise AssertionError(f"no Engine.stream_step spans in the trace: {spans}")
    degraded = metrics["cell_admission_total"]
    out = {"phase": "cell_kwt_tiny", "model": cfg.name, "argv": argv,
           "seconds": seconds, "artifacts": checked, "engine_steps": steps_run,
           "serve_done": done, "fired": len(fired),
           "admission": degraded, "launches": path,
           "launches_per_step": expected_launches(cfg, 1),
           "p50_hop_ms": float(done["p50_ms"]),
           "rtf_p50_one_hop": float(done["p50_ms"]) / 10.0}
    emit(out)
    return path, expected


def _cell_chunks(n_lanes: int, hops: int, hop: int) -> np.ndarray:
    """[hops, lanes, hop] host chunks of seeded keyword event streams."""
    audio = np.stack([pipeline.keyword_event_stream(1, lane, n_hops=hops,
                                                    hop_len=hop)[0]
                      for lane in range(n_lanes)])
    return np.ascontiguousarray(audio.reshape(n_lanes, hops, hop)
                                .transpose(1, 0, 2))


def _zeroed_lane(lanes, lane: int) -> bool:
    d, s = lanes.dstate, lanes.state
    return (int(d["hist"]["count"][lane]) == 0 and not bool(d["active"][lane])
            and int(d["cooldown"][lane]) == 0 and int(d["warm_hops"][lane]) == 0
            and int(s["embed"]["count"][lane]) == 0
            and not bool(s["frontend"]["tail"][lane].any()))


def cell_kwt1_plan(dev, cfg, np_tree, np_tree2, attention: str, tmp: str):
    """One attention realisation of ``cell_kwt_1``.  Returns the plan's line,
    the launches of its lane hops and those of its checks."""
    fcfg = stream_serve.frontend_for(cfg)
    dcfg = detector.DetectorConfig(**CELL_KWT1_DETECTOR)
    per_hop = expected_launches(cfg, 1, attention)
    eng = runtime.compile_model(cfg, convert.from_numpy_tree(np_tree, dev),
                                backend="cuda", attention=attention, device=dev)
    watch = os.path.join(tmp, f"watch_{attention}")
    probe = np.random.RandomState(3).normal(
        0, 0.5, (1, *cfg.input_dim)).astype(np.float32)
    cell = cellmod.ServeCell(
        eng, slots=CELL_KWT1_SLOTS, registry=telemetry.Registry(),
        watch_dir=watch, watch_like=eng.params, probe=probe,
        flight=telemetry.FlightConfig(dump_dir=os.path.join(
            tmp, f"flight_{attention}")))
    chunks = _cell_chunks(CELL_KWT1_SLOTS, CELL_KWT1_HOPS, fcfg.hop_len)
    lanes_rose = dict.fromkeys(ops.launch_counts(), 0)
    checks_rose = dict(lanes_rose)

    def count(into, before):
        for k, v in _rise(before).items():
            into[k] += v

    with cell:
        joint = cell.stream_lanes(fcfg, dcfg)
        piped = cell.stream_lanes(fcfg, dcfg, pipelined=True)
        ingest = cell.stream_lanes(fcfg, dcfg, feature_ingest=True)
        for lanes in (joint, piped, ingest):
            for lane in range(CELL_KWT1_SLOTS):
                lanes.join(lane)
        edge = features.frontend_init(fcfg, CELL_KWT1_SLOTS, device=dev)
        ev = {"joint": [], "pipelined": [], "ingest": []}
        ms = {"joint": [], "pipelined": []}
        bounds = (0, CELL_KWT1_SWAP_AT, CELL_KWT1_RESET_AT, CELL_KWT1_HOPS)
        gen0 = cell.handle.generation
        for seg in range(3):
            lo, hi = bounds[seg], bounds[seg + 1]
            if seg == 1:          # a packed artifact published mid-stream
                packed = runtime.QuantRecipe.from_config(cfg).quantize(
                    convert.from_numpy_tree(np_tree2, dev))
                ckpt_manager.save(watch, 1, packed)
                before = ops.launch_counts()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    swapped = cell.maybe_swap()
                if not swapped:
                    raise AssertionError("maybe_swap did not install the "
                                         "published artifact")
                count(checks_rose, before)
                gate_err = float(log_fields(buf.getvalue(), "hot_swap")
                                 ["probe_err"])
            if seg == 2:          # one lane evicted and re-joined
                for lanes in (joint, piped, ingest):
                    lanes.evict(CELL_RESET_LANE)
                    lanes.join(CELL_RESET_LANE)
                    if not _zeroed_lane(lanes, CELL_RESET_LANE):
                        raise AssertionError("a re-joined lane kept state")
                tail = edge["tail"].clone()
                tail[CELL_RESET_LANE] = 0.0
                edge = {"tail": tail}
            before = ops.launch_counts()
            for h in range(lo, hi):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev["joint"].append(joint.hop(chunks[h]))
                ms["joint"].append((time.perf_counter() - t0) * 1e3)
                with torch.inference_mode():
                    edge, frames = features.frontend_push(
                        edge, torch.from_numpy(chunks[h]).to(dev), fcfg)
                ev["ingest"].append(ingest.hop(frames))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in piped.run(chunks[lo:hi]):
                ev["pipelined"].append(e)
                t1 = time.perf_counter()
                ms["pipelined"].append((t1 - t0) * 1e3)
                t0 = t1
            count(lanes_rose, before)
        if cell.handle.generation != gen0 + 1:
            raise AssertionError(f"generation {cell.handle.generation}, "
                                 f"expected {gen0 + 1}")
        for mode in ("pipelined", "ingest"):
            for h, (a, b) in enumerate(zip(ev["joint"], ev[mode])):
                for key in ("fired", "score"):
                    if not np.array_equal(a[key], b[key]):
                        raise AssertionError(
                            f"{attention} hop {h}: {mode} lanes' {key} differ "
                            f"from the joint lanes' by "
                            f"{np.abs(a[key] - b[key]).max()}")
        m = cell.metrics
        want_hops = 3 * CELL_KWT1_HOPS * CELL_KWT1_SLOTS
        ledger = m.hops.value
        if ledger != want_hops or m.dropped_hops.value:
            raise AssertionError(f"hop ledger {ledger}, expected {want_hops}")
        # where a hop's time goes: the card's busy share under the profiler
        # (lane hops too: their launches count on the lane side)
        before = ops.launch_counts()
        window = chunks[:PROFILED_HOPS]
        profiled = {
            "joint": profile_hops(lambda: [joint.hop(c) for c in window]),
            "pipelined": profile_hops(lambda: list(piped.run(window)))}
        count(lanes_rose, before)
        # a corrupted artifact fails closed
        serving, failures = cell.engine, m.swap_failures.value
        bad = tree_map(lambda leaf: dataclasses.replace(
            leaf, exponent=leaf.exponent - 10)
            if isinstance(leaf, quant.QTensor) else leaf,
            runtime.QuantRecipe.from_config(cfg).quantize(
                convert.from_numpy_tree(np_tree2, dev)))
        before = ops.launch_counts()
        try:
            cellmod.hot_swap(cell.handle, bad, probe, metrics=m)
        except cellmod.SwapRejected:
            pass
        else:
            raise AssertionError("the corrupted artifact was installed")
        count(checks_rose, before)
        cell.flight.check()
        dumps = [json.loads(Path(d).read_text())["reason"]
                 for d in cell.flight.dumps]
        if m.swap_failures.value != failures + 1 or cell.engine is not serving \
                or dumps != ["swap_failure"]:
            raise AssertionError(f"corrupted artifact: swap_failures "
                                 f"{m.swap_failures.value}, dumps {dumps}")
        # taps on the cuda plan: the served logits are the untapped plan's
        x = np.random.RandomState(4).normal(
            0, 0.5, (CELL_KWT1_SLOTS, *cfg.input_dim)).astype(np.float32)
        before = ops.launch_counts()
        tapped = runtime.compile_model(
            cfg, convert.from_numpy_tree(np_tree, dev), backend="cuda",
            attention=attention, taps=True, device=dev)
        logits, aux = tapped.forward(x)
        require_equal(f"{attention} taps plan logits vs untapped",
                      logits, eng.forward(x))
        bad_taps = [f"{site}/{k}" for site, st in aux.items()
                    for k, v in st.items() if not bool(torch.isfinite(v))]
        if bad_taps or "block11/gelu" not in aux:
            raise AssertionError(f"taps: non-finite {bad_taps}, sites {list(aux)}")
        count(checks_rose, before)
    lane_hops = 3 * CELL_KWT1_HOPS + 2 * PROFILED_HOPS
    expected = {k: lane_hops * per_hop[k] for k in per_hop}
    if lanes_rose != expected:
        raise AssertionError(f"{attention}: the lanes launched {lanes_rose}, "
                             f"expected {expected}")
    hop_ms = 1e3 * fcfg.hop_len / fcfg.sample_rate
    line = {"attention": attention, "describe": eng.describe(),
            "hops": CELL_KWT1_HOPS, "lanes": CELL_KWT1_SLOTS,
            "lane_hops_launched": lane_hops,
            "modes_equal": ["joint", "pipelined (two streams)",
                            "feature ingest"],
            "generation": cell.handle.generation, "ledger_hops": ledger,
            "swap_ms": m.swap_ms.summary(), "swap_gate_err": gate_err,
            "swap_gate_tol": cellmod.hotswap._INT_EXEC_PROBE_TOL,
            "swap_failures": m.swap_failures.value,
            "flight_dumps": dumps, "taps_sites": len(aux),
            "fired": int(sum(e["fired"].sum() for e in ev["joint"])),
            "score_range": [float(min(e["score"].min() for e in ev["joint"])),
                            float(max(e["score"].max() for e in ev["joint"]))],
            "p50_hop_ms": {k: statistics.median(v) for k, v in ms.items()},
            "p50_rtf": {k: statistics.median(v) / hop_ms for k, v in ms.items()},
            "cell_hop_latency_ms": m.hop_ms.summary(),
            "profiled": profiled,
            "launches_per_hop": per_hop, "launches": lanes_rose,
            "check_launches": checks_rose}
    return line, lanes_rose, checks_rose, expected


PROFILED_HOPS = 20


def profile_hops(run_hops) -> dict:
    """``run_hops()`` under ``torch.profiler``: wall ms per hop, the
    kernels' device time per hop, and the share of the window in which the
    card ran a kernel (the union of the kernel intervals of the profiler's
    Chrome trace over the wall time; the profiler's own host cost is in
    the wall time, so the busy share without it is at least this)."""
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_hops()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not spans:
        return {"device_busy_share": "not measured (no kernel events)"}
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"hops": PROFILED_HOPS, "wall_ms_per_hop": wall_us / 1e3 / PROFILED_HOPS,
            "kernel_ms_per_hop": sum(hi - lo for lo, hi in spans) / 1e3
            / PROFILED_HOPS, "kernels_per_hop": len(spans) / PROFILED_HOPS,
            "device_busy_share": busy / wall_us}


def phase_cell_kwt_1(dev, tmp: str) -> tuple:
    """KWT-1 at full width and depth served by ``ServeCell`` directly (the
    launcher serves the smoke configs), 64 slots of seeded event streams,
    under ``cuda`` + ``xla`` and ``cuda`` + ``flash_lut``: joint, pipelined
    (two CUDA streams) and feature-ingest lanes on the same chunks give the
    same events and scores bit for bit; a packed artifact published mid-
    stream is hot-swapped in with an exact hop ledger; a lane evicted and
    re-joined comes back zeroed; a corrupted artifact is refused with one
    flight dump; the taps plan serves the untapped logits."""
    cfg = registry.get("kwt-1").config
    np_tree, np_tree2 = seeded_params(cfg, 0, dev), seeded_params(cfg, 1, dev)
    out = {"phase": "cell_kwt_1", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "plans": []}
    lanes = dict.fromkeys(ops.launch_counts(), 0)
    checks, expected = dict(lanes), dict(lanes)
    for attention in ("xla", "flash_lut"):
        line, rose, chk, exp = cell_kwt1_plan(dev, cfg, np_tree, np_tree2,
                                              attention, tmp)
        out["plans"].append(line)
        for k in lanes:
            lanes[k] += rose[k]
            checks[k] += chk[k]
            expected[k] += exp[k]
    out["launches"], out["check_launches"] = lanes, checks
    emit(out)
    return lanes, checks, expected


# ---------------------------------------------------------------------------
# phases 11 + 12: the train path
# ---------------------------------------------------------------------------

TRAIN_TINY_ARGS = ["--arch", "kwt-tiny", "--qat", "--qat-backend", "cuda",
                   "--distill-teacher-arch", "kwt-1",
                   "--distill-teacher-steps", "20", "--steps", "60",
                   "--global-batch", "64"]
TRAIN_TINY_CKPT_EVERY, TRAIN_TINY_FAIL_AT = 10, 35
TRAIN_KWT1_ARGS = ["--arch", "kwt-1", "--qat", "--qat-backend", "cuda",
                   "--steps", "10", "--global-batch", "64"]
TRAIN_BATCH = 64
QAT_ENVELOPE = 0.35           # int-executing plan vs QAT eval: the
                              # reference's own envelope (tests/test_qat.py)
TIMED_STEPS = 20              # student-alone QAT steps timed per model


def train_launches(cfg, steps_run: int) -> dict:
    """A QAT step under the cuda backend launches the softmax and the GELU
    once per layer in its forward, nothing in its backward (the STEs'
    backward is the exact ops' gradient in plain PyTorch), and no matmul
    (its linears are float products of fake-quant weights) or attention
    (einsum attention: the flash-LUT kernel has no gradient)."""
    return {"lut_softmax": cfg.n_layers * steps_run,
            "lut_gelu": cfg.n_layers * steps_run,
            "int8_matmul": 0, "lut_attention": 0}


def run_main(argv: list) -> tuple:
    """``launch.train.main(argv)`` with its per-step lines kept out of this
    script's output (they are returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train.main(argv)
    return result, buf.getvalue()


def check_ste(dev, cfg, b: int) -> dict:
    """The STE Functions on the card at the step's own shapes: forward
    ``torch.equal`` to the plain version, input gradient ``torch.equal``
    to ``torch.autograd.grad`` of the exact op on the same tensor; one
    launch in the forward, none in the backward."""
    gen = torch.Generator(device=dev).manual_seed(5)
    sh = model_shapes(cfg, b)
    out = {}
    cases = {
        # the model's call: approx.masked_softmax(scores, None, "cuda")
        "lut_softmax": (sh["softmax"],
                        lambda x: approx.masked_softmax(x, None, mode="cuda"),
                        lambda x: approx.softmax_lut(x, fixed=True),
                        lambda x: torch.softmax(x, dim=-1)),
        "lut_gelu": (sh["gelu"], lambda x: approx.gelu(x, mode="cuda"),
                     approx.gelu_lut, approx.gelu_exact)}
    for name, (shape, fn, plain, exact) in cases.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 3.0
             ).requires_grad_(True)
        g = torch.randn(shape, generator=gen, device=dev)
        before = ops.launch_counts()
        y = fn(x)
        fwd = _rise(before)
        (gx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        bwd = {k: v - fwd[k] for k, v in _rise(before).items()}
        want_fwd = {k: int(k == name) for k in fwd}
        if fwd != want_fwd or any(bwd.values()):
            raise AssertionError(f"STE {name}: forward launched {fwd}, "
                                 f"backward {bwd}; expected {want_fwd} and none")
        if y.grad_fn is None or "Ste" not in type(y.grad_fn).__name__:
            raise AssertionError(f"STE {name}: the output's grad_fn is "
                                 f"{y.grad_fn}, not the STE Function's")
        with torch.no_grad():
            want_y = plain(x)
        (want_g,) = torch.autograd.grad(exact(x), x, g)
        out[name] = {"shape": list(shape),
                     "forward_max_abs_err": require_equal(
                         f"STE {name} forward", y.detach(), want_y),
                     "grad_max_abs_err": require_equal(
                         f"STE {name} input gradient", gx, want_g),
                     "forward_launches": fwd[name], "backward_launches": 0}
    return out


def _setup_step(cfg, dev, b: int, seed: int):
    params = kwt.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    batch = steps.to_device(pipeline.keyword_batch(
        seed, 0, batch=b, input_dim=cfg.input_dim, n_classes=cfg.n_classes),
        dev)
    hp = adamw.HParams(lr=1e-3, warmup_steps=2, total_steps=50)
    return params, batch, hp, ShapeSpec("chip", cfg.input_dim[1], b, "train")


def check_cuda_vs_lut_step(dev, cfg, b: int) -> dict:
    """One QAT step under ``cuda`` and one under ``lut``, from the same
    params and batch on the card: loss, every gradient and every new
    parameter ``torch.equal``."""
    params, batch, hp, shape = _setup_step(cfg, dev, b, 7)
    got = {}
    for backend in ("cuda", "lut"):
        spec = qat.QATSpec(runtime.QuantRecipe.from_config(cfg),
                           qat.QATConfig(backend=backend))
        qs = qat.init_qat_state(spec, dev)
        loss, grads = steps.value_and_grad(
            qat_train.make_qat_loss(cfg, spec), params, batch,
            qs["weight_exponent"], qs["step"] >= spec.config.start_step)
        step = steps.make_train_step(cfg, shape, hp, n_micro=1, qat=spec)
        new_p, new_opt, _, m = step(params, adamw.init(params, hp), qs, batch)
        got[backend] = (loss, grads, new_p, new_opt, m["loss"])
    (lc, gc, pc, oc, mc), (ll, gl, pl, ol, ml) = got["cuda"], got["lut"]
    require_equal(f"{cfg.name} QAT loss cuda vs lut", lc, ll)
    require_equal(f"{cfg.name} QAT step loss cuda vs lut", mc, ml)
    for what, a, b_ in (("gradient", gc, gl), ("new param", pc, pl),
                        ("new moment", oc, ol)):
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b_))):
            require_equal(f"{cfg.name} QAT {what} {i} cuda vs lut", x, y)
    return {"loss": float(lc), "leaves_equal": len(tree_leaves(gc)),
            "equal": True}


def time_qat_steps(dev, cfg, spec, b: int, n: int) -> dict:
    """p50 ms per QAT step (forward + backward + AdamW: the host clock
    around the step and a synchronize), launches per step, and the ATen
    ops one step dispatches (backward included)."""
    params, batch, hp, shape = _setup_step(cfg, dev, b, 9)
    step = steps.make_train_step(cfg, shape, hp, n_micro=1, qat=spec)
    opt, qs = adamw.init(params, hp), qat.init_qat_state(spec, dev)
    for _ in range(2):
        params, opt, qs, _ = step(params, opt, qs, batch)
    lat, per_step = [], train_launches(cfg, 1)
    for _ in range(n):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, qs, m = step(params, opt, qs, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if _rise(before) != per_step:
            raise AssertionError(f"{cfg.name} QAT step launched {_rise(before)}"
                                 f", expected {per_step}")
    with CountOps() as counter:
        params, opt, qs, m = step(params, opt, qs, batch)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"{cfg.name}: timed QAT steps diverged")
    return {"steps": n, "p50_ms_per_step": statistics.median(lat),
            "aten_ops_per_step": counter.n, "launches_per_step": per_step}


def check_export(dev, cfg, result, tmp: str) -> dict:
    """The trained run's export on the card: QAT eval under the cuda exec
    config ``torch.equal`` to the non-executing ``lut`` engine; the
    integer-executing ``cuda`` plan within ``QAT_ENVELOPE``; the artifact
    written to disk and read back deploys bit-identically on that plan."""
    ex, spec = result.export, result.qat_spec
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1.0, (TRAIN_BATCH, *cfg.input_dim))
                         .astype(np.float32)).to(dev)
    ev = qat.eval_forward(cfg, spec, ex.recipe)(result.params, x)
    lut = runtime.compile_model(cfg, ex.params, backend="lut", recipe=ex.recipe,
                                integer_exec=False, device=dev).forward(x)
    require_equal(f"{cfg.name} QAT eval vs exported lut engine", ev, lut)
    plan = runtime.compile_model(cfg, ex.params, backend="cuda",
                                 recipe=ex.recipe, device=dev)
    served = plan.forward(x)
    envelope = max_abs_err(served, ev)
    if not envelope < QAT_ENVELOPE:
        raise AssertionError(f"{cfg.name}: cuda plan {envelope} from the QAT "
                             f"eval (envelope {QAT_ENVELOPE})")
    path = os.path.join(tmp, "artifact")
    qat_export.save(path, ex)
    recipe, qtree = qat_export.load(path, ex.qparams, device=dev)
    if recipe != ex.recipe:
        raise AssertionError(f"artifact recipe {recipe} != {ex.recipe}")
    loaded = runtime.compile_model(cfg, qtree, backend="cuda", device=dev)
    require_equal(f"{cfg.name} artifact from disk on the cuda plan",
                  loaded.forward(x), served)
    return {"eval_vs_lut_engine": "torch.equal", "cuda_plan_vs_eval": envelope,
            "envelope": QAT_ENVELOPE, "artifact_reload": "torch.equal",
            "artifact_bytes": list(ex.quantized_bytes),
            "argmax_agree_cuda_vs_eval": float(
                (served.argmax(-1) == ev.argmax(-1)).float().mean())}


def phase_train_kwt_tiny(dev, tmp: str) -> tuple:
    """KWT-Tiny trained by ``launch.train.main`` under ``--qat-backend
    cuda`` with the KWT-1 teacher: a run that fails at step 35, its
    rerun that resumes from the newest step complete in every tree (30)
    and an uninterrupted run of the same seed, whose params must be
    ``torch.equal``; then the loss, the export and the checks of both
    train phases.  Returns the line, the launches of the ``main`` runs
    (the path's), those of the checks, and the path's expected count."""
    cfg = registry.get("kwt-tiny").config
    out = {"phase": "train_kwt_tiny", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "argv": TRAIN_TINY_ARGS}
    ckpt = os.path.join(tmp, "ckpt")
    ck = ["--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN_TINY_CKPT_EVERY)]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    try:
        run_main(TRAIN_TINY_ARGS + ck + ["--fail-at-step",
                                         str(TRAIN_TINY_FAIL_AT)])
    except RuntimeError as err:
        if "injected failure" not in str(err):
            raise
    else:
        raise AssertionError("the run with --fail-at-step did not fail")
    resumed, log = run_main(TRAIN_TINY_ARGS + ck)
    full, _ = run_main(TRAIN_TINY_ARGS)
    path = _rise(before)
    out["seconds_three_runs"] = time.perf_counter() - t0
    want_resume = TRAIN_TINY_FAIL_AT // TRAIN_TINY_CKPT_EVERY * \
        TRAIN_TINY_CKPT_EVERY
    if resumed.resumed_from != want_resume or \
            f"[restore] resuming from step {want_resume}" not in log:
        raise AssertionError(f"resumed from {resumed.resumed_from}, expected "
                             f"{want_resume}")
    for i, (a, b) in enumerate(zip(tree_leaves(resumed.params),
                                   tree_leaves(full.params))):
        require_equal(f"resumed vs uninterrupted param {i}", a, b)
    n_steps = int(TRAIN_TINY_ARGS[TRAIN_TINY_ARGS.index("--steps") + 1])
    steps_run = TRAIN_TINY_FAIL_AT + (n_steps - want_resume) + n_steps
    expected = train_launches(cfg, steps_run)
    if path != expected:
        raise AssertionError(f"the train runs launched {path}, expected "
                             f"{expected}")
    losses = full.losses
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"loss: first five {first}, last five {last}")
    out.update(resumed_from=resumed.resumed_from, resume_params_equal=True,
               steps_run=steps_run, loss_first5=first, loss_last5=last,
               p50_ms_per_step_with_teacher=statistics.median(full.step_ms),
               recipe=full.export.recipe.to_dict())
    before = ops.launch_counts()
    out["export"] = check_export(dev, cfg, full, tmp)
    out.update(common_train_checks(dev, cfg, full.qat_spec))
    checks = _rise(before)
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


def common_train_checks(dev, cfg, spec_with_teacher=None) -> dict:
    """The checks both train phases make: the STE at the step's shapes,
    ``cuda`` against ``lut`` on one step, and the step's time and ATen ops
    (student alone, and with the teacher where there is one)."""
    out = {"ste": check_ste(dev, cfg, TRAIN_BATCH),
           "cuda_vs_lut_step": check_cuda_vs_lut_step(dev, cfg, TRAIN_BATCH)}
    student = qat.QATSpec(runtime.QuantRecipe.from_config(cfg),
                          qat.QATConfig(backend="cuda"))
    out["timed_student"] = time_qat_steps(dev, cfg, student, TRAIN_BATCH,
                                          TIMED_STEPS)
    if spec_with_teacher is not None:
        out["timed_with_teacher"] = time_qat_steps(
            dev, cfg, spec_with_teacher, TRAIN_BATCH, TIMED_STEPS)
    return out


def phase_train_kwt_1(dev) -> tuple:
    """KWT-1 at full width and depth on its 40x98 input, 35 classes,
    trained by ``launch.train.main`` under ``--qat-backend cuda``."""
    cfg = registry.get("kwt-1").config
    out = {"phase": "train_kwt_1", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "argv": TRAIN_KWT1_ARGS}
    before = ops.launch_counts()
    result, _ = run_main(TRAIN_KWT1_ARGS)
    path = _rise(before)
    n_steps = int(TRAIN_KWT1_ARGS[TRAIN_KWT1_ARGS.index("--steps") + 1])
    expected = train_launches(cfg, n_steps)
    if path != expected:
        raise AssertionError(f"the train run launched {path}, expected "
                             f"{expected}")
    if not all(np.isfinite(result.losses)) or len(result.losses) != n_steps:
        raise AssertionError(f"KWT-1 losses {result.losses}")
    out.update(losses=result.losses,
               p50_ms_per_step_launcher=statistics.median(result.step_ms))
    before = ops.launch_counts()
    out.update(common_train_checks(dev, cfg))
    checks = _rise(before)
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


# ---------------------------------------------------------------------------
# phases 13 + 14: the dense LM
# ---------------------------------------------------------------------------

LM_SERVE_ARGS = ["--arch", LM_NAME, "--backend", "cuda", "--requests", "8",
                 "--slots", str(LM_SLOTS), "--max-len", "256", "--seed", "0"]
LM_PREFILL_LEN = 64           # fixed pad width of the order-invariance runs
LM_CHECK_TOKENS = (2, 64)     # decode == forward, cuda against lut
LM_FLASH_TOKENS = (2, 1024)   # flash_lut against xla: the kernel row's shape
LM_TIMED = 20                 # decode steps (and 5 prefills) per p50
# prefill of S - 1 tokens + one decode step (caches of S slots) against
# forward's last logits.  tools/lm_decode_gap.py takes the gap apart
# (PERF.md §6): on the same weights with float32 activations and the
# exact softmax and SiLU, decode == forward to the bit at the logits (1.4e-6
# at every layer); a bf16 residual stream, the LUT bins and the head's eq-9
# codes each turn the float32 products' other rounding at other row counts
# into steps that 24 random layers carry on.  Measured on the card: 0.0405
# on the cuda plan (0.0638 while its float32 keys and values were rounded
# into a bf16 cache, ROADMAP C7), 0.0138 on the bf16 float plan; greedy
# tokens equal.  So the cuda plan is held to LM_DECODE_REL with its argmax,
# and the float plan at float32 activations, whose products round apart by
# ulps only, to the reference's rel 1e-4 (tests/test_models.py): a fault in
# the cache write, the masks or the positions shows there unblurred.
LM_DECODE_REL = 0.06
LM_REF_DECODE_REL = 1e-4
# the flash-LUT forward against the sdpa forward of the same cuda plan at
# B = 2, S = 1024 (online LUT softmax against the Q8.24 one, renormalised):
# measured 0.180 max abs, argmax agreement 0.964 on the card (PERF.md)
LM_FLASH_ATOL = 0.5
LM_FLASH_MIN_ARGMAX = 0.9
# the five dense smoke configs (float32 activations): decode == forward on
# the card within the reference's rel 1e-4 on every plan (measured at most
# 2.1e-7 float, 0.0 lut and cuda); the card against the same plan on the
# CPU, the float plan to 1e-4 (measured at most 4.3e-6), the integer plans
# to LM_SMOKE_CODE_FLIPS of the head's eq-9 input steps (one code of the
# head's input moves a logit by at most max|W_head| * 2^-input_exponent,
# 0.0159 for internlm2's smoke head): the card's and the host's float32
# products round apart, and that once moved one code, a logit by 0.0103,
# on lut (cuda: 0.0)
LM_SMOKE_FLOAT_ATOL = 1e-4
LM_SMOKE_CODE_FLIPS = 2
LM_SMOKE_MIN_ARGMAX = 0.9


def lm_expected(cfg, calls: int, attention: str = "xla") -> dict:
    """Per LM call (``forward``, ``prefill`` or ``decode_step`` of at most
    ``Q_CHUNK`` queries): one softmax per layer under ``xla`` (one attention
    launch per layer under ``flash_lut``, forward only; none for rwkv,
    which has no attention) and, on a moe config, one more per layer for
    the router; one int8 matmul (the packed head; the experts are batched
    float products, the recurrences plain PyTorch); no GELU (SiLU,
    softplus and the sigmoid are the LUT, no kernel)."""
    flash = attention == "flash_lut"
    routers = cfg.n_layers * calls if cfg.family == "moe" else 0
    attn = 0 if flash or cfg.family == "rwkv" else cfg.n_layers * calls
    return {"lut_softmax": attn + routers,
            "lut_gelu": 0, "int8_matmul": calls,
            "lut_attention": cfg.n_layers * calls if flash else 0}


def run_lm_serve(argv: list) -> tuple:
    """``launch.serve.main(argv)`` with its log lines returned, not
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = lm_serve.main(argv)
    return out, buf.getvalue()


def lm_schedule(eng, requests, order) -> dict:
    sched = cellmod.LMScheduler(eng, slots=LM_SLOTS, max_len=256,
                                prefill_len=LM_PREFILL_LEN)
    for j in order:
        r = requests[j]
        sched.submit(r["id"], r["prompt"], r["gen"])
    return sched.run()


def time_lm_calls(eng, ptoks) -> tuple:
    """p50 ms of a prefill of ``ptoks`` into fresh states of 256 slots
    (5 of them) and of LM_TIMED greedy decode steps after it; returns them
    with the last step's greedy tokens and state."""
    pre, dsteps = [], []
    for _ in range(5):
        st = eng.init_decode_state(LM_SLOTS, 256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = eng.prefill(ptoks, st)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    cur = logits.argmax(-1)
    for _ in range(LM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = eng.decode_step(cur, st)
        cur = logits.argmax(-1)
        torch.cuda.synchronize()
        dsteps.append((time.perf_counter() - t0) * 1e3)
    return {"p50_prefill_ms": statistics.median(pre),
            "p50_decode_step_ms": statistics.median(dsteps)}, cur, st


def phase_lm_internlm2(dev, tmp: str, roof) -> tuple:
    """internlm2-1.8b at full width (24 layers, d 2048, 16 heads / 8 KV,
    head_dim 128, d_ff 8192, vocab 92544, bf16; random weights drawn on the
    card from the seed) served through ``repro_torch.launch.serve`` under
    ``--backend cuda`` with tracing on: 8 requests on 4 slots; then, on the
    same plan, prefill + decode against forward, the same requests in two
    orders, cuda against lut, flash_lut against xla, p50 per decode step
    and per prefill, and the forward of the 4 x 63 prefill tokens priced
    by ``perf.engine_cost`` (products at the hand count) beside its p50
    against ``roof``.  Returns the path's launches (the served run and the
    ``flash_lut`` forward), the launches of the other checks, the path's
    expected, and the weights (``phase_lm_int8_kv`` serves them again)."""
    cfg = registry.get(LM_NAME).config
    trace = os.path.join(tmp, "lm_serve.json")
    argv = LM_SERVE_ARGS + ["--telemetry-out", trace]
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    served, log = run_lm_serve(argv)
    seconds = time.perf_counter() - t0
    path = _rise(before)
    done = log_fields(log, "serve_done")
    telemetry_check.check_artifacts(trace, require_metrics=True)
    metrics = json.loads(Path(trace).with_suffix(".metrics.json").read_text())
    steps_run = metrics["cell_decode_latency_ms"]["summary"]["n"]
    prefills = metrics["cell_prefill_latency_ms"]["summary"]["n"]
    expected = lm_expected(cfg, steps_run + prefills)
    if path != expected:
        raise AssertionError(f"the LM server launched {path}, expected "
                             f"{expected} ({steps_run} decode steps, "
                             f"{prefills} prefills)")
    requests = lm_serve.make_requests(cfg, 8, 256, 0)
    for r in requests:
        got = served.get(r["id"], [])
        if len(got) != r["gen"] or not all(0 <= t < cfg.vocab_size
                                           for t in got):
            raise AssertionError(f"request {r['id']}: {len(got)} tokens of "
                                 f"{r['gen']}, or a pad id")
    if metrics["cell_tokens_total"]["value"] != sum(r["gen"] for r in requests):
        raise AssertionError("cell_tokens_total is not the tokens served")
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"phase": "lm_internlm2", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "argv": argv,
           "serve_seconds": seconds, "serve_done": done,
           "tokens_served": {str(k): len(v) for k, v in served.items()},
           "decode_steps": steps_run, "prefills": prefills,
           "launches": path, "launches_per_call": lm_expected(cfg, 1),
           "serve_peak_gb": serve_peak}

    # the checks, on plans of the same seed's weights
    checks = ops.launch_counts()
    params = lm_model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = runtime.compile_model(cfg, params, backend="cuda", device=dev)
    out["describe"] = eng.describe()
    out["param_bytes"], out["rom_bytes"] = eng.param_bytes, eng.rom_bytes
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, LM_CHECK_TOKENS).astype(np.int32)
    fwd = eng.forward(toks)
    if tuple(fwd.shape) != (*LM_CHECK_TOKENS, cfg.padded_vocab) or \
            not bool(torch.isfinite(fwd).all()):
        raise AssertionError(f"{cfg.name}: bad forward logits")
    failures = []
    # caches of exactly S slots: the decode's softmax rows are then as long
    # as the forward's, with the same lanes masked (the cuda mode's masked
    # rows depend on their length: the pre-shift, the clip-bin lanes)
    out["decode_vs_forward"] = {}
    plans = (("cuda", eng),
             ("float", runtime.compile_model(cfg, params, backend="float",
                                             device=dev)),
             ("float32", runtime.compile_model(cfg.with_(dtype="float32"),
                                               params, backend="float",
                                               device=dev)))
    for plan, e in plans:
        f = fwd if e is eng else e.forward(toks)
        state = e.init_decode_state(LM_CHECK_TOKENS[0], LM_CHECK_TOKENS[1])
        _, state = e.prefill(toks[:, :-1], state)
        # the same step with a per-lane index (the scheduler's scatter
        # write and per-lane masks) must give the scalar step's bits
        lanes = {"layers": {k: v.clone() for k, v in state["layers"].items()},
                 "index": torch.full((LM_CHECK_TOKENS[0],), state["index"],
                                     dtype=torch.long, device=dev)}
        dec, _ = e.decode_step(toks[:, -1], state)
        dec_lanes, _ = e.decode_step(toks[:, -1], lanes)
        last = f[:, -1].float()
        rel = float((dec.float() - last).abs().max() / last.abs().max())
        out["decode_vs_forward"][plan] = {
            "rel": rel, "argmax_equal": bool(torch.equal(dec.argmax(-1),
                                                         last.argmax(-1))),
            "per_lane_equal": bool(torch.equal(dec, dec_lanes))}
        del f, state, lanes, dec, dec_lanes, e
    del plans
    dvf = out["decode_vs_forward"]
    for plan, lim in (("cuda", LM_DECODE_REL), ("float32", LM_REF_DECODE_REL)):
        if dvf[plan]["rel"] >= lim or not dvf[plan]["argmax_equal"]:
            failures.append(f"{plan}: prefill + decode_step against forward: "
                            f"{dvf[plan]}, over {lim} or another greedy "
                            "token")
    if not all(v["per_lane_equal"] for v in dvf.values()):
        failures.append(f"a per-lane decode step differs from the scalar "
                        f"one: {dvf}")
    # the same requests in two orders: equal tokens per request
    a = lm_schedule(eng, requests, range(len(requests)))
    b = lm_schedule(eng, requests, reversed(range(len(requests))))
    if a != b or sorted(a) != [r["id"] for r in requests]:
        failures.append("tokens depend on the submission order")
    out["order_invariant_requests"] = len(a)
    # p50 per decode step and per prefill, 4 slots, and ATen ops per step
    ptoks = rng.integers(0, cfg.vocab_size, (LM_SLOTS, 63)).astype(np.int32)
    timed, cur, state = time_lm_calls(eng, ptoks)
    with CountOps() as counter:
        eng.decode_step(cur, state)
    del state
    out.update(timed, prefill_tokens=list(ptoks.shape),
               decode_tok_s=LM_SLOTS / (timed["p50_decode_step_ms"] / 1e3),
               aten_ops_per_decode_step=counter.n)
    out["priced_forward"] = price_lm_forward(
        eng, ptoks, roof, cfg.name,
        analytic_lm_matmul_flops(cfg, *ptoks.shape))
    # cuda against lut on the card (by design apart: the masked
    # renormalisation), flash_lut against xla
    lut = runtime.compile_model(cfg, params, backend="lut", device=dev)
    lut_logits = lut.forward(toks)
    del lut
    out["cuda_vs_lut"] = {
        "max_abs": float((fwd - lut_logits).abs().max()),
        "argmax_agree": float((fwd.argmax(-1) == lut_logits.argmax(-1))
                              .float().mean())}
    del lut_logits
    flash = runtime.compile_model(cfg, params, backend="cuda",
                                  attention="flash_lut", device=dev)
    ftoks = rng.integers(0, cfg.vocab_size, LM_FLASH_TOKENS).astype(np.int32)
    # the flash_lut forward is the path's too (a user's Engine.forward)
    before = ops.launch_counts()
    f_logits = flash.forward(ftoks)
    flash_rose = _rise(before)
    if flash_rose != lm_expected(cfg, 1, "flash_lut"):
        failures.append(f"flash_lut forward launched {flash_rose}")
    x_logits = eng.forward(ftoks)
    agree = float((f_logits.argmax(-1) == x_logits.argmax(-1)).float().mean())
    out["flash_vs_xla"] = {"tokens": list(LM_FLASH_TOKENS),
                           "max_abs": float((f_logits - x_logits).abs().max()),
                           "argmax_agree": agree}
    if not bool(torch.isfinite(f_logits).all()) or agree < LM_FLASH_MIN_ARGMAX \
            or out["flash_vs_xla"]["max_abs"] > LM_FLASH_ATOL:
        failures.append(f"flash_lut forward against xla: "
                        f"{out['flash_vs_xla']}")
    del f_logits, x_logits, flash, eng
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    checks = {k: v - flash_rose[k] for k, v in _rise(checks).items()}
    path = {k: path[k] + flash_rose[k] for k in path}
    expected = {k: expected[k] + v
                for k, v in lm_expected(cfg, 1, "flash_lut").items()}
    out.update(check_launches=checks, launches=path, failures=failures)
    emit(out)
    if failures:
        raise AssertionError(f"{cfg.name}: " + "; ".join(failures))
    return path, checks, expected, params


# internlm2-1.8b on the int8 KV cache (cfg.quant.quantize_kv_cache).
# Decode against forward (prefill of 63 + one step, as LM_DECODE_REL's):
# measured 0.1388 on the card (PERF.md §6, PR 23), the float cache's 0.0405
# plus the cache's own noise: tools/lm_decode_gap.py --kv8 reads 0.0788
# with both LUTs off at float32 activations (the float cache: 1.4e-6),
# entering at layer 0 (0.016) and carried smoothly to layer 23 (0.025),
# no layer stepping out; each cached vector round-trips within 0.95 % rms
# (a step of up to 2 maxabs / 127).  Held to 0.2 with its argmax.  The
# int8 cache against the float one over a prefill of the 4 x 63 prompts
# and LM_KV8_STEPS decode steps teacher-forced with the float cache's
# greedy tokens: the largest logit gap over the float logits' largest
# magnitude, measured at most 0.1094 (held 0.15), and the share of equal
# greedy tokens, 0.985 (held 0.9).
LM_KV8_DECODE_REL = 0.2
LM_KV8_VS_FLOAT_REL = 0.15
LM_KV8_MIN_ARGMAX = 0.9
LM_KV8_STEPS = 32


def kv8_config(cfg):
    return cfg.with_(quant=QuantConfig(quantize_kv_cache=True))


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(state["layers"]))


def phase_lm_int8_kv(dev, params) -> tuple:
    """internlm2-1.8b at full width on the ``cuda`` plan with its KV cache
    in int8 (``QuantConfig(quantize_kv_cache=True)``: int8 codes and a
    float32 power-of-two scale per token and KV head), on the weights of
    ``lm_internlm2``: the same 8 requests on 4 slots, KV 256, through
    ``runtime.compile_model`` and ``LMScheduler`` (the path).  Then: the
    cache's leaves and bytes against the float cache's; ``_q8_vec`` on
    the card ``torch.equal`` to the CPU's on layer 0's real keys and
    values; prefill + decode against forward and a per-lane step equal to
    the scalar one; the int8 cache against the float cache, teacher-forced
    and free-running over the same schedule; p50 per decode step and per
    prefill of both caches.  Returns the path's launches, the launches of
    the checks and the path's expected."""
    cfg = registry.get(LM_NAME).config
    eng8 = runtime.compile_model(kv8_config(cfg), params, backend="cuda",
                                 device=dev)
    requests = lm_serve.make_requests(cfg, 8, 256, 0)
    met = telemetry.make_cell_metrics(telemetry.Registry())
    torch.cuda.reset_peak_memory_stats()
    sched = cellmod.LMScheduler(eng8, slots=LM_SLOTS, max_len=256,
                                metrics=met)
    for r in requests:
        sched.submit(r["id"], r["prompt"], r["gen"])
    before = ops.launch_counts()
    t0 = time.perf_counter()
    served = sched.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path = _rise(before)
    steps_run, prefills = met.decode_ms.count, met.prefill_ms.count
    expected = lm_expected(cfg, steps_run + prefills)
    if path != expected:
        raise AssertionError(f"the int8-cache scheduler launched {path}, "
                             f"expected {expected} ({steps_run} decode "
                             f"steps, {prefills} prefills)")
    for r in requests:
        got = served.get(r["id"], [])
        if len(got) != r["gen"] or not all(0 <= t < cfg.vocab_size
                                           for t in got):
            raise AssertionError(f"int8 cache, request {r['id']}: {len(got)}"
                                 f" tokens of {r['gen']}, or a pad id")
    layers = sched.state["layers"]
    leaves = {k: [str(v.dtype), list(v.shape)] for k, v in layers.items()}
    codes = (cfg.n_layers, LM_SLOTS, 256, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if leaves != {"k": ["torch.int8", list(codes)],
                  "ks": ["torch.float32", list(codes[:4])],
                  "v": ["torch.int8", list(codes)],
                  "vs": ["torch.float32", list(codes[:4])]}:
        raise AssertionError(f"the int8 cache's leaves: {leaves}")
    failures = []
    out = {"phase": "lm_int8_kv", "model": cfg.name, "slots": LM_SLOTS,
           "max_len": 256, "requests": len(requests),
           "serve_seconds": seconds, "decode_steps": steps_run,
           "prefills": prefills,
           "tokens_served": {str(k): len(v) for k, v in served.items()},
           "p50_decode_step_ms_served": met.decode_ms.quantile(0.5),
           "launches": path, "cache_leaves": leaves,
           "serve_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del sched

    # the checks
    checks = ops.launch_counts()
    eng = runtime.compile_model(cfg, params, backend="cuda", device=dev)
    fstate = eng.init_decode_state(LM_SLOTS, 256)
    out["cache_bytes"] = {
        "int8": state_bytes({"layers": layers}),
        "int8_reckoned": 2 * int(np.prod(codes)) + 2 * 4 * int(
            np.prod(codes[:4])),
        "float": state_bytes(fstate), "float_dtype": str(
            fstate["layers"]["k"].dtype)}
    del layers, fstate
    if out["cache_bytes"]["int8"] != out["cache_bytes"]["int8_reckoned"]:
        failures.append(f"int8 cache bytes: {out['cache_bytes']}")
    rng = np.random.default_rng(8)
    ptoks = rng.integers(0, cfg.vocab_size, (LM_SLOTS, 63)).astype(np.int32)
    # _q8_vec on the card against the CPU on layer 0's real K and V
    with recorded(lm_layers, "_q8_vec", keep=lambda i, a: i < 2) as kv:
        eng8.prefill(ptoks, eng8.init_decode_state(LM_SLOTS, 256))
    q8 = {}
    for name, (x,) in zip(("k", "v"), kv):
        qc, sc = lm_layers._q8_vec(x)
        qh, sh = lm_layers._q8_vec(x.cpu())
        require_equal(f"_q8_vec {name} codes", qc.cpu(), qh)
        require_equal(f"_q8_vec {name} scales", sc.cpu(), sh)
        m, _ = torch.frexp(sh)
        if not bool((m == 0.5).all()):
            failures.append(f"_q8_vec {name}: a scale is no power of two")
        # the cache's own noise: the round trip against the values
        err = lm_layers._q8_vec_decode(qh, sh, torch.float32) - x.cpu()
        xf = x.cpu().float()
        q8[name] = {"shape": list(x.shape), "dtype": str(x.dtype),
                    "scale_exponents": [int(torch.log2(sh).min()),
                                        int(torch.log2(sh).max())],
                    "roundtrip_rel_rms": float(err.norm() / xf.norm()),
                    "roundtrip_max_over_maxabs": float(
                        (err.abs().amax(-1) / xf.abs().amax(-1)).max()),
                    "equal": True}
    out["q8_vec_card_vs_cpu"] = q8
    del kv
    # prefill + decode against forward, and a per-lane step
    toks = rng.integers(0, cfg.vocab_size, LM_CHECK_TOKENS).astype(np.int32)
    fwd = eng8.forward(toks)[:, -1].float()
    state = eng8.init_decode_state(*LM_CHECK_TOKENS)
    _, state = eng8.prefill(toks[:, :-1], state)
    lanes = {"layers": {k: v.clone() for k, v in state["layers"].items()},
             "index": torch.full((LM_CHECK_TOKENS[0],), state["index"],
                                 dtype=torch.long, device=dev)}
    dec, _ = eng8.decode_step(toks[:, -1], state)
    dec_lanes, _ = eng8.decode_step(toks[:, -1], lanes)
    out["decode_vs_forward"] = {
        "rel": float((dec.float() - fwd).abs().max() / fwd.abs().max()),
        "argmax_equal": bool(torch.equal(dec.argmax(-1), fwd.argmax(-1))),
        "per_lane_equal": bool(torch.equal(dec, dec_lanes)),
        "limit": LM_KV8_DECODE_REL}
    dvf = out["decode_vs_forward"]
    if dvf["rel"] >= LM_KV8_DECODE_REL or not dvf["argmax_equal"] or \
            not dvf["per_lane_equal"]:
        failures.append(f"int8 cache: prefill + decode against forward: "
                        f"{dvf}")
    del fwd, state, lanes, dec, dec_lanes
    # the int8 cache against the float one, teacher-forced with the float
    # cache's greedy tokens
    s8 = eng8.init_decode_state(LM_SLOTS, 256)
    sf = eng.init_decode_state(LM_SLOTS, 256)
    l8, s8 = eng8.prefill(ptoks, s8)
    lf, sf = eng.prefill(ptoks, sf)
    rels, agree = [], []
    for _ in range(LM_KV8_STEPS + 1):
        lff = lf.float()
        rels.append(float((l8.float() - lff).abs().max() / lff.abs().max()))
        agree.append((l8.argmax(-1) == lf.argmax(-1)).float().mean().item())
        cur = lf.argmax(-1)
        l8, s8 = eng8.decode_step(cur, s8)
        lf, sf = eng.decode_step(cur, sf)
    del s8, sf, l8, lf
    out["int8_vs_float_cache"] = {
        "prompts": list(ptoks.shape), "steps": LM_KV8_STEPS,
        "prefill_rel": rels[0], "max_rel": max(rels),
        "rel_by_step": rels, "argmax_agree": float(np.mean(agree)),
        "limits": [LM_KV8_VS_FLOAT_REL, LM_KV8_MIN_ARGMAX]}
    if max(rels) >= LM_KV8_VS_FLOAT_REL or \
            np.mean(agree) < LM_KV8_MIN_ARGMAX:
        failures.append(f"int8 cache against the float cache: "
                        f"{out['int8_vs_float_cache']}")
    # free-running: the float cache's scheduler on the same requests
    # (recorded: greedy decoding carries a first differing token on)
    fsched = cellmod.LMScheduler(eng, slots=LM_SLOTS, max_len=256)
    for r in requests:
        fsched.submit(r["id"], r["prompt"], r["gen"])
    fserved = fsched.run()
    del fsched

    def prefix(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n

    out["schedule_vs_float_cache"] = {
        "requests_equal": sum(served[k] == fserved[k] for k in served),
        "requests": len(served),
        "equal_prefix_share": float(np.mean(
            [prefix(served[k], fserved[k]) / len(fserved[k])
             for k in served]))}
    # p50 per prefill and decode step, int8 and float caches in turns
    times = {}
    for tag, e in (("float", eng), ("int8", eng8), ("int8_again", eng8),
                   ("float_again", eng)):
        times[tag] = time_lm_calls(e, ptoks)[0]
    out["timed"] = times
    del eng, eng8
    gc.collect()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    checks = _rise(checks)
    out.update(check_launches=checks, failures=failures)
    emit(out)
    if failures:
        raise AssertionError(f"{cfg.name} int8 cache: " + "; ".join(failures))
    return path, checks, expected


def seeded_lm_params(cfg, seed: int) -> dict:
    """Every leaf of the port's LM layout (the encdec family's too) random,
    from a numpy seed (matrices fan-in scaled, biases small, norm scales
    around 1)."""
    layout = steps.model_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)

    def walk(tree, stacked=False, norm=False):
        if isinstance(tree, dict):
            return {k: walk(v, stacked or k in ("blocks", "enc_blocks",
                                                "dec_blocks"),
                            norm or k in ("ln1", "ln2", "ln3", "ln_f",
                                          "ln_enc", "ln_dec", "q_norm",
                                          "k_norm", "ln_x", "out_norm_a",
                                          "out_norm_m"))
                    for k, v in tree.items()}
        shape = tuple(tree.shape)
        per = shape[1:] if stacked else shape
        if norm:
            return rng.normal(1.0, 0.1, shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, shape).astype(np.float32)

    return walk(layout)


# the recurrent smoke configs of phase lm_dense_smoke: rwkv6-3b in its
# projection layouts, hymba-1.5b (window 8)
SMOKE_RECURRENT = [(RWKV_NAME, {}), (RWKV_NAME, {"rwkv_fused_proj": True}),
                   (RWKV_NAME, {"rwkv_head_pad": True}), (HYMBA_NAME, {})]
RING_WRAP_TOKENS = 20         # hymba's smoke ring of 8 slots wraps twice


def phase_lm_smoke(dev) -> dict:
    """The five dense smoke configs, the two moe ones and the recurrent
    ones (rwkv6-3b in three layouts, hymba-1.5b) on the card under float,
    lut and cuda: decode == forward (a moe config at the drop-free capacity
    factor, on a plan that shares the weights; a hybrid one on a prompt
    within its window), and each plan against the same plan on the CPU
    (the cuda plan there through its kernels' plain versions); the cuda
    plan's launches per call; hymba decoded token by token across its
    ring's wrap against forward."""
    out = {"phase": "lm_dense_smoke", "configs": []}
    failures = []
    for name, kw in [(n, {}) for n in registry.DENSE + [MOE_NAME,
                     "deepseek-moe-16b"]] + SMOKE_RECURRENT:
        cfg = registry.get(name).smoke.with_(**kw)
        moe = cfg.family == "moe"
        np_tree = seeded_lm_params(cfg, 0)
        # a hybrid prefill longer than the window leaves the ring empty (C10)
        s = min(16, cfg.sliding_window) if cfg.family == "hybrid" else 16
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, s)).astype(np.int32)
        row = {"model": name, "variant": kw, "plans": {}}
        costs = {}
        for plan in ("float", "lut", "cuda"):
            eng = runtime.compile_model(
                cfg, convert.from_numpy_tree(np_tree, dev), backend=plan,
                device=dev)
            cpu = runtime.compile_model(
                cfg, convert.from_numpy_tree(np_tree, "cpu"), backend=plan,
                device="cpu", plain_kernels=plan == "cuda")
            dec_eng = dataclasses.replace(eng, exec_cfg=eng.exec_cfg.with_(
                capacity_factor=MOE_DROP_FREE)) if moe else eng
            before = ops.launch_counts()
            fwd = eng.forward(toks)
            ref_last = (dec_eng.forward(toks) if moe else fwd)[:, -1]
            # caches as long as the forward: the same rows in the softmax
            state = dec_eng.init_decode_state(*toks.shape)
            _, state = dec_eng.prefill(toks[:, :-1], state)
            dec, _ = dec_eng.decode_step(toks[:, -1], state)
            rose = _rise(before)
            want = lm_expected(cfg, 4 if moe else 3) if plan == "cuda" else \
                {k: 0 for k in rose}
            if rose != want:
                failures.append(f"{name} {plan}: launched {rose}, expected "
                                f"{want}")
            # the plan priced the same on the card and on the CPU
            cost = require_same_cost(f"{name} {kw} {plan}",
                                     perf.engine_cost(eng, batch=2),
                                     perf.engine_cost(cpu, batch=2))
            costs[plan] = {k: cost[k] for k in ("flops", "bytes_moved",
                                                "matmul_flops")}
            rel = float((dec - ref_last).abs().max() / ref_last.abs().max())
            on_cpu = cpu.forward(toks)
            diff = float((fwd.cpu() - on_cpu).abs().max())
            agree = float((fwd.cpu().argmax(-1) == on_cpu.argmax(-1))
                          .float().mean())
            if plan == "float":
                atol = LM_SMOKE_FLOAT_ATOL
            else:
                head = quant.resident_values(cpu.params["lm_head"])
                atol = LM_SMOKE_CODE_FLIPS * float(head.abs().max()) \
                    * 2.0 ** -cpu.exec_cfg.quant.input_exponent
            row["plans"][plan] = {"decode_vs_forward_rel": rel,
                                  "card_vs_cpu_max_abs": diff,
                                  "card_vs_cpu_atol": atol,
                                  "card_vs_cpu_argmax_agree": agree}
            ok = rel < LM_REF_DECODE_REL and diff <= atol and \
                agree >= LM_SMOKE_MIN_ARGMAX
            if cfg.family == "hybrid":
                wrap = ring_wrap_rel(eng, cfg)
                row["plans"][plan]["ring_wrap_rel"] = wrap
                ok = ok and wrap < LM_REF_DECODE_REL
            if not ok:
                failures.append(f"{name} {kw} {plan}: {row['plans'][plan]}")
        row["cost"] = costs
        if len({c["matmul_flops"] for c in costs.values()}) != 1:
            failures.append(f"{name} {kw}: the plans' products differ: "
                            f"{costs}")
        out["configs"].append(row)
    out["configs"] += smoke_int8_kv(dev, failures)
    out["configs"].append(smoke_encdec(dev, failures))
    out["configs"].append(smoke_encdec(dev, failures, kv8=True))
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


# the int8 KV cache on the smoke configs: a dense one, a moe one at the
# drop-free capacity factor, hymba on a prompt within its window and
# across its ring's wrap.  The card's decode logits against the CPU's on
# the same plan to the limits of the float-cache rows (LM_SMOKE_*), and
# the card's decode-vs-forward gap to the CPU's within LM_SMOKE_GAP_ATOL
# (the gap itself is the int8 cache's, 0.01-0.04 on these configs in the
# CPU tests, tests/test_torch_kvcache.py)
SMOKE_INT8 = ("internlm2-1.8b", MOE_NAME, HYMBA_NAME)
LM_SMOKE_GAP_ATOL = 1e-3


def smoke_atol(cpu, plan: str) -> float:
    """Card against CPU on a smoke plan: 1e-4 on ``float``, two steps of
    the head's eq-9 input on the integer plans (see LM_SMOKE_*)."""
    if plan == "float":
        return LM_SMOKE_FLOAT_ATOL
    head = quant.resident_values(cpu.params["lm_head"])
    return LM_SMOKE_CODE_FLIPS * float(head.abs().max()) \
        * 2.0 ** -cpu.exec_cfg.quant.input_exponent


def smoke_int8_kv(dev, failures: list) -> list:
    """``SMOKE_INT8`` on the int8 KV cache under float, lut and cuda, on
    the card and on the CPU: forward's last logits, prefill of S - 1 +
    one decode step (hymba also 20 tokens decoded across its ring's
    wrap); the caches int8 codes and float32 scales; the cuda plan's
    launches on the card, none on the CPU."""
    rows = []
    for name in SMOKE_INT8:
        kw = {"capacity_factor": MOE_DROP_FREE} if name == MOE_NAME else {}
        base = registry.get(name).smoke.with_(**kw)
        cfg = kv8_config(base)
        np_tree = seeded_lm_params(base, 0)
        hybrid = cfg.family == "hybrid"
        s = cfg.sliding_window if hybrid else 16
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, s)).astype(np.int32)
        row = {"model": name, "variant": {**kw, "quantize_kv_cache": True},
               "plans": {}}
        for plan in ("float", "lut", "cuda"):
            res = []
            for where in (dev, torch.device("cpu")):
                e = runtime.compile_model(
                    cfg, convert.from_numpy_tree(np_tree, where),
                    backend=plan, device=where,
                    plain_kernels=where.type == "cpu" and plan == "cuda")
                before = ops.launch_counts()
                fwd = e.forward(toks)[:, -1]
                st = e.init_decode_state(*toks.shape)
                _, st = e.prefill(toks[:, :-1], st)
                dec, st = e.decode_step(toks[:, -1], st)
                kv = st["layers"]["kv"] if hybrid else st["layers"]
                r = {"fwd": fwd.cpu(), "dec": dec.cpu(),
                     "leaves": sorted((k, str(v.dtype)) for k, v in
                                      kv.items())}
                if hybrid:
                    r["wrap"], r["wrap_fwd"] = ring_wrap(e, cfg)
                r["rose"] = _rise(before)
                if where.type == "cpu":
                    r["atol"] = smoke_atol(e, plan)
                res.append(r)
                del e, st
            card, cpu = res
            calls = 3 + (RING_WRAP_TOKENS + 1 if hybrid else 0)
            want = lm_expected(cfg, calls) if plan == "cuda" else \
                {k: 0 for k in card["rose"]}
            if card["rose"] != want or any(cpu["rose"].values()):
                failures.append(f"{name} int8 cache {plan}: launched "
                                f"{card['rose']} on the card, {cpu['rose']} "
                                f"on the cpu, expected {want}")
            if card["leaves"] != [("k", "torch.int8"),
                                  ("ks", "torch.float32"),
                                  ("v", "torch.int8"),
                                  ("vs", "torch.float32")]:
                failures.append(f"{name} int8 cache leaves: {card['leaves']}")

            def gap(a, b):
                return float((a - b).abs().max() / b.abs().max())

            got = {"decode_vs_forward_rel": gap(card["dec"], card["fwd"]),
                   "cpu_decode_vs_forward_rel": gap(cpu["dec"], cpu["fwd"]),
                   "card_vs_cpu_max_abs": float(
                       (card["dec"] - cpu["dec"]).abs().max()),
                   "card_vs_cpu_atol": cpu["atol"]}
            ok = got["card_vs_cpu_max_abs"] <= cpu["atol"] and \
                abs(got["decode_vs_forward_rel"]
                    - got["cpu_decode_vs_forward_rel"]) < LM_SMOKE_GAP_ATOL
            if hybrid:
                got.update(
                    ring_wrap_rel=gap(card["wrap"], card["wrap_fwd"]),
                    cpu_ring_wrap_rel=gap(cpu["wrap"], cpu["wrap_fwd"]),
                    ring_wrap_card_vs_cpu_max_abs=float(
                        (card["wrap"] - cpu["wrap"]).abs().max()))
                ok = ok and got["ring_wrap_card_vs_cpu_max_abs"] <= \
                    cpu["atol"] and abs(got["ring_wrap_rel"]
                                        - got["cpu_ring_wrap_rel"]) \
                    < LM_SMOKE_GAP_ATOL
            row["plans"][plan] = got
            if not ok:
                failures.append(f"{name} int8 cache {plan}: {got}")
        rows.append(row)
    return rows


def smoke_encdec(dev, failures: list, kv8: bool = False) -> dict:
    """whisper-large-v3's smoke config at module level under the float,
    lut and cuda plans' exec_cfg, on the card and on the CPU (the cuda
    plan there through its kernels' plain versions): decode == forward
    within the reference's 1e-3, the card against the CPU to
    ``LM_SMOKE_FLOAT_ATOL`` on every plan (measured 8.3e-7 float, 7.2e-7
    lut and cuda: no LUT bin moves between the card and the host on
    these seeded inputs, so a moved bin is a fault), and the cuda
    plan's launches (two encoder passes — ``encode`` and the prefill's —,
    two decoder passes and a decode step).  With ``kv8`` the decoder's
    self cache is int8 (the cross caches stay float): the decode step's
    logits too are held card against CPU, and the decode's gap to
    ``decode_train`` (the int8 cache's, not 1e-3) to the CPU's within
    ``LM_SMOKE_GAP_ATOL``."""
    cfg = registry.get(WHISPER_NAME).smoke
    np_tree = seeded_lm_params(cfg, 0)
    if kv8:
        cfg = kv8_config(cfg)
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int64)
    row = {"model": WHISPER_NAME,
           "variant": {"quantize_kv_cache": True} if kv8 else {},
           "plans": {}}
    for plan in ("float", "lut", "cuda"):
        xc = runtime.get_backend(plan).configure(cfg)
        res = []                          # the card's, then the CPU's
        for where in (dev, torch.device("cpu")):
            p = convert.from_numpy_tree(np_tree, where)
            f, t = (torch.from_numpy(a).to(where) for a in (frames, toks))
            before = ops.launch_counts()
            with torch.inference_mode():
                fwd = encdec.decode_train(p, encdec.encode(p, f, xc), t, xc)
                st = encdec.init_decode_state(xc, 2, t.shape[1], device=where)
                _, st = encdec.prefill(p, f, t[:, :-1], xc, st)
                dec, _ = encdec.decode_step(p, t[:, -1], xc, st)
            if kv8 and st["layers"]["kv"]["k"].dtype != torch.int8:
                failures.append(f"whisper smoke {plan}: the self cache is "
                                f"{st['layers']['kv']['k'].dtype}")
            res.append((fwd.cpu(), dec.cpu(), _rise(before)))
        (fwd, dec, rose), (cpu_fwd, cpu_dec, cpu_rose) = res
        want = whisper_expected(cfg, 2, 1, 0) if plan == "cuda" else \
            {k: 0 for k in rose}
        if rose != want or any(cpu_rose.values()):
            failures.append(f"whisper smoke {plan}: launched {rose} on the "
                            f"card, {cpu_rose} on the cpu, expected {want}")
        diff = float((fwd - cpu_fwd).abs().max())
        atol = LM_SMOKE_FLOAT_ATOL
        r = {"decode_vs_forward_max_abs": float((dec - fwd[:, -1]).abs()
                                                .max()),
             "card_vs_cpu_max_abs": diff, "card_vs_cpu_atol": atol,
             "card_vs_cpu_argmax_agree": float(
                 (fwd.argmax(-1) == cpu_fwd.argmax(-1)).float().mean())}
        row["plans"][plan] = r
        if kv8:
            last, cpu_last = fwd[:, -1], cpu_fwd[:, -1]
            r.update(decode_vs_forward_rel=float(
                (dec - last).abs().max() / last.abs().max()),
                cpu_decode_vs_forward_rel=float(
                    (cpu_dec - cpu_last).abs().max() / cpu_last.abs().max()),
                decode_card_vs_cpu_max_abs=float(
                    (dec - cpu_dec).abs().max()))
            bad = r["decode_card_vs_cpu_max_abs"] > atol or abs(
                r["decode_vs_forward_rel"] - r["cpu_decode_vs_forward_rel"]) \
                >= LM_SMOKE_GAP_ATOL
        else:
            bad = r["decode_vs_forward_max_abs"] >= WHISPER_REF_DECODE_ATOL
        if bad or diff > atol or \
                r["card_vs_cpu_argmax_agree"] < LM_SMOKE_MIN_ARGMAX:
            failures.append(f"whisper smoke {plan} {row['variant']}: {r}")
    return row


def ring_wrap(eng, cfg) -> tuple:
    """``RING_WRAP_TOKENS`` tokens decoded one at a time into a fresh
    state (the ring wraps), and ``forward`` of them: both logits, float32
    on the CPU."""
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, RING_WRAP_TOKENS)).astype(np.int32)
    state = eng.init_decode_state(2, 64)
    outs = []
    for t in range(RING_WRAP_TOKENS):
        lg, state = eng.decode_step(toks[:, t], state)
        outs.append(lg)
    return torch.stack(outs, 1).float().cpu(), \
        eng.forward(toks).float().cpu()


def ring_wrap_rel(eng, cfg) -> float:
    """``ring_wrap``'s largest gap over the forward's largest magnitude."""
    dec, ref = ring_wrap(eng, cfg)
    return float((dec - ref).abs().max() / ref.abs().max())


MOE_SERVE_ARGS = ["--arch", MOE_NAME, "--backend", "cuda", "--requests",
                  "8", "--slots", str(LM_SLOTS), "--max-len", "256",
                  "--seed", "0"]
# the reference's own decode == forward test raises the capacity factor to
# 8.0, where no slot drops (tests/test_models.py); granite's 1.25 drops
# slots of hot experts in a join prefill of 4 x 63 tokens (C = 64 against
# a mean load of 50.4), and a join group shares that capacity (ROADMAP C8)
MOE_DROP_FREE = 8.0
# prefill of S - 1 tokens + one decode step against forward's last logits
# at the drop-free factor, over the real vocabulary.  tools/lm_decode_gap.py
# takes the gap apart (PERF.md §6, PR 19): the integer plans' blocks are a
# float32 view, and at bf16 activations the float32 products' other
# rounding at another row count turns into bf16 steps from layer 1 on,
# which a random moe's large expert outputs carry and which from layer 24
# flip routes; measured on the card: 0.3146 on cuda (argmax equal, 92.2 %
# of the last position's expert sets equal), 0.0074 on the same plan at
# float32 activations with every route equal, 0.0 on the bf16 float plan,
# 1.88e-5 on the float plan at float32.  So the cuda plan is held to
# MOE_DECODE_REL with its argmax, the cuda plan at float32 activations to
# MOE_F32_DECODE_REL with every route equal, and the float plan at float32
# to the reference's rel 1e-4 (tests/test_models.py)
MOE_DECODE_REL = 0.5
MOE_F32_DECODE_REL = 0.02
MOE_ORDER_GEN = 16            # budget of each request in the order checks


@contextlib.contextmanager
def moe_routes():
    """While open, each moe block's routing is taken again on its input,
    beside the block, and recorded per call: the expert ids ``[T, k]``,
    the keep mask, and whether the softmax kernel on the router logits
    was ``torch.equal`` to its plain version (these softmax launches are
    checks of no path)."""
    seen = []
    block = lm_moe.apply_moe

    def recording(p, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        logits = xt.to(torch.float32) @ p["router"]
        equal = bool(torch.equal(ops.lut_softmax(logits, fixed=True),
                                 ref.lut_softmax(logits, fixed=True)))
        _, idx = lm_moe._route(xt, p["router"], cfg)
        _, _, keep = lm_moe._slots(idx, e_lo=0,
                                   e_n=lm_moe.padded_experts(cfg),
                                   C=lm_moe._capacity(xt.shape[0], cfg))
        seen.append({"idx": idx, "keep": keep, "equal": equal})
        return block(p, x, cfg)

    lm_moe.apply_moe = recording
    try:
        yield seen
    finally:
        lm_moe.apply_moe = block


def route_agreement(fwd_routes, dec_routes, lanes: int) -> dict:
    """The last position's experts in a forward against a decode step's,
    over (layer, lane): the share with the same set, and with the same
    slot order."""
    same_set = same_order = 0
    for f, d in zip(fwd_routes, dec_routes):
        fi = f["idx"].reshape(lanes, -1, f["idx"].shape[-1])[:, -1]
        di = d["idx"].reshape(lanes, -1)
        same_order += int((fi == di).all(dim=-1).sum())
        same_set += int((fi.sort(dim=-1).values == di.sort(dim=-1).values)
                        .all(dim=-1).sum())
    n = lanes * len(dec_routes)
    return {"expert_set_agree": same_set / n, "slot_order_agree": same_order / n}


def phase_lm_granite_moe(dev, tmp: str, roof) -> tuple:
    """granite-moe-3b-a800m at full width (32 layers, d 1536, 24 heads / 8
    KV, head_dim 64, 40 experts padded to 48, top-8, expert_d_ff 512,
    vocab 49155, bf16; random weights drawn on the card from the seed)
    served through ``repro_torch.launch.serve --backend cuda`` with tracing
    on: 8 requests on 4 slots.  Then on the same weights: at the drop-free
    capacity factor, prefill + decode against forward (``cuda``, and
    ``cuda`` and ``float`` at float32 activations with every route of the
    last position equal), a per-lane step equal to the scalar one and the
    same requests in two orders; at the config's 1.25, the softmax kernel
    on every layer's router logits of one 4 x 63 prefill against its plain
    version, that prefill's dropped slots and whether two orders differ
    (recorded); ``cuda`` against ``lut`` (recorded); p50 ms per decode
    step and per prefill, ATen ops per step, peak GB; the forward of the
    4 x 63 prefill tokens priced by ``perf.engine_cost`` beside its p50
    against ``roof``.  Returns the path's launches (the served run), the
    launches of the checks, and the path's expected."""
    cfg = registry.get(MOE_NAME).config
    trace = os.path.join(tmp, "moe_serve.json")
    argv = MOE_SERVE_ARGS + ["--telemetry-out", trace]
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    served, log = run_lm_serve(argv)
    seconds = time.perf_counter() - t0
    path = _rise(before)
    done = log_fields(log, "serve_done")
    telemetry_check.check_artifacts(trace, require_metrics=True)
    metrics = json.loads(Path(trace).with_suffix(".metrics.json").read_text())
    steps_run = metrics["cell_decode_latency_ms"]["summary"]["n"]
    prefills = metrics["cell_prefill_latency_ms"]["summary"]["n"]
    expected = lm_expected(cfg, steps_run + prefills)
    if path != expected:
        raise AssertionError(f"the moe server launched {path}, expected "
                             f"{expected} ({steps_run} decode steps, "
                             f"{prefills} prefills)")
    requests = lm_serve.make_requests(cfg, 8, 256, 0)
    for r in requests:
        got = served.get(r["id"], [])
        if len(got) != r["gen"] or not all(0 <= t < cfg.vocab_size
                                           for t in got):
            raise AssertionError(f"request {r['id']}: {len(got)} tokens of "
                                 f"{r['gen']}, or a pad id")
    if metrics["cell_tokens_total"]["value"] != sum(r["gen"] for r in requests):
        raise AssertionError("cell_tokens_total is not the tokens served")
    gc.collect()                        # the server's plan, before the next
    out = {"phase": "lm_granite_moe", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": [cfg.n_experts, lm_moe.padded_experts(cfg)],
           "top_k": cfg.top_k, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "argv": argv, "serve_seconds": seconds, "serve_done": done,
           "tokens_served": {str(k): len(v) for k, v in served.items()},
           "decode_steps": steps_run, "prefills": prefills,
           "launches": path, "launches_per_call": lm_expected(cfg, 1),
           "serve_peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    # the checks, on plans of the same seed's weights; the drop-free plan
    # shares the cuda plan's weights
    checks = ops.launch_counts()
    params = lm_model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = runtime.compile_model(cfg, params, backend="cuda", device=dev)
    free = dataclasses.replace(
        eng, exec_cfg=eng.exec_cfg.with_(capacity_factor=MOE_DROP_FREE))
    out["describe"] = eng.describe()
    out["param_bytes"], out["rom_bytes"] = eng.param_bytes, eng.rom_bytes
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, LM_CHECK_TOKENS).astype(np.int32)
    failures = []
    out["decode_vs_forward"] = {}
    plans = (("cuda", free),
             ("cuda_float32", dataclasses.replace(
                 free, exec_cfg=free.exec_cfg.with_(dtype="float32"))),
             ("float", runtime.compile_model(
                 cfg.with_(capacity_factor=MOE_DROP_FREE), params,
                 backend="float", device=dev)),
             ("float32", runtime.compile_model(
                 cfg.with_(dtype="float32", capacity_factor=MOE_DROP_FREE),
                 params, backend="float", device=dev)))
    for plan, e in plans:
        with moe_routes() as fwd_routes:
            f = e.forward(toks)
        if tuple(f.shape) != (*LM_CHECK_TOKENS, cfg.padded_vocab) or \
                not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{cfg.name} {plan}: bad forward logits")
        state = e.init_decode_state(LM_CHECK_TOKENS[0], LM_CHECK_TOKENS[1])
        _, state = e.prefill(toks[:, :-1], state)
        lanes = {"layers": {k: v.clone() for k, v in state["layers"].items()},
                 "index": torch.full((LM_CHECK_TOKENS[0],), state["index"],
                                     dtype=torch.long, device=dev)}
        with moe_routes() as dec_routes:
            dec, _ = e.decode_step(toks[:, -1], state)
        dec_lanes, _ = e.decode_step(toks[:, -1], lanes)
        # the real vocabulary: the pad ids' -1e30 would hide every gap
        last = f[:, -1, :cfg.vocab_size].float()
        dec = dec[:, :cfg.vocab_size].float()
        out["decode_vs_forward"][plan] = {
            "rel": float((dec - last).abs().max() / last.abs().max()),
            "argmax_equal": bool(torch.equal(dec.argmax(-1),
                                             last.argmax(-1))),
            "per_lane_equal": bool(torch.equal(
                dec, dec_lanes[:, :cfg.vocab_size].float())),
            **route_agreement(fwd_routes, dec_routes, LM_CHECK_TOKENS[0])}
        del f, state, lanes, dec, dec_lanes, e, fwd_routes, dec_routes
    del plans
    dvf = out["decode_vs_forward"]
    for plan, lim in (("cuda", MOE_DECODE_REL),
                      ("cuda_float32", MOE_F32_DECODE_REL),
                      ("float32", LM_REF_DECODE_REL)):
        if dvf[plan]["rel"] >= lim or not dvf[plan]["argmax_equal"]:
            failures.append(f"{plan}: prefill + decode_step against forward: "
                            f"{dvf[plan]}, over {lim} or another greedy "
                            "token")
    for plan in ("cuda_float32", "float32"):
        if dvf[plan]["expert_set_agree"] != 1.0:
            failures.append(f"{plan}: a decode step routes to other experts "
                            f"than the forward: {dvf[plan]}")
    if not all(v["per_lane_equal"] for v in dvf.values()):
        failures.append(f"a per-lane decode step differs from the scalar "
                        f"one: {dvf}")
    # the same requests in two orders (budgets cut to MOE_ORDER_GEN: two
    # join groups and their decode steps): equal tokens where nothing
    # drops; at the config's factor, recorded
    short = [{**r, "gen": min(r["gen"], MOE_ORDER_GEN)} for r in requests]
    a = lm_schedule(free, short, range(len(short)))
    b = lm_schedule(free, short, reversed(range(len(short))))
    if a != b or sorted(a) != [r["id"] for r in short]:
        failures.append("drop-free tokens depend on the submission order")
    out["order_invariant_requests"] = len(a)
    a = lm_schedule(eng, short, range(len(short)))
    b = lm_schedule(eng, short, reversed(range(len(short))))
    ptoks = rng.integers(0, cfg.vocab_size, (LM_SLOTS, 63)).astype(np.int32)
    with moe_routes() as routes:
        eng.prefill(ptoks, eng.init_decode_state(LM_SLOTS, 256))
    equal = [r["equal"] for r in routes]
    drops = [int((~r["keep"]).sum()) for r in routes]
    del routes
    if not all(equal):
        failures.append(f"the softmax kernel differs from its plain version "
                        f"on the router logits of layers "
                        f"{[i for i, e in enumerate(equal) if not e]}")
    out["router_rows_equal"] = {"rows": list(ptoks.shape), "layers":
                                len(equal), "equal": all(equal)}
    out["capacity_1_25"] = {
        "prefill_tokens": list(ptoks.shape),
        "capacity": lm_moe._capacity(ptoks.size, cfg),
        "slots": ptoks.size * cfg.top_k, "dropped_per_layer": drops,
        "dropped": sum(drops), "order_gen": MOE_ORDER_GEN,
        "orders_differ": a != b,
        "requests_differing": sum(a[k] != b[k] for k in a)}
    # p50 per decode step and per prefill, 4 slots, and ATen ops per step
    timed, cur, state = time_lm_calls(eng, ptoks)
    with CountOps() as counter:
        eng.decode_step(cur, state)
    del state
    out.update(timed, prefill_tokens=list(ptoks.shape),
               decode_tok_s=LM_SLOTS / (timed["p50_decode_step_ms"] / 1e3),
               aten_ops_per_decode_step=counter.n)
    out["priced_forward"] = price_lm_forward(eng, ptoks, roof, cfg.name)
    # cuda against lut (recorded: the attention's masked renormalisation
    # sets them apart by design)
    fwd = eng.forward(toks)
    del eng, free
    lut = runtime.compile_model(cfg, params, backend="lut", device=dev)
    del params
    lut_logits = lut.forward(toks)
    del lut
    out["cuda_vs_lut"] = {
        "max_abs": float((fwd - lut_logits).abs().max()),
        "argmax_agree": float((fwd.argmax(-1) == lut_logits.argmax(-1))
                              .float().mean())}
    del fwd, lut_logits
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    checks = _rise(checks)
    out.update(check_launches=checks, failures=failures)
    emit(out)
    if failures:
        raise AssertionError(f"{cfg.name}: " + "; ".join(failures))
    return path, checks, expected


# prefill of 63 tokens + one decode step (a state of 64 slots) against
# forward's last logits over 64, on the cuda plan at bf16, over the real
# vocabulary; set from the gap measured on an H100 80GB HBM3 at 700 W
# (PERF.md §6, tools/lm_decode_gap.py): 0.0810 (rwkv6-3b) and 0.0551 (hymba-1.5b) on
# cuda, 0.0154 / 0.0248 on the bf16 float plan, 2.3e-6 / 2.0e-6 on float
# at float32 activations.  With float32 activations and exact sigmoid /
# SiLU / softplus, decode == forward at the logits to the bit; the LUT
# bins (a ulp of the float32 products at another row count takes the
# neighbouring bin of the sigmoid table), the bf16 residual stream and the
# head's eq-9 codes turn that rounding into steps that 32 random layers
# carry on, as for the dense LM.  Greedy tokens: equal, or (bf16 plans)
# a near tie — the forward's top two within twice that lane's gap (rwkv's
# vocabulary of 65536 random logits: one lane of two flipped in run 1).
RECURRENT_DECODE_REL = {RWKV_NAME: 0.15, HYMBA_NAME: 0.1}
# state continuity, a prefill of 31 then 32 tokens against one of 63:
# every chunk after the first falls elsewhere, so more of the sequence
# rounds apart than in a decode step; measured on the same card 0.2592 /
# 0.0732 on cuda, 2.6e-5 / 4.1e-6 on float at float32 (PERF.md §6).  A
# lost state reads near 1 (ROADMAP C10's empty ring: 1.10)
RECURRENT_SPLIT = 31
RECURRENT_CONTINUITY_REL = 0.5
RECURRENT_TIMED_PREFILLS = 5


@contextlib.contextmanager
def recorded(module, name: str, keep=lambda i, args: True):
    """While open, ``module.name`` records the positional arguments of the
    calls whose index ``keep(i, args)`` accepts (the tensors cloned)."""
    seen, calls = [], [0]
    fn = getattr(module, name)

    def recording(*args, **kw):
        if keep(calls[0], args):
            seen.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                              else a for a in args))
        calls[0] += 1
        return fn(*args, **kw)

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def drain_batch(prefill, decode_step, state, steps: int) -> dict:
    """Serving as one drain batch, as the reference serves the recurrent
    families and the encoder-decoder: one ``prefill(state)`` of every
    lane's prompt, then ``steps`` greedy ``decode_step(token, state)``
    calls on every lane.  Returns each lane's decoded tokens, the
    prefill's and each step's milliseconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(state)
    cur = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tokens, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, state = decode_step(cur, state)
        cur = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(cur)
    return {"tokens": torch.stack(tokens, 1).cpu(), "prefill_ms": prefill_ms,
            "step_ms": step_ms}


def greedy_check(got, want) -> dict:
    """Greedy tokens of ``got`` against ``want`` ([B, V], float): equal,
    or a near tie, where a lane's tokens differ while the forward's top two
    lie within twice that lane's largest gap."""
    eq = got.argmax(-1) == want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    tie = margin <= 2 * (got - want).abs().amax(-1)
    return {"argmax_equal": bool(eq.all()),
            "near_tie_lanes": int((~eq & tie).sum()),
            "greedy_ok": bool((eq | tie).all()),
            "top2_margin": margin.tolist()}


def require_head_equal(eng, xs: list, what: str) -> dict:
    """The head kernel (the cuda plan's packed ``lm_head`` product) on real
    final hidden states against its plain version, ``torch.equal``."""
    w, q = eng.params["lm_head"], eng.exec_cfg.quant
    for x in xs:
        got = ops.int8_matmul(x, w, x_exp=q.input_exponent,
                              residual_bits=q.residual_bits)
        want = quant.int_exec_einsum("...d,dv->...v", x, w,
                                     x_exp=q.input_exponent,
                                     residual_bits=q.residual_bits)
        require_equal(f"{what} head {tuple(x.shape)} {x.dtype}", got, want)
    return {"calls": len(xs), "shapes": [list(x.shape) for x in xs],
            "dtype": str(xs[0].dtype), "equal": True}


def require_softmax_equal(seen: list, what: str) -> dict:
    """The softmax kernel on real masked scores (every recorded layer)
    against its plain version, ``torch.equal``."""
    for i, (s, mask) in enumerate(seen):
        require_equal(f"{what} masked softmax, layer {i}",
                      approx.masked_softmax(s, mask, mode="cuda"),
                      masked_plain(s, mask))
    return {"layers": len(seen), "scores": list(seen[0][0].shape),
            "mask": list(seen[0][1].shape), "equal": True}


def phase_lm_recurrent(dev, name: str, roof) -> tuple:
    """A recurrent LM at full width (rwkv6-3b or hymba-1.5b, bf16; random
    weights drawn on the card by the port's ``init_params`` from seed 0)
    served on the ``cuda`` plan as one drain batch (``drain_batch``): 4
    requests of 63 tokens, 64 decode steps.  Then on the same weights:
    the head kernel on real hidden states, hymba's softmax kernel on real
    masked scores (prefill and ring decode), prefill + decode against
    forward (``cuda``; ``float``; ``float`` at float32 activations),
    rwkv's per-lane step against the scalar one, state continuity,
    ``cuda`` against ``lut``, p50 ms per decode step and per prefill,
    ATen ops per step, peak GB; the forward of the 4 x 63 prompts priced
    by ``perf.engine_cost`` beside its p50 against ``roof``.  Returns the
    path's launches (the drain batch), the launches of the checks, and the
    path's expected."""
    t_phase = time.perf_counter()
    cfg = registry.get(name).config
    hybrid = cfg.family == "hybrid"
    torch.cuda.reset_peak_memory_stats()
    params = lm_model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = runtime.compile_model(cfg, params, backend="cuda", device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (RECURRENT_LANES, RECURRENT_PROMPT)).astype(np.int32)
    # the path: one drain batch
    before = ops.launch_counts()
    t0 = time.perf_counter()
    served = drain_batch(
        functools.partial(eng.prefill, prompts), eng.decode_step,
        eng.init_decode_state(RECURRENT_LANES, RECURRENT_SLOTS),
        RECURRENT_STEPS)
    serve_seconds = time.perf_counter() - t0
    path = _rise(before)
    expected = lm_expected(cfg, 1 + RECURRENT_STEPS)
    if path != expected:
        raise AssertionError(f"the {name} drain batch launched {path}, "
                             f"expected {expected}")
    toks = served["tokens"]
    if tuple(toks.shape) != (RECURRENT_LANES, RECURRENT_STEPS) or \
            int(toks.max()) >= cfg.vocab_size or int(toks.min()) < 0:
        raise AssertionError(f"{name}: {tuple(toks.shape)} tokens served, "
                             "or a pad id")
    step_p50 = statistics.median(served["step_ms"])
    out = {"phase": f"lm_{'hymba' if hybrid else 'rwkv6'}", "model": name,
           "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": cfg.dtype, "describe": eng.describe(),
           "param_bytes": eng.param_bytes, "rom_bytes": eng.rom_bytes,
           "requests": RECURRENT_LANES, "prompt": RECURRENT_PROMPT,
           "decode_steps": RECURRENT_STEPS, "slots": RECURRENT_SLOTS,
           "tokens_served": {str(i): len(t) for i, t in enumerate(toks.tolist())},
           "serve_seconds": serve_seconds,
           "served_prefill_ms": served["prefill_ms"],
           "p50_decode_step_ms": step_p50,
           "decode_tok_s": RECURRENT_LANES / (step_p50 / 1e3),
           "launches": path, "launches_per_call": lm_expected(cfg, 1),
           "serve_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del served
    failures = []

    # the checks
    checks = ops.launch_counts()
    with recorded(lm_model, "_head") as heads, \
            recorded(approx, "masked_softmax") as pre_scores:
        state = eng.init_decode_state(RECURRENT_LANES, RECURRENT_SLOTS)
        logits, state = eng.prefill(prompts, state)
    with recorded(lm_model, "_head") as dheads, \
            recorded(approx, "masked_softmax") as dec_scores:
        eng.decode_step(logits.argmax(-1), state)
    out["head_equal"] = require_head_equal(
        eng, [x for _, x, _ in heads + dheads], name)
    if hybrid:
        out["softmax_equal"] = {
            "prefill": require_softmax_equal(pre_scores, f"{name} prefill"),
            "ring_decode": require_softmax_equal(dec_scores,
                                                 f"{name} ring decode")}
    del heads, dheads, pre_scores, dec_scores, state, logits
    # p50 per prefill (fresh states) and ATen ops per decode step
    pre = []
    for _ in range(RECURRENT_TIMED_PREFILLS):
        st = eng.init_decode_state(RECURRENT_LANES, RECURRENT_SLOTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = eng.prefill(prompts, st)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    with CountOps() as counter:
        eng.decode_step(logits.argmax(-1), st)
    out.update(p50_prefill_ms=statistics.median(pre),
               prefill_tokens=list(prompts.shape),
               aten_ops_per_decode_step=counter.n)
    del st, logits
    out["priced_forward"] = price_lm_forward(eng, prompts, roof, name)
    # prefill + decode against forward; state continuity
    ctoks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, LM_CHECK_TOKENS).astype(np.int32)
    v = cfg.vocab_size        # the pad ids' -1e30 would hide every gap
    out["decode_vs_forward"], out["state_continuity"] = {}, {}
    plans = (("cuda", eng),
             ("float", runtime.compile_model(cfg, params, backend="float",
                                             device=dev)),
             ("float32", runtime.compile_model(cfg.with_(dtype="float32"),
                                               params, backend="float",
                                               device=dev)))
    for plan, e in plans:
        f = e.forward(ctoks)
        if tuple(f.shape) != (*LM_CHECK_TOKENS, cfg.padded_vocab) or \
                not bool(torch.isfinite(f[..., :v]).all()):
            raise AssertionError(f"{name} {plan}: bad forward logits")
        last = f[:, -1, :v].float()
        del f
        state = e.init_decode_state(*LM_CHECK_TOKENS)
        full, state = e.prefill(ctoks[:, :-1], state)
        lanes = None
        if not hybrid:
            lanes = {"layers": tree_map(lambda t: t.clone(), state["layers"]),
                     "index": torch.full((LM_CHECK_TOKENS[0],),
                                         state["index"], dtype=torch.long,
                                         device=dev)}
        dec, _ = e.decode_step(ctoks[:, -1], state)
        dec = dec[:, :v].float()
        row = {"rel": float((dec - last).abs().max() / last.abs().max()),
               **greedy_check(dec, last)}
        if lanes is not None:
            dl, _ = e.decode_step(ctoks[:, -1], lanes)
            row["per_lane_equal"] = bool(torch.equal(dec, dl[:, :v].float()))
        out["decode_vs_forward"][plan] = row
        st = e.init_decode_state(*LM_CHECK_TOKENS)
        _, st = e.prefill(ctoks[:, :RECURRENT_SPLIT], st)
        split, st = e.prefill(ctoks[:, RECURRENT_SPLIT:-1], st)
        full, split = full[:, :v].float(), split[:, :v].float()
        out["state_continuity"][plan] = {
            "split": [RECURRENT_SPLIT, LM_CHECK_TOKENS[1] - 1 - RECURRENT_SPLIT],
            "rel": float((split - full).abs().max() / full.abs().max()),
            **greedy_check(split, full)}
        del state, st, dec, full, split, lanes, e
    del plans
    dvf, cont = out["decode_vs_forward"], out["state_continuity"]
    # (what, plan, limit, greedy tokens equal or near ties only)
    for what, got, plan, lim, exact in (
            ("prefill + decode_step against forward", dvf, "cuda",
             RECURRENT_DECODE_REL[name], False),
            ("prefill + decode_step against forward", dvf, "float32",
             LM_REF_DECODE_REL, True),
            ("a split prefill against one", cont, "cuda",
             RECURRENT_CONTINUITY_REL, False),
            ("a split prefill against one", cont, "float32",
             LM_REF_DECODE_REL, True)):
        r = got[plan]
        if r["rel"] >= lim or not r["argmax_equal" if exact else "greedy_ok"]:
            failures.append(f"{plan}: {what}: {r}, over {lim} or another "
                            "greedy token")
    if not all(r.get("per_lane_equal", True) for r in dvf.values()):
        failures.append(f"a per-lane decode step differs from the scalar "
                        f"one: {dvf}")
    # cuda against lut (recorded)
    fwd = eng.forward(ctoks)[..., :v]
    del eng
    lut = runtime.compile_model(cfg, params, backend="lut", device=dev)
    del params
    lut_logits = lut.forward(ctoks)[..., :v]
    del lut
    out["cuda_vs_lut"] = {
        "max_abs": float((fwd - lut_logits).abs().max()),
        "argmax_agree": float((fwd.argmax(-1) == lut_logits.argmax(-1))
                              .float().mean())}
    del fwd, lut_logits
    gc.collect()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    checks = _rise(checks)
    out.update(check_launches=checks, failures=failures,
               seconds=time.perf_counter() - t_phase)
    emit(out)
    if failures:
        raise AssertionError(f"{name}: " + "; ".join(failures))
    return path, checks, expected


# prefill of 15 tokens + one decode step (caches of 16 slots, so that the
# decode step's masked rows are as long as decode_train's) against
# decode_train's last logits, over the real vocabulary.  Measured on an
# H100 80GB HBM3 at 700 W (PERF.md §6): rel 0.0225 on the cuda plan at
# bf16 (the LUT bins and the bf16 residual stream over 32 random layers,
# as for the decoder-only LMs), greedy tokens equal but in one clip whose
# forward's top two were an exact tie; 1.2e-6 absolute on the float plan
# at float32, held to the reference's own 1e-3 with its greedy tokens.
WHISPER_CHECK_TOKENS = 16
WHISPER_DECODE_REL = 0.05
WHISPER_REF_DECODE_ATOL = 1e-3    # the reference's own (tests/test_models.py)
# the flash-LUT forward against the xla one (online LUT softmax over key
# tiles of 4 against the Q8.24 softmax of each row): measured 0.0273 on the
# logits, argmax agreement 0.922 (59 of 64 positions; random weights leave
# top-two margins near 0), 0.227 on the memory (recorded)
WHISPER_FLASH_ATOL = 0.1
WHISPER_FLASH_MIN_ARGMAX = 0.8
WHISPER_TIMED = 5                 # encodes and prefills per p50


def whisper_expected(cfg, prefills: int, steps: int, flash: int) -> dict:
    """Launches of the encdec path: a ``prefill`` runs the encoder (one
    softmax per query chunk of ``Q_CHUNK`` per layer, one GELU per layer)
    and the prompt through the decoder (per layer one softmax for the self
    and one for the cross attention, one GELU); a ``decode_step`` the
    decoder; a flash-LUT forward (``encode`` + ``decode_train`` under
    ``attention="flash_lut"``) one attention launch per encoder layer and
    per decoder layer (the causal self attention), one softmax per decoder
    layer (the cross attention) and one GELU per layer.  The head is a
    float product: no matmul launch."""
    chunks = -(-cfg.enc_seq // lm_layers.Q_CHUNK)
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {"lut_softmax": prefills * (ne * chunks + 2 * nd)
            + steps * 2 * nd + flash * nd,
            "lut_gelu": (prefills + flash) * (ne + nd) + steps * nd,
            "int8_matmul": 0,
            "lut_attention": flash * (ne + nd)}


def whisper_frames(cfg, seed: int, dev) -> torch.Tensor:
    """The stub frontend's frames [clips, enc_seq, d] from a numpy seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(
        WHISPER_CLIPS, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(dev)


def whisper_drain(params, frames, prompt, xc) -> dict:
    """The family's serving at module level under ``xc`` (ROADMAP C11):
    one ``prefill`` of the audio and the prompt, then greedy
    ``decode_step`` calls on every clip (``drain_batch``)."""
    return drain_batch(
        lambda st: encdec.prefill(params, frames, prompt, xc, st),
        lambda tok, st: encdec.decode_step(params, tok, xc, st),
        encdec.init_decode_state(xc, prompt.shape[0], WHISPER_MAX_LEN,
                                 device=frames.device), WHISPER_STEPS)


def whisper_decode_vs_forward(params, frames, toks, xc) -> dict:
    """prefill of all but the last token + one decode step against the
    last logits of decode_train on encode, over the real vocabulary."""
    v = xc.vocab_size
    fwd = encdec.decode_train(params, encdec.encode(params, frames, xc),
                              toks, xc)[:, -1, :v].float()
    state = encdec.init_decode_state(xc, toks.shape[0], toks.shape[1],
                                     device=frames.device)
    _, state = encdec.prefill(params, frames, toks[:, :-1], xc, state)
    dec, _ = encdec.decode_step(params, toks[:, -1], xc, state)
    dec = dec[:, :v].float()
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("non-finite decode logits")
    return {"max_abs": float((dec - fwd).abs().max()),
            "rel": float((dec - fwd).abs().max() / fwd.abs().max()),
            **greedy_check(dec, fwd)}


def phase_lm_whisper(dev) -> tuple:
    """whisper-large-v3 at full width (32 encoder and 32 decoder layers, d
    1280, 20 heads of 64, d_ff 5120, enc_seq 1500, vocab 51866, bf16;
    random weights drawn on the card by the port's ``init_params`` from
    seed 0), run as the reference runs this family (ROADMAP C11): the
    module's ``prefill`` / ``decode_step`` with float params under the
    ``cuda`` plan's ``exec_cfg`` (``runtime.get_backend("cuda")
    .configure``, what ``compile_model`` pins).  The path: 4 clips, a
    4-token prompt, 60 greedy decode steps, then one flash-LUT forward
    (``encode`` + ``decode_train``).  Then on the same weights: each
    kernel against its plain version on the model's real inputs, decode
    against forward (``cuda``; ``float`` at float32), ``flash_lut``
    against ``xla``, ``cuda`` against ``lut``, p50s, ATen ops a decode
    step, peak GB.  Returns the path's launches, the checks' launches and
    the path's expected."""
    t_phase = time.perf_counter()
    cfg = registry.get(WHISPER_NAME).config
    v = cfg.vocab_size
    cuda = runtime.get_backend("cuda")
    xc = cuda.configure(cfg)
    fc = cuda.configure(cfg, attention="flash_lut")
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "lm_whisper", "model": cfg.name, "family": cfg.family,
           "n_enc_layers": cfg.n_enc_layers, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "enc_seq": cfg.enc_seq, "vocab": v,
           "dtype": cfg.dtype, "clips": WHISPER_CLIPS,
           "prompt": WHISPER_PROMPT, "decode_steps": WHISPER_STEPS,
           "max_len": WHISPER_MAX_LEN,
           "attention_block_k": ops.fit_block(cfg.enc_seq, ops.ATTN_BLOCK_K)}
    failures = []
    with torch.inference_mode():
        params = encdec.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        out["param_count"] = sum(t.numel() for t in tree_leaves(params))
        frames = whisper_frames(cfg, 0, dev)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, v, (WHISPER_CLIPS, WHISPER_PROMPT)).astype(np.int64)).to(dev)
        # the path: the served clips, then one flash-LUT forward
        before = ops.launch_counts()
        t0 = time.perf_counter()
        served = whisper_drain(params, frames, prompt, xc)
        serve_seconds = time.perf_counter() - t0
        toks = served["tokens"]
        if tuple(toks.shape) != (WHISPER_CLIPS, WHISPER_STEPS) or \
                int(toks.max()) >= v or int(toks.min()) < 0:
            raise AssertionError(f"{tuple(toks.shape)} tokens served, or a "
                                 "pad id")
        fmem = encdec.encode(params, frames, fc)
        ftoks = torch.cat([prompt, toks[:, :WHISPER_CHECK_TOKENS
                                        - WHISPER_PROMPT].to(dev)], 1)
        flogits = encdec.decode_train(params, fmem, ftoks, fc)[..., :v]
        path = _rise(before)
        expected = whisper_expected(cfg, 1, WHISPER_STEPS, 1)
        if path != expected:
            raise AssertionError(f"the whisper path launched {path}, "
                                 f"expected {expected}")
        step_p50 = statistics.median(served["step_ms"])
        out.update(serve_seconds=serve_seconds,
                   served_prefill_ms=served["prefill_ms"],
                   p50_decode_step_ms=step_p50,
                   decode_tok_s=WHISPER_CLIPS / (step_p50 / 1e3),
                   tokens_served={str(i): len(t)
                                  for i, t in enumerate(toks.tolist())},
                   launches=path,
                   launches_per_call={
                       "prefill": whisper_expected(cfg, 1, 0, 0),
                       "decode_step": whisper_expected(cfg, 0, 1, 0),
                       "flash_forward": whisper_expected(cfg, 0, 0, 1)},
                   serve_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        served_tokens = toks
        del served

        # the checks
        checks = ops.launch_counts()
        # 1. the kernels on the model's real inputs: the first and the last
        # encoder layers' first query chunk of scores and MLP inputs, every
        # decoder layer's cross-attention rows of a decode step, the first
        # encoder layer's q, k, v under flash_lut
        n_sm = cfg.n_enc_layers * -(-cfg.enc_seq // lm_layers.Q_CHUNK)
        last = n_sm - -(-cfg.enc_seq // lm_layers.Q_CHUNK)
        with recorded(approx, "masked_softmax",
                      lambda i, a: i in (0, last)) as enc_scores, \
                recorded(approx, "gelu",
                         lambda i, a: i in (0, cfg.n_enc_layers - 1)) as gelus:
            encdec.encode(params, frames, xc)
        state = encdec.init_decode_state(xc, WHISPER_CLIPS, WHISPER_MAX_LEN,
                                         device=dev)
        logits, state = encdec.prefill(params, frames, prompt, xc, state)
        with recorded(approx, "masked_softmax",
                      lambda i, a: a[1] is None) as cross:
            encdec.decode_step(params, logits.argmax(-1), xc, state)
        with recorded(ops, "lut_attention", lambda i, a: i == 0) as qkv:
            encdec.encode(params, frames, fc)
        del state, logits
        for what, seen in (("encoder chunk", enc_scores),
                           ("decode-step cross rows", cross)):
            for i, (sc, _) in enumerate(seen):
                require_equal(f"whisper {what} {i} softmax",
                              ops.lut_softmax(sc, fixed=True),
                              ref.lut_softmax(sc, fixed=True))
        for i, (x,) in enumerate(gelus):
            require_equal(f"whisper encoder MLP {i} GELU", ops.lut_gelu(x),
                          ref.lut_gelu(x))
        q, k, hv = qkv[0][:3]
        shape = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                 q.shape[3])
        attn = {str(dt).split(".")[1]: check_attention(
            dev, None, shape, False, True,
            qkv=tuple(t.to(dt) for t in (q, k, hv)))
            for dt in (torch.bfloat16, torch.float32)}
        out["kernels_on_real_inputs"] = {
            "softmax_encoder_chunks": [list(sc.shape) for sc, _ in enc_scores],
            "softmax_cross_rows": {"layers": len(cross),
                                   "scores": list(cross[0][0].shape)},
            "gelu_encoder_mlp": [list(x.shape) for (x,) in gelus],
            "gelu_dtype": str(gelus[0][0].dtype), "equal": True,
            "attention": {k: {f: r[f] for f in ("shape_bhhlld", "block_k",
                                                "max_abs_err", "within_1e-5",
                                                "oracle_max_abs_err")}
                          for k, r in attn.items()}}
        del enc_scores, cross, gelus, qkv, q, k, hv
        # 2. decode against forward: cuda (bf16), float at float32
        ctoks = ftoks
        dvf = {"cuda": whisper_decode_vs_forward(params, frames, ctoks, xc)}
        p32 = tree_map(lambda t: t.float(), params)
        c32 = runtime.get_backend("float").configure(
            cfg.with_(dtype="float32"))
        dvf["float32"] = whisper_decode_vs_forward(p32, frames, ctoks, c32)
        del p32
        out["decode_vs_forward"] = dvf
        if dvf["float32"]["max_abs"] >= WHISPER_REF_DECODE_ATOL or \
                not dvf["float32"]["argmax_equal"]:
            failures.append(f"float32: prefill + decode_step against "
                            f"forward {dvf['float32']}")
        if dvf["cuda"]["rel"] >= WHISPER_DECODE_REL or \
                not dvf["cuda"]["greedy_ok"]:
            failures.append(f"cuda: prefill + decode_step against forward "
                            f"{dvf['cuda']}")
        # 3. flash_lut against xla: the memory and the logits
        xmem = encdec.encode(params, frames, xc)
        xlogits = encdec.decode_train(params, xmem, ftoks, xc)[..., :v]
        out["flash_vs_xla"] = {
            "memory_max_abs": float((fmem.float() - xmem.float()).abs().max()),
            "logits_max_abs": float((flogits.float() - xlogits.float())
                                    .abs().max()),
            "argmax_agree": float((flogits.argmax(-1) == xlogits.argmax(-1))
                                  .float().mean())}
        if not bool(torch.isfinite(flogits).all()) or \
                out["flash_vs_xla"]["logits_max_abs"] > WHISPER_FLASH_ATOL or \
                out["flash_vs_xla"]["argmax_agree"] < WHISPER_FLASH_MIN_ARGMAX:
            failures.append(f"flash_lut against xla {out['flash_vs_xla']}")
        del fmem, flogits
        # 4. cuda against the plain lut plan on the card (recorded)
        lc = runtime.get_backend("lut").configure(cfg)
        llogits = encdec.decode_train(params, encdec.encode(params, frames,
                                                            lc), ftoks, lc)[..., :v]
        lut_served = whisper_drain(params, frames, prompt, lc)["tokens"]
        out["cuda_vs_lut"] = {
            "max_abs": float((xlogits.float() - llogits.float()).abs().max()),
            "argmax_agree": float((xlogits.argmax(-1) == llogits.argmax(-1))
                                  .float().mean()),
            "greedy_tokens_equal": int((lut_served == served_tokens).sum()),
            "greedy_tokens": served_tokens.numel(),
            "greedy_equal_prefix": [int((a != b).nonzero()[0])
                                    if bool((a != b).any()) else len(a)
                                    for a, b in zip(served_tokens,
                                                    lut_served)]}
        del xmem, xlogits, llogits
        # 5. p50 of encode and prefill, ATen ops a decode step
        enc_ms, pre_ms = [], []
        for _ in range(WHISPER_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encdec.encode(params, frames, xc)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
            st = encdec.init_decode_state(xc, WHISPER_CLIPS, WHISPER_MAX_LEN,
                                          device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, st = encdec.prefill(params, frames, prompt, xc, st)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        with CountOps() as counter:
            encdec.decode_step(params, logits.argmax(-1), xc, st)
        del st, logits, params, frames
    gc.collect()
    out.update(p50_encode_ms=statistics.median(enc_ms),
               p50_prefill_ms=statistics.median(pre_ms),
               aten_ops_per_decode_step=counter.n,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    checks = _rise(checks)
    out.update(check_launches=checks, failures=failures,
               seconds=time.perf_counter() - t_phase)
    emit(out)
    if failures:
        raise AssertionError(f"{cfg.name}: " + "; ".join(failures))
    return path, checks, expected


# ---------------------------------------------------------------------------
# nemotron-4-340b at full width (lm_nemotron)
# ---------------------------------------------------------------------------

# Every width published (d_model 18432, 96 heads and 8 KV heads at
# head_dim 192, d_ff 73728, vocab 256000, bf16, squared ReLU, LayerNorm);
# the depth cut from 96 layers to NEMOTRON_LAYERS: a layer is 6.91 GB in
# bf16 and 13.82 GB as the integer plans' float32 block view, and one
# card holds the packed tree and one plan of 2 layers (PERF.md §4).
NEMOTRON_NAME = "nemotron-4-340b"
NEMOTRON_LAYERS = 2
# prefill of 63 tokens + one decode step against forward on the cuda plan,
# as LM_DECODE_REL's check: measured on the card 0.101 (0.071 after 1023
# tokens), greedy tokens equal, and 0.0034 on the same plan at float32
# activations: the bf16 residual stream, 18432 wide, makes the rest (a
# bf16 step of 2^-9 turns eq-9 codes of the head's input).  So the bf16
# plan is held to NEMOTRON_DECODE_REL, about twice the measured gap, and
# the float32-activation plan to LM_DECODE_REL, each with its argmax.
NEMOTRON_DECODE_REL = 0.2


def phase_lm_nemotron(dev) -> tuple:
    """nemotron-4-340b at full width, depth cut to NEMOTRON_LAYERS; random
    weights drawn on the card from the seed and quantised once (the bf16
    source dropped), every plan compiled from the packed tree, one alive
    at a time: the ``cuda`` + ``flash_lut`` forward of LM_FLASH_TOKENS
    (8 key tiles a row, the wide attention kernel at head_dim 192, the
    K = 18432 head) against the ``cuda`` + ``xla`` forward and, recorded,
    the ``lut`` + ``flash_lut`` one (the kernel's plain version on the
    card); on the ``xla`` plan a prefill of S - 1 tokens and one decode
    step against the forward's last logits (per-lane == scalar index) at
    S = 64 (NEMOTRON_DECODE_REL, and LM_DECODE_REL at float32
    activations) and S = 1024 (recorded), 8
    requests on 4 slots served through ``cell.scheduler.LMScheduler`` (the
    LUT softmax kernel on 96 heads' masked rows), p50 per forward and per
    decode step, ATen ops a decode step, the peak GB.  Returns the path's
    launches (the flash forward and the served run), the other checks'
    launches and the path's expected."""
    t_phase = time.perf_counter()
    published = registry.get(NEMOTRON_NAME).config
    cfg = published.with_(n_layers=NEMOTRON_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = ops.launch_counts()
    t0 = time.perf_counter()
    params = lm_model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    qtree = runtime.QuantRecipe.from_config(cfg).quantize(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "lm_nemotron", "model": cfg.name,
           "n_layers": cfg.n_layers, "n_layers_published": published.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "activation": cfg.activation, "norm": cfg.norm,
           "packed_gb": quant.tree_quantized_bytes(qtree)[0] / 1e9,
           "init_quantize_seconds": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    failures = []
    rng = np.random.default_rng(7)
    ftoks = rng.integers(0, cfg.vocab_size, LM_FLASH_TOKENS).astype(np.int32)
    want_shape = (*LM_FLASH_TOKENS, cfg.padded_vocab)

    # the path: the flash_lut forward of the cuda plan
    flash = runtime.compile_model(cfg, qtree, backend="cuda",
                                  attention="flash_lut", device=dev)
    out["describe"] = flash.describe()
    before = ops.launch_counts()
    with launch_log(True):
        f_logits = flash.forward(ftoks)
    torch.cuda.synchronize()
    path = _rise(before)
    expected = lm_expected(cfg, 1, "flash_lut")
    if path != expected:
        failures.append(f"flash_lut forward launched {path}, expected "
                        f"{expected}")
    if tuple(f_logits.shape) != want_shape or \
            not bool(torch.isfinite(f_logits).all()):
        failures.append(f"flash_lut logits {tuple(f_logits.shape)}, or "
                        "not finite")
    out["p50_forward_ms"] = p50_forward_ms(flash, ftoks)
    del flash
    gc.collect()
    torch.cuda.empty_cache()

    # the xla plan: its forward, decode against it, the served requests
    eng = runtime.compile_model(cfg, qtree, backend="cuda", device=dev)
    x_logits = eng.forward(ftoks)
    agree = float((f_logits.argmax(-1) == x_logits.argmax(-1)).float().mean())
    out["flash_vs_xla"] = {"tokens": list(LM_FLASH_TOKENS),
                           "max_abs": float((f_logits - x_logits).abs().max()),
                           "argmax_agree": agree}
    if agree < LM_FLASH_MIN_ARGMAX or \
            out["flash_vs_xla"]["max_abs"] > LM_FLASH_ATOL:
        failures.append(f"flash_lut forward against xla: "
                        f"{out['flash_vs_xla']}")
    # prefill + one decode step against the forward's last logits: at
    # LM_CHECK_TOKENS under NEMOTRON_DECODE_REL and, at float32
    # activations, LM_DECODE_REL; at LM_FLASH_TOKENS (a prefill of two
    # query chunks) recorded; greedy tokens and per-lane steps held
    ctoks = rng.integers(0, cfg.vocab_size,
                         LM_CHECK_TOKENS).astype(np.int32)
    dvf = out["decode_vs_forward"] = {}
    f32 = dataclasses.replace(eng, exec_cfg=eng.exec_cfg.with_(
        dtype="float32"))
    for tag, e, toks, logits in (
            (str(LM_CHECK_TOKENS[1] - 1), eng, ctoks, None),
            (str(LM_FLASH_TOKENS[1] - 1), eng, ftoks, x_logits),
            # the same plan at float32 activations: what the bf16
            # residual stream adds (recorded)
            (f"{LM_CHECK_TOKENS[1] - 1} float32", f32, ctoks, None)):
        if logits is None:
            logits = e.forward(toks)
        state = e.init_decode_state(*toks.shape)
        _, state = e.prefill(toks[:, :-1], state)
        lanes = {"layers": {k: v.clone()
                            for k, v in state["layers"].items()},
                 "index": torch.full((toks.shape[0],), state["index"],
                                     dtype=torch.long, device=dev)}
        dec, _ = e.decode_step(toks[:, -1], state)
        dec_lanes, _ = e.decode_step(toks[:, -1], lanes)
        last = logits[:, -1].float()
        dvf[tag] = {
            "rel": float((dec.float() - last).abs().max()
                         / last.abs().max()),
            "argmax_equal": bool(torch.equal(dec.argmax(-1),
                                             last.argmax(-1))),
            "per_lane_equal": bool(torch.equal(dec, dec_lanes))}
        del state, lanes, dec, dec_lanes, last, logits
    del f32, e                 # each holds the plan
    short = str(LM_CHECK_TOKENS[1] - 1)
    if dvf[short]["rel"] >= NEMOTRON_DECODE_REL or \
            dvf[short + " float32"]["rel"] >= LM_DECODE_REL or not all(
                v["argmax_equal"] and v["per_lane_equal"]
                for v in dvf.values()):
        failures.append(f"prefill + decode_step against forward: {dvf}, "
                        f"over {NEMOTRON_DECODE_REL} (bf16) or "
                        f"{LM_DECODE_REL} (float32 activations) after "
                        f"{short} tokens, another greedy token or a "
                        "per-lane step apart from the scalar one")
    requests = lm_serve.make_requests(cfg, 8, 256, 0)
    reg = telemetry.Registry()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with cellmod.ServeCell(eng, slots=LM_SLOTS, registry=reg) as cell:
        sched = cell.lm_scheduler(max_len=256)
        for r in requests:
            sched.submit(r["id"], r["prompt"], r["gen"])
        served = sched.run()
    torch.cuda.synchronize()
    del cell, sched            # each holds the plan
    out["serve_seconds"] = time.perf_counter() - t0
    served_rose = _rise(before)
    steps_run = reg.histogram("cell_decode_latency_ms").summary()["n"]
    prefills = reg.histogram("cell_prefill_latency_ms").summary()["n"]
    served_expected = lm_expected(cfg, steps_run + prefills)
    if served_rose != served_expected:
        failures.append(f"the served run launched {served_rose}, expected "
                        f"{served_expected} ({steps_run} decode steps, "
                        f"{prefills} prefills)")
    for r in requests:
        got = served.get(r["id"], [])
        if len(got) != r["gen"] or not all(0 <= t < cfg.vocab_size
                                           for t in got):
            failures.append(f"request {r['id']}: {len(got)} tokens of "
                            f"{r['gen']}, or a pad id")
    out.update(decode_steps=steps_run, prefills=prefills,
               tokens_served=sum(len(v) for v in served.values()),
               tokens_budgeted=sum(r["gen"] for r in requests))
    ptoks = rng.integers(0, cfg.vocab_size, (LM_SLOTS, 63)).astype(np.int32)
    timed, cur, st = time_lm_calls(eng, ptoks)
    with CountOps() as counter:
        eng.decode_step(cur, st)
    del st, eng
    out.update(timed, prefill_tokens=list(ptoks.shape),
               aten_ops_per_decode_step=counter.n)
    gc.collect()
    torch.cuda.empty_cache()

    # the lut plan's flash_lut forward: the kernel's plain version on the
    # card in the kernel's place, the same integer pipeline besides
    lut = runtime.compile_model(cfg, qtree, backend="lut",
                                attention="flash_lut", device=dev)
    l_logits = lut.forward(ftoks)
    del lut
    out["cuda_vs_lut_flash"] = {
        "max_abs": float((f_logits - l_logits).abs().max()),
        "argmax_agree": float((f_logits.argmax(-1) == l_logits.argmax(-1))
                              .float().mean())}
    if not bool(torch.isfinite(l_logits).all()):
        failures.append("lut + flash_lut logits not finite")
    del f_logits, x_logits, l_logits, qtree
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    path = {k: path[k] + served_rose[k] for k in path}
    expected = {k: expected[k] + served_expected[k] for k in expected}
    checks = {k: v - path[k] for k, v in _rise(start).items()}
    out.update(launches=path, launches_expected=expected,
               check_launches=checks, failures=failures,
               seconds=time.perf_counter() - t_phase)
    emit(out)
    if failures:
        raise AssertionError(f"{cfg.name}: " + "; ".join(failures))
    return path, checks, expected


# ---------------------------------------------------------------------------
# phase 19: LM training (train_lm)
# ---------------------------------------------------------------------------

TRAIN_LM_ARGS = ["--arch", LM_NAME, "--steps", "8", "--global-batch", "8",
                 "--seq-len", "256", "--seed", "0"]
TRAIN_LM_QAT_STEPS = 3
# the central difference: one batch, a seeded direction d that scales each
# leaf's normal draws by the leaf's RMS, L(p + eps d) - L(p - eps d) over
# 2 eps against <g, d>.  Held at FD_EPS; the others are recorded (at
# 1e-2 the curvature shows, at 1e-3 the float32 loss's rounding: on a
# two-layer d 512 cut of the config on the CPU, relative 1.5e-3, 2.1e-4 and
# 2.4e-3 at 1e-2, 3e-3 and 1e-3)
FD_BATCH = (4, 256)
FD_EPS = 3e-3
FD_EPS_RECORDED = (1e-2, 3e-3, 1e-3)
FD_REL = 1e-2
# remat on against off at float32: the forward is the same ops on the same
# inputs (losses torch.equal); each gradient leaf within this share of its
# largest |g| (the embedding's backward accumulates its rows by atomics on
# the card; the count of leaves that come out torch.equal is recorded)
REMAT_GRAD_RTOL = 1e-4
# the smoke configs' steps, card against CPU (the CPU on the kernels' plain
# versions): float32 on both.  float: loss and gradients within 1e-4 (the
# LM smoke plans' float tolerance, LM_SMOKE_FLOAT_ATOL); cuda QAT: a
# float rounding upstream of a LUT index may move one entry a LUT bin
# (1/32 of exp's unit in Q8.24), so the loss within 1e-3 and the gradients
# within 1e-2.  New params after one AdamW step from zero moments: each
# update is about lr * sign(g), and a gradient that is rounding noise on
# both devices can take either sign, so within 2.2 lr (the KWT steps'
# bound, tests/test_torch_train.py).
SMOKE_TRAIN = ("internlm2-1.8b", MOE_NAME, RWKV_NAME, HYMBA_NAME, WHISPER_NAME,
               "qwen2.5-14b")
SMOKE_TRAIN_ATOL = {"float": (1e-4, 1e-4), "cuda": (1e-3, 1e-2)}
SMOKE_TRAIN_BATCH = (2, 16)
SMOKE_NEW_PARAM_LRS = 2.2
TRAIN_LM_RESUME_ARGS = ["--arch", LM_NAME, "--smoke", "--qat", "--qat-backend",
                        "cuda", "--steps", "8", "--global-batch", "4",
                        "--seq-len", "32", "--seed", "5"]
TRAIN_LM_CKPT_EVERY, TRAIN_LM_FAIL_AT = 2, 5


def lm_train_launches(cfg, steps_run: int) -> dict:
    """A dense LM's QAT step under the cuda backend launches the softmax
    once per layer in its forward and, when the config sets ``remat``,
    once more per layer in its backward: the checkpointed layer's forward
    reruns there, its STE included, and the STE's forward is the kernel.
    The STE's backward is the exact op's gradient in plain PyTorch, the
    SiLU has no kernel (its cuda mode is the LUT), the linears are float
    products of fake-quant weights and the attention is the einsum one:
    no GELU, matmul or attention launch."""
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    return {"lut_softmax": per_step * steps_run, "lut_gelu": 0,
            "int8_matmul": 0, "lut_attention": 0}


def lm_batch_for(cfg, seed: int, step: int, b: int, s: int) -> dict:
    """The launcher's batch for ``step`` (``pipeline.lm_batch``, or the
    encoder-decoder's ``_whisper_batch``), on the host."""
    if cfg.family == "encdec":
        return train._whisper_batch(argparse.Namespace(
            seed=seed, global_batch=b, seq_len=s), cfg, step)
    return pipeline.lm_batch(seed, step, global_batch=b, seq_len=s,
                             vocab_size=cfg.vocab_size)


def lm_step_of(result, qat_spec=None):
    """A train step of the run's own config and hyper-parameters."""
    cfg = result.cfg
    hp = dataclasses.replace(steps.hparams_for(cfg), lr=1e-3, warmup_steps=2,
                             total_steps=10)
    shape = ShapeSpec("custom", 256, 8, "train")
    return steps.make_train_step(cfg, shape, hp, n_micro=1, qat=qat_spec)


def count_step_ops(step, state: tuple, batch, names=None) -> int:
    """The ATen ops one more step of ``state`` dispatches (forward,
    backward and AdamW; its output is dropped); ``names``, a dict, takes
    their counts by op name."""
    with CountOps() as counter:
        step(*state, batch)
        torch.cuda.synchronize()
    if names is not None:
        names.update(counter.names)
    return counter.n


# the float run's step as the card ran it, for the dry run's calibration
TRAIN_LM_MEASURED: dict = {}


def full_width_float(dev) -> dict:
    """internlm2-1.8b at full width (bf16 params, remat on) trained by the
    launcher: every loss finite, p50 ms per step, tokens/s, peak memory,
    ATen ops per step."""
    torch.cuda.reset_peak_memory_stats()
    result, _ = run_main(TRAIN_LM_ARGS)
    peak = torch.cuda.max_memory_allocated()
    cfg = result.cfg
    b = int(TRAIN_LM_ARGS[TRAIN_LM_ARGS.index("--global-batch") + 1])
    s = int(TRAIN_LM_ARGS[TRAIN_LM_ARGS.index("--seq-len") + 1])
    if not all(np.isfinite(result.losses)) or len(result.losses) != 8:
        raise AssertionError(f"{cfg.name} float losses {result.losses}")
    p50 = statistics.median(result.step_ms)
    names = {}
    n_ops = count_step_ops(
        lm_step_of(result), (result.params, result.opt_state),
        steps.to_device(lm_batch_for(cfg, 0, 8, b, s), dev), names)
    TRAIN_LM_MEASURED.update(p50_ms=p50, peak_bytes=peak, aten_ops=n_ops,
                             aten_ops_by_name=names)
    n_params = sum(t.numel() for t in tree_leaves(result.params))
    out = {"argv": TRAIN_LM_ARGS, "dtype": cfg.dtype, "remat": cfg.remat,
           "n_params": n_params, "tokens_per_step": b * s,
           "losses": result.losses, "step_ms": result.step_ms,
           "p50_ms_per_step": p50, "tokens_per_s": b * s / p50 * 1e3,
           "peak_gb": peak / 1e9, "aten_ops_per_step": n_ops}
    del result
    return out


def full_width_float32_checks(dev) -> dict:
    """On the config at float32 (random weights drawn on the card from seed
    1): one backward's gradient against a central difference along a seeded
    direction, and the loss and gradients with remat on against off."""
    cfg = registry.get(LM_NAME).config.with_(dtype="float32")
    params = lm_model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev)
    b, s = FD_BATCH
    batch = steps.to_device(lm_batch_for(cfg, 1, 0, b, s), dev)
    out = {"batch": [b, s]}
    got = {}
    for remat in (True, False):
        c = cfg.with_(remat=remat)
        torch.cuda.reset_peak_memory_stats()
        got[remat] = steps.value_and_grad(
            lambda p, bb, c=c: lm_model.loss_fn(p, bb, c), params, batch)
        torch.cuda.synchronize()
        out[f"peak_gb_remat_{'on' if remat else 'off'}"] = \
            torch.cuda.max_memory_allocated() / 1e9
    (loss, grads), (loss_off, grads_off) = got[True], got[False]
    require_equal("loss remat on vs off", loss, loss_off)
    worst, n_equal, names = 0.0, 0, []
    for (path, g), g_off in zip(_named_leaves(grads), tree_leaves(grads_off)):
        scale = float(g_off.abs().max())
        err = float((g - g_off).abs().max()) / max(scale, 1e-30)
        n_equal += bool(torch.equal(g, g_off))
        if not torch.equal(g, g_off):
            names.append(path)
        worst = max(worst, err)
    del got, grads_off
    if worst > REMAT_GRAD_RTOL:
        raise AssertionError(f"remat on vs off: gradients {worst} of their "
                             f"largest |g| apart (bound {REMAT_GRAD_RTOL})")
    out["remat"] = {"loss": float(loss), "loss_equal": True,
                    "grad_worst_rel": worst, "grad_rtol": REMAT_GRAD_RTOL,
                    "leaves": len(tree_leaves(grads)),
                    "leaves_equal": n_equal, "leaves_not_equal": names}
    gen = torch.Generator(device=dev).manual_seed(2)
    d = tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev)
                 * t.square().mean().sqrt(), params)
    gd = sum(float((g.double() * dd.double()).sum())
             for g, dd in zip(tree_leaves(grads), tree_leaves(d)))
    del grads
    rows = {}
    with torch.no_grad():
        for eps in FD_EPS_RECORDED:
            lp = float(lm_model.loss_fn(
                tree_map(lambda p, dd: p + eps * dd, params, d), batch, cfg))
            lm = float(lm_model.loss_fn(
                tree_map(lambda p, dd: p - eps * dd, params, d), batch, cfg))
            fd = (lp - lm) / (2 * eps)
            rows[str(eps)] = {"fd": fd, "rel": abs(fd - gd) / abs(gd)}
    out["central_difference"] = {"g_dot_d": gd, "eps": rows,
                                 "held_eps": FD_EPS, "rel_bound": FD_REL}
    if not rows[str(FD_EPS)]["rel"] <= FD_REL:
        raise AssertionError(f"central difference at eps {FD_EPS}: "
                             f"{rows[str(FD_EPS)]} (bound {FD_REL})")
    return out


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@contextlib.contextmanager
def recorded_softmax():
    """While open, every ``ops.lut_softmax`` call records its input and
    output (cloned)."""
    seen, fn = [], ops.lut_softmax

    def recording(x, **kw):
        y = fn(x, **kw)
        seen.append((x.detach().clone(), y.detach().clone()))
        return y

    ops.lut_softmax = recording
    try:
        yield seen
    finally:
        ops.lut_softmax = fn


def full_width_qat(dev) -> tuple:
    """The same command under ``--qat --qat-backend cuda`` for a few steps,
    ending in ``qat.export``; the launches of its steps exactly
    ``lm_train_launches``.  Then one more step with every softmax call
    recorded: each kernel output ``torch.equal`` to the plain version on
    its input, and the backward's reruns fed the forward's inputs.  Returns
    the line, the launcher's launches and the expected count."""
    argv = TRAIN_LM_ARGS[:]
    argv[argv.index("--steps") + 1] = str(TRAIN_LM_QAT_STEPS)
    argv += ["--qat", "--qat-backend", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    result, log = run_main(argv)
    path = _rise(before)
    peak = torch.cuda.max_memory_allocated()
    cfg = result.cfg
    expected = lm_train_launches(cfg, TRAIN_LM_QAT_STEPS)
    if path != expected:
        raise AssertionError(f"{cfg.name} QAT run launched {path}, expected "
                             f"{expected}")
    if not all(np.isfinite(result.losses)):
        raise AssertionError(f"{cfg.name} QAT losses {result.losses}")
    b = int(argv[argv.index("--global-batch") + 1])
    s = int(argv[argv.index("--seq-len") + 1])
    step = lm_step_of(result, result.qat_spec)
    batch = steps.to_device(lm_batch_for(cfg, 0, TRAIN_LM_QAT_STEPS, b, s),
                            dev)
    state = (result.params, result.opt_state, result.qstate)
    before = ops.launch_counts()
    with recorded_softmax() as seen:
        out_state = step(*state, batch)
        torch.cuda.synchronize()
    rec_launches = _rise(before)
    per_step = lm_train_launches(cfg, 1)
    if rec_launches != per_step or len(seen) != per_step["lut_softmax"]:
        raise AssertionError(f"one QAT step launched {rec_launches} over "
                             f"{len(seen)} softmax calls, expected {per_step}")
    for i, (x, y) in enumerate(seen):
        require_equal(f"{cfg.name} QAT step softmax call {i}", y,
                      ref.lut_softmax(x, fixed=True))
    n = cfg.n_layers
    # the backward reruns layer n-1 first: call n + j reruns layer n-1-j
    for j in range(n if cfg.remat else 0):
        require_equal(f"{cfg.name} rerun of layer {n - 1 - j}'s softmax "
                      "input", seen[n + j][0], seen[n - 1 - j][0])
    rows = list(seen[0][0].shape)
    del seen, out_state
    n_ops = count_step_ops(step, state, batch)
    ex = result.export
    out = {"argv": argv, "losses": result.losses, "step_ms": result.step_ms,
           "p50_ms_per_step": statistics.median(result.step_ms),
           "tokens_per_s": b * s / statistics.median(result.step_ms) * 1e3,
           "peak_gb": peak / 1e9, "aten_ops_per_step": n_ops,
           "launches": path, "launches_per_step": per_step,
           "softmax_calls_checked": per_step["lut_softmax"],
           "softmax_rows": rows, "softmax_equal": True,
           "rerun_inputs_equal": bool(cfg.remat),
           "export": {"recipe": ex.recipe.to_dict(),
                      "packed_int_bytes": int(ex.quantized_bytes[0]),
                      "float_bytes": int(ex.quantized_bytes[1])},
           "exported": "[qat] exported recipe" in log}
    return out, path, expected


def smoke_train_step(cfg, np_tree, dev, backend: str) -> dict:
    """One train step of a smoke config on ``dev`` from numpy weights
    (float, or QAT on ``cuda``; on the CPU through the kernels' plain
    versions): the loss, the gradients, the new params and the calls of
    the two kernel wrappers."""
    params = convert.from_numpy_tree(np_tree, dev)
    hp = dataclasses.replace(steps.hparams_for(cfg), lr=1e-3, warmup_steps=2,
                             total_steps=10)
    b, s = SMOKE_TRAIN_BATCH
    batch = steps.to_device(lm_batch_for(cfg, 3, 0, b, s), dev)
    spec = None if backend == "float" else qat.QATSpec(
        runtime.QuantRecipe.from_config(cfg), qat.QATConfig(backend=backend),
        plain_kernels=dev.type == "cpu")
    calls = {"lut_softmax": 0, "lut_gelu": 0}
    wrapped = {name: getattr(ops, name) for name in calls}

    def counting(name):
        def fn(*a, **kw):
            calls[name] += 1
            return wrapped[name](*a, **kw)
        return fn

    for name in calls:
        setattr(ops, name, counting(name))
    try:
        if spec is None:
            loss, grads = steps.value_and_grad(
                lambda p, bb: steps._loss(cfg)(p, bb, cfg), params, batch)
            new_p, new_opt, m = steps.make_train_step(
                cfg, ShapeSpec("custom", s, b, "train"), hp)(
                params, adamw.init(params, hp), batch)
        else:
            qs = qat.init_qat_state(spec, dev)
            loss, grads = steps.value_and_grad(
                qat_train.make_qat_loss(cfg, spec), params, batch,
                qs["weight_exponent"], qs["step"] >= 0)
            new_p, new_opt, _, m = steps.make_train_step(
                cfg, ShapeSpec("custom", s, b, "train"), hp, qat=spec)(
                params, adamw.init(params, hp), qs, batch)
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
    return {"loss": loss, "grads": grads, "new_params": new_p, "lr": m["lr"],
            "calls": dict(calls), "int8_moments": hp.int8_moments}


def _tree_max_abs(a, b) -> float:
    return max(float((x.detach().cpu().to(torch.float64)
                      - y.detach().cpu().to(torch.float64)).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def smoke_qat_calls(cfg) -> dict:
    """The softmax and GELU launches of ``smoke_train_step``'s two QAT
    forwards (the loss's and the step's; a smoke config sets no remat):
    per forward one attention softmax a layer, a moe layer's router rows
    one more, rwkv none; the encoder-decoder one per encoder layer and two
    per decoder layer (self and cross), and a GELU per layer of both."""
    n = cfg.n_layers
    per = {"dense": (n, 0), "moe": (2 * n, 0), "rwkv": (0, 0),
           "hybrid": (n, 0),
           "encdec": (cfg.n_enc_layers + 2 * n, cfg.n_enc_layers + n)}
    sm, ge = per[cfg.family]
    return {"lut_softmax": 2 * sm, "lut_gelu": 2 * ge}


def smoke_train_card_vs_cpu(dev, failures: list) -> list:
    """The six smoke configs (a dense, the moe, the two recurrent, the
    encoder-decoder and a dense one with int8 moments), one float step and
    one cuda QAT step each on the card and on the CPU, from the same numpy
    weights and batch: loss, gradients and new params within
    ``SMOKE_TRAIN_ATOL`` / ``SMOKE_NEW_PARAM_LRS``; the card's launches
    equal the CPU's calls of the two wrappers and ``smoke_qat_calls`` (the
    GELU on whisper's, the router's softmax on granite-moe's)."""
    rows = []
    for name in SMOKE_TRAIN:
        cfg = registry.get(name).smoke
        np_tree = seeded_lm_params(cfg, 0)
        row = {"model": name, "family": cfg.family}
        for backend in ("float", "cuda"):
            before = ops.launch_counts()
            card = smoke_train_step(cfg, np_tree, dev, backend)
            rose = _rise(before)
            cpu = smoke_train_step(cfg, np_tree, torch.device("cpu"), backend)
            loss_atol, grad_atol = SMOKE_TRAIN_ATOL[backend]
            lr = float(card["lr"])
            r = {"loss_card": float(card["loss"]), "loss_cpu": float(cpu["loss"]),
                 "loss_abs": abs(float(card["loss"]) - float(cpu["loss"])),
                 "grad_max_abs": _tree_max_abs(card["grads"], cpu["grads"]),
                 "new_param_max_abs": _tree_max_abs(card["new_params"],
                                                    cpu["new_params"]),
                 "new_param_atol": SMOKE_NEW_PARAM_LRS * lr,
                 "loss_atol": loss_atol, "grad_atol": grad_atol,
                 "launches": {k: rose[k] for k in ("lut_softmax", "lut_gelu")},
                 "cpu_calls": cpu["calls"],
                 "int8_moments": card["int8_moments"]}
            want = {k: rose[k] for k in ("int8_matmul", "lut_attention")}
            if any(want.values()) or r["launches"] != cpu["calls"] or \
                    (backend == "float" and any(cpu["calls"].values())):
                failures.append(f"{name} {backend}: launched {rose}, the "
                                f"CPU called {cpu['calls']}")
            if not (np.isfinite(r["loss_card"]) and r["loss_abs"] <= loss_atol
                    and r["grad_max_abs"] <= grad_atol
                    and r["new_param_max_abs"] <= r["new_param_atol"]):
                failures.append(f"{name} {backend}: {r}")
            row[backend] = r
        want = smoke_qat_calls(cfg)
        if row["cuda"]["launches"] != want:
            failures.append(f"{name}: the QAT loss and step launched "
                            f"{row['cuda']['launches']}, expected {want}")
        rows.append(row)
    return rows


def smoke_crash_resume(tmp: str) -> tuple:
    """A smoke LM trained by the launcher under ``--qat-backend cuda``:
    a run that fails at step 5 with checkpoints every 2 steps, its rerun
    (which must resume from step 4) and an uninterrupted run, whose params
    and optimizer state must be ``torch.equal``.  Returns the line, the
    three runs' launches and their expected count."""
    ckpt = os.path.join(tmp, "lm_ckpt")
    ck = ["--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN_LM_CKPT_EVERY)]
    before = ops.launch_counts()
    try:
        run_main(TRAIN_LM_RESUME_ARGS + ck + ["--fail-at-step",
                                              str(TRAIN_LM_FAIL_AT)])
    except RuntimeError as err:
        if "injected failure" not in str(err):
            raise
    else:
        raise AssertionError("the LM run with --fail-at-step did not fail")
    resumed, log = run_main(TRAIN_LM_RESUME_ARGS + ck)
    full, _ = run_main(TRAIN_LM_RESUME_ARGS)
    path = _rise(before)
    want = TRAIN_LM_FAIL_AT // TRAIN_LM_CKPT_EVERY * TRAIN_LM_CKPT_EVERY
    if resumed.resumed_from != want or \
            f"[restore] resuming from step {want}" not in log:
        raise AssertionError(f"resumed from {resumed.resumed_from}, expected "
                             f"{want}")
    for what, a, b in (("param", resumed.params, full.params),
                       ("optimizer leaf", resumed.opt_state, full.opt_state)):
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            require_equal(f"LM resumed vs uninterrupted {what} {i}", x, y)
    n = int(TRAIN_LM_RESUME_ARGS[TRAIN_LM_RESUME_ARGS.index("--steps") + 1])
    steps_run = TRAIN_LM_FAIL_AT + (n - want) + n
    expected = lm_train_launches(full.cfg, steps_run)
    if path != expected:
        raise AssertionError(f"the LM resume runs launched {path}, expected "
                             f"{expected}")
    if resumed.losses != full.losses[want:]:
        raise AssertionError(f"resumed losses {resumed.losses} vs "
                             f"{full.losses[want:]}")
    return ({"argv": TRAIN_LM_RESUME_ARGS, "resumed_from": want,
             "params_and_moments_equal": True, "steps_run": steps_run,
             "losses": full.losses}, path, expected)


def phase_train_lm(dev, tmp: str) -> tuple:
    """LM training (ROADMAP A3.4): internlm2-1.8b at full width through
    ``launch.train.main``, float and ``--qat --qat-backend cuda``; the
    float32 gradient checks; the smoke configs card against CPU; crash and
    resume of a smoke LM.  Returns the line, the launches of the launcher
    runs (the path's), those of the checks and the expected count."""
    out = {"phase": "train_lm", "model": LM_NAME}
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out["float"] = full_width_float(dev)
    float_path = _rise(before)
    if any(float_path.values()):
        raise AssertionError(f"the float run launched {float_path}")
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds_float"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = ops.launch_counts()
    out["float32_checks"] = full_width_float32_checks(dev)
    checks = _rise(before)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds_float32_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = ops.launch_counts()
    out["qat"], qat_path, qat_exp = full_width_qat(dev)
    qat_checks = {k: v - qat_path[k] for k, v in _rise(before).items()}
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds_qat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = ops.launch_counts()
    failures = []
    out["smoke"] = smoke_train_card_vs_cpu(dev, failures)
    smoke_checks = _rise(before)
    out["seconds_smoke"] = time.perf_counter() - t0
    if failures:
        out["failures"] = failures
        emit(out)
        raise AssertionError("; ".join(failures))
    t0 = time.perf_counter()
    out["resume"], resume_path, resume_exp = smoke_crash_resume(tmp)
    out["seconds_resume"] = time.perf_counter() - t0
    path = {k: float_path[k] + qat_path[k] + resume_path[k] for k in qat_path}
    expected = {k: qat_exp[k] + resume_exp[k] for k in qat_exp}
    checks = {k: checks[k] + qat_checks[k] + smoke_checks[k] for k in checks}
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


# ---------------------------------------------------------------------------
# the bf16 score path (ROADMAP A3.5)
# ---------------------------------------------------------------------------

SCORES_BF16_PROMPTS = (4, 63)
SCORES_BF16_TIMED = 5


def p50_forward_ms(eng, toks) -> float:
    """p50 ms of ``eng.forward(toks)`` over SCORES_BF16_TIMED calls after
    one warm-up."""
    eng.forward(toks)
    times = []
    for _ in range(SCORES_BF16_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.forward(toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_lm_scores_bf16(dev, params) -> dict:
    """internlm2-1.8b at full width on ``lm_internlm2``'s weights: a
    forward of 4 x 63 tokens on ``float`` with ``scores_dtype`` bf16 and
    float32 (max-abs gap, argmax agreement, p50 of each); on ``cuda`` with
    bf16 scores, the softmax kernel on every layer's bf16-rounded rows
    ``torch.equal`` to its plain version.  Its launches belong to no
    path."""
    cfg = registry.get(LM_NAME).config
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, SCORES_BF16_PROMPTS)
                            .astype(np.int64)).to(dev)
    f32 = runtime.compile_model(cfg, params, backend="float", device=dev)
    bf16 = dataclasses.replace(
        f32, exec_cfg=f32.exec_cfg.with_(scores_dtype="bfloat16"))
    want = f32.forward(toks).float()
    got = bf16.forward(toks).float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("bf16 scores: non-finite logits")
    out = {"phase": "lm_scores_bf16", "model": cfg.name,
           "tokens": list(SCORES_BF16_PROMPTS),
           "logits_max_abs_gap": max_abs_err(got, want),
           "logits_max_abs": float(want.abs().max()),
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                 .float().mean()),
           "p50_forward_ms_bf16": p50_forward_ms(bf16, toks),
           "p50_forward_ms_float32": p50_forward_ms(f32, toks)}
    del f32, bf16, got, want
    eng = runtime.compile_model(cfg, params, backend="cuda", device=dev)
    eng = dataclasses.replace(
        eng, exec_cfg=eng.exec_cfg.with_(scores_dtype="bfloat16"))
    with recorded(approx, "masked_softmax") as seen:
        logits = eng.forward(toks)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bf16 scores on cuda: non-finite logits")
    if len(seen) != cfg.n_layers or seen[0][0].dtype != torch.bfloat16:
        raise AssertionError(f"recorded {len(seen)} softmax calls of "
                             f"{seen[0][0].dtype if seen else None} scores")
    for i, (s, mask, *_rest) in enumerate(seen):
        require_equal(f"bf16 scores, masked softmax kernel, layer {i}",
                      approx.masked_softmax(s, mask, mode="cuda"),
                      masked_plain(s.float(), mask))
    out["cuda_softmax"] = {"layers": len(seen), "scores": list(seen[0][0].shape),
                           "dtype": "bfloat16", "equal": True}
    del eng, seen, logits
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the example twins (ROADMAP A1)
# ---------------------------------------------------------------------------

# the twins' arguments on the card: the reference's defaults, but the KWT
# twins on the cuda backend and quantize_eval on both arch families
EXAMPLE_RUNS = [
    ("quickstart", ["--backend", "cuda"]),
    ("stream_kws", ["--backend", "cuda"]),
    ("cell_flight_drill", ["--backend", "cuda"]),
    ("train_kws_qat", ["--qat-backend", "cuda", "--check-backends"]),
    ("quantize_eval", ["--arch", "kwt-tiny"]),
    ("quantize_eval", ["--arch", "internlm2-1.8b"]),
    ("serve_batched", []),
    ("train_lm", []),
    ("cell_soak", []),
]
# the defaults of the twins (and of the reference's examples) that set
# how many forwards and steps each runs
EVAL_BATCH = 64                  # data.pipeline.gsc_eval_set
QUICKSTART_EVAL_N = 512
STREAM_KWS_HOPS, STREAM_KWS_CHUNK = 400, 2
DRILL_HOPS = 24
QAT_TWIN_STEPS, QAT_TWIN_EVAL_N = 300, 512
QAT_SELECT_N, QAT_SELECT_EVERY = 256, 25   # train_kws_qat.make_eval fold 5
KERNEL_NAMES = ("lut_softmax", "lut_gelu", "int8_matmul", "lut_attention")


def _plus(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def train_kws_qat_launches(cfg) -> dict:
    """train_kws_qat on ``cuda`` with ``--check-backends``: integer
    forwards (PTQ eval, QAT eval, the envelope's batch, the ``cuda`` row of
    the backend matrix) launch every kernel; its QAT steps, the validation
    selections (step 0, every QAT_SELECT_EVERY steps but the last, the
    final one; a fold of QAT_SELECT_N) and the one QAT eval forward run
    float products of fake-quant weights and launch the softmax and the
    GELU only."""
    evals = -(-QAT_TWIN_EVAL_N // EVAL_BATCH)
    int_forwards = 3 * evals + 1
    selects = 2 + sum(1 for i in range(QAT_TWIN_STEPS)
                      if (i + 1) % QAT_SELECT_EVERY == 0
                      and i != QAT_TWIN_STEPS - 1)
    lut_forwards = selects * -(-QAT_SELECT_N // EVAL_BATCH) + 1
    return _plus(expected_launches(cfg, int_forwards),
                 train_launches(cfg, QAT_TWIN_STEPS + lut_forwards))


def example_expected(name: str, argv: list) -> dict:
    """Each twin's launches: a stream step or a lane hop as a forward;
    cell_soak serves on ``lut`` (as the reference hard-codes) and the LM
    twins on ``float`` / ``lut_float``: nothing."""
    tiny = registry.get("kwt-tiny").config
    if name == "quickstart":
        return expected_launches(tiny, -(-QUICKSTART_EVAL_N // EVAL_BATCH))
    if name == "stream_kws":
        return expected_launches(tiny, STREAM_KWS_HOPS // STREAM_KWS_CHUNK)
    if name == "cell_flight_drill":
        from repro_torch.examples import cell_flight_drill
        return expected_launches(registry.get("kwt-tiny").smoke,
                                 DRILL_HOPS + cell_flight_drill.INCIDENT_HOPS)
    if name == "train_kws_qat":
        return train_kws_qat_launches(tiny)
    return {k: 0 for k in KERNEL_NAMES}


@contextlib.contextmanager
def first_kernel_calls():
    """While open, the first call of each kernel wrapper records its
    arguments and output (cloned)."""
    seen, saved = {}, {n: getattr(ops, n) for n in KERNEL_NAMES}

    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        if isinstance(a, quant.QTensor):
            return a.to(a.values.device)
        return a

    def wrap(name, fn):
        def recording(*args, **kw):
            y = fn(*args, **kw)
            if name not in seen:
                seen[name] = (tuple(clone(a) for a in args), dict(kw),
                              y.detach().clone())
            return y
        return recording

    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def require_plain_equal(seen: dict, names) -> dict:
    """Each recorded kernel call against the same wrapper on the same
    inputs moved to the CPU, where it takes the kernel's plain version:
    ``torch.equal``."""
    out = {}
    for name in names:
        if name not in seen:
            raise AssertionError(f"quickstart never called {name}")
        args, kw, y = seen[name]
        cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else
                    a.to("cpu") if isinstance(a, quant.QTensor) else a
                    for a in args)
        with torch.inference_mode():
            want = getattr(ops, name)(*cpu, **kw)
        require_equal(f"quickstart's first {name} call", y.cpu(), want)
        out[name] = {"shape": list(args[0].shape), "equal": True}
    return out


def run_example(name: str, argv: list) -> tuple:
    """``repro_torch.examples.<name>.main(argv + --device cuda)`` with its
    output captured; returns rc, seconds and the printed lines (the
    stream trainer's per-step log lines left out)."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = mod.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.strip() and not ln.startswith("event=train_step")]
    return rc, seconds, lines


def phase_examples(tmp: str) -> tuple:
    """Every twin's ``main`` on the card (``EXAMPLE_RUNS``), each exiting 0
    with its launches equal to ``example_expected``; quickstart's first
    call of each kernel against its plain version.  Returns the path's
    launches (every twin's), the checks' (none) and the expected."""
    rows, path, expected = [], {k: 0 for k in KERNEL_NAMES}, \
        {k: 0 for k in KERNEL_NAMES}
    failures = []
    plain = None
    for name, argv in EXAMPLE_RUNS:
        if name == "cell_flight_drill":
            argv = argv + ["--dump-dir", os.path.join(tmp, "flight_dumps")]
        before = ops.launch_counts()
        if name == "quickstart":
            with first_kernel_calls() as seen:
                rc, seconds, lines = run_example(name, argv)
            rose = _rise(before)
            plain = require_plain_equal(seen, ("lut_softmax", "lut_gelu",
                                               "int8_matmul"))
        else:
            rc, seconds, lines = run_example(name, argv)
            rose = _rise(before)
        want = example_expected(name, argv)
        row = {"example": name, "argv": argv, "rc": rc, "seconds": seconds,
               "launches": rose, "expected_launches": want,
               "lines": lines[-40:]}
        rows.append(row)
        if rc != 0:
            failures.append(f"{name} {argv} exited {rc}: {lines[-3:]}")
        if rose != want:
            failures.append(f"{name} launched {rose}, expected {want}")
        path, expected = _plus(path, rose), _plus(expected, want)
        gc.collect()
        torch.cuda.empty_cache()
    out = {"phase": "examples", "runs": rows, "quickstart_plain": plain,
           "launches": path}
    if failures:
        out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))
    return path, {k: 0 for k in KERNEL_NAMES}, expected


# ---------------------------------------------------------------------------
# the contract line
# ---------------------------------------------------------------------------

SOURCES = {
    "lut_softmax": ("src/repro_torch/csrc/lut_softmax.cu",
                    "src/repro/kernels/lut_softmax.py:76"),
    "lut_gelu": ("src/repro_torch/csrc/lut_gelu.cu",
                 "src/repro/kernels/lut_gelu.py:49"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:53"),
    "lut_attention": ("src/repro_torch/csrc/lut_attention.cu",
                      "src/repro/kernels/lut_attention.py:98"),
}
TIMED_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "library_device_ms", "bytes")
# where a row has them: the attention's bytes bound; the matmul's input
# mode and both of its library calls (or _int_mm's refusal)
EXTRA_KEYS = ("bytes_bound_ms", "input", "library_call", "int_mm_ms",
              "int_mm_device_ms", "int_mm_error", "f32_matmul_ms",
              "f32_matmul_device_ms", "bf16_matmul_ms",
              "bf16_matmul_device_ms", "pairs_per_head", "tile_steps",
              "bound_share", "bytes_bound_share")
LM_ROW_KEYS = ("variant", "tag", "batch", "shape", "shape_mkn",
               "shape_bhhlld", "block_k", "geometry", "within_1e-5",
               "oracle_max_abs_err",
               "dtype", "max_abs_err") + TIMED_KEYS + EXTRA_KEYS


def _variants(rows: list, model: str, batch: int, tag) -> list:
    out = {}
    for r in rows:
        v = out.setdefault(r["variant"], {"variant": r["variant"], "equal": True,
                                          "shapes_checked": 0, "max_abs_err": 0.0})
        v["shapes_checked"] += 1
        v["equal"] = v["equal"] and r["equal"]
        v["max_abs_err"] = max(v["max_abs_err"], r["max_abs_err"])
        if "ms" in r and r.get("model") == model and r.get("batch") == batch \
                and r.get("tag") == tag:
            v.update({k: r[k] for k in TIMED_KEYS})
            v.update({k: r[k] for k in EXTRA_KEYS if k in r})
    return list(out.values())


# ---------------------------------------------------------------------------
# phases 22 - 24: the analysis passes, the compressed sync, the mirrors
# ---------------------------------------------------------------------------

ANALYSIS_KWT_PLANS = [("float", None), ("lut", None), ("cuda", "xla"),
                      ("cuda", "flash_lut")]
# a cuda KWT plan's check_engine: residency's forward + embed_frames +
# encode_window (one forward's launches between them), budget's and
# geometry's forwards; an LM's: residency, budget and geometry forwards
ANALYSIS_KWT_FORWARDS, ANALYSIS_LM_FORWARDS = 4, 3


def engine_on_cpu(eng):
    """The same plan with its (already planned) params on the CPU: a
    ``cuda`` plan there runs its kernels' plain versions."""
    cpu = torch.device("cpu")
    params = tree_map(lambda t: t if t is None else t.to(cpu), eng.params)
    return dataclasses.replace(eng, params=params, device=cpu)


def analysis_summary(rep) -> dict:
    return {"verdict": rep.verdict(),
            "metrics": {r.name: r.metrics for r in rep.results},
            "violations": [f.render() for r in rep.results
                           for f in r.findings if f.severity == "violation"],
            "geometry_rows": [f.message for f in
                              rep.result("geometry").findings
                              if f.kind == "kernel-geometry"]}


def check_plan_analysis(what: str, eng, cpu_eng) -> dict:
    """check_engine on the card plan and on the same plan on the CPU:
    PASS, the verdict, every metric and the geometry rows equal (the
    card's from the launchers' C queries, the CPU's from their Python
    mirrors and the H100 occupancy model)."""
    card = analysis.check_engine(eng)
    cpu = analysis.check_engine(cpu_eng)
    a, b = analysis_summary(card), analysis_summary(cpu)
    if not card.ok:
        raise AssertionError(f"analysis of {what} on the card fails:\n"
                             + card.render())
    if a != b:
        raise AssertionError(f"analysis of {what}: card {a} != cpu {b}")
    if eng.int_resident and a["metrics"]["residency"]["float_leak_count"]:
        raise AssertionError(f"{what}: float_leak_count "
                             f"{a['metrics']['residency']}")
    return a


def check_mutations_on_card(eng, backend: str) -> dict:
    """Each mutation on the card plan where it gates: its pass FAILs."""
    out = {}
    gates = {"float_leak": "residency", "unsat_shift": "ranges",
             "big_lut": "budget"}
    for name, pass_name in gates.items():
        with an_mutations.apply(name):
            rep = analysis.check_engine(eng, passes=(pass_name,))
        caught = not rep.result(pass_name).ok
        out[name] = caught
        gated = backend == "lut" or name != "big_lut"
        if caught != gated:
            raise AssertionError(f"mutation {name} on {backend}: caught "
                                 f"{caught}, expected {gated}")
    if not analysis.check_engine(eng).ok:
        raise AssertionError(f"{backend}: not clean after the mutations")
    return out


def run_analysis_cli(argv: list) -> int:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = analysis_cli(argv)
    if ("seeded:" in buf.getvalue()) != ("--mutate" in argv):
        raise AssertionError(f"analysis CLI {argv}: {buf.getvalue()[-400:]}")
    return code


def phase_analysis(dev, lm_params) -> tuple:
    """Phase 22 (see the module docstring).  Returns the path's launches
    (check_engine on the card's cuda plans), the launches of the checks
    (the mutations and the CLI) and the path's expected."""
    out = {"phase": "analysis", "plans": {}}
    rose = {n: 0 for n in ops.launch_counts()}
    exp = dict(rose)
    for name in ("kwt-tiny", "kwt-1"):
        cfg = registry.get(name).config
        np_tree = seeded_params(cfg, 0, dev)
        card_p = convert.from_numpy_tree(np_tree, dev)
        cpu_p = convert.from_numpy_tree(np_tree, "cpu")
        for backend, attention in ANALYSIS_KWT_PLANS:
            eng = runtime.compile_model(cfg, card_p, backend=backend,
                                        device=dev, attention=attention)
            cpu_eng = runtime.compile_model(
                cfg, cpu_p, backend=backend, device="cpu",
                attention=attention, plain_kernels=backend == "cuda")
            before = ops.launch_counts()
            row = check_plan_analysis(f"{name}/{backend}", eng, cpu_eng)
            got = _rise(before)
            want = expected_launches(cfg, ANALYSIS_KWT_FORWARDS, attention) \
                if backend == "cuda" else {n: 0 for n in rose}
            if got != want:
                raise AssertionError(f"analysis of {name}/{backend}/"
                                     f"{attention} launched {got}, expected "
                                     f"{want}")
            for n in rose:
                rose[n] += got[n]
                exp[n] += want[n]
            if name == "kwt-tiny" and backend == "lut":
                bud = row["metrics"]["budget"]
                if not 0 < bud["total_bytes"] <= bud["budget_bytes"] == 65536:
                    raise AssertionError(f"KWT-Tiny lut budget {bud}")
            out["plans"][f"{name}/{backend}/{attention or 'xla'}"] = row
    # internlm2-1.8b at full width on cuda
    cfg = registry.get(LM_NAME).config
    eng = runtime.compile_model(cfg, lm_params, backend="cuda", device=dev)
    cpu_eng = engine_on_cpu(eng)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out["plans"][f"{LM_NAME}/cuda/xla"] = check_plan_analysis(
        f"{LM_NAME}/cuda", eng, cpu_eng)
    out["seconds_lm_check"] = time.perf_counter() - t0
    got = _rise(before)
    want = lm_expected(cfg, ANALYSIS_LM_FORWARDS)
    if got != want:
        raise AssertionError(f"analysis of {LM_NAME} launched {got}, "
                             f"expected {want}")
    for n in rose:
        rose[n] += got[n]
        exp[n] += want[n]
    del eng, cpu_eng
    gc.collect()
    torch.cuda.empty_cache()
    # the checks: mutations on KWT-Tiny's card plans, the CLI
    before = ops.launch_counts()
    cfg = registry.get("kwt-tiny").config
    card_p = convert.from_numpy_tree(seeded_params(cfg, 0, dev), dev)
    out["mutations"] = {
        backend: check_mutations_on_card(
            runtime.compile_model(cfg, card_p, backend=backend, device=dev),
            backend) for backend in ("lut", "cuda")}
    cli = {}
    for backend in ("lut", "cuda"):
        base = ["check", "--config", "kwt_tiny", "--backend", backend]
        cli[backend] = {"clean": run_analysis_cli(base)}
        for mut in an_mutations.MUTATIONS:
            cli[backend][mut] = run_analysis_cli(base + ["--mutate", mut])
        want_rc = {"clean": 0, "float_leak": 1, "unsat_shift": 1,
                   "big_lut": 1 if backend == "lut" else 0}
        if cli[backend] != want_rc:
            raise AssertionError(f"analysis CLI on {backend}: {cli[backend]}")
    out["cli"] = cli
    checks = _rise(before)
    out["launches"], out["check_launches"] = rose, checks
    emit(out)
    return rose, checks, exp


COMPRESS_LM_ARGS = ["--arch", LM_NAME, "--steps", "3", "--global-batch", "8",
                    "--seq-len", "256", "--seed", "0", "--compressed-grads",
                    "--grad-bits", "4", "--per-channel-scales"]
COMPRESS_KWT1_ARGS = TRAIN_KWT1_ARGS + ["--compressed-grads"]
COMPRESS_TIMED = 3            # sync calls timed (p50)


def time_sync(grads, err, per_channel: bool, bits: int) -> float:
    """p50 ms of one compressed_grad_sync of ``grads`` on the card."""
    mesh = mesh_mod.make_host_mesh()
    times = []
    for _ in range(COMPRESS_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compress.compressed_grad_sync(grads, err, mesh,
                                      per_channel=per_channel, bits=bits)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def watch_sync_memory(calls: list):
    """Inside the block each ``compress.compressed_grad_sync`` call appends
    to ``calls`` the card's bytes allocated at its entry and exit, its
    peak within, and the peak of the stretch before it (since the last
    sync, or the block's start): where a step's peak lies."""
    real = compress.compressed_grad_sync

    def watched(*args, **kwargs):
        calls.append({"peak_before": torch.cuda.max_memory_allocated(),
                      "at_entry": torch.cuda.memory_allocated()})
        torch.cuda.reset_peak_memory_stats()
        out = real(*args, **kwargs)
        calls[-1].update(peak_within=torch.cuda.max_memory_allocated(),
                         at_exit=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out
    compress.compressed_grad_sync = watched
    try:
        yield
    finally:
        compress.compressed_grad_sync = real


def check_sync_card_vs_cpu(params, err) -> dict:
    """The sync of ``params`` (as gradients) with residuals ``err`` on the
    card and on the CPU: synced leaves and new residuals torch.equal, and
    ``synced + e' == g + e`` exactly on the card."""
    mesh = mesh_mod.make_host_mesh()
    cpu = torch.device("cpu")
    g_cpu = tree_map(lambda t: t.to(cpu), params)
    e_cpu = tree_map(lambda t: t.to(cpu), err)
    rows = {}
    for bits in (8, 4):
        for per_channel in (False, True):
            s1, e1 = compress.compressed_grad_sync(
                params, err, mesh, per_channel=per_channel, bits=bits)
            s2, e2 = compress.compressed_grad_sync(
                g_cpu, e_cpu, mesh, per_channel=per_channel, bits=bits)
            equal = all(torch.equal(a.cpu(), b) for a, b in
                        zip(tree_leaves(s1) + tree_leaves(e1),
                            tree_leaves(s2) + tree_leaves(e2)))
            identity = all(torch.equal(s + e, g.float() + e0) for s, e, g, e0
                           in zip(tree_leaves(s1), tree_leaves(e1),
                                  tree_leaves(params), tree_leaves(err)))
            if not (equal and identity):
                raise AssertionError(f"compressed sync at {bits} bits, per "
                                     f"channel {per_channel}: card == cpu "
                                     f"{equal}, Q(c) + e' == c {identity}")
            rows[f"int{bits}{'_per_channel' if per_channel else ''}"] = {
                "card_equals_cpu": equal, "identity": identity}
    return rows


def phase_compress(dev) -> tuple:
    """Phase 23 (see the module docstring).  Returns the path's launches
    (the compressed KWT-1 QAT run), the checks' and the path's expected."""
    out = {"phase": "compress"}
    cfg = registry.get("kwt-1").config
    before = ops.launch_counts()
    result, _ = run_main(COMPRESS_KWT1_ARGS)
    path = _rise(before)
    n_steps = int(COMPRESS_KWT1_ARGS[COMPRESS_KWT1_ARGS.index("--steps") + 1])
    expected = train_launches(cfg, n_steps)
    if path != expected:
        raise AssertionError(f"the compressed KWT-1 run launched {path}, "
                             f"expected {expected}")
    if not all(np.isfinite(result.losses)) or result.err is None:
        raise AssertionError(f"compressed KWT-1 losses {result.losses}")
    before = ops.launch_counts()
    plain, _ = run_main(TRAIN_KWT1_ARGS)
    out["kwt_1"] = {
        "argv": COMPRESS_KWT1_ARGS, "losses": result.losses,
        "p50_ms_per_step": statistics.median(result.step_ms),
        "p50_ms_per_step_uncompressed": statistics.median(plain.step_ms),
        "sync_ms_int8": time_sync(result.params, result.err, False, 8),
        "card_vs_cpu": check_sync_card_vs_cpu(result.params, result.err)}
    checks = _rise(before)
    del result, plain
    gc.collect()
    torch.cuda.empty_cache()
    # internlm2-1.8b at full width: 3 steps with the int4 per-channel sync
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    syncs = []
    with watch_sync_memory(syncs):
        result, _ = run_main(COMPRESS_LM_ARGS)
    after = torch.cuda.max_memory_allocated()
    peak = max([after] + [max(c["peak_before"], c["peak_within"])
                          for c in syncs])
    if not all(np.isfinite(result.losses)) or len(result.losses) != 3:
        raise AssertionError(f"{LM_NAME} compressed losses {result.losses}")
    err_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(result.err))
    before = ops.launch_counts()
    out["internlm2"] = {
        "argv": COMPRESS_LM_ARGS, "losses": result.losses,
        "step_ms": result.step_ms,
        "p50_ms_per_step": statistics.median(result.step_ms),
        "peak_gb": peak / 1e9, "err_state_gb": err_bytes / 1e9,
        "sync_memory_gb": [{k: v / 1e9 for k, v in c.items()}
                           for c in syncs],
        "peak_gb_after_last_sync": after / 1e9,
        "seconds": time.perf_counter() - t0,
        "sync_ms_int4_per_channel": time_sync(result.params, result.err,
                                              True, 4)}
    lm_checks = _rise(before)
    checks = {n: checks[n] + lm_checks[n] for n in checks}
    del result
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


MESH_LM_ARGS = ["--arch", LM_NAME, "--steps", "2", "--global-batch", "8",
                "--seq-len", "256", "--seed", "0"]
MESH_KWT1_ARGS = ["--arch", "kwt-1", "--qat", "--qat-backend", "cuda",
                  "--steps", "2", "--global-batch", "64"]
MESH_ARGS = ["--data", "1", "--model", "1"]


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group on the card (a localhost rendezvous),
    destroyed on exit."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _trees_equal(what: str, a, b) -> int:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{what}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: leaf {i} differs (max abs "
                                 f"{max_abs_err(x, y)})")
    return len(la)


def mesh_lm_run(argv, dev) -> tuple:
    """internlm2-1.8b's launcher run: (result, its figures)."""
    torch.cuda.reset_peak_memory_stats()
    result, _ = run_main(argv)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(result.losses)) or len(result.losses) != 2:
        raise AssertionError(f"{argv}: losses {result.losses}")
    b = int(argv[argv.index("--global-batch") + 1])
    s = int(argv[argv.index("--seq-len") + 1])
    n_ops = count_step_ops(
        lm_step_of(result), (result.params, result.opt_state),
        steps.to_device(lm_batch_for(result.cfg, 0, 2, b, s), dev))
    return result, {"argv": argv, "losses": result.losses,
                    "step_ms": result.step_ms,
                    "p50_ms_per_step": statistics.median(result.step_ms),
                    "peak_gb": peak / 1e9, "aten_ops_per_step": n_ops}


def mesh_moe_calls(eng, toks, drops: list) -> tuple:
    """A prefill of ``toks`` and one decode step (its greedy token) on a
    fresh state; every moe block's dropped slots appended to ``drops``."""
    slots = lm_moe._slots

    def counting(idx, **kw):
        lid, pos, keep = slots(idx, **kw)
        drops.append(int((~keep).sum()))
        return lid, pos, keep

    lm_moe._slots = counting
    try:
        state = eng.init_decode_state(toks.shape[0], toks.shape[1] + 1)
        pre, state = eng.prefill(toks, state)
        nxt = pre.argmax(-1).cpu().numpy().astype(np.int32)
        dec, _ = eng.decode_step(nxt, state)
    finally:
        lm_moe._slots = slots
    return pre, dec


def phase_mesh(dev) -> tuple:
    """Phase 25 (see the module docstring).  The off-mesh runs come first
    (without a process group the launcher's mesh is the one-device
    ``HostMesh``); the mesh runs then go on the one-rank NCCL group.
    Returns the mesh path's launches, the checks' and the path's
    expected."""
    from repro_torch.dist import ctx, sharding
    out = {"phase": "mesh"}
    checks = ops.launch_counts()
    off, off_row = mesh_lm_run(MESH_LM_ARGS, dev)
    # held on the host, so that the mesh run's peak is its own
    off_params = tree_map(lambda t: t.cpu(), off.params)
    del off
    gc.collect()
    torch.cuda.empty_cache()
    kwt_off = [run_main(MESH_KWT1_ARGS + extra)[0]
               for extra in ([], ["--compressed-grads"])]
    checks = _rise(checks)
    kcfg = registry.get("kwt-1").config
    n_kwt = int(MESH_KWT1_ARGS[MESH_KWT1_ARGS.index("--steps") + 1])
    mcfg = registry.get(MOE_NAME).config
    expected = _plus(_plus(train_launches(kcfg, n_kwt),
                           train_launches(kcfg, n_kwt)),
                     lm_expected(mcfg, 2))
    path = {n: 0 for n in KERNEL_NAMES}
    with one_rank_nccl():
        mesh = mesh_mod.make_host_mesh(1, 1)
        out["mesh"] = {"type": type(mesh).__name__, "device": mesh.device_type,
                       "shape": list(mesh.shape),
                       "axes": list(mesh.mesh_dim_names)}
        # (a) internlm2-1.8b at full width through the launcher
        on, on_row = mesh_lm_run(MESH_LM_ARGS + MESH_ARGS, dev)
        if not sharding.is_dtensor(tree_leaves(on.params)[0]):
            raise AssertionError("the mesh run's params are not placed")
        if on.losses != off_row["losses"]:
            raise AssertionError(f"mesh losses {on.losses} against "
                                 f"{off_row['losses']} off the mesh")
        n = _trees_equal(f"{LM_NAME} mesh params",
                         tree_map(lambda t: t.cpu(), sharding.local(on.params)),
                         off_params)
        out["internlm2"] = {"off_mesh": off_row, "mesh": on_row,
                            "losses_equal": True, "params_equal": n}
        del on, off_params
        gc.collect()
        torch.cuda.empty_cache()
        # (c) + (d) KWT-1 QAT on the cuda kernels, plain and compressed
        out["kwt_1"] = {}
        for extra, ref_run in zip(([], ["--compressed-grads"]), kwt_off):
            before = ops.launch_counts()
            got, _ = run_main(MESH_KWT1_ARGS + MESH_ARGS + extra)
            rose = _rise(before)
            if rose != train_launches(kcfg, n_kwt):
                raise AssertionError(f"KWT-1 mesh QAT {extra} launched "
                                     f"{rose}")
            path = _plus(path, rose)
            if got.losses != ref_run.losses:
                raise AssertionError(f"KWT-1 mesh QAT {extra} losses "
                                     f"{got.losses} against {ref_run.losses}")
            n = _trees_equal(f"KWT-1 mesh QAT {extra} params",
                             sharding.local(got.params), ref_run.params)
            if extra:
                _trees_equal("KWT-1 mesh error state", got.err, ref_run.err)
            out["kwt_1"]["compressed" if extra else "plain"] = {
                "losses": got.losses, "params_equal": n, "launches": rose,
                "p50_ms_per_step": statistics.median(got.step_ms),
                "p50_ms_per_step_off_mesh": statistics.median(
                    ref_run.step_ms)}
        del kwt_off
        # (b) granite-moe-3b-a800m at full width: the expert-parallel branch
        params = lm_model.init_params(
            mcfg, torch.Generator(device=dev).manual_seed(0), dev)
        eng = runtime.compile_model(mcfg, params, backend="cuda", device=dev)
        del params
        toks = np.random.default_rng(7).integers(
            0, mcfg.vocab_size, (LM_SLOTS, 63)).astype(np.int32)
        before = ops.launch_counts()
        local_drops, ep_drops = [], []
        local = mesh_moe_calls(eng, toks, local_drops)
        checks = _plus(checks, _rise(before))
        before = ops.launch_counts()
        with mesh, ctx.mesh_context(mesh_mod.dp_axes(mesh)):
            if not ctx._mesh_active():
                raise AssertionError("the mesh context is not active")
            ep = mesh_moe_calls(eng, toks, ep_drops)
        rose = _rise(before)
        path = _plus(path, rose)
        for what, a, b in (("prefill", ep[0], local[0]),
                           ("decode", ep[1], local[1])):
            require_equal(f"{MOE_NAME} expert-parallel {what} logits", a, b)
        if ep_drops != local_drops:
            raise AssertionError(f"dropped slots {ep_drops} against "
                                 f"{local_drops}")
        out["granite_moe"] = {"tokens": list(toks.shape),
                              "capacity_factor": mcfg.capacity_factor,
                              "logits_equal": True,
                              "dropped": sum(ep_drops),
                              "dropped_per_call_layer": ep_drops,
                              "launches": rose}
        del eng, local, ep
        gc.collect()
        torch.cuda.empty_cache()
    if path != expected:
        raise AssertionError(f"the mesh path launched {path}, expected "
                             f"{expected}")
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


def phase_geometry_mirror(dev) -> None:
    """Phase 24: every launch of this run against its kernel's C query."""
    t0 = time.perf_counter()
    rows = an_geometry.check_launch_log(GEO_LOG, dev)
    # the wide attention's launches among them (D > 128): every one is
    # held like the rest, and its (item, key tile) steps, the mirror's
    # (lut_attention.tile_steps) against the kernel's own item order's
    wide = {tuple(a[5:13]) for e, a in GEO_LOG
            if e == "lut_attention_launch" and a[10] > lut_attn.NARROW_D}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps_apart = []
    for args in sorted(wide):
        c = an_geometry.c_wide_steps(tuple(int(x) for x in args))
        m = lut_attn.tile_steps(*args[:7], bool(args[7]), sms=sms,
                                occupancy=an_geometry.card_occupancy)
        if c != m:
            steps_apart.append({"args": list(args), "c": c, "mirror": m})
    out = {"phase": "geometry_mirror",
           "kernels": {k: {"shapes": v["shapes"],
                           "mismatches": len(v["mismatches"])}
                       for k, v in rows.items()},
           "wide_attention_shapes": len(wide),
           "wide_tile_steps_apart": len(steps_apart),
           "seconds": time.perf_counter() - t0}
    emit(out)
    bad = {k: v["mismatches"][:3] for k, v in rows.items() if v["mismatches"]}
    if bad or steps_apart or set(rows) != set(SOURCES) or not wide:
        raise AssertionError(f"geometry mirror != C query: {bad}, tile "
                             f"steps {steps_apart[:3]}, kernels "
                             f"{sorted(rows)}, {len(wide)} wide attention "
                             "shapes")


def kernels_line(rows: dict, launches: dict, expected: dict,
                 headline_model: str, headline_batch: int) -> dict:
    """One entry per kernel.  The headline numbers are those of the
    variant the main path runs (Q8.24 softmax, nearest GELU, the float32
    epilogue at the MLP's first linear, LUT attention) at
    ``headline_model`` / ``headline_batch``; ``variants`` sums up every
    checked variant (all shapes, ragged ones included) with its own
    headline times where it was timed.  ``launches`` is the sum over the
    main paths, ``launches_by_path`` each path's own count, which must be
    ``expected[path]``; every kernel must be launched by some path (the
    train path launches neither the matmul nor the attention).  The
    ``kernels`` phase line above holds every row."""
    for path, counts in launches.items():
        if counts != expected[path]:
            raise AssertionError(f"the {path} path launched {counts}, "
                                 f"expected {expected[path]}")
    main_variant = {"lut_softmax": lambda r: r["variant"] == "fixed",
                    "lut_gelu": lambda r: r["variant"] == "nearest",
                    # the int8 plans' input: the float activation
                    "int8_matmul": lambda r: r.get("tag") == "w1"
                    and r["variant"] == "f32 int8 residual16 float-x",
                    "lut_attention": lambda r: r["variant"] == "lut"}
    entries = []
    for name, (source, replaces) in SOURCES.items():
        head = next(r for r in rows[name]
                    if r.get("model") == headline_model
                    and r.get("batch") == headline_batch
                    and main_variant[name](r))
        by_path = {path: counts[name] for path, counts in launches.items()}
        if sum(by_path.values()) <= 0:
            raise AssertionError(f"no main path launched {name}: {by_path}")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
            **{k: head[k] for k in EXTRA_KEYS if k in head},
            "shape": head.get("shape", head.get("shape_mkn",
                                                head.get("shape_bhhlld"))),
            "model": headline_model, "batch": headline_batch,
            "equal": all(r["equal"] for r in rows[name]),
            "variants": _variants(rows[name], headline_model, headline_batch,
                                  head.get("tag")),
            # the timed rows at the dense LM's shapes and the moe router's
            "lm": [{k: r[k] for k in LM_ROW_KEYS if k in r}
                   for r in rows[name]
                   if r.get("model") == LM_NAME and "ms" in r],
            "moe": [{k: r[k] for k in LM_ROW_KEYS if k in r}
                    for r in rows[name]
                    if r.get("model") == MOE_NAME and "ms" in r],
            # the recurrent LMs' heads and hymba's masked softmax rows
            "rwkv": [{k: r[k] for k in LM_ROW_KEYS if k in r}
                     for r in rows[name]
                     if r.get("model") == RWKV_NAME and "ms" in r],
            "hybrid": [{k: r[k] for k in LM_ROW_KEYS if k in r}
                       for r in rows[name]
                       if r.get("model") == HYMBA_NAME and "ms" in r],
            # the encoder-decoder's rows (whisper-large-v3, 4 clips)
            "encdec": [{k: r[k] for k in LM_ROW_KEYS if k in r}
                       for r in rows[name]
                       if r.get("model") == WHISPER_NAME and "ms" in r],
            # nemotron-4-340b's head and head_dim-192 attention
            "nemotron": [{k: r[k] for k in LM_ROW_KEYS if k in r}
                         for r in rows[name]
                         if r.get("model") == NEMOTRON_NAME and "ms" in r]})
    return {"kernels": entries}


# ---------------------------------------------------------------------------
# the dry run and program pricing (ROADMAP A4.4)
# ---------------------------------------------------------------------------

DRYRUN_BUDGET_S = 180
DRYRUN_CELLS, DRYRUN_SKIPS = 32, 8
# how far the modelled peak without donation may lie from the card's
# max_memory_allocated on train_lm's step: 55.82 against 54.94 GB, 1.6 %
# (PERF.md), so about three times that
DRYRUN_PEAK_BAND = 0.05


def collective_bytes(cost: dict) -> dict:
    """A cell's collective bytes by kind: each component's times its
    multiplier (``dryrun.combine`` sums only their total)."""
    out = {}
    for comp in cost["components"]:
        for kind, n in comp["collectives"].items():
            out[kind] = out.get(kind, 0.0) + comp["multiplier"] * n
    return out


def dryrun_cli(tmp: str) -> dict:
    """(a) ``python -m repro_torch.launch.dryrun --mesh single --force`` in
    a subprocess (the fake 512-rank world takes a process of its own) over
    every assigned cell, a worker a core: per cell rank 0's peak in GB,
    whether it fits the card's 80 GB, its memory method, the roofline
    terms, the dominant one, the collective bytes by kind, model_to_hlo
    and seconds.  The peak is given with the donated arguments reused
    (``peak_bytes_est``, ``fits_hbm``) and without (``no_donation``,
    the figure the card's peak agrees with: :func:`dryrun_calibration`).  (The multi-pod pass, memory only, does not fit the
    phase's budget beside it: ``PERF.md`` gives it from a run of the
    CLI.)"""
    jobs = max(1, min(8, os.cpu_count() or 1))
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
            "single", "--force", "--jobs", str(jobs), "--results-dir", tmp]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    t0 = time.perf_counter()
    p = subprocess.run(argv, env=env, capture_output=True, text=True,
                       timeout=900)
    seconds = time.perf_counter() - t0
    if p.returncode != 0 or "dry-run complete." not in p.stdout:
        raise AssertionError(f"dry run exited {p.returncode}: "
                             f"{p.stdout[-3000:]} {p.stderr[-3000:]}")
    cells, skipped = [], 0
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name)) as fh:
            rec = json.load(fh)
        if "skipped" in rec:
            skipped += 1
            continue
        roof = rec["roofline"]
        cells.append({
            "arch": rec["arch"], "shape": rec["shape"],
            "peak_gb": rec["memory"]["peak_bytes_est"] / 1e9,
            "fits_hbm": rec["fits_hbm"],
            "no_donation_gb": rec["memory"]["peak_no_donation"] / 1e9,
            "fits_hbm_no_donation": rec["fits_hbm_no_donation"],
            "memory_method": rec["memory_method"],
            **{k: roof[k] for k in ("compute_s", "memory_s",
                                    "collective_s", "dominant")},
            "collectives": collective_bytes(rec["cost"]),
            "model_to_hlo": rec["model_to_hlo"], "seconds": rec["lower_s"]})
        if not all(np.isfinite(v) and v >= 0 for v in (
                cells[-1]["peak_gb"], roof["compute_s"], roof["memory_s"],
                roof["collective_s"])):
            raise AssertionError(f"dry run cell {cells[-1]}")
    if (len(cells), skipped) != (DRYRUN_CELLS, DRYRUN_SKIPS):
        raise AssertionError(f"dry run: {len(cells)} cells and {skipped} "
                             f"skips, not {DRYRUN_CELLS} and {DRYRUN_SKIPS}")
    return {"argv": argv[1:], "jobs": jobs, "seconds": seconds,
            "fit": sum(c["fits_hbm"] for c in cells),
            "fit_no_donation": sum(c["fits_hbm_no_donation"] for c in cells),
            "cells": cells}


def dryrun_calibration(measured: dict, info: dict) -> dict:
    """(b) ``train_lm``'s float step (internlm2-1.8b at full width, 8 x
    256, bf16, remat) lowered on the one-device mesh with
    ``steps.lower_program`` on meta tensors, beside the card's run of the
    same step in this script: the walk's ATen ops against the card's (by
    name where they differ), the reckoned peak against
    ``torch.cuda.max_memory_allocated``, the roofline time against the
    measured p50.  It fails if the ops differ, if the peak without
    donation lies more than ``DRYRUN_PEAK_BAND`` from the card's, or if
    the roofline time, a bound, lies above the measured p50."""
    from repro_torch.launch import dryrun
    cfg = registry.get(LM_NAME).config
    b = int(TRAIN_LM_ARGS[TRAIN_LM_ARGS.index("--global-batch") + 1])
    s = int(TRAIN_LM_ARGS[TRAIN_LM_ARGS.index("--seq-len") + 1])
    host = mesh_mod.HostMesh()
    shape = ShapeSpec("custom", s, b, "train")
    hp = dataclasses.replace(steps.hparams_for(cfg), lr=1e-3,
                             warmup_steps=2, total_steps=10)
    prog = dataclasses.replace(
        steps.build_step_program(cfg, shape, host, n_micro=1),
        fn=steps.make_train_step(cfg, shape, hp, n_micro=1))
    t0 = time.perf_counter()
    lowered = steps.lower_program(prog, host)
    walk_s = time.perf_counter() - t0
    walk = collections.Counter("pow" if r.name == "square" else r.name
                               for r in lowered.records)
    card = measured["aten_ops_by_name"]
    differ = {k: {"card": card.get(k, 0), "walk": walk.get(k, 0)}
              for k in sorted(set(card) | set(walk))
              if card.get(k, 0) != walk.get(k, 0)}
    ma = lowered.memory_analysis()
    cost = dryrun.cost_of(lowered)
    roof = dryrun.roofline(cost, 1)
    roof_ms = 1e3 * max(roof["compute_s"], roof["memory_s"],
                        roof["collective_s"])
    n_params = sum(t.numel() for t in tree_leaves(prog.args[0]))
    model_ms = 1e3 * 6.0 * n_params * b * s / roofline.H100_PEAK_FLOPS_BF16
    no_donation = ma.peak_bytes_est + ma.alias_size_in_bytes
    off = abs(no_donation - measured["peak_bytes"]) / measured["peak_bytes"]
    if differ or len(lowered.records) != measured["aten_ops"]:
        raise AssertionError(
            f"the walk's ATen ops ({len(lowered.records)}) are not the "
            f"card's ({measured['aten_ops']}): {differ}")
    if off > DRYRUN_PEAK_BAND:
        raise AssertionError(
            f"modelled peak without donation {no_donation / 1e9:.2f} GB is "
            f"{100 * off:.1f} % from the card's "
            f"{measured['peak_bytes'] / 1e9:.2f} GB")
    if roof_ms > measured["p50_ms"]:
        raise AssertionError(f"roofline {roof_ms:.1f} ms above the "
                             f"measured p50 {measured['p50_ms']:.1f} ms")
    return {
        "model": LM_NAME, "argv": TRAIN_LM_ARGS,
        "card": info["nvidia_smi"], "walk_s": walk_s,
        "aten_ops": {"walk": len(lowered.records),
                     "card": measured["aten_ops"], "differ": differ},
        "memory": {"argument_gb": ma.argument_size_in_bytes / 1e9,
                   "output_gb": ma.output_size_in_bytes / 1e9,
                   "temp_gb": ma.temp_size_in_bytes / 1e9,
                   "alias_gb": ma.alias_size_in_bytes / 1e9,
                   "peak_bytes_est_gb": ma.peak_bytes_est / 1e9,
                   "no_donation_gb": no_donation / 1e9,
                   "measured_peak_gb": measured["peak_bytes"] / 1e9,
                   "no_donation_off": off, "band": DRYRUN_PEAK_BAND},
        "cost": {k: cost[k] for k in ("flops", "bytes", "collective_bytes")},
        "roofline": roof, "roofline_ms": roof_ms,
        "model_flops_ms": model_ms,
        "measured_p50_ms": measured["p50_ms"],
        "measured_over_roofline": measured["p50_ms"] / roof_ms}


def phase_dryrun(info: dict) -> None:
    """Phase 26 (see the module docstring): the dry run over every
    production cell, and the model against the card on ``train_lm``'s
    step.  It launches no kernel, and fails past ``DRYRUN_BUDGET_S``."""
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = {"phase": "dryrun"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_",
                                     dir=build.build_dir()) as tmp:
        out["cli"] = dryrun_cli(tmp)
    out["calibration"] = dryrun_calibration(TRAIN_LM_MEASURED, info)
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = DRYRUN_BUDGET_S
    if out["seconds"] > DRYRUN_BUDGET_S:
        raise AssertionError(f"phase dryrun took {out['seconds']:.1f} s, "
                             f"over its {DRYRUN_BUDGET_S} s")
    rose = _rise(before)
    if any(rose.values()):
        raise AssertionError(f"the dry run launched {rose}")
    emit(out)


def main() -> None:
    t_start = time.perf_counter()
    seconds = {}
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    seconds["build"] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    tiny, kwt1 = registry.get("kwt-tiny").config, registry.get("kwt-1").config
    with launch_log(True):
        rows = phase_kernels(dev, (tiny, kwt1))
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    roof = phase_perf(dev, info)
    seconds["perf"] = time.perf_counter() - t0

    # The main paths.  Every count goes to 0 just before each and is read
    # just after it: launches made above to compare kernels do not count.
    launches, expected = {}, {}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    serve = [phase_serve("kwt-tiny", dev, (1, 8, 64, 4096),
                         [("int8 (Table V)", None, "xla"),
                          ("int8 (Table V)", None, "flash_lut")], requests=5),
             phase_serve("kwt-1", dev, (1, 64),
                         [("int8 (Table V defaults)", None, "xla"),
                          ("int4 per-channel", dict(bits=4, weight_exponent=4,
                                                    per_channel=True), "xla"),
                          ("int8 (Table V defaults)", None, "flash_lut")])]
    launches["serve"] = ops.launch_counts()
    expected["serve"] = {n: sum(e[n] for e in serve) for n in serve[0]}
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    runs = [phase_stream("kwt-tiny", dev, lanes=64, hops=64, reset_at=30),
            phase_stream("kwt-1", dev, lanes=64, hops=216, reset_at=104)]
    counted = ops.launch_counts()
    # the stream path's own launches: what the counters read less what the
    # check forwards added, which must be what its stream_step calls added
    launches["stream"] = {n: counted[n] - sum(c[n] for _, c, _ in runs)
                          for n in counted}
    expected["stream"] = {n: sum(e[n] for _, _, e in runs) for n in counted}
    steps_rose = {n: sum(s[n] for s, _, _ in runs) for n in counted}
    if launches["stream"] != steps_rose:
        raise AssertionError(f"stream launches {launches['stream']} are not "
                             f"those of its steps, {steps_rose}")
    seconds["stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the cell path: the lanes' hops (the launcher's, and the KWT-1 cell's
    # three lane sets and its profiled joint and pipelined hops), less the launches of the KWT-1 phase's checks
    # (hot-swap's warm and probe forwards, the refused artifact's, the taps
    # plan's and its untapped comparison)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cell_",
                                     dir=build.build_dir()) as tmp:
        tiny_rose, tiny_expected = phase_cell_kwt_tiny(dev, tmp)
        k1_rose, k1_checks, k1_expected = phase_cell_kwt_1(dev, tmp)
    counted = ops.launch_counts()
    launches["cell"] = {n: counted[n] - k1_checks[n] for n in counted}
    expected["cell"] = {n: tiny_expected[n] + k1_expected[n] for n in counted}
    lanes_rose = {n: tiny_rose[n] + k1_rose[n] for n in counted}
    if launches["cell"] != lanes_rose:
        raise AssertionError(f"cell launches {launches['cell']} are not those "
                             f"of its hops, {lanes_rose}")
    seconds["cell"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the train path: the launcher's runs, less the launches of the checks
    # each train phase makes after them
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=build.build_dir()) as tmp:
        runs = [phase_train_kwt_tiny(dev, tmp), phase_train_kwt_1(dev)]
    counted = ops.launch_counts()
    launches["train"] = {n: counted[n] - sum(c[n] for _, c, _ in runs)
                         for n in counted}
    expected["train"] = {n: sum(e[n] for _, _, e in runs) for n in counted}
    runs_rose = {n: sum(p[n] for p, _, _ in runs) for n in counted}
    if launches["train"] != runs_rose:
        raise AssertionError(f"train launches {launches['train']} are not "
                             f"those of its runs, {runs_rose}")
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the LM path: the LM server's run (internlm2-1.8b at full width) and
    # one flash_lut forward, less the launches of the checks the phase makes
    # besides; then the five dense smoke configs, whose launches are checks
    # of no path
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_",
                                     dir=build.build_dir()) as tmp:
        lm_rose, lm_checks, lm_exp, lm_params = phase_lm_internlm2(
            dev, tmp, roof)
    counted = ops.launch_counts()
    launches["lm"] = {n: counted[n] - lm_checks[n] for n in counted}
    expected["lm"] = lm_exp
    if launches["lm"] != lm_rose:
        raise AssertionError(f"lm launches {launches['lm']} are not those of "
                             f"its served run and flash forward, {lm_rose}")
    seconds["lm_internlm2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the int8-cache path: the same weights and requests served on an int8
    # KV cache, less the launches of the checks the phase makes after it
    ops.reset_launch_counts()
    kv_rose, kv_checks, kv_exp = phase_lm_int8_kv(dev, lm_params)
    counted = ops.launch_counts()
    launches["lm_int8_kv"] = {n: counted[n] - kv_checks[n] for n in counted}
    expected["lm_int8_kv"] = kv_exp
    if launches["lm_int8_kv"] != kv_rose:
        raise AssertionError(f"int8-cache launches {launches['lm_int8_kv']} "
                             f"are not those of its served run, {kv_rose}")
    gc.collect()
    torch.cuda.empty_cache()
    seconds["lm_int8_kv"] = time.perf_counter() - t0
    # the bf16 score path on the same weights: checks of no path
    t0 = time.perf_counter()
    phase_lm_scores_bf16(dev, lm_params)
    seconds["lm_scores_bf16"] = time.perf_counter() - t0
    # the analysis path: check_engine on the card's cuda plans (KWT and
    # the same internlm2 weights), less the launches of the mutation and
    # CLI checks
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with launch_log(True):
        a_rose, a_checks, a_exp = phase_analysis(dev, lm_params)
    counted = ops.launch_counts()
    launches["analysis"] = {n: counted[n] - a_checks[n] for n in counted}
    expected["analysis"] = a_exp
    if launches["analysis"] != a_rose:
        raise AssertionError(f"analysis launches {launches['analysis']} are "
                             f"not those of its check_engine runs, {a_rose}")
    seconds["analysis"] = time.perf_counter() - t0
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_lm_smoke(dev)
    seconds["lm_dense_smoke"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the moe path: the moe server's run (granite-moe-3b-a800m at full
    # width), less the launches of the checks the phase makes after it
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_",
                                     dir=build.build_dir()) as tmp:
        moe_rose, moe_checks, moe_exp = phase_lm_granite_moe(dev, tmp, roof)
    counted = ops.launch_counts()
    launches["moe"] = {n: counted[n] - moe_checks[n] for n in counted}
    expected["moe"] = moe_exp
    if launches["moe"] != moe_rose:
        raise AssertionError(f"moe launches {launches['moe']} are not those "
                             f"of its served run, {moe_rose}")
    seconds["lm_granite_moe"] = time.perf_counter() - t0
    # the recurrent paths: each LM's drain batch, less the launches of the
    # checks its phase makes after it
    for path, name in (("rwkv", RWKV_NAME), ("hybrid", HYMBA_NAME)):
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        rose, rchecks, rexp = phase_lm_recurrent(dev, name, roof)
        counted = ops.launch_counts()
        launches[path] = {n: counted[n] - rchecks[n] for n in counted}
        expected[path] = rexp
        if launches[path] != rose:
            raise AssertionError(f"{path} launches {launches[path]} are not "
                                 f"those of its drain batch, {rose}")
        seconds[f"lm_{'rwkv6' if path == 'rwkv' else 'hymba'}"] = \
            time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    # the encdec path: the whisper clips' prefill and greedy decode and one
    # flash-LUT forward, less the launches of the checks its phase makes
    # after them
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rose, wchecks, wexp = phase_lm_whisper(dev)
    counted = ops.launch_counts()
    launches["encdec"] = {n: counted[n] - wchecks[n] for n in counted}
    expected["encdec"] = wexp
    if launches["encdec"] != rose:
        raise AssertionError(f"encdec launches {launches['encdec']} are not "
                             f"those of its clips and flash forward, {rose}")
    seconds["lm_whisper"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the nemotron path: its flash_lut forward and its served requests,
    # less the launches of the checks its phase makes besides
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rose, nchecks, nexp = phase_lm_nemotron(dev)
    counted = ops.launch_counts()
    launches["lm_nemotron"] = {n: counted[n] - nchecks[n] for n in counted}
    expected["lm_nemotron"] = nexp
    if launches["lm_nemotron"] != rose:
        raise AssertionError(f"lm_nemotron launches "
                             f"{launches['lm_nemotron']} are not those of "
                             f"its flash forward and served run, {rose}")
    seconds["lm_nemotron"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the LM train path: the launcher's runs (internlm2-1.8b at full width,
    # float and QAT, and the smoke LM's crash, resume and uninterrupted
    # runs), less the launches of the checks the phase makes besides
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_",
                                     dir=build.build_dir()) as tmp:
        rose, tchecks, texp = phase_train_lm(dev, tmp)
    counted = ops.launch_counts()
    launches["train_lm"] = {n: counted[n] - tchecks[n] for n in counted}
    expected["train_lm"] = texp
    if launches["train_lm"] != rose:
        raise AssertionError(f"train_lm launches {launches['train_lm']} are "
                             f"not those of its launcher runs, {rose}")
    seconds["train_lm"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the compress path: the compressed KWT-1 QAT run, less the launches of
    # the checks (the uncompressed run, the card-vs-CPU syncs) and of the
    # internlm2 compressed run (float: it launches nothing)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    c_rose, c_checks, c_exp = phase_compress(dev)
    counted = ops.launch_counts()
    launches["compress"] = {n: counted[n] - c_checks[n] for n in counted}
    expected["compress"] = c_exp
    if launches["compress"] != c_rose:
        raise AssertionError(f"compress launches {launches['compress']} are "
                             f"not those of its compressed run, {c_rose}")
    seconds["compress"] = time.perf_counter() - t0
    # the examples path: every twin's main on the card
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_",
                                     dir=build.build_dir()) as tmp:
        rose, echecks, eexp = phase_examples(tmp)
    counted = ops.launch_counts()
    launches["examples"] = {n: counted[n] - echecks[n] for n in counted}
    expected["examples"] = eexp
    if launches["examples"] != rose:
        raise AssertionError(f"examples launches {launches['examples']} are "
                             f"not those of its twins, {rose}")
    seconds["examples"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the mesh path: the runs on the one-rank NCCL mesh, less the launches
    # of their off-mesh twins and of the moe's local branch
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rose, m_checks, m_exp = phase_mesh(dev)
    counted = ops.launch_counts()
    launches["mesh"] = {n: counted[n] - m_checks[n] for n in counted}
    expected["mesh"] = m_exp
    if launches["mesh"] != rose:
        raise AssertionError(f"mesh launches {launches['mesh']} are not "
                             f"those of its mesh runs, {rose}")
    seconds["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_geometry_mirror(dev)
    seconds["geometry_mirror"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_dryrun(info)
    seconds["dryrun"] = time.perf_counter() - t0
    emit({"phase": "seconds", "seconds": seconds,
          "total": time.perf_counter() - t_start})

    emit(kernels_line(rows, launches, expected, "kwt-1", 64))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
