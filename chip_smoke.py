#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

From the root of a checkout, on a machine with a CUDA device and ``nvcc``:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the six CUDA kernels from their ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints ``build_s``;
3. decode kernel phase: holds ``decode_gop_blocks`` against its plain
   PyTorch version on the card for F in {1, 4, 16}, M in {64, 4096,
   32768}, qp in {4, 8, 12} (max |diff| <= 1e-3 on pixel-scale output) and
   times both, with the bound F*M*384 B over the card's published HBM rate
   and the kernel's achieved GB/s beside its share of the bound;
4. encode kernel phase: holds ``dct_quant`` and ``idct_dequant`` against
   their plain versions, bit for bit, for N in {64, 4096, 32400, 131072},
   qp in {4, 8, 16}, intra and inter, on pixel-scale blocks and residuals
   from the seed; times both at qp 8, warm (back-to-back launches on the
   same input, as the ingest finds its input in L2) and L2-cold (a 64 MB
   write and a 64 MB read before each launch), against the bound N*384 B
   (``share_of_bound`` from the cold time), and each wrapper's host cost
   per call;
5. attention kernel phase: holds ``flash_attention`` against its plain
   version (atol 2e-5 in f32, 2e-2 in bf16) for (B, H, KV, S, D) in
   {(2,4,4,128,32), (2,4,2,256,64), (2,8,1,256,32), (8,9,3,512,64),
   (1,9,3,4096,64), (3,9,3,100,64), (1,9,3,1,64), (8,32,4,512,128),
   (2,8,8,256,128), (8,32,32,512,128)} and, at MLA's widths (q.k 192, v
   128), (B, H, KV, S) in {(8,16,16,512), (2,4,2,256), (3,16,16,100),
   (1,16,16,1)}, causal and not, bf16 and f32, on ``randn`` inputs from
   the seed, and at the internvl2-26b prefill shape (8,48,8,512,128)
   and the pipeline's (4,48,8,1032,128);
   keys of another length than the queries, not causal, (B, H, KV, S ->
   Skv, Dqk / Dv) in {(8,16,16, 512->128, 64), (2,4,2, 256->100, 64),
   (3,8,8, 100->37, 128), (2,4,4, 64->256, 32), (1,16,16, 128->512,
   192/128)}, bf16 and f32, and a causal call with two lengths refused
   before any launch; the (D, D) pairs' outputs on inputs from
   DIGEST_SEED must hash to the digests of the kernel before v's width
   became a parameter (``FLASH_OLD_DIGESTS``) and the (192, 128) pair's
   to those of the kernel before the keys' length became one
   (``FLASH_MLA_OLD_DIGESTS``): bit-identical; times it, the plain
   version and ``scaled_dot_product_attention`` (the library yardstick,
   which the port never calls) in bf16 at the smollm-135m prefill shape
   (8,9,3,512,64), at (1,9,3,4096,64), at the qwen3-moe-30b-a3b prefill
   shape (8,32,4,512,128), at the zamba2-1.2b prefill shape
   (8,32,32,512,128: MHA at D=128), at the deepseek-v2-lite-16b prefill
   shape (8,16,16,512, 192 / 128) and at the internvl2-26b one, causal,
   and at seamless-m4t-medium's cross-attention (512 queries over 128
   keys), which the JSON line reports, with the byte and operation
   bounds, and the wrapper's host cost per call;
6. sad kernel phase: holds ``sad_search`` against its plain version for
   (b, r) in {(8, 4), (16, 8), (8, 8), (4, 0), (8, 1), (8, 5), (16, 3),
   (5, 2)} (the motion shapes (8, 8) and (16, 8) take the kernel's
   fixed-shape path, the others its generic path, and r in {1, 3, 5}
   leaves a short strip) and N in {1, 7, 64, 500, 32400}: on integer
   pixels in [0, 255] (with a constant window) all
   three outputs equal, ties included; on ``randn * 25`` pixels ``sad``
   within rtol 1e-5 and ``dy``/``dx`` equal except at near-ties (counted);
   times it, the plain version and the wrapper's host cost at both motion
   path shapes against the bound (no single PyTorch call computes it);
7. motion path: frames 0 and 1 of the 1080p video (b=8, r=8: 32,400
   blocks) and a 720p pair (b=16, r=8: 3,600 blocks), each through
   ``frame_motion_blocks``, one pinned H2D copy, one ``sad_search_op``
   launch and one D2H copy, with host times; held against the plain
   version (exact on the frames rounded to 8 bits); then a 1080p frame
   rolled by (3, -2), whose inner blocks must match at (r-3, r+2) with SAD 0;
8. ingest phase: ``VideoStore.ingest`` of a 1080p, 64-frame synthetic video
   (gop 16, qp 8) under a 6x8 uniform layout (48 tiles; a frame is one
   32,400-block launch) encodes on the card; the encode launch counters
   must grow; SOT 0's stored coefficients are held against the numpy
   ``encode_tile`` (equal share >= 0.999, PSNR within 0.1 dB), and so are
   the other SOTs', both encode wall times printed, and one SOT's encode
   split by device time
   (``torch.profiler``: the two kernels, the other kernels' share, the
   copies) and the host time of the size model;
9. scan phase: a full-frame scan, a label (ROI) scan, ``execute_many`` of
   four overlapping scans and a ``serve()`` session of four requests on the
   ingested store; every region is held against the numpy ``decode_tile``
   oracle at atol=1e-3, rtol=1e-5, merged and served results must equal the
   serial ones bit for bit, and the decode launch counter must grow;
10. video server phase: the same store (tuning off, cache off) served
   in-process by ``VideoStoreServer`` on a Unix socket to 4 client threads,
   each with its own ``RemoteVideoStore`` sending 4 scans (full frames 0-16,
   ``car`` scans), once over the socket transport, where shared memory
   exists once over shm, and where msgpack is the default once more over
   the socket with JSON (one request a client); every reply bit-identical
   to the in-process scan (which is held against the oracle), the decode
   launch counter growing;
   p50/p95 latency, requests/s, reply bytes and the wire codec printed;
   then ``python -m repro_torch.tasm_serve --device cuda`` as a subprocess
   over a small store root answers ``ping``, ``config()`` (a cuda decode)
   and one scan, and exits 0 on ``shutdown_server()``;
11. cluster phase: three ``python -m repro_torch.tasm_serve --device
   cuda`` node processes (disk-backed, tuning and cache off) behind one
   ``python -m repro_torch.tasm_router --replication 2`` process (first
   checks that /dev/shm has twice the five servers' shm pools free);
   three 1080p, 16-frame cameras ingested through a ``ClusterClient``
   under the 6x8 layout, each onto 2 nodes; an in-process store on the
   card from the same frames and its numpy oracle; 4 client threads x 4
   routed scans (``car`` 0-16 of each camera, ``person`` 4-12, full frames
   0-16 of cam1), then the same requests straight to each camera's
   primary, p50/p95 and requests/s of both, with the card's
   ``utilization.gpu`` sampled through the ingest and the waves; a second
   routed wave during
   which cam0's primary is SIGKILLed (no read fails, ``node_health``
   reports it down, ``nvidia-smi`` drops its context within 30 s); a
   routed retile of cam0 SOT 0 to 2x2; a fresh node ``d`` joined and the
   lost node repaired through the router's CLI (``--join-node``,
   ``--repair node=... --wait 300``, both exit 0), each copy read straight
   from its new replica at the router's epochs; every live node's decode
   device ``cuda`` (through the router's ``config()``) and its pid holding
   a context in ``nvidia-smi``, the router's holding none; SIGTERM of the
   router and nodes (exit 0, sockets gone) and no shared-memory segment
   left behind.  Every reply is bit-identical to the in-process store and
   within atol=1e-3, rtol=1e-5 of the oracle;
12. retile phase, twice (inline tuning, then the background tuner with
   ``drain_tuner``): ``RegretPolicy`` with ``CostModel(beta=1.4e-8,
   gamma=1e-5)`` over repeated ``car`` scans of frames 0-32 of the same
   1080p video until a SOT's epoch rises; the encode launch counters must
   grow, and every region of a scan after the retile is held against the
   numpy oracle of the new tiles;
12b. tuner race phase, on the same 32 frames: one store on the card with
   the background tuner and the cache on (``RegretPolicy``,
   ``CostModel(beta=1.4e-8, gamma=1e-5)``) serves ``RACE_THREADS`` = 4
   client threads, each running the race mix of ``tests/test_tuner.py``
   (``car`` 0-32 x4, ``person`` 0-32 x4, ``car`` 0-32 x4) until a scan
   has seen a retile in flight (at most ``RACE_PASSES`` = 4 passes), and
   a ``serve()`` session of 8 ``car`` 0-32 submissions beside them, while
   the tuner thread retiles; every region bit for bit equal to an
   inline-tuned store on the card running the mix serially and within
   atol=1e-3, rtol=1e-5 of the numpy oracle, no query charged a retile,
   no thread raising or hanging, an epoch risen after ``drain_tuner``,
   and at least one scan that saw ``dct_quant``'s count grow between its
   call and its return (the store's scheduler lock serialises a batch's
   decode and a retile's re-encode, so they interleave on the card);
   scan p50/p95, the tuner's counts, the three video kernels' launches
   and the wall time printed;
13. calibration: ``calibrated_cost_model`` on the card at its small default
   sizes (10 timed repeats of each decode sample), with finite positive
   beta and encode_per_pixel and a finite, non-negative gamma;
13b. entry points phase: the ported examples' own functions in this
   process, on the card, with the counts set to 0 before each and read
   after: ``examples/quickstart_torch.py`` (the amber-alert flow with its
   manifest reopen, a socket server, a 3-node in-process cluster with a
   repair, shm), ``incremental_workload_torch.py`` (paper §5.3 W4 and the
   background tuner, 256 frames) and ``edge_tiling_torch.py`` must
   launch ``decode_gop_blocks``, ``dct_quant`` and ``idct_dequant`` and
   hold every contract they print; ``serve_lm_torch.py``,
   ``continuous_batching_torch.py`` and ``scripts/smoke_models_torch.py``
   (every architecture of ``ARCH_IDS`` at ``reduce_config`` size, heads
   widened to the kernel's) must launch ``flash_attention`` and give
   finite logits; their output is summarised; ``scripts/
   server_smoke_torch.py --transport shm --device cuda`` runs as a
   subprocess beside the train phase's launchers (22 (e)) and must exit
   0;
14. serve phase, ``smollm-135m`` at full width (30 layers, d_model 576,
   ``make_serve_config(cfg, 1)``, bf16 weights from the seed) on the card:
   (a) ``greedy_generate`` of 8 prompts of 512 tokens, 16 new tokens; the
   prefill launches ``flash_attention`` 30 times; TTFT of the prefill and
   steady decode tokens/s; (b) the same with the prefill attention
   switched to the plain version (a test-only patch of the attention
   module): last-position prefill logits within 5e-2, greedy-token
   agreement printed; (c) the same in f32 at 4 layers: logits within 1e-3,
   greedy agreement >= 0.99; (d) ``ContinuousBatcher(slots=8,
   max_len=640)`` over 16 requests of 64-512 prompt tokens and 8-16 new
   tokens: every request finishes, 30 launches per wave, stats printed;
   (e) the device time of one prefill and of one decode step, split by
   ``torch.profiler`` into ``flash_attention``, matmuls and the rest, and
   the device's busy share of their wall time; with (c), the f32 model on
   the int8 KV cache on the card and on the CPU (B=2): the first layer's
   codes equal but for at most ``INT8_FLIPS`` of them, one apart, a
   decode step from the same codes within 1e-3, greedy agreement >= 0.99
   over 16 tokens (``_int8_card_vs_cpu``);
15. MoE serve phase, ``qwen3-moe-30b-a3b`` at its published width and
   depth (48 layers, d_model 2048, 32/4 heads of 128, 128 experts top 8,
   capacity factor 1.25, vocab 151,936; ``make_serve_config(cfg, 1)``;
   30,532,122,624 parameters, equal to ``analytic_param_count``, 61 GB
   of bf16 weights drawn on the card from a CUDA generator seeded with
   the seed), with no earlier model resident (free card memory printed
   before the init, the init time after it): (a) ``greedy_generate`` of
   8 prompts of 512 tokens, 16 new; the prefill launches
   ``flash_attention`` 48 times; TTFT and decode tokens/s; (b) the same
   weights with the plain prefill attention: the last-position logits'
   largest gap and the greedy agreement; per layer, the share of the
   prefill's (token, slot) expert assignments whose expert the plain
   attention also picks for that token when both run that layer from the
   same input (teacher-forced: a test-only patch runs each layer twice),
   at least 0.99 in every layer, every logit finite; the same share over
   two free-running prefills, printed beside that of
   ``scaled_dot_product_attention`` against the plain version (a control:
   any two correct bf16 attentions part the routes of later layers,
   since a rounding difference that crosses a token's 8th/9th gate gap
   sends it to another expert and the difference grows from there); (d)
   ``ContinuousBatcher(slots=8, max_len=640)`` over 16 requests drawn as
   the serve phase draws them: every request finishes, 48 launches per
   wave; (e) one prefill's and one decode step's device time split by
   ``torch.profiler`` into ``flash_attention``, the expert GEMMs, the
   other matmuls, the dispatch and the rest, and the busy share of each;
   (c) once the bf16 model is freed, f32 at 4 layers, full width
   otherwise: logits within 1e-3 of the plain attention's, greedy
   agreement >= 0.99; the peak memory;
16. SSM and hybrid serve phase, once the MoE weights are freed:
   ``zamba2-1.2b`` (38 Mamba-2 layers, d_model 2048, a shared attention
   block after every 6th layer at twice d_model, 32 heads of 128 on 32
   KV heads; 1,279,529,856 parameters) and then ``falcon-mamba-7b`` (64
   Mamba-1 layers, d_model 4096, attention-free; 7,272,665,088), each at
   its published width and depth with ``make_serve_config(cfg, 1)`` and
   bf16 weights drawn on the card from a CUDA generator seeded with the
   seed, the card's free memory printed before each init: (a)
   ``greedy_generate`` of 8 prompts of 512 tokens, 16 new: TTFT, decode
   tokens/s, init time, peak memory; zamba2's prefill launches
   ``flash_attention`` 6 times, falcon's 0; (b) zamba2 only: the same
   weights with the plain prefill attention and with SDPA (a control):
   the last-position logits' gap and the greedy agreement printed; since
   SDPA's gap from the plain model passes 5e-2 (0.069), the kernel's gap
   is held to at most ``SDPA_FACTOR`` times SDPA's, and each site's
   attention output to within 2e-2 of the plain version on the same q,
   k, v (a test-only patch runs both at every site); (d)
   ``ContinuousBatcher(slots=8, max_len=640)`` over 16 requests drawn
   as the serve phase draws them, request 0 at 512 prompt
   tokens and repeated as the first request of the second wave: every
   request finishes, 6 (zamba2) or 0 launches per wave, the repeat gets
   its first-wave tokens (the batcher zeroes the SSM state at
   admission); (e) one prefill's and one decode step's device time split
   by ``torch.profiler`` into ``flash_attention``, the scan (the chunk
   loops of ``ssm._mamba1_scan`` / ``ssm._ssd_chunked``), the other
   matmuls and the rest, with the busy share; (c) f32 at 7 (zamba2: one
   shared-block site and a trailing layer) or 2 layers, full width
   otherwise, card against CPU on the same weights (B=2): prefill logits
   within 1e-3, greedy agreement >= 0.99 over 16 tokens, and a prefill of
   512 tokens (two 256-token chunks) and one decode step within 1e-3 of a
   prefill of 513 (one chunk); (f) ``python -m repro_torch.launch.serve
   --arch zamba2-1.2b --device cuda`` exits 0 (started as falcon's (c)
   starts, which leaves the card mostly idle, and waited for after it);
17. MLA serve phase, once the SSM weights are freed (free card memory
   printed before the init): ``deepseek-v2-lite-16b`` at its published
   width and depth (27 layers, the first dense at d_ff 10944, d_model
   2048, 16 heads, MLA latent rank 512 with q.k 128 + 64 and v 128, 64
   routed experts top 6 and 2 shared, vocab 102,400;
   ``make_serve_config(cfg, 1)``; 15,706,484,224 parameters, equal to
   ``analytic_param_count``, 31.4 GB of bf16 weights drawn on the card
   from a CUDA generator seeded with the seed): (a) ``greedy_generate``
   of 8 prompts of 512 tokens, 16 new; the prefill launches
   ``flash_attention`` 27 times at (8,16,16,512, 192 / 128); TTFT, decode
   tokens/s, init time; (b) the same weights with the plain prefill
   attention and with SDPA (a control): the last-position logits' gaps
   and the greedy agreement printed, each of the 27 sites' attention
   output within 2e-2 of the plain version on the same q, k, v, the
   teacher-forced share of each MoE layer's expert assignments at least
   0.99, every logit finite; (d) the bf16 model on the int8 latent cache:
   every logit finite, 27 launches, the agreement with the float cache
   printed; (e) ``ContinuousBatcher(slots=8, max_len=640)`` over 16
   requests drawn as the serve phase draws them: every request finishes,
   27 launches per wave; (f) one prefill's and one decode step's device
   time split by ``torch.profiler`` into ``flash_attention``, the expert
   GEMMs, the other matmuls, the dispatch and the rest, with the busy
   share, and the peak memory; (c) f32 at 2 layers (the dense layer and
   a MoE layer), full width otherwise, card against CPU on the same
   weights (B=2): prefill logits within 1e-3, greedy agreement >= 0.99
   over 16 tokens, and on each a prefill of 512 tokens and one absorbed
   decode step within 1e-3 of a prefill of 513 (at a capacity factor
   where no expert drops a token); the f32 model on the int8 cache, card
   against CPU, as the serve phase holds it; (g) ``python -m
   repro_torch.launch.serve --arch deepseek-v2-lite-16b --device cuda``
   exits 0, with and without ``--kv-quant`` (both beside (c));
18. encoder-decoder serve phase, once the MLA weights are freed:
   ``seamless-m4t-medium`` at its published width and depth (12 encoder
   and 12 decoder layers, d_model 1024, 16 heads of 64 on 16, d_ff 4096,
   LayerNorm, vocab 256,206; 977,821,696 parameters, equal to
   ``analytic_param_count``; bf16 weights drawn on the card): (a) a
   ``make_prefill_step`` prefill of 8 prompts of 512 tokens over frame
   embeddings [8, 128, 1024] from the seed (``input_specs``' S // 4): the
   encoder, then the decoder with its cross-attention, 36
   ``flash_attention`` launches (12 encoder self-attentions at (8,16,16,
   128,64) unmasked, 12 causal decoder self-attentions at (8,16,16,512,
   64), 12 cross-attentions of 512 queries over 128 keys); 63 decode
   steps through ``make_decode_step`` over ``enc_out``, then
   ``greedy_generate(enc_out=...)``: TTFT, decode tokens/s, init time;
   (b) the same weights with the plain prefill attention and with SDPA
   (a control): the last-position logits' gaps, and each of the 36
   sites' attention output within 2e-2 of the plain version on the same
   q, k, v, by kind; (d) ``ContinuousBatcher`` refuses the family, as
   the reference's passes no ``enc_out``; (e) one prefill's and one
   decode step's device time split by ``torch.profiler`` into
   ``flash_attention``, matmuls and the rest, with the busy share, and
   the peak memory; (c) f32 at 2 encoder and 2 decoder layers, full
   width otherwise, card against CPU on the same weights (B=2): prefill
   logits within 1e-3, ``greedy_generate(enc_out=...)`` agreement >= 0.99
   over 16 tokens, and on each a prefill of 512 tokens and one decode
   step within 1e-3 of a prefill of 513 over the same ``enc_out``;
19. VLM serve phase, once those weights are freed: ``internvl2-26b`` at
   its published width and depth (48 layers, d_model 6144, 48 heads of
   128 on 8, d_ff 16,384, vocab 92,553, the 3200 -> 6144 -> 6144 patch
   projector with the tanh GELU; 19,918,682,112 parameters, equal to
   ``analytic_param_count``; 39.8 GB of bf16 weights drawn on the card):
   (a) a ``make_prefill_step`` prefill of 8 x 128 patch embeddings of
   width 3,200 and 384 text tokens (``input_specs`` at S=512), 48
   ``flash_attention`` launches at (8,48,8,512,128), then 63 decode
   steps from index 512, then ``greedy_generate`` on the 384 text
   tokens: TTFT, decode tokens/s, init time; (b) the same
   weights with the plain prefill attention and with SDPA: the logits'
   gaps and the greedy agreement printed, each site's attention within
   2e-2 of the plain version on the same q, k, v; (d)
   ``ContinuousBatcher(slots=8, max_len=640)`` over 16 text requests
   drawn as the serve phase draws them: every request finishes, 48
   launches per wave, stats printed; (e) one patch prefill's and one
   decode step's device time by kind, the busy share and the peak
   memory; then the pipeline phase (20) on these weights; once they are
   freed, (c) f32 at 2 layers, full width otherwise, card against CPU
   (B=2): a patch prefill's logits within 1e-3, ``greedy_generate`` on
   text prompts with >= 0.99 of 16 tokens equal, on each that prefill
   one token short plus one decode step within 1e-3 of it, and the
   pipeline's logits of 1 of its first batch's crops within 1e-3; (f)
   ``python -m repro_torch.launch.serve --arch internvl2-26b --device
   cuda`` exits 0 (beside (c));
20. pipeline phase, the paper's Fig. 2 loop of
   ``examples/video_analytics_torch.py`` in this process with the
   full-width internvl2-26b backbone: the example's store on the card
   (its cost model calibrated there, ``sparse_spec(seed=4, n_frames=96)``
   ingested under ``RegretPolicy``), ``tasm_region_batches`` streaming 3
   batches of 4 crops of ``car`` and ``person`` regions (every scan's
   regions held against the numpy oracle at atol 1e-3, rtol 1e-5 after
   the background tuner drains), each batch scored by the example's
   ``score`` (1,024 patch tokens and 8 text tokens a crop, 48
   ``flash_attention`` launches, finite logits), then ``drain_tuner``;
   with the counts set to 0 just before the store is built and read after
   the drain, ``dct_quant``, ``idct_dequant``, ``decode_gop_blocks`` and
   ``flash_attention`` must all have launched; held against the plain
   versions: the first call of each ingest kernel, intra and N (equal
   outputs), and the first batch's crops scored again (after the counts
   are read), each of the 48 attention sites at (4,48,8,1032,128) within
   the larger of 2e-2 and one bf16 ulp; a score's device time by kind;
21. attention backward kernel phase: holds ``flash_attention_bwd`` (dq,
   dk, dv from the forward's o and row logsumexp) against its plain
   version, each element over its row's largest |gradient| (``BWD_TOL``:
   2e-4 in f32, 1e-2 in bf16), with o within FLASH_TOL, lse within
   LSE_ATOL and two calls the same bits, at the training shape (8, 9, 3,
   2048, 64) bf16 causal and at (2, 9, 3, 512, 64) f32, causal and not
   (bf16 runs on the tensor cores, f32 on the CUDA cores), and at the new
   cases in both dtypes: MLA's widths at deepseek-v2-lite-16b's prefill
   shape (8, 16, 16, 512, q.k 192 / v 128) causal, and
   seamless-m4t-medium's cross-attention (8, 16, 16, 512 queries over
   128 keys, 64) not causal; times it in bf16 at the three shapes beside
   the plain version and the backward of
   ``scaled_dot_product_attention`` (``enable_gqa``; the library
   yardstick, which the port never calls; null where it refuses a shape)
   and the bound (``flash_bwd_bound_ms``: the bytes of q, k, v, o, dO,
   lse, dq, dk, dv, against the five products over the live pairs); the
   old cases' gradients (Skv == S, Dv == Dqk, ``BWD_DIGEST_SHAPES``,
   causal and not, both dtypes) must hash to ``BWD_OLD_DIGESTS``, the
   bits of the kernel before the widths and the keys' length became
   parameters;
22. train phase, ``smollm-135m`` at its published width (30 layers,
   d_model 576, vocab 49,152), bf16 params with an f32 master copy, remat
   on: (a) ``TRAIN_STEPS`` steps of ``make_train_step`` at B=8, S=2048 on
   the structured synthetic stream, with the counts set to 0 just before
   and read just after: per step 60 ``flash_attention`` launches (the
   checkpointed forward runs twice) and 30 ``flash_attention_bwd``; the
   median step time, tokens/s, peak memory, every loss finite, the mean
   of the last 5 losses below the first; (b) one step's device time by
   ``torch.profiler`` (forward and backward attention, matmuls, the rest)
   and the busy share of its wall time; (c) an f32 step at 2 layers, full
   width, B=2, S=256 on the card and on the CPU from the same weights:
   loss within rtol 1e-5, every gradient within 1e-4 of its leaf's
   largest, and the params after the AdamW update from the same gradients
   within 1e-6 of their leaf's largest; (d) ``recoverable_train_loop``
   with checkpoints every 2 steps and a simulated fault at step 3,
   restored from the step-2 checkpoint bit for bit (``restarts == 1``);
   (e) ``python -m repro_torch.launch.train --device cuda`` for 3 steps
   with ``--checkpoint-dir``, then ``--resume`` to 5;
22b. family train phase, the six non-dense families (``FAMILY_ARCHS``):
   (a) one f32 step each at ``reduce_config`` width (2 layers, the
   hybrid's 4) with heads widened to the kernels' (64 for seamless, 128,
   MLA's 192 / 128), B=2, S=128 (the encoder-decoder's 32 frames, and
   again 37), card against CPU from the same weights: loss within rtol
   1e-5, every gradient within 1e-4 of its leaf's largest, the backward's
   launches equal to the model's attention sites (none for
   falcon-mamba-7b); (d) ``python -m repro_torch.launch.train --arch
   zamba2-1.2b --device cuda --steps 3 --batch 4 --seq 512`` at full
   width and depth, run beside the train phase's (c)-(e), exits 0 with a
   finite loss; (b) 3 bf16 steps
   each at full width (f32 master, remat, AdamW lr 1e-3, warmup 1),
   B=8, S=512 (falcon B=2; the encoder-decoder over [8, 128, 1024]
   frames, the VLM over 128 patch embeddings and 384 tokens),
   ``zamba2-1.2b`` and ``seamless-m4t-medium`` uncut, the other four at
   2 layers (``FAMILY_LAYERS``): every loss finite, every param moved and
   equal to the master rounded to bf16, the backward launched once per
   attention site each step (6 for zamba2, 36 for seamless), and in the
   first step each site's ``flash_attention_bwd`` held against its plain
   version on the same q, k, v, o, dO and lse, per row within
   ``BWD_TOL`` (bf16: 1e-2 of the row's largest |gradient|); the median
   step, tokens/s, peak memory (steps 2-3) and one step's device time by
   kind;
22c. dryrun phase, the port's analysis tools (``repro_torch.launch``):
   (a) ``python -m repro_torch.launch.dryrun --mesh single`` over every
   shape of one architecture of each family (smollm-135m the dense one;
   ``DRYRUN_GROUPS``), in processes started beside (b) with no card
   visible (falcon-mamba-7b's train_4k and prefill_32k walks are left
   out: ``DRYRUN_LEFT_OUT``; the CPU tests walk the whole table): every
   row ok or skipped, one line a
   cell (dominant term, compute_s, memory_s, total_device_bytes,
   fits_hbm), smollm-135m's prefill_32k ok and fitting the card, its
   decode_32k (a 96.6 GB KV cache) not; (b) that prefill_32k cell on the
   card at its production shape: full-width smollm-135m in bf16 drawn on
   the card, ``make_prefill_step`` on B=32 prompts of 32,768 tokens from
   the seed, one warm-up on one prompt, then ``DRYRUN_TIMED`` timed
   calls, the first with the counts set to 0 just before and read just
   after (30 ``flash_attention`` launches at (32, 9, 3, 32,768, 64)):
   the median wall, the peak
   memory beside the row's ``total_device_bytes``, the roofline share of
   the row's dominant term (at most 1.0, against the card's name and
   power limit), finite last logits, layer 0's attention held against
   the plain version on its own q, k, v (batch rows 0 and 31, the first
   and the last 256 query rows over all keys, each element within 2e-2
   of its row's largest |plain| value), and the kernel at that shape
   timed beside SDPA
   (``enable_gqa``) and its bound; (c) train (a)'s median step against
   the port's FLOP count of that step (``count_flops`` on ``meta``) and
   6·N·D, each as a share of the card's bf16 peak;
22d. distributed phase (``distributed/``, one rank of NCCL on the one
   card, a 1x1 mesh), its collectives in a process of its own
   (``--distributed-worker``, so no NCCL state reaches the other phases):
   (a) ``ring_step`` driven over 4 blocks of a sequence on one device at
   smollm-135m's widths (B=2, S=4096, KV=3, G=3, D=64), f32 and bf16,
   causal and not, each block through the ``flash_attention`` kernel with
   its row logsumexp, and the real ``ring_attention`` on the 1x1 mesh,
   against the plain ``ring_attention_ref`` (f32 within 3e-5, bf16 each
   row within 2e-2 of its largest |plain| value), with the counts set to
   0 just before and read just after (10 launches a causal drive, 16 a
   full one, 1 each ``ring_attention``: 56), the bf16 causal drive timed
   beside the plain ring; (b) smollm-135m at full width, bf16, B=8,
   S=512: ``choose_policy`` picks ``dp_train``, and step 1's loss and
   every gradient leaf of the sharded model equal the unsharded model's
   bit for bit, then 3 steps of each, the same losses, the median steps
   side by side; (c) ``launch.serve``'s weights and prompts (B=8, 512
   tokens, 16 new) unsharded and sharded with the cache placed by
   sequence: the same tokens, prefill and decode times side by side; (d)
   one ``compressed_psum`` and one checkpoint save / restore of a DTensor
   on the NCCL group; beside it, (e) ``python -m repro_torch.launch.train
   --arch smollm-135m --mesh 1,1`` at B=8, S=512 for 3 steps (policy
   ``dp_train``) and (f) ``python -m repro_torch.launch.serve --mesh 1,1
   --kv-shard seq`` at B=8, 512-token prompts, 16 new tokens, whose
   tokens' digest must be (c)'s; the three processes run beside train
   (e)'s ``--resume`` launcher, and the phase checks what they printed;
23. prints the times of the kernels redesigned for this card (all six:
   ``sad_search`` at both motion shapes) beside the times recorded before
   the redesign (``BEFORE_REDESIGN``, from PERF.md),
   one JSON line with the kernels' numbers (each kernel's launches on its
   latest path: ``flash_attention`` on seamless-m4t-medium's prefill,
   timed at its cross-attention shape, with the internvl2-26b prefill's,
   the pipeline's, the earlier prefills' and the LM entry points'
   launches beside it in ``launches_by_path`` (the dryrun phase's 32k
   prefill's and the distributed phase's ring's among them), and the
   pipeline's, the
   tuner race's and the video entry points' ``dct_quant``,
   ``idct_dequant`` and ``decode_gop_blocks`` launches beside theirs,
   and ``flash_attention_bwd``'s by training path: smollm-135m's and
   each family's of 22b (b)),
   then as its last line ``{"ok": true, "device": {...}}``.

f32 products on the card stay f32 (``allow_tf32`` is set False for
matmuls and cuDNN) in every comparison.

Every path is driven with the launch counters set to 0 just before it and
read just after.  Any failed check raises, and the script exits non-zero
without the last line; so it does without a CUDA device, or outside a
checkout.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import functools
import hashlib
import json
import pathlib
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the card's published peaks (H100 SXM data sheet, repro_torch's
#: launch/mesh.py): HBM3 bytes/s, f32 and bf16 FLOP/s
from repro_torch.launch.mesh import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                     PEAK_FLOPS_BF16 as BF16_FLOPS,
                                     PEAK_FLOPS_FP32 as FP32_FLOPS)

#: fp32 adds the card issues per second: half the FLOP/s peak, which counts
#: an FMA as two operations
FP32_ADDS = FP32_FLOPS / 2
#: per 8x8 block-frame of the decode: int16 in + f32 out; 64 pixels x
#: (16 FMAs + dequant multiply + running-sum add)
BYTES_PER_BLOCK_FRAME = 64 * 2 + 64 * 4
FLOPS_PER_BLOCK_FRAME = 64 * (2 * 16 + 2)
#: per 8x8 block of dct_quant / idct_dequant: f32 and int16 once each; 64
#: coefficients x (two 8-point products of 8 multiplies and 7 adds, plus
#: the divide or the dequant multiply)
BYTES_PER_BLOCK = 64 * 4 + 64 * 2
FLOPS_PER_BLOCK = 64 * (2 * 15 + 1)
#: tolerances of the attention kernel against its plain version (the
#: reference's, tests/test_kernels.py), and of the serve comparisons
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGITS_ATOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
AGREE_F32 = 0.99
#: GPU cycles the timing spin holds the stream for (~30 ms at 1.98 GHz):
#: longer than the host takes to enqueue 50 launches of any wrapper here
SPIN_CYCLES = 60_000_000
#: bytes written, then read from a second buffer, before each launch of an
#: L2-cold timing: past the card's 50 MB L2, so a launch finds neither its
#: input nor its output there, and the lines it evicts are clean
FLUSH_BYTES = 64 << 20
ATOL, RTOL = 1e-3, 1e-5
SHARE = 0.999
PSNR_DB = 0.1

#: the main path's configuration
DEVICE = "cuda"
H, W, N_FRAMES = 1080, 1920, 64
GOP, QP = 16, 8
LAYOUT = (6, 8)
RETILE_FRAMES = 32
#: the tuner race (tests/_torch_race.py): client threads, each running
#: the race mix of tests/test_tuner.py (car x4, person x4, car x4 over the
#: retile frames) until a scan has seen a retile in flight, at most
#: RACE_PASSES times, beside a serve() session of 8 car scans (2 passes
#: once saw no retile in flight where the tuner lagged the scans; a pass
#: past the first runs only then)
RACE_THREADS, RACE_PASSES = 4, 4
#: the serve path's configuration
ARCH = "smollm-135m"
#: the train path: B x S at SmolLM-135M's context length, steps, the
#: backward kernel's training shape and an f32 shape, and the f32
#: card-against-CPU step (layers, B, S)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 20
BWD_MAIN = (8, 9, 3, 2048, 64)
BWD_F32 = (2, 9, 3, 512, 64)
#: the backward kernel (fed the forward kernel's o and lse) against the
#: plain gradient from the plain o and lse, each element over its row's
#: largest |gradient| (at least 1e-2 of the largest of the call, since
#: dq's causal row 0 and dq, dk at S = 1 are 0 up to rounding): bf16 one
#: ulp of the row's largest (2^-7) and some f32 noise, f32 sums in another
#: order; the phase prints its readings
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
BWD_FLOOR = 1e-2
#: the row logsumexp against the plain one: about ten f32 ulps at the
#: |lse| ~ 10 of these shapes
LSE_ATOL = 1e-5
TRAIN_F32 = (2, 2, 256)
#: the backward's new cases at the serving phases' prefill shapes, (B, H,
#: KV, S, Skv, Dqk, Dv): deepseek-v2-lite-16b's MLA (causal) and
#: seamless-m4t-medium's cross-attention (not causal)
BWD_MLA = (8, 16, 16, 512, 512, 192, 128)
BWD_CROSS = (8, 16, 16, 512, 128, 64, 64)
#: the backward's old cases (Skv == S, Dv == Dqk; (B, H, KV, S, D) at D
#: 32, 64 and 128, G >= 1, ragged S), causal and not, from ``randn``
#: inputs of DIGEST_SEED (``bwd_digests``): sha256 by dtype of the
#: kernel before v's width and the keys' length became parameters (its
#: source built beside the current one by ``scripts/torch_kernel_probe.py
#: --bwd-only --baseline`` on an NVIDIA H100 80GB HBM3 at 700.00 W); the
#: current kernel must give these bits
BWD_DIGEST_SHAPES = [(2, 4, 4, 128, 32), (2, 6, 2, 100, 64),
                     (1, 9, 3, 257, 64), (2, 4, 2, 65, 128),
                     (1, 3, 1, 1, 64)]
BWD_OLD_DIGESTS = {"bfloat16": "202818c62120c17d1623a0ad0494e8fe",
                   "float32": "225d34293afee3a84968b381d8180c85"}
GRAD_RTOL = 1e-4
SERVE_B, SERVE_S, SERVE_NEW = 8, 512, 64
#: new tokens of the earlier serve paths (smollm-135m, MoE, SSM, MLA):
#: cut from SERVE_NEW (to 32, then to 16) to hold the smoke within its
#: time limit: with the dryrun phase cut to what its checks need (its (b)
#: two timed 9.3 s prefills of the 32k cell after a one-prompt warm-up,
#: its (a) hidden behind them) the smoke took 703 s on an H100 at 32;
#: the encoder-decoder and VLM paths decode SERVE_NEW
EARLY_NEW = 16
F32_LAYERS = 4
FLASH_SHAPES = [(2, 4, 4, 128, 32), (2, 4, 2, 256, 64), (2, 8, 1, 256, 32),
                (8, 9, 3, 512, 64), (1, 9, 3, 4096, 64), (3, 9, 3, 100, 64),
                (1, 9, 3, 1, 64), (8, 32, 4, 512, 128), (2, 8, 8, 256, 128),
                (8, 32, 32, 512, 128)]
#: the batchers' requests: new tokens cut from 16-64 to 8-32, then to
#: 8-16 when the family train phase came, to hold the smoke within its
#: time limit
BATCH_SLOTS, BATCH_MAX_LEN, BATCH_REQUESTS = 8, 640, 16
BATCH_PROMPT, BATCH_NEW = (64, 512), (8, 16)
FLASH_MAIN = (8, 9, 3, 512, 64)
FLASH_LONG = (1, 9, 3, 4096, 64)
#: the (D, D) pairs' outputs over FLASH_SHAPES, causal and not, from
#: ``randn`` inputs of DIGEST_SEED (``flash_digests``): sha256 by dtype of
#: the kernel before v's width became a parameter (its
#: ``csrc/flash_attention.cu`` built beside the current one by
#: ``scripts/torch_kernel_probe.py --flash-only --baseline`` on an NVIDIA
#: H100 80GB HBM3 at 700.00 W); the current kernel must give these bits
DIGEST_SEED = 1234
FLASH_OLD_DIGESTS = {"bfloat16": "35e53691261118712e828ecf4cdd1d04",
                     "float32": "e840524597c7c53ba4ac1e369c4d91eb"}
#: the MoE serve path: qwen3-moe-30b-a3b at its published width and depth
#: (48 layers, d_model 2048, 32/4 heads of 128, 128 experts, top 8), its
#: prefill's attention shape, and the share of (token, slot) expert
#: assignments of each layer that must agree between the kernel's and
#: the plain attention's prefill in bf16
MOE_ARCH = "qwen3-moe-30b-a3b"
FLASH_MOE = (SERVE_B, 32, 4, SERVE_S, 128)
AGREE_ROUTING = 0.99
#: the SSM and hybrid serve paths at their published width and depth:
#: zamba2-1.2b (38 Mamba-2 layers, and a shared attention block after
#: every 6th at twice d_model, 32 heads of 128 on 32 KV heads) and
#: falcon-mamba-7b (64 Mamba-1 layers, no attention), with their
#: parameter counts and depths; zamba2's prefill attention shape; the f32
#: card-against-CPU check's depths (zamba2's 7 layers hold one
#: shared-block site and a trailing layer, where 4 would hold no site;
#: falcon-mamba-7b's 2 hold the scan across a layer boundary),
#: batch and new tokens (the CPU side's time)
SSM_ARCHS = ("zamba2-1.2b", "falcon-mamba-7b")
SSM_PUBLISHED = {"zamba2-1.2b": (1_279_529_856, 38),
                 "falcon-mamba-7b": (7_272_665_088, 64)}
FLASH_HYBRID = (SERVE_B, 32, 32, SERVE_S, 128)
#: the MLA serve path: deepseek-v2-lite-16b at its published width and
#: depth (27 layers, the first dense at d_ff 10944, d_model 2048, 16
#: heads; MLA latent rank 512, q.k 128 + 64, v 128, q_lora_rank 0; 64
#: routed experts top 6 and 2 shared; vocab 102,400), its parameter count
#: and depth; its prefill's attention shape (B, H, KV, S, Dqk, Dv) and the
#: kernel phase's shapes at its widths
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_PUBLISHED = (15_706_484_224, 27)
FLASH_MLA = (SERVE_B, 16, 16, SERVE_S, 192, 128)
#: the f32 card-against-CPU check's depth: the dense layer and one MoE
#: layer (cut from 4 to hold the smoke within its time limit)
MLA_F32_LAYERS = 2
FLASH_MLA_SHAPES = [FLASH_MLA, (2, 4, 2, 256, 192, 128),
                    (3, 16, 16, 100, 192, 128), (1, 16, 16, 1, 192, 128)]
#: the (192, 128) pair's outputs over FLASH_MLA_SHAPES, as
#: FLASH_OLD_DIGESTS: sha256 by dtype of the kernel before the keys'
#: length became a parameter (its source built beside the current one by
#: ``scripts/torch_kernel_probe.py --flash-only --baseline`` on an NVIDIA
#: H100 80GB HBM3 at 700.00 W); the current kernel must give these bits
FLASH_MLA_OLD_DIGESTS = {"bfloat16": "084fb8a8ecf318668cc893180650ecab",
                         "float32": "6e967481e1afc94d933dc188a35689ff"}
#: keys of another length than the queries (not causal), (B, H, KV, S,
#: Skv, Dqk, Dv): seamless-m4t-medium's cross-attention (512 decoder
#: queries over 128 encoder frames, 16/16 heads of 64), keys longer than
#: queries, a ragged last key tile, G > 1, and every pair of PAIRS
FLASH_CROSS = (SERVE_B, 16, 16, SERVE_S, SERVE_S // 4, 64, 64)
FLASH_CROSS_SHAPES = [FLASH_CROSS, (2, 4, 2, 256, 100, 64, 64),
                      (3, 8, 8, 100, 37, 128, 128),
                      (2, 4, 4, 64, 256, 32, 32),
                      (1, 16, 16, 128, 512, 192, 128)]
#: internvl2-26b's prefill attention (48 heads on 8 KV heads of 128)
FLASH_VLM = (SERVE_B, 48, 8, SERVE_S, 128)
#: the encoder-decoder serve path: seamless-m4t-medium at its published
#: width and depth (12 encoder and 12 decoder layers, d_model 1024, 16
#: heads of 64 on 16, d_ff 4096, LayerNorm, vocab 256,206), its parameter
#: count and depths, and the f32 card-against-CPU check's depths (encoder
#: and decoder); frames [B, S // 4, d_model], as ``input_specs`` makes
#: them for S = SERVE_S
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_PUBLISHED = (977_821_696, 12, 12)
ENCDEC_F32_LAYERS = 2
#: the VLM serve path: internvl2-26b at its published width and depth (48
#: layers, d_model 6144, 48 heads of 128 on 8, d_ff 16,384, vocab 92,553,
#: the 3200 -> 6144 -> 6144 patch projector), its parameter count and
#: depth, and the f32 card-against-CPU check's depth (2 layers, cut from
#: 4 to hold the smoke within its time limit: their f32 weights with the
#: f32 embedding and lm_head are 7.7 GB, on the card and again on the
#: host); a prefill takes ``input_specs``' S // 4 = 128 patch
#: embeddings of width 3,200 and 384 text tokens
VLM_ARCH = "internvl2-26b"
VLM_PUBLISHED = (19_918_682_112, 48)
VLM_F32_LAYERS = 2
#: the paper's pipeline (``examples/video_analytics_torch.py``) at full
#: width: batches of crops (each crop a prefill of the backbone's 1,024
#: patch tokens and PIPE_TEXT text tokens), and the crops of the first
#: batch the f32 model holds card against CPU
PIPE_BATCHES, PIPE_CROPS, PIPE_TEXT, PIPE_F32_CROPS = 3, 4, 8, 1
#: the pipeline's prefill attention: 1,024 patch tokens and PIPE_TEXT text
#: tokens a crop, a ragged last query and key tile
FLASH_PIPE = (PIPE_CROPS, 48, 8, 1024 + PIPE_TEXT, 128)
SSM_F32_LAYERS = {"zamba2-1.2b": 7, "falcon-mamba-7b": 2}
SSM_F32_B, SSM_F32_NEW = 2, 16
#: the family training phase: the six non-dense families in the order
#: they run; (a) f32 card against CPU at B x S, and the encoder-decoder
#: again over a ragged frame count; (b) bf16 at full width, B x S (falcon
#: at B=2: its scan's four [B, S, 8192, 16] f32 tensors), steps, and the
#: depths one card holds at 14 bytes a parameter (zamba2-1.2b and
#: seamless-m4t-medium uncut: 38 layers, 12 + 12; deepseek's 2 are its
#: dense layer and one MoE layer); (d) the train launcher's family
FAMILY_ARCHS = (MOE_ARCH, "falcon-mamba-7b", "zamba2-1.2b", MLA_ARCH,
                ENCDEC_ARCH, VLM_ARCH)
FAMILY_F32_B, FAMILY_F32_S, FAMILY_F32_RAGGED = 2, 128, 37
FAMILY_B, FAMILY_S, FAMILY_STEPS = 8, 512, 3
FAMILY_BATCH = {"falcon-mamba-7b": 2}
FAMILY_LAYERS = {MOE_ARCH: 2, "falcon-mamba-7b": 2, MLA_ARCH: 2, VLM_ARCH: 2}
FAMILY_LAUNCH_ARCH = "zamba2-1.2b"
#: the share of the first layer's int8 KV-cache codes that may differ (by
#: one) between the card and the CPU from the same input: where x / scale
#: lies within their f32 error of .5 (about 1e-4 in code units)
INT8_FLIPS = 1e-3
#: zamba2's bf16 prefill logits: the plain attention's model and SDPA's
#: are 0.069 apart at the last position (PERF.md section 6), past
#: the dense model's 5e-2, so the kernel's gap is held to at most this
#: many times SDPA's (or 5e-2), beside each site's attention output
#: against the plain version on the same q, k, v within FLASH_TOL
SDPA_FACTOR = 2.0
#: the motion search: the sweep of the sad kernel phase, and the two frame
#: pairs of the motion path, (height, width, b, r); the first is the main
#: path's shape (1080 is not a multiple of 16, so it takes b=8)
SAD_SWEEP_BR = [(8, 4), (16, 8), (8, 8), (4, 0), (8, 1), (8, 5), (16, 3),
                (5, 2)]
SAD_SWEEP_N = [1, 7, 64, 500, 32400]
SAD_TOL = 1e-5
MOTION_PAIRS = [(H, W, 8, 8), (720, 1280, 16, 8)]
PLANT = (3, -2)
#: the video server phase: client threads, requests per client, queries;
#: the extra JSON-codec pass (where msgpack is the default) sends one
#: query a client, client k the k-th, so each query goes at least once
#: (its 1080p replies take about 4 s each)
SERVER_CLIENTS, SERVER_REQUESTS = 4, 4
SERVER_QUERIES = [("frame", (0, 16)), ("car", (0, 64)), ("car", (16, 48))]
SERVER_REQUESTS_JSON = 1
CLI_SPEC = (192, 320, 32)
#: the cluster phase: 1080p cameras of CLUSTER_FRAMES frames each (one
#: GOP: a 133 MB f32 ingest; nodes, router and clients take
#: CLUSTER_FRAME_MB, past the default 256 MiB frame cap), and the
#: retile's layout
CLUSTER_CAMS, CLUSTER_FRAMES, CLUSTER_FRAME_MB = 3, 16, 1024
CLUSTER_RETILE = (2, 2)

#: device ms of the redesigned kernels before their redesign, at the main
#: path's shapes (PERF.md section 6: chip_smoke.py on an NVIDIA H100 80GB
#: HBM3 at 700.00 W, with the first version of each kernel), printed
#: beside this run's
BEFORE_REDESIGN = {
    "decode_gop_blocks F=16 M=32768": 0.158934,
    f"flash_attention {FLASH_MAIN} bf16 causal": 0.221118,
    f"flash_attention {FLASH_LONG} bf16 causal": 1.557814,
    f"dct_quant N={H * W // 64} inter": 0.025238,
    f"idct_dequant N={H * W // 64} inter": 0.025610,
    "sad_search N=32400 b=8 r=8": 0.223352,
    "sad_search N=3600 b=16 r=8": 0.092842,
    f"flash_attention_bwd {BWD_MAIN} bf16 causal": 5.750445,
}

KERNELS = {
    "decode_gop_blocks": dict(
        source="src/repro_torch/kernels/decode/csrc/decode_gop_blocks.cu",
        replaces="src/repro/kernels/decode/decode.py:46"),
    "dct_quant": dict(
        source="src/repro_torch/kernels/dct/csrc/dct_quant.cu",
        replaces="src/repro/kernels/dct/dct.py:32"),
    "idct_dequant": dict(
        source="src/repro_torch/kernels/idct/csrc/idct_dequant.cu",
        replaces="src/repro/kernels/idct/idct.py:30"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:63"),
    "sad_search": dict(
        source="src/repro_torch/kernels/sad/csrc/sad_search.cu",
        replaces="src/repro/kernels/sad/sad.py:41"),
    # no Pallas kernel: the gradient the reference takes by autodiff of
    # its chunked jnp attention
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:87"),
}


def counters() -> dict:
    from repro_torch.kernels import dct, decode, flash_attention, idct, sad

    return {"decode_gop_blocks": decode.LAUNCHES, "dct_quant": dct.LAUNCHES,
            "idct_dequant": idct.LAUNCHES,
            "flash_attention": flash_attention.LAUNCHES,
            "sad_search": sad.LAUNCHES,
            "flash_attention_bwd": flash_attention.BWD_LAUNCHES}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.count for name, c in counters().items()}


def bound_ms(n: int, bytes_per: int, flops_per: int) -> tuple[float, str]:
    t_bytes = n * bytes_per / HBM_BYTES_PER_S
    t_ops = n * flops_per / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs.  A
    spin kernel holds the stream while the host enqueues every run, so the
    events time the device's work, not the wrappers' host cost between
    launches (that is :func:`host_us`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with the L2 cache evicted before each run
    (``FLUSH_BYTES`` written, then as many read from another buffer), each
    run timed by its own pair of events while a spin kernel holds the
    stream, as in :func:`cuda_ms`."""
    dirty = torch.empty(FLUSH_BYTES // 4, device=DEVICE)
    clean = torch.ones(FLUSH_BYTES // 4, device=DEVICE)
    sink = torch.empty((), device=DEVICE)

    def flush():
        dirty.fill_(1.0)
        torch.sum(clean, dim=0, out=sink)

    # first calls load their kernels, which would stall the enqueue below
    flush()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of ``fn`` while the device keeps up: the
    wrapper's own cost (checks, allocation, ``ctypes`` call, launch)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def random_stream(rng, n_frames: int, m: int, qp: int) -> np.ndarray:
    """Coefficients with the statistics of encoded video: a keyframe row
    whose DC lands in [0, 255] pixels plus small AC terms, then sparse
    small residuals."""
    q = np.zeros((n_frames, m, 8, 8), dtype=np.int16)
    dc_max = int(255 * 8 / (16 * max(qp, 1) / 16.0))
    q[0, :, 0, 0] = rng.integers(0, dc_max + 1, size=m)
    q[0] += rng.integers(-3, 4, size=(m, 8, 8)).astype(np.int16)
    if n_frames > 1:
        resid = rng.integers(-2, 3, size=(n_frames - 1, m, 8, 8))
        resid[rng.random(resid.shape) < 0.7] = 0
        q[1:] = resid
    return q


def pixel_blocks(rng, n: int, residual: bool) -> np.ndarray:
    """Pixel-scale blocks in [0, 255] (keyframes) or residuals (centred,
    with the spread of P-frame differences)."""
    if residual:
        return (rng.standard_normal((n, 8, 8)) * 12).astype(np.float32)
    return (rng.random((n, 8, 8)) * 255).astype(np.float32)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def build_all() -> float:
    """Build the six kernels, one ``nvcc`` per source, all at once."""
    from repro_torch.kernels.dct import LIBRARY as DCT
    from repro_torch.kernels.decode.build import LIBRARY as DECODE
    from repro_torch.kernels.flash_attention import BWD_LIBRARY as BWD
    from repro_torch.kernels.flash_attention import LIBRARY as FLASH
    from repro_torch.kernels.idct import LIBRARY as IDCT
    from repro_torch.kernels.sad import LIBRARY as SAD

    libs = (FLASH, BWD, DECODE, DCT, IDCT, SAD)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    return time.perf_counter() - t0


# ------------------------------------------------------------ kernel phases
def decode_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.decode import decode_fused_ref, decode_gop_blocks

    rng = np.random.default_rng(seed)
    worst = 0.0
    at_main = None
    for n_frames in (1, 4, 16):
        for m in (64, 4096, 32768):
            for qp in (4, 8, 12):
                q = torch.from_numpy(random_stream(rng, n_frames, m, qp))
                q = q.to(DEVICE)
                got = decode_gop_blocks(q, qp)
                want = decode_fused_ref(q, qp)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(err <= ATOL, f"kernel vs plain F={n_frames} M={m} "
                                   f"qp={qp}: max |diff| {err} > {ATOL}")
                worst = max(worst, err)
                if qp != 8:
                    continue
                k_ms = cuda_ms(lambda: decode_gop_blocks(q, qp), iters=50)
                r_ms = cuda_ms(lambda: decode_fused_ref(q, qp), iters=3,
                               warmup=1)
                b_ms, b_by = bound_ms(n_frames * m, BYTES_PER_BLOCK_FRAME,
                                      FLOPS_PER_BLOCK_FRAME)
                gb_s = n_frames * m * BYTES_PER_BLOCK_FRAME / k_ms / 1e6
                print(f"decode F={n_frames:2d} M={m:5d} qp={qp}: "
                      f"kernel_ms={k_ms:.6f} ref_ms={r_ms:.6f} "
                      f"bound_ms={b_ms:.6f} ({b_by}) achieved_GB_s="
                      f"{gb_s:.1f} share_of_bound={b_ms / k_ms:.3f} "
                      f"max_abs_err={err:.3g}", flush=True)
                if (n_frames, m) == (16, 32768):
                    at_main = dict(ms=k_ms, plain_ms=r_ms, bound_ms=b_ms,
                                   bound_by=b_by)
                    host_in = torch.empty(q.shape, dtype=q.dtype,
                                          pin_memory=True)
                    host_out = torch.empty(got.shape, dtype=got.dtype,
                                           pin_memory=True)
                    h2d = cuda_ms(lambda: q.copy_(host_in, non_blocking=True),
                                  iters=10)
                    d2h = cuda_ms(lambda: host_out.copy_(got,
                                                         non_blocking=True),
                                  iters=10)
                    print(f"copies F=16 M=32768 (pinned): h2d_ms={h2d:.6f} "
                          f"({q.numel() * 2} B) d2h_ms={d2h:.6f} "
                          f"({got.numel() * 4} B)", flush=True)
    small = torch.from_numpy(random_stream(rng, 1, 64, 8)).to(DEVICE)
    at_main["host_us"] = host_us(lambda: decode_gop_blocks(small, 8))
    at_main["max_abs_err"] = worst
    print(f"decode wrapper host cost: {at_main['host_us']:.3f} us/call",
          flush=True)
    return at_main


def encode_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.dct import dct_quant, dct_quant_ref
    from repro_torch.kernels.idct import idct_dequant, idct_dequant_ref

    rng = np.random.default_rng(seed + 1)
    worst = {"dct_quant": 0.0, "idct_dequant": 0.0}
    at_main = {}
    for n in (64, 4096, 32400, 131072):
        for qp in (4, 8, 16):
            for intra in (True, False):
                x = torch.from_numpy(pixel_blocks(rng, n, not intra))
                x = x.to(DEVICE)
                q = dct_quant(x, qp, intra)
                q_ref = dct_quant_ref(x, qp, intra)
                y = idct_dequant(q, qp, intra)
                y_ref = idct_dequant_ref(q, qp, intra)
                torch.cuda.synchronize()
                # both kernels round as their plain versions do, so the
                # outputs are equal, not close
                diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
                d_max = int(diff.max())
                check(torch.equal(q, q_ref),
                      f"dct_quant vs plain N={n} qp={qp} intra={intra}: "
                      f"{int((diff != 0).sum())} outputs differ, max |diff| "
                      f"{d_max}")
                err = (y - y_ref).abs()
                check(torch.equal(y, y_ref),
                      f"idct_dequant vs plain N={n} qp={qp} intra={intra}: "
                      f"max |diff| {float(err.max())}")
                worst["dct_quant"] = max(worst["dct_quant"], d_max)
                worst["idct_dequant"] = max(worst["idct_dequant"],
                                            float(err.max()))
                if qp != QP:
                    continue
                b_ms, b_by = bound_ms(n, BYTES_PER_BLOCK, FLOPS_PER_BLOCK)
                for name, kern, plain, arg in (
                        ("dct_quant", dct_quant, dct_quant_ref, x),
                        ("idct_dequant", idct_dequant, idct_dequant_ref, q)):
                    k_ms = cuda_ms(lambda: kern(arg, qp, intra), iters=50)
                    c_ms = cold_ms(lambda: kern(arg, qp, intra), iters=50)
                    r_ms = cuda_ms(lambda: plain(arg, qp, intra), iters=3,
                                   warmup=1)
                    print(f"{name} N={n:6d} qp={qp} intra={intra!s:5}: "
                          f"kernel_ms={k_ms:.6f} cold_ms={c_ms:.6f} "
                          f"ref_ms={r_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
                          f"share_of_bound={b_ms / c_ms:.3f} (cold) "
                          f"achieved_GB_s="
                          f"{n * BYTES_PER_BLOCK / c_ms / 1e6:.1f} (cold)",
                          flush=True)
                    # the main path's launches are mostly P-frames (inter)
                    if n == H * W // 64 and not intra:
                        at_main[name] = dict(ms=k_ms, plain_ms=r_ms,
                                             bound_ms=b_ms, bound_by=b_by)
    x = torch.from_numpy(pixel_blocks(rng, 64, True)).to(DEVICE)
    q = dct_quant(x, QP, False)
    at_main["dct_quant"]["host_us"] = host_us(
        lambda: dct_quant(x, QP, False))
    at_main["idct_dequant"]["host_us"] = host_us(
        lambda: idct_dequant(q, QP, False))
    for name in at_main:
        at_main[name]["max_abs_err"] = worst[name]
        print(f"{name} wrapper host cost: {at_main[name]['host_us']:.3f} "
              f"us/call", flush=True)
    return at_main


# -------------------------------------------------------------- path phases
def _assemble(tiles, rects, shape) -> np.ndarray:
    out = np.zeros(shape, dtype=np.float32)
    for (y1, x1, y2, x2), px in zip(rects, tiles):
        out[:, y1:y2, x1:x2] = px
    return out


def _encode_split(sot, rects, cfg) -> dict:
    """Device time of one SOT's encode, by kind, from the profiler (None
    where it recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.codec.encode import encode_tiles

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode_tiles(sot, rects, cfg, device=DEVICE)
        torch.cuda.synchronize()
    split = {"dct_quant_ms": 0.0, "idct_dequant_ms": 0.0,
             "other_kernels_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.device_time_total / 1e3
        if "idct_dequant" in evt.key:
            split["idct_dequant_ms"] += ms
        elif "dct_quant" in evt.key:
            split["dct_quant_ms"] += ms
        elif "HtoD" in evt.key:
            split["h2d_ms"] += ms
        elif "DtoH" in evt.key:
            split["d2h_ms"] += ms
        else:
            split["other_kernels_ms"] += ms
    if split["dct_quant_ms"] == 0.0:
        return {k: None for k in split}
    return split


def ingest_phase(frames, dets) -> tuple:
    """(store, ingest launches): the 1080p ingest on the card, every SOT
    against the numpy encoder, and one SOT's encode split."""
    from repro_torch.codec.bitstream import stream_bytes_np
    from repro_torch.codec.encode import (EncoderConfig, decode_tile,
                                          encode_tile, encode_tiles)
    from repro_torch.codec.psnr import psnr
    from repro_torch.core import (CacheConfig, DecodeConfig, TuningConfig,
                                  VideoStore, uniform_layout)

    cfg = EncoderConfig(gop=GOP, qp=QP)
    # cache off: every scan of the scan and server phases decodes; tuning
    # off: the served and in-process scans see one layout
    store = VideoStore(decode=DecodeConfig(device=DEVICE),
                       cache=CacheConfig(budget_bytes=0),
                       tuning=TuningConfig(mode="off"))
    check(store.decode_backend == "batched"
          and store.decode_config.device.startswith(DEVICE),
          f"store decodes with {store.decode_backend} on "
          f"{store.decode_config.device}")
    layout = uniform_layout(H, W, *LAYOUT)
    check(layout.n_tiles == LAYOUT[0] * LAYOUT[1],
          f"layout has {layout.n_tiles} tiles")
    reset_counts()
    t0 = time.perf_counter()
    store.ingest("v", frames, detections=dets, encoder=cfg,
                 initial_layouts={s: layout for s in range(N_FRAMES // GOP)})
    ingest_s = time.perf_counter() - t0
    launches = read_counts()
    n_gops = N_FRAMES // GOP
    check(launches["dct_quant"] == N_FRAMES
          and launches["idct_dequant"] == N_FRAMES - n_gops
          and launches["decode_gop_blocks"] == 0,
          f"ingest launched {launches}, want {N_FRAMES} dct_quant and "
          f"{N_FRAMES - n_gops} idct_dequant")
    print(f"ingest {N_FRAMES}x{H}x{W}, {layout.n_tiles} tiles: "
          f"wall_s={ingest_s:.6f} launches={launches}", flush=True)

    # every SOT against the numpy encoder, tile by tile
    ts = store.video("v").store
    numpy_total = device_total = 0.0
    for rec in ts.sots:
        rects = rec.layout.tile_rects()
        sot = frames[rec.frame_start:rec.frame_end]
        stored = [ts._read_tile(rec, i) for i in range(len(rects))]
        t0 = time.perf_counter()
        again = encode_tiles(sot, rects, cfg, device=DEVICE)
        device_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = [encode_tile(np.ascontiguousarray(sot[:, y1:y2, x1:x2]), cfg)
               for y1, x1, y2, x2 in rects]
        numpy_s = time.perf_counter() - t0
        numpy_total += numpy_s
        device_total += device_s
        equal = total = 0
        for st, a, r in zip(stored, again, ref):
            for k in ("kq", "pq"):
                check(st[k].shape == r[k].shape and st[k].dtype == np.int16,
                      f"stored {k} {st[k].dtype}{st[k].shape}, want "
                      f"int16{r[k].shape}")
                check(np.array_equal(st[k], a[k]),
                      "device encode not repeatable")
                equal += int((st[k] == r[k]).sum())
                total += r[k].size
            check(st["size_bytes"] == a["size_bytes"],
                  "size_bytes not repeatable")
        share = equal / total
        p_dev = psnr(sot, _assemble([decode_tile(e) for e in stored], rects,
                                    sot.shape))
        p_ref = psnr(sot, _assemble([decode_tile(e) for e in ref], rects,
                                    sot.shape))
        print(f"ingest SOT {rec.sot_id} vs numpy encode_tile: "
              f"equal_share={share:.6f} ({total - equal} of {total} "
              f"coefficients differ) psnr_device_db={p_dev:.6f} "
              f"psnr_numpy_db={p_ref:.6f} encode_wall_s "
              f"device={device_s:.6f} numpy={numpy_s:.6f}", flush=True)
        check(share >= SHARE, f"SOT {rec.sot_id} equal share {share}")
        check(abs(p_dev - p_ref) <= PSNR_DB,
              f"SOT {rec.sot_id} PSNR {p_dev} vs numpy {p_ref}")
    print(f"ingest encode of all SOTs on this host's numpy: "
          f"wall_s={numpy_total:.6f}; again on the card: "
          f"wall_s={device_total:.6f}", flush=True)

    rec = ts.sots[0]
    rects = rec.layout.tile_rects()
    sot = frames[rec.frame_start:rec.frame_end]
    split = _encode_split(sot, rects, cfg)
    encs = [ts._read_tile(rec, i) for i in range(len(rects))]
    t0 = time.perf_counter()
    for e in encs:
        stream_bytes_np(e["kq"]) + stream_bytes_np(e["pq"])
    size_s = time.perf_counter() - t0
    if split["dct_quant_ms"] is None:
        share = "not measured"
    else:
        share = f"{split['other_kernels_ms'] / sum(split.values()):.3f}"
    print("ingest one SOT's encode, device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()) +
          f" other_kernels_share={share}; size model host_s={size_s:.6f}",
          flush=True)
    return store, launches


def _oracle_frames(ts) -> np.ndarray:
    """Every frame of the store, decoded tile by tile by the numpy oracle
    (``tests/_torch_race.py``'s, which the race shares)."""
    return _tests_module("_torch_race").oracle_frames(ts)


def _check_regions(regions, oracle, what: str) -> float:
    check(len(regions) > 0, f"{what}: no regions")
    worst = 0.0
    for frame, (y1, x1, y2, x2), px in regions:
        want = oracle[frame, y1:y2, x1:x2]
        check(px.dtype == np.float32 and px.shape == want.shape,
              f"{what}: region {frame} {(y1, x1, y2, x2)} is "
              f"{px.dtype}{px.shape}, want float32{want.shape}")
        np.testing.assert_allclose(px, want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} frame {frame}")
        worst = max(worst, float(np.abs(px - want).max(initial=0.0)))
    return worst


def _check_identical(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} regions")
    for ra, rb in zip(a, b):
        check(ra[:-1] == rb[:-1] and np.array_equal(ra[-1], rb[-1]),
              f"{what}: region {ra[:-1]} differs")


def _scan_split(store) -> dict:
    """Device time of one more full-frame scan, by kind, from the profiler
    (None where it recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        store.scan("v").labels("frame").frames(0, N_FRAMES).execute()
        torch.cuda.synchronize()
    split = {"kernel_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0}
    for evt in prof.key_averages():
        us = evt.device_time_total
        name = evt.key
        if "decode_gop_blocks" in name:
            split["kernel_ms"] += us / 1e3
        elif "HtoD" in name:
            split["h2d_ms"] += us / 1e3
        elif "DtoH" in name:
            split["d2h_ms"] += us / 1e3
    if split["kernel_ms"] == 0.0:
        return {k: None for k in split}
    return split


def scan_phase(store) -> tuple:
    """(launches, oracle frames): the scan paths against the oracle."""
    n = N_FRAMES
    store.add_detections("v", {f: [("frame", (0, 0, H, W))]
                               for f in range(n)})
    t0 = time.perf_counter()
    oracle = _oracle_frames(store.video("v").store)
    oracle_s = time.perf_counter() - t0

    queries = [("car", (0, 64)), ("person", (8, 40)), ("car", (16, 48)),
               ("frame", (30, 34))]
    worst = 0.0
    per_phase = {}

    def timed(name, fn):
        before = read_counts()["decode_gop_blocks"]
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_phase[name] = dict(
            wall_s=time.perf_counter() - t,
            launches=read_counts()["decode_gop_blocks"] - before)
        return out

    reset_counts()
    full = timed("full_frame_scan", lambda: store.scan("v").labels("frame")
                 .frames(0, n).execute())
    roi = timed("label_scan", lambda: store.scan("v").labels("car")
                .frames(0, n).execute())
    serial = timed("serial_four", lambda: [
        store.scan("v").labels(l).frames(*f).execute() for l, f in queries])
    merged = timed("execute_many_four", lambda: store.execute_many(
        [store.scan("v").labels(l).frames(*f) for l, f in queries]))

    def serve():
        with store.serve() as session:
            futs = [session.submit(store.scan("v").labels(l).frames(*f))
                    for l, f in queries]
            return [f.result(timeout=300) for f in futs]

    served = timed("serve_four", serve)
    launches = read_counts()

    check(len(full.regions) == n, f"full-frame scan: {len(full.regions)} "
                                  f"regions, want {n}")
    check(per_phase["full_frame_scan"]["launches"] == n // GOP,
          f"full-frame scan launched {per_phase['full_frame_scan']} times, "
          f"want one per SOT ({n // GOP})")
    worst = max(worst, _check_regions(full.regions, oracle, "full-frame"))
    worst = max(worst, _check_regions(roi.regions, oracle, "label scan"))
    for (lbl, fr), s, m, v in zip(queries, serial, merged, served):
        worst = max(worst, _check_regions(s.regions, oracle,
                                          f"serial {lbl}{fr}"))
        _check_identical(s.regions, m.regions, f"execute_many {lbl}{fr}")
        _check_identical(s.regions, v.regions, f"serve {lbl}{fr}")
    check(launches["decode_gop_blocks"] > 0,
          "the scan path never launched the decode kernel")
    for name, p in per_phase.items():
        check(p["launches"] > 0, f"{name} never launched the kernel")
        print(f"scan {name}: wall_s={p['wall_s']:.6f} "
              f"launches={p['launches']}", flush=True)
    split = _scan_split(store)
    store.close()
    print("scan full-frame device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()), flush=True)
    print(f"scan setup: oracle_s={oracle_s:.3f} "
          f"regions_checked max_abs_err={worst:.3g}", flush=True)
    return launches, oracle


# ------------------------------------------------------------ video serving
def video_server_phase(store, oracle) -> None:
    """The 1080p, 48-tile store served in-process through the port's
    ``VideoStoreServer`` on a Unix socket, driven by client threads, each
    with its own ``RemoteVideoStore``, once per transport, and once more
    over the socket with the JSON codec where msgpack is the default;
    every reply is held bit for bit against the same scan in-process."""
    from repro_torch.core import RemoteVideoStore, VideoStoreServer, wire
    from repro_torch.core.shm import shm_available
    from repro_torch.tasm_serve import shm_pool_bytes

    want = {}
    for lbl, fr in SERVER_QUERIES:
        res = store.scan("v").labels(lbl).frames(*fr).execute()
        _check_regions(res.regions, oracle, f"server reference {lbl}{fr}")
        want[(lbl, fr)] = res.regions
    default = wire.default_codec()
    passes = [("socket", default, SERVER_REQUESTS)] + (
        [("shm", default, SERVER_REQUESTS)] if shm_available() else []) + (
        [("socket", "json", SERVER_REQUESTS_JSON)]
        if default != "json" else [])
    pool_bytes = shm_pool_bytes("/dev/shm") if shm_available() else 0
    print(f"server: default codec={default} msgpack="
          f"{wire._msgpack is not None} passes={passes} "
          f"shm_pool_bytes={pool_bytes}", flush=True)
    tmp = tempfile.mkdtemp(prefix="tasm")
    try:
        for transport, codec, n_req in passes:
            sock = os.path.join(tmp, f"{transport}_{codec}.sock")
            lat, seen, errors = [], [], []
            lock = threading.Lock()

            def client(k):
                try:
                    with RemoteVideoStore(sock, transport=transport,
                                          timeout=600) as cli:
                        for i in range(n_req):
                            q = SERVER_QUERIES[(k + i) % len(SERVER_QUERIES)]
                            t0 = time.perf_counter()
                            res = cli.scan("v").labels(q[0]) \
                                .frames(*q[1]).execute()
                            dt = time.perf_counter() - t0
                            _check_identical(want[q], res.regions,
                                             f"{transport} client {k} {q}")
                            with lock:
                                lat.append(dt)
                                seen.append((res.stats.transport,
                                             res.stats.payload_bytes))
                            del res
                except BaseException as e:  # noqa: BLE001 - raised below
                    errors.append(e)

            with VideoStoreServer(store, path=sock, owns_store=False,
                                  codec=codec,
                                  shm_max_bytes=max(pool_bytes, 1)):
                reset_counts()
                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(SERVER_CLIENTS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                wall = time.perf_counter() - t0
                launches = read_counts()
            check(not any(t.is_alive() for t in threads),
                  f"{transport}: a client hung")
            if errors:
                raise errors[0]
            n = SERVER_CLIENTS * n_req
            check(len(lat) == n, f"{transport}: {len(lat)} of {n} replies")
            check(launches["decode_gop_blocks"] > 0,
                  f"{transport}: served scans never launched the decode "
                  f"kernel: {launches}")
            by = {}
            for t, _ in seen:
                by[t] = by.get(t, 0) + 1
            p50, p95 = np.percentile(lat, [50, 95])
            print(f"server {transport}: {SERVER_CLIENTS} clients x "
                  f"{n_req} requests, wall_s={wall:.6f} "
                  f"requests_per_s={n / wall:.3f} latency_p50_s={p50:.6f} "
                  f"latency_p95_s={p95:.6f} latency_max_s={max(lat):.6f} "
                  f"reply_bytes={int(sum(b for _, b in seen))} "
                  f"replies_by_transport={by} codec={codec} "
                  f"decode_launches={launches['decode_gop_blocks']} "
                  f"(bit-identical to in-process)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _port_env() -> dict:
    """The environment of a port subprocess: this checkout's ``src``
    first on ``PYTHONPATH``."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))


class _Launcher:
    """``python -m module *args`` (or ``python script.py *args`` where
    ``module`` is a path ending in ``.py``) started in the background, its
    output
    sent to temporary files, so that a check that leaves the card mostly
    idle (an f32 model held against the CPU) runs meanwhile;
    ``finish()`` waits for it, checks that it exited 0, prints its wall
    time and output after ``label`` and returns its standard output.  A
    run that fails before ``finish()`` kills it at exit."""

    def __init__(self, label: str, module: str, *args: str, env=None):
        self.label = label
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.cmd = ([module] if module.endswith(".py")
                    else ["-m", module]) + list(args)
        self.proc = subprocess.Popen([sys.executable, *self.cmd],
                                     env={**_port_env(), **(env or {})},
                                     stdout=self.out, stderr=self.err,
                                     text=True)
        atexit.register(self._stop)

    def _stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self, timeout: float = 600, echo: bool = True) -> str:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise
        wall = time.perf_counter() - self.t0
        outs = []
        for f in (self.out, self.err):
            f.seek(0)
            outs.append(f.read())
            f.close()
        what = "python " + " ".join(self.cmd)
        check(rc == 0, f"{what} exited {rc}: {outs[1]}")
        print(f"{self.label} {what}: exit 0 in {wall:.3f} s" + (
            ": " + " | ".join(outs[0].strip().splitlines()) if echo
            else ""), flush=True)
        return outs[0]


def cli_server_phase(seed: int) -> None:
    """``python -m repro_torch.tasm_serve --device cuda`` as a subprocess
    over a small store root: ``ping``, ``config()``, one scan, and a clean
    exit on ``shutdown_server()``; every wait has a timeout."""
    from repro_torch.codec.encode import decode_tile
    from repro_torch.core import (DecodeConfig, NoTilingPolicy,
                                  RemoteVideoStore, TuningConfig, VideoStore)
    from repro_torch.data.video_gen import generate, sparse_spec

    h, w, n = CLI_SPEC
    frames, dets = generate(sparse_spec(seed=seed + 5, height=h, width=w,
                                        n_frames=n))
    tmp = tempfile.mkdtemp(prefix="tasm")
    root, sock = os.path.join(tmp, "root"), os.path.join(tmp, "cli.sock")
    local = VideoStore(store_root=root, decode=DecodeConfig(device=DEVICE),
                       tuning=TuningConfig(mode="off"))
    local.ingest("cam", frames, detections=dets, policy=NoTilingPolicy())
    want = local.scan("cam").labels("car").frames(0, n).execute().regions
    ts = local.video("cam").store
    oracle = np.zeros((n, h, w), np.float32)
    for rec in ts.sots:
        for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
            oracle[rec.frame_start:rec.frame_end, y1:y2, x1:x2] = \
                decode_tile(ts._read_tile(rec, i))
    local.close()
    env = _port_env()
    cmd = [sys.executable, "-m", "repro_torch.tasm_serve", "--device",
           DEVICE, "--socket", sock, "--store-root", root, "--tuning", "off"]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.perf_counter()
        while not os.path.exists(sock):
            if proc.poll() is not None:
                raise AssertionError(f"tasm_serve exited {proc.returncode} "
                                     f"before serving: {proc.stdout.read()}")
            check(time.perf_counter() - t0 < 180,
                  "tasm_serve's socket never appeared")
            time.sleep(0.05)
        start_s = time.perf_counter() - t0
        with RemoteVideoStore(sock, timeout=300) as cli:
            pong = cli.ping()
            cfg = cli.config()
            t1 = time.perf_counter()
            res = cli.scan("cam").labels("car").frames(0, n).execute()
            scan_s = time.perf_counter() - t1
            cli.shutdown_server()
        rc = proc.wait(timeout=120)
        log = proc.stdout.read().strip()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    check(pong.get("pong") is True, f"tasm_serve ping: {pong}")
    check(cfg["decode"].device.startswith(DEVICE),
          f"tasm_serve decodes on {cfg['decode'].device}")
    _check_identical(want, res.regions, "tasm_serve scan")
    worst = _check_regions(res.regions, oracle, "tasm_serve scan")
    check(rc == 0, f"tasm_serve exited {rc}")
    print(f"tasm_serve subprocess ({h}x{w}, {n} frames): {log!r}; "
          f"start_s={start_s:.3f} scan_s={scan_s:.6f} regions="
          f"{len(res.regions)} max_abs_err={worst:.3g} decode="
          f"{cfg['decode']} exit={rc}", flush=True)


# ---------------------------------------------------------------- cluster
def _contexts() -> tuple:
    """(processes holding a context on the card, memory used on it) from
    ``nvidia-smi``.  In a container ``--query-compute-apps`` may list every
    context under one pid, so the phase counts its lines and tells the
    processes apart by their open device files (:func:`_device_files`)."""
    def smi(query):
        return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip().splitlines()

    apps = [line for line in smi("--query-compute-apps=pid,used_memory")
            if line.strip()]
    return len(apps), smi("--query-gpu=memory.used")[0].strip()


def _device_files(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open: none for a
    process that never touched the card (importing torch opens none)."""
    out = []
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return out


def _busy_while(fn) -> tuple:
    """(``fn()``, the card's ``utilization.gpu`` samples while it ran):
    ``nvidia-smi`` every 200 ms, each sample the percent of its period in
    which a kernel of any process ran on the card."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=60)
    samples = [int(x) for x in text.split() if x.isdigit()]
    check(samples, f"nvidia-smi gave no utilization sample: {text!r}")
    return out, samples


def _shm_names() -> set:
    return set(os.listdir("/dev/shm"))


class _Procs:
    """The cluster phase's subprocesses, each logging to a file and waited
    for until its socket appears; :meth:`close` kills what is left."""

    def __init__(self, tmp: str):
        self.tmp, self.procs, self.socks = tmp, {}, {}

    def start(self, name: str, args: list) -> str:
        sock = os.path.join(self.tmp, f"{name}.sock")
        with open(os.path.join(self.tmp, f"{name}.log"), "w") as log:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", *args, "--socket", sock],
                env=_port_env(), cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT)
        self.socks[name] = sock
        return sock

    def node(self, name: str) -> str:
        return self.start(name, [
            "repro_torch.tasm_serve", "--device", DEVICE, "--tuning", "off",
            "--cache-bytes", "0", "--max-frame-mb", str(CLUSTER_FRAME_MB),
            "--store-root", os.path.join(self.tmp, f"store-{name}")])

    def wait_ready(self, names, timeout: float = 180) -> float:
        t0 = time.perf_counter()
        for name in names:
            while not os.path.exists(self.socks[name]):
                check(self.procs[name].poll() is None,
                      f"{name} exited {self.procs[name].returncode} before "
                      f"serving: {self.log(name)}")
                check(time.perf_counter() - t0 < timeout,
                      f"{name}: its socket never appeared")
                time.sleep(0.05)
        return time.perf_counter() - t0

    def pid(self, name: str) -> int:
        return self.procs[name].pid

    def log(self, name: str) -> str:
        with open(os.path.join(self.tmp, f"{name}.log")) as f:
            return f.read()[-4000:]

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def _router_admin(router_sock: str, *args: str) -> tuple:
    """``python -m repro_torch.tasm_router`` in an admin mode against the
    running router: (exit code, output, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.tasm_router",
                          "--socket", router_sock, *args], env=_port_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    return (out.returncode, (out.stdout + out.stderr).strip(),
            time.perf_counter() - t0)


def _cluster_wave(opener, route, queries, want, what: str,
                  on_reply=None) -> tuple:
    """4 client threads, 4 requests each cycling over ``queries``; a
    thread sends a query to ``route(camera)`` over its own client
    ``opener(address)`` and holds every reply bit for bit against
    ``want``; ``on_reply`` sees the count of replies so far.  Returns
    (latencies, wall seconds, reply bytes)."""
    lat, errors, nbytes = [], [], []
    lock = threading.Lock()

    def client(k):
        clients = {}
        try:
            for i in range(SERVER_REQUESTS):
                q = queries[(k + i) % len(queries)]
                cam, lbl, fr = q
                addr = route(cam)
                if addr not in clients:
                    clients[addr] = opener(addr)
                t0 = time.perf_counter()
                res = clients[addr].scan(cam).labels(lbl).frames(*fr) \
                    .execute()
                dt = time.perf_counter() - t0
                _check_identical(want[q], res.regions,
                                 f"{what} client {k} {q}")
                with lock:
                    lat.append(dt)
                    nbytes.append(res.stats.payload_bytes)
                    done = len(lat)
                del res
                if on_reply is not None:
                    on_reply(done)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            for c in clients.values():
                c.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVER_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), f"{what}: a client hung")
    if errors:
        raise errors[0]
    n = SERVER_CLIENTS * SERVER_REQUESTS
    check(len(lat) == n, f"{what}: {len(lat)} of {n} replies")
    return lat, wall, int(sum(nbytes))


def _wave_line(what, wave, busy) -> str:
    lat, wall, nbytes = wave
    p50, p95 = np.percentile(lat, [50, 95])
    return (f"{what}: {len(lat)} requests, wall_s={wall:.6f} "
            f"requests_per_s={len(lat) / wall:.3f} latency_p50_s={p50:.6f} "
            f"latency_p95_s={p95:.6f} latency_max_s={max(lat):.6f} "
            f"reply_bytes={nbytes} card_busy_pct mean "
            f"{np.mean(busy):.1f} max {max(busy)} over {len(busy)} samples")


def cluster_phase(seed: int) -> None:
    """Three ``tasm_serve --device cuda`` node processes behind one
    ``tasm_router`` process (K=2) on this card: routed ingest of three
    1080p cameras, routed scans from 4 client threads (beside the same
    requests sent straight to the nodes), a SIGKILL of cam0's primary
    under load, a routed retile, a fourth node joined and repaired onto
    through the router's CLI, the device checks of ``nvidia-smi``, and a
    clean SIGTERM of every process.  Replies are held bit for bit against
    an in-process store on the card and within tolerance of the numpy
    oracle; every wait has a timeout."""
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import (CacheConfig, ClusterClient, DecodeConfig,
                                  NoTilingPolicy, RemoteVideoStore,
                                  TuningConfig, VideoStore, uniform_layout)
    from repro_torch.core.shm import DEFAULT_POOL_BYTES
    from repro_torch.data.video_gen import generate, sparse_spec

    t_phase = time.perf_counter()
    # five socket servers (four nodes, the router) may each pool up to
    # DEFAULT_POOL_BYTES of replies in /dev/shm, which is never checked
    # against the tmpfs's free space: demand twice that, or stop here
    st = os.statvfs("/dev/shm")
    free, pools = st.f_bavail * st.f_frsize, 5 * DEFAULT_POOL_BYTES
    check(free >= 2 * pools,
          f"cluster: /dev/shm has {free} bytes free, want at least "
          f"{2 * pools} (twice the five servers' shm pools)")
    shm_before = _shm_names()
    enc = EncoderConfig(gop=GOP, qp=QP)
    h, w, n = H, W, CLUSTER_FRAMES
    cams = [f"cam{k}" for k in range(CLUSTER_CAMS)]
    layouts = {s: uniform_layout(h, w, *LAYOUT) for s in range(n // GOP)}
    full = {f: [("frame", (0, 0, h, w))] for f in range(n)}
    t0 = time.perf_counter()
    video = {cam: generate(sparse_spec(seed=seed + 10 + k, height=h,
                                       width=w, n_frames=n))
             for k, cam in enumerate(cams)}
    gen_s = time.perf_counter() - t0
    queries = ([(cam, "car", (0, n)) for cam in cams]
               + [(cam, "person", (n // 4, 3 * n // 4)) for cam in cams]
               + [("cam1", "frame", (0, GOP))])

    counted, used0 = _contexts()
    check(counted <= 1, f"cluster: {counted} contexts on the card before "
                        f"the phase")
    tmp = tempfile.mkdtemp(prefix="tasm")
    procs = _Procs(tmp)
    ref = None
    ok = False
    try:
        node_socks = {name: procs.node(name) for name in ("a", "b", "c")}
        start_s = procs.wait_ready(node_socks)
        router = procs.start("router", [
            "repro_torch.tasm_router", "--replication", "2", "--timeout",
            "300", "--max-frame-mb", str(CLUSTER_FRAME_MB), "--placement",
            os.path.join(tmp, "placement.json"),
            *[a for name, s in node_socks.items()
              for a in ("--node", f"{name}={s}")]])
        procs.wait_ready(["router"])

        def cluster_client(addr=router):
            return ClusterClient(addr, timeout=600,
                                 max_frame_bytes=CLUSTER_FRAME_MB << 20)

        def node_client(addr):
            return RemoteVideoStore(addr, timeout=600,
                                    max_frame_bytes=CLUSTER_FRAME_MB << 20)

        # 1. routed ingest: every camera onto 2 of the 3 nodes
        t0 = time.perf_counter()
        per_cam = {}

        def ingest():
            with cluster_client() as cc:
                for cam in cams:
                    frames, dets = video[cam]
                    cc.add_video(cam, encoder=enc, policy=NoTilingPolicy())
                    t1 = time.perf_counter()
                    stats = cc.ingest(cam, frames, detections=dets,
                                      initial_layouts=layouts)
                    per_cam[cam] = (round(time.perf_counter() - t1, 6),
                                    round(stats.encode_s, 6))
                cc.add_detections("cam1", full)
                return cc.placement()["assignments"]

        placement, busy = _busy_while(ingest)
        ingest_s = time.perf_counter() - t0
        check(sorted(placement) == cams
              and all(len(set(r)) == 2 for r in placement.values()),
              f"cluster placement {placement}")
        print(f"cluster: 3 nodes up in {start_s:.3f} s; routed ingest of "
              f"{len(cams)} cameras x {n}x{h}x{w}, "
              f"{layouts[0].n_tiles} tiles, K=2: wall_s={ingest_s:.6f} "
              f"(per camera: wall_s and one replica's encode_s "
              f"{per_cam}; generate_s={gen_s:.3f}) card_busy_pct mean "
              f"{np.mean(busy):.1f} max {max(busy)} over {len(busy)} "
              f"samples; placement={placement}", flush=True)

        # 2-3. the in-process store on the card, and the numpy oracle
        reset_counts()
        ref = VideoStore(decode=DecodeConfig(device=DEVICE),
                         cache=CacheConfig(budget_bytes=0),
                         tuning=TuningConfig(mode="off"))
        t0 = time.perf_counter()
        for cam in cams:
            frames, dets = video[cam]
            ref.ingest(cam, frames, detections=dets, encoder=enc,
                       policy=NoTilingPolicy(), initial_layouts=layouts)
        ref_ingest_s = time.perf_counter() - t0
        ref.add_detections("cam1", full)
        del video
        counted, used = _contexts()
        check(counted == 1 + len(node_socks),
              f"cluster: {counted} contexts on the card after the ingest, "
              f"want this process's and one per node ({1 + len(node_socks)})")
        check(not _device_files(procs.pid("router")),
              f"cluster: the router opened the card: "
              f"{_device_files(procs.pid('router'))}")
        mem = {"before the nodes": used0, "3 nodes": used}
        print(f"cluster: the same ingest in this process: wall_s="
              f"{ref_ingest_s:.6f}; {counted} contexts on the card",
              flush=True)
        oracle = {cam: _oracle_frames(ref.video(cam).store) for cam in cams}
        want, worst = {}, 0.0
        for q in queries:
            cam, lbl, fr = q
            res = ref.scan(cam).labels(lbl).frames(*fr).execute()
            worst = max(worst, _check_regions(res.regions, oracle[cam],
                                              f"cluster reference {q}"))
            want[q] = res.regions
        del oracle

        # 4. routed scans, then the same requests straight to the nodes
        routed = _busy_while(lambda: _cluster_wave(
            cluster_client, lambda cam: router, queries, want,
            "cluster routed"))
        direct = _busy_while(lambda: _cluster_wave(
            node_client, lambda cam: node_socks[placement[cam][0]],
            queries, want, "cluster direct"))
        hop = (np.percentile(routed[0][0], 50)
               - np.percentile(direct[0][0], 50))
        print(_wave_line("cluster scans through the router, 4 clients x "
                         f"{SERVER_REQUESTS}", *routed) + " | " +
              _wave_line("straight to each camera's primary", *direct) +
              f" | router hop p50_s={hop:.6f} (bit-identical to "
              f"in-process, max_abs_err vs numpy oracle {worst:.3g})",
              flush=True)

        # 5. SIGKILL cam0's primary while a second wave is in flight
        dead = placement["cam0"][0]
        killed = threading.Event()

        def kill_mid_wave(done):
            if done >= SERVER_CLIENTS and not killed.is_set():
                killed.set()
                procs.procs[dead].kill()

        failover = _busy_while(lambda: _cluster_wave(
            cluster_client, lambda cam: router, queries, want,
            "cluster failover", on_reply=kill_mid_wave))
        check(killed.is_set(), "cluster: the primary was never killed")
        check(procs.procs[dead].wait(timeout=60) == -9,
              f"cluster: node {dead} was not killed")
        with cluster_client() as cc:
            health = cc.node_health()
        check(health.get(dead) is False and all(
            v for k, v in health.items() if k != dead),
              f"cluster: node_health after the kill: {health}")
        t0 = time.perf_counter()
        while _contexts()[0] != len(node_socks):
            check(time.perf_counter() - t0 < 30,
                  f"cluster: {_contexts()[0]} contexts 30 s after the "
                  f"kill, want {len(node_socks)}")
            time.sleep(0.5)
        released_s = time.perf_counter() - t0
        mem["after the kill"] = _contexts()[1]
        print(_wave_line(f"cluster failover wave (SIGKILL of {dead}, "
                         f"cam0's primary, after {SERVER_CLIENTS} replies)",
                         *failover) +
              f" failed_reads=0 node_health={health} "
              f"context_released_s={released_s:.3f}", flush=True)

        # 6. a routed retile: the surviving replica re-encodes on the card
        new_layout = uniform_layout(h, w, *CLUSTER_RETILE)
        with cluster_client() as cc:
            t0 = time.perf_counter()
            cc.retile("cam0", 0, new_layout)
            retile_s = time.perf_counter() - t0
            epochs = cc.epochs("cam0")
        ref.retile("cam0", 0, new_layout)
        check(epochs == ref.epochs("cam0") and epochs[0] >= 1,
              f"cluster: routed retile epochs {epochs}, in-process "
              f"{ref.epochs('cam0')}")

        # 7. a fresh node joins, and the CLI repairs onto it
        d_sock = procs.node("d")
        procs.wait_ready(["d"])
        rc, out, join_s = _router_admin(router, "--join-node", f"d={d_sock}")
        check(rc == 0, f"cluster: --join-node exited {rc}: {out}")
        rc, out, repair_s = _router_admin(router, "--repair", f"node={dead}",
                                          "--wait", "300")
        check(rc == 0, f"cluster: --repair exited {rc}: {out}")
        with cluster_client() as cc:
            status = cc.repair_status()
            placement = cc.placement()["assignments"]
        jobs = status["jobs"]
        check(jobs and all(j["status"] == "done" for j in jobs)
              and any(j["dst"] == "d" for j in jobs),
              f"cluster: repair jobs {jobs}")
        check(all(len(r) == 2 and dead not in r for r in placement.values()),
              f"cluster: placement after the repair {placement}")
        # each copy straight from the replica it built (the ring walk, not
        # the phase, picks a copy's destination among the live nodes)
        socks = dict(node_socks, d=d_sock)
        for j in jobs:
            cam = j["video"]
            cam_oracle = _oracle_frames(ref.video(cam).store)
            with node_client(socks[j["dst"]]) as dd:
                check(dd.epochs(cam) == ref.epochs(cam),
                      f"cluster: node {j['dst']} serves {cam} at epochs "
                      f"{dd.epochs(cam)}, want {ref.epochs(cam)}")
                for q in queries:
                    if q[0] != cam:
                        continue
                    got = dd.scan(cam).labels(q[1]).frames(*q[2]).execute()
                    _check_identical(ref.scan(cam).labels(q[1])
                                     .frames(*q[2]).execute().regions,
                                     got.regions,
                                     f"cluster node {j['dst']} {q}")
                    _check_regions(got.regions, cam_oracle,
                                   f"cluster node {j['dst']} {q}")
            del cam_oracle
        print(f"cluster: retile of cam0 SOT 0 to {CLUSTER_RETILE} through "
              f"the router retile_s={retile_s:.6f} epochs={epochs}; "
              f"--join-node d {join_s:.3f} s, --repair node={dead} "
              f"{repair_s:.3f} s: " + "; ".join(
                  f"{j['video']} {j['src']}->{j['dst']} chunks "
                  f"{j['chunks_done']}/{j['chunks_total']} bytes "
                  f"{int(j['bytes_copied'])} retries {j['retries']} "
                  f"restreams {j['restreams']}" for j in jobs) +
              f"; copy_s={status['stats']['copy_s']:.6f}; placement="
              f"{placement}; each copy read straight from its new replica "
              f"at the router's epochs, bit-identical", flush=True)

        # 8. device checks: every live node on the card, the router not
        with cluster_client() as cc:
            cfg = cc.config()["nodes"]
        live = [m for m in ("a", "b", "c", "d") if m != dead]
        check(cfg.get(dead) is None and all(
            cfg[m] is not None and cfg[m]["decode"].device.startswith(DEVICE)
            for m in live), f"cluster: node configs {cfg}")
        counted, mem["4 nodes, one dead"] = _contexts()
        check(counted == 1 + len(live),
              f"cluster: {counted} contexts on the card, want this "
              f"process's and one per live node ({1 + len(live)})")
        files = {m: len(_device_files(procs.pid(m)))
                 for m in live + ["router"]}
        check(files["router"] == 0 and all(files[m] for m in live),
              f"cluster: NVIDIA device files open per process: {files}")
        print(f"cluster device: {counted} contexts on the card (this "
              f"process and nodes {live}, each decoding on "
              f"{sorted({cfg[m]['decode'].device for m in live})}); "
              f"device files open {files}, none by the router (pid "
              f"{procs.pid('router')}); card memory used {mem} (per "
              f"process: not measured, nvidia-smi lists every context "
              f"under one pid here)", flush=True)

        # 9. SIGTERM: the router, then the nodes, each exits 0
        for m in ["router"] + live:
            procs.procs[m].send_signal(signal.SIGTERM)
            rc = procs.procs[m].wait(timeout=120)
            check(rc == 0, f"cluster: {m} exited {rc}: {procs.log(m)}")
            check(not os.path.exists(procs.socks[m]),
                  f"cluster: {m} left its socket behind")
        ok = True
    finally:
        if not ok:
            for m in procs.procs:
                print(f"cluster: {m} log tail: {procs.log(m)!r}",
                      file=sys.stderr, flush=True)
        procs.close()
        if ref is not None:
            ref.close()
        shutil.rmtree(tmp, ignore_errors=True)
    left = sorted(_shm_names() - shm_before)
    check(not left, f"cluster: shared-memory segments left behind: {left}")
    print(f"cluster phase: wall_s={time.perf_counter() - t_phase:.3f} "
          f"in-process reference launches={read_counts()}", flush=True)


def retile_phase(frames, dets, mode: str) -> dict:
    """Regret-driven retiles of the 1080p video under ``mode`` tuning; the
    new tiles must come from the encode kernels and scan right."""
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import (CacheConfig, DecodeConfig, RegretPolicy,
                                  TuningConfig, VideoStore)
    from repro_torch.core.cost import CostModel

    store = VideoStore(decode=DecodeConfig(device=DEVICE),
                       tuning=TuningConfig(mode=mode),
                       cache=CacheConfig(budget_bytes=0))
    store.ingest("r", frames[:RETILE_FRAMES], detections=dets[:RETILE_FRAMES],
                 encoder=EncoderConfig(gop=GOP, qp=QP),
                 policy=RegretPolicy(),
                 cost_model=CostModel(beta=1.4e-8, gamma=1e-5))
    ts = store.video("r").store
    ingest_s = ts.encode_seconds_total
    reset_counts()
    t0 = time.perf_counter()
    scans = 0
    while not any(store.epochs("r").values()) and scans < 24:
        store.scan("r").labels("car").frames(0, RETILE_FRAMES).execute()
        store.drain_tuner(timeout=600)
        scans += 1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    epochs = store.epochs("r")
    check(any(epochs.values()), f"{mode}: no retile after {scans} scans")
    check(launches["dct_quant"] > 0 and launches["idct_dequant"] > 0,
          f"{mode} retile did not encode through the kernels: {launches}")
    retile_s = ts.encode_seconds_total - ingest_s
    oracle = _oracle_frames(ts)
    res = store.scan("r").labels("car").frames(0, RETILE_FRAMES).execute()
    worst = _check_regions(res.regions, oracle, f"after {mode} retile")
    layouts = {r.sot_id: (r.layout.n_tiles, r.epoch) for r in ts.sots}
    store.close()
    print(f"retile {mode}: scans={scans} wall_s={wall_s:.6f} "
          f"retile_encode_s={retile_s:.6f} layouts(tiles, epoch)="
          f"{layouts} launches={launches} regions_checked "
          f"max_abs_err={worst:.3g}", flush=True)
    return launches


def calibration_phase() -> None:
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core.calibrate import calibrated_cost_model

    t0 = time.perf_counter()
    model = calibrated_cost_model(EncoderConfig(gop=GOP, qp=QP),
                                  device=DEVICE, repeats=10)
    print(f"calibration ({time.perf_counter() - t0:.3f} s): "
          f"beta={model.beta!r} gamma={model.gamma!r} "
          f"r_squared={model.r_squared!r} "
          f"encode_per_pixel={model.encode_per_pixel!r} "
          f"encode_per_tile={model.encode_per_tile!r} "
          f"io_per_pixel={model.io_per_pixel!r}", flush=True)
    for k in ("beta", "encode_per_pixel"):
        v = getattr(model, k)
        check(np.isfinite(v) and v > 0, f"calibrated {k}={v}")
    # the batched decode opens every tile of a SOT in one dispatch: on the
    # card the least-squares gamma comes out negative and the fit clamps it
    # to 0, so gamma is held to finite and non-negative
    check(np.isfinite(model.gamma) and model.gamma >= 0,
          f"calibrated gamma={model.gamma}")


def tuner_race_phase(frames, dets) -> dict:
    """Scans racing the background tuner's retiles on the card, through
    ``tests/_torch_race.py`` (the race the card's test runs, here with
    ``RACE_THREADS`` client threads on the first RETILE_FRAMES frames):
    every region bit for bit an inline-tuned store's on the card and
    within the numpy oracle, no query charged a retile, an epoch risen,
    and a ``dct_quant`` launch between some scan's call and its return.
    Returns the background store's launches, from the threads' start to
    the drained tuner."""
    from repro_torch.kernels import dct

    racing = _tests_module("_torch_race")
    t_phase = time.perf_counter()
    out = racing.race(frames[:RETILE_FRAMES], dets[:RETILE_FRAMES], DEVICE,
                      lambda: dct.LAUNCHES.count, threads=RACE_THREADS,
                      max_passes=RACE_PASSES, start=reset_counts)
    launches = read_counts()
    worst = racing.check(out, must_race=True)
    for name in ("decode_gop_blocks", "dct_quant", "idct_dequant"):
        check(launches[name] > 0, f"tuner race never launched {name}: "
                                  f"{launches}")
    lat, tuner = out["latencies"], out["tuner"]
    p50, p95 = np.percentile(lat, [50, 95])
    print(f"tuner race: {RACE_THREADS} threads, {len(lat)} scans in all, "
          f"and a session of {racing.SESSION}; race wall_s="
          f"{out['race_s']:.6f} scan p50_s={p50:.6f} p95_s={p95:.6f} max_s="
          f"{max(lat):.6f}; scans that saw a retile in flight="
          f"{len(out['in_flight'])}; tuner observed={tuner.observed} "
          f"proposals={tuner.proposals} coalesced={tuner.coalesced} applied="
          f"{tuner.applied} retile_s={tuner.retile_s:.6f}; epochs="
          f"{out['epochs']} (serial inline store: {out['serial_epochs']}, "
          f"its {len(racing.MIX)} scans {out['serial_s']:.3f} s); launches="
          f"{launches}; bit-identical to the serial store, max_abs_err="
          f"{worst:.3g} against the oracle; phase wall_s="
          f"{time.perf_counter() - t_phase:.3f}", flush=True)
    return launches


def entry_points_phase() -> dict:
    """The ported entry points' own functions in this process on the card,
    the launch counts set to 0 before each and read after: the video
    examples must launch the decode and both encode kernels and hold
    their contracts, the LM examples and the model smoke must launch
    ``flash_attention`` and give finite logits, and every attention call
    they make runs beside the plain version on the same q, k and v
    (``_AttentionBesidePlain``), each within the larger of FLASH_TOL and
    one ulp of the plain output.  Their printed output is kept and
    summarised.  Returns each one's launches."""
    import contextlib
    import io

    from repro_torch.configs.base import ARCH_IDS

    video = ("decode_gop_blocks", "dct_quant", "idct_dequant")
    out = {}

    def one(name, run, kernels, folder="examples"):
        mod = _entry_point(name, folder)
        text = io.StringIO()
        attention = "flash_attention" in kernels
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), (
                _AttentionBesidePlain() if attention
                else contextlib.nullcontext()) as sites:
            ok = run(mod)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        failed = sorted(k for k, v in ok.items() if not v)
        check(ok and not failed, f"{name}: contracts failed: {failed}")
        for kernel in kernels:
            check(launches[kernel] > 0,
                  f"{name} never launched {kernel}: {launches}")
        if attention:
            check(len(sites.calls) == launches["flash_attention"]
                  and max(sites.over) <= 1.0,
                  f"{name} attention vs plain at the sites: "
                  f"{list(zip(sites.calls, sites.errs, sites.mags))}")
        lines = text.getvalue().strip().splitlines()
        print(f"entry point {name}: wall_s={wall:.3f}" +
              (" (attention beside plain at every site)" if attention
               else "") + f" contracts {len(ok)} of {len(ok)} hold; "
              "launches " +
              " ".join(f"{k}={v}" for k, v in launches.items() if v) +
              (f"; each site's attention output vs plain on the same q, k, "
               f"v: {_site_line(sites)}" if attention else "") +
              (f"; its last line printed: {lines[-1]!r}" if lines else ""),
              flush=True)
        out[name] = launches

    with tempfile.TemporaryDirectory(prefix="tasm") as root:
        one("quickstart_torch", lambda m: m.run(root, DEVICE), video)
    one("incremental_workload_torch", lambda m: m.run(DEVICE), video)
    one("edge_tiling_torch", lambda m: m.run(DEVICE), video)
    one("serve_lm_torch", lambda m: m.run(DEVICE), ("flash_attention",))
    one("continuous_batching_torch", lambda m: m.run(DEVICE),
        ("flash_attention",))
    one("smoke_models_torch",
        lambda m: {a: m.smoke(a, DEVICE)["ok"] for a in ARCH_IDS},
        ("flash_attention",), folder="scripts")
    return out


# ------------------------------------------------------ attention and serving
def _qkv(rng, b, h, kv, s, d, dtype, dv=None):
    """q [b, h, s, d], k [b, kv, s, d] and v [b, kv, s, dv or d] from
    ``rng`` on the card."""
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(DEVICE, dtype)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv or d))]


def _qkv_cross(rng, shape, dtype):
    """q [B, H, S, Dqk], k [B, KV, Skv, Dqk] and v [B, KV, Skv, Dv] from
    ``rng`` on the card, for ``shape`` (B, H, KV, S, Skv, Dqk, Dv)."""
    b, h, kv, s, skv, d, dv = shape
    return [torch.from_numpy(rng.standard_normal(x, dtype=np.float32))
            .to(DEVICE, dtype)
            for x in ((b, h, s, d), (b, kv, skv, d), (b, kv, skv, dv))]


def cross_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for one attention of S queries over Skv keys (not
    causal), ``shape`` (B, H, KV, S, Skv, Dqk, Dv): q and o ([B, H, S,
    Dqk] and [B, H, S, Dv]) and k and v ([B, KV, Skv, Dqk] and [B, KV,
    Skv, Dv]) moved once over the HBM rate, against the QK^T and PV
    products over all S x Skv pairs over the card's peak for the type."""
    b, h, kv, s, skv, d, dv = shape
    elt = torch.finfo(dtype).bits // 8
    n_bytes = b * (h * s + kv * skv) * (d + dv) * elt
    flops = 2 * b * h * (d + dv) * s * skv
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bound_ms(shape, dtype, causal: bool) -> tuple[float, str]:
    """Least time for one attention: q, k, v read and o written once over
    the HBM rate, against the products these inputs need (QK^T over Dqk
    and PV over Dv, 2 FLOPs per multiply-add, over the live (query, key)
    pairs) over the card's peak for their type.  ``shape`` is (B, H, KV,
    S, D) or (B, H, KV, S, Dqk, Dv)."""
    b, h, kv, s, d = shape[:5]
    dv = shape[5] if len(shape) > 5 else d
    elt = torch.finfo(dtype).bits // 8
    n_bytes = b * s * (h + kv) * (d + dv) * elt
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * b * h * (d + dv) * pairs
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_digests(call, shapes=None) -> dict:
    """{dtype name: sha256 of the outputs of ``call(q, k, v, causal)``
    over ``shapes`` (FLASH_SHAPES, the (D, D) pairs, unless given), causal
    and not, on ``randn`` inputs from DIGEST_SEED}: the same bits give the
    same digests."""
    rng = np.random.default_rng(DIGEST_SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        digest = hashlib.sha256()
        for shape in shapes or FLASH_SHAPES:
            q, k, v = _qkv(rng, *shape[:5], dtype,
                           dv=shape[5] if len(shape) > 5 else None)
            for causal in (True, False):
                o = call(q, k, v, causal=causal)
                digest.update(o.contiguous().view(-1).view(torch.uint8)
                              .cpu().numpy().tobytes())
        out[str(dtype).split(".")[-1]] = digest.hexdigest()[:32]
    return out


def flash_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.flash_attention import (LAUNCHES, attention_ref,
                                                     flash_attention)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(seed + 2)
    worst = 0.0
    timed = {}
    for shape in FLASH_SHAPES + [FLASH_VLM, FLASH_PIPE] + FLASH_MLA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(rng, *shape[:5], dtype,
                           dv=shape[5] if len(shape) > 5 else None)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(err <= FLASH_TOL[dtype],
                      f"flash_attention vs plain {shape} {dtype} causal="
                      f"{causal}: max |diff| {err} > {FLASH_TOL[dtype]}")
                worst = max(worst, err)
            if shape not in (FLASH_MAIN, FLASH_LONG, FLASH_MOE,
                             FLASH_HYBRID, FLASH_MLA, FLASH_VLM,
                             FLASH_PIPE) \
                    or dtype != torch.bfloat16:
                continue
            k_ms = cuda_ms(lambda: flash_attention(q, k, v), iters=20)
            r_ms = cuda_ms(lambda: attention_ref(q, k, v), iters=3,
                           warmup=1)
            l_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True), iters=20)
            b_ms, b_by = flash_bound_ms(shape, dtype, True)
            t_bytes = flash_bound_ms(shape, dtype, False)
            print(f"flash_attention {shape} bf16 causal: kernel_ms="
                  f"{k_ms:.6f} plain_ms={r_ms:.6f} sdpa_ms={l_ms:.6f} "
                  f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound="
                  f"{b_ms / k_ms:.3f} (non-causal bound "
                  f"{t_bytes[0]:.6f} ms, {t_bytes[1]})", flush=True)
            timed[shape] = dict(ms=k_ms, plain_ms=r_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by)
    # keys of another length than the queries: not causal only
    for shape in FLASH_CROSS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv_cross(rng, shape, dtype)
            got = flash_attention(q, k, v, causal=False)
            want = attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(tuple(got.shape) == (*shape[:2], shape[3], shape[6])
                  and err <= FLASH_TOL[dtype],
                  f"flash_attention vs plain {shape} {dtype} (S={shape[3]} "
                  f"over Skv={shape[4]}): max |diff| {err} > "
                  f"{FLASH_TOL[dtype]}")
            worst = max(worst, err)
            print(f"flash_attention {shape} {str(dtype)[6:]} S={shape[3]} "
                  f"over Skv={shape[4]}, not causal: max_abs_err={err:.3g}",
                  flush=True)
    before = LAUNCHES.count
    try:
        flash_attention(q, k, v, causal=True)
        refused = False
    except ValueError:
        refused = True
    check(refused and LAUNCHES.count == before,
          "causal flash_attention with two lengths was not refused")
    q, k, v = _qkv_cross(rng, FLASH_CROSS, torch.bfloat16)
    k_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=False), iters=20)
    r_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=False), iters=3,
                   warmup=1)
    l_ms = cuda_ms(lambda: sdpa(q, k, v), iters=20)
    b_ms, b_by = cross_bound_ms(FLASH_CROSS, torch.bfloat16)
    print(f"flash_attention {FLASH_CROSS} bf16 cross (S={FLASH_CROSS[3]} "
          f"over Skv={FLASH_CROSS[4]}): kernel_ms={k_ms:.6f} plain_ms="
          f"{r_ms:.6f} sdpa_ms={l_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
          f"share_of_bound={b_ms / k_ms:.3f}; causal with two lengths "
          f"refused", flush=True)
    cross = dict(ms=k_ms, plain_ms=r_ms, library_ms=l_ms, bound_ms=b_ms,
                 bound_by=b_by)
    digests = flash_digests(flash_attention)
    mla_digests = flash_digests(flash_attention, FLASH_MLA_SHAPES)
    print(f"flash_attention (D, D) pairs over {len(FLASH_SHAPES)} shapes, "
          f"causal and not: sha256 {digests}, the kernel before v's width "
          f"became a parameter {FLASH_OLD_DIGESTS}; (192, 128) over "
          f"{len(FLASH_MLA_SHAPES)} shapes: {mla_digests}, the kernel "
          f"before the keys' length became a parameter "
          f"{FLASH_MLA_OLD_DIGESTS}", flush=True)
    check(digests == FLASH_OLD_DIGESTS,
          "flash_attention's (D, D) pairs are not the earlier kernel's bits")
    check(mla_digests == FLASH_MLA_OLD_DIGESTS,
          "flash_attention's (192, 128) pair is not the earlier kernel's "
          "bits")
    q, k, v = _qkv(rng, 1, 9, 3, 16, 64, torch.bfloat16)
    qm, km, vm = _qkv(rng, 1, 16, 16, 16, 192, torch.bfloat16, dv=128)
    # the JSON line reports the cross-attention shape, this slice's case
    at_main = dict(cross, max_abs_err=worst,
                   host_us=host_us(lambda: flash_attention(qm, km, vm)),
                   smollm_ms=timed[FLASH_MAIN]["ms"],
                   long_ms=timed[FLASH_LONG]["ms"],
                   mla_ms=timed[FLASH_MLA]["ms"])
    print(f"flash_attention max_abs_err={worst:.3g} wrapper host cost: "
          f"{host_us(lambda: flash_attention(q, k, v)):.3f} us/call at "
          f"(1, 9, 3, 16, 64), {at_main['host_us']:.3f} us/call at (1, 16, "
          f"16, 16, 192 / 128)", flush=True)
    return at_main


# ------------------------------------------------------------ motion search
def sad_bound_ms(n: int, b: int, r: int) -> tuple[float, str]:
    """Least time for one search: blocks and windows read and the three
    [N] outputs written once over the HBM rate, against the two fp32 adds
    (a subtract, an add of the absolute value) of every (pixel, candidate)
    pair over the card's fp32 add rate."""
    w = b + 2 * r
    n_bytes = n * 4 * (b * b + w * w) + 12 * n
    adds = 2 * n * (2 * r + 1) ** 2 * b * b
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, adds / FP32_ADDS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sad_at(cur, win, dy, dx):
    """The plain SAD of candidate (dy[n], dx[n]) of every block n."""
    b = cur.shape[-1]
    idx = torch.arange(b, device=cur.device)
    rows = dy.long()[:, None] + idx
    cols = dx.long()[:, None] + idx
    cand = win[torch.arange(cur.shape[0], device=cur.device)[:, None, None],
               rows[:, :, None], cols[:, None, :]]
    return (cur - cand).abs().sum(dim=(1, 2))


def check_sad(got, want, cur, win, what: str, exact: bool) -> int:
    """Hold a search result against the plain one: all three outputs equal
    on integer-valued pixels (ties included); else ``sad`` within
    ``SAD_TOL`` and ``dy``/``dx`` equal except at near-ties, where the
    chosen candidate's plain SAD is within ``SAD_TOL`` of the plain
    minimum.  Returns the number of near-ties."""
    (dy, dx, sad), (rdy, rdx, rsad) = got, want
    check(dy.dtype == dx.dtype == torch.int32 and sad.dtype == torch.float32
          and dy.shape == dx.shape == sad.shape == (cur.shape[0],),
          f"{what}: outputs {dy.dtype} {dx.dtype} {sad.dtype} "
          f"{tuple(sad.shape)}")
    if exact:
        check(torch.equal(dy, rdy) and torch.equal(dx, rdx)
              and torch.equal(sad, rsad),
              f"{what}: not equal to the plain version on integer pixels "
              f"({int(((dy != rdy) | (dx != rdx)).sum())} choices differ, "
              f"max |sad diff| {float((sad - rsad).abs().max())})")
        return 0
    rel = float(((sad - rsad).abs() / rsad.abs().clamp_min(1e-30)).max())
    check(rel <= SAD_TOL, f"{what}: sad differs by rtol {rel} > {SAD_TOL}")
    off = (dy != rdy) | (dx != rdx)
    if bool(off.any()):
        chosen = _sad_at(cur, win, dy, dx)
        near = (chosen - rsad).abs() <= SAD_TOL * rsad.abs()
        check(bool(near[off].all()),
              f"{what}: {int((off & ~near).sum())} choices differ beyond a "
              f"near-tie")
    return int(off.sum())


def _sad_inputs(rng, n: int, b: int, r: int, integer: bool):
    w = b + 2 * r
    if integer:
        cur = rng.integers(0, 256, (n, b, b)).astype(np.float32)
        win = rng.integers(0, 256, (n, w, w)).astype(np.float32)
        win[0] = 77.0  # a constant window: every candidate ties at (0, 0)
    else:
        cur = (rng.standard_normal((n, b, b)) * 25).astype(np.float32)
        win = (rng.standard_normal((n, w, w)) * 25).astype(np.float32)
    return torch.from_numpy(cur).to(DEVICE), torch.from_numpy(win).to(DEVICE)


def sad_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.sad import sad_search, sad_search_ref

    rng = np.random.default_rng(seed + 4)
    near_ties = worst = 0
    for b, r in SAD_SWEEP_BR:
        for n in SAD_SWEEP_N:
            for integer in (True, False):
                cur, win = _sad_inputs(rng, n, b, r, integer)
                got = sad_search(cur, win)
                want = sad_search_ref(cur, win)
                torch.cuda.synchronize()
                what = (f"sad_search b={b} r={r} N={n} "
                        f"{'integer' if integer else 'float'}")
                near_ties += check_sad(got, want, cur, win, what, integer)
                if integer:
                    check((int(got[0][0]), int(got[1][0])) == (0, 0),
                          f"{what}: a constant window chose "
                          f"({int(got[0][0])}, {int(got[1][0])})")
                worst = max(worst, float((got[2] - want[2]).abs().max()))
    print(f"sad_search sweep: (b, r) in {SAD_SWEEP_BR}, N in {SAD_SWEEP_N}, "
          f"integer and float pixels: integer exact (ties and a constant "
          f"window included), float near_ties={near_ties} "
          f"max_abs_err={worst:.3g}", flush=True)
    timed = {}
    for h, w, b, r in MOTION_PAIRS:
        n = (h // b) * (w // b)
        cur, win = _sad_inputs(rng, n, b, r, False)
        k_ms = cuda_ms(lambda: sad_search(cur, win), iters=20)
        r_ms = cuda_ms(lambda: sad_search_ref(cur, win), iters=3, warmup=1)
        b_ms, b_by = sad_bound_ms(n, b, r)
        one, one_w = cur[:1].contiguous(), win[:1].contiguous()
        h_us = host_us(lambda: sad_search(one, one_w))
        print(f"sad_search N={n} b={b} r={r} ({h}p pair): kernel_ms="
              f"{k_ms:.6f} plain_ms={r_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / k_ms:.3f} wrapper host_us={h_us:.3f}",
              flush=True)
        timed[(h, w)] = dict(ms=k_ms, plain_ms=r_ms, bound_ms=b_ms,
                             bound_by=b_by, host_us=h_us,
                             label=f"sad_search N={n} b={b} r={r}")
    return dict(timed[MOTION_PAIRS[0][:2]], max_abs_err=worst,
                library_ms=None,
                by_shape={t["label"]: t["ms"] for t in timed.values()})


def motion_path_phase(seed: int, frames) -> int:
    """Motion search between consecutive frames of the synthetic video at
    1080p (b=8) and 720p (b=16): ``frame_motion_blocks`` on the host, one
    pinned H2D copy, one launch, one D2H copy per pair, held against the
    plain version; then the planted shift on a real frame.  Returns the
    launches of the two pairs."""
    from repro_torch.data.video_gen import generate, sparse_spec
    from repro_torch.kernels.sad import (frame_motion_blocks, sad_search_op,
                                         sad_search_ref)

    pairs = {(H, W): frames[:2]}
    f720, _ = generate(sparse_spec(seed=seed, height=720, width=1280,
                                   n_frames=2))
    pairs[(720, 1280)] = f720

    def run(cur, ref, b, r):
        t0 = time.perf_counter()
        blocks, windows = frame_motion_blocks(cur, ref, b=b, r=r)
        t1 = time.perf_counter()
        host = (torch.from_numpy(blocks).pin_memory(),
                torch.from_numpy(windows).pin_memory())
        dev = [x.to(DEVICE, non_blocking=True) for x in host]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = sad_search_op(*dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        res = [x.cpu() for x in out]
        t4 = time.perf_counter()
        times = dict(blocks_s=t1 - t0, h2d_s=t2 - t1, kernel_s=t3 - t2,
                     d2h_s=t4 - t3)
        return dev, out, res, times

    reset_counts()
    runs = {}
    for h, w, b, r in MOTION_PAIRS:
        f = pairs[(h, w)]
        runs[(h, w)] = run(f[1], f[0], b, r)
    launches = read_counts()
    check(launches["sad_search"] == len(MOTION_PAIRS)
          and sum(launches.values()) == len(MOTION_PAIRS),
          f"the motion path launched {launches}, want one sad_search per "
          f"pair")
    near_ties = 0
    for h, w, b, r in MOTION_PAIRS:
        dev, out, res, times = runs[(h, w)]
        what = f"motion {h}p b={b} r={r}"
        near_ties += check_sad(out, sad_search_ref(*dev), *dev, what, False)
        check(all(torch.equal(a, c.cpu()) for a, c in zip(res, out)),
              f"{what}: D2H copy differs")
        f8 = np.clip(np.round(pairs[(h, w)]), 0, 255).astype(np.float32)
        dev8, out8, _, _ = run(f8[1], f8[0], b, r)
        check_sad(out8, sad_search_ref(*dev8), *dev8, f"{what} 8-bit", True)
        moved = float(((out[0] != r) | (out[1] != r)).float().mean())
        print(f"{what}: N={dev[0].shape[0]} " +
              " ".join(f"{k}={v:.6f}" for k, v in times.items()) +
              f" moved_share={moved:.4f} mean_sad={float(out[2].mean()):.3f}"
              f" (8-bit frames: exact)", flush=True)
    # the planted shift of tests/test_kernels.py on a real 8-bit frame:
    # cur[y, x] == ref[y - 3, x + 2], so inner blocks match at (r-3, r+2)
    h, w, b, r = MOTION_PAIRS[0]
    ref = np.clip(np.round(frames[0]), 0, 255).astype(np.float32)
    cur = np.roll(ref, shift=PLANT, axis=(0, 1))
    dev = [torch.from_numpy(x).to(DEVICE)
           for x in frame_motion_blocks(cur, ref, b=b, r=r)]
    out = sad_search_op(*dev)
    check_sad(out, sad_search_ref(*dev), *dev, "planted shift", True)
    dy, dx, sad = (x.cpu().numpy() for x in out)
    nby, nbx = h // b, w // b
    inner = np.zeros((nby, nbx), bool)
    inner[1:-1, 1:-1] = True
    inner = inner.ravel()
    hit = (dy == r - PLANT[0]) & (dx == r - PLANT[1])
    check(bool((sad[inner] == 0).all()),
          f"planted shift: {int((sad[inner] != 0).sum())} inner blocks have "
          f"a nonzero SAD")
    share = float(hit[inner].mean())
    print(f"motion planted shift {PLANT} on a {h}p frame: inner blocks "
          f"{int(inner.sum())}, found at (r-3, r+2): {share:.6f} (the rest "
          f"tie at SAD 0 with an earlier candidate); near_ties in the "
          f"pairs={near_ties}", flush=True)
    check(share >= 0.5, f"planted shift found in only {share} of blocks")
    return launches["sad_search"]


def _arch_config(arch: str, **kw):
    """``arch``'s serving config (``make_serve_config(cfg, 1)``: bf16
    weights) with ``kw`` replaced."""
    from repro_torch.configs.base import get_config, make_serve_config

    cfg = make_serve_config(get_config(arch), model_axis=1)
    return dataclasses.replace(cfg, **kw)


def _serve_config(**kw):
    return _arch_config(ARCH, **kw)


def _plain_prefill_attention():
    """A test-only patch: the attention module's kernel entry replaced by
    the plain version, so the same model prefills without the kernel."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models import attention

    return mock.patch.object(
        attention, "flash_attention_op",
        lambda q, k, v, causal=True: attention_ref(q, k, v, causal=causal))


def _is_matmul(name: str) -> bool:
    """A matmul kernel: cuBLAS's Hopper kernels are named nvjet_*, older
    ones *gemm*."""
    name = name.lower()
    return any(t in name for t in ("nvjet", "gemm", "gemv", "matmul",
                                   "xmma", "cutlass", "cublas"))


def _print_top(what: str, label: str, times: dict) -> None:
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    print(f"{what}, largest {label} kernels: " +
          "; ".join(f"{k} {v:.6f} ms" for k, v in top), flush=True)


def _device_split(what: str, fn, *, bwd: bool = False) -> dict:
    """Device time of ``fn()``, by kind, from the profiler (None where it
    recorded no device time); prints the largest other kernels.  With
    ``bwd`` the attention backward's kernels are a kind of their own.  It
    records the device's activity alone (the host's op events, which
    nothing here reads, made a profiled step of zamba2-1.2b's 38 layers
    take 20 times its unprofiled wall time) and sums the profiler's raw
    events, without building its function events (``key_averages``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"flash_attention_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    if bwd:
        split["flash_attention_bwd_ms"] = 0.0
    others = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        ms = evt.duration_ns() / 1e6
        key = evt.name()
        name = key.lower()
        if bwd and "attention_bwd" in name:
            split["flash_attention_bwd_ms"] += ms
        elif "flash_attention" in name:
            split["flash_attention_ms"] += ms
        elif _is_matmul(name):
            split["matmul_ms"] += ms
        else:
            split["other_ms"] += ms
            others[key[:60]] = others.get(key[:60], 0.0) + ms
    if sum(split.values()) == 0.0:
        return {k: None for k in split}
    _print_top(what, "other", others)
    return split


def _generate(model, cfg, prompts, *, prefill_extra=None, decode_extra=None,
              start=None, new=SERVE_NEW, timed=True) -> tuple:
    """(prefill logits, greedy tokens [B, new], TTFT s, decode tok/s,
    generate wall s, launches of the prefill): one prefill of ``prompts``
    and ``prefill_extra`` (an encoder-decoder's frames, a VLM's patch
    embeddings) through ``make_prefill_step``, timed, with the counts set
    to 0 just before it and read just after; if ``timed``, ``new`` - 1
    decode steps from ``start`` (the prompts' length unless given) with
    ``decode_extra`` (``enc_out``), timed (else decode tok/s is None);
    then ``greedy_generate`` of ``new`` tokens on the prompts with
    ``decode_extra``."""
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    decode = make_decode_step(cfg, device=DEVICE)
    extra = decode_extra or {}
    start = prompts.shape[1] if start is None else start
    tok_s = None
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, caches = prefill(model, {"tokens": prompts,
                                         **(prefill_extra or {})})
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        launches = read_counts()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if timed:
            t0 = time.perf_counter()
            for i in range(new - 1):
                step, caches = decode(model, caches,
                                      {"tokens": tok, **extra}, start + i)
                tok = torch.argmax(step[:, -1], dim=-1)[:, None]
            torch.cuda.synchronize()
            tok_s = prompts.shape[0] * (new - 1) / (time.perf_counter()
                                                    - t0)
        t0 = time.perf_counter()
        out = greedy_generate(model, cfg, prompts, max_new=new,
                              device=DEVICE, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return logits, out, ttft, tok_s, wall, launches


def _batcher_run(what: str, cfg, model, rng, *, per_wave=None,
                 repeat: bool = False) -> dict:
    """``ContinuousBatcher(slots=8, max_len=640)`` over 16 requests of
    64-512 prompt tokens and 8-16 new tokens drawn from ``rng``: every
    request finishes with its tokens, ``per_wave`` ``flash_attention``
    launches per wave (one per layer unless given; counts set to 0 just
    before the run, read just after); returns the stats.  With
    ``repeat`` request 0 gets a prompt of 512 tokens and the first
    request of the second wave repeats it (neither is padded, each is its
    wave's longest), and must get the same tokens."""
    from repro_torch.serve import ContinuousBatcher

    per_wave = cfg.n_layers if per_wave is None else per_wave
    batcher = ContinuousBatcher(cfg, model, slots=BATCH_SLOTS,
                                max_len=BATCH_MAX_LEN, device=DEVICE)
    reqs = []
    for _ in range(BATCH_REQUESTS):
        n = int(rng.integers(BATCH_PROMPT[0], BATCH_PROMPT[1] + 1))
        new = int(rng.integers(BATCH_NEW[0], BATCH_NEW[1] + 1))
        reqs.append((rng.integers(0, cfg.vocab, n), new))
    if repeat:
        reqs[0] = (rng.integers(0, cfg.vocab, BATCH_PROMPT[1]), reqs[0][1])
        reqs[BATCH_SLOTS] = reqs[0]
    for prompt, new in reqs:
        batcher.submit(prompt, max_new=new)
    waves = -(-BATCH_REQUESTS // BATCH_SLOTS)
    reset_counts()
    stats = batcher.run_until_drained()
    torch.cuda.synchronize()
    b_launches = read_counts()["flash_attention"]
    check(stats["requests"] == BATCH_REQUESTS
          and sorted(len(r.out_tokens) for r in batcher.finished)
          == sorted(new for _, new in reqs),
          f"batcher finished {stats['requests']} requests")
    check(b_launches == waves * per_wave,
          f"batcher launched flash_attention {b_launches} times for "
          f"{waves} waves, want {waves * per_wave}")
    line = ""
    if repeat:
        tokens = {r.rid: r.out_tokens for r in batcher.finished}
        same = tokens[BATCH_SLOTS] == tokens[0]
        line = (f"; request {BATCH_SLOTS} (wave 2) repeats request 0 (wave "
                f"1): same tokens {same}")
        check(same, f"{what}: the repeated request got other tokens in "
                    f"the second wave")
    print(f"{what} ContinuousBatcher(slots={BATCH_SLOTS}, max_len="
          f"{BATCH_MAX_LEN}), {BATCH_REQUESTS} requests: {json.dumps(stats)} "
          f"launches={b_launches}{line}", flush=True)
    return stats


def serve_phase(seed: int) -> dict:
    """The LM serving slice at full width; returns the launches of the
    main path's prefill."""
    from repro_torch.models import init_model
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    rng = np.random.default_rng(seed + 3)
    cfg = _serve_config()
    model = init_model(cfg, seed, device=DEVICE)
    check(cfg.n_layers == 30 and cfg.d_model == 576
          and model.embed.table.dtype == torch.bfloat16,
          f"serving {cfg.name} with {cfg.n_layers} layers")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve {cfg.name}: {n_params} parameters (param_count "
          f"{cfg.param_count()}), {cfg.param_dtype} weights, "
          f"{cfg.compute_dtype} compute, kv_repeat={cfg.kv_repeat}",
          flush=True)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SERVE_B, SERVE_S))).to(DEVICE)
    greedy_generate(model, cfg, prompts[:, :64], max_new=2, device=DEVICE)

    # (a) the main path through the kernel
    logits, out, ttft, tok_s, wall, launches = _generate(model, cfg, prompts,
                                                         new=EARLY_NEW)
    check(launches["flash_attention"] == cfg.n_layers,
          f"the prefill launched flash_attention "
          f"{launches['flash_attention']} times, want {cfg.n_layers} (one "
          f"prefill)")
    check(tuple(out.shape) == (SERVE_B, EARLY_NEW)
          and bool(torch.isfinite(logits).all()),
          f"greedy_generate gave {tuple(out.shape)}")
    print(f"serve (a) B={SERVE_B} S={SERVE_S} new={EARLY_NEW}: "
          f"ttft_s={ttft:.6f} decode_tok_per_s={tok_s:.3f} "
          f"greedy_generate_wall_s={wall:.6f} launches={launches}",
          flush=True)

    # (b) the same model with the plain prefill attention
    with _plain_prefill_attention():
        p_logits, p_out, p_ttft, _, _, p_launches = _generate(
            model, cfg, prompts, new=EARLY_NEW, timed=False)
    check(p_launches["flash_attention"] == 0,
          "the plain prefill launched the kernel")
    err = float((logits - p_logits).abs().max())
    agree = float((out == p_out).float().mean())
    print(f"serve (b) bf16 kernel vs plain prefill attention: logits "
          f"max_abs_err={err:.6g} greedy_agreement={agree:.6f} "
          f"plain ttft_s={p_ttft:.6f}", flush=True)
    check(err <= LOGITS_ATOL[torch.bfloat16],
          f"bf16 prefill logits differ by {err}")

    # (c) f32 at 4 layers
    cfg32 = _serve_config(param_dtype="float32", compute_dtype="float32",
                          n_layers=F32_LAYERS)
    m32 = init_model(cfg32, seed, device=DEVICE)
    l32, o32, _, _, _, k32 = _generate(m32, cfg32, prompts, new=EARLY_NEW,
                                       timed=False)
    check(k32["flash_attention"] == F32_LAYERS,
          f"f32 prefill launched {k32}")
    with _plain_prefill_attention():
        pl32, po32, _, _, _, _ = _generate(m32, cfg32, prompts,
                                           new=EARLY_NEW, timed=False)
    err32 = float((l32 - pl32).abs().max())
    agree32 = float((o32 == po32).float().mean())
    print(f"serve (c) f32, {F32_LAYERS} layers, kernel vs plain: logits "
          f"max_abs_err={err32:.6g} greedy_agreement={agree32:.6f}",
          flush=True)
    check(err32 <= LOGITS_ATOL[torch.float32] and agree32 >= AGREE_F32,
          f"f32 serving: logits differ by {err32}, agreement {agree32}")
    _int8_card_vs_cpu("serve (c)", m32, cfg32, prompts[:SSM_F32_B])
    del m32

    # (d) the continuous batcher
    _batcher_run("serve (d)", cfg, model, rng)

    # (e) where a prefill's and a decode step's device time goes
    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    decode = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model,
                                                   {"tokens": prompts})

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode(model, state["caches"], {"tokens": tok}, SERVE_S)

    for what, fn, wall in (("prefill", run_prefill, ttft),
                           ("decode step", run_decode, SERVE_B / tok_s)):
        split = _device_split(f"serve (e) {what}", fn)
        busy = (None if split["other_ms"] is None
                else sum(split.values()) / 1e3 / wall)
        print(f"serve (e) one B={SERVE_B} S={SERVE_S} {what}, device time "
              f"(torch.profiler): " +
              " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                       for k, v in split.items()) +
              f"; device busy share of its wall time "
              f"({wall:.6f} s, unprofiled): "
              f"{'not measured' if busy is None else f'{busy:.4f}'}",
              flush=True)
    return launches


def _on_cpu(model, cfg):
    """A copy of ``model`` on the CPU (the same weights)."""
    from repro_torch.models import Model

    cpu = Model(cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def _int8_flips(got: dict, want: dict, layer=None) -> tuple:
    """(codes that differ, codes, largest difference) between two int8
    caches' code tensors: every layer's, or ``layer`` of the first
    stack."""
    n_diff, n_codes, worst = 0, 0, 0
    for key, stack in want.items():
        for n, c in stack.items():
            if c.dtype != torch.int8:
                continue
            g = got[key][n]
            if layer is not None:
                c, g = c[layer], g[layer]
            d = (g.int() - c.int()).abs()
            n_diff += int((d != 0).sum())
            n_codes += d.numel()
            worst = max(worst, int(d.max()))
        if layer is not None:
            break
    return n_diff, n_codes, worst


def _int8_card_vs_cpu(what: str, model, cfg, prompts) -> None:
    """The f32 ``model`` on the int8 KV cache (``kv_cache_quant``), on the
    card and on a CPU copy.  Quantising is discontinuous: a code flips by
    one where x / scale lies within the devices' f32 error of .5, which
    moves that cached value by a whole quantum (1/127 of its row's
    largest), the next layers' inputs by about 1e-3 and so their codes
    by one far more often (and a token that changes experts, by more).
    So the write is held where both devices see the same input, the
    first layer: its codes equal except at most INT8_FLIPS of them, each
    one apart; the read is held on the same codes: one decode step from
    the card's cache after a prefill of ``prompts``, and from a CPU copy
    of it, logits within 1e-3; ``greedy_generate`` for SSM_F32_NEW tokens
    agrees on at least 0.99; the free-running prefill logits and the
    codes of the whole cache are printed."""
    from repro_torch.models import decode_step
    from repro_torch.serve import greedy_generate, make_prefill_step

    cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    cpu = _on_cpu(model, cfg)
    S = prompts.shape[1]
    max_len = S + SSM_F32_NEW
    t0 = time.perf_counter()
    with torch.no_grad():
        card, caches = make_prefill_step(cfg, max_len, device=DEVICE)(
            model, {"tokens": prompts.to(DEVICE)})
        want, cpu_caches = make_prefill_step(cfg, max_len, device="cpu")(
            cpu, {"tokens": prompts.cpu()})
        same = {key: {n: c.cpu() for n, c in stack.items()}
                for key, stack in caches.items()}
        first, every = _int8_flips(same, cpu_caches, 0), \
            _int8_flips(same, cpu_caches)
        tok = torch.argmax(card[:, -1], dim=-1)[:, None]
        step_card, _ = decode_step(model, cfg, {"tokens": tok}, caches,
                                   cache_index=S)
        step_cpu, _ = decode_step(cpu, cfg, {"tokens": tok.cpu()}, same,
                                  cache_index=S)
        card_out = greedy_generate(model, cfg, prompts.to(DEVICE),
                                   max_new=SSM_F32_NEW, device=DEVICE)
        cpu_out = greedy_generate(cpu, cfg, prompts.cpu(),
                                  max_new=SSM_F32_NEW, device="cpu")
    step_err = float((step_card.cpu() - step_cpu).abs().max())
    free_err = float((card.cpu() - want).abs().max())
    agree = float((card_out.cpu() == cpu_out).float().mean())
    codes = {n: str(c.dtype).split(".")[-1]
             for n, c in next(iter(caches.values())).items()}
    print(f"{what} f32 on the int8 KV cache {codes}, B={prompts.shape[0]}: "
          f"first layer's codes card vs CPU differing {first[0]} of "
          f"{first[1]} (largest difference {first[2]}); one decode step "
          f"from the same codes: logits max_abs_err={step_err:.6g}; "
          f"greedy_agreement={agree:.6f} over {SSM_F32_NEW} tokens; "
          f"free-running: prefill logits max_abs_err={free_err:.6g}, codes "
          f"of every layer differing {every[0]} of {every[1]} (largest "
          f"difference {every[2]}) ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(first[2] <= 1 and first[0] <= INT8_FLIPS * first[1],
          f"{what} first layer's int8 codes card vs CPU: {first[0]} of "
          f"{first[1]} differ, by up to {first[2]}")
    check(step_err <= LOGITS_ATOL[torch.float32] and agree >= AGREE_F32,
          f"{what} int8 cache card vs CPU: a decode step from the same "
          f"codes differs by {step_err}, greedy agreement {agree}")


# ------------------------------------------------------------- MoE serving
def _moe_config(**kw):
    return _arch_config(MOE_ARCH, **kw)


def _free_card(what: str) -> None:
    """Drop what the last phase left on the card, and print the card's
    free memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{what}: card memory before the init (torch.cuda.mem_get_info)"
          f": free_bytes={free} total_bytes={total}; allocated_bytes="
          f"{torch.cuda.memory_allocated()}", flush=True)


def _init_on_card(cfg, seed: int):
    """The model's random weights drawn on the card from a CUDA generator
    seeded with ``seed`` (a host draw of 30.5 G parameters takes minutes)."""
    from repro_torch.models import init_model

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return init_model(cfg, gen, device=DEVICE)


class _Routing:
    """A test-only patch: records the expert choice ``idx`` [T, k] of each
    routing the MoE layers make, in call order (one per layer of a
    prefill)."""

    def __enter__(self):
        from unittest import mock

        from repro_torch.models import moe

        self.idx, real = [], moe.route

        def route(logits, cfg, **kw):
            plan = real(logits, cfg, **kw)
            self.idx.append(plan["idx"].clone())
            return plan

        self._patch = mock.patch.object(moe, "route", route)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def _sdpa_prefill_attention():
    """A test-only patch, as ``_plain_prefill_attention``: the attention
    module's kernel entry replaced by ``scaled_dot_product_attention``
    (the library's, which the port never calls), for a control."""
    from unittest import mock

    from repro_torch.models import attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    return mock.patch.object(
        attention, "flash_attention_op",
        lambda q, k, v, causal=True: sdpa(q, k, v, is_causal=causal,
                                          enable_gqa=True))


class _TeacherForced:
    """A test-only patch of ``zoo.block_apply``: each layer of a prefill
    runs first with the plain attention, then as it is, both from the same
    input ``h``; the layer's routings under either attention and the
    largest difference of its two outputs are kept, and the second output
    goes on.  (Both runs write the same k and v into the cache: they come
    from the same ``h``.)"""

    def __enter__(self):
        from unittest import mock

        from repro_torch.models import zoo

        self.kernel, self.plain, self.out_err = [], [], []
        real = zoo.block_apply

        def block_apply(p, h, cfg, kind, **kw):
            with _plain_prefill_attention(), _Routing() as plain:
                h_plain, _ = real(p, h, cfg, kind, **kw)
            with _Routing() as kernel:
                h_out, cache = real(p, h, cfg, kind, **kw)
            self.plain += plain.idx
            self.kernel += kernel.idx
            self.out_err.append(float((h_out.float() - h_plain.float())
                                      .abs().max()))
            return h_out, cache

        self._patch = mock.patch.object(zoo, "block_apply", block_apply)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def _routing_agreement(first: list, second: list) -> list:
    """Per layer, the share of ``first``'s (token, slot) assignments whose
    expert is among ``second``'s top k for that token."""
    shares = []
    for a, b in zip(first, second):
        hit = (a[:, :, None] == b[:, None, :]).any(-1)
        shares.append(float(hit.float().mean()))
    return shares


def _ranged_split(fn, ranges: dict) -> dict:
    """Device time of ``fn()`` from the profiler, with the kernels that
    each named range of ``ranges`` ({name: [(module, function name),
    ...]}) launched charged to it: each function is wrapped in a
    ``record_function`` range of that name (a test-only patch) and each
    kernel is charged to the range of the operator that launched it.  The
    wrapper synchronises after each call, so the launch queue never
    fills: a launch that waits on a full queue shows as a "Command Buffer
    Full" event, and in a falcon-mamba-7b prefill the ranges were then
    charged more than the whole device time.
    Returns the total, ``flash_attention`` and matmul ms, per range the ms
    of all its kernels (``all_in``) and of its matmul kernels
    (``matmul_in``), and by name the kernels neither attention nor matmul
    (``others``) and those of each range (``inside``)."""
    import contextlib
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def call(*args, **kw):
            with record_function(name):
                out = f(*args, **kw)
            torch.cuda.synchronize()
            return out
        return call

    with contextlib.ExitStack() as stack:
        for name, targets in ranges.items():
            for module, attr in targets:
                stack.enter_context(mock.patch.object(
                    module, attr, ranged(name, getattr(module, attr))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()

    out = {"total": 0.0, "flash": 0.0, "matmul": 0.0, "others": {},
           "all_in": dict.fromkeys(ranges, 0.0),
           "matmul_in": dict.fromkeys(ranges, 0.0),
           "inside": {name: {} for name in ranges}}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue
        ms = evt.device_time_total / 1e3
        out["total"] += ms
        if "flash_attention" in evt.name.lower():
            out["flash"] += ms
        elif _is_matmul(evt.name):
            out["matmul"] += ms
        else:
            key = evt.name[:60]
            out["others"][key] = out["others"].get(key, 0.0) + ms
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        up = evt
        while up is not None and up.name not in ranges:
            up = up.cpu_parent
        if up is None:
            continue
        for kern in evt.kernels:
            ms = kern.duration / 1e3
            out["all_in"][up.name] += ms
            if _is_matmul(kern.name):
                out["matmul_in"][up.name] += ms
            inside = out["inside"][up.name]
            key = f"{evt.name} {kern.name[:40]}"
            inside[key] = inside.get(key, 0.0) + ms
    charged = sum(out["all_in"].values())
    check(charged <= out["total"] * 1.001,
          f"profiler ranges charged {charged} ms of {out['total']} ms")
    return out


def _moe_device_split(what: str, fn) -> dict:
    """Device time of ``fn()`` by kind: ``flash_attention``, the expert
    GEMMs (matmul kernels under ``moe.experts_apply``), the dispatch
    (``moe.route``, ``dispatch`` and ``combine``: softmax, the sort, the
    one-hot cumsum, the scatter and gather, the weighted sum), the other
    matmuls, and the rest; None where the profiler recorded no device
    time (:func:`_ranged_split`)."""
    from repro_torch.models import moe

    dispatch, experts = "moe.dispatch", "moe.experts"
    r = _ranged_split(fn, {
        dispatch: [(moe, n) for n in ("route", "dispatch", "combine")],
        experts: [(moe, "experts_apply")]})
    _print_top(what, "dispatch", r["inside"][dispatch])
    _print_top(what, "non-matmul", r["others"])
    if r["total"] == 0.0:
        return dict.fromkeys(("flash_attention_ms", "expert_bmm_ms",
                              "other_matmul_ms", "dispatch_ms", "rest_ms"))
    split = {"flash_attention_ms": r["flash"],
             "expert_bmm_ms": r["matmul_in"][experts],
             "other_matmul_ms": r["matmul"] - r["matmul_in"][experts],
             "dispatch_ms": r["all_in"][dispatch]}
    split["rest_ms"] = r["total"] - sum(split.values())
    return split


def moe_serve_phase(seed: int) -> int:
    """The MoE family served at full width; returns the launches of the
    main path's ``greedy_generate``."""
    import gc

    from repro_torch.models import zoo
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    _free_card("moe serve")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    cfg = _moe_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _init_on_card(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want_params = zoo.analytic_param_count(cfg)
    moe0 = model.layers[0].moe
    check(cfg.n_layers == 48 and cfg.d_model == 2048 and len(model.layers)
          == 48 and moe0.w_gate.shape[0] == cfg.moe.n_routed == 128
          and n_params == want_params
          and moe0.w_down.dtype == torch.bfloat16
          and moe0.w_down.device.type == "cuda",
          f"serving {cfg.name}: {len(model.layers)} layers, {n_params} "
          f"parameters (analytic {want_params})")
    print(f"moe serve {cfg.name}: {n_params} parameters (analytic_param_count"
          f" {want_params}, active {zoo.analytic_param_count(cfg, True)}), "
          f"{cfg.n_layers} layers, {cfg.moe.n_routed} experts top "
          f"{cfg.moe.top_k}, {cfg.param_dtype} weights drawn on the card in "
          f"init_s={init_s:.3f}; allocated_bytes="
          f"{torch.cuda.memory_allocated()}", flush=True)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SERVE_B, SERVE_S))).to(DEVICE)
    greedy_generate(model, cfg, prompts[:, :64], max_new=2, device=DEVICE)

    # (a) the main path through the kernel
    logits, out, ttft, tok_s, wall, launches = _generate(model, cfg, prompts,
                                                         new=EARLY_NEW)
    check(launches["flash_attention"] == cfg.n_layers,
          f"moe prefill launched flash_attention "
          f"{launches['flash_attention']} times, want {cfg.n_layers} (one "
          f"prefill)")
    check(tuple(out.shape) == (SERVE_B, EARLY_NEW)
          and bool(torch.isfinite(logits).all()),
          f"moe greedy_generate gave {tuple(out.shape)}")
    print(f"moe serve (a) B={SERVE_B} S={SERVE_S} new={EARLY_NEW}: "
          f"ttft_s={ttft:.6f} decode_tok_per_s={tok_s:.3f} "
          f"greedy_generate_wall_s={wall:.6f} launches={launches}",
          flush=True)

    # (b) the same weights with the plain prefill attention
    with _plain_prefill_attention():
        p_logits, p_out, p_ttft, _, _, p_launches = _generate(
            model, cfg, prompts, new=EARLY_NEW, timed=False)
    check(p_launches["flash_attention"] == 0,
          "the plain prefill launched the kernel")
    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    with torch.no_grad():
        with _Routing() as kernel_routes:
            prefill(model, {"tokens": prompts})
        with _plain_prefill_attention(), _Routing() as plain_routes:
            prefill(model, {"tokens": prompts})
        with _sdpa_prefill_attention(), _Routing() as sdpa_routes:
            prefill(model, {"tokens": prompts})
        with _TeacherForced() as forced:
            prefill(model, {"tokens": prompts})
    free_run = _routing_agreement(kernel_routes.idx, plain_routes.idx)
    control = _routing_agreement(sdpa_routes.idx, plain_routes.idx)
    shares = _routing_agreement(forced.kernel, forced.plain)
    err = float((logits - p_logits).abs().max())
    agree = float((out == p_out).float().mean())

    def layers(x):
        return (f"min={min(x):.6f} mean={float(np.mean(x)):.6f} "
                f"{[round(v, 6) for v in x]}")

    print(f"moe serve (b) bf16 kernel vs plain prefill attention, same "
          f"weights: last-position logits max_abs_err={err:.6g} "
          f"greedy_agreement={agree:.6f} plain ttft_s={p_ttft:.6f}; routing "
          f"agreement per layer, each layer from the same input "
          f"(teacher-forced): {layers(shares)}; that layer's output "
          f"max_abs_diff={max(forced.out_err):.6g}", flush=True)
    print(f"moe serve (b) free-running routing agreement per layer, kernel "
          f"vs plain: {layers(free_run)}; SDPA (enable_gqa) vs plain, the "
          f"same measure for another correct bf16 attention: "
          f"{layers(control)}", flush=True)
    check(len(shares) == cfg.n_layers and min(shares) >= AGREE_ROUTING,
          f"moe prefill routing agreement {min(shares)} < {AGREE_ROUTING}")
    check(bool(torch.isfinite(p_logits).all()), "plain logits not finite")

    # (d) the continuous batcher
    _batcher_run("moe serve (d)", cfg, model, rng)

    # (e) where a prefill's and a decode step's device time goes
    decode = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model,
                                                   {"tokens": prompts})

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode(model, state["caches"], {"tokens": tok}, SERVE_S)

    with torch.no_grad():
        for what, fn, wall_s in (("prefill", run_prefill, ttft),
                                 ("decode step", run_decode,
                                  SERVE_B / tok_s)):
            split = _moe_device_split(f"moe serve (e) {what}", fn)
            measured = split["rest_ms"] is not None
            busy = sum(split.values()) / 1e3 / wall_s if measured else None
            print(f"moe serve (e) one B={SERVE_B} S={SERVE_S} {what}, "
                  f"device time (torch.profiler): " +
                  " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                           for k, v in split.items()) +
                  f"; device busy share of its wall time ({wall_s:.6f} s, "
                  f"unprofiled): "
                  f"{'not measured' if busy is None else f'{busy:.4f}'}",
                  flush=True)
    peak = torch.cuda.max_memory_allocated()
    del model, state, prefill, decode, moe0
    gc.collect()
    torch.cuda.empty_cache()

    # (c) f32 at 4 layers, full width otherwise
    cfg32 = _moe_config(param_dtype="float32", compute_dtype="float32",
                        n_layers=F32_LAYERS)
    m32 = _init_on_card(cfg32, seed)
    l32, o32, _, _, _, k32 = _generate(m32, cfg32, prompts, new=EARLY_NEW,
                                       timed=False)
    check(k32["flash_attention"] == F32_LAYERS,
          f"f32 moe prefill launched {k32}")
    with _plain_prefill_attention():
        pl32, po32, _, _, _, _ = _generate(m32, cfg32, prompts,
                                           new=EARLY_NEW, timed=False)
    err32 = float((l32 - pl32).abs().max())
    agree32 = float((o32 == po32).float().mean())
    print(f"moe serve (c) f32, {F32_LAYERS} layers, kernel vs plain: logits "
          f"max_abs_err={err32:.6g} greedy_agreement={agree32:.6f}",
          flush=True)
    check(err32 <= LOGITS_ATOL[torch.float32] and agree32 >= AGREE_F32,
          f"f32 moe serving: logits differ by {err32}, agreement {agree32}")
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe serve: peak_memory_bytes (max_memory_allocated, bf16 model "
          f"through (e))={peak}; after (c): "
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    return launches["flash_attention"]


# ------------------------------------------------ SSM and hybrid serving
class _AttentionBesidePlain:
    """A test-only patch: every full-sequence attention of the model runs
    the kernel and, on the same q, k and v, the plain version and SDPA (a
    control); kept for each call: the largest |kernel - plain| (``errs``)
    and |SDPA - plain| (``sdpa_errs``), the plain output's largest |o|
    (``mags``), the largest |kernel - plain| over the larger of the
    dtype's FLASH_TOL and one ulp of the plain output at that element
    (``over``: at most 1 where every element is within the tolerance, or
    within one rounding step of the plain value where that step is
    coarser), and the call's (causal, S, Skv); the kernel's output goes
    on."""

    def __enter__(self):
        from unittest import mock

        from repro_torch.kernels.flash_attention import attention_ref
        from repro_torch.models import attention

        sdpa = torch.nn.functional.scaled_dot_product_attention
        self.errs, self.calls, self.sdpa_errs = [], [], []
        self.mags, self.over = [], []
        real = attention.flash_attention_op

        def op(q, k, v, causal=True):
            got = real(q, k, v, causal=causal)
            want = attention_ref(q, k, v, causal=causal).float()
            err = (got.float() - want).abs()
            self.errs.append(float(err.max()))
            self.sdpa_errs.append(float((sdpa(
                q, k, v, is_causal=causal, enable_gqa=True).float()
                - want).abs().max()))
            self.mags.append(float(want.abs().max()))
            self.over.append(float((err / torch.clamp(
                _ulp(want, got.dtype), min=FLASH_TOL[got.dtype])).max()))
            self.calls.append((bool(causal), q.shape[2], k.shape[2]))
            return got

        self._patch = mock.patch.object(attention, "flash_attention_op", op)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class _CodecBesidePlain:
    """A test-only patch of the encoder's ``dct_quant_op`` and
    ``idct_dequant_op``: the first call of each (kernel, intra, N) also
    runs the kernel's plain version on the same input; kept: the outputs
    that differ from it (``diffs``, by that key; both round as their plain
    versions do, so none may); the kernel's output goes on."""

    def __enter__(self):
        from unittest import mock

        from repro_torch.kernels.dct import dct_quant_ref
        from repro_torch.kernels.dct import ops as dct_ops
        from repro_torch.kernels.idct import idct_dequant_ref
        from repro_torch.kernels.idct import ops as idct_ops

        self.diffs, self._patches = {}, []
        for mod, name, plain in ((dct_ops, "dct_quant_op", dct_quant_ref),
                                 (idct_ops, "idct_dequant_op",
                                  idct_dequant_ref)):
            def op(x, *, qp, intra, real=getattr(mod, name), plain=plain,
                   name=name):
                got = real(x, qp=qp, intra=intra)
                key = (name, bool(intra), x.shape[0])
                if key not in self.diffs:
                    self.diffs[key] = int((got != plain(x, qp, intra)).sum())
                return got

            self._patches.append(mock.patch.object(mod, name, op))
            self._patches[-1].start()
        return self

    def __exit__(self, *exc):
        for patch in self._patches:
            patch.stop()


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at each |x| (x in f32): 2^(e - 1) eps for
    |x| in [2^(e - 1), 2^e)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.full_like(x, torch.finfo(dtype).eps), e - 1)


def _ssm_device_split(what: str, fn) -> dict:
    """Device time of ``fn()`` by kind: ``flash_attention``, the scan (every
    kernel under ``ssm._mamba1_scan`` or ``ssm._ssd_chunked``: the chunk
    loops, their einsums included), the other matmuls and the rest (the
    discretisation ``exp(dt A)`` and ``dt B x``, the convs, norms, gates,
    casts); None where the profiler recorded no device time."""
    from repro_torch.models import ssm

    scan = "ssm.scan"
    r = _ranged_split(fn, {scan: [(ssm, "_mamba1_scan"),
                                  (ssm, "_ssd_chunked")]})
    _print_top(what, "scan", r["inside"][scan])
    _print_top(what, "non-matmul", r["others"])
    if r["total"] == 0.0:
        return dict.fromkeys(("flash_attention_ms", "scan_ms",
                              "other_matmul_ms", "rest_ms"))
    split = {"flash_attention_ms": r["flash"], "scan_ms": r["all_in"][scan],
             "other_matmul_ms": r["matmul"] - r["matmul_in"][scan]}
    split["rest_ms"] = r["total"] - sum(split.values())
    return split


def _ssm_f32_card_vs_cpu(arch: str, seed: int, rng) -> None:
    """(c): f32 at ``SSM_F32_LAYERS`` layers, full width otherwise, the
    same weights on the card and on the CPU: a prefill of SSM_F32_B x 512
    tokens' logits within 1e-3, greedy agreement over SSM_F32_NEW tokens
    at least 0.99; and on the card a prefill of 512 tokens (two chunks of
    256) and one decode step against a prefill of 513 (one chunk)."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.serve import greedy_generate, make_prefill_step

    cfg = _arch_config(arch, param_dtype="float32", compute_dtype="float32",
                      n_layers=SSM_F32_LAYERS[arch])
    model = _init_on_card(cfg, seed)
    cpu = _on_cpu(model, cfg)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SSM_F32_B, SERVE_S + 1)))
    head = prompts[:, :SERVE_S]
    max_len = SERVE_S + SSM_F32_NEW
    t0 = time.perf_counter()
    with torch.no_grad():
        card, _ = make_prefill_step(cfg, max_len, device=DEVICE)(
            model, {"tokens": head.to(DEVICE)})
        want, _ = make_prefill_step(cfg, max_len, device="cpu")(
            cpu, {"tokens": head})
        card_out = greedy_generate(model, cfg, head.to(DEVICE),
                                   max_new=SSM_F32_NEW, device=DEVICE)
        cpu_out = greedy_generate(cpu, cfg, head, max_new=SSM_F32_NEW,
                                  device="cpu")
        caches = init_cache(cfg, SSM_F32_B, SERVE_S + 8, device=DEVICE)
        p = prompts.to(DEVICE)
        decode_step(model, cfg, {"tokens": p[:, :SERVE_S]}, caches,
                    cache_index=0)
        stepped, _ = decode_step(model, cfg, {"tokens": p[:, SERVE_S:]},
                                 caches, cache_index=SERVE_S)
        whole, _ = decode_step(model, cfg, {"tokens": p},
                               init_cache(cfg, SSM_F32_B, SERVE_S + 8,
                                          device=DEVICE), cache_index=0)
    err = float((card.cpu() - want).abs().max())
    agree = float((card_out.cpu() == cpu_out).float().mean())
    chunk_err = float((stepped - whole).abs().max())
    print(f"ssm serve {arch} (c) f32, {cfg.n_layers} layers, B="
          f"{SSM_F32_B}: card vs CPU prefill logits max_abs_err={err:.6g}, "
          f"greedy_agreement={agree:.6f} over {SSM_F32_NEW} tokens; on the "
          f"card prefill({SERVE_S}) + one decode step vs prefill("
          f"{SERVE_S + 1}) logits max_abs_err={chunk_err:.6g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(err <= LOGITS_ATOL[torch.float32] and agree >= AGREE_F32,
          f"f32 {arch} card vs CPU: logits differ by {err}, agreement "
          f"{agree}")
    check(chunk_err <= LOGITS_ATOL[torch.float32],
          f"f32 {arch}: prefill + decode vs the longer prefill differ by "
          f"{chunk_err}")


def _ssm_serve_one(arch: str, seed: int, beside_c=()) -> int:
    """One SSM or hybrid model served at full width; returns the
    ``flash_attention`` launches of its prefill.  The ``_Launcher``
    arguments of ``beside_c`` run beside its f32 check (c)."""
    from repro_torch.models import zoo
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    label = f"ssm serve {arch}"
    _free_card(label)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    cfg = _arch_config(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _init_on_card(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want_params, depth = SSM_PUBLISHED[arch]
    sites = zoo._hybrid_sites(cfg)[0] if cfg.family == "hybrid" else 0
    emb = model.embed.table
    check(cfg.n_layers == len(model.layers) == depth
          and n_params == zoo.analytic_param_count(cfg) == want_params
          and emb.dtype == torch.bfloat16
          and emb.device.type == torch.device(DEVICE).type,
          f"serving {cfg.name}: {len(model.layers)} layers, {n_params} "
          f"parameters")
    print(f"{label}: {n_params} parameters (analytic_param_count), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.ssm.kind}, "
          f"{sites} shared-attention sites, {cfg.param_dtype} weights "
          f"drawn on the card in init_s={init_s:.3f}; allocated_bytes="
          f"{torch.cuda.memory_allocated()}", flush=True)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SERVE_B, SERVE_S))).to(DEVICE)
    greedy_generate(model, cfg, prompts[:, :64], max_new=2, device=DEVICE)

    # (a) the main path
    logits, out, ttft, tok_s, wall, launches = _generate(model, cfg, prompts,
                                                         new=EARLY_NEW)
    check(launches["flash_attention"] == sites,
          f"{arch} prefill launched flash_attention "
          f"{launches['flash_attention']} times, want {sites} (one prefill)")
    check(tuple(out.shape) == (SERVE_B, EARLY_NEW)
          and bool(torch.isfinite(logits).all()),
          f"{arch} greedy_generate gave {tuple(out.shape)}")
    print(f"{label} (a) B={SERVE_B} S={SERVE_S} new={EARLY_NEW}: "
          f"ttft_s={ttft:.6f} decode_tok_per_s={tok_s:.3f} "
          f"greedy_generate_wall_s={wall:.6f} launches={launches}",
          flush=True)

    # (b) the same weights with the plain prefill attention; SDPA's
    # prefill against the plain one as a control; each site's kernel
    # output against the plain attention on the same q, k, v
    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    if sites:
        with _plain_prefill_attention():
            p_logits, p_out, p_ttft, _, _, p_launches = _generate(
                model, cfg, prompts, new=EARLY_NEW, timed=False)
        with torch.no_grad():
            with _sdpa_prefill_attention():
                s_logits, _ = prefill(model, {"tokens": prompts})
            with _AttentionBesidePlain() as forced:
                prefill(model, {"tokens": prompts})
        check(p_launches["flash_attention"] == 0,
              "the plain prefill launched the kernel")
        err = float((logits - p_logits).abs().max())
        agree = float((out == p_out).float().mean())
        s_err = float((s_logits - p_logits).abs().max())
        print(f"{label} (b) bf16 kernel vs plain prefill attention, same "
              f"weights: last-position logits max_abs_err={err:.6g} "
              f"greedy_agreement={agree:.6f} plain ttft_s={p_ttft:.6f}; "
              f"SDPA vs plain (control): max_abs_err={s_err:.6g}; each "
              f"site's attention output vs plain on the same q, k, v: "
              f"{[round(e, 6) for e in forced.errs]}", flush=True)
        check(len(forced.errs) == sites
              and max(forced.errs) <= FLASH_TOL[torch.bfloat16],
              f"{arch} prefill attention vs plain at the sites: "
              f"{forced.errs}")
        check(err <= max(LOGITS_ATOL[torch.bfloat16], SDPA_FACTOR * s_err),
              f"{arch} bf16 prefill logits differ by {err} (SDPA: {s_err})")

    # (d) the continuous batcher, a request repeated in the second wave
    _batcher_run(f"{label} (d)", cfg, model, rng, per_wave=sites,
                 repeat=True)

    # (e) where a prefill's and a decode step's device time goes
    decode = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model,
                                                   {"tokens": prompts})

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode(model, state["caches"], {"tokens": tok}, SERVE_S)

    with torch.no_grad():
        for what, fn, wall_s in (("prefill", run_prefill, ttft),
                                 ("decode step", run_decode,
                                  SERVE_B / tok_s)):
            split = _ssm_device_split(f"{label} (e) {what}", fn)
            measured = split["rest_ms"] is not None
            busy = sum(split.values()) / 1e3 / wall_s if measured else None
            print(f"{label} (e) one B={SERVE_B} S={SERVE_S} {what}, device "
                  f"time (torch.profiler): " +
                  " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                           for k, v in split.items()) +
                  f"; device busy share of its wall time ({wall_s:.6f} s, "
                  f"unprofiled): "
                  f"{'not measured' if busy is None else f'{busy:.4f}'}",
                  flush=True)
    print(f"{label}: peak_memory_bytes (max_memory_allocated, bf16 model "
          f"through (e))={torch.cuda.max_memory_allocated()}", flush=True)
    del model, state, prefill, decode, emb
    _free_card(f"{label} (c)")
    launchers = [_Launcher(*a) for a in beside_c]
    _ssm_f32_card_vs_cpu(arch, seed, rng)
    for launcher in launchers:
        launcher.finish()
    return launches["flash_attention"]


def ssm_serve_phase(seed: int) -> int:
    """The SSM and hybrid families served at full width and depth, after
    the MoE weights are freed; returns zamba2's ``greedy_generate``
    launches of ``flash_attention``."""
    zamba2, falcon = SSM_ARCHS
    first = _ssm_serve_one(zamba2, seed)
    # (f) python -m repro_torch.launch.serve --arch zamba2-1.2b --device
    # cuda exits 0, beside falcon's f32 check
    _ssm_serve_one(falcon, seed, beside_c=[(
        "ssm serve (f)", "repro_torch.launch.serve", "--arch", zamba2,
        "--device", DEVICE)])
    return first


# ---------------------------------------------------------------- MLA serving
def _mla_f32_card_vs_cpu(seed: int, rng) -> None:
    """(c) and the f32 half of (d): f32 at MLA_F32_LAYERS layers (the
    dense layer and a MoE layer), full width otherwise, the same weights on
    the card and on the CPU (B=SSM_F32_B): prefill logits within 1e-3,
    greedy agreement over SSM_F32_NEW tokens at least 0.99; on each
    device a prefill of 512 tokens and one absorbed decode step against
    a prefill of 513 (K and V materialised from the latent); and on the
    int8 cache, card against CPU.  The absorbed check runs the same
    weights at a capacity factor of n_routed / top_k, where no expert
    drops a token: at 1.25 a decode step's 2 tokens get a capacity of 1
    per expert and a prefill's 1,026 get 121, so the two drop different
    tokens and differ by more than any attention error (0.69 at a narrow
    width on the CPU)."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.serve import greedy_generate, make_prefill_step

    cfg = _arch_config(MLA_ARCH, param_dtype="float32",
                       compute_dtype="float32", n_layers=MLA_F32_LAYERS)
    model = _init_on_card(cfg, seed)
    cpu = _on_cpu(model, cfg)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SSM_F32_B, SERVE_S + 1)))
    head = prompts[:, :SERVE_S]
    max_len = SERVE_S + SSM_F32_NEW
    t0 = time.perf_counter()
    absorbed = {}
    with torch.no_grad():
        reset_counts()
        card, _ = make_prefill_step(cfg, max_len, device=DEVICE)(
            model, {"tokens": head.to(DEVICE)})
        torch.cuda.synchronize()
        launches = read_counts()["flash_attention"]
        want, _ = make_prefill_step(cfg, max_len, device="cpu")(
            cpu, {"tokens": head})
        card_out = greedy_generate(model, cfg, head.to(DEVICE),
                                   max_new=SSM_F32_NEW, device=DEVICE)
        cpu_out = greedy_generate(cpu, cfg, head, max_new=SSM_F32_NEW,
                                  device="cpu")
        moe = cfg.moe
        ncfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_routed / moe.top_k))
        for dev, m in ((DEVICE, model), ("cpu", cpu)):
            p = prompts.to(dev)
            caches = init_cache(ncfg, SSM_F32_B, SERVE_S + 8, device=dev)
            decode_step(m, ncfg, {"tokens": p[:, :SERVE_S]}, caches,
                        cache_index=0)
            stepped, _ = decode_step(m, ncfg, {"tokens": p[:, SERVE_S:]},
                                     caches, cache_index=SERVE_S)
            whole, _ = decode_step(m, ncfg, {"tokens": p},
                                   init_cache(ncfg, SSM_F32_B, SERVE_S + 8,
                                              device=dev), cache_index=0)
            absorbed[str(dev)] = float((stepped - whole).abs().max())
    err = float((card.cpu() - want).abs().max())
    agree = float((card_out.cpu() == cpu_out).float().mean())
    print(f"mla serve (c) f32, {cfg.n_layers} layers, B={SSM_F32_B}: card "
          f"vs CPU prefill logits max_abs_err={err:.6g}, greedy_agreement="
          f"{agree:.6f} over {SSM_F32_NEW} tokens, prefill launches="
          f"{launches}; at capacity factor {ncfg.moe.capacity_factor:.4f}"
          f" (no drops) prefill({SERVE_S}) + one absorbed decode step vs "
          f"prefill({SERVE_S + 1}) logits max_abs_err: card "
          f"{absorbed[str(DEVICE)]:.6g}, CPU {absorbed['cpu']:.6g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(launches == cfg.n_layers,
          f"f32 mla prefill launched flash_attention {launches} times")
    check(err <= LOGITS_ATOL[torch.float32] and agree >= AGREE_F32,
          f"f32 mla card vs CPU: logits differ by {err}, agreement {agree}")
    check(max(absorbed.values()) <= LOGITS_ATOL[torch.float32],
          f"f32 mla: prefill + absorbed decode vs the longer prefill differ "
          f"by {absorbed}")
    del cpu
    _int8_card_vs_cpu("mla serve (d)", model, cfg, head)


def mla_serve_phase(seed: int) -> int:
    """The MLA family served at full width and depth, after the SSM
    weights are freed; returns the launches of the main path's
    ``greedy_generate``."""
    import gc

    from repro_torch.models import zoo
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    label = "mla serve"
    _free_card(label)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    cfg = _arch_config(MLA_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _init_on_card(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want_params, depth = MLA_PUBLISHED
    m = cfg.mla
    attn = model.layers[0].attn
    check(cfg.n_layers == depth and len(model.layers) + len(
        model.dense_layers) == depth and cfg.d_model == 2048
          and (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
               m.v_head_dim, m.q_lora_rank) == (512, 128, 64, 128, 0)
          and n_params == zoo.analytic_param_count(cfg) == want_params
          and attn.wkv_b.w.dtype == torch.bfloat16
          and attn.wkv_b.w.device.type == torch.device(DEVICE).type,
          f"serving {cfg.name}: {len(model.layers)} layers, {n_params} "
          f"parameters")
    print(f"{label} {cfg.name}: {n_params} parameters (analytic_param_count"
          f" {want_params}, active {zoo.analytic_param_count(cfg, True)}), "
          f"{cfg.n_layers} layers ({len(model.dense_layers)} dense), MLA "
          f"rank {m.kv_lora_rank} q.k {m.qk_nope_head_dim}+"
          f"{m.qk_rope_head_dim} v {m.v_head_dim}, {cfg.moe.n_routed} "
          f"experts top {cfg.moe.top_k} + {cfg.moe.n_shared} shared, "
          f"{cfg.param_dtype} weights drawn on the card in init_s="
          f"{init_s:.3f}; allocated_bytes={torch.cuda.memory_allocated()}",
          flush=True)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SERVE_B, SERVE_S))).to(DEVICE)
    greedy_generate(model, cfg, prompts[:, :64], max_new=2, device=DEVICE)

    # (a) the main path through the kernel
    logits, out, ttft, tok_s, wall, launches = _generate(model, cfg, prompts,
                                                         new=EARLY_NEW)
    check(launches["flash_attention"] == cfg.n_layers,
          f"mla prefill launched flash_attention "
          f"{launches['flash_attention']} times, want {cfg.n_layers} (one "
          f"prefill)")
    check(tuple(out.shape) == (SERVE_B, EARLY_NEW)
          and bool(torch.isfinite(logits).all()),
          f"mla greedy_generate gave {tuple(out.shape)}")
    print(f"{label} (a) B={SERVE_B} S={SERVE_S} new={EARLY_NEW}: "
          f"ttft_s={ttft:.6f} decode_tok_per_s={tok_s:.3f} "
          f"greedy_generate_wall_s={wall:.6f} launches={launches}",
          flush=True)

    # (b) the same weights with the plain prefill attention, SDPA's as a
    # control, each site's attention against the plain version on the
    # same q, k, v, and the routing of each layer from the same input
    with _plain_prefill_attention():
        p_logits, p_out, p_ttft, _, _, p_launches = _generate(
            model, cfg, prompts, new=EARLY_NEW, timed=False)
    check(p_launches["flash_attention"] == 0,
          "the plain prefill launched the kernel")
    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    with torch.no_grad():
        with _sdpa_prefill_attention():
            s_logits, _ = prefill(model, {"tokens": prompts})
        with _AttentionBesidePlain() as sites:
            prefill(model, {"tokens": prompts})
        with _TeacherForced() as forced:
            prefill(model, {"tokens": prompts})
    shares = _routing_agreement(forced.kernel, forced.plain)
    err = float((logits - p_logits).abs().max())
    s_err = float((s_logits - p_logits).abs().max())
    agree = float((out == p_out).float().mean())
    print(f"{label} (b) bf16 kernel vs plain prefill attention, same "
          f"weights: last-position logits max_abs_err={err:.6g} "
          f"greedy_agreement={agree:.6f} plain ttft_s={p_ttft:.6f}; SDPA vs "
          f"plain (control): max_abs_err={s_err:.6g}; each site's "
          f"attention output vs plain on the same q, k, v: max="
          f"{max(sites.errs):.6g} {[round(e, 6) for e in sites.errs]}; "
          f"routing agreement per MoE layer (teacher-forced): min="
          f"{min(shares):.6f} mean={float(np.mean(shares)):.6f} "
          f"{[round(v, 6) for v in shares]}", flush=True)
    check(len(sites.errs) == cfg.n_layers
          and max(sites.errs) <= FLASH_TOL[torch.bfloat16],
          f"mla prefill attention vs plain at the sites: {sites.errs}")
    check(len(shares) == len(model.layers)
          and min(shares) >= AGREE_ROUTING,
          f"mla prefill routing agreement {shares}")
    check(bool(torch.isfinite(p_logits).all())
          and bool(torch.isfinite(s_logits).all()),
          "plain or SDPA logits not finite")

    # (d) the int8 latent cache on the same weights
    qcfg = dataclasses.replace(cfg, kv_cache_quant=True)
    q_logits, q_out, q_ttft, q_tok_s, _, q_launches = _generate(
        model, qcfg, prompts, new=EARLY_NEW)
    check(q_launches["flash_attention"] == cfg.n_layers
          and bool(torch.isfinite(q_logits).all()),
          f"int8 mla prefill: launches {q_launches}, finite "
          f"{bool(torch.isfinite(q_logits).all())}")
    print(f"{label} (d) bf16 on the int8 latent cache: ttft_s={q_ttft:.6f} "
          f"decode_tok_per_s={q_tok_s:.3f}; vs the float cache: "
          f"last-position logits max_abs_err="
          f"{float((q_logits - logits).abs().max()):.6g} greedy_agreement="
          f"{float((q_out == out).float().mean()):.6f}", flush=True)

    # (e) the continuous batcher
    _batcher_run(f"{label} (e)", cfg, model, rng)

    # (f) where a prefill's and a decode step's device time goes
    decode = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model,
                                                   {"tokens": prompts})

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode(model, state["caches"], {"tokens": tok}, SERVE_S)

    with torch.no_grad():
        for what, fn, wall_s in (("prefill", run_prefill, ttft),
                                 ("decode step", run_decode,
                                  SERVE_B / tok_s)):
            split = _moe_device_split(f"{label} (f) {what}", fn)
            measured = split["rest_ms"] is not None
            busy = sum(split.values()) / 1e3 / wall_s if measured else None
            print(f"{label} (f) one B={SERVE_B} S={SERVE_S} {what}, device "
                  f"time (torch.profiler): " +
                  " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                           for k, v in split.items()) +
                  f"; device busy share of its wall time ({wall_s:.6f} s, "
                  f"unprofiled): "
                  f"{'not measured' if busy is None else f'{busy:.4f}'}",
                  flush=True)
    print(f"{label}: peak_memory_bytes (max_memory_allocated, bf16 model "
          f"through (f))={torch.cuda.max_memory_allocated()}", flush=True)
    del model, state, prefill, decode, attn
    gc.collect()
    _free_card(f"{label} (c)")
    # (g) python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    # --device cuda exits 0, with and without --kv-quant, beside (c)
    launchers = [_Launcher(f"{label} (g)", "repro_torch.launch.serve",
                           "--arch", MLA_ARCH, "--device", DEVICE, *quant)
                 for quant in ((), ("--kv-quant",))]
    _mla_f32_card_vs_cpu(seed, rng)
    for launcher in launchers:
        launcher.finish()
    return launches["flash_attention"]


# --------------------------------------- encoder-decoder and VLM serving
def _split_line(label: str, what: str, fn, wall_s: float) -> None:
    """Print the device time of ``fn()`` split into ``flash_attention``,
    the matmuls and the rest (``torch.profiler``), and the device's busy
    share of ``wall_s``, the call's unprofiled wall time."""
    split = _device_split(f"{label} {what}", fn)
    busy = (None if split["other_ms"] is None
            else sum(split.values()) / 1e3 / wall_s)
    print(f"{label} one {what}, device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()) +
          f"; device busy share of its wall time ({wall_s:.6f} s, "
          f"unprofiled): {'not measured' if busy is None else f'{busy:.4f}'}",
          flush=True)


def _site_line(sites) -> str:
    """A prefill's attention calls by kind, (causal, S, Skv): the calls,
    the largest |kernel - plain|, the largest |SDPA - plain| (control),
    the largest plain |o|, and the largest error over the larger of the
    and one ulp of the plain output (the gate: at most 1)."""
    kinds = {}
    for i, call in enumerate(sites.calls):
        n, *worst = kinds.get(call, (0, 0.0, 0.0, 0.0, 0.0))
        kinds[call] = (n + 1, *(max(a, b) for a, b in zip(worst, (
            sites.errs[i], sites.sdpa_errs[i], sites.mags[i],
            sites.over[i]))))
    return "; ".join(
        f"causal={c} S={s} Skv={kv}: {n} calls, max {e:.6g} (SDPA {se:.6g})"
        f", max |o| {m:.4g}, over max(FLASH_TOL, ulp) {o:.4f}"
        for (c, s, kv), (n, e, se, m, o) in kinds.items())


def _prefill_specs(cfg) -> dict:
    """``input_specs`` of a B=SERVE_B, S=SERVE_S prefill (meta tensors)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import input_specs

    return input_specs(cfg, ShapeSpec("serve", "prefill", SERVE_S, SERVE_B))


def _randn(rng, shape, device=None) -> torch.Tensor:
    """f32 ``randn`` of ``shape`` from ``rng`` on ``device`` (the card
    unless given)."""
    return torch.from_numpy(rng.standard_normal(
        tuple(shape), dtype=np.float32)).to(device or DEVICE)


def _encdec_f32_card_vs_cpu(seed: int, rng) -> None:
    """(c): f32 at ENCDEC_F32_LAYERS encoder and decoder layers, full width
    otherwise, the same weights on the card and on the CPU (B=SSM_F32_B):
    prefill logits (the frames encoded, then the decoder) within 1e-3,
    ``greedy_generate(enc_out=...)`` agreement over SSM_F32_NEW tokens at
    least 0.99, and on each device a prefill of SERVE_S tokens and one
    decode step within 1e-3 of a prefill of SERVE_S + 1 over the same
    ``enc_out``."""
    from repro_torch.models import decode_step, encode_frames, init_cache
    from repro_torch.serve import greedy_generate, make_prefill_step

    cfg = _arch_config(ENCDEC_ARCH, param_dtype="float32",
                       compute_dtype="float32", n_layers=ENCDEC_F32_LAYERS,
                       enc_layers=ENCDEC_F32_LAYERS)
    model = _init_on_card(cfg, seed)
    cpu = _on_cpu(model, cfg)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SSM_F32_B, SERVE_S + 1)))
    frames = _randn(rng, (SSM_F32_B, SERVE_S // 4, cfg.d_model), "cpu")
    head = prompts[:, :SERVE_S]
    max_len = SERVE_S + SSM_F32_NEW
    t0 = time.perf_counter()
    stepped = {}
    with torch.no_grad():
        reset_counts()
        card, _ = make_prefill_step(cfg, max_len, device=DEVICE)(
            model, {"tokens": head.to(DEVICE), "frames": frames.to(DEVICE)})
        torch.cuda.synchronize()
        launches = read_counts()["flash_attention"]
        want, _ = make_prefill_step(cfg, max_len, device="cpu")(
            cpu, {"tokens": head, "frames": frames})
        outs = {}
        for dev, m in ((DEVICE, model), ("cpu", cpu)):
            p = prompts.to(dev)
            enc = encode_frames(m, cfg, frames.to(dev))
            outs[dev] = greedy_generate(m, cfg, p[:, :SERVE_S],
                                        max_new=SSM_F32_NEW, enc_out=enc,
                                        device=dev).cpu()
            caches = init_cache(cfg, SSM_F32_B, SERVE_S + 8, device=dev)
            decode_step(m, cfg, {"tokens": p[:, :SERVE_S]}, caches,
                        cache_index=0, enc_out=enc)
            one, _ = decode_step(m, cfg, {"tokens": p[:, SERVE_S:]}, caches,
                                 cache_index=SERVE_S, enc_out=enc)
            whole, _ = decode_step(m, cfg, {"tokens": p},
                                   init_cache(cfg, SSM_F32_B, SERVE_S + 8,
                                              device=dev),
                                   cache_index=0, enc_out=enc)
            stepped[str(dev)] = float((one - whole).abs().max())
    err = float((card.cpu() - want).abs().max())
    agree = float((outs[DEVICE] == outs["cpu"]).float().mean())
    print(f"encdec serve (c) f32, {cfg.enc_layers} + {cfg.n_layers} layers, "
          f"B={SSM_F32_B}: card vs CPU prefill logits max_abs_err={err:.6g}"
          f", greedy_agreement={agree:.6f} over {SSM_F32_NEW} tokens, "
          f"prefill launches={launches}; prefill({SERVE_S}) + one decode "
          f"step vs prefill({SERVE_S + 1}) over the same enc_out, logits "
          f"max_abs_err: card {stepped[str(DEVICE)]:.6g}, CPU "
          f"{stepped['cpu']:.6g} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(launches == cfg.enc_layers + 2 * cfg.n_layers,
          f"f32 encdec prefill launched flash_attention {launches} times")
    check(err <= LOGITS_ATOL[torch.float32] and agree >= AGREE_F32,
          f"f32 encdec card vs CPU: logits differ by {err}, agreement "
          f"{agree}")
    check(max(stepped.values()) <= LOGITS_ATOL[torch.float32],
          f"f32 encdec: prefill + decode vs the longer prefill differ by "
          f"{stepped}")


def encdec_serve_phase(seed: int) -> int:
    """The encoder-decoder family served at full width and depth, after
    the MLA weights are freed; returns the launches of the main path's
    prefill."""
    import gc

    from repro_torch.models import encode_frames, zoo
    from repro_torch.serve import (ContinuousBatcher, make_decode_step,
                                   make_prefill_step)

    label = "encdec serve"
    _free_card(label)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    cfg = _arch_config(ENCDEC_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _init_on_card(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want_params, n_enc, n_dec = ENCDEC_PUBLISHED
    check(len(model.enc_layers) == cfg.enc_layers == n_enc
          and len(model.dec_layers) == cfg.n_layers == n_dec
          and cfg.d_model == 1024 and cfg.head_dim == 64
          and n_params == zoo.analytic_param_count(cfg) == want_params
          and model.dec_layers[0].cross.wq.w.dtype == torch.bfloat16,
          f"serving {cfg.name}: {n_params} parameters")
    print(f"{label} {cfg.name}: {n_params} parameters (analytic_param_count"
          f" {want_params}), {cfg.enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, {cfg.param_dtype} weights drawn on the card in "
          f"init_s={init_s:.3f}; allocated_bytes="
          f"{torch.cuda.memory_allocated()}", flush=True)
    specs = _prefill_specs(cfg)
    frames = _randn(rng, specs["frames"].shape)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, tuple(specs["tokens"].shape))).to(DEVICE)
    with torch.no_grad():
        warm = encode_frames(model, cfg, frames[:, :16])
        enc_out = encode_frames(model, cfg, frames)
    _generate(model, cfg, prompts[:, :64], prefill_extra={
        "frames": frames[:, :16]}, decode_extra={"enc_out": warm}, new=2,
        timed=False)  # warm

    # (a) the main path through the kernel
    n_sites = cfg.enc_layers + 2 * cfg.n_layers
    logits, out, ttft, tok_s, wall, launches = _generate(
        model, cfg, prompts, prefill_extra={"frames": frames},
        decode_extra={"enc_out": enc_out})
    check(launches["flash_attention"] == n_sites,
          f"encdec prefill launched flash_attention "
          f"{launches['flash_attention']} times, want {n_sites} (encoder "
          f"self-attention, decoder self- and cross-attention)")
    check(tuple(out.shape) == (SERVE_B, SERVE_NEW)
          and bool(torch.isfinite(logits).all()),
          f"encdec greedy_generate gave {tuple(out.shape)}")
    print(f"{label} (a) B={SERVE_B} frames={tuple(frames.shape)} "
          f"S={SERVE_S} new={SERVE_NEW}: ttft_s={ttft:.6f} (encoder and "
          f"decoder prefill) decode_tok_per_s={tok_s:.3f} "
          f"greedy_generate_wall_s={wall:.6f} launches={launches}",
          flush=True)

    # (b) the same weights with the plain prefill attention, SDPA's as a
    # control, and each site's attention against the plain version
    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    batch = {"tokens": prompts, "frames": frames}
    with torch.no_grad():
        with _plain_prefill_attention():
            reset_counts()
            p_logits, _ = prefill(model, batch)
            p_launches = read_counts()["flash_attention"]
        with _sdpa_prefill_attention():
            s_logits, _ = prefill(model, batch)
        with _AttentionBesidePlain() as sites:
            prefill(model, batch)
    check(p_launches == 0, "the plain prefill launched the kernel")
    err = float((logits - p_logits).abs().max())
    s_err = float((s_logits - p_logits).abs().max())
    print(f"{label} (b) bf16 kernel vs plain prefill attention, same "
          f"weights: last-position logits max_abs_err={err:.6g}; SDPA vs "
          f"plain (control): max_abs_err={s_err:.6g}; each site's "
          f"attention output vs plain on the same q, k, v: "
          f"{_site_line(sites)}", flush=True)
    check(len(sites.errs) == n_sites
          and sum(s != kv for _, s, kv in sites.calls) == cfg.n_layers
          and max(sites.over) <= 1.0,
          f"encdec prefill attention vs plain at the sites: "
          f"{list(zip(sites.calls, sites.errs, sites.mags))}")
    check(bool(torch.isfinite(p_logits).all())
          and bool(torch.isfinite(s_logits).all()),
          "plain or SDPA logits not finite")

    # (d) the batcher refuses the family, as the reference's cannot serve
    # it (it passes no enc_out)
    try:
        ContinuousBatcher(cfg, model, slots=2, max_len=64, device=DEVICE)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "the batcher took the encoder-decoder family")

    # (e) where a prefill's and a decode step's device time goes
    decode_fn = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model, batch)

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode_fn(model, state["caches"], {"tokens": tok,
                                           "enc_out": enc_out}, SERVE_S)

    with torch.no_grad():
        _split_line(f"{label} (e)", f"B={SERVE_B} S={SERVE_S} prefill",
                    run_prefill, ttft)
        _split_line(f"{label} (e)", f"B={SERVE_B} decode step", run_decode,
                    SERVE_B / tok_s)
    print(f"{label}: peak_memory_bytes (max_memory_allocated, bf16 model "
          f"through (e))={torch.cuda.max_memory_allocated()}", flush=True)
    del model, state, prefill, enc_out
    gc.collect()
    _free_card(f"{label} (c)")
    _encdec_f32_card_vs_cpu(seed, rng)
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def _entry_point(name: str, folder: str = "examples"):
    """``<folder>/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = ROOT / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _tests_module(name: str):
    """``tests/<name>.py`` of this checkout as a module, loaded once."""
    return _entry_point(name, "tests")


class _OracleScans:
    """A test-only view of a VideoStore for ``tasm_region_batches``: each
    scan first waits for the background tuner to drain (so the scan reads
    the layout in place), then holds every region it returns against the
    numpy ``decode_tile`` oracle of that layout's tiles (cached by the
    SOTs' epochs)."""

    def __init__(self, store):
        self.store, self.regions, self.worst = store, 0, 0.0
        self._oracle = {}

    def __getattr__(self, name):
        return getattr(self.store, name)

    def scan(self, name: str):
        return _OracleQuery(self, name, self.store.scan(name))

    def check(self, name: str, query):
        self.store.drain_tuner()
        key = (name, tuple(sorted(self.store.epochs(name).items())))
        if key not in self._oracle:
            self._oracle = {key: _oracle_frames(self.store.video(name)
                                                .store)}
        res = query.execute()
        if res.regions:
            self.worst = max(self.worst, _check_regions(
                res.regions, self._oracle[key], "pipeline scan"))
            self.regions += len(res.regions)
        return res


class _OracleQuery:
    def __init__(self, owner, name, query):
        self.owner, self.name, self.query = owner, name, query

    def labels(self, *a, **kw):
        return _OracleQuery(self.owner, self.name,
                            self.query.labels(*a, **kw))

    def frames(self, *a, **kw):
        return _OracleQuery(self.owner, self.name,
                            self.query.frames(*a, **kw))

    def execute(self):
        return self.owner.check(self.name, self.query)


def pipeline_phase(model, cfg) -> tuple:
    """The paper's store-to-VLM loop of ``examples/video_analytics_torch.py``
    on the card, at full width, in this process: the store is built (cost
    model calibrated, ``sparse_spec(seed=4, n_frames=96)`` ingested, on the
    card), ``tasm_region_batches`` streams PIPE_BATCHES batches of
    PIPE_CROPS crops (every scan's regions held against the numpy oracle
    at atol 1e-3, rtol 1e-5), each scored by the example's ``score`` on
    ``model`` (1,024 patch tokens and PIPE_TEXT text tokens a crop, one
    ``flash_attention`` launch a layer), then the tuner drains.  The counts
    are set to 0 just before the store is built and read after the drain:
    the ingest's ``dct_quant`` and ``idct_dequant``, the scans'
    ``decode_gop_blocks`` and the backbone's ``flash_attention`` must all
    have launched.  Held against the plain versions: the first call of
    each ingest kernel, intra and N (equal outputs), and each attention
    site of the first batch's crops scored again after the counts are
    read (within the larger of 2e-2 and one bf16 ulp).  Returns (the
    counts, the first batch's crops)."""
    from repro_torch.train.data import tasm_region_batches

    ex = _entry_point("video_analytics_torch")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _CodecBesidePlain() as codec:
        store = ex.build_store(DEVICE)
    build_s = time.perf_counter() - t0
    built = read_counts()
    scans = _OracleScans(store)
    batches = tasm_region_batches(scans, ex.LABELS, batch=PIPE_CROPS,
                                  crop=16, video="cam0")
    first, times, flash = None, [], []
    for i in range(PIPE_BATCHES):
        b = next(batches)
        pixels = torch.from_numpy(b["pixels"]).to(DEVICE)
        tokens = torch.zeros((pixels.shape[0], PIPE_TEXT), dtype=torch.long,
                             device=DEVICE)
        before = read_counts()["flash_attention"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = ex.score(model, cfg, pixels, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        flash.append(read_counts()["flash_attention"] - before)
        check(tuple(logits.shape) == (PIPE_CROPS, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"pipeline batch {i}: logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        if first is None:
            first = b["pixels"]
    store.drain_tuner()
    counts = read_counts()
    entry = store.video("cam0")
    layouts = [r.layout.describe() for r in entry.store.sots]
    print(f"pipeline: store built (calibration, ingest of 96 frames) in "
          f"build_s={build_s:.3f} (the plain checks below included) with "
          f"launches {built}; "
          f"{PIPE_BATCHES} batches of {PIPE_CROPS} crops, each a prefill of "
          f"{cfg.frontend_tokens} patch tokens + {PIPE_TEXT} text tokens: "
          f"score_s={[round(x, 6) for x in times]} (TTFT of a batch), "
          f"flash_attention launches per batch {flash}; {scans.regions} "
          f"scanned regions vs the numpy oracle max_abs_err="
          f"{scans.worst:.3g}; layouts after the drain {layouts}; launches "
          f"through the drain {counts}; peak_memory_bytes="
          f"{torch.cuda.max_memory_allocated()}; decode: none (the "
          f"pipeline scores crops)", flush=True)
    check(scans.regions > 0, "the pipeline's scans returned no region")
    check(flash == [cfg.n_layers] * PIPE_BATCHES,
          f"pipeline flash_attention launches per batch {flash}")
    for name in ("dct_quant", "idct_dequant", "decode_gop_blocks",
                 "flash_attention"):
        check(counts[name] > 0, f"pipeline launched no {name}")
    pixels = torch.from_numpy(first).to(DEVICE)
    tokens = torch.zeros((pixels.shape[0], PIPE_TEXT), dtype=torch.long,
                         device=DEVICE)
    with _AttentionBesidePlain() as sites:
        ex.score(model, cfg, pixels, tokens)
    print(f"pipeline: ingest kernels vs plain, first call of each (kernel, "
          f"intra, N): outputs that differ {codec.diffs}; the first batch "
          f"scored again, each site's attention output vs plain on the same "
          f"q, k, v: {_site_line(sites)}", flush=True)
    check(sorted({k[:2] for k in codec.diffs}) == [
        ("dct_quant_op", False), ("dct_quant_op", True),
        ("idct_dequant_op", False), ("idct_dequant_op", True)]
          and not any(codec.diffs.values()),
          f"pipeline ingest kernels vs plain: {codec.diffs}")
    n_seq = cfg.frontend_tokens + PIPE_TEXT
    check(sites.calls == [(True, n_seq, n_seq)] * cfg.n_layers
          and max(sites.over) <= 1.0,
          f"pipeline attention vs plain at the sites: "
          f"{list(zip(sites.calls, sites.errs, sites.mags))}")
    with torch.no_grad():
        _split_line("pipeline", f"score of {PIPE_CROPS} crops",
                    lambda: ex.score(model, cfg, pixels, tokens), times[-1])
    store.close()
    return counts, first


def _vlm_f32_card_vs_cpu(seed: int, rng, crops) -> None:
    """(c): f32 at VLM_F32_LAYERS layers, full width otherwise, the same
    weights on the card and on the CPU (B=SSM_F32_B): the logits of a
    patch prefill (SERVE_S // 4 patches and the rest text) within 1e-3,
    ``greedy_generate`` on text prompts with at least 0.99 of its
    SSM_F32_NEW tokens equal, on each device that prefill one text token
    short plus one decode step within 1e-3 of it, and the pipeline's
    ``score`` of the first PIPE_F32_CROPS crops of its first batch within
    1e-3."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.serve import greedy_generate, make_prefill_step

    ex = _entry_point("video_analytics_torch")
    cfg = _arch_config(VLM_ARCH, param_dtype="float32",
                       compute_dtype="float32", n_layers=VLM_F32_LAYERS)
    model = _init_on_card(cfg, seed)
    cpu = _on_cpu(model, cfg)
    n_img = SERVE_S // 4
    patches = _randn(rng, (SSM_F32_B, n_img, cfg.frontend_dim), "cpu")
    text = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (SSM_F32_B, SERVE_S - n_img)))
    t0 = time.perf_counter()
    logits, stepped, outs, scored = {}, {}, {}, {}
    with torch.no_grad():
        for dev, m in ((DEVICE, model), ("cpu", cpu)):
            pe, tx = patches.to(dev), text.to(dev)
            if dev == DEVICE:
                reset_counts()
            logits[dev], _ = make_prefill_step(cfg, SERVE_S + 8, device=dev)(
                m, {"patch_embeds": pe, "tokens": tx})
            if dev == DEVICE:
                torch.cuda.synchronize()
                launches = read_counts()["flash_attention"]
            caches = init_cache(cfg, SSM_F32_B, SERVE_S + 8, device=dev)
            decode_step(m, cfg, {"patch_embeds": pe, "tokens": tx[:, :-1]},
                        caches, cache_index=0)
            one, _ = decode_step(m, cfg, {"tokens": tx[:, -1:]}, caches,
                                 cache_index=SERVE_S - 1)
            stepped[dev] = float((one - logits[dev]).abs().max())
            outs[dev] = greedy_generate(m, cfg, tx, max_new=SSM_F32_NEW,
                                        device=dev).cpu()
            px = torch.from_numpy(crops[:PIPE_F32_CROPS]).to(dev)
            scored[dev] = ex.score(m, cfg, px, torch.zeros(
                (px.shape[0], PIPE_TEXT), dtype=torch.long, device=dev)).cpu()
    err = float((logits[DEVICE].cpu() - logits["cpu"]).abs().max())
    agree = float((outs[DEVICE] == outs["cpu"]).float().mean())
    p_err = float((scored[DEVICE] - scored["cpu"]).abs().max())
    print(f"vlm serve (c) f32, {cfg.n_layers} layers, B={SSM_F32_B}: card "
          f"vs CPU patch-prefill logits ({n_img} patches + "
          f"{SERVE_S - n_img} tokens) max_abs_err={err:.6g}, prefill "
          f"launches={launches}, greedy_agreement={agree:.6f} over "
          f"{SSM_F32_NEW} tokens of text prompts; prefill one token short "
          f"+ one decode step vs the prefill, logits max_abs_err: card "
          f"{stepped[DEVICE]:.6g}, CPU {stepped['cpu']:.6g}; pipeline score "
          f"of {PIPE_F32_CROPS} crops ({cfg.frontend_tokens} patch tokens "
          f"each) card vs CPU max_abs_err={p_err:.6g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(launches == cfg.n_layers,
          f"f32 vlm prefill launched flash_attention {launches} times")
    check(err <= LOGITS_ATOL[torch.float32] and agree >= AGREE_F32,
          f"f32 vlm card vs CPU: logits differ by {err}, agreement {agree}")
    check(max(stepped.values()) <= LOGITS_ATOL[torch.float32],
          f"f32 vlm: patch prefill + decode vs the longer prefill differ by "
          f"{stepped}")
    check(p_err <= LOGITS_ATOL[torch.float32],
          f"f32 vlm: the pipeline's logits differ by {p_err} card vs CPU")


def vlm_serve_phase(seed: int) -> tuple:
    """The VLM family served at full width and depth, after the
    encoder-decoder's weights are freed, then the pipeline on the same
    weights; returns (the launches of the main path's prefill, the
    pipeline's counts)."""
    import gc

    from repro_torch.models import zoo
    from repro_torch.serve import make_decode_step, make_prefill_step

    label = "vlm serve"
    _free_card(label)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    cfg = _arch_config(VLM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _init_on_card(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want_params, depth = VLM_PUBLISHED
    check(len(model.layers) == cfg.n_layers == depth and cfg.d_model == 6144
          and (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (48, 8, 128)
          and tuple(model.projector.fc1.w.shape) == (3200, 6144)
          and n_params == zoo.analytic_param_count(cfg) == want_params
          and model.projector.fc1.w.dtype == torch.bfloat16,
          f"serving {cfg.name}: {n_params} parameters")
    print(f"{label} {cfg.name}: {n_params} parameters (analytic_param_count"
          f" {want_params}), {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} on {cfg.n_kv_heads}, "
          f"projector {cfg.frontend_dim} -> {cfg.d_model} -> {cfg.d_model}, "
          f"{cfg.param_dtype} weights drawn on the card in init_s="
          f"{init_s:.3f}; allocated_bytes={torch.cuda.memory_allocated()}",
          flush=True)
    specs = _prefill_specs(cfg)
    patches = _randn(rng, specs["patch_embeds"].shape)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, tuple(specs["tokens"].shape))).to(DEVICE)
    _generate(model, cfg, prompts[:, :8],
              prefill_extra={"patch_embeds": patches[:, :8]}, start=16,
              new=2, timed=False)  # warm

    # (a) the main path through the kernel: the patch prefill, then the
    # decode steps from its full length
    n = patches.shape[1] + prompts.shape[1]
    logits, out, ttft, tok_s, wall, launches = _generate(
        model, cfg, prompts, prefill_extra={"patch_embeds": patches},
        start=n)
    check(launches["flash_attention"] == cfg.n_layers,
          f"vlm prefill launched flash_attention "
          f"{launches['flash_attention']} times, want {cfg.n_layers}")
    check(tuple(out.shape) == (SERVE_B, SERVE_NEW)
          and bool(torch.isfinite(logits).all()),
          f"vlm generation gave {tuple(out.shape)}")
    print(f"{label} (a) B={SERVE_B} patches={tuple(patches.shape)} + "
          f"{prompts.shape[1]} tokens, new={SERVE_NEW}: ttft_s={ttft:.6f} "
          f"decode_tok_per_s={tok_s:.3f} greedy_generate_wall_s={wall:.6f} "
          f"(the text prompts alone) launches={launches}", flush=True)

    # (b) the same weights with the plain prefill attention, SDPA's as a
    # control, and each site's attention against the plain version
    with _plain_prefill_attention():
        p_logits, p_out, p_ttft, _, _, p_launches = _generate(
            model, cfg, prompts, prefill_extra={"patch_embeds": patches},
            start=n, timed=False)
    check(p_launches["flash_attention"] == 0,
          "the plain prefill launched the kernel")
    prefill = make_prefill_step(cfg, BATCH_MAX_LEN, device=DEVICE)
    batch = {"patch_embeds": patches, "tokens": prompts}
    with torch.no_grad():
        with _sdpa_prefill_attention():
            s_logits, _ = prefill(model, batch)
        with _AttentionBesidePlain() as sites:
            prefill(model, batch)
    err = float((logits - p_logits).abs().max())
    s_err = float((s_logits - p_logits).abs().max())
    agree = float((out == p_out).float().mean())
    print(f"{label} (b) bf16 kernel vs plain prefill attention, same "
          f"weights: last-position logits max_abs_err={err:.6g} "
          f"greedy_agreement={agree:.6f} (greedy_generate on the text "
          f"prompts) plain ttft_s={p_ttft:.6f}; SDPA vs "
          f"plain (control): max_abs_err={s_err:.6g}; each site's "
          f"attention output vs plain on the same q, k, v: "
          f"{_site_line(sites)}", flush=True)
    check(len(sites.errs) == cfg.n_layers and max(sites.over) <= 1.0,
          f"vlm prefill attention vs plain at the sites: "
          f"{list(zip(sites.errs, sites.mags))}")
    check(bool(torch.isfinite(p_logits).all())
          and bool(torch.isfinite(s_logits).all()),
          "plain or SDPA logits not finite")

    # (d) the continuous batcher on text prompts, as the reference's
    stats = _batcher_run(f"{label} (d)", cfg, model, rng)

    # (e) where a prefill's and a decode step's device time goes
    decode_fn = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model, batch)

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode_fn(model, state["caches"], {"tokens": tok}, n)

    with torch.no_grad():
        _split_line(f"{label} (e)", f"B={SERVE_B} S={n} patch prefill",
                    run_prefill, ttft)
        _split_line(f"{label} (e)", f"B={SERVE_B} decode step", run_decode,
                    SERVE_B / tok_s)
    print(f"{label}: peak_memory_bytes (max_memory_allocated, bf16 model "
          f"through (e))={torch.cuda.max_memory_allocated()}; batcher "
          f"stats {json.dumps(stats)}", flush=True)
    del state
    pipe, crops = _phase("pipeline", pipeline_phase, model, cfg)
    del model, prefill, batch, patches
    gc.collect()
    _free_card(f"{label} (c)")
    # (f) python -m repro_torch.launch.serve --arch internvl2-26b --device
    # cuda exits 0 (text prompts, as the reference's), beside (c)
    launcher = _Launcher(f"{label} (f)", "repro_torch.launch.serve",
                         "--arch", VLM_ARCH, "--device", DEVICE)
    _vlm_f32_card_vs_cpu(seed, rng, crops)
    launcher.finish()
    return launches["flash_attention"], pipe


# ---------------------------------------------------------------- training
def _bwd_shape(shape) -> tuple:
    """A backward shape as (B, H, KV, S, Skv, Dqk, Dv), from (B, H, KV, S,
    D) or that 7-tuple itself."""
    if len(shape) == 5:
        b, h, kv, s, d = shape
        return b, h, kv, s, s, d, d
    return tuple(shape)


def flash_bwd_bound_ms(shape, dtype, causal: bool) -> tuple[float, str]:
    """Least time for one attention backward: q, k, v, o, dO and the f32
    lse read and dq, dk, dv written once over the HBM rate (B (H S + KV
    Skv)(2 Dqk + 2 Dv) elements), against the five products the gradient
    needs (the recomputed scores, dq and dk over Dqk; dP and dv over Dv; 2
    FLOPs per multiply-add over the live (query, key) pairs: 2 B H pairs
    (3 Dqk + 2 Dv)) over the card's peak for the type.  ``shape`` as
    :func:`_bwd_shape` takes it."""
    b, h, kv, s, skv, d, dv = _bwd_shape(shape)
    elt = torch.finfo(dtype).bits // 8
    n_bytes = b * (h * s + kv * skv) * (2 * d + 2 * dv) * elt + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * skv
    flops = 2 * b * h * pairs * (3 * d + 2 * dv)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_row_err(got: torch.Tensor, want: torch.Tensor,
                floor: float) -> float:
    """The largest |got - want| of one gradient, each element over the
    largest |want| of its row (over D), that scale taken at least
    ``floor``."""
    w = want.float()
    row = w.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
    return float(((got.float() - w).abs() / row).max())


def _qkv_bwd(rng, shape, dtype):
    """q, k, v on the card for a backward ``shape`` (:func:`_bwd_shape`)."""
    return _qkv_cross(rng, _bwd_shape(shape), dtype)


def _dout_bwd(rng, q, v):
    """dO [B, H, S, Dv] from ``rng`` on the card, in q's dtype."""
    shape = (*q.shape[:3], v.shape[3])
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        DEVICE, q.dtype)


def bwd_chain_errs(q, k, v, dout, causal: bool) -> dict:
    """The main path's chain (the forward kernel's o and lse into the
    backward kernel) held against the fully plain chain: o within
    FLASH_TOL, lse within LSE_ATOL, each gradient over its row's largest
    within BWD_TOL; two calls of the backward the same bits.  Returns the
    readings, with ``max_abs`` the largest absolute gradient error."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)

    dtype, what = q.dtype, f"{tuple(q.shape)} / {tuple(v.shape)}"
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
    again = flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
    o_ref = attention_ref(q, k, v, causal=causal)
    lse_ref = attention_lse_ref(q, k, causal=causal)
    torch.cuda.synchronize()
    errs = {"o": float((o.float() - o_ref.float()).abs().max()),
            "lse": float((lse - lse_ref).abs().max())}
    check(errs["o"] <= FLASH_TOL[dtype],
          f"flash_attention o vs plain {what} {dtype} causal={causal}: max "
          f"|diff| {errs['o']} > {FLASH_TOL[dtype]}")
    check(errs["lse"] <= LSE_ATOL,
          f"flash_attention lse vs plain {what} {dtype} causal={causal}: "
          f"max |diff| {errs['lse']} > {LSE_ATOL}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {what} {dtype} causal={causal}: two calls "
          f"gave other bits")
    want = attention_bwd_ref(q, k, v, o_ref, dout, lse_ref, causal=causal)
    floor = BWD_FLOOR * max(float(w.float().abs().max()) for w in want)
    errs["max_abs"] = 0.0
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        errs[gname] = bwd_row_err(a, w, floor)
        check(errs[gname] <= BWD_TOL[dtype],
              f"flash_attention_bwd {gname} vs plain {what} {dtype} causal="
              f"{causal}: {errs[gname]} of its row's largest > "
              f"{BWD_TOL[dtype]}")
        errs["max_abs"] = max(errs["max_abs"],
                              float((a.float() - w.float()).abs().max()))
    return errs


def bwd_times(q, k, v, o, dout, lse, causal: bool, shape) -> dict:
    """Device ms of the backward kernel, of its plain version and of
    SDPA's backward (``enable_gqa``; the library yardstick, which the port
    never calls: None, with its error, where SDPA refuses the shape),
    beside the bound."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"ms": cuda_ms(lambda: flash_attention_bwd(
        q, k, v, o, dout, lse, causal=causal), iters=5)}
    row["plain_ms"] = cuda_ms(lambda: attention_bwd_ref(
        q, k, v, o, dout, lse, causal=causal), iters=2, warmup=1)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    try:
        ref_out = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)
        row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            ref_out, (qg, kg, vg), dout, retain_graph=True), iters=5)
    except RuntimeError as e:  # a shape SDPA's backward refuses
        row["library_ms"] = None
        row["library_error"] = str(e).splitlines()[0][:200]
    row["bound_ms"], row["bound_by"] = flash_bwd_bound_ms(shape, q.dtype,
                                                          causal)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def bwd_digests(call) -> dict:
    """{dtype name: sha256 of ``call(q, k, v, o, dO, lse, causal=...)``'s
    dq, dk, dv over BWD_DIGEST_SHAPES, causal and not, on ``randn`` inputs
    from DIGEST_SEED, o and lse from the forward kernel}: the same bits
    give the same digests."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(DIGEST_SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        digest = hashlib.sha256()
        for shape in BWD_DIGEST_SHAPES:
            q, k, v = _qkv(rng, *shape, dtype)
            dout = _qkv(rng, *shape, dtype)[0]
            for causal in (True, False):
                o, lse = flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
                for g in call(q, k, v, o, dout, lse, causal=causal):
                    digest.update(g.contiguous().view(-1).view(torch.uint8)
                                  .cpu().numpy().tobytes())
        out[str(dtype).split(".")[-1]] = digest.hexdigest()[:32]
    return out


def flash_bwd_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    rng = np.random.default_rng(seed + 4)
    worst, at_main = 0.0, None
    for shape, dtype in ((BWD_MAIN, torch.bfloat16),
                         (BWD_F32, torch.float32)):
        q, k, v = _qkv(rng, *shape, dtype)
        dout = _qkv(rng, *shape, dtype)[0]
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for causal in (True, False):
            errs = bwd_chain_errs(q, k, v, dout, causal)
            worst = max(worst, errs.pop("max_abs"))
            print(f"flash_attention_bwd {shape} {name} causal={causal} vs "
                  f"plain: " + ", ".join(f"{g} {r:.3g}"
                                         for g, r in errs.items())
                  + " (gradients of the row's largest)", flush=True)
        o, lse = flash_attention(q, k, v, return_lse=True)
        row = bwd_times(q, k, v, o, dout, lse, True, shape)
        print(f"flash_attention_bwd {shape} {name} causal: kernel_ms="
              f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
              f"sdpa_backward_ms={row['library_ms']:.6f} bound_ms="
              f"{row['bound_ms']:.6f} ({row['bound_by']}) share_of_bound="
              f"{row['share_of_bound']:.3f}", flush=True)
        if shape == BWD_MAIN:
            at_main = row
    # MLA's widths (causal) and keys of another length (not causal), at
    # the serving phases' prefill shapes, in both dtypes; bf16 timed
    for label, shape, causal in (("mla", BWD_MLA, True),
                                 ("cross", BWD_CROSS, False)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv_bwd(rng, shape, dtype)
            dout = _dout_bwd(rng, q, v)
            errs = bwd_chain_errs(q, k, v, dout, causal)
            worst = max(worst, errs.pop("max_abs"))
            print(f"flash_attention_bwd {label} {shape} {dtype} causal="
                  f"{causal} vs plain: " + ", ".join(
                      f"{g} {r:.3g}" for g, r in errs.items()), flush=True)
        q, k, v = _qkv_bwd(rng, shape, torch.bfloat16)
        dout = _dout_bwd(rng, q, v)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        row = bwd_times(q, k, v, o, dout, lse, causal, shape)
        print(f"flash_attention_bwd {label} {shape} bf16 causal={causal}: "
              + " ".join(f"{n}={x:.6f}" if isinstance(x, float) else
                         f"{n}={x}" for n, x in row.items()), flush=True)
    digests = bwd_digests(flash_attention_bwd)
    check(digests == BWD_OLD_DIGESTS,
          f"flash_attention_bwd old cases' digests {digests}, not the "
          f"parent build's {BWD_OLD_DIGESTS}")
    print(f"flash_attention_bwd old cases (Skv == S, Dv == Dqk) over "
          f"{len(BWD_DIGEST_SHAPES)} shapes, causal and not: digests equal "
          f"to the build before the widths and lengths became parameters "
          f"{digests}", flush=True)
    q, k, v = _qkv(rng, 1, 9, 3, 16, 64, torch.bfloat16)
    o, lse = flash_attention(q, k, v, return_lse=True)
    at_main.update(max_abs_err=worst, host_us=host_us(
        lambda: flash_attention_bwd(q, k, v, o, q, lse)))
    print(f"flash_attention_bwd max_abs_err={worst:.3g} wrapper host cost: "
          f"{at_main['host_us']:.3f} us/call", flush=True)
    return at_main


def _grads(model, cfg, batch) -> tuple:
    """(loss, {name: gradient}) of ``loss_fn`` on ``batch``."""
    from repro_torch.models import loss_fn

    params = dict(model.named_parameters())
    model.requires_grad_(True)
    loss, _ = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    model.requires_grad_(False)
    return loss.detach(), dict(zip(params, grads))


def _f32_step_card_vs_cpu(seed: int) -> None:
    """(c): the same f32 step on the card and on the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)

    layers, b, s = TRAIN_F32
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              param_dtype="float32",
                              compute_dtype="float32")
    cpu = init_model(cfg, seed, device="cpu")
    card = init_model(cfg, seed, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    reset_counts()
    loss_d, g_d = _grads(card, cfg,
                         {k: v.to(DEVICE) for k, v in batch.items()})
    torch.cuda.synchronize()
    counts = read_counts()
    loss_h, g_h = _grads(cpu, cfg, batch)
    check(counts["flash_attention_bwd"] == layers,
          f"f32 card step launched {counts}")
    rel = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
    check(rel <= 1e-5, f"f32 loss card {float(loss_d)} cpu {float(loss_h)}")
    worst = 0.0
    for name, gh in g_h.items():
        diff = float((g_d[name].cpu() - gh).abs().max())
        ratio = diff / max(float(gh.abs().max()), 1e-30)
        check(ratio <= GRAD_RTOL, f"f32 gradient {name}: max |diff| {diff},"
                                  f" {ratio} of the leaf's largest")
        worst = max(worst, ratio)
    # the update from the same gradients: the card's against the CPU's
    opt_cfg = AdamWConfig(lr=1e-3)
    p_d, p_h = dict(card.named_parameters()), dict(cpu.named_parameters())
    adamw_update(g_d, init_opt_state(p_d), p_d, opt_cfg)
    adamw_update({n: g_d[n].cpu() for n in g_d}, init_opt_state(p_h), p_h,
                 opt_cfg)
    upd = max(float((p_d[n].cpu() - p_h[n]).abs().max()
                    / p_h[n].abs().max()) for n in p_h)
    check(upd <= 1e-6, f"f32 AdamW update card vs cpu: {upd} of a leaf's "
                       f"largest")
    print(f"train (c) f32, {layers} layers at full width, B={b} S={s}, card "
          f"vs cpu: loss {float(loss_d):.7f} / {float(loss_h):.7f} (rel "
          f"{rel:.3g}); worst gradient diff {worst:.3g} of its leaf's "
          f"largest; params after AdamW from the same gradients "
          f"{upd:.3g} of their leaf's largest; "
          f"launches {counts}", flush=True)


def _recovery(seed: int) -> None:
    """(d): the recoverable loop through a simulated fault."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import synthetic_token_batches
    from repro_torch.train.elastic import LoopConfig, recoverable_train_loop
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    layers, b, s = TRAIN_F32
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              param_dtype="bfloat16")
    model = init_model(cfg, seed, device=DEVICE)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=6))
    saved = {}

    def step_fn(state, batch):
        model, opt = state
        model, opt, metrics = step(model, opt, batch)
        return (model, opt), metrics

    def on_metrics(n, m):
        if n == 2:
            saved["embed"] = model.embed.table.detach().clone()

    faults = {"armed": True}

    def fault_hook(n):
        if n == 3 and faults["armed"]:
            faults["armed"] = False
            saved["at_fault"] = model.embed.table.detach().clone()
            raise RuntimeError("simulated node failure")

    restored = {}
    with tempfile.TemporaryDirectory() as ckdir:
        ckpt = CheckpointManager(ckdir, keep=2)
        real_restore = ckpt.restore

        def restore(target, **kw):
            out = real_restore(target, **kw)
            restored["embed"] = model.embed.table.detach().clone()
            return out

        ckpt.restore = restore
        t0 = time.perf_counter()
        (model, opt), steps, restarts = recoverable_train_loop(
            (model, opt), synthetic_token_batches(cfg.vocab, b, s, seed=seed),
            step_fn, ckpt=ckpt,
            cfg=LoopConfig(total_steps=6, checkpoint_every=2),
            fault_hook=fault_hook, on_metrics=on_metrics)
        wall = time.perf_counter() - t0
        kept = ckpt.list_steps()
    torch.cuda.synchronize()
    check(restarts == 1 and steps == 6 and kept == [4, 6],
          f"recoverable loop: restarts={restarts} steps={steps} kept={kept}")
    check(torch.equal(restored["embed"], saved["embed"]),
          "the restore did not bring back the step-2 parameters")
    print(f"train (d) recoverable_train_loop, {layers} layers at full width:"
          f" a fault at step 3, restored from step 2 bit for bit, "
          f"restarts={restarts} steps={steps} checkpoints kept {kept} "
          f"wall_s={wall:.3f}", flush=True)


def _train_launcher(ckdir: str, steps: int, *extra: str) -> _Launcher:
    """(e): ``python -m repro_torch.launch.train --device cuda`` for
    ``steps`` steps, checkpointing into ``ckdir`` every 3."""
    return _Launcher("train (e)", "repro_torch.launch.train",
                     "--device", DEVICE, "--steps", str(steps),
                     "--checkpoint-dir", ckdir, "--checkpoint-every", "3",
                     *extra)


def train_phase(seed: int, beside_e=(), beside_resume=()) -> tuple:
    """The training slice at full width; returns the backward kernel's
    launches over the main path's run, the standard output of each
    process of ``beside_e`` (``_Launcher`` arguments of processes run
    beside (c)-(e), which leave the card mostly idle), then that of each
    process of ``beside_resume`` (run beside (e)'s ``--resume`` launcher,
    the phase's last and idlest part), and the median step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model
    from repro_torch.train.data import synthetic_token_batches
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(ARCH), param_dtype="bfloat16")
    model = init_model(cfg, seed, device=DEVICE)
    opt = init_opt_state(dict(model.named_parameters()))
    check(cfg.n_layers == 30 and cfg.d_model == 576 and cfg.vocab == 49152
          and "master" in opt, f"training {cfg.name} at {cfg.n_layers} "
                               f"layers")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=TRAIN_STEPS))
    data = synthetic_token_batches(cfg.vocab, TRAIN_B, TRAIN_S, seed=seed)
    batches = [next(data) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the main path: TRAIN_STEPS steps through both attention kernels
    losses, times, per_step = [], [], []
    reset_counts()
    for batch in batches[:TRAIN_STEPS]:
        before = read_counts()
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in
                         ("flash_attention", "flash_attention_bwd")})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(all(c == {"flash_attention": 2 * cfg.n_layers,
                    "flash_attention_bwd": cfg.n_layers} for c in per_step),
          f"per-step launches {per_step}")
    check(launches["flash_attention_bwd"] == TRAIN_STEPS * cfg.n_layers,
          f"train launches {launches}")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"loss did not fall: first {losses[0]}, mean "
                             f"of the last 5 {last5}")
    med = float(np.median(times[1:]))
    print(f"train (a) {cfg.name} B={TRAIN_B} S={TRAIN_S}, bf16 params + "
          f"f32 master, remat, {TRAIN_STEPS} steps: first step "
          f"{times[0]:.6f} s, median step {med:.6f} s, tokens_per_s="
          f"{TRAIN_B * TRAIN_S / med:.1f}, peak_memory_bytes={peak}, "
          f"launches per step {per_step[-1]}, total {launches}; loss first "
          f"{losses[0]:.6f}, mean of the last 5 {last5:.6f}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)

    # (b) where one step's device time goes
    split = _device_split("train (b) one step",
                          lambda: step(model, opt, batches[TRAIN_STEPS]),
                          bwd=True)
    busy = (None if split["other_ms"] is None
            else sum(split.values()) / 1e3 / med)
    print("train (b) one step, device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()) +
          f"; device busy share of the median step ({med:.6f} s, "
          f"unprofiled): {'not measured' if busy is None else f'{busy:.4f}'}",
          flush=True)
    del model, opt, batches
    torch.cuda.empty_cache()

    # (e) launch.train for 3 steps, beside (c) and (d), then --resume to 5
    with tempfile.TemporaryDirectory() as ckdir:
        first = _train_launcher(ckdir, 3)
        beside = [_Launcher(*a) for a in beside_e]
        _f32_step_card_vs_cpu(seed)
        _recovery(seed)
        outs = [first.finish()]
        resume = _train_launcher(ckdir, 5, "--resume")
        later = [_Launcher(*a) for a in beside_resume]
        outs.append(resume.finish())
        beside_outs = [launcher.finish() for launcher in beside]
        later_outs = [launcher.finish(echo=False) for launcher in later]
    check(f"device={DEVICE}" in outs[0] and "done: 3 steps" in outs[0],
          f"launch.train: {outs[0]}")
    check("resumed from step 3" in outs[1] and "done: 5 steps" in outs[1],
          f"launch.train --resume: {outs[1]}")
    return launches["flash_attention_bwd"], beside_outs, later_outs, med


# ------------------------------------------------- training of the families
def _families():
    """``tests/_torch_families.py``: the families' kernel widths, batches
    and attention sites, as the tests take them."""
    return _tests_module("_torch_families")


def _family_full(arch: str):
    """(b)'s config: ``arch`` at its published width, bf16 params (an f32
    master in the optimizer), cut to FAMILY_LAYERS where one card cannot
    hold 14 bytes a parameter of the whole depth."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    return cfg


def _family_f32_card_vs_cpu(arch: str, seed: int, rng, frames=None) -> None:
    """(a): one f32 step's loss and gradients of ``arch`` at (a)'s config,
    card against CPU from the same weights, and the backward kernel's
    launches equal to the model's attention sites."""
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.models import init_model

    fam = _families()
    cfg = fam.kernel_widths(reduce_config(get_config(arch)), "float32")
    cpu = init_model(cfg, seed, device="cpu")
    card = init_model(cfg, seed, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in fam.batch(
        cfg, FAMILY_F32_B, FAMILY_F32_S, rng, frames).items()}
    reset_counts()
    loss_d, g_d = _grads(card, cfg, {k: v.to(DEVICE)
                                     for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = read_counts()["flash_attention_bwd"]
    loss_h, g_h = _grads(cpu, cfg, batch)
    sites = fam.attention_sites(cfg)
    check(launches == sites, f"f32 {arch} step launched the backward "
                             f"{launches} times, not {sites}")
    rel = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
    check(rel <= 1e-5, f"f32 {arch} loss card {float(loss_d)} cpu "
                       f"{float(loss_h)}")
    worst, at = 0.0, None
    for name, gh in g_h.items():
        diff = float((g_d[name].cpu() - gh).abs().max())
        ratio = diff / max(float(gh.abs().max()), 1e-30)
        check(ratio <= GRAD_RTOL, f"f32 {arch} gradient {name}: max |diff| "
                                  f"{diff}, {ratio} of the leaf's largest")
        if ratio >= worst:
            worst, at = ratio, name
    extra = f", {batch['frames'].shape[1]} frames" if cfg.is_encdec else ""
    print(f"family train (a) {arch} f32, {cfg.n_layers} layers at d_model "
          f"{cfg.d_model}, heads of {cfg.head_dim}, B={FAMILY_F32_B} S="
          f"{FAMILY_F32_S}{extra}, card vs cpu: loss {float(loss_d):.7f} / "
          f"{float(loss_h):.7f} (rel {rel:.3g}); worst gradient diff "
          f"{worst:.3g} of its leaf's largest ({at}, of {len(g_h)} leaves); "
          f"flash_attention_bwd launches {launches} = attention sites",
          flush=True)


class _BwdBesidePlain:
    """A test-only patch of the attention backward that autograd calls
    (``ops.flash_attention_bwd``): each call runs the kernel and, on the
    same q, k, v, o, dO and lse, its plain version; kept for each call:
    its (B, H, KV, S, Skv, Dqk, Dv, causal) (``calls``) and each
    gradient's largest error over its row's largest |gradient|, that
    scale at least BWD_FLOOR of the call's largest (``errs``, as
    :func:`bwd_chain_errs` reads them); the kernel's gradients go on."""

    def __enter__(self):
        from unittest import mock

        from repro_torch.kernels.flash_attention import attention_bwd_ref, ops

        self.calls, self.errs = [], []
        real = ops.flash_attention_bwd

        def bwd(q, k, v, o, dout, lse, causal=True):
            got = real(q, k, v, o, dout, lse, causal=causal)
            want = attention_bwd_ref(q, k, v, o, dout, lse, causal=causal)
            floor = BWD_FLOOR * max(float(w.float().abs().max())
                                    for w in want)
            self.errs.append({g: bwd_row_err(a, w, floor) for g, a, w in
                              zip(("dq", "dk", "dv"), got, want)})
            self.calls.append((*q.shape[:2], k.shape[1], q.shape[2],
                               k.shape[2], q.shape[3], v.shape[3],
                               bool(causal)))
            return got

        self._patch = mock.patch.object(ops, "flash_attention_bwd", bwd)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def check(self, arch: str, sites: int, dtype) -> str:
        """Fails unless ``sites`` calls were made, each gradient within
        BWD_TOL[dtype]; returns a line of the worst errors by shape."""
        check(len(self.calls) == sites,
              f"{arch}: {len(self.calls)} backward calls beside the plain "
              f"version, not {sites}")
        worst = {}
        for call, errs in zip(self.calls, self.errs):
            for g, e in errs.items():
                check(e <= BWD_TOL[dtype],
                      f"{arch}: flash_attention_bwd {g} at {call} vs plain "
                      f"on the same inputs: {e} of its row's largest > "
                      f"{BWD_TOL[dtype]}")
            at = worst.setdefault(call, dict.fromkeys(errs, 0.0))
            for g, e in errs.items():
                at[g] = max(at[g], e)
        return "; ".join(
            f"{self.calls.count(c)} at {c[:7]} causal={c[7]}: " +
            ", ".join(f"{g} {e:.3g}" for g, e in w.items())
            for c, w in worst.items())


def _family_bf16_steps(arch: str, seed: int, rng) -> int:
    """(b): FAMILY_STEPS bf16 steps of ``arch`` at full width (f32 master,
    remat, AdamW), each launching the backward once per attention site,
    the first with every site's backward held against its plain version
    on the same inputs (:class:`_BwdBesidePlain`); returns the backward's
    launches over the steps."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = _family_full(arch)
    b = FAMILY_BATCH.get(arch, FAMILY_B)
    _free_card(f"family train (b) {arch}")
    t0 = time.perf_counter()
    model = _init_on_card(cfg, seed)
    opt = init_opt_state(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=FAMILY_STEPS))
    batches = [_families().batch(cfg, b, FAMILY_S, rng)
               for _ in range(FAMILY_STEPS + 1)]
    sites = _families().attention_sites(cfg)
    losses, times, per_step = [], [], []
    reset_counts()
    for i, batch in enumerate(batches[:FAMILY_STEPS]):
        bwd0 = read_counts()["flash_attention_bwd"]
        t0 = time.perf_counter()
        if i == 0:  # every backward site beside its plain version
            with _BwdBesidePlain() as beside:
                model, opt, metrics = step(model, opt, batch)
        else:
            model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
        per_step.append(read_counts()["flash_attention_bwd"] - bwd0)
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
    launches = read_counts()["flash_attention_bwd"]
    peak = torch.cuda.max_memory_allocated()
    against_plain = beside.check(arch, sites, torch.bfloat16)
    check(all(np.isfinite(losses)), f"{arch} train losses {losses}")
    check(per_step == [sites] * FAMILY_STEPS,
          f"{arch}: backward launches per step {per_step}, not {sites}")
    # every leaf's f32 master moved (a bf16 param of 1.0 may not: one of
    # its ulps is 2^-7), and every param is its master rounded to bf16
    still = [n for n, p in before.items()
             if torch.equal(opt["master"][n], p.float())]
    check(not still, f"{arch}: the master of {still} did not move")
    check(all(torch.equal(p, opt["master"][n].bfloat16())
              for n, p in model.named_parameters()),
          f"{arch}: params are not the master rounded to bf16")
    moved = sum(not torch.equal(p, before[n])
                for n, p in model.named_parameters())
    check(not torch.equal(model.embed.table, before["embed.table"]),
          f"{arch}: the bf16 embedding did not move")
    del before
    med = float(np.median(times[1:]))
    tokens = batches[0]["targets"].size
    depth = (f"{cfg.enc_layers} + {cfg.n_layers}" if cfg.is_encdec
             else cfg.n_layers)
    print(f"family train (b) {arch} {depth} layers at full width "
          f"(d_model {cfg.d_model}), B={b} S={FAMILY_S}, bf16 params + f32 "
          f"master, remat: init {init_s:.3f} s; first step {times[0]:.6f} s "
          f"(the plain backward beside each site), median step {med:.6f} "
          f"s, tokens_per_s={tokens / med:.1f}, peak_memory_bytes={peak} "
          f"(steps 2-{FAMILY_STEPS}); bf16 params moved {moved} of "
          f"{len(opt['master'])} (every master); flash_attention_bwd per step "
          f"{per_step[-1]} = attention sites; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"family train (b) {arch} step 1, flash_attention_bwd vs its plain "
          f"version on each site's inputs (of the row's largest, limit "
          f"{BWD_TOL[torch.bfloat16]}): {against_plain or 'no sites'}",
          flush=True)
    split = _device_split(f"family train (b) {arch} one step",
                          lambda: step(model, opt, batches[-1]), bwd=True)
    busy = (None if split["other_ms"] is None
            else sum(split.values()) / 1e3 / med)
    print(f"family train (b) {arch} one step, device time (torch.profiler): "
          + " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                     for k, v in split.items()) +
          f"; device busy share of the median step ({med:.6f} s, "
          f"unprofiled): {'not measured' if busy is None else f'{busy:.4f}'}",
          flush=True)
    del model, opt, step
    return launches


def family_launch_args(ckdir: str) -> tuple:
    """(d)'s ``_Launcher`` arguments: ``python -m repro_torch.launch.train
    --arch zamba2-1.2b --device cuda --steps 3 --batch 4 --seq 512`` at
    full width and depth, checkpointing into ``ckdir``.  It runs beside
    the train phase's (c)-(e), which leave the card mostly idle: its final
    checkpoint writes 18 GB (bf16 params, the f32 master, m and v)."""
    return ("family train (d)", "repro_torch.launch.train", "--arch",
            FAMILY_LAUNCH_ARCH, "--device", DEVICE, "--steps", "3",
            "--batch", "4", "--seq", str(FAMILY_S), "--checkpoint-dir",
            ckdir)


def family_train_phase(seed: int, launch_out: str) -> dict:
    """Training of the six non-dense families: (d) the output of
    :func:`family_launch_args`' run, checked; (a) an f32 step each at
    reduced width, card against CPU; (b) bf16 steps each at full width.
    Returns the backward kernel's launches of (b) by architecture."""
    check(f"arch={FAMILY_LAUNCH_ARCH}" in launch_out and "device=cuda"
          in launch_out and "done: 3 steps" in launch_out,
          f"launch.train zamba2: {launch_out}")
    last = next(x for x in launch_out.splitlines()
                if x.startswith("step     3"))
    check(np.isfinite(float(last.split()[3])), f"launch.train: {last}")
    rng = np.random.default_rng(seed + 9)
    for arch in FAMILY_ARCHS:
        _family_f32_card_vs_cpu(arch, seed, rng)
    _family_f32_card_vs_cpu(ENCDEC_ARCH, seed, rng, frames=FAMILY_F32_RAGGED)
    launches = {}
    for arch in FAMILY_ARCHS:
        launches[arch] = _family_bf16_steps(arch, seed, rng)
    _free_card("family train phase done")
    return launches


# ------------------------------------------- the dry run, and one of its cells
#: the card as ``nvidia-smi --query-gpu=name,power.limit`` gives it (set by
#: ``main``), beside every roofline share
CARD = "not read"
#: the cell of the table that (b) runs on the card at its production shape
DRYRUN_CELL = "prefill_32k"
#: (b)'s timed prefills after one warm-up, and the query rows of a layer-0
#: attention head group held against the plain version (the first and the
#: last, over all keys, in batch rows 0 and B - 1)
DRYRUN_TIMED = 2
DRYRUN_ROWS = 256
#: (a)'s processes, started together beside (b): (archs, shapes) each,
#: over one architecture of each family (smollm-135m the dense one, whose
#: row (b) reads), balanced by their walks' times on one host core
#: (zamba2-1.2b's train and prefill walks the longest); the other dense
#: architectures' cells are walked by tests/test_torch_dryrun.py.
#: falcon-mamba-7b's train_4k and prefill_32k are left out
#: (``DRYRUN_LEFT_OUT``): their walks loop over 16 and 128 scan chunks a
#: layer and take about 40 s each on one core, past (b)'s time
#: (tests/test_torch_dryrun_ssm.py walks them on the CPU, at 2 of their
#: 64 layers)
DRYRUN_GROUPS = (
    (("zamba2-1.2b",), ("train_4k",)),
    (("zamba2-1.2b",), ("prefill_32k", "decode_32k", "long_500k")),
    (("falcon-mamba-7b",), ("decode_32k", "long_500k")),
    (("seamless-m4t-medium", "deepseek-v2-lite-16b"), ("all",)),
    (("qwen3-moe-30b-a3b", "internvl2-26b", "smollm-135m"), ("all",)))
DRYRUN_LEFT_OUT = {("falcon-mamba-7b", "train_4k"),
                   ("falcon-mamba-7b", "prefill_32k")}


def _dryrun_jobs(out_root: str) -> list:
    """(a): ``python -m repro_torch.launch.dryrun --mesh single`` over the
    cells of ``DRYRUN_GROUPS`` but ``DRYRUN_LEFT_OUT``, in the processes
    of ``DRYRUN_GROUPS``, each writing its rows under ``out_root``;
    ``CUDA_VISIBLE_DEVICES`` is empty, so none can open a context on the
    card (the walk needs none)."""
    jobs = []
    for i, (archs, shapes) in enumerate(DRYRUN_GROUPS):
        jobs.append(_Launcher(
            f"dryrun (a) {','.join(archs)} x {','.join(shapes)}",
            "repro_torch.launch.dryrun", "--mesh", "single", "--arch",
            ",".join(archs), "--shape", ",".join(shapes), "--out",
            os.path.join(out_root, str(i)), env={"CUDA_VISIBLE_DEVICES": ""}))
    return jobs


def _dryrun_rows(jobs: list, out_root: str) -> dict:
    """Wait for (a)'s processes (each must exit 0) and return its rows by
    (arch, shape); every cell of ``DRYRUN_GROUPS`` but ``DRYRUN_LEFT_OUT``
    has one."""
    from repro_torch.configs.base import SHAPES

    for job in jobs:
        job.finish(echo=False)
    rows = {}
    for path in sorted(pathlib.Path(out_root).glob("*/1xh100.jsonl")):
        for line in path.read_text().splitlines():
            r = json.loads(line)
            rows[(r["arch"], r["shape"])] = r
    want = {(a, sh) for archs, shapes in DRYRUN_GROUPS for a in archs
            for sh in (SHAPES if shapes == ("all",) else shapes)}
    check(set(rows) == want and not want & DRYRUN_LEFT_OUT,
          f"dry run: rows for {sorted(rows)}")
    print(f"dryrun (a) {len(rows)} cells; left out (walked by "
          f"tests/test_torch_dryrun_ssm.py): {sorted(DRYRUN_LEFT_OUT)}",
          flush=True)
    return rows


def _rows_vs_plain(q, k, v, o, rows: slice) -> tuple:
    """For query ``rows`` of q [1, H, S, D] over all the causal keys of k,
    v [1, KV, S, D] (the plain scores of those rows only): the largest |o
    - plain| over FLASH_TOL times its row's largest |plain| value (a last
    row averages about 32k keys of unit scale, so its values are a few
    hundredths: an absolute limit would hold nothing), and the largest
    |plain| value."""
    g = q.shape[1] // k.shape[1]
    kr, vr = (x.float().repeat_interleave(g, 1) for x in (k, v))
    sc = q[:, :, rows].float() @ kr.transpose(-1, -2) / q.shape[-1] ** 0.5
    pos = torch.arange(k.shape[2], device=q.device)
    sc = sc.masked_fill(pos[None, :] > pos[rows][:, None], float("-inf"))
    want = torch.softmax(sc, dim=-1) @ vr
    scale = want.abs().amax(-1, keepdim=True)
    err = (o[:, :, rows].float() - want).abs()
    return (float((err / (FLASH_TOL[o.dtype] * scale)).max()),
            float(scale.max()))


def dryrun_phase(seed: int, train_med: float) -> int:
    """(a) the port's dry run over the table (``_dryrun_jobs``), run beside
    (b): every row ok or skipped, one line a cell, smollm-135m's
    prefill_32k ok and fitting the card, its decode_32k not; (b) that
    prefill cell on the card at its production shape: full-width
    smollm-135m in bf16 drawn on the card, ``make_prefill_step`` on B=32
    prompts of 32,768 tokens from the seed, a warm-up on one prompt and
    ``DRYRUN_TIMED`` timed calls (the first's launches counted: 30 of
    ``flash_attention``, layer 0's q, k, v and output kept), their median
    wall, peak memory beside
    the row's ``total_device_bytes``, the roofline share of the row's
    dominant term (at most 1.0), finite last logits, layer 0's attention
    rows held against the plain version, and the kernel at (32, 9, 3,
    32,768, 64) timed beside SDPA and its bound; (c) train (a)'s step
    (``train_med``, B=8 x S=2048) against the port's count of that step
    and 6·N·D.  Returns (b)'s ``flash_attention`` launches."""
    from unittest import mock

    from repro_torch.configs.base import ShapeSpec, get_config, get_shape
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic_cost import count_flops, tiling_of
    from repro_torch.launch.mesh import HBM_PER_CHIP, make_production_mesh
    from repro_torch.launch.roofline import model_flops_estimate
    from repro_torch.models import init_model, zoo
    from repro_torch.serve.serve_step import make_prefill_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    out_root = tempfile.mkdtemp(prefix="dryrun_torch_")
    jobs = _dryrun_jobs(out_root)

    # (b) the cell on the card, beside (a)
    shape = get_shape(DRYRUN_CELL)
    B, S = shape.global_batch, shape.seq_len
    scfg = dryrun.prefill_config(get_config(ARCH), shape,
                                 make_production_mesh())
    model = _init_on_card(scfg, seed)
    step = make_prefill_step(scfg, S, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    batch = {"tokens": torch.randint(0, scfg.vocab, (B, S), generator=gen,
                                     device=DEVICE, dtype=torch.int32)}
    site = {}
    real = flash_ops.flash_attention

    def first(q, k, v, **kw):  # layer 0's call: batch rows 0 and B - 1
        out = real(q, k, v, **kw)
        if not site:
            site.update({i: [x[i:i + 1].clone() for x in (q, k, v, out)]
                         for i in (0, q.shape[0] - 1)})
        return out

    # the warm-up: one prompt of the cell's length (at the full batch it
    # took as long as a timed call, 9.2-9.3 s, and read no different)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        step(model, {"tokens": batch["tokens"][:1]})
        torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    walls = []
    for i in range(DRYRUN_TIMED):
        # the first timed call is the main path's run: its launches are
        # counted and layer 0's q, k, v and output kept
        torch.cuda.reset_peak_memory_stats()
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), mock.patch.object(
                flash_ops, "flash_attention", first if i == 0 else real):
            logits, caches = step(model, batch)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        del caches
        if i == 0:
            launches = read_counts()
            check(launches["flash_attention"] == scfg.n_layers and all(
                n == 0 for k, n in launches.items()
                if k != "flash_attention"),
                f"dryrun (b) launches {launches}")
            over = {f"b{j} rows {r.start}-{r.stop - 1}":
                    _rows_vs_plain(*site[j], r)
                    for j in site for r in (slice(0, DRYRUN_ROWS),
                                            slice(S - DRYRUN_ROWS, S))}
            check(max(x for x, _ in over.values()) <= 1.0,
                  f"dryrun (b) layer 0 rows against the plain version: "
                  f"{over}")
            site.clear()
    check(logits.shape == (B, 1, scfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"dryrun (b) last logits {tuple(logits.shape)}")
    del logits, model
    torch.cuda.empty_cache()

    # the kernel alone at the cell's shape, beside SDPA and its bound
    kshape = (B, scfg.n_heads, scfg.n_kv_heads, S, scfg.head_dim)
    b, h, kv, _, d = kshape
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    q, k, v = (torch.randn(x, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)
               for x in ((b, h, S, d), (b, kv, S, d), (b, kv, S, d)))
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                      2, warmup=1)
    b_ms, b_by = flash_bound_ms(kshape, torch.bfloat16, True)
    del q, k, v
    torch.cuda.empty_cache()

    # (a) the table
    rows = _dryrun_rows(jobs, out_root)
    shutil.rmtree(out_root, ignore_errors=True)
    for (arch, name), r in sorted(rows.items()):
        check(r["status"] in ("ok", "skipped"),
              f"dryrun (a) {arch} x {name}: {r.get('error')}")
        if r["status"] == "skipped":
            print(f"dryrun (a) {arch} x {name}: skipped ({r['reason']})",
                  flush=True)
            continue
        t = r["roofline"]
        print(f"dryrun (a) {arch} x {name}: dominant={t['dominant']} "
              f"compute_s={t['compute_s']:.6g} memory_s={t['memory_s']:.6g}"
              f" total_device_bytes={r['memory']['total_device_bytes']:.6g}"
              f" fits_hbm={r['fits_hbm']} (walk {r['walk_s']} s)",
              flush=True)
    row = rows[(ARCH, DRYRUN_CELL)]
    check(row["status"] == "ok" and row["fits_hbm"],
          f"dryrun (a) {ARCH} x {DRYRUN_CELL}: {row}")
    check(rows[(ARCH, "decode_32k")]["status"] == "ok"
          and not rows[(ARCH, "decode_32k")]["fits_hbm"],
          f"dryrun (a) {ARCH} x decode_32k fits")

    t = row["roofline"]
    med = float(np.median(walls))
    dom = max(t["compute_s"], t["memory_s"], t["collective_s"])
    share = dom / med
    check(share <= 1.0, f"dryrun (b) roofline share {share} > 1: the "
                        f"count is wrong")
    print(f"dryrun (b) {ARCH} x {DRYRUN_CELL} on the card ({CARD}): "
          f"B={B} S={S}, warm-up (B=1) {warm:.6f} s, timed "
          f"{[round(w, 6) for w in walls]}"
          f", median wall {med:.6f} s; flash_attention launches "
          f"{launches['flash_attention']}; peak memory "
          f"(max_memory_allocated) {peak} bytes against the row's "
          f"total_device_bytes {row['memory']['total_device_bytes']:.0f} "
          f"({peak / row['memory']['total_device_bytes']:.4f}x; card "
          f"{HBM_PER_CHIP:.0f}); counted FLOPs {t['hlo_flops']:.6g} (of "
          f"which attention {row['attention_flops']:.6g}), dominant "
          f"{t['dominant']} {dom:.6f} s: roofline share {share:.4f} of "
          f"{BF16_FLOPS:.3g} FLOP/s; layer 0 against the plain version "
          f"(over FLASH_TOL x the row's largest |plain|; largest |plain|):"
          f" " + ", ".join(f"{k} {x:.4f} ({m:.4g})"
                           for k, (x, m) in over.items()),
          flush=True)
    print(f"dryrun (b) flash_attention {kshape} bf16 causal ({CARD}): "
          f"{ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}; {b_ms / ms:.3f} of "
          f"it), SDPA (enable_gqa) {sdpa_ms:.6f} ms (the kernel "
          f"{ms / sdpa_ms:.2f}x), plain version not measured (its scores "
          f"would take {B * scfg.n_heads * S * S * 4 / 1e12:.1f} TB)",
          flush=True)

    # (c) the train step's share against its count
    tcfg = dataclasses.replace(get_config(ARCH), param_dtype="bfloat16")
    mmodel = init_model(tcfg, device="meta")
    tshape = ShapeSpec("smoke_train", "train", TRAIN_S, TRAIN_B)
    flops = count_flops(make_train_step(tcfg), mmodel,
                        init_opt_state(dict(mmodel.named_parameters())),
                        zoo.input_specs(tcfg, tshape),
                        tiling=tiling_of(tcfg))
    six_nd = model_flops_estimate(tcfg, tshape)
    check(0 < flops / train_med / BF16_FLOPS <= 1.0,
          f"dryrun (c) share of {flops} FLOPs in {train_med} s")
    print(f"dryrun (c) train (a)'s step, {ARCH} B={TRAIN_B} S={TRAIN_S}, "
          f"median {train_med:.6f} s ({CARD}): counted FLOPs {flops:.6g}, "
          f"roofline share {flops / train_med / BF16_FLOPS:.4f} of "
          f"{BF16_FLOPS:.3g} FLOP/s; 6·N·D {six_nd:.6g}, share "
          f"{six_nd / train_med / BF16_FLOPS:.4f}", flush=True)
    return launches["flash_attention"]


# ------------------------------------------------------------ distributed
#: the ring on the card at smollm-135m's widths, (B, S, KV, G, D), in
#: RING_BLOCKS blocks of the sequence; f32 within the reference test's
#: bound, bf16 each row within RING_ROW_TOL of its largest |plain| value
RING_SHAPE = (2, 4096, 3, 3, 64)
RING_BLOCKS = 4
RING_TOL32, RING_ROW_TOL = 3e-5, 2e-2
#: the sharded train and serve at smollm-135m's full width
DIST_B, DIST_S, DIST_STEPS, DIST_NEW = 8, 512, 3, 16


def _ring_blocks(q, k, v, causal: bool) -> torch.Tensor:
    """``ring_step`` over ``RING_BLOCKS`` blocks of the sequence on one
    device: each query block over the key blocks in the ring's order (its
    own first, then the ones before it; those after it only when not
    causal), as a rank of a ring of that many would."""
    from repro_torch.distributed.ring_attention import ring_step

    B, S, KV, G, D = q.shape
    s = S // RING_BLOCKS
    out = []
    for i in range(RING_BLOCKS):
        qh = q[:, i * s:(i + 1) * s].permute(0, 2, 3, 1, 4).reshape(
            B, KV * G, s, D).contiguous()
        carry = None
        for hop in range(RING_BLOCKS):
            j = (i - hop) % RING_BLOCKS
            if causal and j > i:
                continue
            kb = k[:, j * s:(j + 1) * s].transpose(1, 2).contiguous()
            vb = v[:, j * s:(j + 1) * s].transpose(1, 2).contiguous()
            carry = ring_step(carry, qh, kb, vb, causal=causal and j == i)
        out.append(carry[0].reshape(B, KV, G, s, D).permute(0, 3, 1, 2, 4))
    return torch.cat(out, dim=1)


def _ring_err(got, want, dtype) -> tuple:
    """(max |err|, passes): f32 within RING_TOL32; bf16 each row within
    RING_ROW_TOL of its own largest |plain| value."""
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        return err.max().item(), err.max().item() < RING_TOL32
    ok = (err.amax(-1) <= RING_ROW_TOL * want.abs().amax(-1)).all().item()
    return err.max().item(), ok


def _dist_ring(mesh, seed: int) -> dict:
    """(a): the ring's blocks through the kernel, against the plain ring."""
    from repro_torch.distributed.ring_attention import (ring_attention,
                                                        ring_attention_ref)

    B, S, KV, G, D = RING_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    base = [torch.randn(shape, device=DEVICE, generator=g) for shape in (
        (B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D))]
    errs, times = {}, {}
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dtype) for x in base)
        for causal in (True, False):
            want = ring_attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal)
            before = read_counts()["flash_attention"]
            got = _ring_blocks(q, k, v, causal)
            n = read_counts()["flash_attention"] - before
            check(n == (RING_BLOCKS * (RING_BLOCKS + 1) // 2 if causal
                        else RING_BLOCKS ** 2), f"ring blocks launched {n}")
            err, ok = _ring_err(got, want, dtype)
            tag = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            check(ok, f"ring_step x{RING_BLOCKS} {tag}: max err {err}")
            whole = ring_attention(q, k, v, mesh=mesh,
                                   causal=causal).to_local()
            err1, ok1 = _ring_err(whole, want, dtype)
            check(ok1, f"ring_attention 1x1 {tag}: max err {err1}")
            errs[tag] = (err, err1)
    launches = read_counts()["flash_attention"]
    q, k, v = (x.to(torch.bfloat16) for x in base)
    times["ring_ms"] = cuda_ms(lambda: _ring_blocks(q, k, v, True), 3)
    times["plain_ms"] = cuda_ms(lambda: ring_attention_ref(
        q.float(), k.float(), v.float(), causal=True), 3)
    print(f"distributed (a) ring_step over {RING_BLOCKS} blocks of "
          f"{RING_SHAPE} and ring_attention on the 1x1 mesh, against the "
          f"plain ring (max |err|, blocks and 1x1): " + "; ".join(
              f"{k} {a:.3g} {b:.3g}" for k, (a, b) in errs.items()) +
          f"; flash_attention launches {launches}; bf16 causal "
          f"{RING_BLOCKS}-block ring {times['ring_ms']:.6f} ms, plain "
          f"ring {times['plain_ms']:.6f} ms", flush=True)
    return {"launches": launches, **times}


def _dist_grads(model, cfg, batch, scope):
    from repro_torch.models import loss_fn

    params = dict(model.named_parameters())
    with scope:
        model.requires_grad_(True)
        loss, _ = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        model.requires_grad_(False)
    return loss.detach(), dict(zip(params, grads))


def _dist_train(mesh, seed: int) -> dict:
    """(b): step 1's loss and every gradient leaf of the sharded model
    (``choose_policy``'s layout on the 1x1 mesh) bit for bit the
    unsharded model's, then both trained DIST_STEPS steps, timed."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ctx import dp_rules, use_sharding
    from repro_torch.train.data import synthetic_token_batches
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(ARCH), param_dtype="bfloat16")
    mode = shd.choose_policy(cfg, mesh, "train")
    check(mode == "dp_train", f"choose_policy picked {mode}")
    scope = functools.partial(use_sharding, dp_rules(mesh.axis_names), mesh)
    data = synthetic_token_batches(cfg.vocab, DIST_B, DIST_S, seed=seed)
    batches = [{k: torch.as_tensor(v).to(DEVICE) for k, v in
                next(data).items()} for _ in range(DIST_STEPS)]
    plain = _init_on_card(cfg, seed)
    sharded = shd.shard_model(_init_on_card(cfg, seed), cfg, mesh, mode=mode)
    lp, gp = _dist_grads(plain, cfg, batches[0], contextlib.nullcontext())
    ls, gs = _dist_grads(sharded, cfg, batches[0], scope())
    check(torch.equal(lp, ls), f"sharded loss {ls.item()} != {lp.item()}")
    differ = [n for n, g in gp.items() if not torch.equal(g, gs[n].to_local())]
    check(not differ, f"gradient leaves not bit for bit: {differ[:4]}")
    del gp, gs
    out = {"loss": lp.item(), "leaves": len(dict(plain.named_parameters()))}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=DIST_STEPS)
    for name, model, ctx in (("unsharded", plain, contextlib.nullcontext),
                             ("sharded", sharded, scope)):
        step = make_train_step(cfg, opt_cfg)
        opt = init_opt_state(dict(model.named_parameters()))
        times, losses = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx():
                model, opt, m = step(model, opt, batch)
            losses.append(m["loss"].item())  # synchronises
            times.append(time.perf_counter() - t0)
        out[name] = {"median_s": float(np.median(times[1:])),
                     "losses": losses}
        del opt
    check(out["sharded"]["losses"] == out["unsharded"]["losses"],
          f"losses {out['sharded']['losses']} != "
          f"{out['unsharded']['losses']}")
    print(f"distributed (b) {cfg.name} B={DIST_B} S={DIST_S} bf16, "
          f"policy {mode} on the 1x1 NCCL mesh: step 1's loss "
          f"{out['loss']:.6f} and all {out['leaves']} gradient leaves bit "
          f"for bit the unsharded step's; {DIST_STEPS} steps, losses equal "
          f"{[round(x, 4) for x in out['sharded']['losses']]}; median step "
          f"sharded {out['sharded']['median_s']:.6f} s, unsharded "
          f"{out['unsharded']['median_s']:.6f} s", flush=True)
    return out


def _serve_tokens(model, cfg, scope) -> tuple:
    """``launch.serve``'s loop: DIST_B prompts of DIST_S tokens from a CPU
    generator seeded with 1, a prefill and DIST_NEW greedy decode steps;
    (tokens [B, 1 + DIST_NEW], prefill s, decode s)."""
    from repro_torch.serve.serve_step import (make_decode_step,
                                              make_prefill_step)

    max_len = DIST_S + DIST_NEW + 8
    prompts = torch.randint(0, cfg.vocab, (DIST_B, DIST_S),
                            generator=torch.Generator().manual_seed(1)
                            ).to(DEVICE)
    prefill = make_prefill_step(cfg, max_len, device=DEVICE)
    decode = make_decode_step(cfg, device=DEVICE)
    with torch.no_grad(), scope:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(model, {"tokens": prompts})
        tok = torch.argmax(logits[:, -1:], -1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new = [tok]
        for i in range(DIST_NEW):
            logits, caches = decode(model, caches, {"tokens": tok},
                                    DIST_S + i)
            tok = torch.argmax(logits[:, -1:], -1)
            new.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return torch.cat(new, dim=1).cpu(), t1 - t0, t2 - t1


def _dist_serve(mesh) -> dict:
    """(c): ``launch.serve``'s weights (a CUDA generator seeded with 0)
    and prompts, unsharded and sharded (``mode="serve"``, the cache placed
    by sequence): the same tokens."""
    from repro_torch.configs.base import get_config, make_serve_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ctx import SERVE_RULES_1POD, use_sharding

    cfg = dataclasses.replace(make_serve_config(get_config(ARCH), 1),
                              kv_cache_shard="seq")
    plain = _init_on_card(cfg, 0)
    want, pre_p, dec_p = _serve_tokens(plain, cfg, contextlib.nullcontext())
    del plain
    sharded = shd.shard_model(_init_on_card(cfg, 0), cfg, mesh, mode="serve")
    got, pre_s, dec_s = _serve_tokens(
        sharded, cfg, use_sharding(SERVE_RULES_1POD, mesh))
    check(torch.equal(got, want), "sharded serve tokens differ")
    digest = hashlib.sha256(want.to(torch.int64).numpy().tobytes()
                            ).hexdigest()[:16]
    print(f"distributed (c) {cfg.name} serve B={DIST_B} prompts of {DIST_S}"
          f", {DIST_NEW} new tokens, cache placed by sequence on the 1x1 "
          f"mesh: tokens equal the unsharded serve's (sha256={digest}); "
          f"prefill sharded {pre_s:.6f} s, unsharded {pre_p:.6f} s; decode "
          f"tokens/s sharded {DIST_B * DIST_NEW / dec_s:.1f}, unsharded "
          f"{DIST_B * DIST_NEW / dec_p:.1f}", flush=True)
    return {"digest": digest, "prefill_s": [pre_s, pre_p],
            "decode_tok_s": [DIST_B * DIST_NEW / dec_s,
                             DIST_B * DIST_NEW / dec_p]}


def _dist_sync_and_checkpoint(mesh, seed: int) -> None:
    """(d): one int8 error-feedback all-reduce and one checkpoint save /
    restore of a DTensor on the NCCL group."""
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.train.checkpoint import CheckpointManager

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    grad = torch.randn(1 << 20, device=DEVICE, generator=g)
    synced, res = compressed_psum(grad, torch.zeros_like(grad),
                                  group=mesh.device_mesh.get_group("data"))
    sent = dequantize_int8(*quantize_int8(grad))
    check(torch.equal(synced, sent) and torch.equal(res, grad - sent),
          "compressed_psum on one rank is not its own dequantized payload")
    w = NamedSharding(mesh, P("data", None)).distribute(
        torch.randn(256, 512, device=DEVICE, generator=g))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"w": w})
        got, _ = mgr.restore({"w": torch.zeros(256, 512)}, shardings={
            "w": NamedSharding(mesh, P(None, "model"))})
    check(torch.equal(got["w"].to_local(), w.to_local()),
          "checkpoint restore differs")
    print(f"distributed (d) compressed_psum of {grad.numel()} values on the "
          f"NCCL group: the dequantized int8 payload, residual exact; "
          f"checkpoint of a DTensor saved and restored onto another "
          f"placement, bit for bit", flush=True)


def distributed_worker(out_path: str, seed: int) -> int:
    """The distributed phase's own process (NCCL state stays in it): a
    one-rank NCCL group and the 1x1 mesh over it, (a)-(d), a JSON summary
    to ``out_path``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_mesh((1, 1), "cuda")
    check(dist.get_backend() == "nccl" and mesh.device_mesh is not None,
          f"the mesh's group runs {dist.get_backend()}")
    walls, t0 = [], time.perf_counter()
    out = {"ring": _dist_ring(mesh, seed)}
    walls.append(time.perf_counter())
    out["train"] = _dist_train(mesh, seed)
    walls.append(time.perf_counter())
    out["serve"] = _dist_serve(mesh)
    walls.append(time.perf_counter())
    _dist_sync_and_checkpoint(mesh, seed)
    walls.append(time.perf_counter())
    print("distributed (a)-(d) wall_s " + " ".join(
        f"{k}={b - a:.3f}" for k, a, b in zip("abcd", [t0] + walls, walls)),
        flush=True)
    pathlib.Path(out_path).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def distributed_launch_args(out_dir: str, seed: int) -> list:
    """The distributed phase's processes, as ``_Launcher`` arguments: its
    own (a)-(d) (``distributed_worker``, writing its summary to
    ``<out_dir>/distributed.json``) and, beside it, (e) ``launch.train
    --mesh 1,1`` and (f) ``launch.serve --mesh 1,1 --kv-shard seq``.  They
    run beside train (e)'s ``--resume`` launcher."""
    return [("distributed (a)-(d)", str(ROOT / "chip_smoke.py"),
             "--distributed-worker", os.path.join(out_dir, "distributed.json"),
             "--seed", str(seed)),
            ("distributed (e)", "repro_torch.launch.train", "--arch", ARCH,
             "--mesh", "1,1", "--device", DEVICE, "--batch", str(DIST_B),
             "--seq", str(DIST_S), "--steps", str(DIST_STEPS),
             "--checkpoint-dir", os.path.join(out_dir, "ckpt"),
             "--checkpoint-every", str(DIST_STEPS)),
            ("distributed (f)", "repro_torch.launch.serve", "--arch", ARCH,
             "--mesh", "1,1", "--kv-shard", "seq", "--batch", str(DIST_B),
             "--prompt-len", str(DIST_S), "--max-new", str(DIST_NEW),
             "--device", DEVICE)]


def distributed_phase(out_dir: str, outs: list) -> int:
    """``distributed/`` on the card, from the processes of
    ``distributed_launch_args`` (their standard outputs ``outs``): (a)-(d)
    printed, (e) trained under ``dp_train``, (f)'s tokens those of (c)'s
    unsharded serve; the ring's ``flash_attention`` launches."""
    worker, train, serve = outs
    print(worker, end="", flush=True)
    for label, out in (("distributed (e)", train), ("distributed (f)", serve)):
        print(f"{label}: " + " | ".join(out.strip().splitlines()), flush=True)
    res = json.loads(pathlib.Path(out_dir, "distributed.json").read_text())
    check("policy dp_train" in train and f"done: {DIST_STEPS} steps" in train,
          f"launch.train --mesh 1,1: {train}")
    check(f"sha256={res['serve']['digest']}" in serve,
          f"launch.serve --mesh 1,1 --kv-shard seq: tokens differ from the "
          f"unsharded serve's ({res['serve']['digest']}): {serve}")
    return res["ring"]["launches"]


def _phase(name: str, fn, *args):
    """``fn(*args)``, with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed-worker", default="",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.distributed_worker:
        return distributed_worker(args.distributed_worker, args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.video_gen import generate, sparse_spec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build_s={build_all():.3f}", flush=True)

    numbers = {"decode_gop_blocks": decode_kernel_phase(args.seed)}
    numbers.update(encode_kernel_phase(args.seed))
    numbers["flash_attention"] = flash_kernel_phase(args.seed)
    numbers["sad_search"] = sad_kernel_phase(args.seed)

    t0 = time.perf_counter()
    frames, dets = generate(sparse_spec(seed=args.seed, height=H, width=W,
                                        n_frames=N_FRAMES))
    print(f"generate_s={time.perf_counter() - t0:.3f}", flush=True)
    motion = motion_path_phase(args.seed, frames)
    store, ingest = ingest_phase(frames, dets)
    scan, oracle = scan_phase(store)
    _phase("video server", video_server_phase, store, oracle)
    store.close()
    del store, oracle
    cli_server_phase(args.seed)
    _phase("cluster", cluster_phase, args.seed)
    for mode in ("inline", "background"):
        retile_phase(frames, dets, mode)
    race = _phase("tuner race", tuner_race_phase, frames, dets)
    del frames
    calibration_phase()
    entry = _phase("entry points", entry_points_phase)
    _phase("serve", serve_phase, args.seed)
    moe = _phase("moe serve", moe_serve_phase, args.seed)
    hybrid = _phase("ssm serve", ssm_serve_phase, args.seed)
    mla = _phase("mla serve", mla_serve_phase, args.seed)
    encdec = _phase("encdec serve", encdec_serve_phase, args.seed)
    vlm, pipe = _phase("vlm serve", vlm_serve_phase, args.seed)
    numbers["flash_attention_bwd"] = flash_bwd_kernel_phase(args.seed)
    # the server drill of scripts/server_smoke_torch.py and the family
    # train phase's launch.train (d), beside train (c)-(e); the
    # distributed phase's processes beside train (e)'s resume
    with tempfile.TemporaryDirectory() as ckdir, \
            tempfile.TemporaryDirectory() as dist_dir:
        train, (_, family_out), dist_outs, train_med = _phase(
            "train", train_phase, args.seed, [
                ("entry point", str(ROOT / "scripts" /
                                    "server_smoke_torch.py"),
                 "--transport", "shm", "--device", DEVICE),
                family_launch_args(ckdir)],
            distributed_launch_args(dist_dir, args.seed))
        ring = _phase("distributed", distributed_phase, dist_dir, dist_outs)
    families = _phase("family train", family_train_phase, args.seed,
                      family_out)
    prefill_32k = _phase("dryrun", dryrun_phase, args.seed, train_med)

    now = {"decode_gop_blocks F=16 M=32768":
           numbers["decode_gop_blocks"]["ms"],
           f"flash_attention {FLASH_MAIN} bf16 causal":
           numbers["flash_attention"]["smollm_ms"],
           f"flash_attention {FLASH_LONG} bf16 causal":
           numbers["flash_attention"]["long_ms"],
           f"dct_quant N={H * W // 64} inter": numbers["dct_quant"]["ms"],
           f"idct_dequant N={H * W // 64} inter":
           numbers["idct_dequant"]["ms"],
           **numbers["sad_search"]["by_shape"],
           f"flash_attention_bwd {BWD_MAIN} bf16 causal":
           numbers["flash_attention_bwd"]["ms"]}
    print("redesigned kernels, this run against the time before the "
          "redesign (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): " +
          "; ".join(f"{k}: {now[k]:.6f} ms, before {v:.6f} ms "
                    f"({v / now[k]:.2f}x)"
                    for k, v in BEFORE_REDESIGN.items()), flush=True)

    launches = {"decode_gop_blocks": scan["decode_gop_blocks"],
                "dct_quant": ingest["dct_quant"],
                "idct_dequant": ingest["idct_dequant"],
                "flash_attention": encdec,
                "sad_search": motion, "flash_attention_bwd": train}
    by_path = {"flash_attention": {"seamless_prefill": encdec,
                                   "smollm_prefill_32k": prefill_32k,
                                   "ring_attention": ring,
                                   "internvl2_prefill": vlm,
                                   "pipeline": pipe["flash_attention"],
                                   "mla_prefill": mla,
                                   "zamba2_prefill": hybrid,
                                   "moe_prefill": moe,
                                   **{ex: entry[ex]["flash_attention"]
                                      for ex in ("serve_lm_torch",
                                                 "continuous_batching_torch",
                                                 "smoke_models_torch")}},
               "flash_attention_bwd": {"smollm_train": train, **{
                   f"{arch}_train": n for arch, n in families.items()}},
               **{name: {"pipeline": pipe[name], "tuner_race": race[name],
                         **{ex: entry[ex][name] for ex in (
                             "quickstart_torch", "incremental_workload_torch",
                             "edge_tiling_torch")}}
                  for name in ("decode_gop_blocks", "dct_quant",
                               "idct_dequant")}}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", **KERNELS[name],
        "launches": launches[name],
        **({"launches_by_path": by_path[name]} if name in by_path else {}),
        "max_abs_err": numbers[name]["max_abs_err"],
        "ms": numbers[name]["ms"], "plain_ms": numbers[name]["plain_ms"],
        "bound_ms": numbers[name]["bound_ms"],
        "bound_by": numbers[name]["bound_by"],
        "library_ms": numbers[name].get("library_ms")}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
