#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (needs one card)
    python3 chip_smoke.py --profile  # + profiles of one served batch and
                                     #   of one SQuAD, one NER, one
                                     #   MiniLM and each LM's train step

Phases:
1. Build: compiles the port's CUDA sources (one nvcc per source, side by
   side) for sm_90a into build/ and prints the card, the versions, the
   build time, ptxas' registers and spills per kernel and the kernels
   whose wgmmas ptxas serialized.
2. Forward kernel: runs K1 (flash-attention forward) through its wrapper
   against its plain PyTorch version on the card -- [8,12,512,64] in
   bf16 and f32, causal and not, the served call itself (q/k/v as
   strided views into a fused [32,512,3,12,64] qkv projection, bf16;
   the adaptive batcher grows the served batches to 32), cross-length
   causal [1,2,128->384,128], and the logsumexp output at [2,4,256,64]
   -- and times the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only; the port never calls
   it). Every f32 case must run K1's f32 tensor-core kernel (phase 25;
   counted in f32tc_launches).
3. Backward kernels: runs K1 without and with logsumexp (out and lse),
   then K2 (dQ and delta) and K3 (dK/dV) on the kernel's checked out and
   lse, each through its wrapper against its plain version on the card
   (bf16 runs the Hopper kernels of phases 22 and 23, f32 K2 and K3 the
   tensor-core kernels of phase 24 and f32 K1 and K1-lse that of phase
   25; every case fails unless K1, K2 and K3 ran where _fwd_entry and
   _bwd_entry send it) -- the trained
   call ([48,12,384,64] q/k/v as views into a
   [48,384,3,12,64] projection, random dO) in bf16 and f32, causal
   [8,12,512,64] bf16, cross-length causal [1,2,128->384,128] in bf16
   and f32 -- and times each kernel (CUDA events, and profiler device
   time), its plain version and SDPA: its forward at inference and with
   inputs that need a gradient (beside K1 and K1 with logsumexp), and its
   backward alone, replayed on one retained graph (beside K2 + K3); where
   the lengths differ under causal, or a mask stands beside it, SDPA
   takes the bottom-right diagonal as an explicit boolean mask.
4. Masked kernels: the same checks and timings with a key-padding mask
   (SDPA takes it as a boolean attn_mask [B,1,1,Lk]) -- the NER trained
   call ([32,12,128,64] views into the qkv projection, synthetic real
   lengths uniform in [2,128], one left-padded row) in bf16 and f32, a
   padded SQuAD call ([48,12,384,64] bf16, lengths in [64,384]),
   cross-length causal [1,2,128->384,128] with left padding (rows that
   see no key) in bf16 and f32, and a batch row with no real token in
   bf16 and f32; every bf16 K1, K1-lse, K2 and K3 launch must run the
   Hopper kernels (phases 22 and 23; counted in sm90_launches,
   _check_sm90). Also checks that padded keys get exactly
   zero dK (and
   dV, where every row sees a key) and rows that see no key exactly zero
   dQ. Bounds count the visible pairs' flops and the K/V bytes of the
   keys some row sees.
5. Serving: saves a seeded BERT-base BERTClassifier (bf16) in the JAX
   package's layout (config.json and an Estimator checkpoint of flax
   msgpack, utils/flax_msgpack.py), serves 64 requests of 512 tokens
   through the port's launch() -> ServingWorker -> InferenceModel with
   zoo.ops.attention_impl = "flash" (every batch
   bucket the batcher can emit is warmed first), checks that
   every request is answered once with finite logits, that K1 ran for
   every encoder layer of every dispatched batch, every launch on the
   Hopper kernel (flash_attn_fwd_sm90.cu, counted in sm90_launches) and
   none on the older one, and that 4 replies match the same model run
   with the einsum attention path.
6. Learn: fine-tunes a seeded BERT-base BERTSQuAD (bf16 encoder, seq 384,
   batch 48, random token ids and spans) through ZooModel.fit ->
   Estimator.fit for 2 epochs of 16 steps (the first warms up, the second
   is timed) with zoo.ops.attention_impl = "flash"; checks finite losses
   and that K1, K2 and K3 each launched at least 12 times per step (every
   K1-lse, K2 and K3 launch on the Hopper kernels: 384 each); runs
   evaluate and predict on the same Estimator; and, before the fit, holds
   one step's gradients (hidden dropout off) with flash attention against
   the same step with einsum attention in f32 (F32_GRAD_TOL), and in
   bf16 each path's distance from the f32 step (flash's within
   BF16_GRAD_RATIO x einsum's + BF16_GRAD_SLACK); it repeats the flash
   step with the backward's wiring broken on purpose (dQ zeroed; dK and
   dV swapped) and fails unless the f32 check and the bf16 bound each
   reject each broken step. Prints
   steps/s, samples/s, tokens/s, MFU (bench.py's formula against 989
   TFLOP/s bf16) and peak device memory.
7. NER learn: the same code for BERT-base BERTNER (bert-base-cased,
   vocab 28996, 9 tags, seq 128, batch 32, bf16 encoder) on padded
   batches of synthetic traffic (random ids, real lengths uniform in
   [2,128], attention_mask, tags -1 on padding). The gradient checks
   run with the mask and without it (the learn phase does so for any
   padded batch); the planted fault is
   the mask dropped from K2 and K3, which the f32 check and the bf16
   bound must reject; K1,
   K2 and K3 must each launch with the mask at least 12 times per step,
   every K1-lse, K2 and K3 launch on the Hopper kernels (384 each,
   counted in sm90_launches);
   predict reports token accuracy and the fitted model is saved (the
   same flax msgpack layout, optimizer state included). Prints real and
   padded tokens/s; MFU counts padded tokens.
8. NER serving: the same serving code for the saved NER model, loaded
   through InferenceModel from that layout, every bucket warmed with a
   padded example, 64 padded requests (input_ids and attention_mask,
   128 each) through a ServingWorker on the memory queue whose input_fn
   passes both tensors; K1 must run with the mask for every encoder
   layer of every dispatched batch, every launch on K1's Hopper kernel
   (sm90_launches), and 4 replies match the einsum path at real tokens.

9. K5b kernels: K1 at head dims that are not a multiple of 64 (the
   stock-kernel branch the reference takes at such head dims; bf16 on
   K1's Hopper kernel, every launch counted in sm90_launches, f32 on its
   f32 tensor-core kernel),
   through the flash_attention wrapper against its plain version on the
   card: every instantiation once (D = 8..120 in steps of 8 but not 64,
   bf16 and f32, with and without a key-padding mask, with logsumexp),
   then TinyGenLM's prefill calls ([1,32,2048,80] and [1,32,512,80] f32
   causal at Phi-2's widths, [1,2,256,16] f32 causal at the repo
   geometry), [8,32,1024,80] bf16 causal, a masked bf16 call at
   MiniLM-L12-H384's heads ([32,12,128,32], one left-padded row, one row
   with no real token) and [2,4,256,40] with logsumexp in both dtypes
   (D = 8 mod 16) and [8,12,512,20] bf16 causal (zero-padded to 24),
   each timed beside its plain version, SDPA and its bound. Head dims
   that are not a multiple of 8 (12, 20, 100) run zero-padded to the
   next one: K1, and K1-lse, K2 and K3 under autograd, must match their
   plain versions at the true head dim (bf16 and f32), with every launch
   counted as K5b. Every f32 K1 launch here must be K1's f32 tensor-core
   kernel's (phase 25), and every f32 K2 and K3 launch K2's and K3's
   (phase 24).
10. K5b backward kernels: K2 and K3 (and K1 with logsumexp) at the same
   head dims, through backward_phase: every instantiation once ([4,2,128,
   128,d], D = 8..120 but not 64, bf16 and f32, without a mask and with
   one holding a full row, a row of 2, a left-padded row and a row with
   no real token, causal at lq == lk and not; one summary line, and each
   case must count one K2 and one K3 launch in small_d_launches, every
   bf16 one on K2's and K3's Hopper kernels, phase 23), then
   MiniLM-L12-H384's trained call ([48,12,384,32] bf16 views into the
   qkv projection) without a mask and padded (lengths uniform in [64,
   384]), timed as phase 3 times the BERT-base call.
11. MiniLM learn: the learn phase's code for BERTSQuAD at
   MiniLM-L12-H384's published widths (vocab 30522, hidden 384, 12
   layers, 12 heads of 32, intermediate 1536, bf16 encoder; 48 x 384, 2
   epochs of 16 steps) on padded batches of synthetic traffic (real
   lengths uniform in [64, 384], spans inside them). The gradient checks
   run with the mask and without it; the f32 check and the bf16 bound
   must each reject dQ zeroed, dK and dV swapped and the mask dropped
   from K2 and K3. K1, K2
   and K3 must each launch with the mask at least 12 times a step, every
   launch a K5b one (small_d_launches), every K1-lse, K2 and K3 launch
   on the Hopper kernels (384 each, sm90_launches). Prints real and
   padded tokens/s,
   MFU (padded tokens) and peak memory.
12. Generation, repo geometry: TinyGenLM as the launcher documents it
   (vocab 64, dim 32, 2 heads of 16, 2 layers, max_len 256, 8 slots,
   page 16) served through launch() with a generation: block ->
   GenerationWorker -> DecodeEngine -> PagedKVCache, with
   zoo.ops.attention_impl = "flash": 500 synthetic requests (prompt
   lengths uniform in [1, 240], __max_tokens__ 16), at most 8
   outstanding. Every stream must get contiguous chunks and one terminal
   chunk with in-range tokens, K5b must launch once a layer for every
   prefill in a bucket of 128 tokens or more (warm-up included), every
   launch on K1's f32 tensor-core kernel (phase 25; the model is f32, as
   at every width up to Gemma-2B's), and every stream must be
   token-exact against reference_generate. Prints
   TTFT and inter-token p50/p99, tokens/s, decode-step wall and device
   time (a profile with all slots live), prefill ms by bucket, KV-pool
   bytes and peak memory.
13. Generation, Phi-2 widths: the same at microsoft/phi-2's published
   widths in TinyGenLM's block (hidden 2560, 32 heads of 80, 32 layers,
   intermediate 10240, vocab 51200, max_len 2048; f32, seeded weights):
   32 synthetic requests (prompts uniform in [128, 2016],
   __max_tokens__ 32); the first 16 tokens of 4 streams against
   reference_generate, where a divergence at a top-1 - top-2 logit gap
   under 1e-3 is reported as an f32 tie and ends that comparison.
14. K1 wide kernels: K1 at head dims 192 and 256 (the reference's Pallas
   kernel at D % 64 == 0 above 128), through the flash_attention wrapper
   against its plain version: every instantiation once (bf16 and f32,
   causal and not, with and without logsumexp, lq == lk and lq < lk; one
   summary line, each launch counted in wide_d_launches), then the
   full-width prefill call at Gemma-2B's widths ([1,8,8192,256] f32
   causal), K1 with logsumexp at its 2048 bucket and bf16 calls at D =
   256 and 192 ([8,8,2048,d] causal), each timed beside its plain
   version, SDPA and its bound. f32 here runs K1's f32 tensor-core
   kernel (phase 25), bf16 the Hopper kernel (phase 22).
15. Generation, Gemma-2B widths: the generation phase at google/gemma-2b's
   published widths in TinyGenLM's block (hidden 2048, 8 heads of 256,
   18 layers, intermediate 16384, vocab 256000, max_len 8192; f32,
   seeded weights; not Gemma's RMSNorm, RoPE, GeGLU, tied head or single
   KV head), after the Phi-2 phase's memory is freed: 32 synthetic
   requests (prompts uniform in [128, 8160], __max_tokens__ 32), 4
   streams checked as at Phi-2's widths; K1 at D = 256 must launch once
   a layer for every prefill in a bucket of 128 or more (wide_d_launches),
   every launch on K1's f32 tensor-core kernel.
16. K2/K3 wide kernels: K1, K1 with logsumexp, K2 and K3 at head dims 192
   and 256 through backward_phase: every instantiation once (bf16 and
   f32, causal and not, lq == lk and lq < lk; one summary line, each
   launch counted in wide_d_launches), then the GPT-J-width LM's trained
   call ([4,16,2048,256] bf16 causal, views into the qkv projection), its
   f32 gradient check's call ([1,16,2048,256]) and [4,16,2048,192] bf16,
   the f32 one timed beside its plain version, SDPA and its bound (bf16
   there runs the Hopper kernels, which phase 23 times; f32 K2 and K3
   the tensor-core kernels of phase 24, each launch counted in
   f32tc_launches).
17. GPT-J-width LM: TransformerModule at EleutherAI/gpt-j-6b's published
   widths (hidden 4096, 16 heads of 256, intermediate 16384, vocab 50400,
   2048 positions, LayerNorm epsilon 1e-5, no dropout; 8 of its 28
   layers; bf16 blocks, f32 parameters and an untied f32 head; post-LN,
   learned positions, seeded weights) trained as a causal LM through
   Estimator(module, loss="sparse_categorical_crossentropy",
   optimizer=Adam).fit on a synthetic next-token stream (lm_data, 4 x
   2048 tokens a step, 2 epochs of 8 steps, the second timed). Before the
   fit, one step's gradients flash against einsum at batch 1, in f32 (it
   must reject dQ zeroed and dK and dV swapped) and bf16. K1-lse, K2 and
   K3 must each launch exactly 8 times a step (once a layer), every launch
   a wide one
   (D = 256), every K1-lse, K2 and K3 launch on the Hopper kernels (128
   each), and the last logged loss must be below the first. Prints
   steps/s, tokens/s, MFU (bench.py's formula), peak memory and the
   logged losses.
18. K1 wider kernels: K1 at head dims 320, 384, 448 and 512 (the
   reference's Pallas kernel at D % 64 == 0 above 256; bf16 on K1's
   Hopper kernel, flash_fwd_sm90_split_kernel: 64-row q blocks, O's head
   dim split between two consumer warpgroups) through the
   flash_attention wrapper against its plain version: every
   instantiation once (bf16 and f32, causal and not, with and without
   logsumexp, lq == lk and lq < lk; in bf16 also q/k/v views into a fused
   projection, lq 192 (three 64-row blocks) and lk 320; one summary
   line, each launch counted in wide_d_launches, every bf16 one in
   sm90_launches and every f32 one on K1's f32 tensor-core kernel, phase
   25), then 30 identical launches each of a causal [2,4,512,512] K1-lse
   and a [1,2,192,448] K1-lse call, whose O and logsumexp must be bit
   for bit the same every time, then the prefill call at
   DeepSeek-V4-Flash's attention widths ([1,64,2048,512] causal) in bf16
   with and without logsumexp, and bf16 at D = 384, each timed beside
   its plain version, SDPA and its bound (phase 25 times the f32
   call).
19. Generation, DeepSeek-V4-Flash widths, over HTTP: TinyGenLM at
   deepseek-ai/DeepSeek-V4-Flash's published attention widths (hidden
   4096, 64 heads of 512, vocab 129280; 4 of 43 layers, 2048 of its
   positions, 64 K/V heads in place of its one shared, a dense ReLU MLP
   at ratio 4 in place of its MoE; f32, seeded weights), launched from a
   stock config (no http: block, so the HTTP frontend starts on loopback
   at a free port) after the earlier phases' memory is freed: 32
   synthetic prompts uniform in [128, 2016], 32 tokens each, as POST
   /generate SSE streams (urllib, at most 8 outstanding), with GET
   /metrics and /healthz answering 200 during the burst. Every stream
   must carry one meta event, contiguous chunks, exactly one terminal
   event and no error event; K1 at D = 512 must launch once a layer for
   every prefill in a bucket of 128 or more (warm-up included,
   wide_d_launches), every launch on K1's f32 tensor-core kernel. Then 4
   prompts go through the same DecodeEngine's
   prefill and 16 decode steps, and their logits are held against the
   plain full forward (f32 einsum attention, no cache) within LOGIT_TOL
   of the row's largest |logit|, a bound the same logits rounded to bf16
   must fail; and 4 streams against reference_generate as at Phi-2's
   widths.
20. K2/K3 wider kernels: K1, K1 with logsumexp, K2 and K3 at head dims
   320, 384, 448 and 512 through backward_phase, as phase 16 at 192 and
   256 (K2 and K3 bf16 on the Hopper kernels' split templates of
   flash_attn_bwd_sm90.cu, counted in sm90_launches; f32 runs the
   tensor-core kernels of phase 24, counted in f32tc_launches): every
   instantiation once, bf16 and f32, causal and not, lq == lk and lq <
   lk, then in bf16 q/k/v views into a fused projection, lq 192 (three
   64-row q blocks), causal lq < lk and lk 320 (five 64-key blocks) at
   every head dim (56 sweep cases, one summary line, each launch counted
   in wide_d_launches); then 30 identical bf16 K2 and K3 launches each at
   [1,8,2048,512] and [1,8,2048,384] causal that must agree bit for bit
   (WIDER_BWD_REPEAT), and at the same calls, with Q and dO (then K)
   whose two halves of D are the same, dK's and dV's (then dQ's) halves
   must be bit for bit the same (bwd_parts_check: the two K3 blocks, and
   the two K2 consumers, of a tile build the same P); then the 512-head LM's trained call
   ([4,8,2048,512] bf16 causal, views into the qkv projection), its f32
   gradient check's call ([1,8,2048,512]) and [4,8,2048,384] bf16, each
   timed beside its plain version, SDPA (with the backend SDPA took for
   its backward) and its bound.
21. 512-head LM: the same TransformerModule and causal-LM code as phase
   17 at deepseek-ai/DeepSeek-V4-Flash's hidden size 4096 and head dim
   512 (8 heads of 512, intermediate 16384, vocab 129280, 4 of its 43
   layers; LM512 lists the cuts), after the DeepSeek-width phase's memory
   is freed: 4 x 2048 tokens a step, 2 epochs of 8 steps, gradient checks
   at batch 1 (the f32 one must reject dQ zeroed and dK and dV swapped,
   and its K1-lse, K2 and K3 must run on the f32 tensor-core kernels);
   K1-lse, K2
   and K3 must each launch exactly once a layer a step, every launch at
   D = 512, every K1-lse, K2 and K3 launch (64 each) on the Hopper
   kernels, and the loss must fall.
22. K1 sm90: K1's Hopper kernel (flash_attn_fwd_sm90.cu: TMA into a
   ring of shared-memory stages, a producer warpgroup, wgmma) through the
   flash_attention wrapper against its plain version on the card: every
   unmasked instantiation once at D = 64, 128, 192, 256 (causal and not,
   with and without logsumexp, q/k/v views into a fused projection; then
   lq 192, an odd number of 64-row blocks, lq < lk causal, and lk past
   the last whole kv tile; 32 cases, one summary line), then every head
   dim up to 128 in steps of 8 without a mask and with one (a full row,
   a row of 2 keys, a left-padded row, a row with no real token), with
   and without logsumexp, at lq 192 (the last 128-row block half empty),
   causal lq < lk with left padding (rows that see no key), masks with
   wholly padded kv tiles between real ones, and random masks over 1024
   keys (80 cases, one summary line; each launch counted in
   sm90_launches), then the served call
   [32,12,512,64], the SQuAD fit's
   K1-lse [48,12,384,64] (both views), [8,8,2048,256] and
   [8,8,2048,192] causal and the LM fit's K1-lse [4,16,2048,256] causal
   (views), each timed (events and device time) beside its plain
   version, SDPA and its bound, and the host time of encoding a call's
   three tensor maps.
23. K2/K3 sm90: K2 and K3's Hopper kernels (flash_attn_bwd_sm90.cu: TMA,
   a producer warpgroup, wgmma; K3 up to D = 64 and at 192 and 256
   splits its products between its two consumers; with a key-padding
   mask K2 walks only the kv tiles with a real key and K3 skips key
   blocks of padding) through backward_phase, with K1 and K1-lse beside
   them: every unmasked instantiation at 64-256 once (causal and not,
   q/k/v views into a fused projection, lq 192 (an odd number of 64-row
   tiles), lq < lk causal, lk past the last whole 128-key block; 28
   cases), then every head dim up to 128 (D = 8..128 in steps of 8,
   causal and not, without a mask and with _k5b_mask's rows, one with no
   real key, at lq 192), causal lq < lk with left padding (rows that see
   no key), _gap_mask's wholly padded kv tiles (lk 4224, and causal) and
   _pattern_mask's random masks over 1024 keys (80 cases); one summary
   line a sweep, each case counting K1 twice and K2 and K3 once in
   sm90_launches; then 30 identical K2 and K3 launches on each of three
   calls with a random mask, whose dQ, delta, dK and dV must agree bit
   for bit (SM90_BWD_REPEAT); then the SQuAD fit's call
   [48,12,384,64] (views), [8,8,2048,128] and [4,16,2048,192] causal and
   the LM fit's [4,16,2048,256] causal (views), each timed (events and
   device time) beside its plain version, SDPA's backward and its bound
   (the masked NER call and the MiniLM calls are timed in phases 4 and
   10).
24. K2/K3 f32 tensor cores: K2 and K3 in f32 at every head dim
   (flash_attn_bwd_f32tc.cu: 3xTF32 mma.sync, partial sums flushed to
   device memory every 256 rows; up to D = 128 cp.async tile copies,
   streamed tiles split once a block into hi and lo planes; above 128 D
   split over the warps that share 16 rows, their partial S and dP summed
   in one order, one stage refilled in turns by 1-D bulk copies) through
   backward_phase, with K1 and K1-lse beside them: every instantiation
   once (D = 8..128 in steps of 8; q/k/v views into a fused projection
   causal and not; _k5b_mask's rows, one with no real key, causal and
   not; lq < lk causal, unmasked and with rows that see no key; then
   the same masks at L = 1024, D = 32, 64 and 128, where rows of 2 real
   keys would show a sum run in the tensor cores' accumulators drifting;
   D = 192, 256, 320, 384, 448 and 512 without a mask as views causal
   and not, lq < lk causal, and causal at L = 2048, where the flushes
   matter; 123 cases, one summary line, each counting one K2 and one K3
   launch in f32tc_launches), then the BERT-base trained call
   [48,12,384,64], the NER trained call (masked), MiniLM's
   [48,12,384,32] without and with a mask, cross-length causal
   [1,2,128->384,128], [8,8,2048,128] causal, and causal at
   [1,16,2048,256] (the GPT-J-width LM's f32 gradient check's call),
   [1,8,2048,512] (the 512-head LM's), [1,16,2048,192] and
   [1,8,2048,384], each timed (events and device time) beside its plain
   version (TF32 off: no_tf32), SDPA's backward and its backend (and,
   at the trained call, the names of the kernels it runs), and both
   bounds: at f32 accuracy (3 TF32 products a product) and on FMA. Every
   learn phase's f32 gradient check (one f32 train step, flash
   attention) must run each layer's K2 and K3 once, all on these kernels
   (_check_f32tc), as must phases 16 and 20's f32 cases.
25. K1 f32 tensor cores: K1 and K1-lse in f32 at every head dim
   (flash_attn_fwd_f32tc.cu: 3xTF32 mma.sync, cp.async tile copies, the
   streamed K and V tiles split in registers, each tile's P V in a fresh
   accumulator; above D = 128 the warps of a row group each take a slice
   of D and add their partial S in one order) through the
   flash_attention wrapper
   against its plain version (TF32 off): every instantiation once (D =
   8..128 in steps of 8, without a mask (q/k/v views into a fused
   projection) and with _k5b_mask's rows, causal and not, with and
   without logsumexp; D = 192, 256, 320, 384, 448 and 512 causal and
   not, with and without logsumexp; lq < lk causal, unmasked and with
   rows that see no key; causal calls at L = 4096 (D = 64, 256, 512);
   masked calls at L = 1024 with a row of 2 real keys; 171 cases, one
   summary line, each counting one launch in
   f32tc_launches), then the calls timed: the f32 served shape
   [8,12,512,64], the BERT-base trained K1-lse [48,12,384,64], the NER
   trained K1-lse (masked), MiniLM's K1-lse [48,12,384,32] without and
   with a mask, cross-length causal [1,2,128->384,128], [8,8,2048,128]
   causal, the generation phases' prefills [1,32,2048,80],
   [1,2,256,16], [1,8,8192,256] and [1,64,2048,512], the Gemma-width
   K1-lse [1,8,2048,256], the 512-head LM's f32 K1-lse [1,8,2048,512]
   and [2,32,2048,384] causal, each (events and device time) beside its
   plain
   version, SDPA's f32 forward (and, beside K1-lse, SDPA's forward on
   inputs that need a gradient) with its backend, and both bounds. Every
   phase that runs an f32 K1 call (phases 2, 3, 4, 9, 10, 14, 16, 18,
   20, 24, the four generation phases, and every learn phase's f32
   gradient check) fails unless it ran on this kernel.
26. NCF learn: bench.py's measure_ncf through the port's entry points:
   NeuralCF(6040, 3706, class_num=5) (MovieLens-1M's counts, default
   widths) through ZooModel.fit(device_cache=True) ->
   Estimator._fit_device_cached, batch 65536, 65536 x 64 seeded random
   (user, item, rating) triples, 5 epochs; the last epoch's loss must be
   finite. Prints samples/s (best and median of epochs 2-5), MFU by the
   bench's 6 * P_dense formula (parameters whose path holds no "embed")
   against 989 TFLOP/s, peak memory, and one profiled train step's wall
   and device time, idle share and device time by group.
27. ResNet-50 learn: bench.py's measure_resnet: ImageClassifier(1000,
   "resnet50", dtype="bfloat16") through ZooModel.fit(device_cache=True),
   batch 256, 8 steps an epoch, 5 epochs, seeded f32 images 224 x 224
   (NHWC; cuDNN convolutions on channels_last views, the port's
   flax-semantics BatchNorm); finite losses. Prints images/s (best and
   median of epochs 2-5), the first epoch's seconds, MFU by 3 x 4.1
   GFLOP an image against 989 TFLOP/s, peak memory, and one profiled
   train step's device time by group (convolution, BatchNorm,
   elementwise, copies, pooling, optimizer) and idle share.
28. ResNet-18 serving: bench.py's measure_serving deployment: a seeded
   ImageClassifier(1000, "resnet18", dtype="bfloat16") saved, then
   launch() with batch_size = max_batch_size = 128, timeout 2 ms,
   pipeline depth 3, a uint8 [1,224,224,3] warm example and the HTTP
   frontend off; a closed burst of 512 raw uint8 [224,224,3] requests
   (no image decoder on the path), each answered once, with the top
   class of an eval-mode forward of the same model on the same image and
   logits within 2e-2 (1 + |ref|) of it. Prints requests/s, p50 and p99.
29. Card against CPU: ResNet-18 (f32, batch 8, 64 x 64 images, 10
   classes, every BatchNorm's parameters and statistics drawn) and NCF
   (50 users, 40 items, 5 classes, batch 256) with the same seeded
   weights on the card and on the CPU, TF32 off: one train step's loss,
   every gradient and the BatchNorm statistics after it, then an
   eval-mode forward, each within 1e-4 (1 + |cpu|). The CPU side is what
   the tier-1 tests hold against the JAX package.
Phases 26-29 launch none of the port's kernels (no attention); every
figure they print carries the card's name and power limit.
30. Keras BERT: the Keras engine's main path at BERT-base's full width,
   through the port's public imports: ids = Input((512,)), BERT(vocab
   30522, hidden 768, 12 blocks of 12 heads, intermediate 3072, 512
   positions; f32, as the reference's Keras BERT, attention-prob dropout
   0 as the repo's BERT fine-tunes set it, so that training takes the
   kernels), SelectTable(1), Dropout(0.1), Dense(2), Model(ids, out) on
   the card compiled with "adam" and sparse_categorical_crossentropy;
   materialized on a one-row probe, then one step's f32 gradients with
   flash attention held against einsum attention within F32_GRAD_TOL
   (and a planted fault, dQ zeroed, that the check must reject), then
   fit on seeded synthetic ids and labels, batch 16, 2 epochs of 16
   steps, with zoo.ops.attention_impl = "flash": every K1-lse, K2 and K3
   launch of the fit (12 a step each) and every K1 launch of predict
   (12 a batch) on the f32 tensor-core kernels; evaluate; save_weights,
   load_weights into a fresh Model, whose predict must agree bit for
   bit; then a Sequential MLP of core, merge and activation layers
   (Dense, PReLU, Highway, SplitTensor, Merge, MaxoutDense, SReLU,
   LeakyReLU, ELU) with the same seeded weights on the card and on the
   CPU, TF32 off, within 1e-4 (1 + |cpu|) as phase 29. Prints samples/s
   (the second epoch) and one profiled train step's device time by
   kernel group, with the card's name and power limit.

31. Keras text: the Keras layers of slice 3b on their main path at
   TextClassifier's default widths (vocab 20000 + 1, embedding 200,
   sequence 500, encoder 256) with 20 classes, through the port's public
   imports: a CNN Sequential (Embedding, Convolution1D(256, 5, relu),
   GlobalMaxPooling1D, Dropout(0.2), Dense(128, relu), Dense(20)) and a
   BiLSTM one (Embedding, Bidirectional(LSTM(256)), Dropout(0.2),
   Dense(128, relu), Dense(20)), f32, compiled with "adam" and
   sparse_categorical_crossentropy. For each: one step's gradients
   (dropout off) and predict on 8 rows on the card against the CPU at
   the same seeded weights, TF32 off (gradients within 1e-3 relative per
   parameter, predictions within 1e-4 (1 + |cpu|)); fit on seeded
   synthetic documents (each class's own id planted 5 times), batch
   128 x 500, 2 epochs of 16 steps; evaluate and predict on 512 rows;
   save_weights, load_weights into a fresh model, whose predict must
   agree bit for bit; one profiled train step by kernel group
   (embedding gather and backward, cuDNN RNN, convolution, GEMMs, Adam).
   Then a functional Model holding every layer of slice 3b at least
   once (seven inputs: ids, id bags, images, volumes, image and volume
   sequences, vectors) on the card and on the CPU at the same seeded
   weights, TF32 off: the eval-mode output, its loss's gradients and a
   train-mode forward's BatchNormalization statistics within 1e-4 (1 +
   |cpu|). Launches none of the port's kernels. Prints samples/s (the
   second epoch), predict samples/s, the idle share and peak memory,
   with the card's name and power limit.

32. Zoo models learn: the zoo's sequence and tabular models (slice 4a)
   on their main path, each built with device="cuda" (a parameter off
   the card fails the phase) and fit through ZooModel.fit -> Estimator,
   2 epochs of 16 steps, f32 with TF32 off, on seeded synthetic data at
   their published or default widths, nothing cut: TextClassifier
   (vocab 20000 + 1, embedding 200, sequence 500, encoder 256, 20
   classes, batch 128) with each of its cnn, lstm and gru encoders;
   KNRM (vocab 20000, embedding 300, question 10 and answer 40 tokens,
   21 kernels) on 256 (pos, neg) pairs with rank_hinge, then
   evaluate_ndcg and evaluate_map over 128 queries of 10 docs;
   WideAndDeep at wide_n_deep.ipynb's MovieLens-1M column info (wide
   occupation 21, gender 3, the age-gender cross 100; indicators genres
   19, gender 3; userId 6040 and itemId 3952 embedded to 64; age; 5
   classes, hidden (40, 20, 10)), batch 8192, then recommend_for_user
   over every item through a feature assembler; SessionRecommender at
   37483 items with the history MLP, batch 1024, then
   recommend_for_session; Seq2seq (vocab 20000, embedding 128, one
   LSTM of 128, max_len 32), batch 256, then infer on 64 sources, whose
   tokens must be the CPU's at the same weights except from a step
   where the CPU's top-two logit gap is below 1e-5 (printed);
   AnomalyDetector (unroll 50 over 3 features of a 10320-point series,
   LSTMs 8, 32, 15, dropouts 0.2, RMSprop), batch 1024 (10 steps an
   epoch), then detect_anomalies on every window's forecast. Before
   each fit, one step's gradients (dropout off) and the eval-mode
   forward of the same seeded module on 8 rows, on the card and on the
   CPU, within 1e-4 (1 + |cpu|). After it, evaluate and predict
   (finite, of the expected shape) and one profiled train step by
   kernel group. Then a CNN TextClassifier saved by the port and served
   through launch() on the memory queue (batch 32) answers 256 requests
   of 500 ids, each within 1e-4 (1 + |x|) of predict's. Launches none
   of the port's kernels. Prints each model's samples/s, the step's
   wall and busy ms, idle share and kernel groups, peak memory and
   losses, and the served requests/s, p50 and p99, with the card's
   name and power limit.

33. Image models: the image models of slice 4b on their main paths,
   f32 checks with TF32 off, seeded weights on synthetic images. The
   ten other backbones (Inception-v1 and -v3, MobileNet and
   MobileNet-v2, VGG-16 and -19, AlexNet, SqueezeNet, DenseNet-121 and
   -161), each ImageClassifier(1000, backbone, dtype="bfloat16") built
   on the card at 224 x 224 (Inception-v3 at its published 299), fit
   through ZooModel.fit(device_cache=True) on raw uint8 images, batch
   64, 3 epochs of 8 steps (finite losses), then predict on 256 (finite,
   [256, 1000]) and one profiled train step by kernel group; MFU is
   images/s x 3 x the forward FLOPs counted from the port's Conv and
   Dense shapes on one probe image (2 x multiply-adds, depthwise by
   group) against the bf16 peak. Then each backbone (10 classes,
   dropout 0) on 8 rows at 96 x 96 (Inception-v3 139; each last map 3
   x 3, AlexNet's 2 x 2) with the same seeded weights (every BatchNorm
   drawn) on the card and on the CPU: one f32 train step's loss,
   gradients and BatchNorm statistics and then the eval forward, within
   1e-4 (1 + |cpu|); for the nets whose f32 step lay beyond that on the
   card (train-mode BatchNorm's backward passes small differences of
   nearly equal f32 numbers), the reading is printed and the step is
   held in f64 within 1e-4 (1 + |cpu|), and the card's f32 step must lie
   no farther from the f64 one than 2 x the CPU's f32 step + 1e-6
   (relative norms, group by group). SSD: ObjectDetector(20,
   image_size=128) at its default widths (1344 anchors) fits with the
   MultiBox loss on 1024 seeded toy scenes (bright rectangles labelled
   1-20, prepare_targets), batch 64, 2 epochs of 16 steps, losses
   finite and falling, one profiled step; detect on 64 scenes: the raw
   outputs within 1e-4 (1 + |cpu|) of a CPU twin's at the same weights
   and the detection lists (threshold 0.1) equal but for scores within
   the tolerance of the threshold (counted). FasterRCNN(20,
   image_size=128) at its defaults: predict's images/s and detect on 64
   scenes at threshold 0.055 (its seeded 21-way scores sit near 1/21);
   against the CPU twin the sorted top-K objectness, and the second
   stage (proposals, class logits, box deltas) of every anchor both
   sides select, run by each side on those anchors; an anchor one side
   alone selects must lie within the tolerance of the K-th value
   (counted); the detection lists equal the twin's on every image whose
   top-K sets agree, in each class whose scores hold no two within the
   tolerance (NMS keeps either of two tied boxes; counted).
   MobileNet-v2 (bf16, seeded) saved and served through launch() (batch
   128, depth 3): 512 raw uint8 224 x 224 requests, each within 2e-2 (1
   + |x|) of predict's. Launches none of the port's
   kernels. Prints per backbone images/s (best and median of epochs
   2-3), MFU, peak memory, the step's wall, busy ms, idle share and
   kernel groups; SSD's samples/s and step; Faster-RCNN's images/s; the
   served requests/s, p50 and p99; every figure with the card's name
   and power limit.

The three full-width generation phases (13, 15, 19) draw their seeded
weights on the card (device_draws): every check there holds the port to
its own plain paths on the same weights.

Prints each phase's seconds, a {"kernels": [...]} line
(flash_attn_fwd_sm90 at the served call with an lse_call at the SQuAD
fit's, a d256_call, a d192_call, a trained_lse_call at the LM fit's, a
kv_mask_call and a kv_mask_lse_call at the masked bf16 NER trained call,
a k5b_call at [8,32,1024,80] bf16 causal, a k5b_lse_call and a
k5b_mask_lse_call at the MiniLM trained call unmasked and padded, a
k5b_mask_call at the masked D = 32 call and a padded_call at D = 20,
its launches those of phases 5, 6, 7, 8, 11, 17 and 21;
flash_attn_bwd_dq_sm90 and
flash_attn_bwd_dkv_sm90 at the SQuAD fit's call with a d128_call, a
d192_call, an lm_call at the LM fit's, a kv_mask_call at the masked bf16
NER trained call, and a k5b_call and a k5b_mask_call at the MiniLM
trained call unmasked and padded, and the head dims they are built for,
their launches those of phases 6, 7, 11 and 17 (these rows took the
places of the older sources' rows at the NER call and of
flash_attn_bwd_{dq,dkv}_k5b); flash_attn_bwd_dq_f32tc and flash_attn_bwd_dkv_f32tc at the
f32 trained call with a kv_mask_call (NER), a k5b_call and a
k5b_mask_call (MiniLM), a cross_call, a d128_call, a d192_call, a
d256_call (the GPT-J-width LM's f32 gradient check's call), a d384_call
and a d512_call (the 512-head LM's), and the head dims they are built
for, their launches those of the learn phases' f32 gradient checks and
of phase 30's fit; flash_attn_fwd_f32tc
at the f32 trained K1-lse call with a served_call, a kv_mask_call (NER),
a k5b_call (the Phi-2-width prefill), a k5b_lse_call and a
k5b_mask_call (MiniLM), a repo_call (the repo geometry's prefill), a
cross_call, a d128_call, a d256_call (the Gemma-width prefill), a
d256_lse_call, a d512_call (the DeepSeek-width prefill), a d512_lse_call
(the 512-head LM's f32 K1-lse) and a d384_call, and the head dims it is
built for, its launches those of the four f32 generation phases'
prefills, of the learn phases' f32 gradient checks and of phase 30's
fit and predict, by phase;
flash_attn_fwd_wide at the Gemma-width prefill call (f32, on
flash_attn_fwd_f32tc.cu since it retired the FMA kernel there) with an
lse_call, its launches the Gemma phase's; flash_attn_fwd_wider
(bf16 at D = 320-512, flash_attn_fwd_sm90.cu's split kernel) at the
DeepSeek-width prefill call with an
lse_call, a d384_call and a trained_lse_call at the 512-head LM's call,
its launches the 512-head LM fit's; flash_attn_bwd_dq_wider and
flash_attn_bwd_dkv_wider (bf16 at D = 320-512, flash_attn_bwd_sm90.cu's
split templates) at the 512-head LM's trained call with a d384_call,
their launches that fit's; each backward row
names SDPA's backend; every f32 row carries fma_bound_ms beside its
bound at f32 accuracy), the card's name and power limit, and last {"ok":
true, "device": {...}}. Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import inspect
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# the key-padding branch the masked kernels replace (JAX's stock Pallas
# flash_attention with segment ids on the TPU), and the same stock kernel
# at head dims that are not a multiple of 64, which K5b replaces
K5A_REPLACES = "analytics_zoo_tpu/ops/attention.py:116"
K5B_REPLACES = "analytics_zoo_tpu/ops/attention.py:116"
K1_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:82"
# K1's bf16 forward on Hopper (every D up to 128, masked or not, and 192
# to 512 without a mask), and K2's and K3's for the unmasked bf16 calls
# at D in {64, 128, 192, 256}
SM90_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_fwd_sm90.cu"
SM90_BWD_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_bwd_sm90.cu"
# K2's, K3's and K1's f32 kernels at every head dim, on the tensor cores
# (3xTF32)
F32TC_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_bwd_f32tc.cu"
F32TC_FWD_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_fwd_f32tc.cu"
K2_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:209"
K3_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:249"
# |kernel - plain| <= TOL * (1 + |plain|): f32 is exact arithmetic in
# another order; bf16 rounds P to bf16 before P.V (as the reference
# kernel does) and rounds the output (one bf16 ulp is 2^-7 relative)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# BERT-base logits, bf16 encoder: flash vs einsum attention on the card
SERVE_TOL = 5e-2
# one BERT-base train step (48 x 384) at the seeded weights, bf16
# encoder: per checked parameter, the kernels' bf16 gradient (flash
# attention) may lie no farther from the same step in f32 than the plain
# einsum path's bf16 gradient does, within a factor and a slack:
#   flash_vs_f32 <= BF16_GRAD_RATIO * einsum_vs_f32 + BF16_GRAD_SLACK,
# each ||g_a - g_b|| / ||g_b||. The two bf16 paths round at other points
# (the flash backward rounds dS to bf16 as _flash_bwd does; einsum's
# autograd keeps the softmax backward in f32), and 12 post-LN layers
# compound that in proportion to the weights' spread. At flax's
# lecun_normal Dense draw (scripts/bf16_grad_spread.py, NVIDIA H100 80GB
# HBM3, 700 W) each bf16 path lay 6.5-6.9% from the f32 step for
# BERT-base SQuAD (flash against einsum 6.0% at the layer-0 qkv, 8.5% at
# the head) and 5.2-9.0% for MiniLM (5.7% and 11.3% apart); the JAX
# package's own bf16 gradients lie 5.5% and 6.1% from its f32 ones at
# the same init (CPU). At the narrower draw the port had before, all
# were 2.5-3.5%, which this bound turns into 5.8-7.3%. flash_vs_einsum
# stays printed: by the triangle inequality the bound caps it. Each
# planted fault (dQ zeroed, dK and dV swapped, the mask dropped) must
# exceed the bound on the layer-0 qkv weight. The bf16 losses' absolute
# difference is held to LOSS_TOL
BF16_GRAD_RATIO = 1.5
BF16_GRAD_SLACK = 2e-2
LOSS_TOL = 1e-2
# the same step in f32 (GEMMs without TF32; K1, K2 and K3 at every D as
# three TF32 products, about 2^-21 to 2^-20 relative a product): flash
# and einsum attention differ only in the order of f32 sums, so a broken
# backward (dQ dropped, dK and dV swapped) shows far above this
F32_GRAD_TOL = 1e-3

# published dense peaks (NVIDIA data sheets): bf16 and TF32 tensor-core
# and f32 CUDA-core FLOP/s, HBM bytes/s
PEAKS = {
    "sxm": {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12, "bw": 3.35e12},
    "pcie": {"bf16": 756e12, "tf32": 378e12, "f32": 51e12, "bw": 2.0e12},
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """``nvcc -Xptxas -v`` output as one line per kernel template and mask
    flag: each head dim's registers, and its spill stores/loads in bytes
    where there are any."""
    table, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*(flash_(?:fwd|bwd_dq|"
                      r"bwd_dkv)_(?:bf16|f32tc|f32|sm90)(?:_wide|_split)?"
                      r"_kernel)"
                      r"ILi(\d+)E"
                      r"(?:Lb([01])E)?", line)
        if m:
            kernel = (m.group(1), int(m.group(3) or 0), int(m.group(2)))
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel and m.groups() != ("0", "0"):
            spill = f" (spill {m.group(1)}/{m.group(2)})"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            table.setdefault(kernel[:2], []).append(
                f"{kernel[2]}:{m.group(1)}{spill}")
            kernel = None
    return [f"{name} mask={mask}: " + " ".join(
        sorted(dims, key=lambda x: int(x.split(":")[0])))
        for (name, mask), dims in sorted(table.items())]


def time_ms(torch, fn, iters: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call of ``fn`` from a torch.profiler window of
    ``iters`` calls: for each CUDA kernel row, its mean time a launch
    times its launches a call, summed. Beside ``time_ms`` it tells a
    call bound by its kernels from one bound by the host's launch work.
    The profiler drops records now and then (a window once held 8 of 10
    launches of each kernel), so a row's launches a call are its count
    over ``iters`` rounded to a whole number, at least 1. A window that
    recorded no kernel is taken again, up to three times; then the
    reading is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        busy = sum(e.self_device_time_total / e.count
                   * max(1, round(e.count / iters)) for e in rows)
        if busy > 0:
            return busy / 1e3
    return None


def sdpa_backend(torch, fn) -> str:
    """Which backend PyTorch's SDPA dispatcher picks for the call ``fn``
    makes ("flash_attention", "efficient_attention", "math", ...): the
    first, in the dispatcher's own priority order, that runs the call
    when it is the only backend allowed. (Read from kernel names in a
    profiler window, the answer went missing late in a run.)"""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = (torch._C._get_sdp_priority_order()
             if hasattr(torch._C, "_get_sdp_priority_order")
             else [1, 2, 0, 3])  # flash, efficient, math, cudnn
    for i in order:
        backend = SDPBackend(i)
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                fn()
        except RuntimeError:
            continue
        return backend.name.lower()
    return "none"


def _ms(x) -> str:
    return "n/a" if x is None else f"{x:.4f}"


def _pairs(lq, lk, causal):
    """Visible (query, key) pairs of one head (bottom-right diagonal)."""
    return (sum(min(lk, i + lk - lq + 1) for i in range(lq)) if causal
            else lq * lk)


def _roof(flops, nbytes, peak_flops, bw):
    t_ops, t_bytes = flops / peak_flops, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


KERNELS = ("k1", "k1_lse", "k2", "k3")


def bounds(b, h, lq, lk, d, elt, causal, peak_flops, bw, keep=None):
    """{kernel: (bound_ms, bound_by)} of K1, K1 with logsumexp, K2 and K3
    at one call: the larger of the bytes the function must move (each
    input read once, each output written once) over ``bw`` and its flops
    over ``peak_flops``.

    - K1 reads q, k, v, writes o (and the f32 lse): 4 * d flops per
      visible (query, key) pair (S, P.V).
    - K2 reads q, k, v, o, dO and lse, writes dQ and delta: 6 * d (S, dP,
      dQ).
    - K3 reads q, k, v, dO, lse and delta, writes dK and dV: 8 * d (S,
      dP, dV, dK).

    With a key-padding mask, ``keep`` is the ``[B, Lq, Lk]`` bool of
    visible pairs: the flops are those pairs', the mask's bytes are read
    once, and K and V are read only for the keys some row sees, except
    that K1 reads a batch row's V in full where one of its rows sees no
    key (that row is V's mean). dK and dV are written in full."""
    if keep is None:
        pairs, seen, v_k1, mask_bytes = (b * _pairs(lq, lk, causal),
                                         b * lk, b * lk, 0)
    else:
        seen_b = keep.any(1).sum(1)    # [B]: keys some row sees
        full = keep.any(2).all(1)      # [B]: every row sees a key
        pairs, seen = int(keep.sum()), int(seen_b.sum())
        v_k1 = int((full * seen_b + ~full * lk).sum())
        mask_bytes = b * lk
    rows = b * h * lq * d * elt        # one [B, H, Lq, D] tensor

    def keys(n):                       # K or V rows of n keys
        return n * h * d * elt

    f32 = b * h * lq * 4               # lse or delta
    nbytes = {"k1": 2 * rows + keys(seen + v_k1),
              "k1_lse": 2 * rows + keys(seen + v_k1) + f32,
              "k2": 4 * rows + keys(2 * seen) + 2 * f32,
              "k3": 2 * rows + keys(2 * seen + 2 * b * lk) + 2 * f32}
    flops = {"k1": 4, "k1_lse": 4, "k2": 6, "k3": 8}
    return {k: _roof(flops[k] * d * pairs * h, nbytes[k] + mask_bytes,
                     peak_flops, bw) for k in KERNELS}


def kernel_bounds(b, h, lq, lk, d, elt, causal, peaks, keep=None):
    """``bounds`` at the card's peaks for the dtype of ``elt``-byte
    elements: {kernel: (bound_ms, bound_by, fma_bound_ms)}. bf16: flops at
    the bf16 tensor-core peak (fma_bound_ms None). f32: the least time at
    f32 accuracy, max(bytes / bw, 3 * flops / the TF32 tensor-core peak)
    (three TF32 products make one f32 one: flash_attn_fwd_f32tc.cu,
    flash_attn_bwd_f32tc.cu), and
    beside it the FMA figure, flops at the f32 CUDA-core peak."""
    if elt == 2:
        return {k: (*v, None) for k, v in bounds(
            b, h, lq, lk, d, elt, causal, peaks["bf16"], peaks["bw"],
            keep).items()}
    acc = bounds(b, h, lq, lk, d, elt, causal, peaks["tf32"] / 3,
                 peaks["bw"], keep)
    fma = bounds(b, h, lq, lk, d, elt, causal, peaks["f32"], peaks["bw"],
                 keep)
    return {k: (*acc[k], fma[k][0]) for k in acc}


def _excess(got, want, tol):
    """(max |got - want|, the largest share of tol * (1 + |want|) that an
    element's error takes: above 1 fails)."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            (diff / (tol * (1 + want.float().abs()))).max().item())


def no_tf32(torch, label):
    """Fail unless f32 matmuls and convolutions run in full f32: the
    plain versions are the yardstick of the f32 kernels, and a TF32
    yardstick would be off by about 1e-3."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail(f"{label}: TF32 is on for f32 matmuls or convolutions; the "
             "plain versions must run in f32")


def kernel_phase(torch, peaks):
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    no_tf32(torch, "K1")
    cases = [
        # name, (b, h, lq, lk, d), dtype, causal, with_lse. "served" is
        # the call serving makes: the batcher's grown batch of 32, q/k/v
        # strided views into the fused qkv projection
        # (MultiHeadSelfAttention.forward)
        ("serve", (8, 12, 512, 512, 64), "bfloat16", False, False),
        ("serve", (8, 12, 512, 512, 64), "float32", False, False),
        ("served", (32, 12, 512, 512, 64), "bfloat16", False, False),
        ("served", (8, 12, 512, 512, 64), "float32", False, False),
        ("serve_causal", (8, 12, 512, 512, 64), "bfloat16", True, False),
        ("serve_causal", (8, 12, 512, 512, 64), "float32", True, False),
        ("cross_causal", (1, 2, 128, 384, 128), "bfloat16", True, False),
        ("cross_causal", (1, 2, 128, 384, 128), "float32", True, False),
        ("lse", (2, 4, 256, 256, 64), "bfloat16", False, True),
        ("lse", (2, 4, 256, 256, 64), "float32", False, True),
        ("lse_causal", (2, 4, 256, 256, 128), "bfloat16", True, True),
    ]
    rng = np.random.RandomState(0)
    checks = []
    served = {}
    for name, (b, h, lq, lk, d), dt, causal, with_lse in cases:
        dtype = getattr(torch, dt)

        def make(*shape):
            return torch.from_numpy(
                rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

        if name == "served":
            qkv = make(b, lq, 3, h, d)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
        before = _k1_counts(fa)
        got = fa.flash_attention(q, k, v, causal, None, with_lse)
        torch.cuda.synchronize()
        # f32 on the f32 tensor-core kernel, bf16 on the Hopper kernel
        _k1_check(fa, f"K1 {name} {dt}", before, dtype)
        ref = fa.flash_attention_reference(q, k, v, causal, None,
                                           with_lse)
        out, lse = got if with_lse else (got, None)
        ref_out, ref_lse = ref if with_lse else (ref, None)
        if not torch.isfinite(out.float()).all():
            fail(f"K1 {name} {dt}: non-finite output")
        diff = (out.float() - ref_out.float()).abs()
        err = diff.max().item()
        excess = (diff - TOL[dt] * (1 + ref_out.float().abs())).max().item()
        rec = {"case": name, "shape": [b, h, lq, lk, d], "dtype": dt,
               "causal": causal, "max_abs_err": err, "tol": TOL[dt]}
        if with_lse:
            lerr = (lse - ref_lse).abs().max().item()
            rec.update(lse_max_abs_err=lerr, lse_tol=LSE_TOL[dt])
            if not lerr <= LSE_TOL[dt]:
                fail(f"K1 {name} {dt}: lse error {lerr} > {LSE_TOL[dt]}")
        if name.startswith("serve"):
            rec["ms"] = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal), 50)
            rec["plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_reference(
                    q, k, v, causal, None), 10)
            rec["library_ms"] = time_ms(
                torch, lambda: torch.nn.functional.
                scaled_dot_product_attention(q, k, v, is_causal=causal),
                50)
            (rec["bound_ms"], rec["bound_by"],
             rec["fma_bound_ms"]) = kernel_bounds(
                b, h, lq, lk, d, q.element_size(), causal, peaks)["k1"]
            if name == "served":
                served[dt] = rec
        checks.append(rec)
        print(f"K1 {name} {dt} {[b, h, lq, lk, d]} causal={causal} "
              f"max_abs_err={err:.3g}"
              + (f" lse_err={rec['lse_max_abs_err']:.3g}"
                 if with_lse else "")
              + (f" kernel={rec['ms']:.4f}ms plain={rec['plain_ms']:.4f}ms"
                 f" sdpa={rec['library_ms']:.4f}ms bound="
                 f"{rec['bound_ms']:.4f}ms ({rec['bound_by']})"
                 if "ms" in rec else ""), flush=True)
        if not excess <= 0:
            fail(f"K1 {name} {dt}: error above {TOL[dt]} * (1 + |ref|) "
                 f"(max abs error {err})")
        del q, k, v, got, ref, out, ref_out
    print(json.dumps({"kernel_checks": checks}), flush=True)
    return served


def padding_mask(rng, b, lk, lo, left_rows=(), zero_rows=()):
    """[B, Lk] int32 key-padding mask (1 = real token): real lengths
    uniform in [lo, lk], the first row full and the second at ``lo``;
    ``left_rows`` padded on the left, ``zero_rows`` all padding."""
    lens = rng.randint(lo, lk + 1, b)
    lens[0] = lk
    if b > 1:
        lens[1] = lo
    pos = np.arange(lk)[None, :]
    m = pos < lens[:, None]
    for r in left_rows:
        m[r] = pos[0] >= lk - lens[r]
    for r in zero_rows:
        m[r] = False
    return m.astype(np.int32)


def _right_100(rng, b, lk):
    """100 real keys at the right end: under a bottom-right causal
    diagonal at lq = 128, lk = 384, rows 0-27 see no key."""
    return np.broadcast_to(np.arange(lk) >= lk - 100,
                           (b, lk)).astype(np.int32)


# calls whose q/k/v are views into the fused qkv projection and whose dO
# is laid out as the attention output ([B, L, H, D] memory)
VIEW_CASES = ("trained", "ner_trained", "squad_padded", "minilm_trained",
              "minilm_padded", "gptj_trained", "gptj_f32", "lm512_trained",
              "lm512_f32", "sm90_views", "f32tc_views", "wider_views")
# name, (b, h, lq, lk, d), dtype, causal, mask (a function of the rng,
# b and lk; None: no mask), timed. "trained" is the call one BERT-base
# SQuAD train step makes per layer
BACKWARD_CASES = [
    ("trained", (48, 12, 384, 384, 64), "bfloat16", False, None, True),
    ("trained", (48, 12, 384, 384, 64), "float32", False, None, True),
    ("causal", (8, 12, 512, 512, 64), "bfloat16", True, None, True),
    ("cross_causal", (1, 2, 128, 384, 128), "bfloat16", True, None, True),
    ("cross_causal", (1, 2, 128, 384, 128), "float32", True, None, True),
]
# "ner_trained" is one BERT-base NER layer's call on synthetic traffic
# (real lengths uniform in [2, 128], one left-padded row); "squad_padded"
# the SQuAD fine-tune's call with lengths in [64, 384];
# "cross_causal_left" has rows that see no key (left padding past the
# bottom-right diagonal); "all_zero_row" a batch row with no real token
MASKED_CASES = [
    ("ner_trained", (32, 12, 128, 128, 64), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,)), True),
    ("ner_trained", (32, 12, 128, 128, 64), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,)), True),
    ("squad_padded", (48, 12, 384, 384, 64), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 64), True),
    ("cross_causal_left", (1, 2, 128, 384, 128), "bfloat16", True,
     _right_100, False),
    ("cross_causal_left", (1, 2, 128, 384, 128), "float32", True,
     _right_100, False),
    ("all_zero_row", (4, 12, 128, 128, 64), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, zero_rows=(1,)), False),
    ("all_zero_row", (4, 12, 128, 128, 64), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, zero_rows=(1,)), False),
]


def _sdpa_args(fa, lq, lk, causal, m):
    """(attn_mask, is_causal) for SDPA to compute the port's function: the
    key-padding mask as a boolean [B, 1, 1, Lk] mask, and a causal
    diagonal as is_causal where that means the same (SDPA aligns it
    top-left: equal at lq == lk without a mask beside it), else as an
    explicit bottom-right boolean mask (``_visible``). One PyTorch call
    either way; rows that see no key come out NaN there, which a timing
    does not read."""
    if causal and (lq != lk or m is not None):
        return fa._visible(lq, lk, True, m, m.device if m is not None
                           else "cuda"), False
    return (None if m is None else m.bool()[:, None, None, :]), causal


def backward_phase(torch, peaks, cases, seed, label, quiet=False):
    """K1 without and with logsumexp, K2 and K3, each through its wrapper
    against its plain version on the card, K2 and K3 reading the kernel's
    own out and lse (as the main path's backward does), each launched once
    where ``_bwd_entry`` sends it (counted in ``sm90_launches`` or
    ``f32tc_launches``). With a mask:
    padded keys' dK (and, where every row sees a key, dV) and the dQ of
    rows that see no key must be exactly zero. Timed cases: each kernel
    and SDPA by CUDA events and by profiler device time, the plain
    versions, and bounds. ``quiet`` prints one line for all the cases
    instead of one a case. Returns the cases' records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    no_tf32(torch, label)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.RandomState(seed)
    checks = []
    bwd_wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for name, (b, h, lq, lk, d), dt, causal, mask_of, timed in cases:
        dtype = getattr(torch, dt)

        def make(*shape):
            return torch.from_numpy(
                rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

        if name in VIEW_CASES:
            qkv = make(b, lq, 3, h, d)
            q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            do = make(b, lq, h, d).transpose(1, 2)
        else:
            q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
            do = make(b, h, lq, d)
        rec = {"case": name, "shape": [b, h, lq, lk, d], "dtype": dt,
               "causal": causal, "tol": TOL[dt], "lse_tol": LSE_TOL[dt]}
        m = keep = None
        if mask_of is not None:
            m = torch.from_numpy(mask_of(rng, b, lk)).cuda()
            keep = fa._visible(lq, lk, causal, m, m.device).expand(
                b, 1, lq, lk)[:, 0]                     # [B, Lq, Lk]
            empty = ~keep.any(-1)                       # [B, Lq]
            rec.update(real_keys=int(m.ne(0).sum()), keys=b * lk,
                       rows_without_key=int(empty.sum()) * h,
                       visible_pairs=int(keep.sum()) * h)

        def check(key, got, want, tol):
            if not torch.isfinite(got.float()).all():
                fail(f"{label} {key} {name} {dt}: non-finite output")
            err, share = _excess(got, want, tol)
            rec[f"{key}_max_abs_err"] = err
            rec[f"{key}_tol_share"] = share
            if not share <= 1:
                fail(f"{label} {key} {name} {dt}: error above {tol} * "
                     f"(1 + |ref|) (max abs error {err})")

        k1_before = _k1_counts(fa)
        out = fa.flash_attention(q, k, v, causal, None, False, m)
        torch.cuda.synchronize()
        check("k1", out, fa.flash_attention_reference(
            q, k, v, causal, None, False, m), TOL[dt])
        # K1 with logsumexp: out within TOL * (1 + |ref|), lse within
        # LSE_TOL; K2 and K3 below read this out and lse
        o, lse = fa.flash_attention(q, k, v, causal, None, True, m)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, causal, None,
                                                True, m)
        check("k1_lse_out", o, ro, TOL[dt])
        lerr = (lse - rlse).abs().max().item()
        rec["k1_lse_max_abs_err"] = lerr
        if not (torch.isfinite(lse).all() and lerr <= LSE_TOL[dt]):
            fail(f"{label} K1 lse {name} {dt}: error {lerr} > {LSE_TOL[dt]}")
        del ro, rlse
        # K1 and K1-lse: f32 on the f32 tensor-core kernel, bf16 on the
        # Hopper kernel
        _k1_check(fa, f"{label} {name} {dt} D={d}", k1_before, dtype,
                  calls=2)
        before = [(w.launches, w.f32tc_launches, w.sm90_launches)
                  for w in bwd_wrappers]
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                              None, m)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal,
                                            None, m)
        torch.cuda.synchronize()
        # f32 on the tensor-core kernels, bf16 on the Hopper kernels
        entry = fa._bwd_entry(dtype)[0]
        want = (1, int(entry.endswith("_f32tc")), int(entry.endswith("_sm90")))
        for w, counts in zip(bwd_wrappers, before):
            got = tuple(now - was for now, was in zip(
                (w.launches, w.f32tc_launches, w.sm90_launches), counts))
            if got != want:
                fail(f"{label} {name} {dt} D={d}: {w.__name__} launched "
                     f"{got[0]}, {got[1]} of them on flash_attn_bwd_f32tc.cu "
                     f"and {got[2]} on flash_attn_bwd_sm90.cu (want {want})")
        rdq, rdelta = fa.flash_attention_bwd_dq_reference(
            q, k, v, o, lse, do, causal, None, m)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, lse, rdelta, do, causal, None, m)
        check("dq", dq, rdq, TOL[dt])
        check("delta", delta, rdelta, TOL["float32"])
        check("dk", dk, rdk, TOL[dt])
        check("dv", dv, rdv, TOL[dt])
        if m is not None:
            # exact zeros: padded keys' dK; their dV where every row of
            # the batch row sees a key; dQ of rows that see no key
            pad = m == 0                                # [B, Lk]
            if torch.count_nonzero(dk[pad[:, None, :, None].expand_as(dk)]):
                fail(f"{label} K3 {name} {dt}: padded keys get a nonzero dK")
            pad_v = (pad & ~empty.any(1)[:, None])[:, None, :, None]
            if torch.count_nonzero(dv[pad_v.expand_as(dv)]):
                fail(f"{label} K3 {name} {dt}: padded keys get a nonzero dV")
            if torch.count_nonzero(dq[empty[:, None, :, None].expand_as(dq)]):
                fail(f"{label} K2 {name} {dt}: a row that sees no key gets "
                     f"a nonzero dQ")
        rec["k2_max_abs_err"] = max(rec["dq_max_abs_err"],
                                    rec["delta_max_abs_err"])
        rec["k3_max_abs_err"] = max(rec["dk_max_abs_err"],
                                    rec["dv_max_abs_err"])
        if timed:
            # the mask as the main path hands it over (BERTModule makes
            # the bytes once a forward)
            mk = fa._kernel_mask(m)
            calls = {
                "k1": lambda: fa.flash_attention(q, k, v, causal, None,
                                                 False, mk),
                "k1_lse": lambda: fa.flash_attention(q, k, v, causal, None,
                                                     True, mk),
                "k2": lambda: fa.flash_attention_bwd_dq(
                    q, k, v, o, lse, do, causal, None, mk),
                "k3": lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, delta, do, causal, None, mk)}
            plain = {
                "k1": lambda: fa.flash_attention_reference(
                    q, k, v, causal, None, False, m),
                "k1_lse": lambda: fa.flash_attention_reference(
                    q, k, v, causal, None, True, m),
                "k2": lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, o, lse, do, causal, None, m),
                "k3": lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, lse, rdelta, do, causal, None, m)}
            for key in KERNELS:
                rec[f"{key}_ms"] = time_ms(torch, calls[key], 20)
                rec[f"{key}_device_ms"] = device_ms(torch, calls[key])
                rec[f"{key}_plain_ms"] = time_ms(torch, plain[key], 3)
            for key, bnd in kernel_bounds(b, h, lq, lk, d,
                                          q.element_size(), causal, peaks,
                                          keep).items():
                (rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"],
                 rec[f"{key}_fma_bound_ms"]) = bnd
            # SDPA (a yardstick; the port never calls it) on the same
            # function (_sdpa_args): the forward at inference, the forward
            # with inputs that need a gradient (it keeps its logsumexp),
            # and the backward alone replayed on one retained graph
            attn, flag = _sdpa_args(fa, lq, lk, causal, m)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            # the backend that takes the forward and its backward
            rec["sdpa_backend"] = sdpa_backend(
                torch, lambda: torch.autograd.grad(
                    sdpa(qs, ks, vs, attn_mask=attn, is_causal=flag),
                    (qs, ks, vs), do))
            sout = sdpa(qs, ks, vs, attn_mask=attn, is_causal=flag)
            calls = {
                "sdpa": lambda: sdpa(q, k, v, attn_mask=attn,
                                     is_causal=flag),
                "sdpa_fwd": lambda: sdpa(qs, ks, vs, attn_mask=attn,
                                         is_causal=flag),
                "sdpa_bwd": lambda: torch.autograd.grad(
                    sout, (qs, ks, vs), do, retain_graph=True)}
            for key, fn in calls.items():
                rec[f"{key}_ms"] = time_ms(torch, fn, 20, warm=5)
                rec[f"{key}_device_ms"] = device_ms(torch, fn)
            del sout, qs, ks, vs
        checks.append(rec)
        if quiet:
            del q, k, v, do, o, lse, dq, dk, dv, delta, rdq, rdk, rdv, rdelta
            continue
        print(f"{label} {name} {dt} {[b, h, lq, lk, d]} causal={causal}"
              + (f" real keys {rec['real_keys']}/{rec['keys']}, rows "
                 f"without a key {rec['rows_without_key']}"
                 if m is not None else "")
              + "; err " + " ".join(
                  f"{key}={rec[key + '_max_abs_err']:.3g}" for key in (
                      "k1", "k1_lse_out", "k1_lse", "dq", "delta", "dk",
                      "dv")), flush=True)
        if timed:
            both = (None if None in (rec["k2_device_ms"], rec["k3_device_ms"])
                    else rec["k2_device_ms"] + rec["k3_device_ms"])
            print(f"{label} {name} {dt} ms, (device ms): " + "; ".join(
                f"{key} {rec[key + '_ms']:.4f} "
                f"({_ms(rec[key + '_device_ms'])}) plain "
                f"{rec[key + '_plain_ms']:.4f} bound "
                f"{rec[key + '_bound_ms']:.4f} ({rec[key + '_bound_by']}"
                + ("" if rec[key + "_fma_bound_ms"] is None else
                   f"; FMA {rec[key + '_fma_bound_ms']:.4f}") + ")"
                for key in KERNELS) + "".join(
                f"; {key} {rec[key + '_ms']:.4f} "
                f"({_ms(rec[key + '_device_ms'])})"
                for key in ("sdpa", "sdpa_fwd", "sdpa_bwd")
                if key + "_ms" in rec)
                + (f" [{rec['sdpa_backend']}]" if "sdpa_backend" in rec
                   else "")
                + f"; K2+K3 {rec['k2_ms'] + rec['k3_ms']:.4f} ({_ms(both)})",
                flush=True)
        del q, k, v, do, o, lse, dq, dk, dv, delta, rdq, rdk, rdv, rdelta
    if quiet:
        keys = ("k1", "k1_lse_out", "dq", "delta", "dk", "dv")
        print(f"{label}: all {len(checks)} cases match the plain versions; "
              "largest error, as a share of its tolerance: " + " ".join(
                  f"{key} {max(r[key + '_tol_share'] for r in checks):.3g}"
                  for key in keys), flush=True)
    else:
        print(json.dumps({f"{label}_checks": checks}), flush=True)
    return checks


# K5b: the forward kernel at head dims that are not a multiple of 64.
# name, (b, h, lq, lk, d), dtype, causal, mask (a function of the rng, b
# and lk; None: no mask), with_lse. "gen_full" is TinyGenLM's prefill at
# Phi-2's widths (32 heads of 80, f32) in its top bucket and one of 512,
# "gen_repo" the repo geometry's top bucket (2 heads of 16, f32);
# "minilm_masked" MiniLM-L12-H384's heads (12 of 32) on a padded NER-like
# batch with one left-padded row and one row with no real token
K5B_CASES = [
    ("gen_full", (1, 32, 2048, 2048, 80), "float32", True, None, False),
    ("gen_full", (1, 32, 512, 512, 80), "float32", True, None, False),
    ("gen_repo", (1, 2, 256, 256, 16), "float32", True, None, False),
    ("bf16_d80", (8, 32, 1024, 1024, 80), "bfloat16", True, None, False),
    ("minilm_masked", (32, 12, 128, 128, 32), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,),
                                     zero_rows=(3,)), False),
    ("d40", (2, 4, 256, 256, 40), "bfloat16", True, None, True),
    ("d40", (2, 4, 256, 256, 40), "float32", True, None, True),
    # a head dim that is not a multiple of 8: K5b at 24 on a zero-padded
    # copy of q, k, v (the bound counts the true D's work)
    ("padded_d20", (8, 12, 512, 512, 20), "bfloat16", True, None, False),
]
# the head dims K5b is built for: multiples of 8 up to 128 but not of 64
K5B_HEAD_DIMS = [d for d in range(8, 129, 8) if d % 64]


def _k5b_mask(rng, b, lk):
    """A full batch row, one of 2 real keys, one left-padded and one
    with no real token."""
    return padding_mask(rng, b, lk, 2, left_rows=(2,), zero_rows=(3,))


# K5b backward (K1-lse, K2 and K3 at those head dims), in backward_phase's
# case form. Every instantiation once: each D in bf16 and f32, without a
# mask and with _k5b_mask, causal at lq == lk for the unmasked calls at
# D = 8 (mod 16) and the masked ones at D = 0 (mod 16), so each of the two
# residues sees both flags and left padding under causal leaves rows that
# see no key
K5B_BWD_SWEEP = [
    (f"d{d}", (4, 2, 128, 128, d), dt, causal, mask_of, False)
    for d in K5B_HEAD_DIMS for dt in ("bfloat16", "float32")
    for causal, mask_of in ((d % 16 == 8, None), (d % 16 == 0, _k5b_mask))]
# the call one MiniLM-L12-H384 SQuAD train step makes per layer (12 heads
# of 32, views into the qkv projection), without a mask and padded (real
# lengths uniform in [64, 384], the fine-tune's traffic)
K5B_BWD_CASES = [
    ("minilm_trained", (48, 12, 384, 384, 32), "bfloat16", False, None,
     True),
    ("minilm_padded", (48, 12, 384, 384, 32), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 64), True),
]


def k5b_bwd_phase(torch, peaks):
    """K5b backward through ``backward_phase``: every instantiation once
    (``K5B_BWD_SWEEP``, one summary line), then the MiniLM trained calls
    (``K5B_BWD_CASES``, timed). Each sweep case must count one K2 and
    one K3 launch in ``small_d_launches``. Returns the timed records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [w.small_d_launches for w in wrappers]
    backward_phase(torch, peaks, K5B_BWD_SWEEP, 6, "k5b-bwd-sweep",
                   quiet=True)
    counted = [w.small_d_launches - n for w, n in zip(wrappers, before)]
    if counted != [len(K5B_BWD_SWEEP)] * 2:
        fail(f"K5b backward: K2 and K3 counted {counted} K5b launches in "
             f"{len(K5B_BWD_SWEEP)} sweep cases")
    return backward_phase(torch, peaks, K5B_BWD_CASES, 7, "k5b-bwd")


def _make(torch, rng):
    def make(shape, dtype):
        return torch.from_numpy(
            rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
    return make


def _k1_kernels(fa, dtype):
    """(Hopper, f32 tensor-core): 1 where ``_fwd_entry`` sends a K1 call
    to that kernel (flash_attn_fwd_sm90.cu: every bf16 call;
    flash_attn_fwd_f32tc.cu: every f32 one), else 0."""
    name = fa._fwd_entry(dtype)
    return int(name.endswith("_sm90")), int(name.endswith("_f32tc"))


def _k1_counts(fa):
    """K1's launches so far on the Hopper and the f32 tensor-core
    kernels."""
    return fa.flash_attention.sm90_launches, fa.flash_attention.f32tc_launches


def _k1_check(fa, label, before, dtype, calls=1):
    """Fail unless the K1 launches since ``before`` (``_k1_counts``),
    ``calls`` calls of one kind, ran where ``_fwd_entry`` sends them."""
    got = tuple(a - b for a, b in zip(_k1_counts(fa), before))
    want = tuple(calls * n for n in _k1_kernels(fa, dtype))
    if got != want:
        fail(f"{label}: K1 launched {got[0]} times on "
             f"flash_attn_fwd_sm90.cu and {got[1]} on "
             f"flash_attn_fwd_f32tc.cu (want {want[0]} and {want[1]})")


def fwd_check(torch, make, label, b, h, lq, lk, d, dt, causal, m, with_lse,
              counter, views=False):
    """One ``flash_attention`` call on random inputs against its plain
    version (``TOL``, ``LSE_TOL``); the wrapper must count it in
    ``counter`` (``small_d_launches`` for K5b, ``wide_d_launches`` above
    D = 128, ``sm90_launches`` for the Hopper kernel, ``f32tc_launches``
    for the f32 tensor-core kernel), every f32 call in
    ``f32tc_launches`` and every bf16 call in ``sm90_launches``
    (``_k1_check``). With
    ``views`` (and lq == lk) q, k and v are
    strided views into one fused [B, L, 3, H, D] projection, as the
    models' attention makes them. Returns (q, k, v, record)."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dt)
    if views and lq == lk:
        q, k, v = (t.transpose(1, 2)
                   for t in make((b, lq, 3, h, d), dtype).unbind(2))
    else:
        q = make((b, h, lq, d), dtype)
        k, v = make((b, h, lk, d), dtype), make((b, h, lk, d), dtype)
    before = getattr(fa.flash_attention, counter)
    k1_before = _k1_counts(fa)
    got = fa.flash_attention(q, k, v, causal, None, with_lse, m)
    torch.cuda.synchronize()
    if getattr(fa.flash_attention, counter) != before + 1:
        fail(f"{label}: the wrapper did not count the launch in {counter}")
    _k1_check(fa, label, k1_before, dtype)
    ref = fa.flash_attention_reference(q, k, v, causal, None, with_lse, m)
    out, lse = got if with_lse else (got, None)
    ref_out, ref_lse = ref if with_lse else (ref, None)
    if not torch.isfinite(out.float()).all():
        fail(f"{label}: non-finite output")
    err, share = _excess(out, ref_out, TOL[dt])
    if not share <= 1:
        fail(f"{label}: error above {TOL[dt]} * (1 + |ref|) "
             f"(max abs error {err})")
    rec = {"max_abs_err": err, "tol": TOL[dt], "share": share}
    if with_lse:
        rec["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
        if not rec["lse_max_abs_err"] <= LSE_TOL[dt]:
            fail(f"{label}: lse error {rec['lse_max_abs_err']} > "
                 f"{LSE_TOL[dt]}")
        rec["share"] = max(share, rec["lse_max_abs_err"] / LSE_TOL[dt])
    return q, k, v, rec


def timed_fwd_cases(torch, peaks, rng, cases, counter, label, iters=20,
                    views=()):
    """``fwd_check`` at each case (q/k/v views into a fused projection
    for the case names in ``views``), then the call timed (CUDA events
    and profiler device time) beside its plain version, SDPA (a
    yardstick; the port never calls it) and its bound. Returns the
    records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    no_tf32(torch, label)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    make = _make(torch, rng)
    checks = []
    for name, (b, h, lq, lk, d), dt, causal, mask_of, with_lse in cases:
        m = keep = None
        if mask_of is not None:
            m = torch.from_numpy(mask_of(rng, b, lk)).cuda()
            keep = fa._visible(lq, lk, causal, m, m.device).expand(
                b, 1, lq, lk)[:, 0]
        q, k, v, rec = fwd_check(torch, make, f"{label} {name} {dt}", b, h,
                                 lq, lk, d, dt, causal, m, with_lse, counter,
                                 views=name in views)
        rec.update(case=name, shape=[b, h, lq, lk, d], dtype=dt,
                   causal=causal)
        if m is not None:
            rec.update(real_keys=int(m.ne(0).sum()), keys=b * lk,
                       rows_without_key=int((~keep.any(-1)).sum()) * h)
        mk = fa._kernel_mask(m)
        call = lambda: fa.flash_attention(q, k, v, causal, None, with_lse,
                                          mk)
        attn, flag = _sdpa_args(fa, lq, lk, causal, m)
        lib = lambda: sdpa(q, k, v, attn_mask=attn, is_causal=flag)
        rec["ms"] = time_ms(torch, call, iters)
        rec["device_ms"] = device_ms(torch, call)
        rec["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, causal, None, with_lse, m), 3)
        rec["library_ms"] = time_ms(torch, lib, iters)
        rec["library_device_ms"] = device_ms(torch, lib)
        rec["library_backend"] = sdpa_backend(torch, lib)
        if with_lse:
            # beside K1-lse: SDPA's forward on inputs that need a gradient
            # (it keeps its logsumexp for the backward)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            lib_grad = lambda: sdpa(qs, ks, vs, attn_mask=attn,
                                    is_causal=flag)
            rec["library_grad_ms"] = time_ms(torch, lib_grad, iters)
            rec["library_grad_device_ms"] = device_ms(torch, lib_grad)
            del qs, ks, vs
        (rec["bound_ms"], rec["bound_by"],
         rec["fma_bound_ms"]) = kernel_bounds(
            b, h, lq, lk, d, q.element_size(), causal, peaks,
            keep)["k1_lse" if with_lse else "k1"]
        checks.append(rec)
        print(f"{label} {name} {dt} {[b, h, lq, lk, d]} causal={causal}"
              + (f" real keys {rec['real_keys']}/{rec['keys']}, rows "
                 f"without a key {rec['rows_without_key']}"
                 if m is not None else "")
              + f" err={rec['max_abs_err']:.3g}"
              + (f" lse_err={rec['lse_max_abs_err']:.3g}" if with_lse
                 else "")
              + f"; kernel {rec['ms']:.4f} ({_ms(rec['device_ms'])}) ms, "
              f"plain {rec['plain_ms']:.4f}, sdpa "
              f"({rec['library_backend']}) {rec['library_ms']:.4f} "
              f"({_ms(rec['library_device_ms'])}), bound "
              f"{rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return checks


# head dims that are not a multiple of 8: the wrappers zero-pad them to
# the next one (the kernels read 16-byte rows)
PADDED_HEAD_DIMS = (12, 20, 100)


def padded_check(torch, rng):
    """K1, then K1-lse, K2 and K3 under autograd, at ``PADDED_HEAD_DIMS``
    (causal [2,2,128,d], bf16 and f32) against their plain versions at
    the true head dim (``TOL``): every launch counted as K5b, every
    output and gradient of the caller's shape."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    make = _make(torch, rng)
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    worst = 0.0
    for d in PADDED_HEAD_DIMS:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            q, k, v = (make((2, 2, 128, d), dtype).requires_grad_()
                       for _ in range(3))
            do = make((2, 2, 128, d), dtype)
            before = [w.small_d_launches for w in wrappers]
            before_tc = [w.f32tc_launches for w in wrappers]
            with torch.no_grad():
                plain_fwd = fa.flash_attention(q, k, v, True)
            out = fa.flash_attention(q, k, v, True)
            grads = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            counted = [w.small_d_launches - n
                       for w, n in zip(wrappers, before)]
            if counted != [2, 1, 1]:
                fail(f"padded d={d} {dt}: K1, K2, K3 counted {counted} "
                     "K5b launches (want 2, 1, 1)")
            # f32: all four on the f32 tensor-core kernels
            tc = [w.f32tc_launches - n for w, n in zip(wrappers, before_tc)]
            if tc != ([2, 1, 1] if dt == "float32" else [0, 0, 0]):
                fail(f"padded d={d} {dt}: K1, K2, K3 counted {tc} f32 "
                     "tensor-core launches")
            with torch.no_grad():
                ref, lse = fa.flash_attention_reference(q, k, v, True, None,
                                                        True)
                ref_grads = fa.flash_attention_bwd_reference(
                    q, k, v, ref, lse, do, True)
            for what, got, want in zip(
                    ("K1", "K1-lse", "dq", "dk", "dv"),
                    (plain_fwd, out, *grads), (ref, ref, *ref_grads)):
                if tuple(got.shape) != tuple(want.shape):
                    fail(f"padded d={d} {dt} {what}: shape "
                         f"{tuple(got.shape)}, want {tuple(want.shape)}")
                err, share = _excess(got, want, TOL[dt])
                if not share <= 1:
                    fail(f"padded d={d} {dt} {what}: error above "
                         f"{TOL[dt]} * (1 + |ref|) (max abs error {err})")
                worst = max(worst, share)
    print(f"K5b padded: head dims {list(PADDED_HEAD_DIMS)} x bf16/f32, "
          f"forward and backward, match the plain versions (largest error "
          f"{worst:.3g} of its tolerance)", flush=True)


def k5b_phase(torch, peaks):
    """K5b through the ``flash_attention`` wrapper against its plain
    version on the card: every instantiation once ([2,2,128,d], causal
    without a mask and non-causal with one, with its logsumexp, in bf16
    and f32), head dims that are not a multiple of 8 through the
    wrappers' padding, forward and backward (``padded_check``), then
    ``K5B_CASES``, each timed (``timed_fwd_cases``). Returns the cases'
    records."""
    rng = np.random.RandomState(5)
    make = _make(torch, rng)
    sweep = []
    for d in K5B_HEAD_DIMS:
        for dt in ("bfloat16", "float32"):
            for masked in (False, True):
                m = (torch.from_numpy(padding_mask(
                    rng, 2, 128, 2, zero_rows=(1,))).cuda()
                    if masked else None)
                _, _, _, rec = fwd_check(
                    torch, make, f"K5b d={d} {dt} mask={masked}", 2, 2, 128,
                    128, d, dt, not masked, m, True, "small_d_launches")
                sweep.append(rec["share"])
    print(f"K5b: all {len(K5B_HEAD_DIMS)} head dims x bf16/f32 x "
          f"mask/none match the plain version (largest error "
          f"{max(sweep):.3g} of its tolerance)", flush=True)
    padded_check(torch, rng)
    checks = timed_fwd_cases(torch, peaks, rng, K5B_CASES,
                             "small_d_launches", "K5b")
    print(json.dumps({"k5b_checks": checks}), flush=True)
    return checks


# K1 above D = 128: every instantiation once (D in {192, 256}, bf16 and
# f32, causal and not, with and without logsumexp, lq == lk and lq < lk)
WIDE_SWEEP = [
    (f"d{d}", shape + (d,), dt, causal, None, with_lse)
    for d in (192, 256) for dt in ("bfloat16", "float32")
    for shape in ((2, 2, 128, 128), (1, 3, 128, 384))
    for causal in (False, True) for with_lse in (False, True)]
# the calls timed: the full-width prefill at Gemma-2B's widths (8 heads
# of 256, f32, the 8192 bucket), K1 with logsumexp at its 2048 bucket,
# and a bf16 call
WIDE_CASES = [
    ("gemma_prefill", (1, 8, 8192, 8192, 256), "float32", True, None,
     False),
    ("gemma_lse", (1, 8, 2048, 2048, 256), "float32", True, None, True),
    ("bf16_d256", (8, 8, 2048, 2048, 256), "bfloat16", True, None, False),
    ("bf16_d192", (8, 8, 2048, 2048, 192), "bfloat16", True, None, False),
]


def wide_phase(torch, peaks):
    """K1 at D in {192, 256} through the ``flash_attention`` wrapper
    against its plain version on the card (``WIDE_SWEEP``, one summary
    line), then ``WIDE_CASES`` timed. Every launch must count in
    ``wide_d_launches``. Returns the timed records."""
    rng = np.random.RandomState(8)
    make = _make(torch, rng)
    sweep = []
    for name, (b, h, lq, lk, d), dt, causal, _, with_lse in WIDE_SWEEP:
        _, _, _, rec = fwd_check(
            torch, make, f"K1 wide {name} {dt} {[b, h, lq, lk]} "
            f"causal={causal} lse={with_lse}", b, h, lq, lk, d, dt, causal,
            None, with_lse, "wide_d_launches")
        sweep.append(rec["share"])
    print(f"K1 wide: all {len(WIDE_SWEEP)} cases (D 192/256 x bf16/f32 x "
          f"causal x lse x lq == lk or lq < lk) match the plain version "
          f"(largest error {max(sweep):.3g} of its tolerance)", flush=True)
    checks = timed_fwd_cases(torch, peaks, rng, WIDE_CASES,
                             "wide_d_launches", "K1 wide", iters=10)
    print(json.dumps({"wide_checks": checks}), flush=True)
    return checks


# K2 and K3 above D = 128 (with K1 and K1-lse beside them): every
# instantiation once (D in {192, 256}, bf16 and f32, causal and not, lq ==
# lk and lq < lk)
WIDE_BWD_SWEEP = [
    (f"d{d}", shape + (d,), dt, causal, None, False)
    for d in (192, 256) for dt in ("bfloat16", "float32")
    for shape in ((2, 2, 128, 128), (1, 3, 128, 384))
    for causal in (False, True)]
# the calls checked: the one a train step of the GPT-J-width LM makes per
# layer (4 x 2048 tokens, 16 heads of 256, causal, views into the qkv
# projection), its f32 gradient check's (batch 1), and bf16 at D = 192;
# the f32 call timed (the bf16 ones run the Hopper kernels, which
# sm90_bwd_phase times)
WIDE_BWD_CASES = [
    ("gptj_trained", (4, 16, 2048, 2048, 256), "bfloat16", True, None, False),
    ("gptj_f32", (1, 16, 2048, 2048, 256), "float32", True, None, True),
    ("bf16_d192", (4, 16, 2048, 2048, 192), "bfloat16", True, None, False),
]


# the head dims above 256 the kernels are built for
WIDER_HEAD_DIMS = (320, 384, 448, 512)
# K2 and K3 above D = 256 (with K1 and K1-lse beside them): every
# instantiation once (D in {320, 384, 448, 512}, bf16 and f32, causal and
# not, lq == lk and lq < lk), then in bf16 (the Hopper split templates:
# K2's 64-row q blocks, K3's 64-key blocks of one part of D each) q/k/v
# views into a fused projection, lq 192 (three q blocks, K3's q tiles of
# 32 rows), causal lq < lk with lk 320 (five key blocks), and lq 64
# against lk 320
WIDER_BWD_SWEEP = [
    (f"d{d}", shape + (d,), dt, causal, None, False)
    for d in WIDER_HEAD_DIMS for dt in ("bfloat16", "float32")
    for shape in ((2, 2, 128, 128), (1, 3, 128, 384))
    for causal in (False, True)] + [
    (name, shape + (d,), "bfloat16", causal, None, False)
    for d in WIDER_HEAD_DIMS for name, shape, causal in (
        ("wider_views", (2, 3, 256, 256), False),
        ("wider_views", (2, 3, 256, 256), True),
        ("odd_blocks", (1, 2, 192, 192), True),
        ("odd_blocks", (1, 2, 192, 192), False),
        ("lk320", (1, 2, 192, 320), True),
        ("lk320", (1, 2, 64, 320), False))]
# unmasked bf16 calls whose K2 and K3 launch REPEATS times and must agree
# bit for bit (both K2 consumers rebuild P; K3's consumers exchange P^T),
# and whose two parts of D must build the same P (bwd_parts_check):
# (b, h, lq, lk, d, causal)
WIDER_BWD_REPEAT = ((1, 8, 2048, 2048, 512, True),
                    (1, 8, 2048, 2048, 384, True))
# the calls timed: the one a train step of the LM at DeepSeek-V4-Flash's
# hidden size and head dim makes per layer (4 x 2048 tokens, 8 heads of
# 512, causal, views into the qkv projection), its f32 gradient check's
# (batch 1), and bf16 at D = 384
WIDER_BWD_CASES = [
    ("lm512_trained", (4, 8, 2048, 2048, 512), "bfloat16", True, None, True),
    ("lm512_f32", (1, 8, 2048, 2048, 512), "float32", True, None, True),
    ("bf16_d384", (4, 8, 2048, 2048, 384), "bfloat16", True, None, True),
]


def wide_bwd_phase(torch, peaks, sweep=WIDE_BWD_SWEEP, cases=WIDE_BWD_CASES,
                   seeds=(10, 12), label="wide-bwd", repeat=()):
    """K2 and K3 above D = 128 through ``backward_phase``: every
    instantiation once (``sweep``, one summary line; each case must count
    K1's two launches and one of K2 and of K3 in ``wide_d_launches``),
    ``repeat`` (unmasked calls, ``REPEATS`` launches each, bit for bit the
    same, and ``bwd_parts_check``), then ``cases`` timed. The defaults are D in {192, 256}; the
    ``WIDER_BWD_*`` lists are D in {320, 384, 448, 512}. Returns the timed
    records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [w.wide_d_launches for w in wrappers]
    backward_phase(torch, peaks, sweep, seeds[0], f"{label}-sweep",
                   quiet=True)
    counted = [w.wide_d_launches - n for w, n in zip(wrappers, before)]
    n = len(sweep)
    if counted != [2 * n, n, n]:
        fail(f"{label}: K1, K2, K3 counted {counted} wide launches in "
             f"{n} sweep cases (want {[2 * n, n, n]})")
    for args in repeat:
        bwd_repeat_check(torch, *args, masked=False)
        bwd_parts_check(torch, *args)
    if repeat:
        print(f"{label}: {REPEATS} launches each of K2 and K3 at "
              f"{len(repeat)} unmasked calls agree bit for bit, and so do "
              "the halves of D their two parts compute", flush=True)
    return backward_phase(torch, peaks, cases, seeds[1], label)


# K1 above D = 256: every instantiation once (D in WIDER_HEAD_DIMS, bf16
# and f32, causal and not, with and without logsumexp, lq == lk and lq <
# lk), then in bf16 (the split kernel's 64-row q blocks) q/k/v views into
# a fused projection, lq 192 (three blocks, an odd count) and lk 320
# (not a multiple of 128); (name, shape, dtype, causal, with_lse, views)
WIDER_SWEEP = [
    (f"d{d}", shape + (d,), dt, causal, with_lse, False)
    for d in WIDER_HEAD_DIMS for dt in ("bfloat16", "float32")
    for shape in ((2, 4, 256, 256), (1, 2, 128, 384))
    for causal in (False, True) for with_lse in (False, True)] + [
    (f"{name}_d{d}", shape + (d,), "bfloat16", causal, with_lse, views)
    for d in WIDER_HEAD_DIMS for name, shape, causal, with_lse, views in (
        ("views", (2, 3, 256, 256), False, True, True),
        ("views", (2, 3, 256, 256), True, False, True),
        ("odd_blocks", (1, 2, 192, 192), True, True, False),
        ("odd_blocks", (1, 2, 192, 192), False, False, False),
        ("lk320", (1, 2, 192, 320), True, True, False),
        ("lk320", (1, 2, 64, 320), False, False, False))]
# identical bf16 K1-lse launches whose O and logsumexp must agree bit for
# bit every time (a race between the consumers and the ring shows so):
# (b, h, lq, lk, d, causal)
WIDER_REPEAT = ((2, 4, 512, 512, 512, True), (1, 2, 192, 192, 448, False))
REPEATS = 30
# the calls timed: the prefill call at DeepSeek-V4-Flash's attention
# widths (64 heads of 512, the 2048 bucket) in bf16 without and with
# logsumexp (the forward a training step would run), and bf16 at D =
# 384 (f32 at these head dims runs K1's f32 tensor-core kernel, whose
# phase times the f32 prefill: F32TC_FWD_CASES)
WIDER_CASES = [
    ("deepseek_bf16", (1, 64, 2048, 2048, 512), "bfloat16", True, None,
     False),
    ("deepseek_bf16_lse", (1, 64, 2048, 2048, 512), "bfloat16", True, None,
     True),
    ("bf16_d384", (2, 32, 2048, 2048, 384), "bfloat16", True, None, False),
]


def repeat_check(torch, make, b, h, lq, lk, d, causal, n=REPEATS):
    """``n`` identical bf16 K1-lse calls (the first against its plain
    version, ``fwd_check``): fail unless every O and logsumexp is bit for
    bit the first's."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    label = f"K1 wider repeat {[b, h, lq, lk, d]} causal={causal}"
    q, k, v, _ = fwd_check(torch, make, label, b, h, lq, lk, d, "bfloat16",
                           causal, None, True, "sm90_launches")
    first = fa.flash_attention(q, k, v, causal, None, True)
    differ = 0
    for _ in range(n - 2):
        out, lse = fa.flash_attention(q, k, v, causal, None, True)
        differ += not (torch.equal(out, first[0])
                       and torch.equal(lse, first[1]))
    if differ:
        fail(f"{label}: {differ} of {n - 2} repeated launches differ from "
             f"the second in O or logsumexp")


def wider_phase(torch, peaks):
    """K1 at D in {320, 384, 448, 512} through the ``flash_attention``
    wrapper against its plain version on the card (``WIDER_SWEEP``, one
    summary line), ``WIDER_REPEAT`` (``REPEATS`` launches each, bit for
    bit the same), then ``WIDER_CASES`` timed. Every launch must count in
    ``wide_d_launches``, every bf16 one in ``sm90_launches`` and every
    f32 one in ``f32tc_launches`` (``fwd_check``). Returns the timed
    records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(18)
    make = _make(torch, rng)
    sm90_before = fa.flash_attention.sm90_launches
    sweep = []
    for name, (b, h, lq, lk, d), dt, causal, with_lse, views in WIDER_SWEEP:
        _, _, _, rec = fwd_check(
            torch, make, f"K1 wider {name} {dt} {[b, h, lq, lk]} "
            f"causal={causal} lse={with_lse} views={views}", b, h, lq, lk,
            d, dt, causal, None, with_lse, "wide_d_launches", views=views)
        sweep.append(rec["share"])
    print(f"K1 wider: all {len(WIDER_SWEEP)} cases (D 320/384/448/512 x "
          f"bf16/f32 x causal x lse x lq == lk or lq < lk; bf16 views, lq "
          f"192, lk 320) match the plain version (largest error "
          f"{max(sweep):.3g} of its tolerance)", flush=True)
    for b, h, lq, lk, d, causal in WIDER_REPEAT:
        repeat_check(torch, make, b, h, lq, lk, d, causal)
    print(f"K1 wider: {REPEATS} launches each of "
          + " and ".join(f"{list(c[:5])} causal={c[5]}" for c in WIDER_REPEAT)
          + " gave the same O and logsumexp bit for bit", flush=True)
    want = (sum(c[2] == "bfloat16" for c in WIDER_SWEEP)
            + len(WIDER_REPEAT) * REPEATS)
    sm90 = fa.flash_attention.sm90_launches - sm90_before
    if sm90 != want:
        fail(f"K1 wider: {sm90} launches on K1's Hopper kernel (want every "
             f"bf16 call's: {want})")
    checks = timed_fwd_cases(torch, peaks, rng, WIDER_CASES,
                             "wide_d_launches", "K1 wider", iters=10)
    print(json.dumps({"wider_checks": checks}), flush=True)
    return checks


# K1's Hopper kernel (flash_attn_fwd_sm90.cu): every instantiation once
# (D 64/128/192/256, causal and not, with and without logsumexp, q/k/v
# views into a fused projection at lq == lk), then an odd number of
# 64-row q blocks (lq 192: the last 128-row block half empty), lq < lk
# causal, and lk past the last whole kv tile
SM90_SWEEP = [
    (f"d{d}", shape + (d,), "bfloat16", causal, with_lse, views)
    for d in (64, 128, 192, 256)
    for shape, causal, with_lse, views in (
        [((2, 3, 256, 256), c, w, True) for c in (False, True)
         for w in (False, True)]
        + [((1, 2, 192, 192), True, True, True),
           ((1, 2, 192, 192), False, False, False),
           ((1, 2, 128, 384), True, True, False),
           ((1, 2, 64, 320), False, True, False)])]


def _tail_mask(rng, b, lk):
    """Batch row 0 full, the others' real keys the last 40 (left padding:
    causal at lq < lk, their first rows see no key)."""
    m = np.zeros((b, lk), np.int32)
    m[0] = 1
    m[1:, lk - 40:] = 1
    return m


def _gap_mask(rng, b, lk):
    """Batch row 0 real in every third 64-key block, the others in a
    random few keys of the first block and in the last block: whole kv
    tiles of padding between real ones."""
    m = np.zeros((b, lk), np.int32)
    m[0] = (np.arange(lk) // 64) % 3 == 0
    m[1:, rng.randint(0, 64, 3)] = 1
    m[1:, lk - 64:] = 1
    return m


def _pattern_mask(rng, b, lk):
    """Each key real with probability 0.6 (key 0 always): every kv tile
    walked, each with its own mask, over many refills of each stage."""
    m = (rng.rand(b, lk) < 0.6).astype(np.int32)
    m[:, 0] = 1
    return m


# K1's Hopper kernel at the K5b head dims and with a key-padding mask:
# every head dim a call runs at up to 128 (each multiple of 16 is an
# instantiation; 8 mod 16 runs the next one up), without a mask and with
# _k5b_mask (a full row, one of 2 keys, one left-padded, one with no
# real key), with and without logsumexp, all at lq 192 (the last 128-row
# block half empty), causal for the unmasked ones at D = 8 (mod 16) and
# the masked ones at 0 (mod 16); then causal lq < lk with left padding
# (rows that see no key; lk 320 ends a 128-key tile half-way, so its
# mask copy is 64 bytes), masks with wholly padded kv tiles between real
# ones (the list of tiles walked; at lk 4224 more tiles than one round of
# 32), the same causal at lq == lk, and random masks over 1024 keys (each
# stage refilled with tiles whose masks differ)
SM90_MASKED_SWEEP = [
    (f"d{d}", (4, 2, 192, 192, d), "bfloat16", causal, mask_of, with_lse)
    for d in range(8, 129, 8)
    for causal, mask_of in ((d % 16 == 8, None), (d % 16 == 0, _k5b_mask))
    for with_lse in (False, True)] + [
    (f"cross_d{d}", (2, 2, 64, 320, d), "bfloat16", True, _tail_mask, True)
    for d in (24, 64, 80, 128)] + [
    (f"gaps_d{d}", (2, 2, 128, 4224, d), "bfloat16", False, _gap_mask, True)
    for d in (32, 128)] + [
    (f"gaps_causal_d{d}", (2, 2, 384, 384, d), "bfloat16", True, _gap_mask,
     False) for d in (40, 80)] + [
    (f"pattern_d{d}", (2, 2, 128, 1024, d), "bfloat16", causal,
     _pattern_mask, True) for d in (32, 64, 80, 128)
    for causal in (False, True)]
# the calls timed: the served call and the SQuAD fit's K1-lse (BERT-base,
# D = 64), [8,8,2048,d] causal at 256 and 192, and the GPT-J-width LM
# fit's K1-lse (the K5b and masked calls are timed in phases 4, 9 and 10)
SM90_CASES = [
    ("served", (32, 12, 512, 512, 64), "bfloat16", False, None, False),
    ("trained_lse", (48, 12, 384, 384, 64), "bfloat16", False, None, True),
    ("bf16_d256", (8, 8, 2048, 2048, 256), "bfloat16", True, None, False),
    ("bf16_d192", (8, 8, 2048, 2048, 192), "bfloat16", True, None, False),
    ("gptj_lse", (4, 16, 2048, 2048, 256), "bfloat16", True, None, True),
]
SM90_VIEWS = ("served", "trained_lse", "gptj_lse")


def map_encode_us(torch, fa, b, h, l, d, iters=1000):
    """Host microseconds to encode one call's three tensor maps (the
    kernel's own helper, ``zoo_flash_attn_fwd_sm90_map_ns``, on views
    into a fused projection)."""
    import ctypes

    lib = fa.build_kernels()["flash_attn_fwd_sm90"]
    fn = lib.zoo_flash_attn_fwd_sm90_map_ns
    fn.restype = ctypes.c_double
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int])
    qkv = torch.empty(b, l, 3, h, d, dtype=torch.bfloat16, device="cuda")
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    ns = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, h, l, l, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], iters)
    if ns < 0:
        fail(f"map encoding refused [{b},{h},{l},{d}]: code {-ns}")
    return ns / 1e3


def sm90_phase(torch, peaks):
    """K1's Hopper kernel through the ``flash_attention`` wrapper against
    its plain version on the card (``SM90_SWEEP``, then
    ``SM90_MASKED_SWEEP``, one summary line each; each launch must count
    in ``sm90_launches``), then ``SM90_CASES`` timed,
    and the host time of encoding a call's tensor maps. Returns the timed
    records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(22)
    make = _make(torch, rng)
    sweep = []
    for name, (b, h, lq, lk, d), dt, causal, with_lse, views in SM90_SWEEP:
        _, _, _, rec = fwd_check(
            torch, make, f"K1 sm90 {name} {[b, h, lq, lk]} causal={causal} "
            f"lse={with_lse} views={views}", b, h, lq, lk, d, dt, causal,
            None, with_lse, "sm90_launches", views=views)
        sweep.append(rec["share"])
    print(f"K1 sm90: all {len(SM90_SWEEP)} cases (D 64/128/192/256 x causal "
          f"x lse, views, lq 192, lq < lk, lk past a whole kv tile) match "
          f"the plain version (largest error {max(sweep):.3g} of its "
          f"tolerance)", flush=True)
    sweep = []
    for name, (b, h, lq, lk, d), dt, causal, mask_of, with_lse in (
            SM90_MASKED_SWEEP):
        m = (None if mask_of is None
             else torch.from_numpy(mask_of(rng, b, lk)).cuda())
        _, _, _, rec = fwd_check(
            torch, make, f"K1 sm90 {name} {[b, h, lq, lk]} causal={causal} "
            f"mask={m is not None} lse={with_lse}", b, h, lq, lk, d, dt,
            causal, m, with_lse, "sm90_launches")
        sweep.append(rec["share"])
    print(f"K1 sm90: all {len(SM90_MASKED_SWEEP)} K5b and masked cases (D "
          f"8..128 x mask/none x lse/none at lq 192, rows that see no key, "
          f"lq < lk causal, wholly padded kv tiles, random masks) match the "
          f"plain version "
          f"(largest error {max(sweep):.3g} of its tolerance)", flush=True)
    checks = timed_fwd_cases(torch, peaks, rng, SM90_CASES, "sm90_launches",
                             "K1 sm90", views=SM90_VIEWS)
    encode = {"served": map_encode_us(torch, fa, 32, 12, 512, 64),
              "gptj": map_encode_us(torch, fa, 4, 16, 2048, 256)}
    for rec in checks:
        rec["map_encode_us"] = encode["gptj" if rec["shape"][-1] == 256
                                      else "served"]
    print(f"K1 sm90: encoding a call's three tensor maps takes "
          f"{encode['served']:.3f} us on the host (served call), "
          f"{encode['gptj']:.3f} us (the LM's)", flush=True)
    print(json.dumps({"sm90_checks": checks}), flush=True)
    return checks


# K2 and K3's Hopper kernels (flash_attn_bwd_sm90.cu), with K1 and K1-lse
# beside them: every instantiation once (D 64/128/192/256, causal and not,
# q/k/v views into a fused projection at lq == lk), then an odd number of
# 64-row q tiles (lq 192: K2's last 128-row block half empty), lq < lk
# causal (the bottom-right diagonal; K3's first q tile mid-diagonal), and
# lk past the last whole 128-key block (K3's second consumer without keys
# at D = 128)
SM90_BWD_SWEEP = [
    (name, shape + (d,), "bfloat16", causal, None, False)
    for d in (64, 128, 192, 256) for name, shape, causal in (
        [("sm90_views", (2, 3, 256, 256), c) for c in (False, True)]
        + [("sm90_views", (1, 2, 192, 192), True),
           ("odd_tiles", (1, 2, 192, 192), False),
           ("cross", (1, 2, 128, 384), True),
           ("past_tile", (1, 2, 64, 320), False),
           ("past_tile", (1, 2, 192, 320), True)])]
# the same kernels at the K5b head dims and with a key-padding mask: every
# head dim a call runs at up to 128 (each multiple of 16 is an
# instantiation; 8 mod 16 runs the next one up), causal and not, without
# a mask and with _k5b_mask (a full row, one of 2 keys, one left-padded,
# one with no real key), all at lq 192 (K2's last 128-row block half
# empty); then causal lq < lk with left padding (rows that see no key; lk
# 320 ends K3's last 128-key block half-way), masks with wholly padded kv
# tiles between real ones (K2's list of tiles walked, K3's key blocks of
# padding; at lk 4224 more tiles than one round of 32), the same causal at
# lq == lk, and random masks over 1024 keys (each stage refilled with
# tiles whose masks differ)
SM90_BWD_MASKED_SWEEP = [
    (f"d{d}", (4, 2, 192, 192, d), "bfloat16", causal, mask_of, False)
    for d in range(8, 129, 8) for causal in (False, True)
    for mask_of in (None, _k5b_mask)] + [
    (f"cross_d{d}", (2, 2, 64, 320, d), "bfloat16", True, _tail_mask, False)
    for d in (24, 64, 80, 128)] + [
    (f"gaps_d{d}", (2, 2, 128, 4224, d), "bfloat16", False, _gap_mask,
     False) for d in (32, 128)] + [
    (f"gaps_causal_d{d}", (2, 2, 384, 384, d), "bfloat16", True, _gap_mask,
     False) for d in (40, 80)] + [
    (f"pattern_d{d}", (2, 2, 128, 1024, d), "bfloat16", causal,
     _pattern_mask, False) for d in (32, 64, 80, 128)
    for causal in (False, True)]
# calls whose K2 and K3 launch REPEATS times with one random mask (K3's
# two blocks an SM at D = 32, its 128-key blocks at 80 and 128, K2's list
# at lq < lk causal): (b, h, lq, lk, d, causal)
SM90_BWD_REPEAT = ((4, 4, 256, 256, 32, False), (4, 4, 256, 256, 80, True),
                   (2, 4, 256, 512, 128, True))
# the calls timed: the BERT-base SQuAD fit's (views), [8,8,2048,128]
# causal, [4,16,2048,192] causal and the GPT-J-width LM fit's (views); the
# masked NER call and the MiniLM calls are timed in phases 4 and 10
SM90_BWD_CASES = [
    ("trained", (48, 12, 384, 384, 64), "bfloat16", False, None, True),
    ("bf16_d128", (8, 8, 2048, 2048, 128), "bfloat16", True, None, True),
    ("bf16_d192", (4, 16, 2048, 2048, 192), "bfloat16", True, None, True),
    ("gptj_trained", (4, 16, 2048, 2048, 256), "bfloat16", True, None, True),
]


def bwd_repeat_check(torch, b, h, lq, lk, d, causal, n=REPEATS,
                     masked=True):
    """``n`` identical bf16 K2 and K3 launches on one call, with a random
    key-padding mask (``_pattern_mask``) where ``masked``: fail unless
    every dQ, delta, dK and dV is bit for bit the first's."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(b + h + lq + lk + d)

    def make(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
    do = make(b, h, lq, d)
    m = (fa._kernel_mask(torch.from_numpy(_pattern_mask(rng, b, lk)).cuda())
         if masked else None)
    o, lse = fa.flash_attention(q, k, v, causal, None, True, m)
    first, differ = None, 0
    for _ in range(n):
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                              None, m)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal,
                                            None, m)
        got = (dq, delta, dk, dv)
        if first is None:
            first = got
        else:
            differ += not all(torch.equal(x, y) for x, y in zip(got, first))
    if differ:
        fail(f"K2/K3 sm90 repeat {[b, h, lq, lk, d]} causal={causal}: "
             f"{differ} of {n - 1} repeated launches differ from the first "
             "in dQ, delta, dK or dV")


def bwd_parts_check(torch, b, h, lq, lk, d, causal):
    """K2 and K3 bf16 at D = 384 or 512 split D's columns in halves: K2's
    two consumers own one half of dQ each and K3's two blocks of a key
    block one half of dK and dV each, and each of them rebuilds P (and
    dS) itself. With Q and dO whose two halves are the same, dK's and
    dV's halves must be bit for bit the same, and with K's two halves the
    same, dQ's: fail unless they are (two builds of P that differ in
    their last bits show so)."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    if d not in (384, 512):
        fail(f"K2/K3 parts check at D = {d}: its halves are not the parts")
    rng = np.random.RandomState(b + h + lq + lk + d + 1)
    half = d // 2

    def make(*shape, twin=False):
        x = rng.randn(*shape[:-1], half if twin else d).astype(np.float32)
        if twin:
            x = np.concatenate([x, x], -1)
        return torch.from_numpy(x).to("cuda", torch.bfloat16)

    differ = {}
    for twins in ("q_do", "k"):
        q = make(b, h, lq, d, twin=twins == "q_do")
        k = make(b, h, lk, d, twin=twins == "k")
        v = make(b, h, lk, d)
        do = make(b, h, lq, d, twin=twins == "q_do")
        o, lse = fa.flash_attention(q, k, v, causal, None, True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        if twins == "k":
            outs = {"dQ": dq}
        else:
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                causal)
            outs = {"dK": dk, "dV": dv}
        for name, x in outs.items():
            differ[name] = int(x[..., :half].ne(x[..., half:]).sum())
    if any(differ.values()):
        fail(f"K2/K3 sm90 parts {[b, h, lq, lk, d]} causal={causal}: the "
             f"two halves of an output differ in {differ} entries")


def sm90_bwd_phase(torch, peaks):
    """K2 and K3's Hopper kernels through ``backward_phase``: every
    instantiation once, unmasked at 64-256 (``SM90_BWD_SWEEP``), then at
    every head dim up to 128 with and without a mask
    (``SM90_BWD_MASKED_SWEEP``), one summary line each (each case must
    count its two K1 launches and one of K2 and of K3 in
    ``sm90_launches``); ``SM90_BWD_REPEAT`` (``REPEATS`` launches each,
    bit for bit the same); then ``SM90_BWD_CASES`` timed. Returns the
    timed records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for sweep, seed, label in ((SM90_BWD_SWEEP, 23, "sm90-bwd-sweep"),
                               (SM90_BWD_MASKED_SWEEP, 27,
                                "sm90-bwd-masked-sweep")):
        before = [w.sm90_launches for w in wrappers]
        backward_phase(torch, peaks, sweep, seed, label, quiet=True)
        counted = [w.sm90_launches - n for w, n in zip(wrappers, before)]
        n = len(sweep)
        if counted != [2 * n, n, n]:
            fail(f"{label}: K1, K2, K3 counted {counted} Hopper launches in "
                 f"{n} sweep cases (want {[2 * n, n, n]})")
    for args in SM90_BWD_REPEAT:
        bwd_repeat_check(torch, *args)
    print(f"K2/K3 sm90: {REPEATS} launches each of {len(SM90_BWD_REPEAT)} "
          f"masked calls agree bit for bit", flush=True)
    return backward_phase(torch, peaks, SM90_BWD_CASES, 24, "sm90-bwd")


# K2 and K3 in f32 on the tensor cores (flash_attn_bwd_f32tc.cu), with K1
# and K1-lse beside them: every instantiation once, D = 8..128 in steps
# of 8, each without a mask and with _k5b_mask (a full row, one of 2 real
# keys, one left-padded, one with no real key), causal and not, q/k/v as
# views into a fused projection (unmasked), and lq < lk causal both ways
# (the masked one with _right_100's rows that see no key); then
# _k5b_mask's rows at L = 1024, D = 32, 64 and 128; then D = 192 to 512
# without a mask (views, causal and not; lq < lk causal; causal at L =
# 2048, where dQ, dK and dV pass seven flushes)
F32TC_SWEEP = [
    (name, shape + (d,), "float32", causal, mask_of, False)
    for d in range(8, 129, 8) for name, shape, causal, mask_of in (
        [("f32tc_views", (2, 3, 128, 128), c, None) for c in (False, True)]
        + [("f32tc_masked", (4, 2, 128, 128), c, _k5b_mask)
           for c in (False, True)]
        + [("f32tc_cross", (1, 2, 64, 192), True, None),
           ("f32tc_cross_left", (1, 2, 128, 384), True, _right_100)])] + [
    # a row of 2 real keys over a long sequence: P near 1/2 for 1024 q
    # rows, where sums run in the tensor cores' accumulators would drift
    ("f32tc_long_masked", (4, 2, 1024, 1024, d), "float32", False, _k5b_mask,
     False) for d in (32, 64, 128)] + [
    (name, shape + (d,), "float32", causal, None, False)
    for d in (192, 256, 320, 384, 448, 512) for name, shape, causal in (
        [("f32tc_views", (2, 3, 128, 128), c) for c in (False, True)]
        + [("f32tc_cross", (1, 2, 64, 192), True),
           ("f32tc_long", (1, 2, 2048, 2048), True)])]
# the calls timed: the BERT-base trained call (views), the NER trained
# call (masked, views), MiniLM's trained call without and with a mask
# (K5b at D = 32, views), cross-length causal [1,2,128->384,128],
# [8,8,2048,128] causal, and causal above 128: the GPT-J-width LM's f32
# gradient check's call [1,16,2048,256], the 512-head LM's
# [1,8,2048,512], [1,16,2048,192] and [1,8,2048,384]
F32TC_CASES = [
    ("trained", (48, 12, 384, 384, 64), "float32", False, None, True),
    ("ner_trained", (32, 12, 128, 128, 64), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,)), True),
    ("minilm_trained", (48, 12, 384, 384, 32), "float32", False, None,
     True),
    ("minilm_padded", (48, 12, 384, 384, 32), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 64), True),
    ("cross_causal", (1, 2, 128, 384, 128), "float32", True, None, True),
    ("f32_d128", (8, 8, 2048, 2048, 128), "float32", True, None, True),
    ("f32_d256", (1, 16, 2048, 2048, 256), "float32", True, None, True),
    ("f32_d512", (1, 8, 2048, 2048, 512), "float32", True, None, True),
    ("f32_d192", (1, 16, 2048, 2048, 192), "float32", True, None, True),
    ("f32_d384", (1, 8, 2048, 2048, 384), "float32", True, None, True),
]


def sdpa_bwd_kernels(torch, b, h, l, d):
    """The CUDA kernels SDPA's backward runs at an f32 call [b, h, l, d]
    (random q, k, v and dO; one profiler window): a yardstick's names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = [torch.randn(b, h, l, d, device="cuda", requires_grad=True)
         for _ in range(3)]
    out = torch.nn.functional.scaled_dot_product_attention(*x)
    grad = torch.randn_like(out)
    torch.cuda.synchronize()
    # CPU and CUDA activity, as device_ms takes them; late in a run a
    # window can still lose its records (an empty list)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, x, grad)
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count > 0})


def f32tc_phase(torch, peaks):
    """K2 and K3's f32 tensor-core kernels through ``backward_phase``:
    every instantiation once (``F32TC_SWEEP``, one summary line; each case
    must count one K2 and one K3 launch in ``f32tc_launches``, which
    ``backward_phase`` checks), then ``F32TC_CASES`` timed. Returns the
    timed records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [w.f32tc_launches for w in wrappers]
    backward_phase(torch, peaks, F32TC_SWEEP, 25, "f32tc-bwd-sweep",
                   quiet=True)
    counted = [w.f32tc_launches - n for w, n in zip(wrappers, before)]
    n = len(F32TC_SWEEP)
    if counted != [n, n]:
        fail(f"K2/K3 f32tc: K2, K3 counted {counted} f32 tensor-core "
             f"launches in {n} sweep cases (want {[n, n]})")
    checks = backward_phase(torch, peaks, F32TC_CASES, 26, "f32tc-bwd")
    trained = _pick(checks, "trained", "float32")
    trained["sdpa_bwd_kernels"] = sdpa_bwd_kernels(torch, 48, 12, 384, 64)
    print(f"f32tc-bwd: SDPA's f32 backward ({trained['sdpa_backend']}) at "
          f"the trained call runs {trained['sdpa_bwd_kernels']}", flush=True)
    return checks


# K1 in f32 on the tensor cores (flash_attn_fwd_f32tc.cu): every
# instantiation once -- D = 8..128 in steps of 8, each without a mask (q/k/v
# views into a fused projection) and with _k5b_mask (a full row, one of 2
# real keys, one left-padded, one with no real key), causal and not, with
# and without logsumexp; D = 192 to 512 (views, no mask), causal and not,
# with and without logsumexp -- then lq < lk causal (unmasked, and with
# _right_100's rows that see no key), long causal calls (L = 4096, where
# O sums 4096 keys) and masked calls at L = 1024 with a row of 2 real
# keys. name, (b, h, lq, lk, d), causal, mask, with_lse, views
F32TC_FWD_SWEEP = [
    (f"d{d}", shape + (d,), causal, mask_of, with_lse, views)
    for d in range(8, 129, 8)
    for shape, mask_of, views in (((2, 3, 128, 128), None, True),
                                  ((4, 2, 128, 128), _k5b_mask, False))
    for causal in (False, True) for with_lse in (False, True)] + [
    (f"d{d}", (2, 3, 128, 128, d), causal, None, with_lse, True)
    for d in (192, 256) + WIDER_HEAD_DIMS for causal in (False, True)
    for with_lse in (False, True)] + [
    ("cross", (1, 2, 64, 192, d), True, None, True, False)
    for d in (8, 64, 80, 128, 192, 256) + WIDER_HEAD_DIMS] + [
    ("cross_left", (1, 2, 128, 384, d), True, _right_100, True, False)
    for d in (16, 64, 128)] + [
    ("long_causal", (1, 4, 4096, 4096, d), True, None, True, False)
    for d in (64, 256, 512)] + [
    ("long_masked", (4, 2, 1024, 1024, d), False, _k5b_mask, True, False)
    for d in (32, 64, 128)]
# the calls timed: the served shape at the f32 kernel phase's batch
# (views), the BERT-base trained K1-lse (views), the NER trained K1-lse
# (masked, views), MiniLM's trained K1-lse without and with a mask (K5b at
# D = 32, views), cross-length causal [1,2,128->384,128], [8,8,2048,128]
# causal, the prefills of the three f32 generation phases at their
# widths (Phi-2's [1,32,2048,80] and the repo geometry's [1,2,256,16] in
# their top buckets, Gemma-2B's [1,8,8192,256]), the Gemma-width K1-lse
# at its 2048 bucket, the DeepSeek-width prefill [1,64,2048,512], the
# 512-head LM's f32 gradient check's K1-lse [1,8,2048,512] and
# [2,32,2048,384] causal. name, shape, dtype, causal, mask, with_lse
F32TC_FWD_CASES = [
    ("served", (8, 12, 512, 512, 64), "float32", False, None, False),
    ("trained_lse", (48, 12, 384, 384, 64), "float32", False, None, True),
    ("ner_lse", (32, 12, 128, 128, 64), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,)), True),
    ("minilm_lse", (48, 12, 384, 384, 32), "float32", False, None, True),
    ("minilm_padded_lse", (48, 12, 384, 384, 32), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 64), True),
    ("cross_causal", (1, 2, 128, 384, 128), "float32", True, None, False),
    ("f32_d128", (8, 8, 2048, 2048, 128), "float32", True, None, False),
    ("phi2_prefill", (1, 32, 2048, 2048, 80), "float32", True, None, False),
    ("repo_prefill", (1, 2, 256, 256, 16), "float32", True, None, False),
    ("gemma_prefill", (1, 8, 8192, 8192, 256), "float32", True, None,
     False),
    ("gemma_lse", (1, 8, 2048, 2048, 256), "float32", True, None, True),
    ("deepseek_prefill", (1, 64, 2048, 2048, 512), "float32", True, None,
     False),
    ("lm512_lse", (1, 8, 2048, 2048, 512), "float32", True, None, True),
    ("f32_d384", (2, 32, 2048, 2048, 384), "float32", True, None, False),
]
F32TC_FWD_VIEWS = ("served", "trained_lse", "ner_lse", "minilm_lse",
                   "minilm_padded_lse")


def f32tc_fwd_phase(torch, peaks):
    """K1's f32 tensor-core kernel through the ``flash_attention``
    wrapper against its plain version on the card (TF32 off:
    ``no_tf32``): ``F32TC_FWD_SWEEP`` (seed 27, one summary line; each
    case must count one launch in ``f32tc_launches``), then
    ``F32TC_FWD_CASES`` timed (seed 28), each beside its plain version,
    SDPA's f32 forward and its backend, the bound at f32 accuracy and on
    FMA. Returns the timed records."""
    no_tf32(torch, "K1 f32tc")
    rng = np.random.RandomState(27)
    make = _make(torch, rng)
    sweep = []
    for name, (b, h, lq, lk, d), causal, mask_of, with_lse, views in (
            F32TC_FWD_SWEEP):
        m = (None if mask_of is None
             else torch.from_numpy(mask_of(rng, b, lk)).cuda())
        _, _, _, rec = fwd_check(
            torch, make, f"K1 f32tc {name} {[b, h, lq, lk, d]} "
            f"causal={causal} mask={m is not None} lse={with_lse}", b, h, lq,
            lk, d, "float32", causal, m, with_lse, "f32tc_launches",
            views=views)
        sweep.append(rec["share"])
    print(f"K1 f32tc: all {len(F32TC_FWD_SWEEP)} cases (D 8..128 x mask x "
          f"causal x lse, views; 192..512 x causal x lse; lq < lk, rows "
          f"that see no key, L = 4096 causal, L = 1024 with a row of 2 "
          f"real keys) match the plain version (largest error "
          f"{max(sweep):.3g} of its tolerance)", flush=True)
    checks = timed_fwd_cases(torch, peaks, np.random.RandomState(28),
                             F32TC_FWD_CASES, "f32tc_launches", "K1 f32tc",
                             views=F32TC_FWD_VIEWS)
    print(json.dumps({"f32tc_fwd_checks": checks}), flush=True)
    return checks


def _pick(records, name, dt="bfloat16"):
    return next(r for r in records if r["case"] == name and r["dtype"] == dt)


BERT_BASE = dict(num_classes=2, vocab=30522, hidden_size=768, n_block=12,
                 n_head=12, intermediate_size=3072, max_position_len=512,
                 dtype="bfloat16")
# the JAX package's fine-tune workload (bench.py measure_bert): BERT-base
# BERTSQuAD, seq 384, batch 48, 16 steps an epoch, bf16 encoder
SQUAD_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                  intermediate_size=3072, max_position_len=512,
                  dtype="bfloat16")
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 384, 48, 16
BF16_PEAK = 989e12


def profile_batch(torch, model, x, iters=10) -> None:
    """Where one served batch's time goes: host wall time per predict,
    device time by kernel (torch.profiler), and the device idle share."""
    from torch.profiler import ProfilerActivity, profile

    model.predict(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict(x)
    wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.predict(x)
        torch.cuda.synchronize()
    shape = x["input_ids"].shape if isinstance(x, dict) else x.shape
    _print_rows(prof, 3, wall, f"batch {shape} predict")


# kernel-name marks of the groups a profile is summed into
KERNEL_GROUPS = (
    ("flash (K1-K3)", ("flash_fwd", "flash_bwd")),
    ("gemm", ("nvjet", "gemm", "cutlass", "Kernel2")),
    ("layer_norm", ("layer_norm", "GammaBeta")),
    ("indexing (KV gathers)", ("index", "gather")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
)


def _print_rows(prof, n, wall, what, top=14, kernel_groups=KERNEL_GROUPS):
    """Device time by kernel per iteration (``n`` profiled iterations),
    and the idle share against ``wall`` (seconds per iteration, measured
    without the profiler, whose host-side cost would stretch the
    window). Kernel rows only: an operator row repeats its kernels'
    device time. Returns (wall ms, busy ms, {group: ms})."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / (n * 1e3), e.count / n, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: {what} wall {wall * 1e3:.3f} ms; device busy "
          f"{busy:.3f} ms per iteration; idle share "
          f"{1 - busy / (wall * 1e3):.3f}", flush=True)
    for ms, calls, name in rows[:top]:
        print(f"profile:   {ms:9.4f} ms {100 * ms / max(busy, 1e-9):5.1f}% "
              f"x{calls:g} {name[:90]}", flush=True)
    groups = {}
    for ms, calls, name in rows:
        key = next((g for g, marks in kernel_groups if any(
            m in name for m in marks)), "other")
        groups[key] = groups.get(key, 0.0) + ms
    print("profile:   by group " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])),
        flush=True)
    return wall * 1e3, busy, groups


def _reset_launches(fa):
    for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        w.launches = w.masked_launches = w.small_d_launches = 0
        w.wide_d_launches = w.sm90_launches = w.f32tc_launches = 0


def _launches(fa):
    """{kernel: (launches, launches with a mask, launches at a head dim
    that is not a multiple of 64, launches above D = 128, launches of
    the Hopper kernels: K1's flash_attn_fwd_sm90.cu, K2's and K3's
    flash_attn_bwd_sm90.cu, and launches of the f32 tensor-core kernels:
    K1's flash_attn_fwd_f32tc.cu, K2's and K3's
    flash_attn_bwd_f32tc.cu)} since the last reset."""
    return {name: (w.launches, w.masked_launches, w.small_d_launches,
                   w.wide_d_launches, w.sm90_launches, w.f32tc_launches)
            for name, w in (
        ("K1", fa.flash_attention), ("K2", fa.flash_attention_bwd_dq),
        ("K3", fa.flash_attention_bwd_dkv))}


def _sm90_expected(torch, fa, dtype, launches):
    """{kernel: how many of its launches in ``launches`` (``_launches``'s
    form) must have run on the Hopper kernels}: all of a call that
    ``_fwd_entry`` (K1: ``flash_attn_fwd_sm90.cu``) or ``_bwd_entry`` (K2
    and K3: ``flash_attn_bwd_sm90.cu``) sends there, every bf16 call;
    none of any other."""
    dt = getattr(torch, dtype)
    hopper = dict(zip(("K1", "K2", "K3"), (
        fa._fwd_entry(dt), *fa._bwd_entry(dt))))
    return {name: counts[0] if hopper[name].endswith("_sm90") else 0
            for name, counts in launches.items()}


def _check_sm90(label, launches, want):
    """Fail unless each kernel's Hopper launches in ``launches`` are what
    ``want`` (``_sm90_expected``) says; returns a line that says where
    they ran."""
    for name, n in want.items():
        got, total = launches[name][4], launches[name][0]
        if got != n:
            fail(f"{label}: {got} of {total} {name} launches on the Hopper "
                 f"kernel (want {n})")
    return f"{label}: Hopper kernels " + ", ".join(
        f"{name} {launches[name][4]} of {launches[name][0]}"
        + ("" if launches[name][4] else " (f32 tensor-core kernels)")
        for name in want)


def _check_bf16_on_sm90(label, launches):
    """``_check_sm90`` for a phase of bf16 calls beside f32 ones: every
    K1, K2 and K3 launch in ``launches`` that is not an f32 tensor-core
    one must have run on the Hopper kernels."""
    return _check_sm90(label, launches, {
        name: counts[0] - counts[5] for name, counts in launches.items()})


def _f32tc_expected(torch, fa, dtype, launches):
    """{kernel: how many of its launches in ``launches`` must have run on
    the f32 tensor-core kernels}: every K1, K2 and K3 launch of an f32
    call (flash_attn_fwd_f32tc.cu and flash_attn_bwd_f32tc.cu, up to D =
    512), masked or not; none of any other."""
    dt = getattr(torch, dtype)
    tc = dict(zip(("K1", "K2", "K3"), (
        fa._fwd_entry(dt), *fa._bwd_entry(dt))))
    return {name: counts[0] if tc[name].endswith("_f32tc") else 0
            for name, counts in launches.items()}


def _check_f32tc(label, launches, want):
    """Fail unless each kernel's f32 tensor-core launches in ``launches``
    are what ``want`` (``_f32tc_expected``) says; returns a line that
    says where K1, K2 and K3 ran."""
    for name, n in want.items():
        got, total = launches[name][5], launches[name][0]
        if got != n:
            fail(f"{label}: {got} of {total} {name} launches on the f32 "
                 f"tensor-core kernels (want {n})")
    return f"{label}: f32 tensor-core kernels " + ", ".join(
        f"{name} {launches[name][5]} of {launches[name][0]}"
        for name in ("K1", "K2", "K3"))


# K2's and K3's launches in the learn phases' f32 gradient checks (one
# train step of the f32 model, flash attention): {label: _launches}
F32_CHECK_LAUNCHES = {}


def serving_phase(torch, start, reqs, input_fn, out_shape, n_block,
                  masked=False, label="serving", device="cuda",
                  profile=False):
    """One closed burst of ``reqs`` ({uri: {name: array}}) through the
    deployment ``start()`` brings up (load and warm-up included); it
    returns (input queue, output queue, InferenceModel, batcher, stop).
    Checks that every request is answered once with finite
    ``out_shape`` logits, that K1 ran (with the mask, where ``masked``)
    for every encoder layer of every dispatched batch, and that 4
    replies match the same model with einsum attention (at real tokens,
    where requests carry an ``attention_mask``), and that K1 ran on the
    Hopper kernel exactly where ``_sm90_expected`` says (a bf16
    model). ``input_fn`` maps named tensors to the model's input,
    as the worker does. Returns K1's ``_launches`` tuple."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.obs.metrics import get_registry
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    cfg = get_config()
    # the auto threshold (512) is the reference's TPU figure; serve
    # through the kernel explicitly
    cfg.set("zoo.ops.attention_impl", "flash")
    n_requests = len(reqs)
    dispatch = get_registry().get(
        "zoo_inference_dispatch_total").labels(mode="off")
    d0 = dispatch.value
    _reset_launches(fa)
    # ---- main path: start (load, warm-up) -> ServingWorker ->
    # InferenceModel ----
    t0 = time.perf_counter()
    in_q, out_q, model, batcher, stop = start()
    print(f"{label}: up in {time.perf_counter() - t0:.1f}s", flush=True)
    try:
        sent, got, lat = {}, {}, []
        t_start = time.perf_counter()
        for uri, tensors in reqs.items():
            sent[uri] = time.perf_counter()
            if not in_q.enqueue(uri, **tensors):
                fail(f"{label}: enqueue refused {uri}")
        deadline = time.perf_counter() + 300
        while len(got) < n_requests and time.perf_counter() < deadline:
            item = out_q.dequeue(timeout=1.0)
            if item is None:
                continue
            uri, tensors = item
            if uri in got:
                fail(f"{label}: {uri} answered twice")
            lat.append(time.perf_counter() - sent[uri])
            got[uri] = tensors
        wall = time.perf_counter() - t_start
        k1 = _launches(fa)["K1"]
        dispatched = int(dispatch.value - d0)
        # ---- end of the main path ----
        stats = batcher.stats()
        if set(got) != set(reqs):
            fail(f"{label}: answered {len(got)}/{n_requests} requests")
        for uri, tensors in got.items():
            out = tensors.get("output")
            if out is None or out.shape != out_shape \
                    or not np.isfinite(out).all():
                fail(f"{label} {uri}: bad reply "
                     f"{tensors if out is None else out.shape}")
        need = n_block * dispatched if device == "cuda" else 0
        if k1[int(masked)] < need:
            fail(f"{label}: K1 launched {k1[int(masked)]} times"
                 + (" with a mask" if masked else "") + f" < {n_block} x "
                 f"{dispatched} dispatched batches")
        # every launch of a bf16 model, masked or not, on the Hopper
        # kernel
        if device == "cuda":
            _check_sm90(label, {"K1": k1}, _sm90_expected(
                torch, fa, "bfloat16", {"K1": k1}))

        def batch_of(uris):
            return input_fn({k: np.stack([reqs[u][k] for u in uris])
                             for k in reqs[uris[0]]})

        # reference: the same served model, einsum attention path
        check = sorted(reqs)[:4]
        cfg.set("zoo.ops.attention_impl", "einsum")
        ref = model.predict(batch_of(check))
        cfg.set("zoo.ops.attention_impl", "flash")
        served = np.stack([got[u]["output"] for u in check])
        diff = np.abs(served - ref)
        if "attention_mask" in reqs[check[0]]:
            diff = diff[np.stack([reqs[u]["attention_mask"]
                                  for u in check]) != 0]
        diff = float(diff.max())
        print(f"{label}: flash vs einsum logits max_abs_diff={diff:.4g}"
              f" (tol {SERVE_TOL}); logits[0]={served[0].ravel()[:4]}",
              flush=True)
        if not diff <= SERVE_TOL:
            fail(f"{label}: served logits differ from the einsum path by "
                 f"{diff}")
        if profile:
            # a batch of the size the batcher served the burst in
            x = batch_of(sorted(reqs)[:stats["max_batch_size"]])
            for impl in ("flash", "einsum"):
                cfg.set("zoo.ops.attention_impl", impl)
                print(f"profile: attention_impl={impl}", flush=True)
                profile_batch(torch, model, x)
            cfg.set("zoo.ops.attention_impl", "flash")
    finally:
        stop()
    lat_ms = np.asarray(lat) * 1e3
    first = next(iter(reqs.values()))
    seq = first["input_ids"].shape[0]
    real = sum(int(np.count_nonzero(t["attention_mask"])) if
               "attention_mask" in t else seq for t in reqs.values())
    summary = {
        "requests": n_requests, "seq": seq, "wall_s": wall,
        "rps": n_requests / wall, "real_tokens_per_s": real / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "dispatched_batches": dispatched, "k1_launches": k1[0],
        "k1_masked_launches": k1[1], "k1_sm90_launches": k1[4],
        "served_batches": stats["batches"],
        "mean_occupancy": stats["mean_occupancy"],
        "max_batch_size": stats["max_batch_size"],
        "einsum_max_abs_diff": diff,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else device)}
    print(f"{label}: " + json.dumps(summary), flush=True)
    return k1


def bert_serving(torch, device="cuda", base=BERT_BASE, n_requests=64,
                 seq=512, batch=8, profile=False):
    """A seeded BERT-base BERTClassifier saved, then served through
    ``launch()`` (which warms every bucket up to the batcher's growth
    cap): ``n_requests`` requests of ``input_ids [seq]``, no mask."""
    from analytics_zoo_tpu_torch.models.text.bert_estimators import (
        BERTClassifier)
    from analytics_zoo_tpu_torch.serving.launcher import launch

    rng = np.random.RandomState(0)
    reqs = {f"req{i:03d}": {"input_ids": rng.randint(
        0, base["vocab"], seq).astype(np.int32)} for i in range(n_requests)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        BERTClassifier(device=device, seed=0, **base).save_model(tmp)
        print(f"serving: BERT-base saved in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        def start():
            app = launch({
                "model": {"path": tmp},
                "params": {"batch_size": batch,
                           "warm_example": np.zeros((1, seq), np.int32)},
                "http": {"enabled": False}}, device=device)
            return (app.input_queue, app.output_queue, app.model,
                    app.worker.batcher, app.stop)

        return serving_phase(torch, start, reqs,
                             lambda t: t["input_ids"],
                             (base["num_classes"],), base["n_block"],
                             device=device, profile=profile)


def _ner_input(tensors):
    """The NER deployment's input_fn: a request's named tensors as the
    model's input dict (``launch()`` maps several tensors to a tuple)."""
    return {"input_ids": tensors["input_ids"],
            "attention_mask": tensors["attention_mask"]}


def profile_train_step(torch, est, x, y, iters=5,
                       kernel_groups=KERNEL_GROUPS):
    """Where one train step's time goes: host wall time per step and
    device time by kernel (torch.profiler over one step: tracing and
    summing a deep net's three took seconds), kernel rows only. Returns
    ``_print_rows``'s (wall ms, busy ms, {group: ms})."""
    from torch.profiler import ProfilerActivity, profile

    est._train_step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        est._train_step(x, y)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est._train_step(x, y)
        torch.cuda.synchronize()
    rows = (y[0] if isinstance(y, (tuple, list)) else y).shape[0]
    return _print_rows(prof, 1, wall, f"train step ({rows},)",
                       top=20, kernel_groups=kernel_groups)


GRAD_PARAMS = ("squad.bert.encoder_0.attention.qkv.weight",
               "squad.head.weight")


def step_grads(torch, module, xb, yb, impl, loss_fn, names):
    """(loss, {param: gradient}) of one step at ``module``'s weights with
    ``impl`` attention (``train=False``: hidden dropout off)."""
    from analytics_zoo_tpu_torch.common.config import get_config

    cfg = get_config()
    cfg.set("zoo.ops.attention_impl", impl)
    params = dict(module.named_parameters())
    module.zero_grad(set_to_none=True)
    loss = loss_fn(module(xb, train=False), yb)
    loss.backward()
    grads = {k: params[k].grad.float().clone() for k in names}
    module.zero_grad(set_to_none=True)
    cfg.set("zoo.ops.attention_impl", "flash")
    return float(loss.detach()), grads


def _rel(a, b, keys=None):
    """{param: ||a - b|| / ||b||} over ``keys`` (default: all of b's)."""
    return {k: float((a[k] - b[k]).norm() / b[k].norm())
            for k in (keys or b)}


def bf16_bound(einsum_vs_f32):
    """{param: the bound on flash_vs_f32} (see BF16_GRAD_RATIO)."""
    return {k: BF16_GRAD_RATIO * r + BF16_GRAD_SLACK
            for k, r in einsum_vs_f32.items()}


def grad_check(torch, module, xb, yb, ref, loss_fn, names, label):
    """One step's gradients with flash and with einsum attention at the
    same weights and batch, and each bf16 path's distance from ``ref``
    (loss, grads) of the same step in f32. Returns the relative errors
    ||g_a - g_b|| / ||g_b||, the bound on flash_vs_f32 and the
    flash/einsum loss gap."""
    loss_f, g_f = step_grads(torch, module, xb, yb, "flash", loss_fn, names)
    loss_e, g_e = step_grads(torch, module, xb, yb, "einsum", loss_fn, names)
    rel = {name: _rel(a, b) for name, a, b in (
        ("flash_vs_einsum", g_f, g_e), ("flash_vs_f32", g_f, ref[1]),
        ("einsum_vs_f32", g_e, ref[1]))}
    bound = bf16_bound(rel["einsum_vs_f32"])
    losses = {"flash": loss_f, "einsum": loss_e, "f32": ref[0]}
    print(f"{label}: gradients rel_err={rel} (flash_vs_f32 bound "
          f"{BF16_GRAD_RATIO} x einsum_vs_f32 + {BF16_GRAD_SLACK} = "
          f"{bound}); loss {losses} (tol {LOSS_TOL})", flush=True)
    return rel, bound, abs(loss_f - loss_e)


def fault_controls(torch, module, xb, yb, g_ref, tol, faults, loss_fn,
                   names, label):
    """The flash step again with the backward broken on purpose, each
    fault held against ``g_ref`` as the gradient check holds the sound
    step (f32: the einsum step's gradients, bf16: the f32 step's):
    "dq_zeroed", "dk_dv_swapped", or "mask_dropped" (K2 and K3 without
    the key-padding mask, K1-lse still masked). Returns each fault's
    relative error on the layer-0 qkv weight and fails unless each
    exceeds ``tol``, so that check is known to tell a broken backward
    from a sound one."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    bwd = fa.flash_attention_bwd
    # FlashAttention.backward passes every argument positionally: (q, k,
    # v, o, lse, do, causal, scale, key_padding_mask)
    broken = {
        "dq_zeroed": lambda *a: (lambda dq, dk, dv: (
            torch.zeros_like(dq), dk, dv))(*bwd(*a)),
        "dk_dv_swapped": lambda *a: (lambda dq, dk, dv: (dq, dv, dk))(
            *bwd(*a)),
        "mask_dropped": lambda *a: bwd(*a[:8])}
    qkv = names[:1]
    rel = {}
    try:
        for name in faults:
            fa.flash_attention_bwd = broken[name]
            _, g = step_grads(torch, module, xb, yb, "flash", loss_fn, names)
            rel[name] = _rel(g, g_ref, qkv)[qkv[0]]
    finally:
        fa.flash_attention_bwd = bwd
    print(f"{label}: planted faults, {qkv[0]} rel_err={rel} (each must "
          f"exceed {tol})", flush=True)
    for name, r in rel.items():
        if not r > tol:
            fail(f"the gradient check misses a planted fault ({name}): "
                 f"rel_err {r} <= {tol}")
    return rel


class _Logged(logging.Handler):
    """The losses the Estimator logs (step 1 and every
    ``zoo.train.log_every_n_steps``), as (step, loss)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.steps = []

    def emit(self, record):
        if record.msg.startswith("epoch %d step %d loss"):
            self.steps.append((record.args[1], record.args[2]))


def learn_phase(torch, build, base, x, y, batch, loss_fn, names, faults,
                masked=False, label="learn", save_to=None, device="cuda",
                profile=False, check_batch=None, infer=None,
                loss_falls=False):
    """The flash-vs-einsum gradient checks at the initial weights (f32,
    with its planted ``faults``, which it must reject, and bf16; where
    the batch carries an ``attention_mask``, both again without it) on
    the first ``check_batch`` samples (default ``batch``), then the fit
    on (``x``, ``y``: an id array, or a dict of arrays) through
    ``fit`` -> Estimator.fit (2 epochs, the second timed, the loss logged
    at each epoch's end), then ``infer(model, x, y, batch, label)`` on the
    trained model (default ``evaluate_predict``; it returns figures for
    the summary); saves the
    fitted model to ``save_to`` if given. ``build(**overrides)`` makes the
    model from ``base`` with seed 0: a ZooModel (``fit`` is
    ``ZooModel.fit``), or a bare module with its Estimator in a
    namespace of the same attributes and a ``name``. K1, K2 and K3 must
    each launch (with the mask, where ``masked``) at least once per layer
    a step, K1, K2 and K3 on the Hopper kernels exactly where
    ``_sm90_expected`` says; with ``loss_falls`` the last logged step's loss must be below
    the first's. Returns the fit's ``_launches``."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.learn.optim import param_tree
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    cfg = get_config()
    # the auto threshold (512) is the reference's TPU figure: at L <= 512
    # it would route around the kernels
    cfg.set("zoo.ops.attention_impl", "flash")
    cuda = device == "cuda"
    ids = x["input_ids"] if isinstance(x, dict) else x
    n, seq = ids.shape
    steps_per_epoch = n // batch
    check_batch = check_batch or batch
    grad = dict(loss_fn=loss_fn, names=names)

    def first(k):
        """The first ``k`` samples of ``x``, as tensors on the device."""
        def take(a):
            return torch.from_numpy(a[:k]).to(device)
        return ({key: take(a) for key, a in x.items()} if isinstance(x, dict)
                else take(x))

    # one step's gradients at the initial weights and the first batch,
    # hidden dropout off. In f32: flash (K1-lse, K2, K3) against einsum
    # attention, and the same with the backward broken on purpose
    xb = first(check_batch)
    yb = torch.from_numpy(y[:check_batch]).to(device)
    # the batches the checks run on: the first, and without its mask
    batches = {"": xb}
    if isinstance(xb, dict) and "attention_mask" in xb:
        batches[" unmasked"] = {k: t for k, t in xb.items()
                                if k != "attention_mask"}
    f32 = build(dtype="float32")
    refs, rel32 = {}, {}
    for tag, xc in batches.items():
        refs[tag] = step_grads(torch, f32.module, xc, yb, "einsum", **grad)
        _reset_launches(fa)
        rel32[tag] = _rel(step_grads(torch, f32.module, xc, yb, "flash",
                                     **grad)[1], refs[tag][1])
        if cuda:
            # the f32 step's K1-lse, K2 and K3 all on the f32 tensor-core
            # kernels; K2 and K3 once a layer
            counts = _launches(fa)
            want = _f32tc_expected(torch, fa, "float32", counts)
            print(_check_f32tc(f"{label}{tag} f32 check", counts, want),
                  flush=True)
            if min(counts["K2"][0], counts["K3"][0]) < base["n_block"]:
                fail(f"{label}{tag}: the f32 step launched K2 and K3 "
                     f"{counts['K2'][0]} and {counts['K3'][0]} times "
                     f"(< {base['n_block']} layers)")
            F32_CHECK_LAUNCHES[label + tag] = counts
        print(f"{label}{tag}: f32 gradients flash vs einsum rel_err="
              f"{rel32[tag]} (tol {F32_GRAD_TOL}; batch {check_batch})",
              flush=True)
        if not all(r <= F32_GRAD_TOL for r in rel32[tag].values()):
            fail(f"{label}{tag}: f32 gradients flash vs einsum differ: "
                 f"{rel32[tag]}")
    ref = refs[""]
    planted = {"f32": fault_controls(torch, f32.module, xb, yb, ref[1],
                                     F32_GRAD_TOL, faults, label=label,
                                     **grad)}
    del f32
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build()
    model_name = getattr(model, "name", type(model).__name__)
    print(f"{label}: {model_name} built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    rels, bounds, dlosses = {}, {}, {}
    for tag, xc in batches.items():
        rels[tag], bounds[tag], dlosses[tag] = grad_check(
            torch, model.module, xc, yb, refs[tag], label=label + tag,
            **grad)
        over = {k: r for k, r in rels[tag]["flash_vs_f32"].items()
                if not r <= bounds[tag][k]}
        if over:
            fail(f"{label}{tag}: bf16 gradients flash vs f32 {over} above "
                 f"the bound {bounds[tag]}")
        if not dlosses[tag] <= LOSS_TOL:
            fail(f"{label}{tag}: flash and einsum losses differ by "
                 f"{dlosses[tag]}")
    # the same faults must fail the bf16 bound on the layer-0 qkv weight
    planted["bf16"] = fault_controls(torch, model.module, xb, yb, ref[1],
                                     bounds[""][names[0]], faults,
                                     label=label, **grad)
    del xb, yb
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    logged = _Logged()
    est_logger = logging.getLogger("analytics_zoo_tpu_torch.learn.estimator")
    est_logger.addHandler(logged)
    cfg.set("zoo.train.log_every_n_steps", steps_per_epoch)
    _reset_launches(fa)
    # ---- main path: fit (ZooModel.fit) -> Estimator.fit ----
    t0 = time.perf_counter()
    try:
        hist = model.fit((x, y), batch_size=batch, epochs=2)
        if cuda:
            torch.cuda.synchronize()
    finally:
        est_logger.removeHandler(logged)
        cfg.unset("zoo.train.log_every_n_steps")
    fit_s = time.perf_counter() - t0
    launches = _launches(fa)
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated() if cuda else None
    est = model.estimator
    steps = est.global_step
    if steps != 2 * steps_per_epoch or len(hist) != 2:
        fail(f"{label}: fit ran {steps} steps in {len(hist)} epochs")
    losses = [h["loss"] for h in hist]
    # an epoch's loss is the mean of its steps' losses: finite means
    # every step's loss was finite
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite training loss: {losses}")
    if loss_falls and not logged.steps[-1][1] < logged.steps[0][1]:
        fail(f"{label}: the loss did not fall: logged {logged.steps}")
    need = base["n_block"] * steps if cuda else 0
    for kname, counts in launches.items():
        if counts[int(masked)] < need:
            fail(f"{label}: {kname} launched {counts[int(masked)]} times"
                 + (" with a mask" if masked else "")
                 + f" in {steps} train steps (< {need})")
    # K1-lse, K2 and K3 of every bf16 model on the Hopper kernels; f32
    # none (_sm90_expected)
    if cuda:
        print(_check_sm90(label, launches, _sm90_expected(
            torch, fa, base["dtype"], launches)), flush=True)
    timed = hist[1]["seconds"]
    sps = steps_per_epoch / timed
    # one epoch's real tokens (the mask's ones) and padded tokens
    real = (int(np.count_nonzero(x["attention_mask"]))
            if isinstance(x, dict) and "attention_mask" in x else n * seq)
    p_dense = sum(p.numel() for pname, p in param_tree(model.module).items()
                  if "embed" not in pname.lower())
    flops_per_token = (6 * p_dense
                       + 12 * base["n_block"] * base["hidden_size"] * seq)
    # bench.py's formula over every position the encoder computes
    # (padding included), as the kernels and GEMMs do the work for it
    mfu = sps * batch * seq * flops_per_token / BF16_PEAK

    inferred = (infer or evaluate_predict)(model, x, y, batch, label)
    if save_to is not None:
        model.save_model(save_to)
    summary = {
        "model": model_name, "config": base, "seq": seq, "batch": batch,
        "steps": steps, "losses": losses,
        "logged_step_losses": logged.steps, "fit_s": fit_s,
        "timed_epoch_s": timed, "steps_per_s": sps,
        "samples_per_s": sps * batch, "tokens_per_s": sps * batch * seq,
        "real_tokens_per_s": real / timed, "real_token_share": real / (n * seq),
        "dense_params": p_dense, "flops_per_token": flops_per_token,
        "mfu_bf16": mfu, "peak_mem_gib": peak / 2 ** 30 if cuda else None,
        **inferred,
        "launches": {k: {"all": a, "masked": mk, "small_d": sd, "wide_d": wd,
                         "sm90": h, "f32tc": tc}
                     for k, (a, mk, sd, wd, h, tc) in launches.items()},
        "check_batch": check_batch,
        "grad_rel_err": {tag.strip() or "batch": dict(
            rels[tag], f32_flash_vs_einsum=rel32[tag]) for tag in rels},
        "loss_flash_vs_einsum": {tag.strip() or "batch": dlosses[tag]
                                 for tag in dlosses},
        "planted_fault_rel_err": planted,
        "device": torch.cuda.get_device_name(0) if cuda else device}
    print(f"{label}: " + json.dumps(summary), flush=True)
    if profile:
        profile_train_step(torch, est, first(batch),
                           torch.from_numpy(y[:batch]).to(device))
    return launches


def evaluate_predict(model, x, y, batch, label):
    """``learn_phase``'s default ``infer``: evaluate and predict on the
    same Estimator over two batches; every output finite, of [m, seq]
    leading dims. Returns the eval loss and, for a model that has one,
    its token accuracy."""
    m = 2 * batch
    xe = {k: a[:m] for k, a in x.items()}
    ev = model.evaluate((xe, y[:m]), batch_size=batch)
    pred = model.predict(xe, batch_size=batch)
    if not np.isfinite(ev["loss"]):
        fail(f"{label} evaluate: non-finite loss {ev}")
    for t in pred if isinstance(pred, (tuple, list)) else (pred,):
        if t.shape[:2] != xe["input_ids"].shape or not np.isfinite(t).all():
            fail(f"{label} predict: bad output {t.shape}")
    acc = (model.token_accuracy(pred, y[:m])
           if hasattr(model, "token_accuracy") else None)
    return {"eval_loss": ev["loss"], "token_accuracy": acc}


def zoo_builder(cls, base, device):
    """``learn_phase``'s ``build`` for a ZooModel subclass: ``cls`` at
    ``base`` with overrides, seed 0."""
    return lambda **over: cls(device=device, seed=0, **dict(base, **over))


def squad_learn(torch, device="cuda", base=SQUAD_BASE, seq=TRAIN_SEQ,
                batch=TRAIN_BATCH, steps_per_epoch=TRAIN_STEPS,
                profile=False):
    """BERT-base BERTSQuAD on random ids and spans, no mask; planted
    faults: dQ zeroed, dK and dV swapped."""
    from analytics_zoo_tpu_torch.models.text.bert_squad import (
        BERTSQuAD, squad_span_loss)

    rng = np.random.RandomState(0)
    n = batch * steps_per_epoch
    x = {"input_ids": rng.randint(0, base["vocab"], (n, seq)
                                  ).astype(np.int32)}
    y = np.stack([rng.randint(0, seq, n), rng.randint(0, seq, n)],
                 axis=1).astype(np.int32)
    return learn_phase(torch, zoo_builder(BERTSQuAD, base, device), base, x,
                       y, batch, squad_span_loss, GRAD_PARAMS,
                       ("dq_zeroed", "dk_dv_swapped"), device=device,
                       profile=profile)


# MiniLM-L12-H384 (Wang et al. 2020, MiniLM: Deep Self-Attention
# Distillation; microsoft/MiniLM-L12-H384-uncased config.json): vocab
# 30522, hidden 384, 12 layers, 12 heads of 32, intermediate 1536, 512
# positions, in the repo's BERTSQuAD (bf16 encoder, f32 parameters and
# head, hidden dropout 0.1), seeded weights. Nothing is cut; batch 48 at
# seq 384 as the BERT-base fine-tune. Its head dim of 32 takes K5b both
# ways. The traffic is synthetic: real lengths uniform in [64, 384] (SQuAD
# contexts are padded to 384), spans inside the real part
MINILM = dict(vocab=30522, hidden_size=384, n_block=12, n_head=12,
              intermediate_size=1536, max_position_len=512,
              dtype="bfloat16")


def minilm_learn(torch, device="cuda", base=MINILM, seq=TRAIN_SEQ,
                 batch=TRAIN_BATCH, steps_per_epoch=TRAIN_STEPS,
                 profile=False):
    """BERTSQuAD at MiniLM-L12-H384's widths on padded batches, the
    gradient checks with the mask and without; planted faults: dQ
    zeroed, dK and dV swapped, the mask dropped from K2 and K3. Every
    K1, K2 and K3 launch of the fit must be a K5b one."""
    from analytics_zoo_tpu_torch.models.text.bert_squad import (
        BERTSQuAD, squad_span_loss)

    rng = np.random.RandomState(6)
    n = batch * steps_per_epoch
    mask = padding_mask(rng, n, seq, 64)
    lens = mask.sum(1)
    ids = rng.randint(1, base["vocab"], (n, seq)).astype(np.int32) * mask
    start = rng.randint(0, lens)
    end = np.minimum(start + rng.randint(0, 30, n), lens - 1)
    y = np.stack([start, end], axis=1).astype(np.int32)
    launches = learn_phase(
        torch, zoo_builder(BERTSQuAD, base, device), base,
        {"input_ids": ids, "attention_mask": mask},
        y, batch, squad_span_loss, GRAD_PARAMS,
        ("dq_zeroed", "dk_dv_swapped", "mask_dropped"), masked=True,
        label="learn-minilm", device=device, profile=profile)
    for kname, (total, _, small, *_) in launches.items():
        if device == "cuda" and small != total:
            fail(f"learn-minilm: {kname} counted {small} K5b launches of "
                 f"{total}")
    return launches


# BERT-base NER (Devlin et al. 2019, section 5.3, CoNLL-2003): the
# bert-base-cased configuration (vocab 28996), 9 BIO tags, sequences of
# 128 tokens, bf16 encoder, f32 head. Nothing is cut. The traffic is
# synthetic: real lengths uniform in [2, 128], about half the positions
# real. CoNLL-2003's published train split (14,041 sentences, 203,621
# tokens, 14.5 words a sentence) would leave far fewer real at 128
NER_BASE = dict(num_classes=9, vocab=28996, hidden_size=768, n_block=12,
                n_head=12, intermediate_size=3072, max_position_len=512,
                dtype="bfloat16")
NER_SEQ, NER_BATCH, NER_STEPS = 128, 32, 16
NER_GRAD_PARAMS = ("bert.encoder_0.attention.qkv.weight", "head.weight")


def ner_data(rng, n, seq, vocab, n_tags):
    """Synthetic NER traffic: random token ids with per-row real lengths
    uniform in [2, seq] (the first row full, the second of 2), their
    attention mask, and tags in [0, n_tags) on real tokens, -1
    (IGNORE_INDEX) on padding."""
    mask = padding_mask(rng, n, seq, 2)
    ids = rng.randint(1, vocab, (n, seq)).astype(np.int32) * mask
    tags = np.where(mask == 1, rng.randint(0, n_tags, (n, seq)), -1)
    return {"input_ids": ids, "attention_mask": mask}, tags.astype(np.int32)


def ner_learn(torch, save_to, device="cuda", base=NER_BASE, seq=NER_SEQ,
              batch=NER_BATCH, steps_per_epoch=NER_STEPS, profile=False):
    """BERT-base BERTNER on padded batches; planted fault: the mask
    dropped from K2 and K3. Saves the fitted model to ``save_to``."""
    from analytics_zoo_tpu_torch.models.text.bert_estimators import (
        BERTNER, token_cross_entropy)

    rng = np.random.RandomState(3)
    x, y = ner_data(rng, batch * steps_per_epoch, seq, base["vocab"],
                    base["num_classes"])
    return learn_phase(torch, zoo_builder(BERTNER, base, device), base, x, y,
                       batch, token_cross_entropy, NER_GRAD_PARAMS,
                       ("mask_dropped",), masked=True, label="learn-ner",
                       save_to=save_to, device=device, profile=profile)


def ner_serving(torch, path, device="cuda", n_requests=64, seq=NER_SEQ,
                batch=8, base=NER_BASE):
    """The saved NER model through InferenceModel -> ServingWorker on the
    memory queue with ``_ner_input``, every bucket warmed with a padded
    example, then ``n_requests`` padded requests."""
    from analytics_zoo_tpu_torch.inference.inference_model import (
        InferenceModel, bucket_ladder)
    from analytics_zoo_tpu_torch.serving.queues import (
        InputQueue, OutputQueue)
    from analytics_zoo_tpu_torch.serving.worker import ServingWorker

    rng = np.random.RandomState(4)
    x, _ = ner_data(rng, n_requests, seq, base["vocab"], base["num_classes"])
    reqs = {f"ner{i:03d}": {k: a[i] for k, a in x.items()}
            for i in range(n_requests)}

    def start():
        model = InferenceModel(device=device).load_zoo(path)
        in_q = InputQueue(backend="memory")
        out_q = OutputQueue(backend="memory")
        worker = ServingWorker(model, in_q, out_q, batch_size=batch,
                               input_fn=_ner_input)
        cap = getattr(worker.batcher, "max_batch_size",
                      worker.batcher.batch_size)
        # a padded example (the second request: 2 real tokens)
        model.warm_up({k: a[1:2] for k, a in x.items()},
                      batch_sizes=bucket_ladder(cap))
        worker.start()
        print(f"serve-ner: warmed buckets {bucket_ladder(cap)}", flush=True)
        return in_q, out_q, model, worker.batcher, worker.stop

    return serving_phase(torch, start, reqs, _ner_input,
                         (seq, base["num_classes"]), base["n_block"],
                         masked=True,
                         label="serve-ner", device=device)


# GPT-J-6B (EleutherAI/gpt-j-6b config.json: n_embd 4096, n_head 16, so
# heads of 256; n_inner null, so 4 * 4096 = 16384; n_positions 2048; vocab
# 50400; gelu_new, the tanh GELU; layer_norm_epsilon 1e-5; attn, resid and
# embd pdrop 0.0) in the port's TransformerModule, trained as a causal LM:
# bf16 blocks, f32 parameters and head, seeded weights, Adam at lr 1e-4.
# Cut: 8 of its 28 layers (Adam's f32 state over the 2.03 B parameters
# left is 32.5 GB). Departures from GPT-J: post-LN, attention then FFN
# (not side by side), learned positions (not rotary over 64 dims), biases
# on Q, K, V and the projection, an untied head with a bias. GPT-J's zero
# dropout keeps every attention call on the kernels (the reference's
# flash gate requires dropout_rate 0)
GPTJ = dict(vocab=50400, seq_len=2048, hidden_size=4096, n_head=16,
            n_block=8, intermediate_size=16384, hidden_dropout=0.0,
            attn_dropout=0.0, dtype="bfloat16")
# deepseek-ai/DeepSeek-V4-Flash's published hidden_size (4096) and
# head_dim (512) in the same TransformerModule, which ties the head dim
# to hidden / n_head, so 8 heads of 512; its vocab_size 129280; an MLP of
# 16384, as the DeepSeek-width generation phase has it. Cut: 4 of its 43
# layers; 8 query heads, not 64; K and V heads equal to the query heads,
# not one shared K=V head; no low-rank Q or grouped low-rank O, CSA/HCA,
# sliding window, mHC or MTP; a dense MLP of 16384 in place of its MoE;
# post-LN, learned positions (2048 of them) and biases, which are
# TransformerModule's. bf16 blocks, f32 parameters and an untied f32
# head: 1.87 B parameters. Every layer's attention runs K1-lse, K2 and K3
# at D = 512 (bf16 in the fit, f32 in the gradient check)
LM512 = dict(vocab=129280, seq_len=2048, hidden_size=4096, n_head=8,
             n_block=4, intermediate_size=16384, hidden_dropout=0.0,
             attn_dropout=0.0, dtype="bfloat16")
LM_BATCH, LM_STEPS = 4, 8
# the gradient checks' batch: f32 einsum attention at L = 2048 keeps
# [B, 16, 2048, 2048] f32 scores and probabilities for each layer's
# backward, about 1.5 GB a layer at B = 1 beside the f32 model's 16 GB of
# weights and gradients
LM_CHECK_BATCH = 1
LM_GRAD_PARAMS = ("lm.block_0.attention.qkv.weight", "head.weight")


def lm_data(rng, n, seq, vocab):
    """A learnable next-token stream (the rule of
    examples/moe/moe_transformer.py ``lm_data``): a random first token,
    then each even token followed by token + 1 and each odd one by
    token - 1 (mod vocab); labels are the ids shifted left by one (the
    last wraps round to the first). Returns int32 (ids, labels)."""
    x = np.zeros((n, seq), np.int32)
    x[:, 0] = rng.randint(0, vocab, n)
    for t in range(1, seq):
        prev = x[:, t - 1]
        x[:, t] = np.where(prev % 2 == 0, prev + 1, prev - 1) % vocab
    return x, np.roll(x, -1, axis=1)


def causal_lm(torch, cfg):
    """The port's ``TransformerModule(**cfg)`` (``dtype`` a name or a
    torch dtype) with an untied ``Dense(vocab)`` head, logits as
    ``[B * L, vocab]`` for ``sparse_categorical_crossentropy``. The head
    has no dtype, so beside bf16 blocks it computes in f32, as flax's
    Dense does. The JAX package has no LM head of its own, so the port's
    package has none either; tests/test_torch_port_wide_bwd.py writes this
    wrapper in flax."""
    from analytics_zoo_tpu_torch.keras.layers.transformer import (
        Dense, TransformerModule)

    dt = cfg.get("dtype")
    cfg = dict(cfg, dtype=getattr(torch, dt) if isinstance(dt, str) else dt)

    class CausalLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm = TransformerModule(**cfg)
            self.head = Dense(cfg["hidden_size"], cfg["vocab"])

        def forward(self, ids, train=False, rng=None):
            logits = self.head(self.lm(ids, train=train, rng=rng))
            return logits.reshape(-1, logits.shape[-1])

    return CausalLM()


def lm_learn(torch, device="cuda", base=GPTJ, batch=LM_BATCH,
             steps_per_epoch=LM_STEPS, profile=False, label="learn-lm"):
    """``causal_lm`` at ``base`` (GPT-J-6B's widths, or ``LM512``)
    trained through ``Estimator(module,
    loss="sparse_categorical_crossentropy", optimizer=Adam).fit`` on
    ``lm_data``; gradient checks at ``LM_CHECK_BATCH``; planted faults: dQ
    zeroed, dK and dV swapped. The loss must fall, and K1 (with
    logsumexp), K2 and K3 must each launch once a layer a step of the
    fit, every launch a wide one (the model's one head dim, hidden /
    n_head: 256 or 512)."""
    from types import SimpleNamespace

    from analytics_zoo_tpu_torch.keras.layers.transformer import (
        reset_parameters)
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    from analytics_zoo_tpu_torch.learn.objectives import (
        sparse_categorical_crossentropy)
    from analytics_zoo_tpu_torch.learn.optim import Adam

    x, y = lm_data(np.random.RandomState(9), batch * steps_per_epoch,
                   base["seq_len"], base["vocab"])

    def build(**over):
        # the weights are drawn on the card from the seed: a CPU
        # generator would take minutes over 2 B parameters
        with torch.device(device):
            module = causal_lm(torch, dict(base, **over))
        reset_parameters(module, 0)
        est = Estimator(module, loss="sparse_categorical_crossentropy",
                        optimizer=Adam(lr=1e-4), seed=0, device=device)
        return SimpleNamespace(name="CausalLM", module=module, estimator=est,
                               fit=est.fit)

    def infer(model, x, y, batch, label):
        """One forward of the trained model over the first batch:
        finite [B * L, vocab] logits, and their loss. (Estimator.predict
        would cut those logits to B rows, and its Loss metric takes one
        sample's outputs a row.)"""
        with torch.no_grad():
            logits = model.module(torch.from_numpy(x[:batch]).to(device))
        if (tuple(logits.shape) != (x[:batch].size, base["vocab"])
                or not torch.isfinite(logits).all()):
            fail(f"{label}: bad logits {tuple(logits.shape)}")
        return {"trained_batch_loss": float(sparse_categorical_crossentropy(
            logits, torch.from_numpy(y[:batch]).to(device)))}

    launches = learn_phase(
        torch, build, base, x, y, batch, sparse_categorical_crossentropy,
        LM_GRAD_PARAMS, ("dq_zeroed", "dk_dv_swapped"), label=label,
        device=device, profile=profile, check_batch=LM_CHECK_BATCH,
        infer=infer, loss_falls=True)
    head_dim = base["hidden_size"] // base["n_head"]
    want = base["n_block"] * 2 * steps_per_epoch
    for kname, (total, _, _, wide, *_) in launches.items():
        if device == "cuda" and not wide == total == want:
            fail(f"{label}: {kname} launched {total} times, {wide} of them "
                 f"wide (want {want}, every one at D = {head_dim})")
    # the bf16 blocks' K1-lse, K2 and K3, at 256 and at 512, on the
    # Hopper kernels
    for kname, counts in launches.items():
        if device == "cuda" and counts[4] != want:
            fail(f"{label}: {counts[4]} of {kname}'s {want} launches on "
                 f"the Hopper kernels")
    return launches


# TinyGenLM geometries served through launch() with a generation: block.
# "repo": the launcher's documented default (scripts/perf_generation.py's
# model, GEN_r01.json's traffic shape). "full": Phi-2's published widths
# (microsoft/phi-2 config.json: hidden 2560, 32 heads of 80, 32 layers,
# intermediate 10240, vocab 51200, 2048 positions) in TinyGenLM's own
# block (pre-LN, learned positions, ReLU, no biases), f32, seeded weights
GEN_REPO = {"model": dict(vocab=64, dim=32, heads=2, head_dim=16, layers=2,
                          max_len=256, mlp_ratio=2, seed=0),
            "slots": 8, "page_size": 16, "max_len": 256}
GEN_FULL = {"model": dict(vocab=51200, dim=2560, heads=32, head_dim=80,
                          layers=32, max_len=2048, mlp_ratio=4, seed=0),
            "slots": 8, "page_size": 16, "max_len": 2048}
# google/gemma-2b's published widths (config.json: hidden 2048, 8 heads
# of 256, 18 layers, intermediate 16384, vocab 256000, 8192 positions) in
# TinyGenLM's block (pre-LN LayerNorm, learned positions, ReLU, no
# biases, untied head, 8 KV heads -- not Gemma's RMSNorm, RoPE, GeGLU,
# tied head and one KV head), f32, seeded weights: K1 at D = 256
GEN_GEMMA = {"model": dict(vocab=256000, dim=2048, heads=8, head_dim=256,
                           layers=18, max_len=8192, mlp_ratio=8, seed=0),
             "slots": 8, "page_size": 16, "max_len": 8192}
# deepseek-ai/DeepSeek-V4-Flash's published attention widths (config.json:
# hidden_size 4096, num_attention_heads 64, head_dim 512, vocab_size
# 129280) in TinyGenLM's block, f32, seeded weights: K1 at D = 512. Cut:
# 4 of its 43 layers, 2048 of its 1,048,576 positions, 64 K/V heads in
# place of its one shared K=V head (TinyGenLM takes one H for Q, K and
# V), a dense ReLU MLP at ratio 4 (16384) in place of its MoE (6 of 256
# routed experts of 2048 and 1 shared: 14,336 active columns), and none
# of its low-rank Q and O, compressed or sparse attention, sliding
# window, mHC residual streams or MTP. The KV pool holds 1024 pages of 16
# (8 slots at the full 2048), 17.18 GB
GEN_DEEPSEEK = {"model": dict(vocab=129280, dim=4096, heads=64,
                              head_dim=512, layers=4, max_len=2048,
                              mlp_ratio=4, seed=0),
                "slots": 8, "page_size": 16, "num_pages": 1024,
                "max_len": 2048}
# a full-width divergence from the reference at a top-1 - top-2 logit gap
# below this is an f32 tie (the logits spread about 50)
TIE_GAP = 1e-3


@contextlib.contextmanager
def device_draws(torch):
    """``TinyGenLM.init_params`` with its seeded normal draws made on the
    card by a ``torch.Generator`` there, while the context lasts: the
    same parameter tree, shapes and scales as the port's (checked on a
    small geometry against the original first), other numbers. Drawn
    with numpy on the host, the full-width geometries' billions of
    weights took minutes. Every check of a generation phase compares the
    port with its own plain paths on the same parameters, so the draws'
    source does not change what they show."""
    from analytics_zoo_tpu_torch.serving.generation.model import (
        GenModelConfig, TinyGenLM)

    host = TinyGenLM.init_params

    def init_params(self, pos_len=None, device=None):
        c = self.config
        device = torch.device(device or "cuda")
        gen = torch.Generator(device=device)
        gen.manual_seed(c.seed)

        def mat(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
            return torch.empty(shape, device=device).normal_(
                0.0, scale, generator=gen)

        def full(value):
            return torch.full((c.dim,), value, dtype=torch.float32,
                              device=device)

        inner = c.heads * c.head_dim
        return {
            "blocks": [{
                "ln1_s": full(1.0), "ln1_b": full(0.0),
                "wq": mat(c.dim, inner), "wk": mat(c.dim, inner),
                "wv": mat(c.dim, inner), "wo": mat(inner, c.dim),
                "ln2_s": full(1.0), "ln2_b": full(0.0),
                "w1": mat(c.dim, c.dim * c.mlp_ratio),
                "w2": mat(c.dim * c.mlp_ratio, c.dim),
            } for _ in range(c.layers)],
            "embed": mat(c.vocab, c.dim, scale=1.0),
            "pos": mat(int(pos_len or c.max_len), c.dim, scale=1.0),
            "lnf_s": full(1.0), "lnf_b": full(0.0),
            "head": mat(c.dim, c.vocab, scale=1.0)}

    def layout(tree):
        return {k: (layout(v) if isinstance(v, dict) else
                    [layout(b) for b in v] if isinstance(v, list) else
                    tuple(v.shape)) for k, v in tree.items()}

    small = TinyGenLM(GenModelConfig(**GEN_REPO["model"]))
    if layout(init_params(small, 48)) != layout(host(small, 48, "cuda")):
        fail("device_draws: the parameter tree differs from TinyGenLM's")
    TinyGenLM.init_params = init_params
    try:
        yield
    finally:
        TinyGenLM.init_params = host


def _hist(name):
    """{label value: (count, sum)} of a registry histogram's series."""
    from analytics_zoo_tpu_torch.obs.metrics import get_registry

    values = get_registry().snapshot(with_buckets=False)[name]["values"]
    return {label.partition("=")[2]: (v["count"], v["sum"])
            for label, v in values.items()}


def _gen_reference_check(torch, engine, prompts, streams, n_check,
                         n_tokens, tie_gap, label):
    """Streams against the port's cache-free ``reference_generate`` (the
    first ``n_tokens`` of the first ``n_check`` requests). A divergence
    prints the reference's top-1 - top-2 logit gap at that step; with
    ``tie_gap`` a gap below it is reported as an f32 tie and that
    stream's comparison stops there; any other divergence fails.
    Returns (tokens compared, ties)."""
    model, params = engine.model, engine.params
    compared, ties = 0, []
    for uri in sorted(prompts)[:n_check]:
        ref = [int(t) for t in model.reference_generate(
            params, prompts[uri], n_tokens)]
        got = streams[uri]["toks"][:n_tokens]
        i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                 None)
        compared += len(got) if i is None else i
        if i is None:
            continue
        with torch.inference_mode():
            prefix = np.concatenate([prompts[uri], ref[:i]]).astype(np.int64)
            logits, _, _ = model.prefill(params, torch.as_tensor(
                prefix[None], device=engine.device))
            top = torch.topk(logits[0, -1].float(), 2).values
            gap = float(top[0] - top[1])
        print(f"{label}: {uri} diverges from the reference at token {i} "
              f"(served {got[i]}, reference {ref[i]}); the reference's "
              f"top-1 - top-2 logit gap there is {gap:.3g}", flush=True)
        if tie_gap is None or not gap < tie_gap:
            fail(f"{label}: {uri} is not token-exact against "
                 f"reference_generate (gap {gap} at token {i})")
        ties.append({"uri": uri, "token": i, "gap": gap})
    return compared, ties


def _drive_queue(app, prompts, max_tokens, slots, label):
    """The generate requests through ``app.gen_input_queue``, at most
    ``slots`` outstanding, chunks read from ``app.output_queue``.
    Returns ({uri: {"toks", "seqs", "t", "terminal", "reason"}}, {uri:
    send time})."""
    streams = {u: {"toks": [], "seqs": [], "t": [], "terminal": 0}
               for u in prompts}
    order, sent, finished = sorted(prompts), {}, 0
    deadline = time.perf_counter() + 900
    while finished < len(prompts):
        while len(sent) < len(prompts) and len(sent) - finished < slots:
            uri = order[len(sent)]
            sent[uri] = time.perf_counter()
            if not app.gen_input_queue.enqueue_generation(
                    uri, prompts[uri], max_tokens=max_tokens):
                fail(f"{label}: enqueue refused {uri}")
        item = app.output_queue.dequeue(timeout=1.0)
        if time.perf_counter() > deadline:
            fail(f"{label}: {finished}/{len(prompts)} streams finished in "
                 "900 s")
        if item is None:
            continue
        now = time.perf_counter()
        uri, tensors = item
        rec = streams.get(uri)
        if rec is None:
            fail(f"{label}: a chunk for an unknown stream {uri}")
        if "__error__" in tensors:
            fail(f"{label} {uri}: error terminal "
                 f"{np.asarray(tensors['__error__'])}")
        rec["seqs"].append(int(np.asarray(tensors["__stream__"])))
        rec["t"].append(now)
        rec["toks"].extend(int(t) for t in np.asarray(
            tensors.get("token", np.zeros(0, np.int32))).reshape(-1))
        if "finish_reason" in tensors:
            rec["terminal"] += 1
            rec["reason"] = str(np.asarray(tensors["finish_reason"]))
            finished += 1
    return streams, sent


def _sse_stream(address, prompt, max_tokens, label):
    """One ``POST /generate`` read as its SSE stream: every event must be
    one ``data: <json>`` line and a blank line, the first the meta event
    ({"uri"}), no event an error. Returns (send time, the stream's
    record as ``_drive_queue`` makes it)."""
    import urllib.request

    req = urllib.request.Request(
        address + "/generate", data=json.dumps(
            {"prompt": [int(t) for t in prompt],
             "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    rec = {"toks": [], "seqs": [], "t": [], "terminal": 0, "events": 0}
    t_sent = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        if (resp.status != 200
                or resp.headers["Content-Type"] != "text/event-stream"):
            fail(f"{label}: /generate answered {resp.status} "
                 f"{resp.headers['Content-Type']}")
        while True:
            line = resp.readline()
            if not line:
                break
            now = time.perf_counter()
            if not line.startswith(b"data: ") or not line.endswith(b"\n"):
                fail(f"{label}: not an SSE data line: {line[:200]!r}")
            if resp.readline() != b"\n":
                fail(f"{label}: an SSE event not ended by a blank line")
            ev = json.loads(line[len(b"data: "):])
            rec["events"] += 1
            if "error" in ev:
                fail(f"{label}: an error event reached the client: {ev}")
            if rec["events"] == 1:
                if set(ev) - {"uri", "trace_id"} or "uri" not in ev:
                    fail(f"{label}: the first event is not the meta event: "
                         f"{ev}")
                continue
            rec["seqs"].append(ev["seq"])
            rec["t"].append(now)
            rec["toks"].extend(ev.get("token", ()))
            if "finish_reason" in ev:
                rec["terminal"] += 1
                rec["reason"] = ev["finish_reason"]
    return t_sent, rec


def _drive_http(app, prompts, max_tokens, slots, label):
    """The generate requests as ``POST /generate`` SSE streams from
    ``slots`` client threads (at most ``slots`` outstanding), with ``GET
    /metrics`` and ``/healthz`` asked every second meanwhile; each must
    answer 200. Returns what ``_drive_queue`` does."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def get(route):
        with urllib.request.urlopen(app.address + route, timeout=60) as r:
            r.read()
            return r.status

    polled = []
    with ThreadPoolExecutor(max_workers=slots) as pool:
        futures = {u: pool.submit(_sse_stream, app.address, prompts[u],
                                  max_tokens, f"{label} {u}")
                   for u in sorted(prompts)}
        deadline = time.perf_counter() + 900
        while not all(f.done() for f in futures.values()):
            if time.perf_counter() > deadline:
                fail(f"{label}: the streams did not finish in 900 s")
            polled += [(route, get(route)) for route in ("/metrics",
                                                         "/healthz")]
            time.sleep(1.0)
        done = {u: f.result() for u, f in futures.items()}
    bad = [p for p in polled if p[1] != 200]
    if not polled or bad:
        fail(f"{label}: /metrics and /healthz during the run: {bad or 'none'}")
    print(f"{label}: /metrics and /healthz answered 200 to all "
          f"{len(polled)} polls during the burst", flush=True)
    return ({u: rec for u, (_, rec) in done.items()},
            {u: t for u, (t, _) in done.items()})


def generation_phase(torch, label, block, n_requests, prompt_lens,
                     max_tokens, n_check, check_tokens, tie_gap=None,
                     seed=0, http=False, n_logits=0, on_card=False):
    """``n_requests`` synthetic generate requests (prompt lengths uniform
    in ``prompt_lens``, tokens uniform over the vocabulary,
    ``__max_tokens__`` ``max_tokens``) through the port's launch() with
    ``block`` as its generation: block -> GenerationWorker ->
    DecodeEngine -> PagedKVCache -> TinyGenLM, at most ``slots`` streams
    outstanding (a bounded admission window, as
    scripts/perf_generation.py drives the JAX package): on the memory
    queue with ``http: {enabled: false}``, or with ``http`` from a stock
    config (no http: block) as ``POST /generate`` SSE streams through
    the HTTP frontend (``_drive_http``). Checks that every stream gets
    contiguous chunks and one terminal chunk with in-range tokens, that
    the prefill's flash kernel (K5b at a head dim up to 128, counted in
    ``small_d_launches``; K1 above 128 in ``wide_d_launches``) launched once a layer for every
    prefill in a bucket of 128 tokens or more (warm-up included) and no
    other flash launch ran, ``n_logits`` prompts' logits against the
    plain full forward (``_logits_check``), and the streams against
    reference_generate. Then profiles the decode step with all slots
    live at the longest prompts. ``on_card`` draws the seeded weights on
    the card (``device_draws``). Returns the summary."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.serving.generation import prefill_ladder
    from analytics_zoo_tpu_torch.serving.launcher import launch

    get_config().set("zoo.ops.attention_impl", "flash")
    m = block["model"]
    slots, layers = block["slots"], m["layers"]
    rng = np.random.RandomState(seed)
    prompts = {f"{label}{i:03d}": rng.randint(
        0, m["vocab"], rng.randint(prompt_lens[0], prompt_lens[1] + 1)
    ).astype(np.int32) for i in range(n_requests)}
    ladder = prefill_ladder(block["page_size"], block["max_len"])
    bucket = {u: next(b for b in ladder if b >= len(p))
              for u, p in prompts.items()}
    counter = ("wide_d_launches" if m["head_dim"] > 128
               else "small_d_launches")
    want = layers * (sum(b >= 128 for b in ladder)
                     + sum(b >= 128 for b in bucket.values()))
    prefill0, step0 = (_hist("zoo_generation_prefill_duration_seconds"),
                       _hist("zoo_generation_decode_step_duration_seconds"))
    config = ({"generation": block} if http
              else {"generation": block, "http": {"enabled": False}})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    # ---- main path: launch() (-> HttpFrontend) -> GenerationWorker ->
    # DecodeEngine -> PagedKVCache -> TinyGenLM (prefill through K5b, or
    # K1 above 128) ----
    t0 = time.perf_counter()
    with (device_draws(torch) if on_card else contextlib.nullcontext()):
        app = launch(config)
    up_s = time.perf_counter() - t0
    print(f"{label}: up in {up_s:.1f}s (seeded weights, warm-up of "
          f"buckets {ladder})"
          + (f", serving at {app.address}" if http else ""), flush=True)
    try:
        engine = app.gen_worker.engine
        t_start = time.perf_counter()
        streams, sent = (_drive_http if http else _drive_queue)(
            app, prompts, max_tokens, slots, label)
        wall = time.perf_counter() - t_start
        torch.cuda.synchronize()
        launched = getattr(fa.flash_attention, counter)
        other = fa.flash_attention.launches - launched
        f32tc = fa.flash_attention.f32tc_launches
        # ---- end of the main path ----
        peak = torch.cuda.max_memory_allocated()
        prefill1, step1 = (
            _hist("zoo_generation_prefill_duration_seconds"),
            _hist("zoo_generation_decode_step_duration_seconds"))
        if not app.drain(deadline_ms=60000):
            fail(f"{label}: the generation worker did not drain")
        if not http:
            time.sleep(0.2)
            extra = app.output_queue.dequeue(timeout=0.5)
            if extra is not None:
                fail(f"{label}: a chunk after every stream ended: "
                     f"{extra[0]}")
        for uri, rec in streams.items():
            if rec["terminal"] != 1 or rec["reason"] != "length":
                fail(f"{label} {uri}: {rec['terminal']} terminal chunks "
                     f"({rec.get('reason')})")
            if rec["seqs"] != list(range(len(rec["seqs"]))):
                fail(f"{label} {uri}: chunk numbers {rec['seqs']}")
            if len(rec["toks"]) != max_tokens or not all(
                    0 <= t < m["vocab"] for t in rec["toks"]):
                fail(f"{label} {uri}: tokens {rec['toks']}")
        if launched != want or other:
            fail(f"{label}: the prefill's flash kernel launched {launched} "
                 f"times in {counter} (want {layers} layers x "
                 f"{want // layers} prefills in buckets >= 128, warm-up "
                 f"included), {other} other flash launches")
        # TinyGenLM is f32: every prefill on K1's f32 tensor-core kernel
        tc_want = launched * _k1_kernels(fa, torch.float32)[1]
        if f32tc != tc_want:
            fail(f"{label}: {f32tc} of the prefill's {launched} flash "
                 f"launches on flash_attn_fwd_f32tc.cu (want {tc_want})")
        logits = (_logits_check(torch, engine, prompts, n_logits,
                                check_tokens, label) if n_logits else None)
        compared, ties = _gen_reference_check(
            torch, engine, prompts, streams, n_check, check_tokens, tie_gap,
            label)
        print(f"{label}: {compared} tokens of {min(n_check, n_requests)} "
              f"streams token-exact against reference_generate"
              + (f", {len(ties)} f32 ties" if ties else ""), flush=True)
        step_wall, step_device, gather_share = _profile_decode(
            torch, engine, prompts, label)
    finally:
        app.stop()
    ttft = [(r["t"][0] - sent[u]) * 1e3 for u, r in streams.items()]
    gaps = [g * 1e3 for r in streams.values() for g in np.diff(r["t"])]
    by_bucket = {}
    for key, (count, total) in prefill1.items():
        c0, s0 = prefill0.get(key, (0, 0.0))
        if count > c0:
            by_bucket[key] = {"prefills": count - c0,
                              "mean_ms": (total - s0) / (count - c0) * 1e3}
    steps = step1[""][0] - step0.get("", (0, 0.0))[0]
    summary = {
        "requests": n_requests, "prompt_lens": list(prompt_lens),
        "max_tokens": max_tokens, "slots": slots, "layers": layers,
        "traffic": "synthetic", "client": "http" if http else "queue",
        "up_s": up_s, "wall_s": wall,
        "tokens": n_requests * max_tokens,
        "tokens_per_s": n_requests * max_tokens / wall,
        "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                    "p99": float(np.percentile(ttft, 99))},
        "inter_token_ms": {"p50": float(np.percentile(gaps, 50)),
                           "p99": float(np.percentile(gaps, 99))},
        "decode_steps": steps,
        "decode_step_wall_ms": (step1[""][1] - step0.get("", (0, 0.0))[1])
        / max(steps, 1) * 1e3,
        "decode_step_full_wall_ms": step_wall,
        "decode_step_full_device_ms": step_device,
        "decode_gather_share": gather_share,
        "prefill_ms_by_bucket": by_bucket,
        "flash_counter": counter, "flash_launches": launched,
        "flash_launches_wanted": want, "flash_f32tc_launches": f32tc,
        "exact_tokens_compared": compared, "f32_ties": ties,
        "logits_check": logits,
        "kv_pool_bytes": engine.cache.stats()["bytes"],
        "peak_mem_gib": peak / 2 ** 30,
        "device": torch.cuda.get_device_name(0)}
    print(f"{label}: " + json.dumps(summary), flush=True)
    return summary


# The DeepSeek-width phase's logits against the plain full forward: the
# largest |served - plain| of a row, as a share of the row's largest
# |plain logit|. f32 on both sides (the served path through K1, the paged
# pool and the decode step; the plain one through the einsum path over
# the whole sequence), so the two differ by the order of f32 sums, which
# 4 layers leave far below this. Rounding the plain logits to bf16 alone
# moves the row's top logit by up to 2^-9 (1.95e-3) of itself, so a bf16
# result fails this bound nearly 20 times over (and the check proves it
# on its own rows).
LOGIT_TOL = 1e-4


def _logits_check(torch, engine, prompts, n_check, n_steps, label):
    """The first ``n_check`` prompts (after the burst, the worker
    drained) through the engine's own prefill and ``n_steps`` decode
    steps, their logits taken from the model's calls; each prompt's plain
    full forward over the prompt and the tokens the engine chose (f32,
    einsum attention, no cache) gives the rows they must match within
    ``LOGIT_TOL``. Fails unless the same rows rounded to bf16 fail it.
    Returns the largest share and the bf16 control's."""
    from analytics_zoo_tpu_torch.common.config import get_config

    model, params = engine.model, engine.params
    uris = sorted(prompts)[:n_check]
    row, pre, steps = [0], [], []
    real_prefill, real_step = model.prefill, model.decode_step

    def prefill(p, tokens):
        out = real_prefill(p, tokens)
        pre.append(out[0][0, row[0]].float().clone())
        return out

    def decode_step(*args):
        steps.append(real_step(*args).float().clone())
        return steps[-1]

    model.prefill, model.decode_step = prefill, decode_step
    slots, toks = {}, {}
    try:
        for u in uris:
            row[0] = len(prompts[u]) - 1
            slots[u], tok0 = engine.admit(prompts[u], n_steps + 1)
            toks[u] = [tok0]
        for _ in range(n_steps):
            out = dict(engine.step())
            for u in uris:
                toks[u].append(out[slots[u]])
    finally:
        del model.prefill, model.decode_step
        for s in slots.values():
            engine.release(s)
    worst = control = 0.0
    get_config().set("zoo.ops.attention_impl", "einsum")
    try:
        for i, u in enumerate(uris):
            seq = np.concatenate([prompts[u], toks[u][:n_steps]])
            with torch.inference_mode():
                plain, _, _ = model.prefill(params, torch.as_tensor(
                    seq.astype(np.int64)[None], device=engine.device))
            lp = len(prompts[u])
            want = plain[0, lp - 1:lp + n_steps].float()
            got = torch.stack([pre[i]] + [s[slots[u]] for s in steps])
            scale = want.abs().amax(-1)
            share = ((got - want).abs().amax(-1) / scale).max().item()
            bf16 = ((want.bfloat16().float() - want).abs().amax(-1)
                    / scale).max().item()
            worst, control = max(worst, share), max(control, bf16)
            del plain, want, got
    finally:
        get_config().set("zoo.ops.attention_impl", "flash")
    print(f"{label}: logits of {len(uris)} prompts x (prefill + {n_steps} "
          f"decode steps) against the plain full forward: largest error "
          f"{worst:.3g} of the row's largest |logit| (limit {LOGIT_TOL}); "
          f"the same rows rounded to bf16: {control:.3g}", flush=True)
    if not worst <= LOGIT_TOL:
        fail(f"{label}: logits {worst} of the row's largest |logit| from "
             f"the plain full forward (limit {LOGIT_TOL})")
    if not control > LOGIT_TOL:
        fail(f"{label}: bf16 rounding of the plain logits passes the "
             f"logits check ({control} <= {LOGIT_TOL}): the bound is loose")
    return {"max_share": worst, "bf16_control_share": control,
            "tol": LOGIT_TOL, "prompts": len(uris), "steps": n_steps}


def _profile_decode(torch, engine, prompts, label, iters=5):
    """The decode step with every slot live (the longest prompts, a
    budget that outlasts the window): host wall per step, device time by
    kernel (torch.profiler), and the share of device time in the index
    kernels that gather each slot's whole context from the pool."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    longest = sorted(prompts.values(), key=len)[-engine.num_slots:]
    budget = 2 * iters + 4
    slots = [engine.admit(p[:engine.max_len - budget], budget)[0]
             for p in longest]
    try:
        engine.step()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.step()
        wall = (time.perf_counter() - t0) / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                engine.step()
    finally:
        for s in slots:
            engine.release(s)
    _print_rows(prof, iters, wall, f"{label} decode step, "
                f"{engine.num_slots} live slots")
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t in rows)
    gather = sum(t for k, t in rows if "index" in k or "gather" in k)
    return wall * 1e3, busy / (iters * 1e3), gather / max(busy, 1e-9)


# ----------------------------------------------- NCF and ResNet (bench) --
# bench.py's configurations: NCF at MovieLens-1M's counts (:43-45, :97),
# ResNet-50 bf16 on synthetic ImageNet shapes (:59-62, :180), ResNet-18
# bf16 served on uint8 images (:213-253)
NCF_USERS, NCF_ITEMS, NCF_CLASSES = 6040, 3706, 5
NCF_BATCH, NCF_EPOCHS = 65536, 5
RESNET_BATCH, RESNET_STEPS, RESNET_EPOCHS = 256, 8, 5
IMAGE_SIZE = 224
# ResNet-50's forward at 224 x 224 (MAC = 2 FLOPs), 3x for a train step
RESNET50_TRAIN_FLOPS = 3 * 4.1e9
IMAGE_SERVING_BATCH, IMAGE_SERVING_DEPTH = 128, 3
IMAGE_SERVING_REQUESTS = 512
# served bf16 logits against an eval-mode forward of the same model
IMAGE_SERVE_TOL = 2e-2
# the card against the CPU: f32, TF32 off, the same seeded weights
CARD_CPU_TOL = 1e-4
# a ResNet train step's kernels by group (the first group a kernel's
# name matches): cuDNN runs 1x1 convolutions as GEMMs (nvjet, cutlass),
# so the convolution group holds those and the head's product; the
# BatchNorm group holds its statistics' reductions
RESNET_GROUPS = (
    ("convolution", ("xmma", "implicit_gemm", "conv", "dgrad", "wgrad",
                     "fprop", "cudnn", "nvjet", "gemm", "cutlass",
                     "Kernel2")),
    ("batch norm", ("batch_norm", "reduce_kernel")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
    ("pooling", ("max_pool", "avg_pool")),
    ("elementwise", ("elementwise_kernel",)),
)


def _epoch_rates(history, samples):
    """bench.py's rates: ``samples`` an epoch over the best and the
    median of the epochs after the first."""
    secs = sorted(h["seconds"] for h in (history[1:] or history))
    return samples / secs[0], samples / secs[len(secs) // 2]


def _dense_params(module) -> int:
    """bench.py's ``_dense_params``: parameters whose path holds no
    "embed" (embedding tables are gathers, not products)."""
    from analytics_zoo_tpu_torch.learn.optim import param_tree

    return sum(p.numel() for k, p in param_tree(module).items()
               if "embed" not in k.lower())


def _finite_losses(history, label):
    losses = [h["loss"] for h in history]
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite epoch loss {losses}")
    return losses


def ncf_learn(torch, card, peaks):
    """bench.py's measure_ncf on the card: NeuralCF at MovieLens-1M's
    counts through ZooModel.fit(device_cache=True), 65536 x 64 seeded
    pairs, 5 epochs; then one profiled train step (device time by
    group, idle share)."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.models import NeuralCF

    # every log line is a host sync, as in the bench
    get_config().set("zoo.train.log_every_n_steps", 100000)
    rng = np.random.RandomState(0)
    n = NCF_BATCH * 64
    x = np.stack([rng.randint(1, NCF_USERS + 1, n),
                  rng.randint(1, NCF_ITEMS + 1, n)], axis=1).astype(np.int32)
    y = rng.randint(1, NCF_CLASSES + 1, n).astype(np.int32)
    model = NeuralCF(NCF_USERS, NCF_ITEMS, class_num=NCF_CLASSES,
                     device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    # ---- main path: ZooModel.fit -> Estimator._fit_device_cached ----
    history = model.fit((x, y), batch_size=NCF_BATCH, epochs=NCF_EPOCHS,
                        device_cache=True)
    torch.cuda.synchronize()
    # ---- end of the main path ----
    losses = _finite_losses(history, "ncf")
    best, median = _epoch_rates(history, (n // NCF_BATCH) * NCF_BATCH)
    p_dense = _dense_params(model.module)
    flops = 6 * p_dense
    summary = {
        "samples_per_s": best, "median_samples_per_s": median,
        "mfu": best * flops / peaks["bf16"],
        "median_mfu": median * flops / peaks["bf16"],
        "p_dense": p_dense, "steps_per_epoch": n // NCF_BATCH,
        "epoch_seconds": [h["seconds"] for h in history],
        "losses": losses,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": card}
    print(f"ncf fit: {json.dumps(summary)}", flush=True)
    xb = torch.from_numpy(x[:NCF_BATCH]).cuda()
    yb = torch.from_numpy(y[:NCF_BATCH]).cuda()
    wall, busy, groups = profile_train_step(torch, model.estimator, xb, yb,
                                            iters=20)
    print(f"ncf step: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall:.3f}; by group " + json.dumps(
              {g: round(ms, 4) for g, ms in groups.items()})
          + f" ({card})", flush=True)
    return summary


def resnet_learn(torch, card, peaks):
    """bench.py's measure_resnet on the card: ImageClassifier(1000,
    "resnet50", dtype="bfloat16") through ZooModel.fit(device_cache=True),
    batch 256, 8 steps an epoch, 5 epochs, seeded f32 images; then one
    profiled train step by kernel group."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.models import ImageClassifier

    get_config().set("zoo.train.log_every_n_steps", 100000)
    rng = np.random.RandomState(0)
    n = RESNET_BATCH * RESNET_STEPS
    x = rng.rand(n, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.int32)
    model = ImageClassifier(class_num=1000, backbone="resnet50",
                            dtype="bfloat16", device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    # ---- main path: ZooModel.fit -> Estimator._fit_device_cached ----
    history = model.fit((x, y), batch_size=RESNET_BATCH,
                        epochs=RESNET_EPOCHS, device_cache=True)
    torch.cuda.synchronize()
    # ---- end of the main path ----
    losses = _finite_losses(history, "resnet50")
    best, median = _epoch_rates(history, n)
    summary = {
        "images_per_s": best, "median_images_per_s": median,
        "first_epoch_s": history[0]["seconds"],
        "mfu": best * RESNET50_TRAIN_FLOPS / peaks["bf16"],
        "median_mfu": median * RESNET50_TRAIN_FLOPS / peaks["bf16"],
        "epoch_seconds": [h["seconds"] for h in history],
        "losses": losses,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": card}
    print(f"resnet50 fit: {json.dumps(summary)}", flush=True)
    xb = torch.from_numpy(x[:RESNET_BATCH]).cuda()
    yb = torch.from_numpy(y[:RESNET_BATCH]).cuda()
    del x
    wall, busy, groups = profile_train_step(torch, model.estimator, xb, yb,
                                            kernel_groups=RESNET_GROUPS)
    print(f"resnet50 step: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}; by group " + json.dumps(
              {g: round(ms, 4) for g, ms in groups.items()})
          + f" ({card})", flush=True)
    summary.update(step_wall_ms=wall, step_busy_ms=busy,
                   step_groups_ms=groups)
    return summary


def serve_images(model, images, batch, depth, label, device="cuda"):
    """``model`` saved and served through launch() on the memory queue
    (batch = max batch ``batch``, timeout 2 ms, pipeline depth ``depth``,
    every bucket warmed with a uint8 example, the HTTP frontend off); a
    closed burst of one request a raw uint8 image (no image decoder on
    the path). Fails unless every request is answered once with a finite
    row. Returns (the answers stacked in request order, the latencies in
    seconds, wall s, start-up s, the batcher's stats)."""
    from analytics_zoo_tpu_torch.serving.launcher import launch

    n = len(images)
    with tempfile.TemporaryDirectory() as tmp:
        model.save_model(tmp)
        # ---- main path: launch -> ServingWorker -> InferenceModel ----
        t0 = time.perf_counter()
        app = launch({
            "model": {"path": tmp},
            "params": {"batch_size": batch, "max_batch_size": batch,
                       "timeout_ms": 2.0, "pipeline_depth": depth,
                       "warm_example": np.zeros((1, *images.shape[1:]),
                                                np.uint8)},
            "http": {"enabled": False}}, device=device)
        up = time.perf_counter() - t0
        try:
            sent, got, lat = {}, {}, []
            t_start = time.perf_counter()
            for i in range(n):
                uri = f"img{i:03d}"
                sent[uri] = time.perf_counter()
                if not app.input_queue.enqueue(uri, image=images[i]):
                    fail(f"{label}: enqueue refused {uri}")
            deadline = time.perf_counter() + 300
            while len(got) < n and time.perf_counter() < deadline:
                item = app.output_queue.dequeue(timeout=1.0)
                if item is None:
                    continue
                uri, tensors = item
                if uri in got:
                    fail(f"{label}: {uri} answered twice")
                lat.append(time.perf_counter() - sent[uri])
                got[uri] = tensors
            wall = time.perf_counter() - t_start
            stats = app.worker.batcher.stats()
        finally:
            app.stop()
        # ---- end of the main path ----
    if len(got) != n:
        fail(f"{label}: answered {len(got)}/{n}")
    served = np.stack([np.asarray(got[f"img{i:03d}"]["output"])
                       for i in range(n)])
    if not np.isfinite(served).all():
        fail(f"{label}: non-finite replies")
    return served, lat, wall, up, stats


def image_serving(torch, card):
    """bench.py's measure_serving deployment on the card: a seeded
    ImageClassifier(1000, "resnet18", dtype="bfloat16") saved and served
    through launch() (batch 128, pipeline depth 3, every bucket warmed
    with a uint8 example); a closed burst of 512 raw uint8 [224,224,3]
    requests (no image decoder on the path). Every request is answered
    once, with the top class of an eval-mode forward of the same model
    on the same image and logits within 2e-2 (1 + |ref|) of it."""
    from analytics_zoo_tpu_torch.models import ImageClassifier

    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (IMAGE_SERVING_REQUESTS, IMAGE_SIZE,
                                  IMAGE_SIZE, 3), dtype=np.uint8)
    model = ImageClassifier(class_num=1000, backbone="resnet18",
                            dtype="bfloat16", device="cuda", seed=0)
    served, lat, wall, up, stats = serve_images(
        model, images, IMAGE_SERVING_BATCH, IMAGE_SERVING_DEPTH,
        "image serving")
    if served.shape != (IMAGE_SERVING_REQUESTS, 1000):
        fail(f"image serving: bad replies {served.shape}")
    ref = []
    with torch.inference_mode():
        for i in range(0, IMAGE_SERVING_REQUESTS, IMAGE_SERVING_BATCH):
            xb = torch.from_numpy(images[i:i + IMAGE_SERVING_BATCH]).cuda()
            ref.append(model.module(xb).float().cpu().numpy())
    ref = np.concatenate(ref)
    excess = float((np.abs(served - ref)
                    - IMAGE_SERVE_TOL * (1 + np.abs(ref))).max())
    top_diff = int((served.argmax(-1) != ref.argmax(-1)).sum())
    lat_ms = np.asarray(lat) * 1e3
    summary = {
        "requests": IMAGE_SERVING_REQUESTS, "up_s": up, "wall_s": wall,
        "rps": IMAGE_SERVING_REQUESTS / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "served_batches": stats["batches"],
        "mean_occupancy": stats["mean_occupancy"],
        "max_batch_size": stats["max_batch_size"],
        "max_abs_diff": float(np.abs(served - ref).max()),
        "top1_differ": top_diff, "card": card}
    print(f"image serving: {json.dumps(summary)}", flush=True)
    if top_diff:
        fail(f"image serving: {top_diff} answers' top class differs from "
             "the eval-mode forward")
    if excess > 0:
        fail(f"image serving: logits beyond {IMAGE_SERVE_TOL} (1 + |ref|) "
             f"of the eval-mode forward by {excess:.3g}")
    return summary


def _seeded_pair(torch, build, label, draw_norms=False):
    """``build()`` seeded on the CPU (every BatchNorm's scale, bias and
    running statistics drawn too with ``draw_norms``, so that no
    residual branch starts at scale 0 and gradient 0) and a copy of it
    on the card. Fails if TF32 is on."""
    from analytics_zoo_tpu_torch.keras.layers.normalization import (
        BatchNorm)
    from analytics_zoo_tpu_torch.keras.layers.transformer import (
        reset_parameters)

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail(f"{label}: TF32 is on")
    cpu = build()
    reset_parameters(cpu, 0)
    if draw_norms:
        rng = np.random.RandomState(1)
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, BatchNorm):
                    c = m.weight.numel()
                    m.weight.copy_(torch.from_numpy(rng.rand(c) + 0.5))
                    m.bias.copy_(torch.from_numpy(rng.randn(c) * 0.2))
                    m.mean.copy_(torch.from_numpy(rng.randn(c) * 0.2))
                    m.var.copy_(torch.from_numpy(rng.rand(c) + 0.5))
    gpu = build().cuda()
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _step_values(torch, m, x, y, loss_fn=None, train=True):
    """One train step of ``m`` on its device (the loss's gradients, the
    BatchNorm statistics it leaves), then an eval-mode forward, as
    {"group name": array}. ``x`` is an array or a dict of arrays;
    ``loss_fn`` defaults to sparse categorical cross-entropy;
    ``train=False`` takes the step's gradients in eval mode, and a
    module whose forward takes no ``train`` is called without it."""
    from analytics_zoo_tpu_torch.learn.objectives import (
        sparse_categorical_crossentropy)
    from analytics_zoo_tpu_torch.learn.optim import (batch_stats_tree,
                                                     param_tree)
    from analytics_zoo_tpu_torch.utils.tree import tree_map

    loss_fn = loss_fn or sparse_categorical_crossentropy
    takes_train = "train" in inspect.signature(m.forward).parameters

    def forward(xt, training):
        return m(xt, train=training) if takes_train else m(xt)

    dev = next(m.parameters()).device
    xt = tree_map(lambda a: torch.from_numpy(a).to(dev), x)
    loss = loss_fn(forward(xt, train), torch.from_numpy(y).to(dev))
    loss.backward()
    with torch.no_grad():
        ev = forward(xt, False).cpu().numpy()
    return {"loss": np.asarray(loss.item()),
            **{f"grad {k}": p.grad.cpu().numpy()
               for k, p in param_tree(m).items()},
            **{f"stats {k}": b.cpu().numpy()
               for k, b in batch_stats_tree(m).items()},
            "eval": ev}


def _card_cpu(torch, build, x, y, label, card, draw_norms=False,
              loss_fn=None, train=True):
    """``_step_values`` of the same seeded module on the CPU and on the
    card, in the module's type (f32, or f64 where f32 rounding would
    swamp the comparison) with TF32 off; every value within 1e-4 (1 +
    |cpu|). ``train=False`` for a model with dropout: the card's and
    the CPU's masks would differ."""
    cpu, gpu = _seeded_pair(torch, build, label, draw_norms)
    out = {dev: _step_values(torch, m, x, y, loss_fn, train)
           for dev, m in (("cpu", cpu), ("cuda", gpu))}
    return _compare_card_cpu(out, label, card, {
        "loss_cuda": float(out["cuda"]["loss"]),
        "loss_cpu": float(out["cpu"]["loss"])})


def _worst_excess(got, want):
    """Per group ("group name" keys), the largest excess of ``got`` over
    CARD_CPU_TOL (1 + |want|): {group: (excess, key)}."""
    worst = {}
    for k, w in want.items():
        excess = float((np.abs(got[k] - w)
                        - CARD_CPU_TOL * (1 + np.abs(w))).max())
        group = k.split(" ")[0]
        if group not in worst or excess > worst[group][0]:
            worst[group] = (excess, k)
    return worst


def _compare_card_cpu(out, label, card, summary):
    """Holds ``out["cuda"]`` against ``out["cpu"]`` (the same named
    values, "group name" keys) within CARD_CPU_TOL (1 + |cpu|); prints
    and returns ``summary`` with each group's largest excess."""
    if sorted(out["cuda"]) != sorted(out["cpu"]):
        fail(f"{label}: the card's values are not the CPU's: "
             f"{sorted(set(out['cuda']) ^ set(out['cpu']))}")
    worst = _worst_excess(out["cuda"], out["cpu"])
    summary = {**summary, "values": len(out["cpu"]),
               "max_excess": {g: [round(e, 9), k] for g, (e, k)
                              in worst.items()}, "card": card}
    print(f"{label}: {json.dumps(summary)}", flush=True)
    bad = {g: k for g, (e, k) in worst.items() if e > 0}
    if bad:
        fail(f"{label}: the card differs from the CPU beyond "
             f"{CARD_CPU_TOL} (1 + |cpu|) at {bad}")
    return summary


def card_cpu_check(torch, card):
    """ResNet-18 (f32, batch 8, 64 x 64 images, 10 classes) and NCF (50
    users, 40 items, 5 classes, batch 256) on the card against the CPU,
    which the tier-1 tests hold against the JAX package: one train
    step's loss, gradients and BatchNorm statistics, then an eval-mode
    forward."""
    from analytics_zoo_tpu_torch.models.image.resnet import ResNet18
    from analytics_zoo_tpu_torch.models.recommendation.ncf import (
        NeuralCFNet)

    rng = np.random.RandomState(2)
    resnet = _card_cpu(
        torch, lambda: ResNet18(num_classes=10),
        rng.randn(8, 64, 64, 3).astype(np.float32),
        rng.randint(0, 10, 8).astype(np.int64), "card vs cpu, resnet18",
        card, draw_norms=True)

    class NCF(NeuralCFNet):
        def forward(self, x, train=False):
            return super().forward(x)

    x = np.stack([rng.randint(1, 51, 256), rng.randint(1, 41, 256)],
                 axis=1).astype(np.int32)
    ncf = _card_cpu(torch, lambda: NCF(50, 40, class_num=5), x,
                    rng.randint(0, 5, 256).astype(np.int64),
                    "card vs cpu, ncf", card)
    return resnet, ncf


# the Keras functional Model around BERT-base (f32: the reference's
# Keras BERT takes no dtype); attention-prob dropout 0, as BERTSQuAD and
# BERTNER set it, since the kernels (as the reference's) have none
KERAS_BERT = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                  intermediate_size=3072, max_position_len=512,
                  attn_dropout=0.0)
KERAS_SEQ, KERAS_BATCH, KERAS_STEPS = 512, 16, 16
KERAS_GRAD_PARAMS = ("modules_0.encoder_0.attention.qkv.weight",
                     "modules_3.Dense_0.weight")


def keras_bert_model(device="cuda"):
    """The Keras functional Model of phase 30, compiled, seed 0."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras.layers import (BERT, Dense, Dropout,
                                                      SelectTable)

    ids = Input((KERAS_SEQ,))
    h = BERT(**KERAS_BERT)(ids)
    out = Dense(2)(Dropout(0.1)(SelectTable(1)(h)))
    model = Model(ids, out, device=device, seed=0)
    return model.compile(optimizer="adam",
                         loss="sparse_categorical_crossentropy")


def keras_mlp(device):
    """Phase 30's Sequential of core, merge and activation layers,
    materialized on ``device`` (its module, for ``_card_cpu``)."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as L

    model = Sequential([
        L.Dense(32, activation="relu"), L.PReLU(), L.Highway(),
        L.SplitTensor(0, 2), L.Merge(mode="ave"),
        L.MaxoutDense(16, nb_feature=3), L.SReLU(), L.LeakyReLU(0.1),
        L.Dense(16, activation="tanh"), L.ELU(0.5), L.Dense(4)],
        device=device)
    return model.materialize(np.zeros((1, 24), np.float32)).module


def keras_bert_learn(torch, card, peaks):
    """Phase 30 (see the module docstring). Returns the summary."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.learn.objectives import (
        sparse_categorical_crossentropy)
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    label = "keras BERT"
    cfg = get_config()
    cfg.set("zoo.ops.attention_impl", "flash")
    rng = np.random.RandomState(0)
    n = KERAS_BATCH * KERAS_STEPS
    x = rng.randint(0, KERAS_BERT["vocab"], (n, KERAS_SEQ)).astype(np.int32)
    y = rng.randint(0, 2, n).astype(np.int32)
    blocks = KERAS_BERT["n_block"]
    t0 = time.perf_counter()
    model = keras_bert_model()
    model.materialize(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # one step's f32 gradients at the seeded weights (hidden dropout
    # off): flash (K1-lse, K2, K3) against einsum attention
    xb = torch.from_numpy(x[:KERAS_BATCH]).cuda()
    yb = torch.from_numpy(y[:KERAS_BATCH]).cuda()
    grad = dict(loss_fn=sparse_categorical_crossentropy,
                names=KERAS_GRAD_PARAMS)
    ref = step_grads(torch, model.module, xb, yb, "einsum", **grad)
    _reset_launches(fa)
    rel = _rel(step_grads(torch, model.module, xb, yb, "flash",
                          **grad)[1], ref[1])
    counts = _launches(fa)
    print(_check_f32tc(f"{label} f32 check", counts, _f32tc_expected(
        torch, fa, "float32", counts)), flush=True)
    F32_CHECK_LAUNCHES["keras_bert"] = counts
    print(f"{label}: f32 gradients flash vs einsum rel_err={rel} (tol "
          f"{F32_GRAD_TOL}; batch {KERAS_BATCH})", flush=True)
    if not all(r <= F32_GRAD_TOL for r in rel.values()):
        fail(f"{label}: f32 gradients flash vs einsum differ: {rel}")
    planted = fault_controls(torch, model.module, xb, yb, ref[1],
                             F32_GRAD_TOL, ("dq_zeroed",), label=label,
                             **grad)
    cfg.set("zoo.train.log_every_n_steps", KERAS_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    # ---- main path: Model.fit -> Estimator.fit ----
    try:
        hist = model.fit(x, y, batch_size=KERAS_BATCH, nb_epoch=2)
        torch.cuda.synchronize()
    finally:
        cfg.unset("zoo.train.log_every_n_steps")
    fit = _launches(fa)
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    steps = model.estimator.global_step
    losses = _finite_losses(hist, label)
    if steps != 2 * KERAS_STEPS:
        fail(f"{label}: fit ran {steps} steps")
    print(_check_f32tc(f"{label} fit", fit, _f32tc_expected(
        torch, fa, "float32", fit)), flush=True)
    for k in ("K1", "K2", "K3"):
        if fit[k][0] != blocks * steps:
            fail(f"{label}: {k} launched {fit[k][0]} times in {steps} "
                 f"train steps (want {blocks * steps})")
    m = 4 * KERAS_BATCH
    _reset_launches(fa)
    # ---- main path: Model.predict -> Estimator.predict ----
    pred = model.predict(x[:m], batch_size=KERAS_BATCH)
    torch.cuda.synchronize()
    inferred = _launches(fa)
    # ---- end of the main path ----
    print(_check_f32tc(f"{label} predict", inferred, _f32tc_expected(
        torch, fa, "float32", inferred)), flush=True)
    want = {"K1": blocks * m // KERAS_BATCH, "K2": 0, "K3": 0}
    if {k: c[0] for k, c in inferred.items()} != want:
        fail(f"{label}: predict launched {inferred} (want {want})")
    if pred.shape != (m, 2) or not np.isfinite(pred).all():
        fail(f"{label} predict: bad output {pred.shape}")
    ev = model.evaluate(x[:m], y[:m], batch_size=KERAS_BATCH)
    if not np.isfinite(ev["loss"]):
        fail(f"{label} evaluate: non-finite loss {ev}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        model.save_weights(d)
        save_s = time.perf_counter() - t0
        fresh = keras_bert_model()
        fresh.load_weights(d)
        again = fresh.predict(x[:m], batch_size=KERAS_BATCH)
    if not np.array_equal(again, pred):
        fail(f"{label}: predict after load_weights differs by "
             f"{float(np.abs(again - pred).max())}")
    if fresh.estimator.global_step != steps:
        fail(f"{label}: load_weights restored step "
             f"{fresh.estimator.global_step}, not {steps}")
    del fresh
    timed = hist[1]["seconds"]
    sps = KERAS_STEPS * KERAS_BATCH / timed
    p_dense = _dense_params(model.module)
    flops_per_token = 6 * p_dense + 12 * blocks * 768 * KERAS_SEQ
    wall, busy, groups = profile_train_step(torch, model.estimator, xb, yb)
    summary = {
        "config": KERAS_BERT, "seq": KERAS_SEQ, "batch": KERAS_BATCH,
        "steps": steps, "losses": losses, "build_s": build_s,
        "timed_epoch_s": timed, "samples_per_s": sps,
        "tokens_per_s": sps * KERAS_SEQ, "dense_params": p_dense,
        "mfu_f32": sps * KERAS_SEQ * flops_per_token / peaks["f32"],
        "peak_mem_gib": peak / 2 ** 30, "eval_loss": ev["loss"],
        "save_s": save_s, "grad_rel_err": rel,
        "planted_fault_rel_err": planted,
        "launches": {"fit": fit, "predict": inferred},
        "step_wall_ms": wall, "step_busy_ms": busy,
        "idle_share": 1 - busy / wall,
        "step_ms_by_group": {g: round(v, 4) for g, v in groups.items()},
        "card": card}
    print(f"{label}: {json.dumps(summary)}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    xs = rng.randn(64, 24).astype(np.float32)
    ys = rng.randint(0, 4, 64).astype(np.int64)
    _card_cpu(torch, lambda: keras_mlp("cpu"), xs, ys,
              "card vs cpu, keras mlp", card)
    return summary


# the Keras text classifiers at TextClassifier's default widths
# (analytics_zoo_tpu/models/text/classifier.py: vocab 20000 + 1, embed
# 200, sequence 500, encoder 256) and the 20 classes of the reference's
# 20 Newsgroups app, f32, Adam and sparse categorical cross-entropy
TEXT = dict(vocab=20001, embed=200, seq=500, encoder=256, classes=20)
TEXT_BATCH, TEXT_STEPS, TEXT_CHECK_BATCH = 128, 16, 8
# the card against the CPU, f32 with TF32 off: one step's gradients,
# ||g_cuda - g_cpu|| / ||g_cpu|| per parameter (cuDNN's and the CPU's
# convolutions and recurrences sum in other orders)
TEXT_GRAD_TOL = 1e-3
# a text train step's kernels by group (the first group a kernel's name
# matches): the embedding's gather and its backward (a sort of the ids,
# then a segmented sum), cuDNN's recurrence (its per-step cell kernels;
# its per-step products are GEMMs), the convolution, the products (the
# LSTM's input projections and recurrent steps among them), Adam
TEXT_GROUPS = (
    ("embedding", ("embedding", "indexSelect", "index_select", "gather",
                   "segment", "RadixSort", "radix_sort", "unique",
                   "scatter", "index_add", "indexFunc", "index_elementwise",
                   "compute_grad_weight")),
    ("convolution", ("conv", "implicit", "dgrad", "wgrad", "fprop")),
    ("cuDNN RNN", ("RNN", "LSTM", "lstm", "rnn", "elemWise")),
    ("gemm", ("nvjet", "gemm", "cutlass", "Kernel2", "splitKreduce")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel", "max_pool", "amax")),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
    ("elementwise", ("elementwise_kernel",)),
)


def text_model(kind, device, widths=TEXT):
    """Phase 31's Keras text classifier, compiled, seed 0: "cnn"
    (Embedding, Convolution1D(encoder, 5, relu), GlobalMaxPooling1D,
    Dropout, Dense(128, relu), Dense(classes)) or "bilstm" (Embedding,
    Bidirectional(LSTM(encoder)), Dropout, Dense(128, relu),
    Dense(classes)), through the port's public imports."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as L

    w = widths
    if kind == "cnn":
        encoder = [L.Convolution1D(w["encoder"], 5, activation="relu"),
                   L.GlobalMaxPooling1D()]
    else:
        encoder = [L.Bidirectional(L.LSTM(w["encoder"]))]
    model = Sequential(
        [L.Embedding(w["vocab"], w["embed"]), *encoder, L.Dropout(0.2),
         L.Dense(128, activation="relu"), L.Dense(w["classes"])],
        device=device, seed=0)
    return model.compile(optimizer="adam",
                         loss="sparse_categorical_crossentropy",
                         metrics=["accuracy"])


def text_data(rng, n, widths=TEXT):
    """Seeded synthetic documents a classifier can learn: random ids in
    [classes + 1, vocab), and the class's own id (class + 1) at 5
    random positions."""
    w = widths
    y = rng.randint(0, w["classes"], n).astype(np.int32)
    x = rng.randint(w["classes"] + 1, w["vocab"],
                    (n, w["seq"])).astype(np.int32)
    pos = rng.randint(0, w["seq"], (n, 5))
    x[np.arange(n)[:, None], pos] = (y + 1)[:, None]
    return x, y


def _text_card_cpu(torch, kind, x, y, label, card):
    """One step's gradients (dropout off) and ``predict`` of the same
    seeded model on the CPU and on the card, f32 with TF32 off:
    gradients within TEXT_GRAD_TOL relative per parameter, predictions
    within CARD_CPU_TOL (1 + |cpu|)."""
    from analytics_zoo_tpu_torch.learn.objectives import (
        sparse_categorical_crossentropy)
    from analytics_zoo_tpu_torch.learn.optim import param_tree

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail(f"{label}: TF32 is on")
    models = {"cpu": text_model(kind, "cpu").materialize(x),
              "cuda": text_model(kind, "cuda").materialize(x)}
    models["cuda"].module.load_state_dict(models["cpu"].module.state_dict())
    grads, preds = {}, {}
    for dev, m in models.items():
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        loss = sparse_categorical_crossentropy(m.module(xt, train=False),
                                               yt)
        loss.backward()
        grads[dev] = {k: p.grad.double().cpu()
                      for k, p in param_tree(m.module).items()}
        preds[dev] = m.predict(x, batch_size=len(x))
    rel = {k: float((grads["cuda"][k] - g).norm() / g.norm())
           for k, g in grads["cpu"].items()}
    excess = float((np.abs(preds["cuda"] - preds["cpu"])
                    - CARD_CPU_TOL * (1 + np.abs(preds["cpu"]))).max())
    print(f"{label}: card vs cpu gradients rel_err={rel} (tol "
          f"{TEXT_GRAD_TOL}); predict max excess {excess:.3g} (tol "
          f"{CARD_CPU_TOL} (1 + |cpu|)); batch {len(x)} ({card})",
          flush=True)
    bad = {k: r for k, r in rel.items() if not r <= TEXT_GRAD_TOL}
    if bad:
        fail(f"{label}: card and CPU gradients differ: {bad}")
    if not excess <= 0:
        fail(f"{label}: card and CPU predictions differ (excess {excess})")
    return rel, excess


def keras_text_learn(torch, card, peaks):
    """Phase 31 (see the module docstring). Returns the summary."""
    rng = np.random.RandomState(31)
    n = TEXT_BATCH * TEXT_STEPS
    x, y = text_data(rng, n)
    out = {}
    for kind in ("cnn", "bilstm"):
        label = f"keras text {kind}"
        check = _text_card_cpu(torch, kind, x[:TEXT_CHECK_BATCH],
                               y[:TEXT_CHECK_BATCH], label, card)
        gc.collect()
        torch.cuda.empty_cache()
        model = text_model(kind, "cuda")
        torch.cuda.reset_peak_memory_stats()
        # ---- main path: Sequential.fit -> Estimator.fit ----
        hist = model.fit(x, y, batch_size=TEXT_BATCH, nb_epoch=2)
        torch.cuda.synchronize()
        # ---- end of the main path ----
        peak = torch.cuda.max_memory_allocated()
        losses = _finite_losses(hist, label)
        steps = model.estimator.global_step
        if steps != 2 * TEXT_STEPS:
            fail(f"{label}: fit ran {steps} steps")
        m = 4 * TEXT_BATCH
        ev = model.evaluate(x[:m], y[:m], batch_size=TEXT_BATCH)
        t0 = time.perf_counter()
        pred = model.predict(x[:m], batch_size=TEXT_BATCH)
        pred_s = time.perf_counter() - t0
        if pred.shape != (m, TEXT["classes"]) or \
                not np.isfinite(pred).all():
            fail(f"{label} predict: bad output {pred.shape}")
        if not np.isfinite(ev["loss"]):
            fail(f"{label} evaluate: non-finite loss {ev}")
        with tempfile.TemporaryDirectory() as d:
            model.save_weights(d)
            fresh = text_model(kind, "cuda")
            fresh.load_weights(d)
            again = fresh.predict(x[:m], batch_size=TEXT_BATCH)
        if not np.array_equal(again, pred):
            fail(f"{label}: predict after load_weights differs by "
                 f"{float(np.abs(again - pred).max())}")
        del fresh
        xb = torch.from_numpy(x[:TEXT_BATCH]).cuda()
        yb = torch.from_numpy(y[:TEXT_BATCH]).cuda()
        wall, busy, groups = profile_train_step(
            torch, model.estimator, xb, yb, kernel_groups=TEXT_GROUPS)
        params = sum(p.numel() for p in model.module.parameters())
        out[kind] = {
            "widths": TEXT, "batch": TEXT_BATCH, "steps": steps,
            "params": params, "losses": losses,
            "samples_per_s": TEXT_STEPS * TEXT_BATCH / hist[1]["seconds"],
            "predict_samples_per_s": m / pred_s,
            "eval_loss": ev["loss"], "eval_accuracy": ev.get("accuracy"),
            "peak_mem_gib": peak / 2 ** 30,
            "card_cpu_grad_rel_err": check[0],
            "card_cpu_predict_excess": check[1],
            "step_wall_ms": wall, "step_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "step_ms_by_group": {g: round(v, 4) for g, v in groups.items()},
            "card": card}
        print(f"{label}: {json.dumps(out[kind])}", flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out["all_layers"] = all_layers_check(torch, card)
    return out


ALL_LAYERS_BATCH = 8


def keras_all_layers(device):
    """A functional Model holding every layer of the Keras slice 3b
    (embedding, convolutional, pooling, normalization, recurrent and
    torch-style) at least once, over seven inputs; compiled, seed 0."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as L

    ids, bags = Input((12,)), Input((5,))
    img, vol = Input((8, 8, 3)), Input((4, 6, 6, 2))
    seq_img, seq_vol = Input((3, 6, 6, 2)), Input((2, 4, 4, 4, 2))
    vec = Input((6,))
    table = np.random.RandomState(5).randn(30, 6).astype(np.float32)
    feats = []
    # text: embeddings, 1-D convolutions and pooling, recurrences
    t = L.merge_add([L.Embedding(30, 6)(ids),
                     L.WordEmbedding(30, 6, weights=table)(ids)])
    t = L.Cropping1D((1, 1))(L.ZeroPadding1D((1, 2))(t))
    t = L.Convolution1D(8, 3, border_mode="same", activation="relu")(t)
    t = L.UpSampling1D(2)(L.AtrousConvolution1D(8, 2, atrous_rate=2)(t))
    t = L.AveragePooling1D(2, border_mode="same")(L.MaxPooling1D(2)(t))
    r1 = L.SimpleRNN(5, return_sequences=True)(L.LocallyConnected1D(6, 2)(t))
    r2 = L.GRU(5, return_sequences=True, go_backwards=True)(r1)
    feats += [L.Bidirectional(L.LSTM(4))(r2), L.GlobalMaxPooling1D()(r2),
              L.GlobalAveragePooling1D()(r1),
              L.Flatten()(L.TimeDistributed(L.Dense(3))(r1)),
              L.SparseEmbedding(30, 4, combiner="mean")(bags)]
    # images: 2-D convolutions, normalization and pooling
    h = L.Convolution2D(6, 3, 3, border_mode="same")(
        L.BatchNormalization()(img))
    h = L.SeparableConvolution2D(6, 2, 2, depth_multiplier=2,
                                 border_mode="same")(h)
    h = L.AtrousConvolution2D(4, 2, 2, atrous_rate=(2, 2))(h)
    h = L.Deconvolution2D(4, 2, 2, subsample=(2, 2))(h)
    h = L.WithinChannelLRN2D(size=3)(L.LRN2D(n=3)(h))
    h = L.Cropping2D(((1, 0), (0, 1)))(L.ZeroPadding2D(1)(h))
    h = L.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(h)
    h = L.UpSampling2D(2)(L.AveragePooling2D(border_mode="same")(h))
    h = L.ShareConvolution2D(3, 2, 2)(L.ResizeBilinear(5, 6)(h))
    h = L.LayerNormalization()(L.LocallyConnected2D(2, 2, 2)(h))
    feats += [L.GlobalMaxPooling2D()(h), L.GlobalAveragePooling2D()(h)]
    # volumes: 3-D convolution and pooling
    v = L.ZeroPadding3D(1)(L.Convolution3D(3, 2, 2, 2,
                                          border_mode="same")(vol))
    v = L.UpSampling3D(2)(L.Cropping3D()(v))
    v = L.AveragePooling3D(2)(L.MaxPooling3D(2)(v))
    feats += [L.GlobalMaxPooling3D()(v), L.GlobalAveragePooling3D()(v)]
    # sequences of images and of volumes
    feats += [L.GlobalAveragePooling2D()(L.ConvLSTM2D(3, 3)(seq_img)),
              L.Flatten()(L.TimeDistributed(L.Convolution2D(2, 3, 3))(
                  seq_img)),
              L.Flatten()(L.ConvLSTM3D(2, 2)(seq_vol))]
    # the torch-style layers
    u = L.SparseDense(6, activation="tanh")(vec)
    u = L.Scale((6,))(L.Mul()(L.CMul((1, 6))(L.CAdd((6,))(u))))
    u = L.MulConstant(0.8)(L.AddConstant(0.5)(u))
    a = L.Exp()(L.Negative()(L.Square()(u)))
    a = L.Sqrt()(L.AddConstant(0.1)(L.Log()(L.AddConstant(1.0)(a))))
    feats.append(L.Identity()(L.Power(1.5, scale=2.0, shift=0.5)(a)))
    feats += [layer(u) for layer in (
        L.Threshold(0.1, -0.5), L.BinaryThreshold(0.0), L.HardShrink(0.2),
        L.SoftShrink(0.2), L.HardTanh(-0.3, 0.3), L.RReLU(), L.Softmax(),
        L.LayerNorm())]
    wide = L.Expand((3, 6))(L.ExpandDim(0)(u))
    feats += [L.Select(0, 1)(L.Narrow(0, 1, 2)(wide)), L.Max(0)(wide),
              L.Squeeze(0)(L.ExpandDim(0)(u)),
              L.Lambda(lambda s: s.float() * 0.1)(L.GetShape()(wide))]
    out = L.Dense(4)(L.concatenate(feats))
    model = Model([ids, bags, img, vol, seq_img, seq_vol, vec], out,
                  device=device, seed=0)
    return model.compile(optimizer="adam",
                         loss="sparse_categorical_crossentropy")


def all_layers_inputs(rng, n=ALL_LAYERS_BATCH):
    ids = rng.randint(0, 30, (n, 12)).astype(np.int32)
    bags = rng.randint(0, 30, (n, 5)).astype(np.int32)
    bags[:, 3:] = 0
    shapes = ((8, 8, 3), (4, 6, 6, 2), (3, 6, 6, 2), (2, 4, 4, 4, 2), (6,))
    dense = [(1.5 * rng.randn(n, *s) + 0.5).astype(np.float32)
             for s in shapes]
    return (ids, bags, *dense)


def all_layers_check(torch, card):
    """Phase 31's all-layers Model on the card and on the CPU at the same
    seeded weights, f32 with TF32 off: the eval-mode output and its
    loss's gradients, then one train-mode forward's BatchNormalization
    statistics, each within CARD_CPU_TOL (1 + |cpu|)."""
    from analytics_zoo_tpu_torch.learn.objectives import (
        sparse_categorical_crossentropy)
    from analytics_zoo_tpu_torch.learn.optim import (batch_stats_tree,
                                                     param_tree)

    label = "card vs cpu, keras all layers"
    rng = np.random.RandomState(7)
    x = all_layers_inputs(rng)
    y = rng.randint(0, 4, ALL_LAYERS_BATCH).astype(np.int64)
    models = {"cpu": keras_all_layers("cpu").materialize(x),
              "cuda": keras_all_layers("cuda").materialize(x)}
    models["cuda"].module.load_state_dict(models["cpu"].module.state_dict())
    out = {}
    for dev, m in models.items():
        xt = [torch.from_numpy(a).to(dev) for a in x]
        yt = torch.from_numpy(y).to(dev)
        ev = m.module(*xt, train=False)
        loss = sparse_categorical_crossentropy(ev, yt)
        loss.backward()
        with torch.no_grad():
            # the train-mode forward updates the running statistics;
            # RReLU's training slopes (each device's own generator)
            # reach no BatchNormalization
            m.module(*xt, train=True,
                     rng=torch.Generator(dev).manual_seed(0))
        out[dev] = {"eval": ev.detach().cpu().numpy(),
                    "loss": np.asarray(loss.item()),
                    **{f"grad {k}": p.grad.cpu().numpy()
                       for k, p in param_tree(m.module).items()
                       if p.grad is not None},
                    **{f"stats {k}": b.cpu().numpy()
                       for k, b in batch_stats_tree(m.module).items()}}
    if not any(k.startswith("stats ") for k in out["cpu"]):
        fail(f"{label}: no BatchNormalization statistics")
    return _compare_card_cpu(out, label, card, {"parameters": sum(
        k.startswith("grad ") for k in out["cpu"])})


# phase 32: the zoo's sequence and tabular models at their published or
# default widths, each through ZooModel.fit -> Estimator for 2 epochs of
# ZOO_STEPS steps (the anomaly detector's series holds 10 batches)
ZOO_STEPS = 16
ZOO_CHECK_ROWS = 8
# KNRM at the widths of the reference's WikiQA ranker (GloVe-300,
# seeded here)
ZOO_KNRM = dict(text1_length=10, text2_length=40, vocab=20000,
                embed_dim=300, kernel_num=21)
ZOO_KNRM_BATCH, ZOO_KNRM_QUERIES, ZOO_KNRM_DOCS = 256, 128, 10
# Wide & Deep: wide_n_deep.ipynb's MovieLens-1M column info
ZOO_WND_INFO = dict(
    wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
    wide_cross_cols=["age-gender"], wide_cross_dims=[100],
    indicator_cols=["genres", "gender"], indicator_dims=[19, 3],
    embed_cols=["userId", "itemId"], embed_in_dims=[6040, 3952],
    embed_out_dims=[64, 64], continuous_cols=["age"])
ZOO_WND = dict(model_type="wide_n_deep", class_num=5,
               hidden_layers=(40, 20, 10))
ZOO_WND_BATCH = 8192
# the session recommender over GRU4Rec's preprocessed YOOCHOOSE clicks
# (37483 items; Hidasi et al. 2016), the class defaults, the history MLP
ZOO_SESSION = dict(item_count=37483, item_embed=100,
                   rnn_hidden_layers=(40, 20), session_length=10,
                   include_history=True, mlp_hidden_layers=(40, 20),
                   history_length=5)
ZOO_SESSION_BATCH, ZOO_SESSION_RECS = 1024, 256
# Seq2seq at the class defaults over a 20000-token vocabulary
ZOO_SEQ2SEQ = dict(vocab=20000, embed_dim=128, hidden_sizes=(128,),
                   max_len=32)
ZOO_SEQ2SEQ_BATCH, ZOO_INFER_ROWS = 256, 64
# infer's tokens on the card may differ from the CPU's only from a step
# where the CPU's top-two logit gap is below this
ZOO_TIE_GAP = 1e-5
# the anomaly detector as the reference's NYC-taxi app: unroll 50 over
# 3 features of a 10320-point half-hourly series, the class defaults
ZOO_ANOMALY = dict(feature_shape=(50, 3), hidden_layers=(8, 32, 15),
                   dropouts=(0.2, 0.2, 0.2))
ZOO_SERIES, ZOO_ANOMALY_BATCH, ZOO_ANOMALIES = 10320, 1024, 20
# the TextClassifier (CNN) served through launch()
ZOO_SERVE_REQUESTS, ZOO_SERVE_BATCH = 256, 32
# a zoo model's train step by kernel group: phase 31's, with cuDNN's GRU
# and persistent-kernel recurrences in the RNN group and the softmax
# (the heads' cross-entropy) on its own
ZOO_GROUPS = (
    TEXT_GROUPS[0], TEXT_GROUPS[1],
    ("cuDNN RNN", ("RNN", "LSTM", "GRU", "lstm", "rnn", "elemWise",
                   "elementWise")),
    ("softmax", ("SoftMax",)),
    *TEXT_GROUPS[3:])


def _rows(x, n):
    """The first ``n`` rows of an array or a dict of arrays."""
    if isinstance(x, dict):
        return {k: np.ascontiguousarray(v[:n]) for k, v in x.items()}
    return np.ascontiguousarray(x[:n])


def _on_device(torch, x, device):
    if isinstance(x, dict):
        return {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    return torch.from_numpy(x).to(device)


def zoo_fit(torch, model, x, y, batch, label, card):
    """``model`` through ``ZooModel.fit`` for 2 epochs, then one profiled
    train step. Fails if a parameter is not on the model's device (the
    card) before the fit. Returns the summary: the second epoch's
    samples/s, the peak memory, the losses, the step's wall and busy
    ms, idle share and device ms by kernel group."""
    off = [k for k, p in model.module.named_parameters()
           if p.device.type != model.device.type]
    if off:
        fail(f"{label}: parameters off {model.device} before fit: {off[:4]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- main path: ZooModel.fit -> Estimator.fit ----
    hist = model.fit((x, y), batch_size=batch, epochs=2)
    torch.cuda.synchronize()
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    losses = _finite_losses(hist, label)
    per_epoch = len(y) // batch
    steps = model.estimator.global_step
    if steps != 2 * per_epoch:
        fail(f"{label}: fit ran {steps} steps, not {2 * per_epoch}")
    wall, busy, groups = profile_train_step(
        torch, model.estimator, _on_device(torch, _rows(x, batch),
                                           model.device),
        torch.from_numpy(y[:batch]).to(model.device),
        kernel_groups=ZOO_GROUPS)
    return {"batch": batch, "steps": steps, "losses": losses,
            "losses_finite": True,
            "samples_per_s": per_epoch * batch / hist[1]["seconds"],
            "peak_mem_gib": peak / 2 ** 30,
            "params": sum(p.numel() for p in model.module.parameters()),
            "step_wall_ms": wall, "step_busy_ms": busy,
            "idle_share": 1 - busy / max(wall, 1e-9),
            "step_ms_by_group": {g: round(v, 4) for g, v in groups.items()},
            "card": card}


def zoo_after_fit(model, x, y, batch, out_width, label, batches=4):
    """``evaluate`` (finite) and ``predict`` (finite, of the expected
    shape, timed) on the first ``batches`` batches."""
    m = min(batches * batch, len(y))
    xm, ym = _rows(x, m), y[:m]
    ev = model.evaluate((xm, ym), batch_size=batch)
    if not all(np.isfinite(v) for v in ev.values()):
        fail(f"{label} evaluate: non-finite {ev}")
    t0 = time.perf_counter()
    pred = np.asarray(model.predict(xm, batch_size=batch))
    secs = time.perf_counter() - t0
    if pred.shape[:2] != (m, out_width) or not np.isfinite(pred).all():
        fail(f"{label} predict: bad output {pred.shape}")
    return {"eval": ev, "predict_samples_per_s": m / secs}


def _report(label, summary):
    print(f"{label}: {json.dumps(summary)}", flush=True)
    return summary


def zoo_text_classifiers(torch, card, device="cuda"):
    """TextClassifier at the class defaults (phase 31's widths and
    data) with each encoder, 20 classes, batch 128."""
    from analytics_zoo_tpu_torch.models import TextClassifier

    rng = np.random.RandomState(32)
    x, y = text_data(rng, TEXT_BATCH * ZOO_STEPS)
    out = {}
    for enc in ("cnn", "lstm", "gru"):
        label = f"zoo text classifier {enc}"
        model = TextClassifier(
            TEXT["classes"], vocab=TEXT["vocab"] - 1,
            embed_dim=TEXT["embed"], sequence_length=TEXT["seq"],
            encoder=enc, encoder_output_dim=TEXT["encoder"],
            device=device, seed=0)
        check = _card_cpu(torch, model._build_module, x[:ZOO_CHECK_ROWS],
                          y[:ZOO_CHECK_ROWS].astype(np.int64),
                          f"card vs cpu, {label}", card, train=False)
        summary = zoo_fit(torch, model, x, y, TEXT_BATCH, label, card)
        out[enc] = _report(label, {
            **summary, **zoo_after_fit(model, x, y, TEXT_BATCH,
                                       TEXT["classes"], label),
            "card_cpu_max_excess": check["max_excess"]})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def knrm_rows(rng, queries, matches):
    """Query ++ doc rows: each doc random ids with ``matches[i]`` of its
    tokens copied from its query (exact matches for the last kernel);
    10% of all slots padding."""
    n, l1 = queries.shape
    docs = rng.randint(1, ZOO_KNRM["vocab"] + 1,
                       (n, ZOO_KNRM["text2_length"]))
    copied = queries[np.arange(n)[:, None], rng.randint(0, l1, docs.shape)]
    docs = np.where(np.arange(docs.shape[1])
                    < np.asarray(matches).reshape(-1, 1), copied, docs)
    x = np.concatenate([queries, docs], 1)
    x[rng.rand(*x.shape) < 0.1] = 0
    return x.astype(np.int32)


def zoo_knrm(torch, card, device="cuda"):
    """KNRM ranking: (pos, neg) pairs of a query with a doc sharing 4 of
    its tokens and one sharing none, rank_hinge, batch 256 pairs; then
    NDCG@5 and MAP over 128 queries of 10 docs (relevance r for a doc
    sharing 2r tokens)."""
    from analytics_zoo_tpu_torch.learn.objectives import rank_hinge
    from analytics_zoo_tpu_torch.models import KNRM

    label = "zoo knrm"
    rng = np.random.RandomState(33)
    n = ZOO_KNRM_BATCH * ZOO_STEPS
    q = rng.randint(1, ZOO_KNRM["vocab"] + 1, (n, ZOO_KNRM["text1_length"]))
    x = np.stack([knrm_rows(rng, q, np.full(n, 4)),
                  knrm_rows(rng, q, np.zeros(n))], 1)
    y = np.zeros(n, np.float32)
    model = KNRM(device=device, seed=0, **ZOO_KNRM)
    check = _card_cpu(torch, model._build_module, x[:ZOO_CHECK_ROWS],
                      y[:ZOO_CHECK_ROWS], f"card vs cpu, {label}", card,
                      loss_fn=rank_hinge)
    summary = zoo_fit(torch, model, x, y, ZOO_KNRM_BATCH, label, card)
    after = zoo_after_fit(model, x, y, ZOO_KNRM_BATCH, 2, label)
    rel = rng.randint(0, 3, ZOO_KNRM_QUERIES * ZOO_KNRM_DOCS)
    rows = knrm_rows(rng, np.repeat(q[:ZOO_KNRM_QUERIES], ZOO_KNRM_DOCS, 0),
                     2 * rel)
    labels = [list(r) for r in rel.reshape(ZOO_KNRM_QUERIES, -1)]
    t0 = time.perf_counter()
    ndcg = model.evaluate_ndcg(rows, labels, k=5)
    mean_ap = model.evaluate_map(rows, labels)
    rank_s = time.perf_counter() - t0
    if not (0 <= ndcg <= 1 and 0 <= mean_ap <= 1):
        fail(f"{label}: NDCG@5 {ndcg} or MAP {mean_ap} out of [0, 1]")
    return _report(label, {
        **summary, **after, "ndcg5": ndcg, "map": mean_ap,
        "ranking_s": rank_s, "card_cpu_max_excess": check["max_excess"]})


def wnd_features(rng, users, items):
    """MovieLens-1M-shaped features of (user, item) rows: occupation,
    gender and the age-gender cross as wide indices (1-based, each
    column's after those of the columns before it), the two ids, a
    multi-hot genre block beside a one-hot gender one, and a
    standardised age."""
    info, n = ZOO_WND_INFO, len(users)
    occ_dim, gender_dim = info["wide_base_dims"]
    gender = 1 + users % gender_dim
    age = (18 + users % 50).astype(np.float32)
    cross = 1 + (users * 7 + gender) % info["wide_cross_dims"][0]
    wide = np.stack([1 + users % occ_dim, occ_dim + gender,
                     occ_dim + gender_dim + cross], 1)
    genres = rng.rand(n, info["indicator_dims"][0]) < 0.15
    genres[np.arange(n), items % info["indicator_dims"][0]] = True
    return {"wide": wide.astype(np.int32),
            "embed": np.stack([users, items], 1).astype(np.int32),
            "indicator": np.concatenate(
                [genres, np.eye(gender_dim)[gender - 1]],
                1).astype(np.float32),
            "continuous": ((age[:, None] - 40.0) / 15.0)}


def zoo_wide_and_deep(torch, card, device="cuda"):
    """Wide & Deep at wide_n_deep.ipynb's column info, 5 rating classes,
    batch 8192; then recommend_for_user over every item through a
    feature assembler."""
    from analytics_zoo_tpu_torch.models import WideAndDeep
    from analytics_zoo_tpu_torch.models.recommendation.ncf import _shifted_ce

    label = "zoo wide and deep"
    rng = np.random.RandomState(34)
    info = ZOO_WND_INFO
    n = ZOO_WND_BATCH * ZOO_STEPS
    users = rng.randint(1, info["embed_in_dims"][0] + 1, n)
    items = rng.randint(1, info["embed_in_dims"][1] + 1, n)
    x = wnd_features(rng, users, items)
    y = (1 + (users + 2 * items) % 5).astype(np.int32)
    model = WideAndDeep(device=device, seed=0, column_info=info, **ZOO_WND)

    def build():
        # the wide weights start at zero, as in the reference: drawn
        # here so that the eval-mode forward reads them too
        net = model._build_module()
        with torch.no_grad():
            g = torch.Generator().manual_seed(1)
            net.wide_weight.normal_(0.0, 0.1, generator=g)
            net.wide_bias.normal_(0.0, 0.1, generator=g)
        return net

    check = _card_cpu(torch, build, _rows(x, ZOO_CHECK_ROWS),
                      y[:ZOO_CHECK_ROWS], f"card vs cpu, {label}", card,
                      loss_fn=_shifted_ce)
    summary = zoo_fit(torch, model, x, y, ZOO_WND_BATCH, label, card)
    after = zoo_after_fit(model, x, y, ZOO_WND_BATCH, ZOO_WND["class_num"],
                          label)
    model.set_feature_assembler(lambda u, i: wnd_features(rng, u, i))
    t0 = time.perf_counter()
    recs = model.recommend_for_user(
        7, 10, candidate_items=range(1, info["embed_in_dims"][1] + 1),
        batch_size=ZOO_WND_BATCH)
    rec_s = time.perf_counter() - t0
    if len(recs) != 10 or not all(1 <= r.prediction <= 5 for r in recs):
        fail(f"{label}: bad recommendations {recs[:3]}")
    return _report(label, {
        **summary, **after, "recommend_for_user_s": rec_s,
        "card_cpu_max_excess": check["max_excess"]})


def session_data(rng, n):
    """Sessions left-padded at random, whose next item follows from the
    last one (``last * 7 % items + 1``), with a 5-item history (padding
    id 0 among its slots)."""
    cfg = ZOO_SESSION
    items, length = cfg["item_count"], cfg["session_length"]
    s = rng.randint(1, items + 1, (n, length))
    cut = rng.randint(0, length - 2, n)
    s[np.arange(length)[None, :] < cut[:, None]] = 0
    h = rng.randint(0, items + 1, (n, cfg["history_length"]))
    return ({"session": s.astype(np.int32), "history": h.astype(np.int32)},
            ((s[:, -1] * 7) % items + 1).astype(np.int32))


def zoo_session(torch, card, device="cuda"):
    """The session recommender at 37483 items with the history MLP,
    batch 1024; then recommend_for_session on 256 sessions."""
    from analytics_zoo_tpu_torch.models import SessionRecommender
    from analytics_zoo_tpu_torch.models.recommendation import (
        session_recommender)

    label = "zoo session recommender"
    rng = np.random.RandomState(35)
    x, y = session_data(rng, ZOO_SESSION_BATCH * ZOO_STEPS)
    model = SessionRecommender(device=device, seed=0, **ZOO_SESSION)
    check = _card_cpu(torch, model._build_module, _rows(x, ZOO_CHECK_ROWS),
                      y[:ZOO_CHECK_ROWS], f"card vs cpu, {label}", card,
                      loss_fn=session_recommender._next_item_ce)
    summary = zoo_fit(torch, model, x, y, ZOO_SESSION_BATCH, label, card)
    after = zoo_after_fit(model, x, y, ZOO_SESSION_BATCH,
                          ZOO_SESSION["item_count"] + 1, label)
    t0 = time.perf_counter()
    recs = model.recommend_for_session(_rows(x, ZOO_SESSION_RECS),
                                       max_items=5)
    rec_s = time.perf_counter() - t0
    if len(recs) != ZOO_SESSION_RECS or any(
            len(r) != 5 or any(i == 0 for i, _ in r) for r in recs):
        fail(f"{label}: bad recommendations {recs[:2]}")
    return _report(label, {
        **summary, **after, "recommend_for_session_s": rec_s,
        "card_cpu_max_excess": check["max_excess"]})


def seq2seq_data(rng, n):
    """Sources of at most max_len ids (padded tails); the target is the
    source reversed, fed shifted behind start id 1."""
    length = ZOO_SEQ2SEQ["max_len"]
    src = rng.randint(2, ZOO_SEQ2SEQ["vocab"] + 1, (n, length))
    lens = rng.randint(length // 2, length + 1, n)
    src[np.arange(length)[None, :] >= lens[:, None]] = 0
    tgt = np.zeros_like(src)
    for i, k in enumerate(lens):
        tgt[i, :k] = src[i, :k][::-1]
    tgt_in = np.concatenate([np.ones((n, 1), src.dtype), tgt[:, :-1]], 1)
    return ({"src": src.astype(np.int32), "tgt_in": tgt_in.astype(np.int32)},
            tgt.astype(np.int32))


def infer_check(torch, model, src, label):
    """``infer`` on the card against ``infer`` of the same weights on
    the CPU: a row may differ only from a step where the CPU's top-two
    logit gap is below ZOO_TIE_GAP (each such step is printed)."""
    from analytics_zoo_tpu_torch.models import Seq2seq

    cpu = Seq2seq(device="cpu", **model._config)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                model.module.state_dict().items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = model.infer(src, start_id=1)
    secs = time.perf_counter() - t0
    want = cpu.infer(src, start_id=1)
    tgt = np.concatenate([np.ones((len(src), 1), np.int32), want[:, :-1]],
                         1)
    with torch.no_grad():
        logits = cpu.module({"src": torch.from_numpy(src),
                             "tgt_in": torch.from_numpy(tgt)}).numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    differ = tokens != want
    first = [(int(r), int(np.argmax(differ[r])))
             for r in np.flatnonzero(differ.any(1))]
    for r, t in first:
        print(f"{label}: row {r} differs from step {t}, where the CPU's "
              f"top-two gap is {gap[r, t]:.3g}", flush=True)
    bad = [(r, t, float(gap[r, t])) for r, t in first
           if not gap[r, t] < ZOO_TIE_GAP]
    if bad:
        fail(f"{label}: the card's tokens differ from the CPU's at steps "
             f"whose gap is at least {ZOO_TIE_GAP}: {bad}")
    return {"rows": len(src), "rows_differing": len(first),
            "min_cpu_gap": float(gap.min()), "infer_s": secs,
            "tokens_per_s": tokens.size / secs}


def zoo_seq2seq(torch, card, device="cuda"):
    """Seq2seq at the class defaults (embedding 128, one LSTM of 128,
    max_len 32) over a 20000-token vocabulary: a teacher-forced fit,
    batch 256; then infer on 64 sources, the card against the CPU."""
    from analytics_zoo_tpu_torch.models import Seq2seq

    label = "zoo seq2seq"
    rng = np.random.RandomState(36)
    x, y = seq2seq_data(rng, ZOO_SEQ2SEQ_BATCH * ZOO_STEPS)
    model = Seq2seq(device=device, seed=0, **ZOO_SEQ2SEQ)
    check = _card_cpu(torch, model._build_module, _rows(x, ZOO_CHECK_ROWS),
                      y[:ZOO_CHECK_ROWS], f"card vs cpu, {label}", card,
                      loss_fn=Seq2seq.default_loss)
    summary = zoo_fit(torch, model, x, y, ZOO_SEQ2SEQ_BATCH, label, card)
    # one batch: its logits alone are 0.6 GB on the host
    after = zoo_after_fit(model, x, y, ZOO_SEQ2SEQ_BATCH,
                          ZOO_SEQ2SEQ["max_len"], label, batches=1)
    infer = infer_check(torch, model, x["src"][:ZOO_INFER_ROWS],
                        f"{label} infer")
    return _report(label, {
        **summary, **after, "infer": infer,
        "card_cpu_max_excess": check["max_excess"]})


def taxi_series(rng):
    """A half-hourly series of 3 standardised features (a count with
    daily and weekly cycles and 10 spikes, the time of day, the
    weekday)."""
    n = ZOO_SERIES
    t = np.arange(n, dtype=np.float64)
    day, week = 48.0, 336.0
    count = (1.0 + 0.6 * np.sin(2 * np.pi * t / day)
             + 0.3 * np.sin(2 * np.pi * t / week) + 0.05 * rng.randn(n))
    count[rng.randint(0, n, 10)] += rng.choice([-1.5, 1.5], 10)
    data = np.stack([count, (t % day) / day, (t // day) % 7 / 7], 1)
    return ((data - data.mean(0)) / data.std(0)).astype(np.float32)


def zoo_anomaly(torch, card, device="cuda"):
    """The anomaly detector at the class defaults (LSTMs 8, 32, 15,
    dropouts 0.2, RMSprop): unroll 50 over the 10320-point series,
    batch 1024; predict every window, then detect_anomalies."""
    from analytics_zoo_tpu_torch.learn.objectives import mean_squared_error
    from analytics_zoo_tpu_torch.models import AnomalyDetector

    label = "zoo anomaly detector"
    rng = np.random.RandomState(37)
    x, y = AnomalyDetector.unroll(taxi_series(rng),
                                  ZOO_ANOMALY["feature_shape"][0])
    model = AnomalyDetector(device=device, seed=0, **ZOO_ANOMALY)
    if model.default_optimizer != "rmsprop":
        fail(f"{label}: optimizer {model.default_optimizer}")
    check = _card_cpu(torch, model._build_module, x[:ZOO_CHECK_ROWS],
                      y[:ZOO_CHECK_ROWS], f"card vs cpu, {label}", card,
                      loss_fn=mean_squared_error, train=False)
    summary = zoo_fit(torch, model, x, y, ZOO_ANOMALY_BATCH, label, card)
    after = zoo_after_fit(model, x, y, ZOO_ANOMALY_BATCH, 1, label)
    pred = model.predict(x, batch_size=ZOO_ANOMALY_BATCH)
    idx, threshold = AnomalyDetector.detect_anomalies(y, pred,
                                                      ZOO_ANOMALIES)
    if len(idx) != ZOO_ANOMALIES or not np.isfinite(threshold):
        fail(f"{label}: detect_anomalies gave {len(idx)} at {threshold}")
    return _report(label, {
        **summary, **after, "windows": len(x), "anomalies": idx.tolist(),
        "threshold": threshold, "card_cpu_max_excess": check["max_excess"]})


def zoo_serving(torch, card, device="cuda"):
    """A TextClassifier (CNN, the class defaults, 20 classes) saved by
    the port and served through launch() on the memory queue (batch
    32): 256 requests of 500 ids, each answer within CARD_CPU_TOL (1 +
    |x|) of predict's."""
    from analytics_zoo_tpu_torch.models import TextClassifier
    from analytics_zoo_tpu_torch.serving.launcher import launch

    label = "zoo text serving"
    docs, _ = text_data(np.random.RandomState(38), ZOO_SERVE_REQUESTS)
    model = TextClassifier(TEXT["classes"], vocab=TEXT["vocab"] - 1,
                           device=device, seed=0)
    want = model.predict(docs, batch_size=ZOO_SERVE_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        model.save_model(tmp)
        # ---- main path: launch -> ServingWorker -> InferenceModel ----
        t0 = time.perf_counter()
        app = launch({"model": {"path": tmp},
                      "params": {"batch_size": ZOO_SERVE_BATCH,
                                 "max_batch_size": ZOO_SERVE_BATCH,
                                 "timeout_ms": 2.0},
                      "http": {"enabled": False}}, device=device)
        up = time.perf_counter() - t0
        try:
            sent, got, lat = {}, {}, []
            t_start = time.perf_counter()
            for i in range(ZOO_SERVE_REQUESTS):
                uri = f"doc{i:03d}"
                sent[uri] = time.perf_counter()
                if not app.input_queue.enqueue(uri, ids=docs[i]):
                    fail(f"{label}: enqueue refused {uri}")
            deadline = time.perf_counter() + 120
            while len(got) < ZOO_SERVE_REQUESTS and \
                    time.perf_counter() < deadline:
                item = app.output_queue.dequeue(timeout=1.0)
                if item is None:
                    continue
                uri, tensors = item
                if uri in got:
                    fail(f"{label}: {uri} answered twice")
                lat.append(time.perf_counter() - sent[uri])
                got[uri] = tensors
            wall = time.perf_counter() - t_start
        finally:
            app.stop()
        # ---- end of the main path ----
    if len(got) != ZOO_SERVE_REQUESTS:
        fail(f"{label}: answered {len(got)}/{ZOO_SERVE_REQUESTS}")
    served = np.stack([np.asarray(got[f"doc{i:03d}"]["output"])
                       for i in range(ZOO_SERVE_REQUESTS)])
    if served.shape != want.shape:
        fail(f"{label}: replies {served.shape}, predict {want.shape}")
    excess = float((np.abs(served - want)
                    - CARD_CPU_TOL * (1 + np.abs(want))).max())
    lat_ms = np.asarray(lat) * 1e3
    summary = _report(label, {
        "requests": ZOO_SERVE_REQUESTS, "up_s": up, "wall_s": wall,
        "rps": ZOO_SERVE_REQUESTS / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "max_abs_diff": float(np.abs(served - want).max()),
        "max_excess": excess, "card": card})
    if not excess <= 0:
        fail(f"{label}: answers beyond {CARD_CPU_TOL} (1 + |x|) of "
             f"predict's by {excess:.3g}")
    return summary


def zoo_models_learn(torch, card, device="cuda"):
    """Phase 32 (see the module docstring). Returns the summaries."""
    from analytics_zoo_tpu_torch.common.config import get_config

    # no per-step host sync for logging, as in the other learn phases
    get_config().set("zoo.train.log_every_n_steps", 100000)
    out = {}
    for name, fn in (("text_classifier", zoo_text_classifiers),
                     ("knrm", zoo_knrm),
                     ("wide_and_deep", zoo_wide_and_deep),
                     ("session_recommender", zoo_session),
                     ("seq2seq", zoo_seq2seq),
                     ("anomaly_detector", zoo_anomaly),
                     ("serving", zoo_serving)):
        t0 = time.perf_counter()
        out[name] = fn(torch, card, device)
        print(f"zoo models: {name} {time.perf_counter() - t0:.1f}s "
              f"({card})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# phase 33: the image models (slice 4b) at the reference's full widths,
# seeded weights on synthetic images
BACKBONES = ("inception-v1", "inception-v3", "mobilenet", "mobilenet-v2",
             "vgg16", "vgg19", "alexnet", "squeezenet", "densenet121",
             "densenet161")
# the published input sizes: 299 x 299 for Inception-v3, 224 for the rest
BACKBONE_SIZE = {"inception-v3": 299}
BACKBONE_BATCH, BACKBONE_STEPS, BACKBONE_EPOCHS = 64, 8, 3
BACKBONE_PREDICT_ROWS = 256
# the card against the CPU: 8 rows at 96 x 96 (Inception-v3 139), where
# each net's last map is 3 x 3 (AlexNet's 2 x 2)
BACKBONE_CHECK_SIZE = {"inception-v3": 139}
BACKBONE_CHECK_ROWS, BACKBONE_CHECK_CLASSES = 8, 10
# the nets whose f32 train step on the card lay beyond CARD_CPU_TOL of
# the CPU's (PERF.md §6, with the CPU's own f32 against f64): held in
# f64, and their f32 step against the f64 one within F32_STEP_RATIO x
# the CPU's f32 deviation + F32_STEP_SLACK
BACKBONE_F64_STEP = ("inception-v1", "inception-v3", "mobilenet",
                     "mobilenet-v2", "vgg16", "vgg19", "densenet121",
                     "densenet161")
F32_STEP_RATIO, F32_STEP_SLACK = 2.0, 1e-6
# the detectors at their class defaults with PASCAL VOC's 20 classes
DETECT_CLASSES, DETECT_SIZE = 20, 128
SSD_BATCH, SSD_STEPS, SSD_EPOCHS = 64, 16, 2
DETECT_ROWS = 64
# detections compared between the card and the CPU at this threshold;
# Faster-RCNN's seeded 21-way scores sit near 1 / 21 and none reaches
# 0.1, so it takes 0.055 (about 960 detections on the CPU, 72 of them
# in classes without tied scores)
DETECT_THRESHOLD, DETECT_TOP_K = 0.1, 1000
FRCNN_THRESHOLD = 0.055
V2_SERVE_BATCH, V2_SERVE_REQUESTS = 128, 512


def forward_flops(torch, module, x) -> int:
    """2 x the multiply-adds of ``module``'s ``Conv`` and ``Dense`` layers
    on ``x``, counted from their shapes in one forward (a depthwise
    convolution's by group: in / groups inputs an output); pools, norms
    and elementwise work are not counted."""
    from analytics_zoo_tpu_torch.keras.layers.convolutional import Conv
    from analytics_zoo_tpu_torch.keras.layers.transformer import Dense

    total = [0]

    def conv(m, inputs, out):
        taps = int(np.prod(m.kernel))
        total[0] += 2 * out.numel() * m.weight.shape[1] * taps

    def dense(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv) else dense)
             for m in module.modules() if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def backbone_learn(torch, name, card, peaks, device="cuda"):
    """``ImageClassifier(1000, name, dtype="bfloat16")``, built on the
    card, through ZooModel.fit(device_cache=True): batch 64, 3 epochs of
    8 steps on seeded raw uint8 images (normalized on the card); then
    predict on 256 images and one profiled train step by kernel group.
    MFU is images/s x 3 x the forward's FLOPs (``forward_flops``)
    against the bf16 peak."""
    from analytics_zoo_tpu_torch.models import ImageClassifier

    size = BACKBONE_SIZE.get(name, IMAGE_SIZE)
    rng = np.random.RandomState(33)
    n = BACKBONE_BATCH * BACKBONE_STEPS
    x = rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)
    y = rng.randint(0, 1000, n).astype(np.int32)
    t0 = time.perf_counter()
    # built on the card: the seeded draw runs there (on the host VGG's
    # 139 M parameters take seconds)
    with torch.device(device):
        model = ImageClassifier(class_num=1000, backbone=name,
                                image_size=size, dtype="bfloat16",
                                device=device, seed=0)
    build_s = time.perf_counter() - t0
    off = [k for k, p in model.module.named_parameters()
           if p.device.type != model.device.type]
    if off:
        fail(f"{name}: parameters off the card: {off[:4]}")
    probe = torch.from_numpy(x[:1]).to(device)
    flops = forward_flops(torch, model.module, probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- main path: ZooModel.fit -> Estimator._fit_device_cached ----
    history = model.fit((x, y), batch_size=BACKBONE_BATCH,
                        epochs=BACKBONE_EPOCHS, device_cache=True)
    torch.cuda.synchronize()
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    losses = _finite_losses(history, name)
    best, median = _epoch_rates(history, n)
    t0 = time.perf_counter()
    pred = model.predict(x[:BACKBONE_PREDICT_ROWS], batch_size=BACKBONE_BATCH)
    predict_s = time.perf_counter() - t0
    if pred.shape != (BACKBONE_PREDICT_ROWS, 1000) or \
            not np.isfinite(pred).all():
        fail(f"{name} predict: bad output {pred.shape}")
    xb = torch.from_numpy(x[:BACKBONE_BATCH]).to(device)
    yb = torch.from_numpy(y[:BACKBONE_BATCH]).to(device)
    del x
    wall, busy, groups = profile_train_step(torch, model.estimator, xb, yb,
                                            kernel_groups=RESNET_GROUPS)
    return _report(f"{name} fit", {
        "image_size": size, "batch": BACKBONE_BATCH,
        "images_per_s": best, "median_images_per_s": median,
        "forward_gflop": flops / 1e9,
        "mfu": best * 3 * flops / peaks["bf16"],
        "median_mfu": median * 3 * flops / peaks["bf16"],
        "epoch_seconds": [h["seconds"] for h in history], "losses": losses,
        "peak_gib": peak / 2 ** 30, "build_s": build_s,
        "predict_images_per_s": BACKBONE_PREDICT_ROWS / predict_s,
        "params": sum(p.numel() for p in model.module.parameters()),
        "step_wall_ms": wall, "step_busy_ms": busy,
        "idle_share": 1 - busy / max(wall, 1e-9),
        "step_ms_by_group": {g: round(v, 4) for g, v in groups.items()},
        "card": card})


def _rel_dev(vals, truth):
    """Per group ("group name" keys), the relative deviation of
    ``vals`` from ``truth`` over all of the group's values: ||v - t|| /
    ||t|| with each norm taken over the group's arrays together."""
    err, ref = {}, {}
    for k, t in truth.items():
        group = k.split(" ")[0]
        err[group] = err.get(group, 0.0) + float(
            np.sum((np.asarray(vals[k], np.float64) - t) ** 2))
        ref[group] = ref.get(group, 0.0) + float(np.sum(np.square(t)))
    return {g: (err[g] / max(ref[g], 1e-60)) ** 0.5 for g in err}


def backbone_card_cpu(torch, name, card):
    """The backbone (10 classes, dropout 0, every BatchNorm drawn) on 8
    rows at 96 x 96 (Inception-v3 139), where its last map is 3 x 3
    (AlexNet's 2 x 2); the same seeded weights on the card and on the
    CPU, TF32 off. In f32: one train step's loss, gradients and
    BatchNorm statistics and then an eval forward, within CARD_CPU_TOL
    (1 + |cpu|). For the nets of BACKBONE_F64_STEP, whose f32 step on
    the card lay beyond that (PERF.md §6), the f32 reading is printed
    and the step is held twice: in f64 on the same weights within
    CARD_CPU_TOL, and the card's f32 step no farther from the f64 one,
    group by group, than F32_STEP_RATIO x the CPU's f32 step plus
    F32_STEP_SLACK (``_rel_dev``). Gradients that a downstream
    train-mode BatchNorm nearly cancels (it ignores its input's shift
    and scale) come out of f32 as small differences of large sums: their
    relative rounding is what parts two f32 runs."""
    from analytics_zoo_tpu_torch.models.image.classifier import (
        _BACKBONES, _SIZED)

    size = BACKBONE_CHECK_SIZE.get(name, 96)
    cls = _BACKBONES[name]
    kw = ({"image_size": size} if name in _SIZED else {})
    if "dropout_rate" in inspect.signature(cls).parameters:
        kw["dropout_rate"] = 0.0
    rng = np.random.RandomState(len(name))
    x = rng.randn(BACKBONE_CHECK_ROWS, size, size, 3).astype(np.float32)
    y = rng.randint(0, BACKBONE_CHECK_CLASSES,
                    BACKBONE_CHECK_ROWS).astype(np.int64)
    label = f"card vs cpu, {name}"
    cpu, gpu = _seeded_pair(
        torch, lambda: cls(num_classes=BACKBONE_CHECK_CLASSES, **kw), label,
        draw_norms=True)
    init = {k: v.double() for k, v in cpu.state_dict().items()}
    f32 = {dev: _step_values(torch, m, x, y)
           for dev, m in (("cpu", cpu), ("cuda", gpu))}
    if name not in BACKBONE_F64_STEP:
        check = _compare_card_cpu(f32, f"{label} (f32 step)", card,
                                  {"image_size": size})
        return {"f32_step": check["max_excess"]}
    reading = _worst_excess(f32["cuda"], f32["cpu"])
    f64 = {}
    for dev in ("cpu", "cuda"):
        m = cls(num_classes=BACKBONE_CHECK_CLASSES, dtype=torch.float64,
                **kw).double()
        m.load_state_dict(init)
        f64[dev] = _step_values(torch, m.to(dev), x.astype(np.float64), y)
    check = _compare_card_cpu(f64, f"{label} (f64 step)", card,
                              {"image_size": size})
    dev_card = _rel_dev(f32["cuda"], f64["cpu"])
    dev_cpu = _rel_dev(f32["cpu"], f64["cpu"])
    summary = _report(f"{label} (f32 step)", {
        "image_size": size,
        "max_excess": {g: [e, k] for g, (e, k) in reading.items()},
        "card_rel_dev_from_f64": dev_card, "cpu_rel_dev_from_f64": dev_cpu,
        "card": card})
    bad = {g: (d, dev_cpu[g]) for g, d in dev_card.items()
           if d > F32_STEP_RATIO * dev_cpu[g] + F32_STEP_SLACK}
    if bad:
        fail(f"{label}: the card's f32 step lies farther from the f64 "
             f"step than {F32_STEP_RATIO} x the CPU's + {F32_STEP_SLACK}: "
             f"{bad}")
    return {"f32_step": summary, "f64_step": check["max_excess"]}


def toy_scenes(rng, n, size=DETECT_SIZE, classes=DETECT_CLASSES):
    """``n`` dim noise images, each with one to three bright rectangles
    labelled with a foreground class (1..classes): (images, [(boxes,
    labels)])."""
    images = rng.rand(n, size, size, 3).astype(np.float32) * 0.1
    gt = []
    for img in images:
        boxes, labels = [], []
        for _ in range(rng.randint(1, 4)):
            w, h = rng.randint(size // 4, size // 2, 2)
            x1, y1 = rng.randint(0, size - w), rng.randint(0, size - h)
            img[y1:y1 + h, x1:x1 + w] = rng.rand(3) * 0.5 + 0.5
            boxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(rng.randint(1, classes + 1))
        gt.append((np.asarray(boxes, np.float32),
                   np.asarray(labels, np.int32)))
    return images, gt


def _cpu_twin(torch, model, cls, **cfg):
    """A CPU copy of ``model`` (a ZooModel on the card): the same class
    and configuration, the card's weights and statistics."""
    from analytics_zoo_tpu_torch.bridge import (load_flax_into,
                                                variables_from_module)

    twin = cls(device="cpu", **cfg)
    load_flax_into(twin.module, variables_from_module(model.module))
    return twin


def compare_detections(card_dets, cpu_dets, label,
                       threshold=DETECT_THRESHOLD):
    """The card's per-image detection lists against the CPU's: each
    (class, score, box) matched to one of the same class with score and
    box within CARD_CPU_TOL (1 + |cpu|); an entry without a match is
    allowed only where its score lies within the tolerance of the
    threshold (counted). Returns (detections, unmatched near it)."""
    near, total = 0, 0

    def close(a, b):
        return bool(np.all(np.abs(np.asarray(a) - np.asarray(b))
                           <= CARD_CPU_TOL * (1 + np.abs(np.asarray(b)))))

    def at_threshold(score):
        return abs(score - threshold) <= CARD_CPU_TOL * (1 + threshold)

    for card_img, cpu_img in zip(card_dets, cpu_dets):
        rest = list(cpu_img)
        total += len(cpu_img)
        for c, score, box in card_img:
            j = next((i for i, (c2, s2, b2) in enumerate(rest)
                      if c2 == c and close(score, s2) and close(box, b2)),
                     None)
            if j is not None:
                rest.pop(j)
            elif at_threshold(score):
                near += 1
            else:
                fail(f"{label}: the card's detection {(c, score)} has no "
                     "match on the CPU")
        for c, score, _ in rest:
            if not at_threshold(score):
                fail(f"{label}: the CPU's detection {(c, score)} has no "
                     "match on the card")
            near += 1
    return total, near


def untied_classes(probs, threshold):
    """Per image, the classes whose scores at or above ``threshold``
    (``probs`` [B, N, 1 + C], the CPU's) hold no two within CARD_CPU_TOL
    (1 + |score|) of each other: greedy NMS keeps either of two tied
    boxes, and which one it keeps changes what it suppresses next."""
    out = []
    for p in probs:
        keep = set()
        for c in range(1, p.shape[1]):
            sc = np.sort(p[:, c][p[:, c] >= threshold * (1 - CARD_CPU_TOL)])
            if not (np.diff(sc) <= CARD_CPU_TOL * (1 + sc[1:])).any():
                keep.add(c)
        out.append(keep)
    return out


def _max_excess(got, want):
    return float((np.abs(got - want)
                  - CARD_CPU_TOL * (1 + np.abs(want))).max())


def ssd_learn(torch, card, device="cuda"):
    """``ObjectDetector(20, image_size=128)`` at its default widths, f32:
    fit with the MultiBox loss on 1024 seeded toy scenes
    (``prepare_targets``), batch 64, 2 epochs of 16 steps, losses finite
    and falling; one profiled train step; then ``detect`` on 64 scenes,
    its raw outputs against the CPU twin's within CARD_CPU_TOL and the
    detection lists equal but for scores at the threshold."""
    from analytics_zoo_tpu_torch.models import ObjectDetector

    label = "ssd"
    cfg = dict(class_num=DETECT_CLASSES, image_size=DETECT_SIZE)
    rng = np.random.RandomState(35)
    x, gt = toy_scenes(rng, SSD_BATCH * SSD_STEPS)
    model = ObjectDetector(device=device, seed=0, **cfg)
    targets = model.prepare_targets(gt)
    if not (targets[0] > 0).any():
        fail(f"{label}: the matcher found no positive anchor")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- main path: ZooModel.fit -> Estimator.fit ----
    hist = model.fit((x, targets), batch_size=SSD_BATCH, epochs=SSD_EPOCHS)
    torch.cuda.synchronize()
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    losses = _finite_losses(hist, label)
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    xb = torch.from_numpy(x[:SSD_BATCH]).to(device)
    yb = tuple(torch.from_numpy(t[:SSD_BATCH]).to(device) for t in targets)
    wall, busy, groups = profile_train_step(torch, model.estimator, xb, yb,
                                            kernel_groups=RESNET_GROUPS)
    xd = x[:DETECT_ROWS]
    t0 = time.perf_counter()
    # ---- main path: ObjectDetector.detect ----
    dets = model.detect(xd, batch_size=DETECT_ROWS,
                        score_threshold=DETECT_THRESHOLD, top_k=DETECT_TOP_K)
    # ---- end of the main path ----
    detect_s = time.perf_counter() - t0
    twin = _cpu_twin(torch, model, ObjectDetector, **cfg)
    raw_card = model.predict(xd, batch_size=DETECT_ROWS)
    raw_cpu = twin.predict(xd, batch_size=DETECT_ROWS)
    excess = {k: _max_excess(g, w) for k, g, w in
              zip(("class_logits", "box_deltas"), raw_card, raw_cpu)}
    if max(excess.values()) > 0:
        fail(f"{label}: raw outputs beyond {CARD_CPU_TOL} (1 + |cpu|) of "
             f"the CPU's: {excess}")
    total, near = compare_detections(
        dets, twin.detect(xd, batch_size=DETECT_ROWS,
                          score_threshold=DETECT_THRESHOLD,
                          top_k=DETECT_TOP_K), label)
    return _report(label, {
        "batch": SSD_BATCH, "steps": model.estimator.global_step,
        "losses": losses,
        "samples_per_s": SSD_STEPS * SSD_BATCH / hist[-1]["seconds"],
        "peak_gib": peak / 2 ** 30, "anchors": int(len(model.anchors)),
        "step_wall_ms": wall, "step_busy_ms": busy,
        "idle_share": 1 - busy / max(wall, 1e-9),
        "step_ms_by_group": {g: round(v, 4) for g, v in groups.items()},
        "detect_images_per_s": DETECT_ROWS / detect_s,
        "raw_max_excess": excess, "detections": total,
        "unmatched_at_threshold": near, "card": card})


def frcnn_detect(torch, card, device="cuda"):
    """``FasterRCNN(20, image_size=128)`` at its defaults (width 64,
    top_k 64, pool 7), seeded: ``detect`` on 64 toy scenes and predict's
    images/s; against the CPU twin: the sorted top-K objectness values
    within CARD_CPU_TOL, and for each anchor both sides select the
    proposal, class logits and box deltas; an anchor only one side
    selects is allowed only where its objectness lies within the
    tolerance of the K-th value (counted). The uniform rectangles give
    equal objectness at many anchors, and ``torch.topk`` orders no
    ties, so the second stage is compared anchor by anchor: each side
    runs it on the anchors both selected, in one order. ``detect`` runs
    at FRCNN_THRESHOLD; its lists are held against the CPU twin's
    (``compare_detections``) on every image whose two top-K sets are
    equal (an image with a one-sided anchor decodes a proposal the
    other side has not), class by class where ``untied_classes`` finds
    no tied scores; the rest are counted."""
    from analytics_zoo_tpu_torch.models.image.faster_rcnn import FasterRCNN
    from analytics_zoo_tpu_torch.models.image.object_detection import (
        softmax_probs)

    label = "faster-rcnn"
    cfg = dict(class_num=DETECT_CLASSES, image_size=DETECT_SIZE)
    x, _ = toy_scenes(np.random.RandomState(36), DETECT_ROWS)
    model = FasterRCNN(device=device, seed=0, **cfg)
    model.predict(x, batch_size=DETECT_ROWS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        # ---- main path: ZooModel.predict ----
        out_card = model.predict(x, batch_size=DETECT_ROWS)
    predict_s = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    # ---- main path: FasterRCNN.detect ----
    dets = model.detect(x, batch_size=DETECT_ROWS,
                        score_threshold=FRCNN_THRESHOLD, top_k=DETECT_TOP_K)
    # ---- end of the main path ----
    detect_s = time.perf_counter() - t0
    if any(not np.isfinite(o).all() for o in out_card):
        fail(f"{label}: non-finite outputs")
    twin = _cpu_twin(torch, model, FasterRCNN, **cfg)
    k = model.module.top_k
    worst, one_side, matched, same_sets = {}, 0, 0, []
    with torch.no_grad():
        rpn = {dev: m.module.rpn(torch.from_numpy(x).to(m.device))
               for dev, m in (("cuda", model), ("cpu", twin))}
        top = {dev: [t.cpu().numpy() for t in torch.topk(r[1], k, dim=1)]
               for dev, r in rpn.items()}
        worst["topk_values"] = _max_excess(top["cuda"][0], top["cpu"][0])
        obj_cpu = rpn["cpu"][1].numpy()
        for b in range(len(x)):
            kth = top["cpu"][0][b, -1]
            sel = {dev: set(top[dev][1][b].tolist()) for dev in top}
            if sel["cuda"] == sel["cpu"]:
                same_sets.append(b)
            for a in sel["cuda"] ^ sel["cpu"]:
                if abs(obj_cpu[b, a] - kth) > CARD_CPU_TOL * (1 + abs(kth)):
                    fail(f"{label}: image {b} anchor {a} selected on one "
                         f"side only, objectness {obj_cpu[b, a]} against "
                         f"the K-th {kth}")
                one_side += 1
            # the second stage of the anchors both select, in one order
            common = sorted(sel["cuda"] & sel["cpu"])
            matched += len(common)
            outs = {}
            for dev, m in (("cuda", model), ("cpu", twin)):
                feat, _, dlt = rpn[dev]
                idx = torch.tensor([common], device=m.device)
                outs[dev] = [o.cpu().numpy() for o in m.module.second_stage(
                    feat[b:b + 1], dlt[b:b + 1], idx)]
            for name, oc, ou in zip(("proposals", "class_logits",
                                     "box_deltas"), outs["cuda"],
                                    outs["cpu"]):
                worst[name] = max(worst.get(name, -1.0), _max_excess(oc, ou))
    if max(worst.values()) > 0:
        fail(f"{label}: the card differs from the CPU beyond "
             f"{CARD_CPU_TOL} (1 + |cpu|): {worst}")
    cpu_dets = twin.detect(x, batch_size=DETECT_ROWS,
                           score_threshold=FRCNN_THRESHOLD,
                           top_k=DETECT_TOP_K)
    untied = untied_classes(softmax_probs(twin.predict(
        x, batch_size=DETECT_ROWS)[1]), FRCNN_THRESHOLD)
    lists = [[[d for d in side[b] if d[0] in untied[b]] for b in same_sets]
             for side in (dets, cpu_dets)]
    total, near = compare_detections(*lists, label,
                                     threshold=FRCNN_THRESHOLD)
    if total == 0:
        fail(f"{label}: no detection at {FRCNN_THRESHOLD} to compare")
    return _report(label, {
        "images": DETECT_ROWS, "top_k": k,
        "predict_images_per_s": DETECT_ROWS / predict_s,
        "detect_images_per_s": DETECT_ROWS / detect_s,
        "score_threshold": FRCNN_THRESHOLD,
        "detections": sum(map(len, dets)), "matched_proposals": matched,
        "one_side_at_kth": one_side, "max_excess": worst,
        "images_compared": len(same_sets),
        "tied_classes": sum(DETECT_CLASSES - len(untied[b])
                            for b in same_sets),
        "detections_compared": total,
        "unmatched_at_threshold": near, "card": card})


def mobilenet_v2_serving(torch, card, device="cuda"):
    """A seeded ImageClassifier(1000, "mobilenet-v2", dtype="bfloat16")
    saved and served through launch() (batch 128, pipeline depth 3): a
    closed burst of 512 raw uint8 224 x 224 requests, each answer within
    2e-2 (1 + |x|) of ``predict``'s."""
    from analytics_zoo_tpu_torch.models import ImageClassifier

    label = "mobilenet-v2 serving"
    images = np.random.RandomState(37).randint(
        0, 256, (V2_SERVE_REQUESTS, IMAGE_SIZE, IMAGE_SIZE, 3),
        dtype=np.uint8)
    model = ImageClassifier(class_num=1000, backbone="mobilenet-v2",
                            dtype="bfloat16", device=device, seed=0)
    want = model.predict(images, batch_size=V2_SERVE_BATCH)
    served, lat, wall, up, stats = serve_images(
        model, images, V2_SERVE_BATCH, IMAGE_SERVING_DEPTH, label, device)
    if served.shape != want.shape:
        fail(f"{label}: replies {served.shape}, predict {want.shape}")
    excess = float((np.abs(served - want)
                    - IMAGE_SERVE_TOL * (1 + np.abs(want))).max())
    lat_ms = np.asarray(lat) * 1e3
    summary = _report(label, {
        "requests": V2_SERVE_REQUESTS, "up_s": up, "wall_s": wall,
        "rps": V2_SERVE_REQUESTS / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "served_batches": stats["batches"],
        "max_abs_diff": float(np.abs(served - want).max()),
        "max_excess": excess, "card": card})
    if not excess <= 0:
        fail(f"{label}: answers beyond {IMAGE_SERVE_TOL} (1 + |x|) of "
             f"predict's by {excess:.3g}")
    return summary


def image_models_learn(torch, card, peaks, device="cuda"):
    """Phase 33 (see the module docstring). Returns the summaries."""
    from analytics_zoo_tpu_torch.common.config import get_config

    get_config().set("zoo.train.log_every_n_steps", 100000)
    out = {}
    steps = [(f"{name} fit", backbone_learn, (name, card, peaks, device))
             for name in BACKBONES]
    steps += [(f"{name} card vs cpu", backbone_card_cpu, (name, card))
              for name in BACKBONES]
    steps += [("ssd", ssd_learn, (card, device)),
              ("faster-rcnn", frcnn_detect, (card, device)),
              ("mobilenet-v2 serving", mobilenet_v2_serving, (card, device))]
    for key, fn, args in steps:
        t0 = time.perf_counter()
        out[key] = fn(torch, *args)
        print(f"image models: {key} {time.perf_counter() - t0:.1f}s "
              f"({card})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch (flash and "
                         "einsum attention), one SQuAD, one NER, one "
                         "MiniLM, one GPT-J-width LM and one 512-head LM "
                         "train step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "analytics_zoo_tpu_torch")):
        fail("analytics_zoo_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in name else "sxm"]
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          f"({fa.build_info['path']})", flush=True)
    for line in ptxas_lines(fa.build_info["log"]):
        print(f"  ptxas: {line}", flush=True)
    # ptxas' remark where it had to serialize a kernel's wgmmas
    serialized = [re.sub(r".*function '(\S+)'.*", r"\1", line) for line in
                  fa.build_info["log"].splitlines() if "serialized" in line]
    print(f"  ptxas: wgmma serialized in {len(serialized)} kernels"
          + "".join(f" {k[:90]}" for k in serialized), flush=True)

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"phase {name}: {time.perf_counter() - t:.1f}s ({card})",
              flush=True)
        return out

    timed("kernels", kernel_phase, torch, peaks)
    backward = timed("backward", backward_phase, torch, peaks,
                     BACKWARD_CASES, 1, "backward")
    _reset_launches(fa)
    ner = _pick(timed("masked kernels", backward_phase, torch, peaks,
                      MASKED_CASES, 2, "masked"), "ner_trained")
    print(_check_bf16_on_sm90("masked kernels", _launches(fa)), flush=True)
    runs = [timed("serving", bert_serving, torch, profile=args.profile)]
    squad = timed("learn", squad_learn, torch, profile=args.profile)
    with tempfile.TemporaryDirectory() as ner_dir:
        ner_fit = timed("NER learn", ner_learn, torch, ner_dir,
                        profile=args.profile)
        runs.append(timed("NER serving", ner_serving, torch, ner_dir))
    torch.cuda.empty_cache()
    k5b = timed("K5b kernels", k5b_phase, torch, peaks)
    _reset_launches(fa)
    k5b_bwd = timed("K5b backward kernels", k5b_bwd_phase, torch, peaks)
    print(_check_bf16_on_sm90("K5b backward kernels", _launches(fa)),
          flush=True)
    minilm = timed("MiniLM learn", minilm_learn, torch, profile=args.profile)
    torch.cuda.empty_cache()
    gens = [timed("generation, repo geometry", generation_phase, torch, "gen",
                  GEN_REPO, 500, (1, 240), 16, 500, 16),
            timed("generation, Phi-2 widths", generation_phase, torch,
                  "genfull", GEN_FULL, 32, (128, 2016), 32, 4, 16,
                  tie_gap=TIE_GAP, on_card=True)]
    # the Phi-2 phase's weights and pool (about 11 GB) go before Gemma's
    gc.collect()
    torch.cuda.empty_cache()
    wide = timed("K1 wide kernels", wide_phase, torch, peaks)
    gemma = timed("generation, Gemma-2B widths", generation_phase, torch,
                  "gengemma", GEN_GEMMA, 32, (128, 8160), 32, 4, 16,
                  tie_gap=TIE_GAP, on_card=True)
    # the Gemma phase's weights and pool (about 30 GB) go before the LM's
    gc.collect()
    torch.cuda.empty_cache()
    timed("K2/K3 wide kernels", wide_bwd_phase, torch, peaks)
    lm = timed("GPT-J-width LM learn", lm_learn, torch, profile=args.profile)
    # the LM's weights, gradients and Adam state (about 33 GB) go before
    # the DeepSeek-width phase's
    gc.collect()
    torch.cuda.empty_cache()
    wider = timed("K1 wider kernels", wider_phase, torch, peaks)
    deepseek = timed("generation, DeepSeek-V4-Flash widths, over HTTP",
                     generation_phase, torch, "gendeepseek", GEN_DEEPSEEK,
                     32, (128, 2016), 32, 4, 16, tie_gap=TIE_GAP, http=True,
                     n_logits=4, on_card=True)
    # the DeepSeek phase's weights and pool (about 32 GB) go before the
    # 512-head LM's
    gc.collect()
    torch.cuda.empty_cache()
    wider_bwd = timed("K2/K3 wider kernels", wide_bwd_phase, torch, peaks,
                      WIDER_BWD_SWEEP, WIDER_BWD_CASES, (20, 21), "wider-bwd",
                      WIDER_BWD_REPEAT)
    lm512 = timed("512-head LM learn", lm_learn, torch, base=LM512,
                  profile=args.profile, label="learn-lm512")
    gc.collect()
    torch.cuda.empty_cache()
    sm90 = timed("K1 sm90", sm90_phase, torch, peaks)
    sm90_bwd = timed("K2/K3 sm90", sm90_bwd_phase, torch, peaks)
    f32tc = timed("K2/K3 f32 tensor cores", f32tc_phase, torch, peaks)
    f32tc_fwd = timed("K1 f32 tensor cores", f32tc_fwd_phase, torch, peaks)
    # bench.py's other three workloads: no attention, no kernel of the
    # port's own (cuDNN convolutions, cuBLAS products, stock ops)
    gc.collect()
    torch.cuda.empty_cache()
    timed("NCF learn", ncf_learn, torch, card, peaks)
    timed("ResNet-50 learn", resnet_learn, torch, card, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    timed("ResNet-18 serving", image_serving, torch, card)
    timed("card against CPU", card_cpu_check, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    keras = timed("Keras BERT learn", keras_bert_learn, torch, card, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    timed("Keras text learn", keras_text_learn, torch, card, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    timed("zoo models learn", zoo_models_learn, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("image models learn", image_models_learn, torch, card, peaks)
    k5b_bf16, k5b_masked, k5b_padded = (
        _pick(k5b, "bf16_d80"), _pick(k5b, "minilm_masked"),
        _pick(k5b, "padded_d20"))
    mini, mini_padded = (_pick(k5b_bwd, "minilm_trained"),
                         _pick(k5b_bwd, "minilm_padded"))
    lm512_rec, wider384 = (_pick(wider_bwd, "lm512_trained"),
                           _pick(wider_bwd, "bf16_d384"))

    def at(rec, key, library_ms=None, library_device_ms=None, **extra):
        """A kernel's numbers at one timed ``backward_phase`` call (with
        its real keys, where the call is masked)."""
        out = {"shape": rec["shape"],
               **{k: rec[f"{key}_{k}"] for k in (
                   "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                   "bound_by", "fma_bound_ms")},
               "library_ms": library_ms,
               "library_device_ms": library_device_ms}
        if "real_keys" in rec:
            out.update(real_keys=rec["real_keys"], keys=rec["keys"])
        return dict(out, **extra)

    def lse_call(rec, **extra):
        """K1 with logsumexp at a trained call, beside SDPA's forward on
        inputs that need a gradient."""
        return at(rec, "k1_lse", rec["sdpa_fwd_ms"],
                  rec["sdpa_fwd_device_ms"],
                  max_abs_err=rec["k1_lse_out_max_abs_err"],
                  lse_max_abs_err=rec["k1_lse_max_abs_err"], **extra)

    def pick_keys(rec, *extra):
        """A timed ``timed_fwd_cases`` record's numbers."""
        return {key: rec[key] for key in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "fma_bound_ms", "library_ms",
            "library_device_ms", *extra)}

    def bwd_call(rec, key, **extra):
        """K2 or K3 at one timed call; SDPA's backward computes K2 + K3 +
        delta together (kept beside both rows, with the backend SDPA
        took)."""
        return at(rec, key, library_backward_ms=rec["sdpa_bwd_ms"],
                  library_backward_device_ms=rec["sdpa_bwd_device_ms"],
                  library_backend=rec["sdpa_backend"], **extra)

    def wide_row(name, replaces, key, fit, first, **calls):
        """K2's or K3's Hopper split template (bf16 above D = 256) at the
        call ``first``, with ``calls`` ({key: record}), launched by
        ``fit`` (its Hopper launches, every one at D = 512)."""
        counts = fit[key.upper()]
        return {"name": name, "route": "cuda", "source": SM90_BWD_SOURCE,
                "replaces": replaces, "launches": counts[4],
                **bwd_call(first, key),
                **{k: bwd_call(rec, key) for k, rec in calls.items()}}

    def f32tc_row(name, replaces, key):
        """K2 or K3's f32 tensor-core kernel at the BERT-base trained call
        (f32), with the NER trained call (masked), MiniLM's (K5b at
        D = 32) and the causal calls above 128, launched by the learn
        phases' f32 gradient checks (one f32 train step each, with and
        without the mask) and by the Keras BERT fit (phase 30)."""
        by_phase = {lbl: c[key.upper()][5]
                    for lbl, c in F32_CHECK_LAUNCHES.items()
                    if c[key.upper()][5]}
        by_phase["keras_bert_fit"] = keras["launches"]["fit"][key.upper()][5]
        trained = _pick(f32tc, "trained", "float32")
        return {"name": name, "route": "cuda", "source": F32TC_SOURCE,
                "replaces": replaces,
                "head_dims": [d for d in fa.HEAD_DIMS
                              if d <= fa.F32TC_MAX_D],
                "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase,
                **bwd_call(trained, key,
                           library_backward_kernels=trained[
                               "sdpa_bwd_kernels"]),
                "kv_mask_call": bwd_call(
                    _pick(f32tc, "ner_trained", "float32"), key,
                    replaces=K5A_REPLACES),
                "k5b_call": bwd_call(
                    _pick(f32tc, "minilm_trained", "float32"), key,
                    replaces=K5B_REPLACES),
                "k5b_mask_call": bwd_call(
                    _pick(f32tc, "minilm_padded", "float32"), key,
                    replaces=K5B_REPLACES),
                "cross_call": at(_pick(f32tc, "cross_causal", "float32"),
                                 key),
                **{f"d{d}_call": bwd_call(
                    _pick(f32tc, f"f32_d{d}", "float32"), key)
                   for d in (128, 192, 256, 384, 512)}}

    def f32tc_fwd_row():
        """K1's f32 tensor-core kernel at the BERT-base trained K1-lse
        call, with the served shape, the NER trained call (masked), the
        MiniLM calls (K5b at D = 32), cross-length causal,
        [8,8,2048,128] causal, the four f32 generation phases' prefill
        calls (the Gemma-width one with its K1-lse), the 512-head LM's
        K1-lse and [2,32,2048,384] causal; launched by those generation
        phases' prefills, the learn phases' f32 gradient checks and the
        Keras BERT fit and predict (phase 30)."""
        by_phase = {lbl: g["flash_f32tc_launches"] for lbl, g in zip(
            ("gen", "genfull", "gengemma", "gendeepseek"),
            (*gens, gemma, deepseek))}
        by_phase.update({lbl: c["K1"][5]
                         for lbl, c in F32_CHECK_LAUNCHES.items()
                         if c["K1"][5]})
        by_phase.update({f"keras_bert_{k}": c["K1"][5]
                         for k, c in keras["launches"].items()})
        lse_keys = ("lse_max_abs_err", "library_grad_ms",
                    "library_grad_device_ms", "library_backend")
        rec = {name: _pick(f32tc_fwd, name, "float32")
               for name, *_ in F32TC_FWD_CASES}
        return {"name": "flash_attn_fwd_f32tc", "route": "cuda",
                "source": F32TC_FWD_SOURCE, "replaces": K1_REPLACES,
                "head_dims": [d for d in fa.HEAD_DIMS
                              if d <= fa.F32TC_FWD_MAX_D],
                "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase,
                **pick_keys(rec["trained_lse"], *lse_keys),
                "served_call": pick_keys(rec["served"], "library_backend"),
                "kv_mask_call": dict(pick_keys(rec["ner_lse"], *lse_keys),
                                     replaces=K5A_REPLACES),
                "k5b_call": dict(pick_keys(rec["phi2_prefill"],
                                           "library_backend"),
                                 replaces=K5B_REPLACES),
                "k5b_lse_call": dict(pick_keys(rec["minilm_lse"], *lse_keys),
                                     replaces=K5B_REPLACES),
                "k5b_mask_call": dict(pick_keys(rec["minilm_padded_lse"],
                                                *lse_keys),
                                      replaces=K5B_REPLACES),
                "repo_call": dict(pick_keys(rec["repo_prefill"],
                                            "library_backend"),
                                  replaces=K5B_REPLACES),
                "cross_call": pick_keys(rec["cross_causal"],
                                        "library_backend"),
                "d128_call": pick_keys(rec["f32_d128"], "library_backend"),
                "d256_call": pick_keys(rec["gemma_prefill"],
                                       "library_backend"),
                "d256_lse_call": pick_keys(rec["gemma_lse"], *lse_keys),
                "d512_call": pick_keys(rec["deepseek_prefill"],
                                       "library_backend"),
                "d512_lse_call": pick_keys(rec["lm512_lse"], *lse_keys),
                "d384_call": pick_keys(rec["f32_d384"], "library_backend")}

    def sm90_bwd_row(name, replaces, key):
        """K2 or K3's Hopper kernel at the SQuAD fit's call, with
        [8,8,2048,128] and [4,16,2048,192] causal, the LM fit's call, the
        masked NER call (K5a) and the MiniLM calls (K5b, unmasked and
        padded), launched by the SQuAD, NER, MiniLM and LM fits."""
        by_phase = {"squad_fit": squad[key.upper()][4],
                    "ner_fit": ner_fit[key.upper()][4],
                    "minilm_fit": minilm[key.upper()][4],
                    "lm_fit": lm[key.upper()][4]}
        return {"name": name, "route": "cuda", "source": SM90_BWD_SOURCE,
                "replaces": replaces, "head_dims": list(fa.SM90_HEAD_DIMS),
                "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase,
                **bwd_call(_pick(sm90_bwd, "trained"), key),
                "d128_call": bwd_call(_pick(sm90_bwd, "bf16_d128"), key),
                "d192_call": bwd_call(_pick(sm90_bwd, "bf16_d192"), key),
                "lm_call": bwd_call(_pick(sm90_bwd, "gptj_trained"), key),
                "kv_mask_call": bwd_call(ner, key, replaces=K5A_REPLACES),
                "k5b_call": bwd_call(mini, key, replaces=K5B_REPLACES),
                "k5b_mask_call": bwd_call(mini_padded, key,
                                          replaces=K5B_REPLACES)}

    # K1's Hopper kernel at the served call ([32,12,512,64] bf16 views
    # into the qkv projection), with its logsumexp call at the SQuAD
    # fit's shape, [8,8,2048,d] causal at 256 and 192, the LM fit's
    # K1-lse ([4,16,2048,256] causal), the masked NER trained call
    # ([32,12,128,64], synthetic lengths in [2, 128]) with and without
    # logsumexp, K5b at [8,32,1024,80] causal, the MiniLM trained call's
    # K1-lse ([48,12,384,32]) unmasked and padded (lengths in [64, 384]),
    # the masked D = 32 call and the padded head dim 20; launched by
    # BERT-base and NER serving and the SQuAD, NER, MiniLM and LM fits.
    # K2 and K3's Hopper kernels at the trained call ([48,12,384,64]
    # bf16), with the masked NER trained call and K5b's backward at the
    # MiniLM trained call, unmasked and padded (sm90_bwd_row)
    sm90_launches = {"serving": runs[0][4], "ner_serving": runs[1][4],
                     "squad_fit": squad["K1"][4],
                     "ner_fit": ner_fit["K1"][4],
                     "minilm_fit": minilm["K1"][4], "lm_fit": lm["K1"][4],
                     "lm512_fit": lm512["K1"][4]}
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd_sm90", "route": "cuda",
        "source": SM90_SOURCE, "replaces": K1_REPLACES,
        "launches": sum(sm90_launches.values()),
        "launches_by_phase": sm90_launches,
        **pick_keys(_pick(sm90, "served"), "map_encode_us"),
        "lse_call": pick_keys(_pick(sm90, "trained_lse"), "lse_max_abs_err"),
        "d256_call": pick_keys(_pick(sm90, "bf16_d256")),
        "d192_call": pick_keys(_pick(sm90, "bf16_d192")),
        "trained_lse_call": pick_keys(_pick(sm90, "gptj_lse"),
                                      "lse_max_abs_err", "map_encode_us"),
        "kv_mask_call": at(ner, "k1", ner["sdpa_ms"], ner["sdpa_device_ms"],
                           replaces=K5A_REPLACES),
        "kv_mask_lse_call": lse_call(ner, replaces=K5A_REPLACES),
        "k5b_call": dict(pick_keys(k5b_bf16), replaces=K5B_REPLACES),
        "k5b_lse_call": lse_call(mini, replaces=K5B_REPLACES),
        "k5b_mask_lse_call": lse_call(mini_padded, replaces=K5B_REPLACES),
        "k5b_mask_call": {key: k5b_masked[key] for key in (
            "shape", "real_keys", "keys", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")} | {"replaces": K5B_REPLACES},
        "padded_call": dict(pick_keys(k5b_padded), replaces=K5B_REPLACES)},
        f32tc_fwd_row(),
        sm90_bwd_row("flash_attn_bwd_dq_sm90", K2_REPLACES, "k2"),
        sm90_bwd_row("flash_attn_bwd_dkv_sm90", K3_REPLACES, "k3"),
        f32tc_row("flash_attn_bwd_dq_f32tc", K2_REPLACES, "k2"),
        f32tc_row("flash_attn_bwd_dkv_f32tc", K3_REPLACES, "k3"),
        {
            # K1 f32 at D = 256: the full-width prefill call at Gemma-2B's
            # widths ([1,8,8192,256] f32, causal), launched by the Gemma
            # phase's prefills, on flash_attn_fwd_f32tc.cu (bf16 there is
            # flash_attn_fwd_sm90's)
            "name": "flash_attn_fwd_wide", "route": "cuda",
            "source": F32TC_FWD_SOURCE, "replaces": K1_REPLACES,
            "launches": gemma["flash_launches"],
            **pick_keys(_pick(wide, "gemma_prefill", "float32")),
            "lse_call": pick_keys(_pick(wide, "gemma_lse", "float32"),
                                  "lse_max_abs_err")},
        {
            # K1 bf16 at D = 512 (flash_fwd_sm90_split_kernel): the
            # prefill call at DeepSeek-V4-Flash's attention widths
            # ([1,64,2048,512], causal), launched (with logsumexp) by the
            # 512-head LM's fit; f32 there (the DeepSeek phase's prefills)
            # is flash_attn_fwd_f32tc's
            "name": "flash_attn_fwd_wider", "route": "cuda",
            "source": SM90_SOURCE, "replaces": K1_REPLACES,
            "launches": lm512["K1"][3],
            "lm_lse_launches": lm512["K1"][3],
            **pick_keys(_pick(wider, "deepseek_bf16"), "library_backend"),
            "lse_call": pick_keys(_pick(wider, "deepseek_bf16_lse"),
                                  "library_backend", "lse_max_abs_err"),
            "d384_call": pick_keys(_pick(wider, "bf16_d384"),
                                   "library_backend"),
            # K1-lse at the 512-head LM's trained call, the forward of its
            # fit
            "trained_lse_call": lse_call(lm512_rec)},
        # K2 and K3 bf16 at D = 512 (flash_bwd_{dq,dkv}_sm90_split_kernel):
        # the 512-head LM's trained call ([4,8,2048,512], causal, views),
        # launched by its fit
        wide_row("flash_attn_bwd_dq_wider", K2_REPLACES, "k2", lm512,
                 lm512_rec, d384_call=wider384),
        wide_row("flash_attn_bwd_dkv_wider", K3_REPLACES, "k3", lm512,
                 lm512_rec, d384_call=wider384)]}),
        flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
