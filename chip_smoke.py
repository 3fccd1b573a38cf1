"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

1. Device: the card's name and power limit (``nvidia-smi``), then every CUDA
   source of the port built with nvcc (one process per source, all at once).
2. Kernels against their plain PyTorch versions, on the card, at the
   paper's scale: ``sorted_probe`` over a sorted 176,929,690-entry digest
   plane (PubChem's count) with 477,123 queries (ChEMBL ∩ eMolecules), of
   which 435,413 (the extracted count) are drawn from the plane, over one
   of its 16 shards (11,058,106 entries, 29,820 queries), plus a 24-bit
   table with duplicate runs, each made a ``ProbeTable`` (its fences built
   once, counted) and searched on the route it takes (printed with the
   launches on it, the fence bytes and their share of the table), timed
   warm and cold (L2 flushed before each launch) with
   ``torch.searchsorted`` beside it the same two ways, and a serving
   request's shape (32 keys in a 100,000-entry plane), timed on the device
   with the calls queued behind a sleep (so the host's enqueue time is
   hidden), cold, and on the host per call; the store's served probe
   (``_probe_starts_device``) on every table, held to the plain version
   and timed on the host; beside the sector bound, the bytes of the
   fenced design's own node reads; ``hash_mix`` over
   the 1,048,576 x 128 verify batch that ``compare_ids_batch`` forms for
   435,413 pairs, the same rows at 32 and 64 lanes, the funnel's largest
   verify batch (4,096 x 128) and a slice 4 bytes off 16-byte alignment,
   each on its route, warm and cold.  Outputs must match bit for bit.
   ``tanimoto`` top-k against its plain version (run once a case, at its
   largest k, whose list in its total order holds every smaller k's as its
   first entries), scores as raw float32 bits and rows exactly, one launch
   a call, each k timed warm beside its bound (``kernels/work.py`` ``tanimoto_work``) and
   its share of it, with the plan's route, queries a block and slices:
   ``pubchem``, a plane of 176,929,690 random 1,024-bit fingerprints
   (22.6 GB, generated on the card in chunks) screened by 64 queries at
   k = 32 and 1,024; ``ties``, 4,194,304 rows drawn from 4,096 distinct
   fingerprints, shuffled, screened by 256 queries (rows of the plane,
   all-zero queries, random ones) at k = 1, 32, 1,024 and 2,048, and on
   its first 5,000 rows at k = 8,192 (k > N: pads, the sort route);
   ``served``, a 100,000-row plane at Q = 4 (a request) and k = 8, 32 and
   1,024, timed queued behind a sleep and on the host per call.  ``flash_attention``
   against its plain version in bfloat16 at the LM prefill's shape (yi-6b:
   B = 8, Hq = 32, Hkv = 4, S = 2,048, D = 128, causal) and at gemma3-12b's
   (B = 1, Hq = 16, Hkv = 8, S = 4,096, D = 256, window 1,024), both on
   the tensor-core route, held to the plain version's float32 output on
   the same values within 2^-8 |ref| + 2^-8 A(|v|) + 1e-4 (the bf16
   rounding of the output and of P; ``flash_attention_ref.bound_excess``),
   a bound that a variant losing one key tile must exceed, with
   ``torch.nn.functional.scaled_dot_product_attention`` timed beside it
   and its output read under the same bound and the output-cast-only one;
   also without the causal mask at whisper-small's encoder (B = 8, H =
   12, S = 1,500, D = 64: 11 key tiles and one of 92) and its cross
   attention (Sq = 416 against Skv = 1,500), SDPA timed without a mask;
   and at the served prefills of gemma3-12b (B = 8, Hq = 16, Hkv = 8, S =
   2,048, D = 256: window 1,024 and global), internvl2-76b (B = 8, Hq = 64, Hkv =
   8, S = 256 image positions + 2,048 = 2,304, D = 128, causal),
   qwen3-moe-235b-a22b (B = 8, Hq = 64, Hkv = 4: 16 query heads a KV head,
   S = 2,048, D = 128, causal) and jamba-1.5-large-398b's attention layer
   (B = 8, Hq = 64, Hkv = 8, S = 2,048, D = 128, causal), and at
   qwen2-72b's prefill_32k (B = 1, Hq = 64, Hkv = 8, S = 32,768, D = 128,
   causal), each timed warm and with L2 flushed before each launch.
   At every attention shape the kernel also runs as training calls it,
   writing the rows' log-sum-exp: the output must be bit-identical and the
   lse within 1e-5 (1 + |lse|) of ``attention_lse_ref`` (+inf exactly
   where a row sees no key).
   After the build, ptxas must report no spills in any of the seven
   sources,
   and ``cuobjdump -sass`` must show each redesigned kernel's instruction
   (``DESIGN_OPCODES``): ``HGMMA`` and ``UTMALDG`` in the tensor-core
   attention kernel and in both product kernels of its backward,
   ``LDGSTS`` (``cp.async``) in the staged kernel of ``hash_mix``.
   Prints each kernel's time, the plain version's, a PyTorch library
   call's where one computes the same function, and the least time the
   card could take (its bound).  ``ssd_scan`` against its plain version,
   bit for bit, in float32 at mamba2-1.3b's served prefill shape (BH =
   8 x 64 heads, C = 8 chunks of 256, P = 64, N = 128) and at one
   65,536-token prompt's (BH = 64, C = 256) and at jamba-1.5-large-398b's
   served prefill (BH = 8 x 256 heads, C = 8), warm and L2-cold; states
   from ``randn``, decay
   uniform in [0, 1); no PyTorch call computes the scan (``library_ms``
   null).  ``sample`` (``csrc/sample.cu``, the reference's
   ``jax.random.categorical`` draw, one launch) against its plain version
   at B = 8 and yi-6b's and gemma3-12b's vocabularies (V = 64,000 and
   262,144): the static engine's draw (one key split in place by the
   kernel; bf16 and f32) and the continuous engine's (per-lane seeds and
   token indices, a float32 draw from f32 or bf16 logits, without top-k,
   with its threshold given, found in the launch at k = 40 and at the cap
   of 256, and from ``torch.topk`` at 257).  The random bits and uniforms,
   which the kernel copies out for the check, must equal the plain
   version's bit for bit, the split key too, the arrival counters must
   read zero after each launch, and the tokens, of that launch and of one
   as served (no copy), must be equal except where the plain version's top
   two scores lie within ``SAMPLE_NEAR_TIE`` (printed).  Then the draws as
   the engines make them, through
   ``ops.sample`` (the threshold included): each timed queued behind a
   sleep (the wrapper's host time hidden, as in a CUDA graph), back to
   back and on the host, its kernels of one profiled call listed by name
   (a draw with top-k at most the cap must be one ``sample_kernel``),
   beside the bound (for the top-k draw: threefry of the logits kept and
   a compare of each logit), the kernel's threshold key compares, the
   plain version and
   ``torch.multinomial`` (not the same draw: ``library_ms`` null).
3. The funnel end to end on the card through ``repro_torch.launch.funnel``
   (corpus, index, publish, intersect, lookup_batch, extract + verify) at
   100,000 records, plus an extraction through 17-bit hashed keys whose
   collisions the device verifier must reject as the string verifier does,
   with every kernel's launch counts (in all, and per route) set to 0 just
   before and read just after: each kernel must have launched on that path.
   The 17-bit phase's mismatch count must equal ``HASHED_MISMATCHES`` and
   the count through an index built by one process on the same corpus,
   whose entries the pool build's must equal.  The funnel's §VI collision
   scan at the same 17-bit width (``scan_corpus`` == ``scan_pairs_sorted``,
   every mismatch inside its colliding group, Eq. 4 beside Eq. 5) and its
   Algorithm 1 baseline (``naive_scan`` == ``extract``, Eq. 2/3 projected
   to PubChem) are printed beside the pinned count, and ``digest_ids`` of
   the targets on the card must equal the CPU's bit for bit.
4. The query service on the funnel's corpus and store through
   ``repro_torch.launch.serve_index`` on the card (2 replicas, 8 clients,
   2 s per arm): lookup mode with its ``svc.fetch == serial extract``
   parity gate, and similarity mode at k = 8 with its ``svc.similar ==
   per-query similar_batch(probe="host")`` gate (the card's kernel against
   the host's plain version).  Launch counts are set to 0 before the phase
   and read after it: ``sorted_probe``, ``hash_mix`` and ``tanimoto`` must
   each have launched there (``sorted_probe``'s per route printed), and
   the fence builds over the phase must be at most the device tables its
   stores can upload.
5. A model check at full width: yi-6b cut to 2 layers, in float32 with
   TF32 off, weights made once and loaded into a card model and a CPU
   model; the prefill logits of two ragged prompts (at most 256 bytes, from
   the funnel's corpus) must agree within ``MODEL_ATOL``/``MODEL_RTOL``,
   and the card's prefill must have launched ``flash_attention`` once per
   layer.
6. LM serving through ``repro_torch.launch.serve.run``: yi-6b at its
   published widths and full depth (32 layers) in bfloat16, random weights
   drawn on the card from ``--seed``, 8 prompts cut from the funnel's
   corpus records to 17 ... 2,047 bytes (2,048 tokens with BOS, so the
   padded prefill is B = 8 x S = 2,048), 32 new tokens, ``max_len``
   4,096, served twice: the two runs must give the same tokens, and
   ``flash_attention`` must have launched exactly once per layer per
   prefill, all on the tensor-core route (launch counts set to 0 just
   before the phase).  The served engine decodes by replaying a CUDA
   graph (``Engine``'s default on the card: captured in the first run,
   whose warm-up and capture run the step's Python, so a kernel launched
   in decode would still be counted there).  Then a third
   ``generate`` of the served engine under ``torch.profiler``: for its
   prefill and its decode, the card's busy share and the kernels that take
   the most device time.  Then the same weights through an eager engine
   and the graph engine in turns (eager, graph, eager, graph: one
   process's runs differ by more than 10%), tokens identical across all
   four, each run's decode tokens/s, ITL p50/p99 and busy share (CUDA
   events around each step or replay: ``StepClock``), capture ms, replays
   and own peak, ``flash_attention`` once per layer per prefill and never
   in decode, and the eager engine under the profiler.  Then one reading
   of ``flags.DECODE_CHUNKED`` at ``max_len`` 16,384: the first decode
   step's bf16 logits chunked and one-pass against the same step in
   float32 (the chunked error at most ``CHUNKED_ERR_RATIO`` times the
   one-pass error) and graph decode tokens/s both ways.  The same weights then serve through
   ``ContinuousEngine`` (8 slots, blocks of 16 rows, ``max_len`` 2,080, the
   launcher's pool of 1,172 blocks; its greedy step a CUDA graph, every
   decode step a replay): 16 requests from 4 client threads,
   the 8 prompts and then 8 that reuse a block-aligned prefix of 1,024 or
   1,536 tokens of a long one, so prefix hits send ``lm_prefill_suffix``
   through ``flash_attention`` with ``Skv > Sq``.  TTFT and ITL p50/p99,
   tokens/s, the prefix hit rate and ``flash_attention`` launches split
   into full and suffix prefill (all on the tensor-core route) are
   printed, and after ``close(drain=True)`` ``BlockManager.check()`` must
   pass and no block may stay in use; then an eager and a graph
   ``ContinuousEngine`` (prefix cache off) serve the 8 prompts in turns,
   tokens identical, as above.  Then the same weights sampled
   (temperature ``SAMPLE_TEMPERATURE``): a static eager and graph engine in
   turns, then a continuous eager and graph engine (top-k
   ``SAMPLE_TOP_K``, per-request seeds) in turns, tokens identical within
   each engine and not all the greedy ones, tokens/s and ITL printed, the
   ``sample`` kernel's launches counted over the phase (a first token, an
   eager step, a capture's three steps; replays none).  Then parity in float32 (yi-6b at
   full width, 2 layers): the continuous engine's greedy tokens equal the
   static engine's, prefix on equals off (a differing token passes only
   where both tokens lie within ``NEAR_TIE`` of the top logit, printed),
   and suffix-prefill logits lie within ``SUFFIX_ATOL`` of full prefill's.
7. A model check of the SSM family, in float32 with TF32 off, weights
   made once and loaded into a card model and a CPU model: mamba2-1.3b at
   full width cut to 2 layers.  The prefill logits of two ragged corpus
   prompts (601 and 98 tokens) must agree within
   ``MODEL_ATOL``/``MODEL_RTOL``; ``ssd_scan`` must launch once per Mamba
   layer.  (The hybrid's check is step 9c's.)
8. SSM serving through ``repro_torch.launch.serve.run``: mamba2-1.3b at
   its published widths and full depth (48 layers, d_model 2,048, 64 SSD
   heads of 64, state 128), bfloat16, random weights drawn on the card
   from ``--seed``, the same 8 prompts as step 6, 32 new tokens, served
   twice: the two runs must give the same tokens, and ``ssd_scan`` must
   have launched exactly 48 times per prefill and never in decode (launch
   counts set to 0 just before the phase).  Then the served engine under
   ``torch.profiler`` and the eager/graph turns, as in step 6.
9. Encoder-decoder: whisper-small at full width cut to 2 encoder and 2
   decoder layers, float32 with TF32 off, one set of weights on the card
   and the CPU, the same seeded random frames (2 x 1,500 x 768) and two
   ragged corpus prompts: prefill logits, the loss and every parameter's
   gradient within ``MODEL_ATOL``/``MODEL_RTOL``, none zero on the card
   where the CPU's is not, 6 and 12 ``flash_attention`` launches.  Then
   whisper-small at its published size (12 + 12 layers, d_model 768,
   335,668,224 parameters), bf16, through ``launch.serve.run`` with zero
   frames (the audio frontend is a stub): the 8 prompts of step 6 cut to
   at most 415 bytes (416 tokens, so that 32 new tokens fit Whisper's
   448-token text context), served twice with the same tokens, 36
   tensor-core ``flash_attention`` launches a prefill (12 encoder, 12
   decoder self, 12 cross), the cross cache's bytes (12 x 2 x 8 x 12 x
   1,500 x 64 x 2 B), and the engine profiled and the eager/graph turns
   as in step 6 (the cross cache is a static buffer of the graph too).
9b. gemma3-12b and internvl2-76b.  The model check of step 5 at full width
   cut to 2 layers, float32: gemma3 with one window layer and one global
   layer (``local_block`` 2), its published window of 1,024 and a 1,401-token
   prompt that passes it (so the sliding mask and the prefill's ring layout
   run), internvl2 reading 256 seeded nonzero patch embeddings
   (``torch.Generator`` on the CPU) before the text; the logits and every
   layer's K/V cache within ``MODEL_ATOL``/``MODEL_RTOL``, 2
   ``flash_attention`` launches each.  Then served as in step 6, bf16:
   gemma3-12b at its published widths and full depth (48 layers; three
   prompts pass the window, so decode runs through the ring caches, whose
   slot the captured step reads from the position buffer) through
   ``launch.serve.run``, and internvl2-76b at its published widths cut to
   16 of its 80 layers (its config cut and handed to ``launch.serve.run``:
   the launcher has no depth option; the engine's stub feeds zero patch
   embeddings, positions start at 256):
   the same tokens over 2 runs, 48 and 16 tensor-core launches a prefill,
   none in decode, the profile and the eager/graph turns.  internvl2-76b's
   16 served layers (the same weights) then serve the 8 prompts through
   ``ContinuousEngine``, each behind its 256 image positions (``max_len``
   2,080 + 256, so the block tables hold them; prefix sharing off, as in
   the reference): every request completes, 16 tensor-core launches a
   prefill, every decode step a graph replay, SLO percentiles and
   ``counters()`` printed, a clean ``BlockManager.check()`` and no block in
   use after ``close(drain=True)``, and the eager/graph turns; and at 2
   layers in float32 the continuous engine's greedy tokens equal the
   static engine's (a differing token only at a printed near-tie).
9c. The hybrid and the 128-expert MoE at their published widths, cut in
   depth (``HYBRID_CHECK_CUT``, ``HYBRID_SERVE_CUT``: jamba's depth through
   its super-block, its layers those of the published one).  float32 card
   against CPU, weights drawn on the card and copied to the host (its
   ``MemAvailable`` printed first): jamba-1.5-large-398b's layers 2-3
   (Mamba + SwiGLU, attention + MoE; 11.9e9 parameters) on the 601- and
   98-token prompts (3 SSD chunks of 256), and qwen3-moe-235b-a22b at 2
   layers (128 experts of d_ff 1,536, top 8; 64 query heads of 128 to 4
   KV heads, a query width twice d_model): the router's top-k first (a
   flip passes only at a ``MOE_NEAR_TIE`` gap), then prefill logits and
   every layer's cache (K/V, and the Mamba layer's SSM state and
   convolution tail) within ``MODEL_ATOL``/``MODEL_RTOL``, dropped
   assignments equal, 1 + 1 and 2 kernel launches.  Then each served as in
   step 6, bf16: jamba's layers 0-3 (Mamba + SwiGLU, Mamba + MoE, Mamba +
   SwiGLU, attention + MoE; 45.96 GB: d_model 8,192, 256 SSD heads, 16
   experts of d_ff 24,576, top 2) with 1 tensor-core ``flash_attention``
   and 3 ``ssd_scan`` launches a prefill, and qwen3-moe at 8 of its 94
   layers (42.3 GB) with 8: the same tokens over 2 runs, none in decode,
   the profile, the eager/graph turns, and the graph decode's ITL beside
   the step's weight-read bound (the weights' bytes over 3.35 TB/s).
9d. The QKV-bias family: qwen2-72b and qwen1.5-110b.  Both inits draw the
   biases as zeros (the reference's), so every run here draws them after
   the init from N(0, 1), the size of a projection's output
   (``models.common.draw_qkv_biases``, which ``launch.serve.run`` calls
   after its init too).  The model check of step 5 at full width cut to 2
   layers, float32 (~17.0 and ~20.8 GB a side, drawn on the card and
   copied to the host): logits and every layer's K/V cache within
   ``MODEL_ATOL``/``MODEL_RTOL``, 2 ``flash_attention`` launches, and a
   negative control: layer 0's ``bv`` zeroed on the card, the logits must
   fall outside the tolerance (by how much, printed).  Then step 6's
   continuous parity for qwen2-72b at 2 layers, float32, prefix sharing on
   and off (``lm_prefill_suffix`` and ``lm_decode_step_paged`` carry the
   biases): the continuous engine's greedy tokens equal the static
   engine's and prefix on's equal off's (a differing token only at a
   printed near-tie), suffix-prefill logits within ``SUFFIX_ATOL`` of full
   prefill's.  Then both served as in step 6 at their published widths
   cut to 16 of their 80 layers, bf16, through ``launch.serve.run``
   (which draws the biases after its init): the weights' bytes equal
   the config's figures (``dense_weight_figures``, printed: parameters a
   layer, embedding and head), the same tokens over 2 runs, 16
   tensor-core launches a prefill and none in decode, the profile, the
   eager/graph turns and the graph ITL beside the weight-read bound.  On
   qwen2-72b's 16 served layers, its prefill_32k / decode_32k length: one
   prompt of 32,768 tokens (BOS and corpus records joined to 32,767 bytes)
   into a 32,800-row cache, 32 new tokens, served twice (the same tokens,
   16 tensor-core launches a prefill, prefill ms beside its compute bound,
   the two runs' own peak), then the eager/graph turns (tokens identical),
   the profile and the graph ITL beside the step's read bound (weights and
   cache).
10. MoE: moonshot-v1-16b-a3b at full width cut to 2 layers, float32, card
   against CPU: the router's top-6 experts first (flips only at a
   probability near-tie pass), then prefill logits within
   ``MODEL_ATOL``, dropped assignments on both sides.  Then the model at
   its published widths and full depth (48 layers, 64 experts of d_ff
   1,408, top-6), bf16, drawn on the card, served as in step 6 with
   ``max_len`` 2,080 (48 tensor-core ``flash_attention`` launches a
   prefill, the phase's own peak memory, dropped assignments), profiled,
   the eager/graph turns as in step 6 (the MoE dispatch has fixed shapes
   in decode, so it is captured),
   and 8 requests through ``ContinuousEngine`` on the same weights
   (prefix sharing off for MoE): every request completes; SLO percentiles.
11. Training.  In the kernel phase: ``ssd_scan``'s backward at
   mamba2-1.3b's training shape (BH = 4 x 64, C = 8, P = 64, N = 128):
   the states' gradient equals autograd through the plain version on the
   card bit for bit, the decay's within 1e-5 of its terms' magnitude, the
   backward launch timed warm and cold; ``flash_attention``'s backward
   kernel (``csrc/flash_attention_bwd.cu``, reached through autograd after
   the tensor-core forward) in bf16 at yi-6b's training shape (B = 4, Hq
   = 32, Hkv = 4, S = 2,048, D = 128, causal), at gemma3-12b's window (S
   = 4,096, D = 256, window 1,024), at its training step's window and
   global layers (B = 4, S = 2,048) and, without the causal mask, at
   whisper-small's encoder (B = 4, H = 12, S = 1,500, D = 64): one
   backward (three kernels), dq, dk, dv within
   ``grad_bound_excess(tensor_core=True)`` (the forward's bound plus the
   kernel's bf16 roundings of P and dS), a backward without ``D =
   rowsum(dO * O)`` and one that drops keys 0..63 outside it, two
   launches bit-identical, the lse held to its plain version; timed warm
   and cold beside the PyTorch-ops backward (the plain version) and
   SDPA's backward.  Then, after the MoE and QKV-bias phases: yi-6b,
   moonshot-v1-16b-a3b, mamba2-1.3b and qwen2-72b (its biases drawn as in
   step 9d, its batch 2 x 128 tokens: ``TRAIN_PARITY_SHORT``) at full
   width cut to 2 layers in float32, one train state, one batch: loss and every parameter's gradient card against CPU within
   ``MODEL_ATOL``/``MODEL_RTOL`` (the bias gradients' errors printed by
   name), none zero on the card where the CPU's is not, 2
   ``flash_attention`` or 3 ``ssd_scan`` launches a layer; ``Trainer`` on
   jamba's smoke config on the card crashes at step 3 and resumes from step 2's checkpoint bit
   for bit; and full-size training through ``launch.train``'s trainer
   (``build``, then ``Trainer.run``; B = 4 x 2,048 tokens of the
   index-backed corpus, bf16 compute over float32 masters and moments):
   mamba2-1.3b at 48 layers for 5 steps and yi-6b cut to 4 of its 32
   layers for 3 without a checkpoint (its 6.06B parameters with float32
   moments need about 97 GB: more than the card), under the remat policy
   "names" (the default), with step ms, tokens/s,
   peak memory, every kernel's launches a step (144 ``ssd_scan``, 8
   tensor-core ``flash_attention``, 4 backward kernels), one more step
   under the profiler (the attention backward's share, by span and by its
   kernels' names) and the final checkpoint's seconds
   and bytes (mamba2's; then deleted); then 3 more steps of the same state under
   "nothing" (no checkpoint), with the same launches a step (under both
   policies the attention forward and the scan run again in the backward:
   PERF.md's derivation), step ms, tokens/s and peak memory.  Then
   gemma3-12b cut to one published block (6 layers: 5 with the window of
   1,024, 1 global) for 2 steps the same way but without a checkpoint (its
   ~40 GB of state: the launcher's trainer stops after its last step as a
   run that dies there does), loss and gradient norm finite, 6 backward
   launches a step, 5 of them windowed, and 12 tensor-core forward
   launches.
12. Execution over a mesh, one process over a 1x1 ``DeviceMesh`` on a
   one-rank NCCL group.  (a) Right after step 6's continuous serving,
   yi-6b at full size through ``Engine(mesh=1x1, param_specs=...)`` on the
   weights step 6 served, wrapped as DTensors without a copy, the same 8
   prompts, twice: the tokens must equal step 6's, and ``flash_attention``
   must launch 32 times a prefill, all on the tensor-core route (counts
   set to 0 just before); prefill ms and decode tokens/s are printed
   beside step 6's, and the phase's own peak; the group is then
   destroyed, so none runs beside the unsharded phases.  After training,
   on a new one-rank group: (b) moonshot-v1-16b-a3b at full width cut to 2 layers, f32: the
   expert-parallel path at model = 1 against ``mesh=None`` on the same
   weights (router top-6 equal, logits within ``MODEL_ATOL``/``MODEL_RTOL``,
   dropped assignments equal); (c) ``Trainer.run`` with ``mesh=1x1``
   against ``mesh=None`` on mamba2-1.3b at full width cut to 2 layers,
   f32, 2 steps from one state, each run ending in its checkpoint (loss
   and grad norm within ``MODEL_ATOL``/``MODEL_RTOL``, the mesh run's
   checkpoint restores into an unsharded trainer equal to its state, 3
   ``ssd_scan`` launches a layer a step);
   (d) the dry-run (``launch/dryrun.py``, a fake process group, ``meta``
   tensors) on a 1-rank mesh for yi-6b's served prefill (B = 8 x S =
   2,048) and mamba2-1.3b's training step (B = 4 x 2,048): each
   ``step_time_lb`` is printed beside step 6's warm prefill and step 11's
   median step and may not exceed 1.05 x it; then yi-6b x ``train_4k`` on
   the 32 x 8 fake mesh, and its seconds.
13. A ``{"kernels": [...]}`` line, seven entries, the attention backward
   the sixth and ``sample`` the seventh (``launches`` summed over the
   paths; the backward's are training's, the sampler's the sampled
   serving phase's:
   ``hash_mix`` in the service, ``digest_ids`` and training's batch
   verify, ``flash_attention`` in yi-6b's static and continuous serving,
   whisper-small's, gemma3-12b's, internvl2-76b's static and continuous,
   jamba's, qwen3-moe's, qwen2-72b's (its 32,768-token prompt's too),
   qwen1.5-110b's, moonshot's, training (gemma3's included, as in
   the backward's) and the mesh phase, ``ssd_scan`` in mamba2's and
   jamba's serving, training and the mesh trainer; kernel bounds from
   ``repro_torch.kernels.work``, the dry-run's own formulas; ``tanimoto``'s
   numbers are the ``pubchem`` case at k = 1,024, where its plain version
   is timed), the card line, and as the last line ``{"ok": true,
   "device": {...}}``.
   Any failure exits non-zero before it.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

try:  # the kernels' work, as the dry-run counts it
    from repro_torch.kernels.work import (
        attention_bwd_work, attention_work, sample_select_work, sample_top_k_work,
        sample_work, scan_work)
except ImportError:  # run without the package: main() fails with the reason
    attention_bwd_work = attention_work = sample_select_work = sample_work = None
    sample_top_k_work = scan_work = None

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the HBM3
# rate, and the 32-bit integer rate: half the 67e12 FP32 CUDA-core rate,
# since a Hopper SM has 64 INT32 lanes against 128 FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

L2_FLUSH_BYTES = 256 << 20  # written between cold launches: 5x the H100's 50 MB L2
PUBCHEM = 176_929_690      # table entries (the paper's PubChem count)
QUERIES = 477_123          # ChEMBL ∩ eMolecules
FROM_PLANE = 435_413       # of which present in PubChem (the extracted count)
DUP_TABLE = 1 << 22        # the duplicate-run case: 24-bit digests
SHARDS = 16                # PubChem's plane as the funnel's save_sharded cuts it:
SHARD_ROWS = -(-PUBCHEM // SHARDS)  # 11,058,106 rows a shard
SHARD_QUERIES = QUERIES // SHARDS   # 29,820 keys a shard
VERIFY_ROWS = 1 << 20      # 2 x 435,413 rows bucketed to a power of two
VERIFY_LANES = 128         # 112 lanes (431-byte ids) bucketed
FUNNEL_VERIFY_ROWS = 4096  # the funnel's largest verify batch at 100,000 records
SERVE_PLANE = 100_000      # serving-shaped probe: the funnel store's plane ...
SERVE_KEYS = 32            # ... and a few dozen keys of a coalesced request
SLEEP_CYCLES = 20_000_000  # about 10 ms at 1.98 GHz: longer than a timed enqueue
HOST_CALLS = 10_000        # calls timed on the host's clock
HASH_OPS_PER_LANE = 19     # integer ops per (row, lane) in hash_mix's loop
FUNNEL_RECORDS = 100_000   # 8 files x 12,500 records, about 207 MB of SDF
# mismatches the funnel's 17-bit hashed-key phase rejects at seed 0: the
# count of a workers=1 index (the merge no longer depends on worker order)
HASHED_MISMATCHES = 405
FP_WORDS = 32              # 1,024-bit fingerprints (the store's default)
SIM_QUERIES = 64           # pubchem case: a service batch of queries
SIM_K = 32                 # the service's similar_top_k
SIM_K_LARGE = 1024         # a chemist's "1,000 nearest neighbours" request
SERVE_QUERIES = 4          # served tanimoto: a request's queries (the
SERVE_KS = (8, 32, 1024)   # service's load shape) at these k, on SERVE_PLANE rows
TIES_ROWS = 1 << 22        # ties case: 4,194,304 rows ...
TIES_DISTINCT = 4096       # ... drawn from 4,096 distinct fingerprints
TIES_QUERIES = 256
TIES_KS = (1, 32, 1024, 2048)
PADS_ROWS = 5_000          # ties plane cut to 5,000 rows ...
PADS_K = 8_192             # ... at k > N: pads, lists in global memory
BF16_FLOPS_PER_S = 989e12  # tensor-core bf16 peak (H100 SXM, dense)


class FaCase(NamedTuple):
    """A flash_attention case: Sq query rows, the last Sq positions of Skv
    keys (off = Skv - Sq).  ``paged``: k and v gathered from a shuffled
    block pool of CONT_BLOCK-row blocks (``paged_view``), as
    ``lm_prefill_suffix`` gathers them; otherwise every operand is a
    (B, S, H, D) projection viewed as (B, H, S, D)."""
    name: str
    b: int
    hq: int
    hkv: int
    sq: int
    skv: int
    d: int
    window: Optional[int] = None
    causal: bool = True
    paged: bool = False


FA_YI = FaCase("yi-6b", 8, 32, 4, 2048, 2048, 128)
FA_GEMMA = FaCase("gemma3-12b", 1, 16, 8, 4096, 4096, 256, window=1024)
FA_MOONSHOT = FaCase("moonshot-v1-16b-a3b", 8, 16, 16, 2048, 2048, 128)
# the served prefills of gemma3-12b (the 8 prompts padded to 2,048 tokens: a
# window layer and a global one) and internvl2-76b (256 image positions
# before them)
FA_GEMMA_SERVED = FaCase("gemma3-12b served", 8, 16, 8, 2048, 2048, 256, window=1024)
FA_GEMMA_SERVED_GLOBAL = FaCase("gemma3-12b served global", 8, 16, 8, 2048, 2048, 256)
FA_VLM_SERVED = FaCase("internvl2-76b served", 8, 64, 8, 2304, 2304, 128)
# the served prefills of qwen3-moe-235b-a22b (64 query heads to 4 KV heads:
# 16 a group) and of jamba-1.5-large-398b's attention layer (64:8)
FA_QWEN3_SERVED = FaCase("qwen3-moe-235b-a22b served", 8, 64, 4, 2048, 2048, 128)
FA_HYBRID_SERVED = FaCase("jamba-1.5-large-398b served", 8, 64, 8, 2048, 2048, 128)
# qwen2-72b's prefill_32k: one 32,768-token row, 64 query heads to 8 KV heads
FA_QWEN2_32K = FaCase("qwen2-72b prefill_32k", 1, 64, 8, 32768, 32768, 128)
FA_SUFFIX = (FaCase("yi-6b suffix", 1, 32, 4, 512, 2048, 128, paged=True),
             FaCase("yi-6b suffix short", 1, 32, 4, 48, 1072, 128, paged=True),
             FaCase("yi-6b suffix unaligned", 1, 32, 4, 208, 1248, 128, paged=True))
# whisper-small's prefill: the encoder over 1,500 frames (11 key tiles of
# 128 and one of 92, 92 query rows in the last tile) and the cross
# attention of the decoder's longest served prompt (WHISPER_PROMPT_BYTES + 1
# tokens) against them; D = 64, no mask
FA_WHISPER = (FaCase("whisper-small encoder", 8, 12, 12, 1500, 1500, 64, causal=False),
              FaCase("whisper-small cross", 8, 12, 12, 416, 1500, 64, causal=False))
# flash_attention in bfloat16 against the plain version's float32 output on
# the same values (``bound_excess`` of the plain version's module):
#   CUDA-core route: |err| <= u |ref| + atol, u = 2^-8 the bf16 cast's
#     rounding (half a step: 8 significant bits), atol = 1e-4 float32
#     arithmetic (the f32 card tests agree within 2e-5);
#   tensor-core route: |err| <= u |ref| + u A(|v|) + atol.  The kernel also
#     rounds each p_j to bf16 before P V, which moves p_j by at most u p_j
#     and the output by at most u sum_j p_j |v_j| / l = u A(|v|), where
#     A(|v|) = flash_attention_ref(q, k, |v|): derived from the arithmetic,
#     not fitted to the data.  SDPA's flash kernel rounds P the same way.
# A known-wrong variant, the plain version that loses the first FA_DROP keys
# of every row, must read above the bound used, or the check could not see
# a lost key tile.
FA_DROP = 64
F32_FLOPS_PER_S = 67e12    # float32 on the CUDA cores (H100 SXM)
# ssd_scan cases: (name, BH, C, P, N).  "prefill" is mamba2-1.3b's served
# prefill (B = 8 x 64 heads, padded S = 2,048 in chunks of 256); "long" one
# 65,536-token prompt (256 chunks)
SSD_PREFILL = ("prefill", 512, 8, 64, 128)
SSD_LONG = ("long-prompt", 64, 256, 64, 128)
# jamba-1.5-large-398b's served prefill: B = 8 x 256 SSD heads (d_inner
# 16,384 in heads of 64), the same 8 chunks
SSD_HYBRID = ("jamba prefill", 2048, 8, 64, 128)
MODEL_LAYERS = 2           # the model check's depth cut
SSM_MODEL_LENGTHS = (600, 97)  # prompt bytes: 601 tokens span 3 chunks of 256
MODEL_ATOL = MODEL_RTOL = 1e-3  # float32 logits, card vs CPU, 2 layers
CHUNKED_MAX_LEN = 16_384   # the long-context cache of the DECODE_CHUNKED reading
# chunked decode attention rounds its probabilities to bf16 once, as the
# one-pass path does, so its error against float32 is of the same size:
# at most twice the one-pass path's on the same step
CHUNKED_ERR_RATIO = 2.0
# jamba-1.5-large-398b (the hybrid family) and qwen3-moe-235b-a22b (128
# experts, top 8, a query width of 2 x d_model, 64:4 GQA) at their published
# widths, cut in depth: the whole of either does not fit one card (nor four:
# jamba's bf16 weights are 796 GB).  jamba's depth is cut through its
# super-block (both packages need n_layers % hybrid_block == 0), moe_every
# kept at 2 and attn_index set so that the layers are the published
# super-block's: its layers 2-3 for the f32 check (Mamba + SwiGLU, then
# attention + MoE: 11.9e9 parameters, ~47.6 GB a side), its layers 0-3
# served (Mamba + SwiGLU, Mamba + MoE, Mamba + SwiGLU, attention + MoE:
# 22.98e9 parameters, ~45.96 GB in bf16).  qwen3-moe: 2 layers checked, 8
# of its 94 served (21.15e9 parameters, ~42.3 GB in bf16).
HYBRID = "jamba-1.5-large-398b"
HYBRID_CHECK_CUT = dict(n_layers=2, hybrid_block=2, attn_index=1)
HYBRID_SERVE_CUT = dict(n_layers=4, hybrid_block=4, attn_index=3)
QWEN3_MOE = "qwen3-moe-235b-a22b"
QWEN3_MOE_SERVE_LAYERS = 8
# gemma3-12b and internvl2-76b on the card.  The model check cuts gemma3 to
# one window layer and one global layer (local_block 2, as the reference's
# smoke cut does), its window the published 1,024, and its long prompt
# passes the window; internvl2's prefill reads its published 256 image
# positions as seeded nonzero patch embeddings.  internvl2 is served cut to
# 16 of its 80 layers (the whole model's bf16 weights, ~152 GB, do not fit
# one card); gemma3 at full depth.
GEMMA = "gemma3-12b"
VLM = "internvl2-76b"
GEMMA_MODEL_LENGTHS = (1400, 97)
VLM_MODEL_LENGTHS = (255, 97)
VLM_SERVE_LAYERS = 16
SERVE_LENGTHS = (17, 64, 160, 384, 768, 1152, 1600, 2047)  # prompt bytes
SERVE_NEW_TOKENS = 32
SERVE_MAX_LEN = 4096
# the QKV-bias family at its published widths: qwen2-72b and qwen1.5-110b,
# 2 layers for the float32 checks (~17.0 and ~20.8 GB a side) and 16 of
# their 80 served in bf16 (~33.1 and ~48.5 GB; all 80 need ~140 and ~222
# GB).  Both inits draw zero biases (the reference's); every check and
# served run here draws them from N(0, 1) after the init (draw_qkv_biases), the
# size of a projection's output, so that a lost or misplaced bias moves the
# logits far outside the tolerance.  qwen2's prefill_32k / decode_32k
# length: one prompt of LONG_PROMPT_TOKENS (BOS and 32,767 corpus bytes)
# into a LONG_MAX_LEN cache, SERVE_NEW_TOKENS new tokens
QWEN2 = "qwen2-72b"
QWEN15 = "qwen1.5-110b"
QWEN_SERVE_LAYERS = 16
LONG_PROMPT_TOKENS = 32_768
LONG_MAX_LEN = LONG_PROMPT_TOKENS + SERVE_NEW_TOKENS
# sampled serving and the sampler kernel: the decode batch, a temperature
# and top-k, the static engine's seed and the requests' first seed
SAMPLE_ROWS = 8
SAMPLE_TEMPERATURE = 0.8
SAMPLE_TOP_K = 40
SAMPLE_SEED = 23
# the sampler's vocabularies: yi-6b's (the served sampled engines') and
# gemma3-12b's, the largest of the repo's configs
SAMPLE_VOCABS = ("yi-6b", "gemma3-12b")
# the kernel and the plain version may order two perturbed scores apart
# only where they lie within a few float32 ulps (the card's logf against
# PyTorch's log on the card, an ulp apart at most): the gap relative to
# max(1, |top score|), ``ref.top_two_gap``
SAMPLE_NEAR_TIE = 4 * 2.0**-23
# whisper-small is served within its published 448-token text context
# (arXiv:2212.04356): the prompts are cut to 415 bytes (416 tokens with
# BOS), so that prompt plus SERVE_NEW_TOKENS fits
WHISPER = "whisper-small"
WHISPER_TEXT_CTX = 448
WHISPER_PROMPT_BYTES = WHISPER_TEXT_CTX - SERVE_NEW_TOKENS - 1
WHISPER_LENGTHS = tuple(min(n, WHISPER_PROMPT_BYTES) for n in SERVE_LENGTHS)
PLANE_CHUNK = 1 << 23      # rows generated (and counted) per step on the card
PLAIN_ELEMS = 1 << 26      # (query, row) pairs per block of the plain version
# __popc throughput of compute capability 9.0: 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
M32 = 0xFFFFFFFF
SIGN = -(2**63)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int, flush: torch.Tensor, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, each timed
    alone (CUDA events) after ``flush`` (a buffer larger than the card's
    L2) is written, so that every call finds L2 cold."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls queued behind a
    sleep, so that the host's time to enqueue them is hidden."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn):
    """``(fn(), device milliseconds of that one call)`` (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def popc_per_s() -> float:
    """The card's __popc rate: 16 per clock per SM, at its maximum SM clock
    (``nvidia-smi clocks.max.sm``) over all its SMs."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def keys_to_pairs(keys: torch.Tensor) -> torch.Tensor:
    """Sign-flipped int64 keys → ``(N, 2)`` uint32 ``(hi, lo)`` pairs."""
    from repro_torch.kernels.hash_mix.ref import to_u32

    u = keys ^ SIGN
    return to_u32(torch.stack([(u >> 32) & M32, u & M32], dim=1)).contiguous()


def answer_sectors(keys: torch.Tensor, qk: torch.Tensor) -> int:
    """Distinct 32-byte table sectors that hold each query's answer: the
    keys at ``pos - 1`` and ``pos`` (``pos`` the lower bound), the two that
    any search must see to know that ``pos`` is the answer.  The fewest
    table bytes a lower-bound search of ``qk`` has to move, the bound's
    bytes for every route."""
    m = keys.numel()
    pos = torch.searchsorted(keys, qk)
    idx = torch.cat([pos[pos > 0] - 1, pos[pos < m]])
    return int(torch.unique(idx // 4).numel())


def search_sectors(keys: torch.Tensor, qk: torch.Tensor) -> int:
    """Distinct 32-byte table sectors the direct route's lower-bound search
    of ``qk`` reads (the bound's bytes before the fenced route).

    Replays the kernel's branch-free search (the step widths do not depend
    on the data, only the bases do) and counts the sectors it touches.
    """
    m = keys.numel()
    base = torch.zeros_like(qk)
    length = m
    touched = []
    while length > 1:
        half = length >> 1
        idx = base + (half - 1)
        touched.append(idx)
        base = torch.where(keys[idx] < qk, base + half, base)
        length -= half
    touched.append(base)
    return int(torch.unique(torch.cat(touched) // 4).numel())


def fenced_nodes(pt, qk: torch.Tensor):
    """Distinct fence nodes and table lines (``NODE_KEYS`` keys each) the
    fenced search of ``qk`` (sign-flipped int64 keys) reads: ``(at every
    level and the leaves, at level 1 and the leaves)``, the latter the two
    arrays of a PubChem-sized table that L2 cannot hold.  A replay of the
    kernel's walk."""
    from repro_torch.kernels.sorted_probe.kernel import NODE_KEYS, fence_levels
    from repro_torch.kernels.sorted_probe.ref import pairs_to_key

    b = NODE_KEYS
    fk = pairs_to_key(pt.fences)  # pads (all ones) flip to the largest int64
    levels, _ = fence_levels(pt.m)
    node = torch.zeros_like(qk)
    ar = torch.arange(b, device=qk.device)
    nodes = bottom = 0
    for depth, (off, _n) in reversed(list(enumerate(levels, start=1))):
        seen = int(torch.unique(node).numel())
        nodes += seen
        bottom += seen if depth == 1 else 0
        cnt = (fk[off + node[:, None] * b + ar] < qk[:, None]).sum(1)
        node = node * (b + 1) + cnt
    leaves = int(torch.unique(node).numel())
    return nodes + leaves, bottom + leaves


def probe_case(name, keys, qk, reps, note, flush, queued=False, host_calls=20):
    """Hold sorted_probe's kernel, on the route its ``ProbeTable`` takes, to
    its plain version on one table; time it and ``torch.searchsorted`` warm
    (or, for a call shorter than its enqueue, queued behind a sleep) and
    cold (L2 flushed before each launch), the wrapper and the store's
    served probe (``_probe_starts_device``) on the host, and the fences'
    build (a fenced-route table's only).  The bound counts the sectors
    that hold the answers (``answer_sectors``); the direct search's
    sectors, and on the fenced route the fenced design's node and line
    bytes, are printed beside it."""
    from repro_torch.core.store import _probe_starts_device
    from repro_torch.kernels.sorted_probe.kernel import (
        NODE_KEYS, ProbeTable, sorted_probe_cuda)
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

    table = keys_to_pairs(keys)
    queries = keys_to_pairs(qk)
    q, m = qk.numel(), keys.numel()
    builds = sorted_probe_cuda.fence_builds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt = ProbeTable(table)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    path = pt.route
    if sorted_probe_cuda.fence_builds != builds + (path == "fenced"):
        fail(f"sorted_probe {name}: the {path} table did not build its fences "
             f"{'once' if path == 'fenced' else 'not at all'}")
    routes = {r: getattr(sorted_probe_cuda, f"{r}_launches") for r in ("direct", "fenced")}
    before = (sorted_probe_cuda.launches, getattr(sorted_probe_cuda, f"{path}_launches"))
    f_k, p_k = sorted_probe_cuda(queries, pt)
    f_r, p_r = sorted_probe_ref(queries, table)
    torch.cuda.synchronize()
    after = (sorted_probe_cuda.launches, getattr(sorted_probe_cuda, f"{path}_launches"))
    if after != (before[0] + 1, before[1] + 1):
        fail(f"sorted_probe {name}: the call did not count one launch on the {path} route")
    if not (torch.equal(f_k, f_r) and torch.equal(p_k, p_r)):
        bad = int((f_k != f_r).sum() + (p_k != p_r).sum())
        fail(f"sorted_probe {name}: kernel disagrees with plain version ({bad} outputs)")
    err = int((p_k.to(torch.int64) - p_r.to(torch.int64)).abs().max())
    err = max(err, int((f_k != f_r).sum()))
    digests = (qk ^ SIGN).cpu().numpy().view(np.uint64)
    found, starts = _probe_starts_device(pt, digests)
    if not (np.array_equal(found, f_r.cpu().numpy())
            and np.array_equal(starts, p_r.cpu().numpy())):
        fail(f"sorted_probe {name}: the store's served probe disagrees with the plain version")
    kernel = lambda: sorted_probe_cuda(queries, pt)  # noqa: E731
    library = lambda: torch.searchsorted(keys, qk)  # noqa: E731
    warm = queued_ms if queued else cuda_ms
    ms = warm(kernel, reps)
    cold = cold_ms(kernel, 20, flush)
    plain = cuda_ms(lambda: sorted_probe_ref(queries, table), 3, warmup=1)
    lib_ms = warm(library, reps)
    lib_cold = cold_ms(library, 20, flush)
    served = host_us(lambda: _probe_starts_device(pt, digests), host_calls)
    host = (f" host_us={host_us(kernel, host_calls):.3f} "
            f"library_host_us={host_us(library, host_calls):.3f} "
            f"probe_starts_device_host_us={served:.3f}")
    io = q * (8 + 1 + 4)  # queries in, positions and flags out
    sectors = answer_sectors(keys, qk)
    nbytes = sectors * 32 + io
    # a comparison search needs ceil(log2(M + 1)) compares a query, each
    # 3 int32 operations on a 64-bit key
    b, by = bound_ms(nbytes, q * m.bit_length() * 3)
    direct_sectors = search_sectors(keys, qk)
    direct_bound, _ = bound_ms(direct_sectors * 32 + io,
                               q * (max(1, (m - 1).bit_length()) + 1) * 3)
    if path == "fenced":
        all_nodes, bottom_nodes = fenced_nodes(pt, qk)
        fenced = (f"fenced_design_bytes={all_nodes * NODE_KEYS * 8 + io} (level 1 "
                  f"and leaves: {bottom_nodes * NODE_KEYS * 8 + io})")
    else:
        fenced = "fenced_design_bytes=n/a (direct route)"
    hits = int(f_k.sum())
    how = "queued" if queued else "warm"
    print(f"sorted_probe[{name}]: M={m} Q={q} hits={hits} {note} route={path} "
          f"launches direct={sorted_probe_cuda.direct_launches - routes['direct']} "
          f"fenced={sorted_probe_cuda.fenced_launches - routes['fenced']} "
          f"fence_bytes={pt.fence_bytes} fence_share={pt.fence_bytes / (8 * m):.4f} "
          f"(nodes of {NODE_KEYS} keys, built in {build_ms:.3f} ms host clock) "
          f"bit-exact; kernel_ms={ms:.6f} ({how}) "
          f"kernel_cold_ms={cold:.6f} plain_ms={plain:.6f} "
          f"library_ms(searchsorted)={lib_ms:.6f} ({how}) "
          f"library_cold_ms={lib_cold:.6f}{host} answer_sectors={sectors} "
          f"bytes={nbytes} bound_ms={b:.6f} ({by}) share_of_bound={b / ms:.3f} "
          f"direct_search_sectors={direct_sectors} (bytes "
          f"{direct_sectors * 32 + io}, bound_ms {direct_bound:.6f}) {fenced}",
          flush=True)
    del table, queries, pt
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b,
                bound_by=by, max_abs_err=err)


def hash_case(name, x, reps, flush):
    """Hold hash_mix's kernel to its plain version bit for bit on ``x``, on
    the route the wrapper picks; time it warm and cold."""
    from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda, route
    from repro_torch.kernels.hash_mix.ref import hash_mix_ref

    n, w = x.shape
    path = route(w, x.data_ptr())
    on_route = getattr(hash_mix_cuda, f"{path}_launches")
    out_k = hash_mix_cuda(x)
    out_r = hash_mix_ref(x)
    torch.cuda.synchronize()
    if getattr(hash_mix_cuda, f"{path}_launches") != on_route + 1:
        fail(f"hash_mix {name}: the launch left the {path} route")
    a = out_k.view(torch.int32).to(torch.int64) & M32
    b = out_r.view(torch.int32).to(torch.int64) & M32
    err = int((a - b).abs().max())
    if err != 0:
        fail(f"hash_mix {name}: kernel disagrees with plain version (max_abs_err {err})")
    ms = cuda_ms(lambda: hash_mix_cuda(x), reps)
    cold = cold_ms(lambda: hash_mix_cuda(x), 20, flush)
    plain = cuda_ms(lambda: hash_mix_ref(x), 2, warmup=1)
    nbytes = n * w * 4 + n * 16
    ops = n * w * HASH_OPS_PER_LANE
    bnd, by = bound_ms(nbytes, ops)
    print(f"hash_mix[{name}]: N={n} W={w} route={path} bit-exact; "
          f"kernel_ms={ms:.6f} (warm) kernel_cold_ms={cold:.6f} "
          f"plain_ms={plain:.6f} library_ms=null bytes={nbytes} ops={ops} "
          f"bound_ms={bnd:.6f} ({by}) share_of_bound={bnd / ms:.3f}", flush=True)
    del out_k, out_r, a, b
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def random_u32(g, shape, dev) -> torch.Tensor:
    from repro_torch.kernels.hash_mix.ref import to_u32

    return to_u32(torch.randint(0, 2**32, shape, generator=g, device=dev,
                                dtype=torch.int64)).contiguous()


def tanimoto_case(name, q, db, dc, ks, reps, popc_rate, served=False):
    """Hold tanimoto's kernel to its plain version, bit for bit, at each k,
    one launch a call; time each k warm (or, ``served``, queued behind a
    sleep, and on the host per call) beside its bound, with the plan it
    took.  The plain version runs once, at the largest k, and is timed
    there: its list is in one total order (score descending, then row
    ascending; pads last), checked here, so its first k entries are its
    top-k for every smaller k (over the PubChem plane one plain call takes
    ~42 s whatever k).  Returns the largest k's numbers."""
    from repro_torch.kernels.tanimoto.kernel import plan, tanimoto_topk_cuda
    from repro_torch.kernels.tanimoto.ref import (
        PAD_INDEX, pack_keys, row_counts, tanimoto_topk_ref)
    from repro_torch.kernels.work import tanimoto_work

    qc = row_counts(q)
    n, w = db.shape
    nq = q.shape[0]
    chunk = max(1 << 16, PLAIN_ELEMS // nq)  # bounds the plain version's blocks
    top = max(ks)
    (s_all, i_all), plain = timed(
        lambda: tanimoto_topk_ref(q, db, top, qc, dc, db_chunk=chunk))
    real = i_all != PAD_INDEX
    keys = pack_keys(s_all.clamp(min=0.0), i_all.clamp(min=0))
    ordered = (keys[:, 1:] < keys[:, :-1]) | ~real[:, 1:]
    if not bool((ordered & (real[:, :-1] | ~real[:, 1:])).all()):
        fail(f"tanimoto {name}: the plain version's top-{top} is not in its total "
             "order (score descending, row ascending, pads last)")
    del keys, ordered, real
    out = None
    for k in sorted(ks, reverse=True):
        before = tanimoto_topk_cuda.launches
        s_k, i_k = tanimoto_topk_cuda(q, db, k, qc, dc)
        torch.cuda.synchronize()
        if tanimoto_topk_cuda.launches != before + 1:
            fail(f"tanimoto {name} k={k}: the call did not count one launch")
        s_r, i_r = s_all[:, :k], i_all[:, :k]
        bits_k, bits_r = s_k.view(torch.int32), s_r.contiguous().view(torch.int32)
        if not (torch.equal(bits_k, bits_r) and torch.equal(i_k, i_r)):
            bad = int((bits_k != bits_r).sum() + (i_k != i_r).sum())
            fail(f"tanimoto {name} k={k}: kernel disagrees with plain version "
                 f"({bad} outputs)")
        err = float((s_k - s_r).abs().max())
        ties = int((s_k[:, 1:] == s_k[:, :-1]).sum()) if k > 1 else 0
        kernel = lambda: tanimoto_topk_cuda(q, db, k, qc, dc)  # noqa: E731
        ms = queued_ms(kernel, reps) if served else cuda_ms(kernel, reps, warmup=1)
        host = f" host_us={host_us(kernel, HOST_CALLS):.3f}" if served else ""
        ops, nbytes = tanimoto_work(nq, n, w, k)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / popc_rate * 1e3
        b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        p = plan(nq, n, w, k)
        print(f"tanimoto[{name}]: N={n} W={w} Q={nq} k={k} bit-exact "
              f"({ties} equal-score neighbours in the top-k); route={p.route} "
              f"queries_per_block={p.qpb} slices={p.slices} width={p.width}; "
              f"kernel_ms={ms:.6f} ({'queued' if served else 'warm'}){host} "
              f"plain_ms={plain:.6f} (one call at k={top}, its first {k} entries "
              f"held here) library_ms=null bytes={nbytes} "
              f"popcounts={ops} popc_per_s={popc_rate:.4g} bound_ms={b:.6f} ({by}) "
              f"share_of_bound={b / ms:.4f}", flush=True)
        if out is None:
            out = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                       bound_by=by, max_abs_err=err)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del s_k, i_k, s_r, i_r, bits_k, bits_r
    del s_all, i_all
    return out


def tanimoto_phase(seed: int):
    """``pubchem`` and ``ties`` cases of the tanimoto kernel."""
    from repro_torch.kernels.tanimoto.ref import row_counts

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    rate = popc_per_s()

    # -- pubchem: the plane at PubChem's row count, generated in chunks -----
    t0 = time.perf_counter()
    db = torch.empty((PUBCHEM, FP_WORDS), dtype=torch.uint32, device=dev)
    dc = torch.empty(PUBCHEM, dtype=torch.int32, device=dev)
    for lo in range(0, PUBCHEM, PLANE_CHUNK):
        hi = min(lo + PLANE_CHUNK, PUBCHEM)
        chunk = random_u32(g, (hi - lo, FP_WORDS), dev)
        db.view(torch.int32)[lo:hi].copy_(chunk.view(torch.int32))
        dc[lo:hi] = row_counts(chunk)
        del chunk
    q = random_u32(g, (SIM_QUERIES, FP_WORDS), dev)
    rows = torch.randint(0, PUBCHEM, (SIM_QUERIES // 4,), generator=g, device=dev)
    q.view(torch.int32)[: SIM_QUERIES // 4] = db.view(torch.int32)[rows]
    torch.cuda.synchronize()
    print(f"tanimoto[pubchem]: plane {PUBCHEM} x {FP_WORDS} words "
          f"({PUBCHEM * (4 * FP_WORDS + 4)} bytes) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    main = tanimoto_case("pubchem", q, db, dc, (SIM_K, SIM_K_LARGE), reps=3,
                         popc_rate=rate)
    del db, dc, q, rows
    torch.cuda.empty_cache()

    # -- ties: 4,096 distinct fingerprints, each about 1,024 times ----------
    base = random_u32(g, (TIES_DISTINCT, FP_WORDS), dev)
    base.view(torch.int32)[0] = 0  # all-zero rows: u = 0 against zero queries
    pick = torch.randint(0, TIES_DISTINCT, (TIES_ROWS,), generator=g, device=dev)
    db = base.view(torch.int32)[pick].view(torch.uint32).contiguous()
    dc = row_counts(db)
    q = random_u32(g, (TIES_QUERIES, FP_WORDS), dev)
    qi = q.view(torch.int32)
    qi[: TIES_QUERIES // 2] = db.view(torch.int32)[
        torch.randint(0, TIES_ROWS, (TIES_QUERIES // 2,), generator=g, device=dev)]
    qi[TIES_QUERIES // 2: TIES_QUERIES // 2 + 16] = 0
    tanimoto_case("ties", q, db, dc, TIES_KS, reps=3, popc_rate=rate)
    # k > N on the plane's first rows: pads, and lists too long for shared
    # memory even at one query per warp
    head = db[:PADS_ROWS].contiguous()
    tanimoto_case("ties-pads", q, head, dc[:PADS_ROWS].contiguous(), (PADS_K,),
                  reps=3, popc_rate=rate)
    del base, pick, db, dc, q, qi, head
    torch.cuda.empty_cache()

    # -- served: a similarity request against a store shard's plane --------
    db = random_u32(g, (SERVE_PLANE, FP_WORDS), dev)
    dc = row_counts(db)
    q = random_u32(g, (SERVE_QUERIES, FP_WORDS), dev)
    q.view(torch.int32)[: SERVE_QUERIES // 2] = db.view(torch.int32)[
        torch.randint(0, SERVE_PLANE, (SERVE_QUERIES // 2,), generator=g, device=dev)]
    tanimoto_case("served", q, db, dc, SERVE_KS, reps=100, popc_rate=rate,
                  served=True)
    del db, dc, q
    return main


def kernel_phase(seed: int):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def rand_keys(n, bits=32):
        halves = torch.randint(0, 2**bits, (n, 2), generator=g, device=dev,
                               dtype=torch.int64)
        return ((halves[:, 0] << 32) | halves[:, 1]) ^ SIGN

    # -- sorted_probe at PubChem scale ---------------------------------------
    keys = torch.sort(rand_keys(PUBCHEM)).values
    pick = torch.randint(0, PUBCHEM, (FROM_PLANE,), generator=g, device=dev)
    qk = torch.cat([keys[pick], rand_keys(QUERIES - FROM_PLANE)])
    qk = qk[torch.randperm(QUERIES, generator=g, device=dev)]
    main = probe_case("pubchem", keys, qk, reps=50, note="(1.42 GB plane)",
                      flush=flush)
    del keys, pick, qk

    # -- sorted_probe on one of PubChem's 16 shards (save_sharded(n_shards=16))
    keys = torch.sort(rand_keys(SHARD_ROWS)).values
    pick = torch.randint(0, SHARD_ROWS, (FROM_PLANE // SHARDS,), generator=g, device=dev)
    qk = torch.cat([keys[pick], rand_keys(SHARD_QUERIES - FROM_PLANE // SHARDS)])
    qk = qk[torch.randperm(SHARD_QUERIES, generator=g, device=dev)]
    probe_case("shard", keys, qk, reps=200, note="(88.5 MB: one of 16 shards)",
               flush=flush, queued=True)
    del keys, pick, qk

    # -- sorted_probe on 24-bit digests: duplicate runs -----------------------
    narrow = torch.randint(0, 1 << 24, (DUP_TABLE,), generator=g, device=dev)
    keys = torch.sort(narrow ^ SIGN).values  # hi = 0, lo = 24-bit digest
    runs = DUP_TABLE - int(torch.unique(keys).numel())
    if runs == 0:
        fail("24-bit table has no duplicate runs")
    pick = torch.randint(0, DUP_TABLE, (FROM_PLANE,), generator=g, device=dev)
    miss = torch.randint(0, 1 << 24, (QUERIES - FROM_PLANE,), generator=g,
                         device=dev) ^ SIGN
    qk = torch.cat([keys[pick], miss])
    probe_case("dup24", keys, qk, reps=50, note=f"({runs} duplicate entries)",
               flush=flush)
    del keys, narrow, pick, miss, qk

    # -- sorted_probe at a serving request's shape ----------------------------
    keys = torch.sort(rand_keys(SERVE_PLANE)).values
    pick = torch.randint(0, SERVE_PLANE, (SERVE_KEYS - SERVE_KEYS // 4,),
                         generator=g, device=dev)
    qk = torch.cat([keys[pick], rand_keys(SERVE_KEYS // 4)])
    probe_case("serving", keys, qk, reps=200, note="(a request's keys)", flush=flush,
               queued=True, host_calls=HOST_CALLS)
    del keys, pick, qk

    # -- hash_mix: the verify batch, the other widths, the funnel's batch,
    # and a slice 4 bytes off 16-byte alignment ------------------------------
    hm = hash_case("verify", random_u32(g, (VERIFY_ROWS, VERIFY_LANES), dev), 20, flush)
    for name, shape, reps in (("W=32", (VERIFY_ROWS, 32), 20),
                              ("W=64", (VERIFY_ROWS, 64), 20),
                              ("funnel", (FUNNEL_VERIFY_ROWS, VERIFY_LANES), 200)):
        err = hash_case(name, random_u32(g, shape, dev), reps, flush)["max_abs_err"]
        hm["max_abs_err"] = max(hm["max_abs_err"], err)
    flat = random_u32(g, (VERIFY_ROWS * VERIFY_LANES + 1,), dev)
    err = hash_case("unaligned", flat[1:].view(VERIFY_ROWS, VERIFY_LANES), 20,
                    flush)["max_abs_err"]
    hm["max_abs_err"] = max(hm["max_abs_err"], err)
    del flat, flush
    torch.cuda.empty_cache()
    return main, hm


def sdpa_mask(case: FaCase, dev):
    """SDPA's boolean mask of ``case``, or None where ``is_causal`` (a
    causal case with Sq == Skv and no window) or no mask says it."""
    off = case.skv - case.sq
    if not off and case.window is None:
        return None
    if not case.causal and case.window is None:
        return None
    i = torch.arange(case.sq, device=dev)[:, None] + off
    j = torch.arange(case.skv, device=dev)[None, :]
    vis = j > i - (case.window or case.skv + abs(off) + 1)
    return vis & (j <= i) if case.causal else vis


def attention_case(case: FaCase, seed: int):
    """Hold flash_attention's kernel to its plain version in bfloat16 on
    the model's (B, S, H, D) layout viewed as (B, H, S, D) (k and v of a
    paged case gathered from a block pool); time it, the plain version
    and scaled_dot_product_attention, and read SDPA's output under the
    same bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, route
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_ref,
        bound_excess,
        flash_attention_ref,
        lse_excess,
    )
    from repro_torch.models.common import paged_view

    name, b, hq, hkv, s, sk, d, window, causal, paged = case
    off = sk - s
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)

    def make(h, rows):
        x = torch.randn((b, rows, h, d), generator=g, device=dev).to(torch.bfloat16)
        return x.transpose(1, 2)

    q = make(hq, s)
    if paged:
        n_blocks = sk // CONT_BLOCK
        table = torch.randperm(2 * n_blocks, generator=g, device=dev)[:n_blocks] + 1
        pool_rows = (2 * n_blocks + 1) * CONT_BLOCK
        k, v = (paged_view(torch.randn((hkv, pool_rows, d), generator=g, device=dev)
                           .to(torch.bfloat16), table[None], CONT_BLOCK)
                for _ in range(2))
    else:
        k, v = make(hkv, sk), make(hkv, sk)
    path = route(q, k, v)
    if path != "tensor_core":
        fail(f"flash_attention {name}: the serving layout took the {path} route")
    mask = sdpa_mask(case, dev)
    mode = dict(causal=causal, window=window)

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    out = flash_attention_cuda(q, k, v, **mode)
    # training asks the same kernel for the rows' log-sum-exp: the output's
    # bits may not move, and the lse is held to its plain version
    out_lse, lse = flash_attention_cuda(q, k, v, **mode, return_lse=True)
    same_bits = torch.equal(out.view(torch.int16), out_lse.view(torch.int16))
    out = out.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    lse_ratio = lse_excess(lse, attention_lse_ref(qf, kf, vf, **mode))
    del out_lse, lse
    if not same_bits:
        fail(f"flash_attention {name}: the output's bits change when the lse is written")
    if not lse_ratio <= 1.0:
        fail(f"flash_attention {name}: the kernel's lse at {lse_ratio:.4g} of its "
             f"tolerance (1e-5 (1 + |lse|), +inf where no key is seen)")
    ref = flash_attention_ref(qf, kf, vf, **mode)
    abs_v = flash_attention_ref(qf, kf, vf.abs(), **mode)
    err, ratio = float((out - ref).abs().max()), bound_excess(out, ref, abs_v)
    # keys 0..FA_DROP-1 lost: the rows that saw them (every row without the
    # causal mask), against the same rows
    r0 = max(0, FA_DROP - off) if causal else 0
    rows = (slice(None), slice(None), slice(r0, None))
    keys = (slice(None), slice(None), slice(FA_DROP, None))
    lost = flash_attention_ref(qf[rows], kf[keys], vf[keys], **mode)
    wrong = bound_excess(lost, ref[rows], abs_v[rows])
    lib = sdpa().float()
    lib_derived, lib_cast = bound_excess(lib, ref, abs_v), bound_excess(lib, ref)
    same = float((lib == out).float().mean())
    tol = (f"route {path}, bound |err| <= 2^-8|ref| + 2^-8 A(|v|) + 1e-4: worst "
           f"{ratio:.4g} of it (output-cast-only bound: "
           f"{bound_excess(out, ref):.4g}); losing keys 0..{FA_DROP - 1} reads "
           f"{wrong:.4g}; sdpa reads {lib_derived:.4g} (cast-only {lib_cast:.4g}) "
           f"and equals the kernel's output at {same:.4f} of the elements; with the "
           f"lse written the output is bit-identical, lse at {lse_ratio:.4g} of "
           f"1e-5 (1 + |lse|)")
    if not ratio <= 1.0:
        fail(f"flash_attention {name}: max_abs_err {err} outside the bound ({tol})")
    if not wrong > 1.0:
        fail(f"flash_attention {name}: the bound passes a wrong variant ({tol})")
    del out, ref, abs_v, lost, lib, qf, kf, vf
    before = flash_attention_cuda.tc_launches
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **mode), 20, warmup=2)
    if flash_attention_cuda.tc_launches - before != 22:
        fail(f"flash_attention {name}: timed launches left the tensor-core route")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    cold = cold_ms(lambda: flash_attention_cuda(q, k, v, **mode), 10, flush)
    del flush
    # one timed call where the plain version's scores pass 2^33 elements
    # (2.2 s a call at qwen2's 32,768 tokens), else two after a warm-up
    big = b * hq * s * sk > 2**33
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **mode), 1 if big else 2,
                    warmup=0 if big else 1)
    library = cuda_ms(sdpa, 20, warmup=2)
    # the visible (query, key) pairs of this mask, two products of D each
    flops, nbytes = attention_work(b, hq, hkv, s, sk, d, causal, window, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"flash_attention[{name}]: B={b} Hq={hq} Hkv={hkv} Sq={s} Skv={sk} D={d} "
          f"window={window} bf16 {'causal' if causal else 'non-causal'} "
          f"max_abs_err={err:.6g} ({tol}); "
          f"kernel_ms={ms:.6f} (L2 cold {cold:.6f}) plain_ms={plain:.6f} "
          f"library_ms(sdpa)={library:.6f} "
          f"flops={flops} bytes={nbytes} bound_ms={bnd:.6f} ({by}) "
          f"tflops={flops / ms / 1e9:.1f}", flush=True)
    del q, k, v, mask
    torch.cuda.empty_cache()
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, library_ms=library, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


# sources whose kernels must not spill, and what each redesigned kernel's
# SASS must hold: (source, kernel, opcodes)
NO_SPILL_SOURCES = ("flash_attention", "flash_attention_bwd", "sorted_probe", "hash_mix",
                    "sample", "ssd_scan", "tanimoto")
DESIGN_OPCODES = (
    ("flash_attention", "fa_forward_tc", ("HGMMA", "UTMALDG")),  # wgmma, TMA
    ("flash_attention_bwd", "fa_backward_dkdv", ("HGMMA", "UTMALDG")),
    ("flash_attention_bwd", "fa_backward_dq", ("HGMMA", "UTMALDG")),
    ("hash_mix", "hash_mix_staged_kernel", ("LDGSTS",)),         # cp.async
)


def build_checks(build) -> None:
    """The built libraries: ptxas reports no spills in any kernel of
    ``NO_SPILL_SOURCES``, and each redesigned kernel's instruction is in
    its SASS (``DESIGN_OPCODES``)."""
    import re

    for source in NO_SPILL_SOURCES:
        report = build.ptxas_report(source)
        spills = [m.group(0) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
            if m.group(1) != "0" or m.group(2) != "0"]
        if spills or "spill" not in report:
            fail(f"{source}: ptxas reports spills (or no report): {spills}")
        print(f"ptxas[{source}]: no spills", flush=True)
    for source, kernel, opcodes in DESIGN_OPCODES:
        ops = build.sass_opcode_counts(build.sass(source), kernel, opcodes)
        print(f"sass[{source}, {kernel}]: {json.dumps(ops)}", flush=True)
        if not all(ops.values()):
            fail(f"{source}: the SASS of {kernel} lacks {ops}")


def ssd_scan_case(case, seed: int):
    """Hold ssd_scan's kernel to its plain version on the card, bit for bit
    (both multiply, then add, in float32); time both."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    name, bh, c, p, n = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    states = torch.randn((bh, c, p, n), generator=g, device=dev)
    decay = torch.rand((bh, c), generator=g, device=dev)   # uniform in [0, 1)
    got = ssd_scan_cuda(states, decay)
    want = ssd_scan_ref(states, decay)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"ssd_scan {name}: kernel disagrees with plain version ({bad} outputs)")
    err = float((got - want).abs().max())
    del got, want
    ms = cuda_ms(lambda: ssd_scan_cuda(states, decay), 20)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    cold = cold_ms(lambda: ssd_scan_cuda(states, decay), 10, flush)
    del flush
    plain = cuda_ms(lambda: ssd_scan_ref(states, decay), 3, warmup=1)
    flops, nbytes = scan_work(bh, c, p, n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"ssd_scan[{name}]: BH={bh} C={c} P={p} N={n} f32 bit-exact; "
          f"kernel_ms={ms:.6f} (L2 cold {cold:.6f}) plain_ms={plain:.6f} "
          f"library_ms=null (no PyTorch call computes this scan) bytes={nbytes} "
          f"flops={flops} bound_ms={bnd:.6f} ({by})", flush=True)
    del states, decay
    torch.cuda.empty_cache()
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def sample_case(seed: int):
    """Hold the sampler kernel to its plain version on the card at
    B = ``SAMPLE_ROWS`` and each vocabulary of ``SAMPLE_VOCABS``, in the
    draws the engines make: the static engine's (one key split in place,
    bf16 and f32 logits, the draw in their dtype) and the continuous
    engine's (per-lane seeds and token indices, a float32 draw from f32 or
    bf16 logits, without top-k, with the threshold given, found in the
    launch at k = ``SAMPLE_TOP_K`` and at the cap, and given by
    ``torch.topk`` above the cap).  Each element's random bits and uniform,
    which the kernel copies out, must equal the plain version's bit for
    bit, and the split key too; a token may differ only where the plain
    version's top two scores lie within ``SAMPLE_NEAR_TIE`` (printed); the
    arrival counters must read zero after.  Then the draws as the engines
    call them (:func:`sample_engine_draws`), and the plain versions'
    times; ``torch.multinomial`` over the softmax, the draw the engines
    made before this kernel, is printed beside them (not the same function: no
    ``library_ms``).  Returns row 6's numbers: the static bf16 draw at
    yi-6b's vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sample import ops
    from repro_torch.kernels.sample import ref as S
    from repro_torch.kernels.sample.kernel import TOP_K_CAP, arrival_counters, sample_cuda

    dev = torch.device("cuda")
    r = SAMPLE_ROWS
    cases = (("static bf16", torch.bfloat16, torch.bfloat16, "split", {}),
             ("static f32", torch.float32, torch.float32, "split", {}),
             ("static bf16 top-k in the launch", torch.bfloat16, torch.bfloat16, "split",
              {"top_k": SAMPLE_TOP_K}),
             ("continuous f32", torch.float32, torch.float32, "lanes", {}),
             ("continuous f32 top-k given", torch.float32, torch.float32, "lanes",
              {"kth": SAMPLE_TOP_K}),
             ("continuous f32 top-k in the launch", torch.float32, torch.float32, "lanes",
              {"top_k": SAMPLE_TOP_K}),
             ("continuous bf16 logits top-k in the launch", torch.bfloat16, torch.float32,
              "lanes", {"top_k": SAMPLE_TOP_K}),
             ("continuous f32 top-k at the cap", torch.float32, torch.float32, "lanes",
              {"top_k": TOP_K_CAP}),
             ("continuous f32 top-k above the cap", torch.float32, torch.float32, "lanes",
              {"kth": TOP_K_CAP + 1}))
    err, out = 0.0, {}
    for arch in SAMPLE_VOCABS:
        v = get_config(arch).vocab_size
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 11)
        logits32 = torch.randn((r, v), generator=g, device=dev) * 4
        seeds = torch.randint(-2**31, 2**31, (r,), generator=g, device=dev,
                              dtype=torch.int32)
        index = torch.randint(0, SERVE_NEW_TOKENS, (r,), generator=g, device=dev,
                              dtype=torch.int32)
        noise = (torch.empty((r, v), dtype=torch.int32, device=dev),
                 torch.empty((r, v), device=dev))
        for name, ldt, ddt, mode, thr in cases:
            logits = logits32.to(ldt)
            inv_t = S.inv_temperature(SAMPLE_TEMPERATURE, ddt)
            k = thr.get("top_k") or thr.get("kth") or 0
            kth = S.top_k_threshold(logits, k, inv_t, ddt) if k else None
            given = {"kth": kth} if "kth" in thr else dict(thr)

            def make():
                if mode == "split":
                    return dict(keys=S.prng_key(seed, dev), split_key=True)
                return dict(seeds=seeds, index=index)

            kw, kw_ref = make(), make()
            got = sample_cuda(logits, inv_t, ddt, noise=noise, **given, **kw)
            served = sample_cuda(logits, inv_t, ddt, **given, **make())  # as served
            bits = S.sample_bits(r, v, dev, **make())
            scores = S.sample_scores(logits, inv_t, ddt, kth=kth, **kw_ref)
            torch.cuda.synchronize()
            label = f"sample[{name}, V={v}]"
            if not torch.equal(noise[0].long() & M32, bits):
                fail(f"{label}: the kernel's random bits differ from the plain version's")
            if not torch.equal(noise[1], S.uniform_of_bits(bits, ddt)):
                fail(f"{label}: the kernel's uniforms differ from the plain version's")
            if mode == "split" and not torch.equal(kw["keys"].view(torch.int32),
                                                   kw_ref["keys"].view(torch.int32)):
                fail(f"{label}: the kernel's split key differs")
            if any(c.any() for c in arrival_counters()):
                fail(f"{label}: an arrival counter is not zero after the launch")
            want = torch.argmax(scores, dim=-1).to(torch.int32)
            gap = S.top_two_gap(scores)
            equal = {}
            for how, tokens in (("noise copied", got), ("served", served)):
                differ = (tokens != want).nonzero().flatten().tolist()
                for row in differ:
                    print(f"{label} {how}: row {row} token {int(tokens[row])} != plain "
                          f"{int(want[row])}, top-two gap {float(gap[row]):.3e} "
                          f"(tolerance {SAMPLE_NEAR_TIE:.3e})", flush=True)
                    if float(gap[row]) > SAMPLE_NEAR_TIE:
                        fail(f"{label} {how}: row {row} parts from the plain version "
                             "outside a near-tie")
                    err = max(err, float(scores[row, want[row]] - scores[row, tokens[row]]))
                equal[how] = r - len(differ)
            print(f"{label}: R={r} {str(ldt)[6:]} logits, {str(ddt)[6:]} draw, "
                  f"{next(iter(thr), 'no top-k')}={k}: bits and uniforms bit-exact "
                  f"({r * v} each), tokens {equal['noise copied']} of {r} equal with the "
                  f"noise copied out, {equal['served']} of {r} as served; counters "
                  f"zero; smallest top-two gap {float(gap.min()):.3e}", flush=True)
            del bits, scores
        del noise
        torch.cuda.empty_cache()
        timed = sample_engine_draws(ops.sample, sample_cuda, S, logits32, seeds, index)
        logits = logits32.to(torch.bfloat16)
        inv_t = S.inv_temperature(SAMPLE_TEMPERATURE, torch.bfloat16)
        key = S.prng_key(seed, dev)
        plain = cuda_ms(lambda: S.sample_ref(logits, inv_t, torch.bfloat16, keys=key,
                                             split_key=True), 5, warmup=1)
        inv32 = S.inv_temperature(SAMPLE_TEMPERATURE, torch.float32)
        plain_k = cuda_ms(lambda: S.sample_ref(
            logits32, inv32, torch.float32, seeds=seeds, index=index,
            kth=S.top_k_threshold(logits32, SAMPLE_TOP_K, inv32, torch.float32)), 5,
            warmup=1)
        probs = torch.softmax(logits.float() * inv_t, dim=-1)
        multi = queued_ms(lambda: torch.multinomial(probs, 1), 100)
        print(f"sample[V={v}]: plain_ms static bf16 {plain:.6f}, continuous f32 top-k "
              f"{plain_k:.6f} (torch.topk included); library_ms=null (no PyTorch call "
              f"draws jax.random's tokens; torch.multinomial over the softmax, the "
              f"engines' draw before: {multi:.6f} ms queued)", flush=True)
        if arch == SAMPLE_VOCABS[0]:
            main = timed["static bf16"]
            out = dict(ms=main["ms"], plain_ms=plain, library_ms=None,
                       bound_ms=main["bound_ms"], bound_by=main["bound_by"])
        del logits32, logits, probs
        torch.cuda.empty_cache()
    return dict(out, max_abs_err=err)


def sample_engine_draws(sample, sample_cuda, S, logits32, seeds, index) -> dict:
    """Time the draws as the engines make them, through the entry point
    ``sample`` (``ops.sample``; the threshold included): the static
    engine's bf16 draw with the key split in place, and the continuous
    engine's float32 lane draw with and without top-k ``SAMPLE_TOP_K``;
    each queued behind a sleep (the host's enqueue hidden, as in a CUDA
    graph), back to back, and on the host's clock, the wrapper
    ``sample_cuda``'s host time beside; the kernels of one profiled call
    by name and their summed device time (the measure that holds where the
    host cannot enqueue a draw within its device time), beside the bound
    and its share: ``sample_work`` (every logit's bits) for the draws
    without top-k, ``sample_top_k_work`` (the bits of the logits at or
    above the row's threshold, counted from this run's logits, and a
    compare of every logit) for the top-k draw.  The
    modules are arguments so that another checkout's package can be timed
    the same way (``scripts/sample_timing.py``).  A draw with top-k at
    most the package's cap must be one kernel where the package has a cap
    (``kernel.TOP_K_CAP``)."""
    from torch.profiler import ProfilerActivity, profile

    dev = logits32.device
    r, v = logits32.shape
    bf16 = logits32.to(torch.bfloat16)
    key = S.prng_key(SAMPLE_SEED, dev)
    inv_b = S.inv_temperature(SAMPLE_TEMPERATURE, torch.bfloat16)
    inv_f = S.inv_temperature(SAMPLE_TEMPERATURE, torch.float32)
    draws = {
        "static bf16": (
            lambda: sample(bf16, SAMPLE_TEMPERATURE, key=key, split_key=True),
            lambda: sample_cuda(bf16, inv_b, torch.bfloat16, keys=key, split_key=True),
            bf16),
        "continuous f32 top-k": (
            lambda: sample(logits32, SAMPLE_TEMPERATURE, seeds=seeds, index=index,
                           top_k=SAMPLE_TOP_K, dtype=torch.float32),
            None, logits32),
        "continuous f32": (
            lambda: sample(logits32, SAMPLE_TEMPERATURE, seeds=seeds, index=index,
                           dtype=torch.float32),
            lambda: sample_cuda(logits32, inv_f, torch.float32, seeds=seeds, index=index),
            logits32),
    }
    one_kernel = hasattr(sys.modules[sample_cuda.__module__], "TOP_K_CAP")
    out = {}
    for name, (draw, wrapper, lg) in draws.items():
        ms = queued_ms(draw, 100)
        paced = cuda_ms(draw, 200)
        host = host_us(draw, 1000)
        wrapper_host = host_us(wrapper, 1000) if wrapper is not None else None
        draw()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            draw()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e.name for e in events]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        if one_kernel and (len(kernels) != 1 or "sample_kernel" not in kernels[0]):
            fail(f"sample[{name}, V={v}]: a draw is not one sample kernel: {kernels}")
        if "top-k" in name:
            scaled = S.scale_logits(lg, inv_f, torch.float32)
            kth = S.top_k_threshold(lg, SAMPLE_TOP_K, inv_f, torch.float32)
            kept = int((scaled >= kth[:, None]).sum())
            ops, nbytes = sample_top_k_work(r, v, lg.element_size(), kept)
            work = f"int_ops={ops} (threefry of the {kept} logits kept and a compare each)"
            del scaled
        else:
            ops, nbytes = sample_work(r, v, lg.element_size())
            work = f"int_ops={ops}"
        bnd, by = bound_ms(nbytes, ops)
        wh = f"{wrapper_host:.3f}" if wrapper_host is not None else "n/a"
        select = ""
        if one_kernel and "top-k" in name:
            parts, chunk = sys.modules[sample_cuda.__module__].geometry(r, v)
            select = (f"; the kernel's threshold key compares, at most, "
                      f"{sample_select_work(r, v, SAMPLE_TOP_K, parts, chunk)} "
                      f"({parts} chunks of {chunk})")
        print(f"sample_draw[{name}, V={v}]: kernel_ms={ms:.6f} (queued; back to back "
              f"{paced:.6f}) host_us={host:.3f} a call through ops.sample "
              f"(sample_cuda alone {wh}); {work} bytes={nbytes} "
              f"bound_ms={bnd:.6f} ({by}), share {bnd / ms:.4f}{select}; kernels of one "
              f"profiled call ({len(kernels)}, {busy:.6f} ms on the card): "
              f"{json.dumps([n[:60] for n in kernels])}", flush=True)
        out[name] = dict(ms=ms, paced_ms=paced, host_us=host, wrapper_host_us=wrapper_host,
                         bound_ms=bnd, bound_by=by, kernels=kernels, profiled_ms=busy)
    return out


def sampled_serving_phase(engine, prompts, greedy_tokens, card: str):
    """yi-6b at full size (the served engine's weights, bf16), sampled:
    the static engine (seed ``SAMPLE_SEED``, temperature
    ``SAMPLE_TEMPERATURE``) eager and graph in turns, then the continuous
    engine (top-k ``SAMPLE_TOP_K``, request seeds from ``SAMPLE_SEED``)
    eager and graph in turns; tokens identical across each engine's four
    runs (:func:`decode_alternation`, which prints tokens/s and ITL), and
    not the greedy ones.  The sampler's launch count is set to 0 just
    before and read just after: one launch a first token (continuous), an
    eager step, and each capture's warm-up and captured step (3); replays
    launch none.  Returns ``(sampler launches, flash_attention
    launches)``."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.sample.kernel import sample_cuda
    from repro_torch.serve.engine import Engine

    t0 = time.perf_counter()
    scfg = dataclasses.replace(engine.scfg, greedy=False,
                               temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED)
    engines = {m: Engine(engine.cfg, engine.model, scfg, device="cuda", decode=m)
               for m in ("eager", "graph")}
    seen, eager_steps = [], []

    def run(eng):
        out = eng.generate(prompts)
        seen.append([r.token_ids for r in out])
        if eng.decode == "eager":
            eager_steps.append(out[0].steps)
        return out, out[0].decode_s, len(out) * out[0].steps, "decode", None

    fa0 = flash_attention_cuda.launches
    sample_cuda.launches = 0
    decode_alternation("yi-6b sampled", engines, run, card)
    static_launches = sample_cuda.launches
    want = sum(eager_steps) + 3 * engines["graph"].captures
    if static_launches != want:
        fail(f"sampled static serving: {static_launches} sampler launches, want {want}")
    same = sum(a == b for ra, rb in zip(seen[0], greedy_tokens) for a, b in zip(ra, rb))
    total = sum(len(r) for r in seen[0])
    if same == total:
        fail("sampled static serving gave the greedy tokens")
    del engines
    torch.cuda.empty_cache()
    rates = continuous_alternation("yi-6b continuous sampled", engine.cfg, engine.model,
                                   prompts, card, sampled=True)
    launches = sample_cuda.launches
    work = rates["work"]
    want = static_launches + work["prefills"] + work["eager_steps"] + 3 * work["captures"]
    if launches != want:
        fail(f"sampled serving: {launches} sampler launches, want {want} "
             f"({work})")
    print(f"sampled serving[yi-6b]: sampler launches {launches} (static "
          f"{static_launches}, continuous {launches - static_launches}); static "
          f"tokens equal to greedy {same} of {total}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    return launches, flash_attention_cuda.launches - fa0


def corpus_prompts(work: Path, lengths) -> list:
    """Prompts cut from the funnel corpus's records: the i-th starts at the
    i-th record's id line and runs ``lengths[i]`` bytes (records are ASCII)."""
    from repro_torch.core.records import iter_records

    path = sorted((work / "corpus").glob("compound_*.sdf"))[0]
    recs = []
    for _, text in iter_records(path):
        recs.append(text)
        if len(recs) == 64:
            break
    stream = "".join(recs)
    out, at = [], 0
    for n, rec in zip(lengths, recs):
        start = stream.index("InChI=", at)
        out.append(stream[start:start + n])
        at += len(rec)
    if [len(p.encode()) for p in out] != list(lengths):
        fail("funnel corpus too short for the serving prompts")
    return out


def prompt_batch(prompts):
    """``(tokens (B, S) right-padded, lengths (B,))`` of BOS + the bytes of
    each prompt, as the engine pads them."""
    from repro_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ids = [tok.encode(p, add_eos=False) for p in prompts]
    toks = torch.full((len(ids), max(map(len, ids))), tok.pad_id, dtype=torch.long)
    for i, row in enumerate(ids):
        toks[i, :len(row)] = torch.tensor(row)
    return toks, torch.tensor([len(r) for r in ids])


def model_cases():
    """The model checks, in float32, as ``{phase: [(name, cfg, init,
    prefill, prompt bytes, kernel launches wanted), ...]}``: yi-6b,
    mamba2-1.3b, gemma3-12b (one window and one global layer),
    internvl2-76b, qwen2-72b and qwen1.5-110b at full width cut to
    ``MODEL_LAYERS`` layers.  The
    routed families (MoE, hybrid) have their own check
    (:func:`moe_model_check`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.ssm import init_ssm, ssm_prefill
    from repro_torch.models.transformer import init_lm, lm_prefill

    def cut(arch):
        return dataclasses.replace(get_config(arch), n_layers=MODEL_LAYERS,
                                   dtype="float32")

    gemma = dataclasses.replace(cut(GEMMA), local_block=MODEL_LAYERS)
    vlm = cut(VLM)
    return {
        "dense": [("yi-6b full width, 2 layers", cut("yi-6b"), init_lm, lm_prefill,
                   (255, 97), {"flash_attention": MODEL_LAYERS})],
        "families": [
            (f"{GEMMA} full width, 2 layers (window {gemma.window}, then global)", gemma,
             init_lm, lm_prefill, GEMMA_MODEL_LENGTHS, {"flash_attention": MODEL_LAYERS}),
            (f"{VLM} full width, 2 layers, {vlm.n_img_tokens} seeded patch embeddings",
             vlm, init_lm, lm_prefill, VLM_MODEL_LENGTHS,
             {"flash_attention": MODEL_LAYERS}),
        ],
        "recurrent": [
            ("mamba2-1.3b full width, 2 layers", cut("mamba2-1.3b"), init_ssm,
             ssm_prefill, SSM_MODEL_LENGTHS, {"ssd_scan": MODEL_LAYERS}),
        ],
        "qkv_bias": [
            (f"{arch} full width, 2 layers, biases drawn from N(0, 1)",
             cut(arch), init_lm, lm_prefill, (255, 97), {"flash_attention": MODEL_LAYERS})
            for arch in (QWEN2, QWEN15)
        ],
    }


def model_phase(work: Path, seed: int, cases, wrappers) -> None:
    """For each case: weights drawn once on the card from ``seed`` and
    copied to the CPU (:func:`cpu_copy`; drawn on the CPU, they took most
    of a full-width check's time), prefill logits of two ragged corpus prompts on the card
    against the CPU's, in float32 with TF32 off, and the card's kernel launches
    (``wrappers``' counts) against the ones wanted.  On the VLM both read
    the same seeded nonzero patch embeddings (``torch.Generator`` on the
    CPU).  On the dense and VLM families every layer's K/V cache on the
    card must match the CPU's within the same tolerances too: on a window
    layer that the long prompt passes, the ring of its last ``window``
    positions.  On a config with QKV biases the biases are drawn after the
    init (:func:`draw_qkv_biases`), and then, as a
    negative control, layer 0's ``bv`` is zeroed on the card and its
    logits read again: they must fall outside the tolerance (printed: by
    how much)."""
    from repro_torch.models.common import draw_qkv_biases

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, cfg, init, prefill, lengths, want_launches in cases:
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        card_model = init(cfg, gen, "cuda")
        biased = draw_qkv_biases(card_model, gen)
        cpu_model = cpu_copy(card_model)
        toks, lens = prompt_batch(corpus_prompts(work, lengths))
        extra = {}
        if cfg.family == "vlm":
            g = torch.Generator(device="cpu").manual_seed(seed)
            extra = {"extra_embeds": torch.randn((len(lengths), cfg.n_img_tokens,
                                                  cfg.d_model), generator=g)}
        want, want_cache = prefill(cpu_model, cfg, toks, lengths=lens, **extra)
        for fn in wrappers.values():
            fn.launches = 0
        got, cache = prefill(card_model, cfg, toks.cuda(), lengths=lens.cuda(),
                             **{k: t.cuda() for k, t in extra.items()})
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        got = got.cpu()
        if got.shape != (2, cfg.vocab_size) or not torch.isfinite(got).all():
            fail(f"model check {name}: logits {tuple(got.shape)} not finite or "
                 "misshaped")
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)
        kv = ""
        if cfg.family in ("dense", "vlm"):
            pairs = [(c[n].cpu(), w[n]) for c, w in zip(cache, want_cache) for n in "kv"]
            kv_err = max(float((a - b).abs().max()) for a, b in pairs)
            kv_ok = all(a.shape == b.shape and torch.allclose(a, b, atol=MODEL_ATOL,
                                                              rtol=MODEL_RTOL)
                        for a, b in pairs)
            kv = (f"; K/V caches (slots per layer "
                  f"{[c['k'].shape[2] for c in cache]}) max_abs_err={kv_err:.6g}")
            if not kv_ok:
                fail(f"model check {name}: card caches differ from the CPU's{kv}")
        print(f"model check: {name}, float32, allow_tf32=False; prompts "
              f"{lens.tolist()} tokens; card vs CPU prefill logits "
              f"max_abs_err={err:.6g} (atol {MODEL_ATOL}, rtol {MODEL_RTOL}){kv}; "
              f"launches {json.dumps(launches)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            fail(f"model check {name}: card logits differ from the CPU's (max {err})")
        for kernel, n in launches.items():
            if n != want_launches.get(kernel, 0):
                fail(f"model check {name}: {n} {kernel} launches, want "
                     f"{want_launches.get(kernel, 0)}")
        if biased:
            with torch.no_grad():
                card_model.layers[0].attn.bv.zero_()
            lost = prefill(card_model, cfg, toks.cuda(), lengths=lens.cuda())[0].cpu()
            excess = float(((lost - want).abs()
                            / (MODEL_ATOL + MODEL_RTOL * want.abs())).max())
            print(f"model check {name}: biases of {biased} layers drawn from "
                  f"N(0, 1); negative control, layer 0's bv zeroed on the "
                  f"card: logits max_abs_err={float((lost - want).abs().max()):.6g}, "
                  f"{excess:.4g}x the tolerance", flush=True)
            if torch.allclose(lost, want, atol=MODEL_ATOL, rtol=MODEL_RTOL):
                fail(f"model check {name}: the logits pass with layer 0's bv zeroed")
        del cpu_model, card_model, cache, got, want_cache, extra
        torch.cuda.empty_cache()


def model_wrappers() -> dict:
    """The model kernels' wrappers by name, whose counts the phases read."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    return {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda}


def prefill_launches(cfg) -> dict:
    """Each model kernel's launches in one prefill: ``flash_attention`` once
    per attention layer (on the encoder-decoder family once per encoder
    layer and twice per decoder layer, self and cross attention),
    ``ssd_scan`` once per Mamba layer; the hybrid has ``n_blocks``
    attention layers and ``n_blocks · len(mamba_pos)`` Mamba layers."""
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers}
    if cfg.family == "ssm":
        return {"ssd_scan": cfg.n_layers}
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import _layout

        n_blocks, _, mamba_pos, _, _ = _layout(cfg)
        return {"flash_attention": n_blocks, "ssd_scan": n_blocks * len(mamba_pos)}
    return {"flash_attention": cfg.n_layers}


def dense_weight_figures(cfg) -> dict:
    """A dense config's parameters, from its fields: a layer's (q, k, v and
    output projections, the QKV biases where it has them, the SwiGLU's
    three matrices; its two norms apart), the embedding's and the untied
    head's, and the served model's bytes: matrices and biases in the
    compute dtype, the norms in float32, as ``init_lm`` stores them."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    layer = 2 * d * q + 2 * d * kv + 3 * d * cfg.d_ff
    if cfg.qkv_bias:
        layer += q + 2 * kv
    embed = cfg.vocab_size * d
    heads = 1 if cfg.tie_embeddings else 2
    item = 2 if cfg.dtype == "bfloat16" else 4
    nbytes = (item * (cfg.n_layers * layer + heads * embed)
              + 4 * d * (2 * cfg.n_layers + 1))
    return {"layer": layer, "embed": embed, "heads": heads, "bytes": nbytes}


def lm_serving_phase(work: Path, seed: int, arch: str, card: str,
                     max_len: int = SERVE_MAX_LEN, lengths=SERVE_LENGTHS,
                     cut: Optional[dict] = None):
    """``arch`` at its published widths and full depth, bfloat16, through
    launch.serve.run (with ``cut``, its published config with those fields
    replaced, the depth cut: the launcher has no depth option) with the
    corpus prompts of ``lengths`` bytes; each model kernel must launch
    exactly ``prefill_launches`` times per prefill (``flash_attention``
    all on the tensor-core route) and never in decode.  Prints the
    weights' bytes, the phase's own peak, prefill ms, and the graph
    decode's ITL beside the step's weight-read bound (every weight read
    once a step: MoE decode sizes each expert's slots to the batch, so it
    reads every expert).  Returns each kernel's launches over the phase,
    the served engine (for callers that go on serving its model) and the
    runs (tokens, prefill and decode timings).  On a config with QKV
    biases (the launcher draws them after the init) the weights' bytes
    must equal :func:`dense_weight_figures`' (printed with its
    figures)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.moe import MoE, monitor

    wrappers = model_wrappers()
    fa = wrappers["flash_attention"]
    prompts = corpus_prompts(work, lengths)
    args = serve.build_parser().parse_args([
        "--arch", arch, "--full-config", "--device", "cuda",
        "--seed", str(seed), "--max-new-tokens", str(SERVE_NEW_TOKENS),
        "--max-len", str(max_len), "--repeats", "2", "--prompts", *prompts,
    ])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers.values())
    t0 = time.perf_counter()
    out = serve.run(args, None if cut is None else
                    dataclasses.replace(get_config(arch), **cut))
    launches = {n: fn.launches for n, fn in wrappers.items()}
    tc_launches = fa.tc_launches
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    runs = out["runs"]
    if runs[0]["token_ids"] != runs[1]["token_ids"]:
        fail(f"{arch} serving: the two generate calls gave different tokens")
    vocab = get_config(arch).vocab_size
    for row in runs[0]["token_ids"]:
        if not row or any(not 0 <= t < vocab for t in row):
            fail(f"{arch} serving: bad token row {row[:8]}")
    engine = out.pop("engine")
    if engine.cfg.qkv_bias:
        fig = dense_weight_figures(engine.cfg)
        print(f"lm_serving[{arch}]: from the config, {fig['layer']} parameters a "
              f"layer (QKV biases drawn from N(0, 1)), embedding and untied "
              f"head {fig['embed']} each: {fig['bytes']} bytes at "
              f"{engine.cfg.n_layers} layers in {engine.cfg.dtype}, the weight-read "
              f"bound of a decode step {fig['bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms "
              f"at 3.35 TB/s", flush=True)
        if fig["bytes"] != out["weight_bytes"]:
            fail(f"{arch} serving: {out['weight_bytes']} weight bytes, the config "
                 f"gives {fig['bytes']}")
    per_prefill = prefill_launches(engine.cfg)
    for name, n in launches.items():
        want = 2 * per_prefill.get(name, 0)
        if n != want:
            fail(f"{arch} serving: {n} {name} launches, want {want} "
                 f"({per_prefill.get(name, 0)} per prefill, none in decode)")
    if tc_launches != launches["flash_attention"]:
        fail(f"{arch} serving: {tc_launches} of {launches['flash_attention']} "
             "flash_attention launches on the tensor-core route, want all")
    for i, r in enumerate(runs):
        print(f"lm_serving[{arch}] run {i}: B={out['batch']} prompt tokens "
              f"{out['prompt_tokens']}; prefill_ms={r['prefill_ms']:.3f} "
              f"decode {r['decode_steps']} steps in {r['decode_ms']:.3f} ms = "
              f"{r['decode_tokens_per_s']:.1f} tokens/s; card: {card}", flush=True)
    extra = ""
    if engine.cfg.family == "encdec":
        extra = encdec_cache_check(engine, prompts, fa, max_len,
                                   per_prefill["flash_attention"])
    if any(isinstance(m, MoE) for m in engine.model.modules()):
        # the served prefill again, its routing recorded (decode drops nothing)
        toks, lens = engine._pad_prompts([engine.tok.encode(p, add_eos=False)
                                          for p in prompts])
        with torch.no_grad(), monitor(engine.model) as calls:
            engine.api.prefill(engine.model, {
                "tokens": torch.from_numpy(toks).cuda(),
                "lengths": torch.from_numpy(lens).cuda()}, max_len=max_len)
        extra = (f"; MoE assignments dropped in one prefill (B={len(prompts)} x "
                 f"{toks.shape[1]} tokens, {len(calls)} MoE layers): "
                 f"{int(sum(c.dropped for c in calls))} (decode: no drop)")
        del calls
    counts = ", ".join(f"{n} launches {launches[n]} ({k} per prefill)"
                       for n, k in per_prefill.items())
    print(f"lm_serving[{arch}]: {out['n_layers']} layers bf16, init "
          f"{out['init_s']:.1f} s, weight_bytes={out['weight_bytes']} "
          f"cache_bytes={out['kv_cache_bytes']} (summed over the cache prefill "
          f"allocated, max_len {max_len}) peak_allocated={peak} "
          f"(allocated at the phase's start: {base}; own peak "
          f"{peak - base}); {counts}, flash_attention {tc_launches} on the "
          f"tensor-core route{extra}; tokens identical over 2 runs; {secs:.1f} s",
          flush=True)
    profile_generate(engine, prompts, card, f"{arch} graph")
    before = {n: fn.launches for n, fn in wrappers.items()}
    rates = static_alternation(arch, engine, prompts, card)
    for name, fn in wrappers.items():
        alt = fn.launches - before[name]
        want = 5 * per_prefill.get(name, 0)   # 4 runs and the eager profile
        if alt != want:
            fail(f"{arch} alternation: {alt} {name} launches in 5 generate calls, "
                 f"want {want} ({per_prefill.get(name, 0)} per prefill, none in decode)")
    bound = out["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    itl = rates["itl"]["graph"]
    print(f"decode[{arch}]: graph ITL p50 {', '.join(f'{x:.3f}' for x in itl)} ms "
          f"against the step's weight-read bound {bound:.3f} ms (weight_bytes "
          f"{out['weight_bytes']} / 3.35 TB/s, every weight read once a step): "
          f"{bound / float(np.mean(itl)):.4f} of it; card: {card}", flush=True)
    del out
    torch.cuda.empty_cache()
    return launches, engine, runs


def long_prompt(work: Path, nbytes: int) -> str:
    """The funnel corpus's records joined, from the first one's id line, and
    cut to ``nbytes`` bytes (records are ASCII)."""
    from repro_torch.core.records import iter_records

    parts, have = [], 0
    for path in sorted((work / "corpus").glob("compound_*.sdf")):
        for _, text in iter_records(path):
            parts.append(text)
            have += len(text)
            if have > nbytes + 1024:
                break
        if have > nbytes + 1024:
            break
    stream = "".join(parts)
    out = stream[stream.index("InChI="):][:nbytes]
    if len(out.encode()) != nbytes:
        fail(f"funnel corpus too short for a {nbytes}-byte prompt")
    return out


def long_prompt_phase(work: Path, engine, card: str) -> int:
    """qwen2-72b's prefill_32k / decode_32k length on ``engine``'s served
    model (its 16 layers, bf16, nonzero QKV biases): one prompt of
    ``LONG_PROMPT_TOKENS`` tokens (BOS and the corpus joined to 32,767
    bytes) into a ``LONG_MAX_LEN`` cache, ``SERVE_NEW_TOKENS`` new tokens,
    through a static ``Engine`` that decodes by graph replay, served twice:
    the same tokens, one tensor-core ``flash_attention`` launch a layer a
    prefill and none in decode, prefill ms beside its compute bound, and the
    two runs' own peak; then the eager/graph turns and the eager engine's
    profile (:func:`static_alternation`) with the graph ITL beside the
    step's bound (every weight and the cache's ``LONG_MAX_LEN`` slots read
    once).  Returns the phase's
    ``flash_attention`` launches."""
    from repro_torch.serve.engine import Engine, ServeConfig

    t0 = time.perf_counter()
    cfg, label = engine.cfg, f"{engine.cfg.name} {LONG_PROMPT_TOKENS} tokens"
    fa = model_wrappers()["flash_attention"]
    prompt = long_prompt(work, LONG_PROMPT_TOKENS - 1)
    eng = Engine(cfg, engine.model, ServeConfig(max_new_tokens=SERVE_NEW_TOKENS,
                                                max_len=LONG_MAX_LEN), device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches([fa])
    runs = [eng.generate([prompt])[0] for _ in range(2)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches, tc = fa.launches, fa.tc_launches
    if runs[0].prompt_len != LONG_PROMPT_TOKENS:
        fail(f"{label}: the prompt is {runs[0].prompt_len} tokens")
    if runs[0].token_ids != runs[1].token_ids:
        fail(f"{label}: the two generate calls gave different tokens")
    if not runs[0].token_ids or any(not 0 <= t < cfg.vocab_size for t in runs[0].token_ids):
        fail(f"{label}: bad token row {runs[0].token_ids[:8]}")
    if launches != 2 * cfg.n_layers or tc != launches:
        fail(f"{label}: {launches} flash_attention launches ({tc} on the tensor-core "
             f"route) in 2 generate calls, want {2 * cfg.n_layers}, all tensor-core")
    fig = dense_weight_figures(cfg)
    d, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn_flops, _ = attention_work(1, hq, hkv, LONG_PROMPT_TOKENS, LONG_PROMPT_TOKENS,
                                   d, True, None, 2)
    flops = (2 * LONG_PROMPT_TOKENS * fig["layer"] * cfg.n_layers
             + cfg.n_layers * attn_flops + 2 * fig["embed"])
    prefill_bound = flops / BF16_FLOPS_PER_S * 1e3
    for i, r in enumerate(runs):
        print(f"lm_long[{label}] run {i}: prefill_ms={r.prefill_s * 1e3:.3f} (compute "
              f"bound {prefill_bound:.3f} ms: {flops:.4e} flops at 989 TFLOP/s, "
              f"{prefill_bound / (r.prefill_s * 1e3):.4f} of it); decode {r.steps} "
              f"steps in {r.decode_s * 1e3:.3f} ms = {r.tokens_per_s:.1f} tokens/s; "
              f"card: {card}", flush=True)
    print(f"lm_long[{label}]: {cfg.n_layers} layers bf16, max_len {LONG_MAX_LEN}, "
          f"cache_bytes={eng.kv_cache_bytes}; own peak of the 2 runs {peak} (allocated "
          f"at their start: {base}); flash_attention {launches} launches, {tc} on the "
          f"tensor-core route ({cfg.n_layers} a prefill, none in decode); tokens "
          f"identical over 2 runs; {time.perf_counter() - t0:.1f} s", flush=True)
    before = fa.launches
    rates = static_alternation(label, eng, [prompt], card)
    alt = fa.launches - before
    if alt != 5 * cfg.n_layers:
        fail(f"{label} alternation: {alt} flash_attention launches in 5 generate calls "
             f"(4 turns, 1 profiled), want {5 * cfg.n_layers}")
    step_bytes = fig["bytes"] + eng.kv_cache_bytes
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    itl = rates["itl"]["graph"]
    print(f"decode[{label}]: graph ITL p50 {', '.join(f'{x:.3f}' for x in itl)} ms "
          f"against the step's read bound {bound:.3f} ms (weights {fig['bytes']} + "
          f"cache {eng.kv_cache_bytes} bytes / 3.35 TB/s): {bound / float(np.mean(itl)):.4f} "
          f"of it; {time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches + alt


def encdec_cache_check(engine, prompts, wrapper, max_len: int, per_prefill: int) -> str:
    """The served encoder-decoder prefill once more, alone: its kernel
    launches (all on the tensor-core route) and its caches' bytes, the
    cross cache's against L x 2 x B x Hkv x frames x Dh x 2 B."""
    cfg = engine.cfg
    toks, lens = engine._pad_prompts([engine.tok.encode(p, add_eos=False)
                                      for p in prompts])
    b = len(prompts)
    before = (wrapper.launches, wrapper.tc_launches)
    _, cache = engine.api.prefill(engine.model, {
        "tokens": torch.from_numpy(toks).cuda(), "lengths": torch.from_numpy(lens).cuda(),
        "frames": torch.zeros((b, cfg.enc_frames, cfg.d_model), device="cuda")},
        max_len=max_len)
    torch.cuda.synchronize()
    one = (wrapper.launches - before[0], wrapper.tc_launches - before[1])
    nbytes = {part: sum(t.nbytes for t in kv.values()) for part, kv in cache.items()}
    want = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.enc_frames * cfg.resolved_head_dim * 2
    del cache
    if one != (per_prefill, per_prefill):
        fail(f"{cfg.name} prefill: {one[0]} launches ({one[1]} tensor-core), want "
             f"{per_prefill}, all tensor-core")
    if nbytes["cross"] != want:
        fail(f"{cfg.name} prefill: cross cache {nbytes['cross']} B, want {want}")
    return (f"; one more prefill (B={b} x {toks.shape[1]} tokens against "
            f"{cfg.enc_frames} frames): {one[1]} tensor-core launches (encoder "
            f"{cfg.n_enc_layers}, decoder self {cfg.n_layers}, cross {cfg.n_layers}), "
            f"cross cache {nbytes['cross']} B (L x 2 x B x Hkv x {cfg.enc_frames} x "
            f"{cfg.resolved_head_dim} x 2 B), self cache {nbytes['self']} B")


def encdec_model_check(work: Path, seed: int) -> None:
    """whisper-small at full width cut to ``MODEL_LAYERS`` encoder and
    ``MODEL_LAYERS`` decoder layers, float32 with TF32 off, weights made
    once on the CPU and copied to the card; the same seeded random frames
    (B = 2 x 1,500 x 768) and two ragged corpus prompts on both.  Prefill
    logits card vs CPU within ``MODEL_ATOL``/``MODEL_RTOL``, 3
    ``flash_attention`` launches a layer pair; then the loss and every
    parameter's gradient within the same tolerances, none zero on the card
    where the CPU's is not, 6 launches a layer pair (forward and the
    recompute of each block)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda as fa
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(WHISPER), n_layers=MODEL_LAYERS,
                              n_enc_layers=MODEL_LAYERS, dtype="float32")
    api = build_model(cfg)
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    cpu_model = api.init(g, "cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    toks, lens = prompt_batch(corpus_prompts(work, TRAIN_PARITY_LENGTHS))
    batch = {"frames": torch.randn((2, cfg.enc_frames, cfg.d_model), generator=g),
             "tokens": toks, "lengths": lens,
             "loss_mask": (torch.arange(toks.shape[1])[None, :] < lens[:, None]).float()}
    card_batch = {k: t.cuda() for k, t in batch.items()}
    want, _ = api.prefill(cpu_model, batch)
    fa.launches = 0
    got, _ = api.prefill(card_model, card_batch)
    torch.cuda.synchronize()
    prefill_n = fa.launches
    got = got.cpu()
    if got.shape != (2, cfg.vocab_size) or not torch.isfinite(got).all():
        fail(f"{WHISPER} check: logits {tuple(got.shape)} not finite or misshaped")
    err = float((got - want).abs().max())
    for m in (cpu_model, card_model):
        for p in m.parameters():
            p.requires_grad_(True)
    loss_c, _, grads_c = _loss_and_grads(api, cpu_model, batch)
    fa.launches = 0
    loss_g, _, grads_g = _loss_and_grads(api, card_model, card_batch)
    torch.cuda.synchronize()
    loss_n = fa.launches
    worst, worst_rel, dead, bad = 0.0, 0.0, [], []
    for n, wg in grads_c.items():
        gg = grads_g[n].cpu()
        if not torch.isfinite(gg).all():
            fail(f"{WHISPER} check: gradient of {n} not finite on the card")
        worst = max(worst, float((gg - wg).abs().max()))
        worst_rel = max(worst_rel, float((gg - wg).norm() / max(float(wg.norm()), 1e-30)))
        if bool((wg != 0).any()) and not bool((gg != 0).any()):
            dead.append(n)
        if not torch.allclose(gg, wg, atol=MODEL_ATOL, rtol=MODEL_RTOL):
            bad.append(n)
    per_pair = 3
    print(f"model check: {WHISPER} full width, {MODEL_LAYERS} encoder + {MODEL_LAYERS} "
          f"decoder layers, float32, allow_tf32=False; frames 2 x {cfg.enc_frames} x "
          f"{cfg.d_model} (seeded randn), prompts {lens.tolist()} tokens; card vs CPU "
          f"prefill logits max_abs_err={err:.6g}; loss card {loss_g:.7g} CPU "
          f"{loss_c:.7g}; {len(grads_c)} parameter gradients: max_abs_err={worst:.6g}, "
          f"worst relative norm error {worst_rel:.3g} (atol {MODEL_ATOL}, rtol "
          f"{MODEL_RTOL}), zero on the card where non-zero on the CPU: {len(dead)}; "
          f"flash_attention launches: prefill {prefill_n}, loss and gradients {loss_n}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not torch.allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL):
        fail(f"{WHISPER} check: card logits differ from the CPU's (max {err})")
    if not abs(loss_g - loss_c) <= MODEL_ATOL + MODEL_RTOL * abs(loss_c):
        fail(f"{WHISPER} check: loss {loss_g} on the card, {loss_c} on the CPU")
    if dead or bad:
        fail(f"{WHISPER} check: gradients cut off {dead[:5]} or differing {bad[:5]}")
    if (prefill_n, loss_n) != (per_pair * MODEL_LAYERS, 2 * per_pair * MODEL_LAYERS):
        fail(f"{WHISPER} check: {prefill_n} and {loss_n} flash_attention launches, want "
             f"{per_pair * MODEL_LAYERS} and {2 * per_pair * MODEL_LAYERS}")
    del cpu_model, card_model, grads_c, grads_g, card_batch
    torch.cuda.empty_cache()


def profile_generate(engine, prompts, card: str, arch: str) -> None:
    """Where serving's time goes: one more ``generate`` of the served engine
    under ``torch.profiler``, split by its ``Engine.prefill`` and
    ``Engine.decode`` spans (see :func:`profile_spans`)."""
    profile_spans(lambda: engine.generate(prompts),
                  ("Engine.prefill", "Engine.decode"), card, arch)


class StepClock:
    """CUDA events before and after every decode step while it is entered:
    each eager ``Engine._step`` and each CUDA graph replay (of either
    engine).  ``stats()`` gives the inter-token latency (the device time
    between the ends of consecutive steps) at p50 and p99, and the card's
    busy share over the steps' span: the time inside the steps over the time
    from the first step's start to the last one's end.  For a replay the
    time inside is the graph's own; an eager step's includes the card's
    waits for the host, so its share is not a busy share (the profiler
    gives that)."""

    def __init__(self):
        self.marks = []

    def __enter__(self):
        from repro_torch.serve.engine import Engine

        self._saved = (Engine._step, torch.cuda.CUDAGraph.replay)
        marks = self.marks

        def timed(fn):
            def call(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                marks.append((start, end))
                return out
            return call

        Engine._step = timed(self._saved[0])
        torch.cuda.CUDAGraph.replay = timed(self._saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import Engine

        Engine._step, torch.cuda.CUDAGraph.replay = self._saved

    def stats(self) -> dict:
        torch.cuda.synchronize()
        m = self.marks
        if len(m) < 2:
            return {"steps": len(m), "itl_p50": float("nan"), "itl_p99": float("nan"),
                    "busy": float("nan")}
        itl = [a[1].elapsed_time(b[1]) for a, b in zip(m, m[1:])]
        inside = sum(a.elapsed_time(b) for a, b in m)
        span = m[0][0].elapsed_time(m[-1][1])
        return {"steps": len(m), "itl_p50": float(np.percentile(itl, 50)),
                "itl_p99": float(np.percentile(itl, 99)), "busy": inside / span}


def decode_alternation(label: str, engines: dict, run, card: str) -> dict:
    """The same weights through an eager engine and a graph engine, in
    turns: eager, graph, eager, graph (one process's runs differ by more
    than 10%, so only turns compare).  ``run(engine)`` serves the prompts
    and returns ``(results, seconds, tokens, what the seconds cover, ITL)``,
    the ITL a ``(p50, p99, source)`` or None for :class:`StepClock`'s.
    Tokens must be identical over all four runs.  Prints, per run, tokens/s
    (host clock), ITL p50/p99, the busy share (:class:`StepClock`), capture
    ms, replays and the run's own peak.  Returns each mode's rates."""
    tokens, rates = {}, {"eager": [], "graph": [], "itl": {"eager": [], "graph": []}}
    for mode in ("eager", "graph", "eager", "graph"):
        eng = engines[mode]
        caps, reps = eng.captures, eng.replays
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with StepClock() as clock:
            results, secs, n_tokens, what, itl = run(eng)
        peak = torch.cuda.max_memory_allocated() - base
        st = clock.stats()
        if itl is None:
            itl = (st["itl_p50"], st["itl_p99"],
                   f"over {st['steps']} steps, CUDA events at each step's end")
        toks = [r.token_ids for r in results]
        if tokens.setdefault(mode, toks) != toks:
            fail(f"decode[{label}]: the {mode} engine's two runs gave different tokens")
        rate = n_tokens / secs
        rates[mode].append(rate)
        rates["itl"][mode].append(itl[0])
        cap = (f"captured {eng.captures - caps} in {eng.capture_s * 1e3:.1f} ms"
               if eng.captures > caps else "no capture")
        if mode == "graph":
            busy = (f"busy {st['busy']:.3f} of the replays' span (CUDA events around "
                    "each replay)")
        else:
            busy = ("busy share: see the profiler line (an eager step's CUDA events "
                    "include the card's waits for the host)")
        print(f"decode[{label}] {mode}: {n_tokens} tokens in {secs * 1e3:.3f} ms "
              f"of {what} = {rate:.1f} tokens/s (host clock); ITL p50 {itl[0]:.3f} / "
              f"p99 {itl[1]:.3f} ms ({itl[2]}); {busy}; {cap}; replays "
              f"{eng.replays - reps}; own peak {peak}; card: {card}", flush=True)
    if tokens["graph"] != tokens["eager"]:
        diff = sum(a != b for ra, rb in zip(tokens["graph"], tokens["eager"])
                   for a, b in zip(ra, rb))
        fail(f"decode[{label}]: graph tokens differ from eager tokens ({diff} tokens)")
    e, g = np.mean(rates["eager"]), np.mean(rates["graph"])
    print(f"decode[{label}]: graph tokens identical to eager over 2 + 2 alternated "
          f"runs; decode {g:.1f} against {e:.1f} tokens/s = {g / e:.2f}x; card: "
          f"{card}", flush=True)
    return rates


def static_alternation(label: str, graph_engine, prompts, card: str) -> dict:
    """:func:`decode_alternation` of the static ``Engine``: ``graph_engine``
    (whose capture of this key may already exist) against an eager engine
    on its model and config."""
    from repro_torch.serve.engine import Engine

    if graph_engine.decode != "graph":
        fail(f"decode[{label}]: the served engine decodes {graph_engine.decode!r}, "
             "not through a CUDA graph")
    eager = Engine(graph_engine.cfg, graph_engine.model, graph_engine.scfg,
                   device="cuda", decode="eager")

    def run(eng):
        out = eng.generate(prompts)
        return out, out[0].decode_s, len(out) * out[0].steps, "decode", None

    rates = decode_alternation(label, {"eager": eager, "graph": graph_engine}, run, card)
    profile_generate(eager, prompts, card, f"{label} eager")
    del eager
    return rates


def continuous_alternation(label: str, cfg, model, prompts, card: str,
                           sampled: bool = False, max_len: Optional[int] = None) -> dict:
    """:func:`decode_alternation` of ``ContinuousEngine``s on one model,
    greedy (profiled after the turns) or ``sampled`` (the request seeds
    ``SAMPLE_SEED + i``, temperature ``SAMPLE_TEMPERATURE``, top-k
    ``SAMPLE_TOP_K``): an eager one and a graph one, each with its own pool
    of ``max_len`` rows a slot (``CONT_MAX_LEN`` by default) and the prefix
    cache off (a suffix prefill would change bf16 rounding), the
    ``CONT_SLOTS`` prompts at once, so every lane decodes.  ITL from
    the engine's own windows (host clock).  The rates carry the engines'
    prefills, eager steps and captures under ``"work"``."""
    from repro_torch.launch.serve import paged_spec
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import ContinuousEngine

    spec = paged_spec(max_len or CONT_MAX_LEN, CONT_BLOCK, CONT_SLOTS,
                      prefix_cache=False)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW_TOKENS, max_len=spec.max_len)
    if sampled:
        scfg = dataclasses.replace(scfg, greedy=False, temperature=SAMPLE_TEMPERATURE,
                                   top_k=SAMPLE_TOP_K)
    engines = {m: ContinuousEngine(cfg, model, spec, scfg, prefix_cache=False,
                                   device="cuda", decode=m)
               for m in ("eager", "graph")}

    def run(eng):
        eng.reset_slo()
        t0 = time.perf_counter()
        futs = [eng.submit(p, lead=False, seed=SAMPLE_SEED + i)
                for i, p in enumerate(prompts)]
        eng._maybe_lead()
        out = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        slo = eng.slo_ms()
        return (out, wall, sum(len(r.token_ids) for r in out),
                "the workload (prefills included)",
                (slo["itl_p50_ms"], slo["itl_p99_ms"], "the engine's ITL window"))

    rates = decode_alternation(label, engines, run, card)
    if not sampled:
        profile_spans(lambda: engines["eager"].generate(prompts),
                      ("ContinuousEngine.prefill", "ContinuousEngine.decode"), card,
                      f"{label} eager")
    eager, graph = engines["eager"].stats, engines["graph"]
    rates["work"] = {"prefills": eager.prefills + graph.stats.prefills,
                     "eager_steps": eager.steps, "captures": graph.captures}
    for m, eng in engines.items():
        drain_and_check(eng, f"{label} {m}")
    del engines
    torch.cuda.empty_cache()
    return rates


def profile_spans(run, names, card: str, label: str) -> None:
    """``run()`` under ``torch.profiler``.  For each span name in ``names``:
    the wall time of all its spans, the card's busy time in them (the
    device's kernels and copies that start inside one; one stream, so they
    do not overlap) and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    # the raw (kineto) events, times in us: ``prof.events()`` would build a
    # Python call tree over them at about 60 us an event, which for a
    # moonshot decode (230,000 device events and their host ops) is minutes
    raw = prof.profiler.kineto_results.events()
    device = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3) for e in raw
              if e.device_type() == DeviceType.CUDA and e.name() not in names
              and not e.is_user_annotation()]
    for name in names:
        spans = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                       for e in raw
                       if e.name() == name and e.device_type() == DeviceType.CPU)
        starts = [a for a, _ in spans]
        inside = []
        for ev in device:
            i = bisect.bisect_right(starts, ev[1]) - 1
            if i >= 0 and ev[1] < spans[i][1]:
                inside.append(ev)
        if not inside:
            print(f"lm_profile[{label}][{name}]: the profiler saw no device events in "
                  "it: busy share not measured", flush=True)
            continue
        wall = sum(b - a for a, b in spans)
        busy = sum(d for _, _, d in inside)
        per_kernel: dict = {}
        for kernel, _, d in inside:
            t, n = per_kernel.get(kernel, (0, 0))
            per_kernel[kernel] = (t + d, n + 1)
        tops = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:5]
        top = "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{n}" for k, (t, n) in tops)
        print(f"lm_profile[{label}][{name}]: {len(spans)} spans, wall {wall / 1e3:.3f} "
              f"ms under the profiler, device busy {busy / 1e3:.3f} ms = "
              f"{busy / wall:.3f} of it ({len(inside)} device events); top: {top}; "
              f"card: {card}", flush=True)


def reset_launches(wrappers) -> None:
    """Set every launch count of ``wrappers`` (the total and each route's)
    to 0."""
    for fn in wrappers:
        for attr in list(vars(fn)):
            if attr.endswith("launches"):
                setattr(fn, attr, 0)


def route_launches(wrappers) -> dict:
    """``{name: {"launches": total, "<route>_launches": n, ...}}``."""
    return {name: {attr: getattr(fn, attr) for attr in sorted(vars(fn))
                   if attr.endswith("launches")}
            for name, fn in wrappers.items()}


def hashed_phase_check(work: Path, summary: dict, seed: int) -> None:
    """The funnel's hashed-key phase is deterministic: its mismatch count
    must equal ``HASHED_MISMATCHES`` (seed 0) and the count through an
    index built by one process on the same corpus, whose entries the
    funnel's pool build (``workers=4``) must equal."""
    from repro_torch.core import (
        IndexStore, RecordStore, build_index, extract, intersect_host)
    from repro_torch.core.sdfgen import db_id_list
    from repro_torch.launch.funnel import SHARDS, funnel_spec

    bits = summary["hashed_key_bits"]
    store = RecordStore(work / "corpus")
    one = build_index(store, key_mode="hashed_key", key_bits=bits,
                      recompute_keys=True, workers=1)
    pool = build_index(store, key_mode="hashed_key", key_bits=bits,
                       recompute_keys=True, workers=4)
    if list(one.entries.items()) != list(pool.entries.items()):
        fail("hashed-key index: workers=4 differs from workers=1")
    one.save_sharded(work / "hashed_one", n_shards=SHARDS)
    spec = funnel_spec(FUNNEL_RECORDS, seed)
    ids = intersect_host(db_id_list(spec, "chembl", extra_outside=30),
                         db_id_list(spec, "emolecules", extra_outside=30)).ids
    res = extract(store, IndexStore.open(work / "hashed_one", device="cuda"), ids,
                  key_bits=bits, device="cuda")
    got, one_count = summary["hashed_mismatches"], len(res.mismatches)
    pinned = HASHED_MISMATCHES if seed == 0 else None
    print(f"funnel {bits}-bit phase: {got} mismatches; workers=1 index on the "
          f"same corpus: {one_count}; pinned (seed 0): {pinned}", flush=True)
    if got != one_count or (pinned is not None and got != pinned):
        fail(f"{bits}-bit phase: {got} mismatches, workers=1 gives {one_count}, "
             f"pinned {pinned}")


def serving_phase(serve_index, work: Path, wrappers, card: str):
    """The query service on the funnel's corpus and store, lookup mode then
    similarity mode; returns each kernel's launches over the phase.  Each
    device digest table builds its fences once: the phase's stores (the
    service's replicas sharing one plane and their shard tables, the parity
    and naive arms' stores with up to one table a shard, in each mode) bound
    the builds, however many requests they serve; only tables on the fenced
    route build fences."""
    from repro_torch.core.store import IndexStore
    from repro_torch.kernels.sorted_probe.kernel import FENCED_MIN_ROWS

    probe = wrappers["sorted_probe"]
    common = ["--store", str(work / "store"), "--corpus", str(work / "corpus"),
              "--device", "cuda", "--replicas", "2", "--clients", "8",
              "--seconds", "2"]
    reset_launches(wrappers.values())
    builds = probe.fence_builds
    t0 = time.perf_counter()
    look = serve_index.run(serve_index.build_parser().parse_args(common))
    sim = serve_index.run(serve_index.build_parser().parse_args(
        common + ["--similarity", "--similar-k", "8"]))
    counts = route_launches(wrappers)
    launches = {n: c["launches"] for n, c in counts.items()}
    builds = probe.fence_builds - builds
    # two modes: a plane, three stores' shards; those of the fenced route
    rows = [int(sh["count"])
            for sh in IndexStore.open(work / "store", device="cpu").manifest["shards"]]
    tables = 2 * (1 + 3 * len(rows))
    fenced = 2 * ((sum(rows) >= FENCED_MIN_ROWS)
                  + 3 * sum(r >= FENCED_MIN_ROWS for r in rows))
    print(f"serving phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(counts)}; fence builds {builds} (at most {fenced} of "
          f"{tables} device tables take the fenced route: a plane of {sum(rows)} "
          f"rows, shards of {min(rows)} to {max(rows)}) for "
          f"{launches['sorted_probe']} probe launches", flush=True)
    if builds > fenced or (fenced and not builds):
        fail(f"serving phase: {builds} fence builds, not one per fenced-route "
             f"device table (at most {fenced})")
    for mode, out in (("lookup", look), ("similarity", sim)):
        if not out.get("parity"):
            fail(f"serve_index {mode} mode ran no parity gate")
        for arm in ("service", "naive"):
            r = out[arm]
            if r["errors"]:
                fail(f"serve_index {mode} {arm}: {r['errors']} requests raised")
            unit = "lookups/s" if mode == "lookup" else "similarity queries/s"
            print(f"serve_index[{mode}] {arm}: {r['per_s']:.1f} {unit}, "
                  f"p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
                  f"{r['requests']} requests; card: {card}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched in the serving phase")
    return launches


def funnel_paper_phases(summary: dict, work: Path, seed: int, card: str) -> int:
    """The funnel's §VI scan and Algorithm 1 baseline (run inside
    ``run_funnel``, which raises on a disagreement), printed beside the
    pinned mismatches; then ``digest_ids`` on the card against the CPU's,
    bit for bit, on the targets.  Returns ``digest_ids``' launches."""
    from repro_torch.core import intersect_host
    from repro_torch.core.sdfgen import db_id_list
    from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
    from repro_torch.kernels.hash_mix.ops import digest_ids
    from repro_torch.launch.funnel import funnel_spec

    col, base = summary["collisions"], summary["baseline"]
    print(f"funnel §VI scan at {col['key_bits']}-bit keys: {col['colliding_keys']} "
          f"colliding keys, {col['affected_records']} affected of {col['records']} "
          f"records (scan_corpus == scan_pairs_sorted == collisions_from_pairs); "
          f"Eq. 4 rate {col['empirical_rate']:.6f}, Eq. 5 expectation "
          f"{col['birthday_expectation']:.1f}; the extraction's "
          f"{col['mismatches']} mismatches (pinned {HASHED_MISMATCHES} at seed 0): "
          f"{col['collision_mismatches']} inside colliding groups (at most "
          f"{col['affected_records'] - col['colliding_keys']} possible), "
          f"{col['mismatches'] - col['collision_mismatches']} absent targets; "
          f"scan {col['scan_s']:.2f} s", flush=True)
    if seed == 0 and col["mismatches"] != HASHED_MISMATCHES:
        fail(f"§VI scan saw {col['mismatches']} mismatches, pinned {HASHED_MISMATCHES}")
    print(f"funnel Algorithm 1: {base['targets_checked']} targets found by naive_scan "
          f"== extract; scan {base['scan_records_per_s']:.0f} records/s (host), "
          f"{base['comparisons_per_s']:.4g} list comparisons/s; Eq. 2/3 at "
          f"176,929,690 records x 477,123 targets: {base['projected_ops']:.4g} "
          f"comparisons = {base['projected_naive_s']:.4g} s "
          f"({base['projected_naive_s'] / 86400:.1f} days); indexed extract "
          f"{base['indexed_s']:.3f} s here, {base['indexed_per_target_s'] * 1e3:.4f} "
          f"ms a target, {base['projected_indexed_s']:.1f} s projected: ratio "
          f"{base['ratio']:.1f}x (host clock)", flush=True)
    spec = funnel_spec(FUNNEL_RECORDS, seed)
    targets = intersect_host(db_id_list(spec, "chembl", extra_outside=30),
                             db_id_list(spec, "emolecules", extra_outside=30)).ids
    hash_mix_cuda.launches = 0
    got = digest_ids(targets, seed=seed, device="cuda")
    n = hash_mix_cuda.launches
    want = digest_ids(targets, seed=seed, device="cpu")
    if not np.array_equal(got, want):
        fail(f"digest_ids: card differs from the CPU on "
             f"{int((got != want).any(axis=1).sum())} of {len(targets)} targets")
    print(f"digest_ids: {len(targets)} targets, card == CPU bit for bit, "
          f"{n} hash_mix launch", flush=True)
    return n


# continuous serving: the engine's slots, blocks and rows, and the prompts
# that reuse a block-aligned prefix of a served long prompt: (index of the
# long prompt in SERVE_LENGTHS, prefix tokens adopted, new suffix bytes).
# The parity phase sends the first PARITY_REUSE of them.
CONT_SLOTS = 8
CONT_BLOCK = 16
CONT_MAX_LEN = 2080        # a 2,048-token prompt and 32 new tokens
CONT_CLIENTS = CONT_SLOTS  # one corpus prompt each, then two REUSE at once
REUSE = ((5, 1024, 40), (6, 1536, 200), (7, 1536, 97), (7, 1024, 300),
         (6, 1024, 16), (5, 1024, 500), (7, 1536, 33), (6, 1536, 450),
         (5, 1024, 120), (6, 1024, 260), (7, 1024, 700), (7, 1536, 480),
         (6, 1536, 64), (5, 1024, 900), (6, 1024, 380), (7, 1536, 250))
PARITY_REUSE = 8
SLO_P99_MIN = 100          # fewer samples than this: the tail printed is the max
NEAR_TIE = 1e-4            # logits of two tokens this close: argmax may flip
SUFFIX_ATOL = 1e-4         # float32 suffix-prefill logits against full prefill's
PARITY_NEW_TOKENS = 16
MOE_NEAR_TIE = 1e-6        # router probabilities this close may swap experts


def first_decode_logits(api, model, batch, max_len: int) -> torch.Tensor:
    """Logits (float32) of the first decode step after a prefill of
    ``batch`` into a ``max_len`` cache, fed the prefill's greedy tokens."""
    with torch.no_grad():
        logits, cache = api.prefill(model, batch, max_len=max_len)
        cur = torch.argmax(logits, dim=-1)[:, None]
        return api.decode_step(model, cur, batch["lengths"], cache)[0].float()


def chunked_decode_reading(engine, prompts, card: str) -> None:
    """yi-6b's served model at ``max_len`` ``CHUNKED_MAX_LEN``, the decode
    attention one-pass (``flags.DECODE_CHUNKED`` off) and chunked (on).
    Accuracy: the first decode step's bf16 logits both ways against the
    same step in float32 (the served weights upcast, TF32 off, a cache of
    ``CONT_MAX_LEN`` rows, which masks the same keys); the chunked path's
    error may be at most ``CHUNKED_ERR_RATIO`` times the one-pass path's,
    each path rounding its probabilities to bf16 once.  Rate: one graph
    engine decodes the prompts off, on, off, on (one capture per setting:
    the flag is part of the key), decode tokens/s and the tokens the two
    settings share printed."""
    import copy
    import dataclasses

    from repro_torch import flags
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, model, api = engine.cfg, engine.model, engine.api
    scfg = ServeConfig(max_new_tokens=SERVE_NEW_TOKENS, max_len=CHUNKED_MAX_LEN)
    graph = Engine(cfg, model, scfg, device="cuda")
    batch, _ = graph.inputs(prompts)
    saved = flags.DECODE_CHUNKED
    try:
        first = {}
        for on in (False, True):
            flags.DECODE_CHUNKED = on
            first[on] = first_decode_logits(api, model, batch, CHUNKED_MAX_LEN)
        flags.DECODE_CHUNKED = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = copy.deepcopy(model).float()
        ref = first_decode_logits(build_model(cfg32), model32, batch, CONT_MAX_LEN)
        del model32
        torch.cuda.empty_cache()
        rates, toks = {False: [], True: []}, {}
        for on in (False, True, False, True):
            flags.DECODE_CHUNKED = on
            out = graph.generate(prompts)
            rates[on].append(len(out) * out[0].steps / out[0].decode_s)
            toks[on] = [r.token_ids for r in out]
    finally:
        flags.DECODE_CHUNKED = saved
    err = {on: float((first[on] - ref).abs().max()) for on in (False, True)}
    diff = float((first[True] - first[False]).abs().max())
    same = sum(a == b for x, y in zip(toks[False], toks[True]) for a, b in zip(x, y))
    total = sum(len(x) for x in toks[False])
    print(f"decode_chunked[yi-6b]: max_len {CHUNKED_MAX_LEN}, B={len(prompts)}, graph "
          f"decode (captures {graph.captures}): one-pass "
          f"{', '.join(f'{r:.1f}' for r in rates[False])} tokens/s, chunked (2,048-row "
          f"chunks) {', '.join(f'{r:.1f}' for r in rates[True])} tokens/s (host "
          f"clock); first decode step's bf16 logits against float32 (|logit| max "
          f"{float(ref.abs().max()):.4g}): one-pass max_abs_err={err[False]:.6g}, "
          f"chunked {err[True]:.6g} (at most {CHUNKED_ERR_RATIO} x one-pass's), "
          f"chunked vs one-pass {diff:.6g}; tokens shared {same} of {total} (no "
          f"gate: bf16 near-ties); card: {card}", flush=True)
    if graph.captures != 2:
        fail(f"decode_chunked: {graph.captures} captures, want one per setting")
    if not err[True] <= CHUNKED_ERR_RATIO * err[False]:
        fail(f"decode_chunked: chunked bf16 logits {err[True]} off float32, one-pass "
             f"{err[False]}")
    del graph
    torch.cuda.empty_cache()


def reuse_prompts(work: Path, prompts) -> list:
    """The ``REUSE`` prompts: BOS plus the first ``prefix - 1`` bytes of a
    long corpus prompt (``prefix`` tokens, block-aligned), then a suffix cut
    from another record."""
    suffixes = corpus_prompts(work, [n for *_, n in REUSE])
    return [prompts[i][:prefix - 1] + suf
            for (i, prefix, _), suf in zip(REUSE, suffixes)]


def count_prefill_launches(engine, split: dict) -> None:
    """Wrap ``engine``'s full and suffix prefill so that each adds its
    ``flash_attention`` launches (all, and on the tensor-core route) to
    ``split``: the leader is the one thread that launches."""
    import dataclasses

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda as fa

    def counted(fn, kind):
        def call(*a, **k):
            before = (fa.launches, fa.tc_launches)
            out = fn(*a, **k)
            split[kind] = split.get(kind, 0) + fa.launches - before[0]
            split[f"{kind}_tc"] = split.get(f"{kind}_tc", 0) + fa.tc_launches - before[1]
            split[f"{kind}_calls"] = split.get(f"{kind}_calls", 0) + 1
            return out
        return call

    engine.api = dataclasses.replace(
        engine.api, prefill=counted(engine.api.prefill, "full"),
        prefill_suffix=counted(engine.api.prefill_suffix, "suffix"))


def drain_and_check(engine, name: str) -> None:
    """``close(drain=True)``, the allocator's books exact, and no block in
    use once the prefix index lets go of its entries."""
    engine.close(drain=True)
    engine.check()
    mgr, index = engine._mgr, engine._index
    held = len(index.block_refs()) if index is not None else 0
    if mgr.n_in_use != held:
        fail(f"{name}: {mgr.n_in_use} blocks in use after close, the index holds {held}")
    if index is not None:
        index.clear()
    st = mgr.stats()
    if st["in_use"] or st["allocs"] != st["frees"]:
        fail(f"{name}: blocks left in use after close: {st}")
    engine.check()
    print(f"{name}: closed (drain); BlockManager.check() passed, 0 blocks in use "
          f"after the prefix index let go of {held}; allocator {json.dumps(st)}",
          flush=True)


def slo_text(eng) -> str:
    """TTFT and ITL of ``eng``'s requests: the median and the tail, the
    tail a p99 from ``SLO_P99_MIN`` samples on and the max below that."""
    with eng._lock:
        series = {"TTFT": list(eng._ttft_ms), "ITL": list(eng._itl_ms)}
    parts = []
    for name, xs in series.items():
        tail = (f"p99 {np.percentile(xs, 99):.3f}" if len(xs) >= SLO_P99_MIN
                else f"max {max(xs):.3f}")
        parts.append(f"{name} p50 {np.percentile(xs, 50):.3f} / {tail} ms over "
                     f"{len(xs)}")
    return ", ".join(parts)


def continuous_serving_phase(work: Path, engine, static_tokens, card: str) -> int:
    """yi-6b's served model through ``ContinuousEngine`` (bf16, full depth):
    ``CONT_CLIENTS`` client threads, one per slot, each first sends its
    corpus prompt and waits for it, then (after every thread's) sends two
    ``REUSE`` prompts at once: twice as many requests as slots, so slots
    are reused and requests queue for one.  Returns the
    ``flash_attention`` launches of the phase."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import paged_spec
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import ContinuousEngine

    cfg, model = engine.cfg, engine.model
    prompts = corpus_prompts(work, SERVE_LENGTHS)
    reuse = reuse_prompts(work, prompts)
    n_req = len(prompts) + len(reuse)
    spec = paged_spec(CONT_MAX_LEN, CONT_BLOCK, CONT_SLOTS, prefix_cache=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, model, spec,
                           ServeConfig(max_new_tokens=SERVE_NEW_TOKENS,
                                       max_len=spec.max_len),
                           prefix_cache=True, device="cuda")
    pool_bytes = sum(t.nbytes for layer in eng._cache for t in layer.values())
    split: dict = {}
    count_prefill_launches(eng, split)
    flash_attention_cuda.launches = flash_attention_cuda.tc_launches = 0
    results, errors = {}, []
    barrier = threading.Barrier(CONT_CLIENTS)
    outstanding = {"now": 0, "peak": 0}
    lock = threading.Lock()

    def send(texts):
        with lock:
            outstanding["now"] += len(texts)
            outstanding["peak"] = max(outstanding["peak"], outstanding["now"])
        futures = [eng.submit(t) for t in texts]
        out = [f.result(timeout=600) for f in futures]
        with lock:
            outstanding["now"] -= len(texts)
        return out

    def client(t):
        try:
            results[("corpus", t)] = send([prompts[t]])[0]
            barrier.wait(timeout=600)
            pair = (2 * t, 2 * t + 1)
            for j, r in zip(pair, send([reuse[j] for j in pair])):
                results[("reuse", j)] = r
        except BaseException as e:  # reported below, the phase fails
            errors.append(repr(e))
            barrier.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(CONT_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads) or len(results) != n_req:
        fail(f"continuous yi-6b: {len(results)} of {n_req} requests completed; {errors}")
    launches, tc = flash_attention_cuda.launches, flash_attention_cuda.tc_launches
    c = eng.counters()
    hits, prefills, saved = c["prefix_hits"], c["prefills"], c["prefill_tokens_saved"]
    n_tokens = sum(len(r.token_ids) for r in results.values())
    peak = torch.cuda.max_memory_allocated()
    same = sum(a == b for i in range(len(prompts))
               for a, b in zip(results[("corpus", i)].token_ids, static_tokens[i]))
    total = sum(len(static_tokens[i]) for i in range(len(prompts)))
    print(f"continuous[yi-6b]: {CONT_SLOTS} slots, block {CONT_BLOCK}, max_len "
          f"{spec.max_len}, pool {spec.n_blocks} blocks = {pool_bytes} bytes; "
          f"{n_req} requests from {CONT_CLIENTS} threads in {wall:.3f} s: {n_tokens} "
          f"tokens = {n_tokens / wall:.1f} tokens/s; {slo_text(eng)}; peak_active "
          f"{c['peak_active']:.0f} of {CONT_SLOTS} slots, peak outstanding "
          f"{outstanding['peak']} requests, admission_stalls "
          f"{c['admission_stalls']:.0f} (waits on blocks), {c['steps']:.0f} decode "
          f"steps at {c['tokens_per_step']:.3f} tokens a step, index evictions "
          f"{c.get('pfx_evictions', 0):.0f}; prefix hits {hits:.0f} of "
          f"{prefills:.0f} prefills (hit rate {hits / max(prefills, 1):.3f}), "
          f"{saved:.0f} prefill tokens saved; flash_attention {launches} launches, "
          f"{tc} tensor-core: full prefill {split.get('full', 0)} "
          f"({split.get('full_tc', 0)} tc, {split.get('full_calls', 0)} calls), "
          f"suffix prefill {split.get('suffix', 0)} ({split.get('suffix_tc', 0)} tc, "
          f"{split.get('suffix_calls', 0)} calls); bf16 tokens identical to the "
          f"static run's: {same} of {total} = {same / max(total, 1):.4f} (no gate: "
          f"bf16 near-ties); peak_allocated={peak} (own {peak - base}); "
          f"card: {card}", flush=True)
    if c["peak_active"] != CONT_SLOTS or outstanding["peak"] <= CONT_SLOTS:
        fail(f"continuous yi-6b: {c['peak_active']:.0f} slots busy at most with "
             f"{outstanding['peak']} requests outstanding: the traffic did not fill "
             f"the {CONT_SLOTS} slots and queue beyond them")
    n_layers = cfg.n_layers
    if hits < len(REUSE) or split.get("suffix_calls", 0) != hits:
        fail(f"continuous yi-6b: {hits} prefix hits, want {len(REUSE)}")
    if (split.get("full", 0) != n_layers * split.get("full_calls", 0)
            or split.get("suffix", 0) != n_layers * split.get("suffix_calls", 0)
            or launches != split.get("full", 0) + split.get("suffix", 0)):
        fail(f"continuous yi-6b: flash_attention launches {launches} do not split "
             f"one per layer per prefill: {split}")
    if tc != launches:
        fail(f"continuous yi-6b: {launches - tc} flash_attention launches left the "
             "tensor-core route")
    profile_spans(lambda: eng.generate(prompts),
                  ("ContinuousEngine.prefill", "ContinuousEngine.decode"), card,
                  "yi-6b continuous graph")
    if eng.decode != "graph" or eng.replays != eng.stats.steps:
        fail(f"continuous yi-6b: decode {eng.decode!r}, {eng.replays} replays for "
             f"{eng.stats.steps} steps: the greedy step did not replay a CUDA graph")
    drain_and_check(eng, "continuous[yi-6b]")
    del eng
    torch.cuda.empty_cache()
    continuous_alternation("yi-6b continuous", cfg, model, prompts, card)
    return launches


def near_tie(model, cfg, prompt_ids, common, tokens) -> float:
    """How far below the top logit the ``tokens`` lie at the step after
    ``prompt_ids + common``, from a float32 prefill of batch 1 on the card
    (on the VLM behind its zero patch embeddings, as the engines serve)."""
    from repro_torch.models.transformer import lm_prefill

    ids = torch.tensor([list(prompt_ids) + list(common)], device="cuda")
    image = None
    if cfg.family == "vlm":   # the engines' stub: zero patch embeddings
        image = torch.zeros((1, cfg.n_img_tokens, cfg.d_model), device="cuda")
    logits = lm_prefill(model, cfg, ids, image)[0][0].float()
    top = logits.max()
    return max(float(top - logits[t]) for t in tokens)


def compare_tokens(name, a, b, model, cfg, prompts) -> int:
    """Greedy rows ``a`` and ``b`` of the same prompts must agree; a differing
    token passes only at a near-tie (both tokens within ``NEAR_TIE`` of the
    top logit, recomputed), and is printed.  Returns the near-ties."""
    from repro_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ties = 0
    for i, (ra, rb) in enumerate(zip(a, b)):
        for j, (x, y) in enumerate(zip(ra, rb)):
            if x == y:
                continue
            gap = near_tie(model, cfg, tok.encode(prompts[i], add_eos=False),
                           ra[:j], (x, y))
            print(f"{name}: prompt {i} step {j}: tokens {x} / {y}, both within "
                  f"{gap:.3g} of the top logit", flush=True)
            if gap > NEAR_TIE:
                fail(f"{name}: prompt {i} differs at step {j} ({x} / {y}), "
                     f"{gap:.3g} apart: not a near-tie")
            ties += 1
            break
        else:
            if len(ra) != len(rb):
                fail(f"{name}: prompt {i}: {len(ra)} against {len(rb)} tokens")
    return ties


def continuous_parity_phase(work: Path, seed: int, card: str,
                            arch: str = "yi-6b") -> None:
    """float32, ``arch`` at full width cut to ``MODEL_LAYERS`` layers (its
    QKV biases, where it has them, drawn after the init), one set of
    weights on the card: ContinuousEngine == the static Engine, prefix on
    == off (under the near-tie rule), and suffix-prefill logits within
    ``SUFFIX_ATOL`` of full prefill's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import paged_spec
    from repro_torch.models.common import draw_qkv_biases
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kvcache import BlockManager, PrefixIndex
    from repro_torch.serve.scheduler import ContinuousEngine
    from repro_torch.data.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=MODEL_LAYERS,
                              dtype="float32")
    api = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = api.init(gen, "cuda")
    draw_qkv_biases(model, gen)
    prompts = corpus_prompts(work, SERVE_LENGTHS)
    texts = prompts + reuse_prompts(work, prompts)[:PARITY_REUSE]
    spec = paged_spec(CONT_MAX_LEN, CONT_BLOCK, CONT_SLOTS, prefix_cache=True)
    scfg = ServeConfig(max_new_tokens=PARITY_NEW_TOKENS, max_len=spec.max_len)
    static = [r.token_ids for r in Engine(cfg, model, scfg, device="cuda").generate(texts)]
    rows = {}
    for prefix in (True, False):
        eng = ContinuousEngine(cfg, model, spec, scfg, prefix_cache=prefix,
                               device="cuda")
        rows[prefix] = [r.token_ids for r in eng.generate(texts)]
        if prefix:
            hits = eng.stats.prefix_hits
        drain_and_check(eng, f"parity[prefix {'on' if prefix else 'off'}]")
        if prefix and hits < PARITY_REUSE:
            fail(f"parity: {hits} prefix hits, want at least {PARITY_REUSE}")
    ties = compare_tokens(f"parity[{arch}] continuous vs static", rows[True], static,
                          model, cfg, texts)
    ties += compare_tokens(f"parity[{arch}] prefix on vs off", rows[True],
                           rows[False], model, cfg, texts)

    # suffix prefill against full prefill, through the paged functions
    tok = ByteTokenizer()
    bs = CONT_BLOCK
    mgr = BlockManager(spec)
    index = PrefixIndex(mgr)
    pool = api.paged_cache_init(spec.n_blocks, bs, "cuda")
    worst = 0.0
    for slot, (i, prefix, _) in enumerate(REUSE[:CONT_SLOTS // 2]):
        src = tok.encode(prompts[i], add_eos=False)
        if not mgr.admit(2 * slot, len(src)):
            fail("parity: the pool refused a suffix case's source prompt")
        bucket = -(-len(src) // bs) * bs
        ids = torch.full((1, bucket), tok.pad_id, device="cuda")
        ids[0, :len(src)] = torch.tensor(src)
        _, dense = api.prefill(model, {"tokens": ids, "lengths": torch.tensor(
            [len(src)], device="cuda")}, max_len=spec.max_len)
        api.paged_prefill_write(pool, dense, torch.from_numpy(
            mgr.tables[2 * slot]).cuda(), bs)
        index.publish(src, mgr.slot_blocks(2 * slot), len(src))
        del dense
        ids2 = tok.encode(texts[len(prompts) + slot], add_eos=False)
        blocks, start = index.match(ids2)
        if start != prefix:
            fail(f"parity: suffix case {slot} matched {start} tokens, want {prefix}")
        if not mgr.admit(2 * slot + 1, len(ids2), prefix_blocks=blocks):
            fail("parity: the pool refused a suffix case")
        bucket2 = -(-len(ids2) // bs) * bs
        full_ids = torch.full((1, bucket2), tok.pad_id, device="cuda")
        full_ids[0, :len(ids2)] = torch.tensor(ids2)
        full, _ = api.prefill(model, {"tokens": full_ids, "lengths": torch.tensor(
            [len(ids2)], device="cuda")}, max_len=bucket2)
        before = flash_attention_cuda.launches
        suf, pool = api.prefill_suffix(
            model, full_ids[:, start:], start,
            torch.from_numpy(mgr.tables[2 * slot + 1]).cuda(), pool, bs,
            lengths=torch.tensor([len(ids2) - start], device="cuda"))
        if flash_attention_cuda.launches - before != cfg.n_layers:
            fail("parity: suffix prefill did not launch flash_attention once a layer")
        err = float((suf - full).abs().max())
        worst = max(worst, err)
        print(f"parity: suffix prefill start={start} S={bucket2 - start} "
              f"(Skv={bucket2}) last-token logits vs full prefill max_abs_err="
              f"{err:.6g}", flush=True)
        if not err <= SUFFIX_ATOL:
            fail(f"parity: suffix prefill logits {err} from full prefill's "
                 f"(tolerance {SUFFIX_ATOL})")
    bias = ", QKV biases drawn from N(0, 1)" if cfg.qkv_bias else ""
    print(f"parity ({arch} full width, {MODEL_LAYERS} layers, float32, allow_tf32="
          f"False{bias}, {len(texts)} prompts, {PARITY_NEW_TOKENS} new tokens): "
          f"continuous == static and prefix on == prefix off with {ties} "
          f"near-ties, {hits} prefix hits; suffix vs full "
          f"prefill logits worst {worst:.6g} (tolerance "
          f"{SUFFIX_ATOL}); {time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    del model, pool
    torch.cuda.empty_cache()


def vlm_continuous_phase(work: Path, engine, card: str) -> int:
    """internvl2-76b's served model (the static phase's weights: 16 layers,
    bf16) through ``ContinuousEngine``: the 8 serving prompts, each behind
    the 256 image positions (the stub's zero patch embeddings), so a
    slot's block table holds 256 + prompt + new tokens (``max_len``
    ``CONT_MAX_LEN`` + 256 rows); prefix sharing off, as in the reference
    (image positions offset every position).  Every request completes,
    one tensor-core ``flash_attention`` launch a layer a prefill, the
    greedy step a CUDA graph replayed every decode step, SLO percentiles
    and ``counters()`` printed; after ``close(drain=True)`` a clean
    ``BlockManager.check()`` and no block in use; then the eager and graph
    engines in turns (:func:`continuous_alternation`: graph == eager).
    Returns the ``flash_attention`` launches of the served requests."""
    from repro_torch.launch.serve import paged_spec
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import ContinuousEngine

    fa = model_wrappers()["flash_attention"]
    t0 = time.perf_counter()
    cfg, model = engine.cfg, engine.model
    prompts = corpus_prompts(work, SERVE_LENGTHS)
    max_len = CONT_MAX_LEN + cfg.n_img_tokens
    spec = paged_spec(max_len, CONT_BLOCK, CONT_SLOTS, prefix_cache=False)
    rows = cfg.n_img_tokens + max(len(p.encode()) + 1 for p in prompts) + SERVE_NEW_TOKENS - 1
    if spec.max_blocks_per_seq * CONT_BLOCK < rows:
        fail(f"continuous {VLM}: {spec.max_blocks_per_seq} blocks of {CONT_BLOCK} a slot "
             f"cannot hold {rows} rows (image positions, prompt and new tokens)")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, model, spec,
                           ServeConfig(max_new_tokens=SERVE_NEW_TOKENS,
                                       max_len=spec.max_len),
                           prefix_cache=True, device="cuda")
    if eng._index is not None:
        fail(f"continuous {VLM}: prefix sharing is on behind image positions")
    pool_bytes = sum(t.nbytes for layer in eng._cache for t in layer.values())
    fa.launches = fa.tc_launches = 0
    t1 = time.perf_counter()
    res = eng.generate(prompts)
    wall = time.perf_counter() - t1
    launches, tc = fa.launches, fa.tc_launches
    c = eng.counters()
    n_tokens = sum(len(r.token_ids) for r in res)
    peak = torch.cuda.max_memory_allocated()
    if c["completed"] != len(prompts) or any(not r.token_ids for r in res):
        fail(f"continuous {VLM}: {c['completed']:.0f} of {len(prompts)} requests "
             f"completed, tokens {[len(r.token_ids) for r in res]}")
    if launches != cfg.n_layers * len(prompts) or tc != launches:
        fail(f"continuous {VLM}: {launches} flash_attention launches ({tc} "
             f"tensor-core), want {cfg.n_layers * len(prompts)}, all tensor-core")
    if eng.decode != "graph" or eng.replays != eng.stats.steps:
        fail(f"continuous {VLM}: decode {eng.decode!r}, {eng.replays} replays for "
             f"{eng.stats.steps} steps: the greedy step did not replay a CUDA graph")
    print(f"continuous[{VLM}]: {cfg.n_layers} layers bf16, {cfg.n_img_tokens} image "
          f"positions a request; {CONT_SLOTS} slots x {spec.max_blocks_per_seq} blocks "
          f"of {CONT_BLOCK} (max_len {spec.max_len}), pool {spec.n_blocks} blocks = "
          f"{pool_bytes} bytes; all {len(prompts)} requests completed in {wall:.3f} s, "
          f"{n_tokens} tokens = {n_tokens / wall:.1f} tokens/s; {slo_text(eng)}; "
          f"counters {json.dumps({k: round(v, 4) for k, v in c.items()})}; "
          f"flash_attention {launches} launches (all tensor-core); prefix sharing "
          f"off (image positions); peak_allocated={peak} (own {peak - base}); "
          f"card: {card}", flush=True)
    drain_and_check(eng, f"continuous[{VLM}]")
    del eng
    torch.cuda.empty_cache()
    continuous_alternation(f"{VLM} continuous", cfg, model, prompts, card,
                           max_len=max_len)
    print(f"continuous[{VLM}]: {time.perf_counter() - t0:.1f} s for the phase",
          flush=True)
    return launches


def vlm_continuous_parity(work: Path, seed: int, card: str) -> None:
    """float32, internvl2-76b at full width cut to ``MODEL_LAYERS`` layers,
    one set of weights on the card: ``ContinuousEngine``'s greedy tokens
    (256 image positions in its block tables) equal the static
    ``Engine``'s on the 8 serving prompts (a differing token only at a
    printed near-tie, :func:`compare_tokens`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import paged_spec
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import ContinuousEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(VLM), n_layers=MODEL_LAYERS, dtype="float32")
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                                  "cuda")
    prompts = corpus_prompts(work, SERVE_LENGTHS)
    spec = paged_spec(CONT_MAX_LEN + cfg.n_img_tokens, CONT_BLOCK, CONT_SLOTS,
                      prefix_cache=False)
    scfg = ServeConfig(max_new_tokens=PARITY_NEW_TOKENS, max_len=spec.max_len)
    static = [r.token_ids for r in Engine(cfg, model, scfg, device="cuda").generate(prompts)]
    eng = ContinuousEngine(cfg, model, spec, scfg, prefix_cache=False, device="cuda")
    rows = [r.token_ids for r in eng.generate(prompts)]
    drain_and_check(eng, f"parity[{VLM}]")
    ties = compare_tokens(f"parity {VLM} continuous vs static", rows, static, model,
                          cfg, prompts)
    print(f"parity ({VLM} full width, {MODEL_LAYERS} layers, float32, allow_tf32=False, "
          f"{cfg.n_img_tokens} image positions, {len(prompts)} prompts, "
          f"{PARITY_NEW_TOKENS} new tokens): continuous == static with {ties} "
          f"near-ties; {time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    del model, eng
    torch.cuda.empty_cache()


def host_mem_available() -> int:
    """The host's ``MemAvailable`` in bytes (``/proc/meminfo``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return -1


STAGE_BYTES = 256 << 20    # each of the two pinned buffers a host copy goes through
# host memory a copy leaves free, and how long it waits for the host to hand
# back what the previous check freed (the allocator returns it with a delay)
HOST_MARGIN_BYTES = 12 << 30
HOST_WAIT_S = 60


def cpu_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A CPU copy of the card's ``model`` made without a second copy on the
    card: every parameter and buffer copied to the host first, then the
    modules around them (``copy.deepcopy`` finds the host tensors in its
    memo).  ``copy.deepcopy(model).to("cpu")`` would hold the model twice
    on the card, which a 47.6 GB model cannot.  It waits up to
    ``HOST_WAIT_S`` for the host to have the copy's bytes and
    ``HOST_MARGIN_BYTES`` more available, and fails the run if it does not
    (a host out of memory would lose the machine).  The copies go through two
    pinned buffers of ``STAGE_BYTES`` in turns (the card fills one while
    the host empties the other into the tensor's pageable memory): on the
    H100's host a plain ``.cpu()`` into fresh pages ran at 1.5–1.8 GB/s,
    the staged copy at 4.7–4.8 GB/s (``scripts/host_copy_rates.py``)."""
    import copy
    import gc
    import itertools

    need = sum(t.nbytes for t in itertools.chain(model.parameters(), model.buffers()))
    t0 = time.perf_counter()
    while host_mem_available() < need + HOST_MARGIN_BYTES:
        if time.perf_counter() - t0 > HOST_WAIT_S:
            fail(f"cpu_copy: the host has {host_mem_available()} bytes available, the "
                 f"copy needs {need} and leaves {HOST_MARGIN_BYTES} free")
        gc.collect()
        time.sleep(1.0)
    stages = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
              for _ in range(2)]
    stream = torch.cuda.Stream()
    done = [torch.cuda.Event() for _ in stages]

    def host(t: torch.Tensor) -> torch.Tensor:
        src = t.detach().contiguous().view(-1).view(torch.uint8)
        out = torch.empty(t.shape, dtype=t.dtype)
        dst = out.view(-1).view(torch.uint8)
        pending = [None, None]
        torch.cuda.current_stream().synchronize()   # t is written
        for i, lo in enumerate(range(0, src.numel(), STAGE_BYTES)):
            j = i % 2
            if pending[j] is not None:
                done[j].synchronize()
                a, b = pending[j]
                dst[a:b].copy_(stages[j][:b - a])
            hi = min(lo + STAGE_BYTES, src.numel())
            with torch.cuda.stream(stream):
                stages[j][:hi - lo].copy_(src[lo:hi], non_blocking=True)
                done[j].record(stream)
            pending[j] = (lo, hi)
        for j in (0, 1):
            if pending[j] is not None:
                done[j].synchronize()
                a, b = pending[j]
                dst[a:b].copy_(stages[j][:b - a])
        return out

    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        h = host(t)
        memo[id(t)] = (torch.nn.Parameter(h, requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else h)
    return copy.deepcopy(model, memo)


# the routed families' model checks: (arch, its config's fields replaced,
# prompt bytes).  jamba's cut is its published layers 2-3; its prompts span
# three SSD chunks of 256, as the SSM check's
ROUTED_CHECKS = {
    "moonshot-v1-16b-a3b": (dict(n_layers=MODEL_LAYERS), (255, 97)),
    QWEN3_MOE: (dict(n_layers=MODEL_LAYERS), (255, 97)),
    HYBRID: (HYBRID_CHECK_CUT, SSM_MODEL_LENGTHS),
}


def moe_model_check(work: Path, seed: int, card: str, arch: str) -> None:
    """``arch`` at full width with its ``ROUTED_CHECKS`` cut, in float32 with
    TF32 off, weights drawn on the card and copied to the CPU
    (:func:`cpu_copy`; the host's ``MemAvailable`` printed first): the
    router's top-k experts first (a flip passes only at a probability
    near-tie, and then the logits and caches are not comparable), then
    prefill logits and every layer's cache (K/V; on the hybrid's Mamba
    layers the SSM state and the convolution tail) within
    ``MODEL_ATOL``/``MODEL_RTOL``, dropped assignments equal on both
    sides, and each model kernel's launches (:func:`prefill_launches`)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.moe import monitor
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    fields, lengths = ROUTED_CHECKS[arch]
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **fields)
    api = build_model(cfg)
    avail = host_mem_available()
    card_model = api.init(torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in card_model.parameters())
    print(f"moe check[{arch}]: host MemAvailable {avail} bytes before the copy; "
          f"{n_params} parameters = {4 * n_params} bytes a side; drawn on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    cpu_model = cpu_copy(card_model)
    t2 = time.perf_counter()
    toks, lens = prompt_batch(corpus_prompts(work, lengths))
    with monitor(cpu_model) as r_cpu:
        want, want_cache = api.prefill(cpu_model, {"tokens": toks, "lengths": lens})
    split = f"copy to the host {t2 - t1:.1f} s, CPU prefill {time.perf_counter() - t2:.1f} s"
    wrappers = model_wrappers()
    reset_launches(wrappers.values())
    with monitor(card_model) as r_card:
        got, cache = api.prefill(card_model, {"tokens": toks.cuda(),
                                              "lengths": lens.cuda()})
        torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    want_launches = prefill_launches(cfg)
    n_moe = len(r_cpu)
    if not n_moe == len(r_card) > 0:
        fail(f"moe check[{arch}]: routing of {len(r_cpu)} MoE layers on the CPU, "
             f"{len(r_card)} on the card")
    flips, gaps = 0, []
    for c_cpu, c_card in zip(r_cpu, r_card):
        a = c_cpu.top_i.sort(dim=-1).values
        b = c_card.top_i.cpu().sort(dim=-1).values
        for t in (a != b).any(dim=-1).nonzero().flatten().tolist():
            flips += len(set(a[t].tolist()) - set(b[t].tolist()))
            gaps.append(float(c_cpu.margin[t]))
    got = got.cpu()
    drop_cpu = int(sum(c.dropped for c in r_cpu))
    drop_card = int(sum(c.dropped for c in r_card))
    if got.shape != (2, cfg.vocab_size) or not torch.isfinite(got).all():
        fail(f"moe check[{arch}]: logits {tuple(got.shape)} not finite or misshaped")
    err = float((got - want).abs().max())
    pairs = [(n, c[n].cpu(), w[n]) for c, w in zip(cache, want_cache) for n in sorted(w)]
    cache_err = {n: max(float((a - b).abs().max()) for m, a, b in pairs if m == n)
                 for n in sorted({n for n, _, _ in pairs})}
    cache_ok = all(a.shape == b.shape and torch.allclose(a, b, atol=MODEL_ATOL,
                                                         rtol=MODEL_RTOL)
                   for _, a, b in pairs)
    kinds = [(f"{type(l.mixer).__name__}+{type(l.ffn).__name__}" if hasattr(l, "mixer")
              else f"Attention+{'MoE' if l.moe is not None else 'SwiGLU'}")
             for l in card_model.layers]
    routing = (f"router top-{cfg.experts_per_token} identical on all "
               f"{toks.numel()} tokens x {n_moe} MoE layers" if not flips else
               f"{flips} assignments flipped, smallest top-k probability gap among "
               f"them {min(gaps):.3g}")
    print(f"model check: {arch} full width ({cfg.n_experts} experts of d_ff "
          f"{cfg.d_ff}, top-{cfg.experts_per_token}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size}), {cfg.n_layers} layers {kinds}, float32, "
          f"allow_tf32=False; prompts {lens.tolist()} tokens; {routing}; dropped "
          f"assignments CPU {drop_cpu}, card {drop_card}; card vs CPU prefill logits "
          f"max_abs_err={err:.6g}, caches max_abs_err {json.dumps(cache_err)} (atol "
          f"{MODEL_ATOL}, rtol {MODEL_RTOL}); launches {json.dumps(launches)}; "
          f"{time.perf_counter() - t0:.1f} s ({split}); card: {card}", flush=True)
    for kernel, n in launches.items():
        if n != want_launches.get(kernel, 0):
            fail(f"moe check[{arch}]: {n} {kernel} launches, want "
                 f"{want_launches.get(kernel, 0)}")
    if flips:
        if max(gaps) > MOE_NEAR_TIE:
            fail(f"moe check[{arch}]: routing differs at a probability gap of "
                 f"{max(gaps):.3g}")
        print(f"moe check[{arch}]: routing differs only at near-ties; the logits are "
              "not comparable after a flip", flush=True)
    else:
        if drop_cpu != drop_card:
            fail(f"moe check[{arch}]: dropped {drop_card} on the card, {drop_cpu} on "
                 "the CPU")
        if not torch.allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL):
            fail(f"moe check[{arch}]: card logits differ from the CPU's (max {err})")
        if not cache_ok:
            fail(f"moe check[{arch}]: card caches differ from the CPU's {cache_err}")
    del card_model, cpu_model, cache, want_cache, pairs, r_cpu, r_card
    gc.collect()
    torch.cuda.empty_cache()


def moe_serving_phase(work: Path, seed: int, card: str) -> int:
    """moonshot-v1-16b-a3b at its published widths and full depth, bf16:
    static serving through launch.serve.run (48 tensor-core
    ``flash_attention`` launches a prefill), then 8 requests through
    ``ContinuousEngine`` on the same weights (prefix sharing off for MoE).
    Returns the ``flash_attention`` launches of both."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import paged_spec
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import ContinuousEngine

    t0 = time.perf_counter()
    launches, engine, _ = lm_serving_phase(work, seed, "moonshot-v1-16b-a3b", card,
                                           max_len=CONT_MAX_LEN)
    launches = launches["flash_attention"]
    cfg, model = engine.cfg, engine.model
    del engine
    prompts = corpus_prompts(work, SERVE_LENGTHS)
    spec = paged_spec(CONT_MAX_LEN, CONT_BLOCK, CONT_SLOTS, prefix_cache=False)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, model, spec,
                           ServeConfig(max_new_tokens=SERVE_NEW_TOKENS,
                                       max_len=spec.max_len),
                           prefix_cache=True, device="cuda")
    if eng._index is not None:
        fail("continuous moonshot: prefix sharing is on for an MoE model")
    flash_attention_cuda.launches = flash_attention_cuda.tc_launches = 0
    t1 = time.perf_counter()
    res = eng.generate(prompts)
    wall = time.perf_counter() - t1
    cont = flash_attention_cuda.launches
    c = eng.counters()
    n_tokens = sum(len(r.token_ids) for r in res)
    peak = torch.cuda.max_memory_allocated()
    if c["completed"] != len(prompts) or any(not r.token_ids for r in res):
        fail(f"continuous moonshot: {c['completed']:.0f} of {len(prompts)} requests "
             "completed")
    if cont != cfg.n_layers * len(prompts) or flash_attention_cuda.tc_launches != cont:
        fail(f"continuous moonshot: {cont} flash_attention launches "
             f"({flash_attention_cuda.tc_launches} tensor-core), want "
             f"{cfg.n_layers * len(prompts)}, all tensor-core")
    print(f"continuous[moonshot-v1-16b-a3b]: all {len(prompts)} requests completed "
          f"in {wall:.3f} s, {n_tokens} tokens = {n_tokens / wall:.1f} tokens/s; "
          f"{slo_text(eng)}; peak_active {c['peak_active']:.0f}; pool "
          f"{spec.n_blocks} blocks; flash_attention {cont} launches (all "
          f"tensor-core); prefix sharing off (MoE); peak_allocated={peak} (own "
          f"{peak - base}); {time.perf_counter() - t0:.1f} s for the phase; "
          f"card: {card}", flush=True)
    drain_and_check(eng, "continuous[moonshot-v1-16b-a3b]")
    del eng, model
    torch.cuda.empty_cache()
    return launches + cont


# -- training ---------------------------------------------------------------
#
# Backward cases (FaCase, Sq = Skv).  yi-6b's training shape (B = 4
# sequences of 2,048 tokens), gemma3-12b's sliding-window layer (B = 1, S =
# 4,096, window 1,024), its training step's two layer kinds (B = 4, S =
# 2,048: window 1,024 and global) and whisper-small's encoder over 1,500
# frames (B = 4, no mask).  The ssd_scan backward at mamba2-1.3b's training
# shape: BH = 4 x 64 heads, C = 8 chunks of 256.
FA_TRAIN = FaCase("yi-6b train", 4, 32, 4, 2048, 2048, 128)
FA_TRAIN_WINDOW = FaCase("gemma3-12b window", 1, 16, 8, 4096, 4096, 256, window=1024)
FA_TRAIN_GEMMA = (FaCase("gemma3-12b train", 4, 16, 8, 2048, 2048, 256, window=1024),
                  FaCase("gemma3-12b train global", 4, 16, 8, 2048, 2048, 256))
FA_TRAIN_WHISPER = FaCase("whisper-small encoder train", 4, 12, 12, 1500, 1500, 64,
                          causal=False)
SSD_TRAIN = ("train", 256, 8, 64, 128)
TRAIN_PARITY = ("yi-6b", "moonshot-v1-16b-a3b", "mamba2-1.3b", QWEN2)
TRAIN_PARITY_LENGTHS = (255, 97)  # prompt bytes of the parity batch
# qwen2-72b's batch: 2 x 128 tokens (two of the float32 attention's 64-key
# tiles in row 0, a ragged row 1).  Its CPU side (4.25e9 parameters, a
# 152,064-word head over every token) costs ~0.15 s a token; at 2 x 256 the
# whole run would come within ~50 s of its limit on a slow host
TRAIN_PARITY_SHORT = {QWEN2: (127, 47)}
CRASH_ARCH = "jamba-1.5-large-398b"  # smoke: both kernels and the MoE on one path
TRAIN_SEQ, TRAIN_BATCH = 2048, 4
# the full-size runs: (arch, layers or None for the full depth, steps,
# whether the final checkpoint is written).  mamba2's checkpoint (and the
# crash/resume phase) keeps the save and restore path on the card; yi-6b's
# 14.6 GB one took ~52 s at ~0.28 GB/s and shows nothing more
FULL_TRAIN = (("mamba2-1.3b", None, 5, True), ("yi-6b", 4, 3, False))
# gemma3-12b's windowed training step: one published block (five window
# layers, one global), 2 steps, no checkpoint (its ~40 GB of state would
# take minutes to write)
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS = 6, 2
NOTHING_STEPS = 3          # the same state's steps under the "nothing" policy


def ssd_scan_backward_case(seed: int):
    """ssd_scan's backward at mamba2-1.3b's training shape: the gradient of
    the states equals autograd through the plain version on the card bit
    for bit (the adjoint is the same multiply-then-add recurrence), the
    decay's within 1e-5 of its P x N terms' magnitude; the backward launch
    (the kernel on flipped copies) timed warm and cold."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    name, bh, c, p, n = SSD_TRAIN
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    states = torch.randn((bh, c, p, n), generator=g, device=dev).requires_grad_()
    decay = torch.rand((bh, c), generator=g, device=dev).requires_grad_()
    d_out = torch.randn((bh, c, p, n), generator=g, device=dev)
    out = ssd_scan(states, decay)
    if out.grad_fn is None:
        fail("ssd_scan: the kernel's output carries no grad_fn")
    before = ssd_scan_cuda.launches
    d_states, d_decay = torch.autograd.grad(out, (states, decay), d_out,
                                            retain_graph=True)
    if ssd_scan_cuda.launches != before + 1:
        fail("ssd_scan backward: the kernel was not launched once")
    s2, d2 = states.detach().clone().requires_grad_(), decay.detach().clone().requires_grad_()
    want_s, want_d = torch.autograd.grad(ssd_scan_ref(s2, d2), (s2, d2), d_out)
    torch.cuda.synchronize()
    if not torch.equal(d_states, want_s):
        fail(f"ssd_scan backward: dstates differs from autograd of the plain version "
             f"({int((d_states != want_s).sum())} elements)")
    terms = (d_states * out.detach()).abs().sum(dim=(2, 3))
    dd_ratio = float(((d_decay - want_d).abs() / (1e-5 * terms + 1e-6)).max())
    if not dd_ratio <= 1.0:
        fail(f"ssd_scan backward: ddecay outside 1e-5 of its terms ({dd_ratio:.3g})")
    gf, df = d_out.flip(1).contiguous(), decay.detach().flip(1).contiguous()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: ssd_scan_cuda(gf, df), 20)
    cold = cold_ms(lambda: ssd_scan_cuda(gf, df), 10, flush)
    plain = cuda_ms(lambda: ssd_scan_ref(gf, df), 3, warmup=1)
    whole = cuda_ms(lambda: torch.autograd.grad(out, (states, decay), d_out,
                                                retain_graph=True), 10)
    nbytes = 2 * gf.numel() * 4 + df.numel() * 4
    bnd, by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (2 * gf.numel() / F32_FLOPS_PER_S * 1e3, "operations"))
    print(f"ssd_scan backward[{name}]: BH={bh} C={c} P={p} N={n} f32; dstates "
          f"bit-exact with autograd through the plain version, ddecay within "
          f"{dd_ratio:.3g} of 1e-5 x sum|terms|; backward launch kernel_ms={ms:.6f} "
          f"cold_ms={cold:.6f} plain_ms={plain:.6f} library_ms=null bound_ms="
          f"{bnd:.6f} ({by}); whole backward (flips, launch, ddecay sum) "
          f"{whole:.6f} ms", flush=True)
    del states, decay, d_out, out, d_states, d_decay, want_s, want_d, gf, df, flush
    torch.cuda.empty_cache()
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bnd, whole_ms=whole)


def drop_key_tile(q, k, v, out, d_out, lse, grads, causal, window, tile=FA_DROP):
    """``grads`` as a backward that never visits keys 0 .. tile - 1 would
    give them: dk and dv of those keys 0, dq without their ``scale dS K``
    terms (dS from the kernel's lse and bf16 output, in float32)."""
    dq, dk, dv = (x.float() for x in grads)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, d ** -0.5
    kt, vt = (x[:, :, None, :tile].float() for x in (k, v))
    pos = torch.arange(sq, device=q.device)[:, None] + skv - sq
    key = torch.arange(kt.shape[3], device=q.device)[None, :]
    vis = key <= pos if causal else torch.ones_like(key <= pos)
    if window is not None:
        vis = vis & (key > pos - window)
    s = (q.float() * scale).reshape(b, hkv, g, sq, d) @ kt.transpose(-1, -2)
    p = torch.exp(s.masked_fill(~vis, -torch.inf) - lse.reshape(b, hkv, g, sq, 1))
    do = d_out.float().reshape(b, hkv, g, sq, d)
    delta = (do * out.float().reshape(b, hkv, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (do @ vt.transpose(-1, -2) - delta)
    dq = dq - scale * (ds @ kt).reshape(b, hq, sq, d)
    dk[:, :, :tile] = 0.0
    dv[:, :, :tile] = 0.0
    return dq, dk, dv


def attention_backward_case(case: FaCase, seed: int):
    """flash_attention's backward kernel (``csrc/flash_attention_bwd.cu``,
    after the tensor-core forward, which then writes the rows'
    log-sum-exp) in bfloat16 at a training shape, through autograd: one
    backward launch (its three kernels once each); dq, dk, dv within
    ``grad_bound_excess(tensor_core=True)`` (derived from the forward's
    bound plus the kernel's bf16 roundings of P and dS) against autograd
    through the plain version in float32; a backward without ``D =
    rowsum(dO * O)`` and one that drops the first key tile must read
    outside it; two launches bit-identical; the forward's lse within
    ``lse_excess``'s tolerance.  Timed warm and L2-cold beside the plain
    version (``flash_attention_bwd``, float32 PyTorch ops) and SDPA's
    backward (for the record: the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.backward import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.grad import flash_attention_bwd
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, route
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_ref,
        grad_bound_excess,
        lse_excess,
    )

    name, b, hq, hkv, s, _, d, window, causal, _ = case
    mode = dict(causal=causal, window=window)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 11)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
               .transpose(1, 2).requires_grad_() for h in (hq, hkv, hkv))
    d_out = torch.randn((b, hq, s, d), generator=g, device=dev).to(torch.bfloat16)
    if route(q, k, v) != "tensor_core":
        fail(f"flash_attention backward {name}: the forward left the tensor-core route")
    counters = ("launches", "delta_launches", "dkdv_launches", "dq_launches")
    before = [getattr(flash_attention_bwd_cuda, c) for c in counters]
    out = flash_attention(q, k, v, **mode)
    if out.grad_fn is None:
        fail("flash_attention: the kernel's output carries no grad_fn")
    grads = torch.autograd.grad(out, (q, k, v), d_out)
    torch.cuda.synchronize()
    launched = [getattr(flash_attention_bwd_cuda, c) - n for c, n in zip(counters, before)]
    if launched != [1, 1, 1, 1]:
        fail(f"flash_attention backward {name}: launches {dict(zip(counters, launched))}, "
             "want one backward of three kernels")
    qd, kd, vd, od = (t.detach() for t in (q, k, v, out))
    plain_out = flash_attention_cuda(qd, kd, vd, **mode)
    _, lse = flash_attention_cuda(qd, kd, vd, **mode, return_lse=True)
    if not torch.equal(plain_out.view(torch.int16), od.view(torch.int16)):
        fail(f"flash_attention backward {name}: the forward's bits change with the lse")
    lse_ratio = lse_excess(lse, attention_lse_ref(qd.float(), kd.float(), vd.float(), **mode))
    ratios = grad_bound_excess(q, k, v, d_out, grads, causal, window, tensor_core=True)
    no_d = grad_bound_excess(q, k, v, d_out, flash_attention_bwd(
        qd, kd, vd, torch.zeros_like(od), d_out, **mode), causal, window, tensor_core=True)
    lost = grad_bound_excess(q, k, v, d_out, drop_key_tile(
        qd, kd, vd, od, d_out, lse, grads, causal, window), causal, window,
        tensor_core=True)
    again = [flash_attention_bwd_cuda(qd, kd, vd, od, d_out, lse, **mode) for _ in range(2)]
    same = all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(*again))
    plain = flash_attention_bwd(qd, kd, vd, od, d_out, **mode)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(grads, plain))
    del again, plain_out
    checks = (f"dq, dk, dv at {', '.join(f'{r:.4g}' for r in ratios)} of the derived "
              f"tensor-core bound (without D: {', '.join(f'{r:.4g}' for r in no_d)}; keys "
              f"0..{FA_DROP - 1} dropped: {', '.join(f'{r:.4g}' for r in lost)}); two "
              f"launches {'bit-identical' if same else 'DIFFERENT'}; lse at "
              f"{lse_ratio:.4g} of 1e-5 (1 + |lse|); max |kernel - plain| {err:.6g}")
    if not max(ratios) <= 1.0:
        fail(f"flash_attention backward {name}: outside the bound ({checks})")
    if not (max(no_d) > 1.0 and max(lost) > 1.0):
        fail(f"flash_attention backward {name}: the bound passes a wrong backward ({checks})")
    if not same or not lse_ratio <= 1.0:
        fail(f"flash_attention backward {name}: {checks}")
    del grads
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    kern = lambda: flash_attention_bwd_cuda(qd, kd, vd, od, d_out, lse, **mode)  # noqa: E731
    ms = cuda_ms(kern, 20)
    cold = cold_ms(kern, 10, flush)
    plain_ms = cuda_ms(lambda: flash_attention_bwd(qd, kd, vd, od, d_out, **mode), 3,
                       warmup=1)
    fwd = cuda_ms(lambda: flash_attention_cuda(qd, kd, vd, **mode), 10)
    mask = sdpa_mask(case, dev)
    lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             is_causal=causal and mask is None,
                                             enable_gqa=True)
    library = cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), d_out,
                                                  retain_graph=True), 10, warmup=2)
    # S, dP, dV, dQ, dK of the visible pairs; q, out, dO, k, v, lse in; dq,
    # dk, dv out; D written and read
    flops, nbytes = attention_bwd_work(b, hq, hkv, s, s, d, causal, window, 2)
    bnd, by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (flops / BF16_FLOPS_PER_S * 1e3, "operations"))
    print(f"flash_attention backward[{name}]: B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
          f"window={window} bf16 {'causal' if causal else 'non-causal'}; {checks}; "
          f"kernel_ms={ms:.6f} cold_ms={cold:.6f} plain_ms={plain_ms:.6f} (PyTorch ops, "
          f"float32 products) library_ms(sdpa backward)={library:.6f} forward "
          f"kernel_ms={fwd:.6f} flops={flops} bytes={nbytes} bound_ms={bnd:.6f} ({by}, "
          f"five products at the bf16 tensor-core peak) tflops(5 products)="
          f"{flops / ms / 1e9:.1f}", flush=True)
    del q, k, v, out, d_out, lib_out, qd, kd, vd, od, lse, mask, flush
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library, bound_ms=bnd, bound_by=by,
                max_abs_err=err)


def _loss_and_grads(api, model, batch):
    loss, metrics = api.loss(model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return float(loss.detach()), metrics, {n: torch.zeros_like(p) if gr is None else gr
                                  for (n, p), gr in zip(named.items(), grads)}


def train_parity_phase(work: Path, seed: int, wrappers) -> None:
    """yi-6b, moonshot-v1-16b-a3b, mamba2-1.3b and qwen2-72b (its QKV biases
    drawn after the init; their gradients' errors printed by name) at full
    width cut to ``MODEL_LAYERS`` layers, float32 with TF32 off, one train
    state drawn on the card and copied to the CPU, one batch of two corpus
    prompts (``TRAIN_PARITY_SHORT``'s where it names the arch): the loss and every parameter's gradient on the card against the CPU's
    within ``MODEL_ATOL``/``MODEL_RTOL``, and every parameter with a
    non-zero CPU gradient has one on the card (a kernel output cut off from
    autograd would leave zeros upstream).  MoE routing is compared first:
    a flip passes only at a probability near-tie, and then the gradients
    are not comparable.  Per layer, ``flash_attention`` must launch twice
    (forward, recompute) and ``ssd_scan`` three times (forward, recompute,
    backward)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.common import draw_qkv_biases
    from repro_torch.models.moe import MoE, monitor
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in TRAIN_PARITY:
        t0 = time.perf_counter()
        toks, lens = prompt_batch(corpus_prompts(
            work, TRAIN_PARITY_SHORT.get(arch, TRAIN_PARITY_LENGTHS)))
        mask = (torch.arange(toks.shape[1])[None, :] < lens[:, None]).float()
        cfg = dataclasses.replace(get_config(arch), n_layers=MODEL_LAYERS, dtype="float32")
        api = build_model(cfg)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        card_model = make_train_state(api, g, device="cuda")["model"]
        draw_qkv_biases(card_model, g)
        cpu_model = cpu_copy(card_model)
        moe = any(isinstance(m, MoE) for m in card_model.modules())
        batch = {"tokens": toks, "loss_mask": mask}
        with monitor(cpu_model) as r_cpu:
            want, _, want_g = _loss_and_grads(api, cpu_model, batch)
        reset_launches(wrappers.values())
        with monitor(card_model) as r_card:
            got, _, got_g = _loss_and_grads(api, card_model,
                                            {k: t.cuda() for k, t in batch.items()})
            torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        flips, gaps = 0, []
        for c_cpu, c_card in zip(r_cpu[:MODEL_LAYERS], r_card[:MODEL_LAYERS]):
            a = c_cpu.top_i.sort(dim=-1).values
            b = c_card.top_i.cpu().sort(dim=-1).values
            for t in (a != b).any(dim=-1).nonzero().flatten().tolist():
                flips += len(set(a[t].tolist()) - set(b[t].tolist()))
                gaps.append(float(c_cpu.margin[t]))
        worst, worst_rel, dead = 0.0, 0.0, []
        bad, bias_err = [], {}
        for n, wg in want_g.items():
            # compared on the card: the host's passes over a 4.25e9-parameter
            # model's gradients took longer than its backward
            gg, wg = got_g[n], wg.cuda()
            if not torch.isfinite(gg).all():
                fail(f"train parity {arch}: gradient of {n} not finite on the card")
            err = float((gg - wg).abs().max())
            worst = max(worst, err)
            if n.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                bias_err[n] = f"{err:.3g} (|grad| max {float(wg.abs().max()):.3g})"
            worst_rel = max(worst_rel, float((gg - wg).norm() / max(float(wg.norm()), 1e-30)))
            if bool((wg != 0).any()) and not bool((gg != 0).any()):
                dead.append(n)
            if not torch.allclose(gg, wg, atol=MODEL_ATOL, rtol=MODEL_RTOL):
                bad.append(n)
        routing = ("" if not moe else f"; router top-{cfg.experts_per_token} " + (
            "identical" if not flips else f"{flips} assignments flipped (smallest gap "
            f"{min(gaps):.3g})"))
        biases = (f"; QKV bias gradients max_abs_err {json.dumps(bias_err)}"
                  if bias_err else "")
        want_l = {"flash_attention": 2 * MODEL_LAYERS if cfg.family != "ssm" else 0,
                  "ssd_scan": 3 * MODEL_LAYERS if cfg.family == "ssm" else 0}
        print(f"train parity: {arch} full width, {MODEL_LAYERS} layers, float32, "
              f"allow_tf32=False; batch {lens.tolist()} tokens; loss card {got:.7g} CPU "
              f"{want:.7g}; {len(want_g)} parameter gradients: max_abs_err={worst:.6g}, "
              f"worst relative norm error {worst_rel:.3g} (atol {MODEL_ATOL}, rtol "
              f"{MODEL_RTOL}), zero on the card where non-zero on the CPU: {len(dead)}"
              f"{routing}{biases}; launches {json.dumps(launches)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for kernel, want_n in want_l.items():
            if launches[kernel] != want_n:
                fail(f"train parity {arch}: {launches[kernel]} {kernel} launches, "
                     f"want {want_n}")
        if dead:
            fail(f"train parity {arch}: gradients cut off on the card: {dead[:5]}")
        if flips:
            if max(gaps) > MOE_NEAR_TIE:
                fail(f"train parity {arch}: routing differs at a gap of {max(gaps):.3g}")
            print(f"train parity {arch}: routing differs only at near-ties; the "
                  "gradients are not comparable after a flip", flush=True)
        else:
            if not abs(got - want) <= MODEL_ATOL + MODEL_RTOL * abs(want):
                fail(f"train parity {arch}: loss {got} on the card, {want} on the CPU")
            if bad:
                fail(f"train parity {arch}: gradients differ: {bad[:5]}")
        del card_model, cpu_model, got_g, want_g, r_cpu, r_card
        torch.cuda.empty_cache()


def crash_resume_phase(work: Path, seed: int) -> None:
    """``Trainer`` on the card (jamba's smoke config in float32, batches
    fetched through the index and verified by ``hash_mix``), checkpoints
    every 2 steps: a run that dies at step 3 and resumes from step 2 gives
    the uninterrupted run's losses and state bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import RecordStore, build_index
    from repro_torch.data.pipeline import IndexedDataset
    from repro_torch.models.weights import state_to_reference
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    store = RecordStore(work / "corpus")
    ds = IndexedDataset(store, build_index(store), 256, device="cuda")
    cfg = dataclasses.replace(get_config(CRASH_ARCH).smoke(), dtype="float32")
    tcfg = TrainerConfig(seq_len=256, global_batch=4, steps=4, ckpt_every=2,
                         compress_grads=True, seed=seed,
                         opt=AdamWConfig(warmup_steps=2, total_steps=4))

    def trainer(name):
        return Trainer(cfg, tcfg, ds, work / "crash_resume" / name, device="cuda")

    _, whole_state, whole = trainer("whole").run()
    reached, _, _ = trainer("crash").run(die_at_step=3)
    _, state, resumed = trainer("crash").run()
    ds.close()
    key = lambda h: (h["step"], h["loss"], h["grad_norm"], h["lr"])
    same = [key(h) for h in resumed] == [key(h) for h in whole[2:]]
    a, b = state_to_reference(state), state_to_reference(whole_state)
    diff = [n for n in a if not torch.equal(a[n], b[n])]
    print(f"crash/resume: {CRASH_ARCH} smoke, float32, int8_ef, on the card: died at "
          f"step {reached}, resumed from step 2; losses {[round(h['loss'], 6) for h in resumed]} "
          f"vs uninterrupted {[round(h['loss'], 6) for h in whole[2:]]}: "
          f"{'bit for bit' if same else 'DIFFERENT'}; state tensors differing: "
          f"{len(diff)} of {len(a)}; {time.perf_counter() - t0:.1f} s", flush=True)
    if reached != 3 or not same or diff:
        fail(f"crash/resume: the resumed run differs from the uninterrupted one "
             f"({diff[:5]})")


def profile_train_step(tr, state, step: int, card: str, label: str) -> dict:
    """One more train step under ``torch.profiler``: the device busy time,
    the share of it under the ``flash_attention.backward`` span and in the
    backward's kernels by name (``fa_backward_*``, so that the share does
    not rest on the profiler tying ctypes launches to the span), in the
    ``ssd_scan`` kernel, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = tr.batch(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = tr._step_fn(state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    attn_bwd = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU
                   and e.name == "flash_attention.backward") / 1e3
    per: dict = {}
    for e in device:
        t, n = per.get(e.name, (0.0, 0))
        per[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    scan = sum(t for name, (t, _) in per.items() if "ssd_scan" in name)
    fa_fwd = sum(t for name, (t, _) in per.items() if "fa_forward" in name)
    fa_bwd = sum(t for name, (t, _) in per.items() if "fa_backward" in name)
    tops = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    top = "; ".join(f"{k[:50]} {t:.3f} ms x{n}" for k, (t, n) in tops)
    if busy <= 0:
        print(f"train_profile[{label}]: the profiler saw no device time: shares not "
              "measured", flush=True)
        return {}
    print(f"train_profile[{label}]: one step under the profiler, wall {wall * 1e3:.3f} ms, "
          f"device busy {busy:.3f} ms ({busy / (wall * 1e3):.3f} of the wall); "
          f"flash_attention.backward span {attn_bwd:.3f} ms = {attn_bwd / busy:.4f} of the "
          f"busy time; fa_backward kernels {fa_bwd:.3f} ms = {fa_bwd / busy:.4f}; "
          f"fa_forward kernels {fa_fwd:.3f} ms = {fa_fwd / busy:.4f}; "
          f"ssd_scan kernel {scan:.3f} ms = {scan / busy:.4f}; top: {top}; card: {card}",
          flush=True)
    return dict(busy_ms=busy, attn_bwd_ms=attn_bwd, attn_bwd_share=attn_bwd / busy,
                bwd_kernels_ms=fa_bwd, bwd_kernels_share=fa_bwd / busy, scan_ms=scan)


def full_training_phase(work: Path, arch: str, layers, steps: int, card: str,
                        wrappers, ckpt: bool = True) -> dict:
    """``arch`` at its published widths (``layers`` cuts the depth), bf16
    compute over float32 masters and moments, through
    ``repro_torch.launch.train``: ``TRAIN_BATCH`` sequences of
    ``TRAIN_SEQ`` tokens, ``steps`` steps, the only checkpoint the final one (timed,
    sized, deleted).  Without ``ckpt`` no checkpoint is written: the
    launcher's trainer (``train.build``) stops after its last step as a run
    that dies there does (``Trainer.run(die_at_step=)``), since the trainer
    writes one at its last step whatever ``--ckpt-every`` says.  Every
    kernel's launches per step are counted (reset just before the run);
    ``flash_attention`` must launch twice a layer a step (forward,
    recompute) on the tensor-core route, ``ssd_scan`` three times
    (forward, recompute, backward), and the attention backward kernel once
    a layer a step (its three kernels once each), with a window on each
    window layer.  Then one more step under the profiler."""
    import shutil

    from repro_torch.launch import train

    wd = work / f"train-{arch}"
    args = train.build_parser().parse_args(
        ["--arch", arch, "--full-config", "--device", "cuda", "--steps", str(steps),
         "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
         "--ckpt-every", str(steps), "--workdir", str(wd)]
        + (["--layers", str(layers)] if layers else []))
    per_step = []
    last = {}

    def counts():
        return {f"{n}{'' if a == 'launches' else '.' + a}": getattr(fn, a)
                for n, fn in wrappers.items() for a in sorted(vars(fn))
                if a.endswith("launches")}

    def on_step(step, rec):
        now = counts()
        per_step.append({k: v - last.get(k, 0) for k, v in now.items()})
        last.update(now)
        print(f"train[{arch}] step {step}: loss {rec['loss']:.4f} grad_norm "
              f"{rec['grad_norm']:.4f} lr {rec['lr']:.3g} step_ms {rec['dt'] * 1e3:.3f}",
              flush=True)

    free = shutil.disk_usage(work).free
    reset_launches(wrappers.values())
    last.update(counts())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr, ds = train.build(args)
    try:
        final, state, hist = tr.run(on_step=on_step, die_at_step=None if ckpt else steps)
    finally:
        ds.close()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = state["model"]
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    if final != steps or len(hist) != steps:
        fail(f"train[{arch}]: stopped at step {final}")
    for h in hist:
        if not np.isfinite(h["loss"]) or not np.isfinite(h["grad_norm"]):
            fail(f"train[{arch}]: step {h['step']} loss {h['loss']} not finite")
    fam = tr.api.cfg.family
    attn = n_layers if fam != "ssm" else 0
    windowed = sum(w is not None for w in model.windows()) if attn else 0
    want = {"flash_attention": 2 * attn, "flash_attention.tc_launches": 2 * attn,
            "ssd_scan": 3 * n_layers if fam == "ssm" else 0,
            "flash_attention_bwd": attn, "flash_attention_bwd.delta_launches": attn,
            "flash_attention_bwd.dkdv_launches": attn,
            "flash_attention_bwd.dq_launches": attn,
            "flash_attention_bwd.window_launches": windowed}
    for i, got in enumerate(per_step):
        for k, n in want.items():
            if got[k] != n:
                fail(f"train[{arch}] step {i}: {got[k]} {k} launches, want {n}")
    if ckpt:
        ckpt_dir = tr.ckpt.root / f"step_{steps:08d}"
        ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
        ckpt_s = hist[-1]["ckpt_s"]
        saved = (f"final checkpoint {ckpt_bytes} bytes in {ckpt_s:.3f} s "
                 f"({ckpt_bytes / ckpt_s / 1e9:.3f} GB/s; {free} bytes free before)")
    else:
        saved = "no checkpoint written"
    steady = [h["dt"] for h in hist[1:]]
    step_ms = float(np.median(steady)) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train[{arch}]: {n_layers} layers at full width ({n_params} parameters, "
          f"{windowed} with a sliding window), "
          f"bf16 compute, float32 masters and moments, B={TRAIN_BATCH} x S={TRAIN_SEQ}; "
          f"{steps} steps in {secs:.1f} s (corpus, index and init included); step_ms "
          f"first {hist[0]['dt'] * 1e3:.3f}, then {', '.join(f'{d * 1e3:.3f}' for d in steady)} "
          f"(median {step_ms:.3f}) = {tokens / step_ms * 1e3:.1f} tokens/s; "
          f"peak_allocated={peak} (at the start {base}); launches per step "
          f"{json.dumps(per_step[-1])}; losses {[round(h['loss'], 4) for h in hist]}; "
          f"grad norms {[round(h['grad_norm'], 4) for h in hist]}; {saved}; "
          f"card: {card}", flush=True)
    if ckpt:
        shutil.rmtree(tr.ckpt.root)
    prof = profile_train_step(tr, state, steps, card, arch)
    nothing = nothing_policy_steps(tr, state, steps + 1, arch, counts, want, card)
    print(f"train[{arch}] remat policies: \"names\" step_ms {step_ms:.3f} "
          f"peak_allocated {peak}; \"nothing\" step_ms {nothing['step_ms']:.3f} "
          f"peak_allocated {nothing['peak']}; nothing / names = "
          f"{nothing['step_ms'] / step_ms:.4f}; card: {card}", flush=True)
    del tr, state, model
    torch.cuda.empty_cache()
    return dict(launches=per_step + nothing["launches"], steps=steps,
                step_ms=step_ms, prof=prof, nothing_ms=nothing["step_ms"])


def nothing_policy_steps(tr, state, start: int, arch: str, counts, want: dict,
                         card: str) -> dict:
    """``NOTHING_STEPS`` more steps of the trained state under the remat
    policy "nothing" (each layer recomputed whole), no checkpoint: step ms
    (host clock around the step and its loss read-back), tokens/s, peak
    bytes and the kernels' launches a step, which the derivation in
    PERF.md puts equal to "names"'s (``want``)."""
    from repro_torch import flags

    saved = flags.REMAT_POLICY
    flags.REMAT_POLICY = "nothing"
    dts, per = [], []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(NOTHING_STEPS):
            before = counts()
            batch = tr.batch(start + i)
            t0 = time.perf_counter()
            state, metrics = tr._step_fn(state, batch)
            loss = float(metrics["loss"])
            dts.append(time.perf_counter() - t0)
            per.append({k: v - before[k] for k, v in counts().items()})
            if not np.isfinite(loss):
                fail(f"train[{arch}] \"nothing\" step {i}: loss {loss} not finite")
        peak = torch.cuda.max_memory_allocated()
    finally:
        flags.REMAT_POLICY = saved
    for i, got in enumerate(per):
        for k, n in want.items():
            if got[k] != n:
                fail(f"train[{arch}] \"nothing\" step {i}: {got[k]} {k} launches, "
                     f"want {n}")
    step_ms = float(np.median(dts)) * 1e3
    print(f"train[{arch}] remat \"nothing\": {NOTHING_STEPS} steps, no checkpoint, "
          f"step_ms {', '.join(f'{d * 1e3:.3f}' for d in dts)} (median {step_ms:.3f}) = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s; peak_allocated "
          f"{peak}; launches per step {json.dumps(per[-1])}; card: {card}", flush=True)
    return dict(step_ms=step_ms, peak=peak, launches=per)


# ---------------------------------------------------------------------------
# execution over a mesh (one card: a 1x1 DeviceMesh over a one-rank NCCL group)
# ---------------------------------------------------------------------------

MESH_TRAIN_SEQ = 256       # the mesh trainer's batches: 4 x 256 corpus tokens
MESH_TRAIN_STEPS = 2
# a dry-run bound above this many times the measured time is a wrong count
DRYRUN_SLACK = 1.05
DRYRUN_FAKE_CELL = ("yi-6b", "train_4k")   # on the 32 x 8 production mesh


def one_card_mesh():
    """The ("data", "model") = (1, 1) DeviceMesh of this process's card."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    print(f"mesh: {mesh} over a {torch.distributed.get_backend()} group of "
          f"{torch.distributed.get_world_size()}", flush=True)
    return mesh


def mesh_serving_phase(work: Path, engine, static_runs, mesh, card: str) -> int:
    """yi-6b at full size through ``Engine(mesh=1x1, param_specs=...)`` on
    the weights step 6 served (wrapped as DTensors, no copy), the same 8
    prompts, twice: the tokens must equal step 6's unsharded tokens, and
    ``flash_attention`` must launch once a layer a prefill, all on the
    tensor-core route (counts set to 0 just before).  Prints the prefill
    ms and decode tokens/s beside step 6's, and the phase's own peak.
    Returns the launches."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models.specs import param_specs
    from repro_torch.serve.engine import Engine

    prompts = corpus_prompts(work, SERVE_LENGTHS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(engine.cfg, engine.model, engine.scfg, device="cuda", mesh=mesh,
                 param_specs=param_specs(engine.model))
    plain = dict(engine.model.named_parameters())
    for name, p in eng.model.named_parameters():
        if p.to_local().data_ptr() != plain[name].data_ptr():
            fail(f"mesh serving: {name} was copied")
    flash_attention_cuda.launches = flash_attention_cuda.tc_launches = 0
    runs = [eng.generate(prompts) for _ in range(2)]
    launches, tc = flash_attention_cuda.launches, flash_attention_cuda.tc_launches
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = 2 * engine.cfg.n_layers
    if launches != want or tc != want:
        fail(f"mesh serving: {launches} flash_attention launches ({tc} on the "
             f"tensor-core route), want {want}, all tensor-core")
    for i, res in enumerate(runs):
        if [r.token_ids for r in res] != static_runs[0]["token_ids"]:
            fail(f"mesh serving: run {i}'s tokens differ from the unsharded engine's")
    for i, (res, ref) in enumerate(zip(runs, static_runs)):
        r = res[0]
        tps = len(res) * r.steps / r.decode_s
        print(f"mesh_serving[yi-6b, 1x1 mesh] run {i}: prefill_ms={r.prefill_s * 1e3:.3f} "
              f"(unsharded, step 6: {ref['prefill_ms']:.3f}); decode {r.steps} steps "
              f"{tps:.1f} tokens/s (unsharded: {ref['decode_tokens_per_s']:.1f}); "
              f"card: {card}", flush=True)
    print(f"mesh_serving[yi-6b]: {engine.cfg.n_layers} layers bf16, every parameter a "
          f"DTensor on the 1x1 mesh sharing the unsharded weights' storage; tokens "
          f"identical to step 6's over 2 runs; flash_attention launches {launches} "
          f"({engine.cfg.n_layers} a prefill, all on the tensor-core route); own peak "
          f"{peak - base} bytes (allocated at the start {base}); {secs:.1f} s", flush=True)
    del eng, runs
    torch.cuda.empty_cache()
    return launches


def moe_mesh_check(work: Path, seed: int, mesh, card: str) -> int:
    """moonshot-v1-16b-a3b at full width cut to ``MODEL_LAYERS`` layers,
    float32 with TF32 off: the expert-parallel path at model = 1 on the
    1x1 mesh against ``mesh=None`` on the same weights: the router's top-6
    equal, the prefill logits within ``MODEL_ATOL``/``MODEL_RTOL``, the
    dropped assignments equal.  Returns the mesh run's ``flash_attention``
    launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist.logical import use_mesh
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.sharding import (batch_shardings, distribute,
                                             distribute_params, module_copy)
    from repro_torch.models.moe import monitor
    from repro_torch.models.specs import param_specs
    from repro_torch.models.transformer import init_lm, lm_prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              n_layers=MODEL_LAYERS, dtype="float32")
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    toks, lens = prompt_batch(corpus_prompts(work, (255, 97)))
    batch = {"tokens": toks.cuda(), "lengths": lens.cuda()}
    with monitor(model) as r_plain:
        want, _ = lm_prefill(model, cfg, batch["tokens"], lengths=batch["lengths"])
    sharded = distribute_params(module_copy(model), mesh, param_specs(model))
    pls = batch_shardings(mesh, batch)
    dbatch = {k: distribute(v, mesh, pls[k]) for k, v in batch.items()}
    flash_attention_cuda.launches = 0
    with use_mesh(mesh), monitor(sharded) as r_mesh:
        got, _ = lm_prefill(sharded, cfg, dbatch["tokens"], lengths=dbatch["lengths"])
        got = got.full_tensor()
        routed = [(c.top_i.full_tensor(), int(c.dropped.full_tensor())) for c in r_mesh]
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    same_top = all(torch.equal(a.top_i, b) for a, (b, _) in zip(r_plain, routed))
    drop_plain = int(sum(c.dropped for c in r_plain))
    drop_mesh = sum(d for _, d in routed)
    err = float((got - want).abs().max())
    print(f"mesh moe: moonshot-v1-16b-a3b full width, {MODEL_LAYERS} layers, float32, "
          f"allow_tf32=False, expert-parallel path on the 1x1 mesh ({cfg.n_experts} "
          f"experts on the one model rank) against mesh=None: router top-"
          f"{cfg.experts_per_token} {'identical' if same_top else 'DIFFERENT'} on "
          f"{toks.numel()} tokens x {len(routed)} layers; dropped {drop_mesh} (mesh) "
          f"{drop_plain} (none); logits max_abs_err={err:.6g} (atol {MODEL_ATOL}, rtol "
          f"{MODEL_RTOL}); flash_attention launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    if len(routed) != MODEL_LAYERS or not same_top:
        fail("mesh moe: the expert-parallel path routed otherwise")
    if drop_mesh != drop_plain:
        fail(f"mesh moe: {drop_mesh} dropped on the mesh, {drop_plain} without")
    if not torch.allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL):
        fail(f"mesh moe: logits differ (max {err})")
    if launches != MODEL_LAYERS:
        fail(f"mesh moe: {launches} flash_attention launches, want {MODEL_LAYERS}")
    del model, sharded, want, got
    torch.cuda.empty_cache()
    return launches


def trainer_mesh_check(work: Path, seed: int, mesh, card: str) -> int:
    """``Trainer.run`` with ``mesh=1x1`` against ``mesh=None`` on mamba2-1.3b
    at full width cut to ``MODEL_LAYERS`` layers, float32 with TF32 off,
    both from the state ``seed`` draws, ``MESH_TRAIN_STEPS`` steps on the
    same batches, each ending in the trainer's checkpoint (on the mesh:
    every parameter gathered whole, written by rank 0, then a barrier over
    NCCL): loss and grad norm within ``MODEL_ATOL``/``MODEL_RTOL``; the
    mesh run's checkpoint restores into an unsharded trainer equal to the
    state it held; ``ssd_scan`` must launch 3 times a layer a step on the
    mesh (counts set to 0 just before).  Returns those launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import RecordStore, build_index
    from repro_torch.data.pipeline import IndexedDataset
    from repro_torch.dist.logical import whole
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    store = RecordStore(work / "corpus")
    ds = IndexedDataset(store, build_index(store), MESH_TRAIN_SEQ, device="cuda")
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=MODEL_LAYERS,
                              dtype="float32")
    tcfg = TrainerConfig(seq_len=MESH_TRAIN_SEQ, global_batch=4,
                         steps=MESH_TRAIN_STEPS, seed=seed,
                         opt=AdamWConfig(warmup_steps=1, total_steps=MESH_TRAIN_STEPS))
    hist = {}
    for name, m in (("none", None), ("1x1", mesh)):
        tr = Trainer(cfg, tcfg, ds, work / f"mesh_trainer_{name}", mesh=m, device="cuda")
        state = tr.init_state()
        ssd_scan_cuda.launches = 0
        done, state, history = tr.run(until_step=MESH_TRAIN_STEPS, state=state)
        torch.cuda.synchronize()
        launches = ssd_scan_cuda.launches
        hist[name] = [{k: r[k] for k in ("loss", "grad_norm", "lr", "ckpt_s") if k in r}
                      for r in history]
        if done != MESH_TRAIN_STEPS or "ckpt_s" not in history[-1]:
            fail(f"mesh trainer ({name}): ran to step {done} without its checkpoint")
        if m is not None:
            kinds = {type(p).__name__ for p in state["model"].parameters()}
            held = {n: whole(p.detach()) for n, p in state["model"].named_parameters()}
        del tr, state
        torch.cuda.empty_cache()
    back = Trainer(cfg, tcfg, ds, work / "mesh_trainer_1x1", device="cuda")
    step, restored = back.maybe_restore(back.init_state())
    same = step == MESH_TRAIN_STEPS and all(
        torch.equal(p, held[n]) for n, p in restored["model"].named_parameters())
    del back, restored, held
    torch.cuda.empty_cache()
    ds.close()
    print(f"mesh trainer: mamba2-1.3b full width, {MODEL_LAYERS} layers, float32, "
          f"allow_tf32=False, B=4 x {MESH_TRAIN_SEQ}, Trainer.run to step "
          f"{MESH_TRAIN_STEPS}, parameters {sorted(kinds)}: mesh=1x1 {hist['1x1']} vs "
          f"mesh=None {hist['none']}; the mesh checkpoint restores unsharded at step "
          f"{step}, parameters {'equal' if same else 'DIFFERENT'}; ssd_scan launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    for a, b in zip(hist["1x1"], hist["none"]):
        for k in ("loss", "grad_norm"):
            if not abs(a[k] - b[k]) <= MODEL_ATOL + MODEL_RTOL * abs(b[k]):
                fail(f"mesh trainer: {k} {a[k]} on the mesh, {b[k]} without")
    if not same:
        fail("mesh trainer: the mesh run's checkpoint does not restore its state")
    want = 3 * MODEL_LAYERS * MESH_TRAIN_STEPS
    if launches != want:
        fail(f"mesh trainer: {launches} ssd_scan launches, want {want}")
    return launches


def dryrun_check(static_runs, train_step_ms: float, card: str) -> None:
    """The dry-run's roofline bound against this run's times on the card: on
    a 1-rank mesh, yi-6b's served prefill (B = 8 x S = 2,048, 32 layers,
    bf16) against step 6's warm prefill, and mamba2-1.3b's training step
    (B = 4 x 2,048, 48 layers) against step 11's median step.  A bound
    above ``DRYRUN_SLACK`` x the measured time fails: a count that says the
    card beat its roofline is a wrong count.  Then one production cell on
    the 32 x 8 fake mesh, and its seconds.  The NCCL group of the mesh
    phases is destroyed first (the dry-run's group is a fake one)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    torch.distributed.destroy_process_group()
    cells = [
        ("yi-6b", ShapeConfig("served_prefill", 2048, len(SERVE_LENGTHS), "prefill"),
         static_runs[1]["prefill_ms"], "step 6's warm prefill"),
        ("mamba2-1.3b", ShapeConfig("train_step", TRAIN_SEQ, TRAIN_BATCH, "train"),
         train_step_ms, "step 11's median step"),
    ]
    for arch, shape, measured_ms, what in cells:
        rec = dryrun.lower_cell(arch, shape, (1, 1), ("data", "model"), verbose=False)
        rf = rec["roofline"]
        lb_ms = rf["step_time_lb_s"] * 1e3
        print(f"dryrun[{arch} x {shape.name}, 1x1]: step_time_lb_ms={lb_ms:.3f} "
              f"({rf['bottleneck']}: compute {rf['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{rf['t_memory_s'] * 1e3:.3f} ms; flops {rf['flops_per_device']:.4g}, "
              f"bytes {rf['bytes_per_device']:.4g}, kernels {json.dumps(rec['kernels'])}) "
              f"against {what} {measured_ms:.3f} ms: {lb_ms / measured_ms:.3f} of it; "
              f"dry-run {rec['total_s']} s; card: {card}", flush=True)
        if lb_ms > DRYRUN_SLACK * measured_ms:
            fail(f"dryrun {arch}: bound {lb_ms:.3f} ms above {DRYRUN_SLACK} x the "
                 f"measured {measured_ms:.3f} ms")
    arch, shape = DRYRUN_FAKE_CELL
    shape_, axes = dryrun.production_mesh_shape(multi_pod=False)
    rec = dryrun.lower_cell(arch, shape, shape_, axes, verbose=False)
    rf = rec["roofline"]
    print(f"dryrun[{arch} x {shape}, {rec['mesh']} fake mesh]: {rec['status']} in "
          f"{rec['total_s']} s; per device flops {rf['flops_per_device']:.4g} bytes "
          f"{rf['bytes_per_device']:.4g} collective bytes {rf['collective_bytes']:.4g} "
          f"by axis {json.dumps(rec['collective_by_axis'])} ({rec['collective_calls']} "
          f"collectives); terms compute {rf['t_compute_s']:.4f} s memory "
          f"{rf['t_memory_s']:.4f} s collective {rf['t_collective_s']:.4f} s -> "
          f"{rf['bottleneck']}; argument bytes per device {rec['arg_bytes_per_device']}",
          flush=True)
    torch.distributed.destroy_process_group()



def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention.backward import flash_attention_bwd_cuda
        from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
        from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
        from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
        from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
        from repro_torch.kernels.tanimoto.kernel import tanimoto_topk_cuda
        from repro_torch.launch import serve_index
        from repro_torch.launch.funnel import run_funnel
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    started = time.perf_counter()
    secs = build.build()
    print(f"build: {len(build.SOURCES)} sources in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "smem" in line):
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    build_checks(build)

    t0 = time.perf_counter()
    probe, hm = kernel_phase(args.seed)
    tani = tanimoto_phase(args.seed)
    attn = attention_case(FA_YI, args.seed)
    for case in (FA_GEMMA, FA_GEMMA_SERVED, FA_GEMMA_SERVED_GLOBAL, FA_VLM_SERVED,
                 FA_QWEN3_SERVED, FA_HYBRID_SERVED, FA_QWEN2_32K, FA_MOONSHOT, *FA_SUFFIX,
                 *FA_WHISPER):
        attention_case(case, args.seed)
    ssd = ssd_scan_case(SSD_PREFILL, args.seed)
    ssd_scan_case(SSD_LONG, args.seed)
    ssd_scan_case(SSD_HYBRID, args.seed)
    smp = sample_case(args.seed)
    ssd_scan_backward_case(args.seed)
    fa_bwd = attention_backward_case(FA_TRAIN, args.seed)
    for case in (FA_TRAIN_WINDOW, *FA_TRAIN_GEMMA):
        attention_backward_case(case, args.seed)
    attention_backward_case(FA_TRAIN_WHISPER, args.seed)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)

    wrappers = {"sorted_probe": sorted_probe_cuda, "hash_mix": hash_mix_cuda,
                "tanimoto": tanimoto_topk_cuda}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        t0 = time.perf_counter()
        reset_launches(wrappers.values())
        summary = run_funnel(FUNNEL_RECORDS, seed=args.seed, device="cuda",
                             log=lambda s: print(f"funnel: {s}", flush=True),
                             workdir=work)
        funnel_launches = route_launches(
            {n: wrappers[n] for n in ("sorted_probe", "hash_mix")})
        print(f"funnel summary: {json.dumps(summary)}", flush=True)
        for name, counts in funnel_launches.items():
            if counts["launches"] == 0:
                fail(f"{name} was not launched on the funnel's path")
        print(f"funnel launches: {json.dumps(funnel_launches)}", flush=True)
        hashed_phase_check(Path(work), summary, args.seed)
        digest_launches = funnel_paper_phases(summary, Path(work), args.seed, card)
        print(f"funnel phases: {time.perf_counter() - t0:.1f} s", flush=True)

        launches = serving_phase(serve_index, Path(work), wrappers, card)
        t0 = time.perf_counter()
        checks = model_cases()
        lm_wrappers = model_wrappers()
        model_phase(Path(work), args.seed, checks["dense"], lm_wrappers)
        yi_launches, engine, static_runs = lm_serving_phase(
            Path(work), args.seed, "yi-6b", card)
        fa_static = yi_launches["flash_attention"]
        chunked_decode_reading(engine, corpus_prompts(Path(work), SERVE_LENGTHS), card)
        fa_cont = continuous_serving_phase(Path(work), engine,
                                           static_runs[0]["token_ids"], card)
        sample_launches, fa_sampled = sampled_serving_phase(
            engine, corpus_prompts(Path(work), SERVE_LENGTHS),
            static_runs[0]["token_ids"], card)
        mesh = one_card_mesh()
        fa_mesh = mesh_serving_phase(Path(work), engine, static_runs, mesh, card)
        # no group stays alive through the unsharded phases; (b) and (c) make
        # their own
        del mesh
        torch.distributed.destroy_process_group()
        del engine
        torch.cuda.empty_cache()
        continuous_parity_phase(Path(work), args.seed, card)
        print(f"LM phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        model_phase(Path(work), args.seed, checks["recurrent"], lm_wrappers)
        ssm_launches, engine, _ = lm_serving_phase(
            Path(work), args.seed, "mamba2-1.3b", card)
        launches["ssd_scan"] = ssm_launches["ssd_scan"]
        del engine
        torch.cuda.empty_cache()
        print(f"SSM phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        encdec_model_check(Path(work), args.seed)
        whisper_launches, engine, _ = lm_serving_phase(
            Path(work), args.seed, WHISPER, card,
            max_len=WHISPER_TEXT_CTX, lengths=WHISPER_LENGTHS)
        fa_whisper = whisper_launches["flash_attention"]
        del engine
        torch.cuda.empty_cache()
        print(f"encoder-decoder phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        model_phase(Path(work), args.seed, checks["families"], lm_wrappers)
        gemma_launches, engine, _ = lm_serving_phase(Path(work), args.seed, GEMMA, card)
        fa_gemma = gemma_launches["flash_attention"]
        del engine
        torch.cuda.empty_cache()
        vlm_launches, engine, _ = lm_serving_phase(
            Path(work), args.seed, VLM, card, cut=dict(n_layers=VLM_SERVE_LAYERS))
        fa_vlm = vlm_launches["flash_attention"]
        fa_vlm_cont = vlm_continuous_phase(Path(work), engine, card)
        del engine
        torch.cuda.empty_cache()
        vlm_continuous_parity(Path(work), args.seed, card)
        print(f"gemma3 and internvl2 phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        moe_model_check(Path(work), args.seed, card, HYBRID)
        hybrid_launches, engine, _ = lm_serving_phase(Path(work), args.seed, HYBRID, card,
                                                      cut=HYBRID_SERVE_CUT)
        del engine
        torch.cuda.empty_cache()
        print(f"hybrid phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        moe_model_check(Path(work), args.seed, card, QWEN3_MOE)
        qwen3_launches, engine, _ = lm_serving_phase(
            Path(work), args.seed, QWEN3_MOE, card,
            cut=dict(n_layers=QWEN3_MOE_SERVE_LAYERS))
        fa_qwen3 = qwen3_launches["flash_attention"]
        del engine
        torch.cuda.empty_cache()
        moe_model_check(Path(work), args.seed, card, "moonshot-v1-16b-a3b")
        fa_moe = moe_serving_phase(Path(work), args.seed, card)
        print(f"MoE phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        model_phase(Path(work), args.seed, checks["qkv_bias"], lm_wrappers)
        continuous_parity_phase(Path(work), args.seed, card, arch=QWEN2)
        fa_qwen = {}
        for arch in (QWEN2, QWEN15):
            served, engine, _ = lm_serving_phase(
                Path(work), args.seed, arch, card, cut=dict(n_layers=QWEN_SERVE_LAYERS))
            fa_qwen[arch] = served["flash_attention"]
            if arch == QWEN2:
                fa_long = long_prompt_phase(Path(work), engine, card)
            del engine
            torch.cuda.empty_cache()
        print(f"qwen2 and qwen1.5 phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        train_wrappers = {"flash_attention": flash_attention_cuda,
                          "flash_attention_bwd": flash_attention_bwd_cuda,
                          "ssd_scan": ssd_scan_cuda, "hash_mix": hash_mix_cuda,
                          "sorted_probe": sorted_probe_cuda}
        train_parity_phase(Path(work), args.seed, lm_wrappers)
        crash_resume_phase(Path(work), args.seed)
        trained = {arch: full_training_phase(Path(work), arch, layers, steps, card,
                                             train_wrappers, ckpt=ckpt)
                   for arch, layers, steps, ckpt in FULL_TRAIN}
        trained[GEMMA] = full_training_phase(
            Path(work), GEMMA, GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS, card,
            train_wrappers, ckpt=False)
        print(f"training phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        mesh = one_card_mesh()
        fa_ep = moe_mesh_check(Path(work), args.seed, mesh, card)
        ssd_mesh = trainer_mesh_check(Path(work), args.seed, mesh, card)
        del mesh
        dryrun_check(static_runs, trained["mamba2-1.3b"]["step_ms"], card)
        print(f"mesh phases after training: {time.perf_counter() - t0:.1f} s", flush=True)
    hm_serving = launches["hash_mix"]
    train_total = {k: sum(step[k] for t in trained.values() for step in t["launches"])
                   for k in ("flash_attention", "flash_attention_bwd", "ssd_scan", "hash_mix",
                             "sorted_probe", "flash_attention_bwd.window_launches")}
    gemma_train = {k: sum(step[k] for step in trained[GEMMA]["launches"])
                   for k in ("flash_attention", "flash_attention_bwd",
                             "flash_attention_bwd.window_launches")}
    launches["hash_mix"] += digest_launches + train_total["hash_mix"]
    launches["flash_attention"] = (fa_static + fa_cont + fa_sampled + fa_moe + fa_whisper
                                   + fa_gemma + fa_vlm + fa_vlm_cont
                                   + hybrid_launches["flash_attention"] + fa_qwen3
                                   + fa_qwen[QWEN2] + fa_long + fa_qwen[QWEN15]
                                   + train_total["flash_attention"] + fa_mesh + fa_ep)
    launches["ssd_scan"] += (hybrid_launches["ssd_scan"] + train_total["ssd_scan"]
                             + ssd_mesh)
    print(f"launches by path: hash_mix serve_index {hm_serving} + digest_ids "
          f"{digest_launches} + training's batch verify {train_total['hash_mix']}; "
          f"flash_attention yi-6b static {fa_static} + yi-6b continuous {fa_cont} + "
          f"yi-6b sampled {fa_sampled} + "
          f"moonshot static and continuous {fa_moe} + whisper-small static "
          f"{fa_whisper} + gemma3-12b static {fa_gemma} + internvl2-76b static "
          f"{fa_vlm} + internvl2-76b continuous {fa_vlm_cont} + jamba static "
          f"{hybrid_launches['flash_attention']} + qwen3-moe static {fa_qwen3} + "
          f"qwen2-72b static {fa_qwen[QWEN2]} and its {LONG_PROMPT_TOKENS}-token "
          f"prompt {fa_long} + qwen1.5-110b static {fa_qwen[QWEN15]} + training "
          f"{train_total['flash_attention']} (gemma3-12b's "
          f"{gemma_train['flash_attention']}) + the mesh phase's yi-6b serving {fa_mesh} "
          f"and moonshot expert-parallel prefill {fa_ep}; ssd_scan mamba2 serving "
          f"{ssm_launches['ssd_scan']} + jamba serving {hybrid_launches['ssd_scan']} + "
          f"training {train_total['ssd_scan']} + the mesh trainer {ssd_mesh}; "
          f"sorted_probe in training "
          f"{train_total['sorted_probe']} (the launcher's index is in memory); "
          f"flash_attention backward kernel in training {train_total['flash_attention_bwd']} "
          f"(gemma3-12b's {gemma_train['flash_attention_bwd']}, of them with a window "
          f"{gemma_train['flash_attention_bwd.window_launches']}; with a window in all "
          f"{train_total['flash_attention_bwd.window_launches']}); "
          f"sample in yi-6b's sampled serving {sample_launches}", flush=True)
    yi = trained["yi-6b"]
    est = fa_bwd["ms"] * 4 / yi["step_ms"]
    print(f"attention backward share of the yi-6b training step (4 layers, step_ms "
          f"{yi['step_ms']:.3f}): profiler span "
          f"{yi['prof'].get('attn_bwd_share', 'not measured')}, its kernels by name "
          f"{yi['prof'].get('bwd_kernels_share', 'not measured')}; from the kernel "
          f"phase's kernel_ms x 4 layers / step_ms: {est:.4f}", flush=True)

    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from the build to here",
          flush=True)
    kernels = [
        dict(name="sorted_probe", route="cuda",
             source="src/repro_torch/csrc/sorted_probe.cu",
             replaces="src/repro/kernels/sorted_probe/kernel.py:53",
             launches=launches["sorted_probe"], **probe),
        dict(name="hash_mix", route="cuda",
             source="src/repro_torch/csrc/hash_mix.cu",
             replaces="src/repro/kernels/hash_mix/kernel.py:65",
             launches=launches["hash_mix"], **hm),
        dict(name="tanimoto", route="cuda",
             source="src/repro_torch/csrc/tanimoto.cu",
             replaces="src/repro/kernels/tanimoto/kernel.py:135",
             launches=launches["tanimoto"], **tani),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:97",
             launches=launches["flash_attention"], **attn),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:36",
             launches=launches["ssd_scan"], **ssd),
        dict(name="flash_attention_backward", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="the gradient of src/repro/kernels/flash_attention/kernel.py:97 "
                      "(jax.grad of its chunked XLA path)",
             launches=train_total["flash_attention_bwd"], **fa_bwd),
        dict(name="sample", route="cuda",
             source="src/repro_torch/csrc/sample.cu",
             replaces="no Pallas kernel: XLA's fusion of jax.random.categorical in "
                      "src/repro/serve/engine.py:110 and src/repro/serve/scheduler.py:213",
             launches=sample_launches, **smp),
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels]}))
    print(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
