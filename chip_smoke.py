#!/usr/bin/env python3
"""End-to-end check of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the build: ``nvcc`` compiles the kernels of ``mxnet_tpu_torch/ops/csrc``
   into ``build/kernels/``, one process per source, all at once (timed;
   each source's largest register count and every function that spills,
   by name, with its registers and spilled bytes, from the compiler's
   report); the training kernels' sources (``LATE_SOURCES``: flash,
   striped, ``fused_linear``, ``matmul_stats``) build on a thread while
   the serving kernels are checked and phases 4-4g run (they launch none
   of them), and their checks, and every kernel's timing row, follow
   phase 4g; a ``wall:`` line gives each phase's seconds;
3. every kernel against its plain PyTorch version on the card, at the
   shapes the 124M LM's serving and training paths and ResNet-50 give it
   and at small ragged shapes, in every mode, each to a stated tolerance:
   the serving kernels (int8/int4 weights, float/int8 KV, C = 1/5/64/256,
   GQA, rope on/off, f32 and bf16; ``quant_matmul`` also at the MoE LM's
   products (the gate at 8 experts, and at 3 and 64; the up stack's
   flattened [8 x 3072, 768] view; one expert's down slice of an
   [8, 768, 3072] stack with its rows copied out of h), int8 and int4, M =
   32 and 256; ``quant_matmul`` and
   ``fused_decode_attention`` also held batch-invariant, bitwise: rows of
   x[:1], x[:7], x[:32], x[:256] against the same rows of the 256-row
   product at every 124M shape, int8 and int4, and slot subsets at S = 1,
   5 and 32 of a 124M step, 12 and 4 kv heads; ``paged_attention``'s
   decode entry at
   C = 1/2/4/15 with pos on its split edges, GQA 12->3 and 12->4, head_dim
   16-128 and NaN past the live rows, its chunk entry at
   C = 16/64/100/128/256, pos 0, 512 and L-C, one and three slots, GQA,
   and with NaN in the dead cache rows, each case asserted on the entry
   its route picks; the int8 cache at the chunk entry's breadth with NaN
   in the row scales past the live keys; the scalar entry at an f32 q over
   an f32 cache at C = 64 and 256, bf16 at head_dim 100, and the int8
   cache under an f32 q); ``flash_attention`` forward, dQ and
   dK/dV (B=8 T=1024 12 heads of 64 causal bf16; T=100 and T=1000,
   non-causal, window 33, f32 and bf16, head_dim 8-128; two runs of the
   bf16 backward give the same bits) and through
   ``MultiHeadAttention`` with GQA, rope and a window against the host;
   ``fused_linear`` (M=8192 K=768 N=3072 bf16 relu, and in f32; the SP
   path's M=2048 f32 relu; M=100 K=70 N=130 in f32 and bf16 with every
   activation, with and without the folded-BN ``scale``; f32 at M=129
   N=65 with K = 3, 5, 767 and from a misaligned view); ``matmul_stats``
   (each 1x1 conv of ResNet-50 at the main path's B=256, ragged M, K and
   N in f32 and bf16; the column sums to a stated share of their sums of
   magnitudes); ``fused_conv_bn_act`` (each conv of ResNet-50 at B=256 in
   f32 from an NCHW and a channels-last x and in bf16, small ragged convs
   with stride, pad, dilation and a non-square kernel, relu and linear,
   f32 and bf16, NCHW and channels-last; the Winograd path's ragged edges
   and the 3x3 convs its rule leaves to the implicit GEMM, each with its
   path); ``striped_pair_attention``
   forward, dQ and dK/dV (every ring position pair of the SP path's hop,
   [24, 1024, 64] at n=4, f32 and bf16; n=1, also held against flash
   causal; n=3 at a ragged C=100; head_dim 32-128, and 8 and 16 in f32; a
   random g_o and a nonzero g_lse). Then each
   kernel's time (CUDA
   events, median of 25 launches with the 50 MB L2 flushed before each and
   the host's launch overhead kept out) beside its plain version's, its
   bound, and one PyTorch library call computing the same function where
   there is one (``quant_matmul`` at every 124M product at M = 32 and
   256, and at the MoE gate, up stack and down slice at M = 32 and 256 in
   int8 and M = 32 in int4, each also beside ``F.linear`` on the weight
   dequantized to bf16;
   ``fused_linear`` at the LM's bf16 ffn1, with the SP
   path's f32 ffn1 beside it; flash's f32 backward at B=1;
   ``fused_conv_bn_act`` in f32, the eval forward's path, at the stride-1
   3x3 convs of stages 1-4 (Winograd; the bound also from the direct
   product), the stem and a 1x1 stride-2 projection, with the bf16 row
   beside them; the striped hop's forward and backward beside the
   efficient-attention calls; the paged chunk at C =
   64/128/256 in bf16 and at the int8-KV prefill's C = 256 with the int8
   cache, and the decode entry at C = 1 (bf16 beside SDPA with a mask,
   and int8) and C = 4 and 5, each beside the scalar paged entry on the
   same inputs, in turns; the scalar entry's own row at an f32 C = 256
   chunk, which no path runs; ``quant_matmul`` also at a verify round's
   M = 160); and, bitwise, the rows of a C = 5 verify read against C = 1
   reads at pos + c, and prefill pieces at start 192-768 against the rows
   of one whole-prompt chunk;
4. the serving main path: the 124M LM (12 layers, E=768, 12 heads, vocab
   32000, seeded random weights) saved with ``save_checkpoint`` and served
   by ``InferenceEngine.from_checkpoint`` with paged attention, int8
   weights and the fused decode kernel (max_len 1024, 32 slots, buckets
   64/128/256, 8 steps per round, bf16), 9 waves of the same 24 staggered
   greedy requests; the launch counters are zeroed just before the first
   wave and read just after the last; every wave's streams equal the
   first's, two requests' streams equal the offline ``Decoder.generate``,
   each prefill chunk goes through ``paged_attention_chunk`` (12 launches
   a prefill, none of the scalar entry), and the same 124M LM rebuilt on
   the host (plain versions) agrees with the card's logits and tokens to
   a stated bf16 tolerance. The engine runs compiled programs (CUDA
   graphs): its ``compile_counts`` must be the JAX contract (one decode
   program, one prefill program per bucket); the same wave run uncaptured
   (``Program._run_eager``) must give the same 24 streams; one sampled
   request alone and inside a busy wave, captured and uncaptured, must
   give one stream. Then a window of decode rounds with every slot busy,
   captured and uncaptured (wall time and the card's time per step by
   CUDA events and by the profiler, the idle share, the host calls per
   round, the kernels by device time, peak memory; the trace goes to
   ``chiprun_out/``); one 256-token prefill's wall and card time through
   the (uncaptured) decoder and through the engine's captured bucket
   program; then the same checkpoint
   served by the engine's default configuration (float weights, dense
   products: ``paged_attention_decode`` for every decode step's read) and
   with the int8 KV cache (the decode entry for decode steps,
   ``paged_attention_chunk`` for prefills, no launch of the scalar
   entry), one wave each, counters zeroed just before and read just
   after, exact launches, two streams equal to ``Decoder.generate``, the
   JAX compile contract, the default one's decode profile and the int8
   one's 256-token prefill timed (decoder and engine); then small
   LMs in the decoder's other modes (int4 weights, the int8 KV cache
   through the C=1 paged read, float weights, rope, GQA) are held against
   the plain path on the host;
4b. reuse and speculation: the same checkpoint behind the main path's
   engine, one wave each (after a warm-up wave that builds every program;
   counters zeroed just before each and read just after, launches exact
   from ``engine.stats``, the JAX compile contract, every stream equal to
   the same engine's with the feature off where that engine serves the
   prompts, two equal to ``Decoder.generate``; tokens/s, ms per token p50
   and p99, TTFT p50): prefix reuse (a 160 MiB pool of 4 slots; 24
   requests sharing a 192-token system prompt, >= 20 hits; a hit's
   admission beside a miss's, wall and card time; the gather-in and the
   copy program alone), chunked prefill (``prefill_chunk=256``: 20 short
   requests decode while 4 prompts of 600-1000 tokens admit in pieces;
   the long streams equal ``Decoder.generate`` and all equal an engine's
   at ``prefill_chunk=128``), n-gram speculation (``spec_k=4``, prompts
   repeating a 16-token phrase; one verify program; a verify round's and
   a decode round's wall and card time; one sampled request alone and in
   the wave, speculation on and off, gives one stream) and draft-model
   speculation (the target's own checkpoint through ``from_checkpoint(
   draft_prefix=...)``, every draft accepted, and a 2-layer LM of the same
   width; the draft program's card time), the speculation waves with
   unfused products (``SPEC_MM``);
4c. the engine's robustness and observability layer on phase 4's
   configuration (each check on its own ``phase 4c`` line, the phase's
   seconds last): (1) its cost: phase 4's wave on two engines in turns,
   9 waves each, the JAX package's defaults (telemetry on, a 256-request
   flight recorder) against ``telemetry.enable(False)`` and
   ``flight_recorder=0`` (tokens/s, ms per token p50/p99, the round
   ledger's ms a round by phase; streams equal phase 4's, the compile
   contract and the launches a round phase 4's, counters zeroed just
   before and read just after); (2) a hostile wave: 48 requests of
   24-600 tokens against 32 slots with ``overload="shed_oldest"``,
   ``max_queue=8``, the prefix pool and 256-token chunks: 8 cancelled and
   4 with their deadline forced past 3 rounds after admission, 4 with
   ``ttft_deadline_ms=0``, a burst of 16 at once; survivors equal a
   feature-off engine's streams, partial streams are prefixes, ``stats``
   and the ``serving.*`` counters count exactly the retirements, free
   slots and prefix pins come back, exact launches; (3) the watchdog:
   ``round_timeout_ms=50`` under an injected 5 s round hang raises
   ``EngineStuck`` with ``health()["stuck"]``, then the same engine
   finishes byte-identically; 3 waves armed and 3 not, in turns, with no
   trip, and the event's host cost a round; (4) crash and restore on
   phase 4b's prefix + chunk + n-gram engine: ``InjectedCrash`` 20 rounds
   into a 24-request wave, ``snapshot()``, ``close()``, ``restore()`` on
   a fresh engine over the same decoder; every stream equals the
   uninterrupted wave's; the time to recover (to every resumed request's
   next token) and ``memory_allocated`` before the engine, after
   ``close()`` (within 64 MiB of before) and after ``restore()``; (5) two
   injected staging failures retire exactly two requests with
   ``"error"``, ``serve_forever()`` over a seeded arrival generator, and
   ``close()`` with 4 requests queued (each fails with ``EngineClosed``;
   a second ``close()`` does nothing);
4d. the serving fleet on phase 4's configuration, every replica an engine
   on the one card over one decoder (each check on its own ``phase 4d``
   line, the phase's seconds last): (1) phase 4's wave with
   ``capture_dir`` under ``chiprun_out/`` against capture off, 3 waves
   each in turns (tokens/s), the capture's bytes a request, and
   ``serving.replay.replay(verify=True)`` clean on a fresh engine and at
   ``prefill_chunk=128, steps_per_round=4``; (2) 1P1D and 2P2D
   ``FleetRouter``s over the wave (every program captured first by
   handing one package of each bucket from every prefill engine to every
   decode engine): streams equal phase 4's, 24 handoffs out and in,
   prefill engines build prefill + handoff and no decode, decode engines
   decode + handoff and no prefill, exact launches from the engines'
   ``stats``; the row movers' wall and card ms (CUDA events) at buckets
   64/128/256, wire bytes native against int8 and ``pack_rows``' host ms;
   the wave through an int8 handoff (how many streams agree in full, the
   first token always); the short requests' ms a token p50/p99 under a
   long-prompt mix (20 short beside 4 of 200-256 tokens), 1P1D against
   one unified engine, both on the one card; (3) two unified replicas: a
   replica killed (``fleet_kill_replica``) and, on a fresh pair, one
   drained and a successor added, each in round 6 of the wave (when the
   most requests are in flight on two replicas): streams equal phase
   4's, zero failed, the time to every migrated request's next token;
   (1)'s capture through a 2-replica rolling restart, verify clean; and
   ``memory_allocated`` after the fleets' ``close()`` within 64 MiB of
   before; (4) ``telemetry.serve(port=0)`` during 1P1D waves: a scraper
   thread reads ``/metrics``, ``/healthz``, ``/fleet`` and
   ``/fleet/flight/<id>`` every 50 ms (``/metrics`` parses as Prometheus
   text, a journey's hops are the prefill then the decode engine), ms a
   scrape, tokens/s with the scraper against without, in turns;
4e. tensor-parallel serving of phase 4's 124M LM (each check on its own
   ``phase 4e`` line, the phase's seconds last; every tp figure is two
   ranks on ONE card, not a multi-card figure): the paged read of each
   rank's 6 heads bitwise equal to the same heads of the 12-head read
   (decode entry C = 1 and 5, chunk entry C = 64 and 256, bf16 and int8
   caches); then a tp=2 engine on ``model_parallel_mesh(2, devices=
   [cuda:0] * 2)`` against the tp=1 engine from the same weights, both
   with unfused products (``matmul_impl="pallas"``; the fused step is not
   eligible under tp): (1) phase 4's wave, 5 waves at each degree in
   turns: every stream equal, two equal ``Decoder.generate``, exact
   launches from ``stats`` (2 x 12 decode reads a step and 2 x 12 chunk
   reads a prefill at tp=2, the products as at tp=1, no fused step), each
   rank's shard ``[32, 1024, 6, 64]`` contiguous, ``kv_bytes_per_shard``
   half of tp=1's, equal ``compile_counts``; tokens/s at each degree, a
   decode profile (wall and card ms a step, idle share, host calls a
   round) and the idle decode round's wall, card and event time; (2) the
   int8 KV cache, one wave each, streams equal, exact launches; (3) the
   reuse gauntlet (160 MiB prefix pool, ``prefill_chunk=256``, n-gram
   ``spec_k=4``; 10 system-prompt, 4 long and 10 repeating prompts):
   streams, reuse stats and compile counts equal, exact launches; (4) a
   tp=2 snapshot 6 rounds into the wave restored at tp=1 and a tp=1 one
   at tp=2: the donors' and the restored engines' streams equal tp=1's;
   (5) the wave through a tp=2 prefill and a tp=1 decode specialist, and
   the other way round: streams equal tp=1's;
4f. the dense, blocked and windowed reads on phase 4's 124M LM (int8
   weights, unfused products ``matmul_impl="pallas"``, bf16; each check on
   its own ``phase 4f`` line, the phase's seconds last): (1) before any
   engine runs, bitwise: the blocked read (``cache_block`` 128) over all 8
   blocks against each slot's live blocks (32 slots at random positions,
   bf16 and int8 caches); a row's bits whatever the batch (the blocked,
   dense and ring reads of 1 and 6 slots against the same slots among
   32, a 200-row dense chunk against its 256-row bucket); the windowed
   ring write of a padded piece against the exact piece (the 124M
   windowed LM's padded prefill against its exact one reported); (2) the
   dense engine (``cache_block`` auto = 128) over phase 4's wave, 3 waves
   in turns with the paged engine at the same products: every stream
   equal to the dense ``Decoder.generate``, exact launches (no paged read,
   no fused step), the JAX compile contract, tokens/s of both, how many
   streams the two reads share (bf16: not gated), both decode profiles;
   phase 4e(3)'s reuse gauntlet on a dense engine at ``cache_block=None``
   (the JAX engine's serving configuration): streams equal the dense
   offline decoder's, prefix hits and accepted drafts; (3) a 2-layer f32
   LM's paged and dense engines over a small gauntlet, streams
   byte-identical; (4) the 124M LM built with ``window=256``: asked for
   the paged read and n-gram speculation the engine warns, has no prefix
   pool and refuses a prefill role; 36 requests over 32 slots, prompts of
   40-900 tokens in pieces of 256 (rings wrapping within a prompt, across
   pieces and during decode), exact launches, the compile contract, every
   stream equal to the windowed ``Decoder.generate``, the decode profile;
   the same wave at tp=2 on two ranks of the card, streams equal; (5)
   ``beam_search`` on the 124M paged decoder (B=2, a 64-token prompt, 32
   steps, beams of 4, with and without an EOS): exact launches,
   ``beam_size=1`` equal to greedy ``generate``, each score within its
   bf16 bound of a teacher-forced prefill's log-probs, beams best first,
   ms a step; (6) 2-layer f32 LMs through the dense (GQA, rope, int8
   cache), blocked and windowed reads, card against host;
4g. the mixture-of-experts LM: phase 4's 124M LM with every block a MoE
   block of 8 experts of 3072, top-2 routing (Mixtral 8x7B's counts),
   seeded random weights, saved with ``save_checkpoint`` (each check on
   its own ``phase 4g`` line, the phase's seconds last): (1) served by
   ``from_checkpoint`` on phase 4's settings (int8 weights, the fused
   decode step, paged reads), 3 of phase 4's waves: streams equal the
   first wave's, two equal ``Decoder.generate``, exact launches (per
   decode step 12 fused steps and 12 x (gate + up + 8 down) + 1
   ``quant_matmul``; per prefill 12 chunk reads and 12 x 12 + 1), the
   compile contract; tokens/s, ms per token, the decode profile (the
   ``quant_matmul`` share of the card's time) and one 256-token engine
   prefill; (2) a 2-layer f32 MoE LM (top-2 of 4), card against host,
   float, int8 and int4 weights at ``matmul_impl="dense"`` and
   ``"pallas"``: logits within 1e-3, greedy tokens equal; (3) ep=2 on
   ``build_mesh({"expert": 2, "model": 1}, [cuda:0] * 2)`` and ep=2,
   tp=2 on ``[cuda:0] * 4`` against ep=1 (unfused products), one wave
   each in turns: every stream equal to ep=1's, each rank's gate and
   stacks an allocation of 4 experts (values and scales), exact launches
   (4 down products a layer a rank), equal compile counts, tokens/s over
   ep=1's and the idle decode round's card ms (ranks on ONE card, not a
   multi-card figure); (4) phase 4e(3)'s reuse gauntlet at ep=1 and ep=2:
   streams, prefix hits and accepted drafts equal; an ep=2 snapshot 6
   rounds into the wave restored at ep=1: streams equal;
5. the training main path: the same 124M LM (``impl="flash"``) trained by
   ``ParallelTrainer(device=None)`` in bf16 with SGD (lr 1e-3, momentum
   0.9) at B=8, T=1024 on a repeated seeded batch, as ``bench.py``'s
   ``bench_transformer_lm`` trains it: 3 warm-up steps, then 12 timed
   steps with the launch counters zeroed just before and read just after
   (12 launches of each of flash forward, dQ, dK/dV and ``fused_linear``
   per step, asserted exactly); tokens/s (median, min-max), ms per step,
   peak memory and MFU; the loss must fall; a profiled window of 2 steps
   (busy share, host calls, kernels by device time, trace to
   ``chiprun_out/``); the same step uncaptured (``Program._run_eager``),
   timed and profiled; one captured step equal bitwise to one uncaptured
   step from the same parameters, ``multi_step(batch, 3)`` equal bitwise
   to 3 captured steps, the cost of ``step()``'s output copy, and 12
   steps as one ``multi_step``; then
   one f32 step of the same LM at B=1, T=128 from the same seeded weights
   on the card and on the host, whose parameter deltas must agree;
5b. the MoE LM of phase 4g (``impl="flash"``) trained as phase 5 trains
   the dense LM (bf16 over f32 masters, SGD lr 1e-3 momentum 0.9, B=8,
   T=1024): 3 warm-up and 6 timed steps, exactly 12 launches of each
   flash entry a step and one ``fused_linear`` a FullyConnected ->
   Activation chain of the graph (none in a MoE block), a falling loss,
   tokens/s, ms per step, peak memory, MFU over a stated FLOP count
   (``moe_flops_per_token``) and a 2-step profile; then one f32 step of a
   2-layer MoE LM of the same width at B=1, T=128, card against host,
   parameter deltas within 2e-2 by per-tensor norm;
5c. the LM trained as users train it (each check on its own ``phase 5c``
   line, the phase's seconds last): phase 5's 124M LM ending in
   ``loss_layout="ce"`` (``SoftmaxCELoss``), trained with GPT-3 Small's
   recipe (AdamW lr 6e-4 beta2 0.95 wd 0.1, linear warmup then cosine to
   6e-5, global-norm clip 1.0; bf16 over f32 masters, B=8, T=1024) through
   ``ParallelTrainer(device=None).fit`` over an ``NDArrayIter`` of 24
   batches of a seeded order-1 Markov chain (4 successors a token), 2
   epochs, ``device_metric=True`` on ``metric.Loss()``, a ``Speedometer``
   and an epoch-end callback saving ``.params`` and ``.states`` (and a
   sharded checkpoint after the first epoch): exact launches a step (12
   of each flash entry, one ``fused_linear`` a FullyConnected ->
   Activation chain), every epoch's loss finite and the last below the
   first; tokens/s of ``fit`` with the metric on the device and on the
   host against 12 ``step()`` calls, MFU, peak memory, each checkpoint's
   seconds and bytes; the AdamW update alone (CUDA events, a 2-call
   profile, its kernels) against its bound, and a 2-step profile of the
   AdamW step; then crash and resume: with epoch 2's ``.params`` gone, a
   fresh trainer resumes from ``latest_checkpoint``'s ``.params`` and
   ``.states``, and another from the sharded checkpoint, and each one's
   parameters after the second epoch equal the uninterrupted run's
   bitwise; for AdamW, AdaFactor (factored, beta1 0.9) and SGLD, 4
   captured steps equal 4 uncaptured ones bitwise with lr and t advancing
   (and for AdamW, a run with t frozen at 1 differs), ``multi_step(batch,
   3)`` equals 3 ``step()`` calls bitwise; one f32 AdamW step of a 2-layer
   LM of the same width at B=1, T=128, card against host (deltas within
   2e-2 by norm); the 9 optimizers' functional updates card against host;
   ``SoftmaxCELoss`` at [8192, 32000] bf16 card against host, and its
   forward's and backward's card time;
5d. the other parallelisms at phase 5's width (each check on its own
   ``phase 5d`` line, the phase's seconds last; ranks share the one
   card): (1) ``ParallelTrainer`` on the mesh {dp: 2} over [cuda:0] * 2,
   bf16 over f32 masters, SGD lr 1e-3 momentum 0.9, B=8, T=1024: 3
   warm-up and 6 timed steps with exactly 24 launches of each flash entry
   a step and none of ``fused_linear`` (no chain fuses on a multi-rank
   mesh), a falling loss, tokens/s, ms per step and peak memory; a
   captured step equal to an uncaptured one bitwise; one f32 step of the
   mesh trainer against the one-device f32 trainer from the same weights
   (deltas within 2e-2 by norm: f32, where the ReLU kink rule holds);
   (2) AdamW at dp=2, 3 steps each of plain, ``zero1=True`` and
   ``fsdp=True``: each against plain (bitwise or not, printed; deltas
   within 2e-2 by norm) and each rank's stored bytes (zero1: half the
   state plus the padding; fsdp: half the parameters and half the
   state); (3) one step with ``remat=True`` against ``remat=False``,
   both peak memories; (4) ``PipelineTrainer`` on
   ``pipeline_stages=4`` over {pp: 4} ([cuda:0] * 4), f32, B=8, T=1024,
   M=8: GPipe and 1F1B, 1 warm-up and 2 timed steps each, exactly 96
   launches of each flash entry a step (1F1B: 192 of the forward, its
   backward recomputing each stage), a falling loss, tokens/s, peak
   memory, 1F1B's peak below GPipe's, one step of each against the
   one-device f32 trainer on the untagged LM (deltas within 2e-2 by
   norm), and the same for GPipe on {dp: 2, pp: 2} over [cuda:0] * 4;
   (5) ``FeedForward(ctx=[gpu(0)] * 2)`` fitting the zoo's MLP on
   synthetic data through the fused loop against ``ctx=gpu(0)``
   (deltas within 2e-2 by norm);
6. the conv-net path: ResNet-50 (``get_resnet(1000, 50)``) trained by
   ``ParallelTrainer(device=None)`` as ``bench.py``'s ``bench_resnet50``
   trains it (B=256, 224 x 224, bf16 over f32 master weights, SGD lr 0.1
   momentum 0.9 wd 1e-4, default init, a device-resident seeded batch)
   with ``MXNET_PALLAS_CONVBN_TRAIN=1``: 3 warm-up and 12 timed steps with
   exactly 33 ``matmul_stats`` launches per step and a falling loss, img/s,
   ms per step, MFU, peak memory and a 2-step profile (its trace beside
   the others); the same 12 steps with the gate unset, by a trainer built
   with it unset (the step program reads the gate when it is built; no
   launch);
   ``trainer.forward()`` at B=256 (f32, as the JAX package's eval runs on
   the master parameters) with exactly 53 ``fused_conv_bn_act`` launches
   per forward, and timed again with no chain fused; then ResNet-50 in f32
   at B=2 on the card and on the host from the same weights: the eval
   log-probabilities and top-1, and one train step's parameter deltas,
   must agree;
7. the sequence-parallel path: ``striped_ring_attention`` on a 4-rank mesh
   over one card (``[cuda:0] * 4``) against dense causal attention; the
   124M LM (``impl="ring_striped"``) trained by
   ``SequenceParallelTrainer`` on the mesh {dp: 1, sp: 4} at B=2, T=4096
   in f32 (SGD lr 1e-3 momentum 0.9): 3 warm-up and 12 timed steps with
   exactly 192 launches of each ``striped_pair`` entry and 48 of
   ``fused_linear`` per step, a falling loss, tokens/s, a 2-step profile;
   then one f32 step of it at B=1, T=1024 against
   ``ParallelTrainer(impl="flash")`` from the same weights, whose
   parameter deltas must agree; and 3 steps at B=1, T=1024,
   ``save_sharded_checkpoint``, 2 more: a fresh trainer restored from the
   checkpoint takes the same 2 steps, bitwise;
7b. the classic API (``import mxnet_tpu_torch as mx``), each check on a
   ``phase 7b`` line ending in the phase's seconds: NDArray on
   ``mx.gpu(0)`` (views write through; ``nd.dot`` at [4096, 4096] f32
   against the host; a save/load round trip; ``mx.random`` reproducible
   under ``seed``); phase 5's 124M LM in f32 through
   ``simple_bind(mx.gpu(0), data=(8, 1024), ...)`` with phase 5's seeded
   weights and SGD through ``get_updater``: 2 warm-up and 5 timed
   forward/backward/update steps with exactly 12 launches of each flash
   entry and of ``fused_linear`` a step and a falling loss, ms a step by
   CUDA events, a 2-step profile, peak memory, then one f32 step at B=1
   T=128 against ``ParallelTrainer(device=None)`` (deltas within 2e-2 by
   norm); ResNet-50 f32 through ``FeedForward(ctx=mx.gpu(0)).fit`` over
   an ``NDArrayIter`` of 4 seeded batches of 64, on the default (fused)
   loop and on the legacy loop (``MXNET_FUSED_FIT=0``, the conv-BN train
   gate on, kvstore "local": exactly 33 ``matmul_stats`` a step), in
   turns, img/s and the busy share of each second fit; ``predict`` and
   ``score`` over 2 batches of 256 (exactly 53 ``fused_conv_bn_act`` a
   forward, score equal to predict's accuracy); an MLP through the legacy
   fit at ``ctx=[mx.gpu(0)] * 2`` against ``[mx.gpu(0)]`` (within 1e-5
   after 2 epochs), with a ``Monitor(1)`` (every node reported), and
   crash and resume from ``fit(checkpoint_prefix=)`` (bitwise);
   ``FeedForward.load`` of phase 4's checkpoint and ``as_serving_engine``
   with phase 4's settings: one wave, exact launches from
   ``engine.stats``, streams equal phase 4's. Phase 3's timing rows gain
   the f32 flash forward at B=8 T=1024 beside SDPA f32 and the f32
   ``fused_linear`` at the LM's ffn1 beside ``F.linear`` + relu (the
   ``lm_f32`` rows of the kernels line);
7c. the model zoo through the classic API (``import mxnet_tpu_torch as
   mx``, ``mx.models.get_symbol``, f32 on ``mx.gpu(0)``, seeded weights;
   each check on a ``phase 7c`` line ending in the phase's seconds):
   Inception-BN at full width (224 x 224, 1000 classes) through
   ``FeedForward.fit`` for 2 epochs over an ``NDArrayIter`` of 4 seeded
   batches of 64, on the fused loop and on the legacy loop (the conv-BN
   train gate on: exactly 37 ``matmul_stats`` a step), in turns, the
   second epoch's cross-entropy below the first's, ms a step, img/s, the
   busy share of each second fit and a 2-step profile of the fused step
   (``inception_fit_trace.json.gz``); ``predict`` and ``score`` over 2
   batches of 256 (exactly 69 ``fused_conv_bn_act`` a forward, score
   equal to predict's accuracy) and how many chains of the forward get an
   x that is not channels-last; B=2 card against host (eval
   log-probabilities and top-1, one train step's deltas by norm);
   Inception-v3 (299 x 299, B=64, exactly 94 ``fused_conv_bn_act`` a
   forward) and VGG-16 (B=64, exactly 2 ``fused_linear``) ``predict``,
   each at B=2 card against host; AlexNet (LRN), FCN-32s
   (Deconvolution, Crop) and the unrolled LSTM at ``lstm_ptb.py``'s
   defaults through one ``simple_bind`` forward/backward each (inferred
   shapes, finite, probabilities summing to 1); ``mnist_sae.py``'s sparse
   autoencoder (``IdentityAttachKLSparseReg``, ``LinearRegressionOutput``)
   through one ``fit`` epoch, exactly 3 ``fused_linear`` a step, a falling
   MSE and moving ``moving_avg``s. Phase 3's holds gain every distinct
   chain of Inception-BN (B=256) and Inception-v3 (B=64) in f32 and the
   f32 pointwise shapes of both legacy fits (B=64); its timing rows gain
   ``fused_conv_bn_act`` at Inception-v3's 1x7 and Inception-BN's 3x3/2,
   ``matmul_stats`` at Inception-BN's widest chain and at ResNet-50's 33
   legacy-fit chains a step, ``fused_linear`` at VGG-16's fc6 and the
   f32 flash backward at B=8 (the ``f32_b8``, ``v3_1x7``, ``bn_3x3s2``,
   ``bn_widest``, ``resnet_fit_f32`` and ``vgg_fc6`` rows of the kernels
   line);
7e. the periphery on the card, each check on a ``phase 7e`` line ending in
   the phase's seconds: two workers on the one card through the unchanged
   ``tools/launch.py -n 2`` (``mxnet_tpu_torch.testing.dist_worker``;
   the kernels built by this process first): ResNet-50 f32 (224 x 224,
   1000 classes, seeded weights) through
   ``FeedForward(ctx=mx.gpu(0)).fit(kvstore="dist_sync")`` on the legacy
   loop with the conv-BN train gate on, B=32 a worker over 2 global
   batches of 64 for 2 epochs (exactly 33 ``matmul_stats`` a step in each
   worker, the second epoch's cross-entropy below the first's, both
   ranks' parameters bitwise equal, and within 2e-2 by norm of the deltas
   of one process at ``ctx=[mx.gpu(0)] * 2`` with kvstore local; ms a
   step both ways, the update's push/pull ms, bytes all-reduced, the
   collectives' route; exact sums of keys kept on the card, each
   collective handed card tensors), then train_mnist's MLP over the ``dist_async``
   servers with fc1_weight range-partitioned (accuracy > 0.85 on both
   ranks, pushes and pulls equal to the steps, MB/s); ResNet-50 saved
   and served by ``Predictor(dev_type="gpu")`` at B=64 (exactly 53
   ``fused_conv_bn_act`` a forward, within 1e-5 of
   ``FeedForward.predict``, a partial-out head with its inferred shape,
   img/s) and by the port's C predict client on the card (within 1e-5 of
   Python, ms a forward); the port's ``train_c`` on the card through the
   graph ABI (accuracy > 0.9) and ``MXDataIter`` over a C-created CSV
   iterator handle (``CSVIter``'s batches); a ``NumpyOp`` softmax in an
   MLP fit (deltas within 1e-5 of ``SoftmaxOutput``'s, the step run
   uncaptured and counted), ``TorchModuleOp(nn.Linear)`` against
   ``F.linear``, an ``Rtc`` saxpy compiled by NVRTC (exact, timed); the
   profiler's trace around a Predictor forward (the scope and the
   ``fused_conv_bn_act`` kernels named) and, after an engine with phase
   4's settings served, ``program.serving_decode.flops`` within 1% of
   the kernels' count and on ``/metrics``;
7f. multi-process training, each check on a ``phase 7f`` line ending in
   the phase's seconds: ``ParallelTrainer`` over ONE mesh {dp: 2} that
   spans two workers on the one card (the unchanged ``tools/launch.py -n
   2``, ``mxnet_tpu_torch.testing.dist_worker`` at ``MXNET_DISTTEST_SIZE=
   full``; each worker passes its rows of the global batch; the kernels
   built by this process first): (1) the 124M LM bf16 over f32 masters
   at global B=8 T=1024, SGD lr 1e-3 momentum 0.9, 2 steps on one batch,
   plain, ``zero1=True`` and ``fsdp=True`` (and AdaFactor with
   ``fsdp=True``, its state leaves sharded across the workers and
   gathered before the captured update): each bitwise equal on both
   ranks, to each other and to one process over ``[cuda:0] * 2`` here,
   a falling loss, exactly 12 launches of each flash entry a step in
   each worker, the step two captured programs (compute, update) with
   the gloo collective between them; ms a step against the one-process
   run, the collectives' ms and bytes a step, each rank's stored bytes;
   (2) ResNet-50 f32 at 224 x 224, global B=64, 2 steps, cuDNN
   deterministic and TF32 off, BatchNorm over the global batch (its sums
   in the walk, which therefore runs uncaptured): parameters, moving
   averages and momentum bitwise the one-process run's; (3) the fsdp
   LM's checkpoint written by both workers (synchronous), restored
   bitwise in both workers and here in one process; (4) the sharded-IO
   fit (RAW0 records, ``ImageRecordIter(num_parts=2, part_index=rank)``,
   ``fit(device_metric=True)``): accuracy above 0.85, equal in both;
   (5) ``PipelineTrainer`` on the 124M LM f32 with ``pipeline_stages=2``
   over {pp: 2}, one stage in each process, B=8 T=1024 M=4, GPipe and
   1F1B, 3 steps: parameters (gathered in both ranks) and each rank's
   momentum bitwise the one-process run over ``[cuda:0] * 2``, the head
   only in rank 1, exactly 24 of each flash entry a step in each process
   (1F1B: 48 forwards), ms a step against one process, the hops' MB and
   calls a step; (6) ``SequenceParallelTrainer``, phase 7's cell, over
   {dp: 1, sp: 4} with 2 ranks in each worker (two hops of each
   rotation cross), 3 steps: parameters and momentum in both workers
   bitwise phase 7's one-process run after its 3 warm-up steps, its
   losses, exactly 96 launches of each striped_pair entry and 24 of
   fused_linear a step in each worker; ms a step against phase 7's, the
   exchanges' ms, MB and calls a step (``python3 chip_smoke.py --7f sp``
   runs one check alone);
8. the ``{"kernels": [...]}`` line (every C entry; ``classic_launches``
   are phase 7b's, ``zoo_launches`` phase 7c's, ``periphery_launches``
   phase 7e's, workers included, ``multiproc_launches`` phase 7f's
   workers'; and phase 7e's ``rtc_saxpy``), the card's line, and the
   result line ``{"ok": true, "device": {...}}`` last.

Any failure raises, so the script exits non-zero and prints no result. It
needs a CUDA card and the rest of the repository beside it.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM figures used for the bound (NVIDIA's data sheet, dense rates
# at the 700 W limit): 3.35 TB/s of device memory, 989 TFLOP/s bf16 on
# the tensor cores, 67 TFLOP/s f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# |kernel - plain| <= ATOL + RTOL * |plain|, per output dtype: f32 sums
# run in another order; bf16 outputs may round one unit apart (2^-8)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}

TIMING_RUNS = 25

# C entries no main path launches: the kernels line reports 0 for them
OFF_PATH = ("paged_attention",)


_T0 = time.perf_counter()


def log(*a):
    """Print a result line; its wall seconds since the start go to stderr
    (the order of the phases' costs, in a log that keeps both)."""
    print(*a, flush=True)
    print("  [%.1f s]" % (time.perf_counter() - _T0), file=sys.stderr,
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` over TIMING_RUNS launches, each timed
    by CUDA events after the L2 is flushed by a 64 MB write. The card
    first spins (~50 ms) while the host queues every run behind the spin,
    so the events time the card's work and none of the host's launch
    overhead."""

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.spin_cycles = 100_000_000
        a, b = self._events(1)[0]
        a.record()
        torch.cuda._sleep(self.spin_cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = self.spin_cycles / a.elapsed_time(b)

    @staticmethod
    def _events(n):
        return [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(n)]

    def __call__(self, fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = self._events(TIMING_RUNS)
        torch.cuda._sleep(self.spin_cycles)
        t0 = time.perf_counter()
        for a, b in events:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < 0.8 * self.spin_cycles / self.cycles_per_ms:
            return statistics.median(a.elapsed_time(b) for a, b in events)
        # fn waited on the card (a host read of a device value), so the
        # spin could not hide the queueing: time each run on its own; its
        # time then includes that wait, as the caller of fn sees it
        times = []
        for a, b in events:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes, flops, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for the inputs' type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, got, want):
    """Max |got - want|, raising past the dtype's tolerance."""
    atol, rtol = TOL[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if not torch.isfinite(g).all() or bad.any():
        raise AssertionError(
            "%s: kernel disagrees with the plain version: max |err| %.3g "
            "(atol %g, rtol %g), %d of %d outside" % (
                name, err.max().item(), atol, rtol, int(bad.sum()),
                bad.numel()))
    return err.max().item()


# -- phase 3: kernels against their plain versions ------------------------

def _rand(gen, shape, dtype=torch.float32, scale=1.0):
    """Seeded normal values, drawn where ``gen`` lives (a generator on the
    card draws the ResNet-50 shapes' gigabytes without the host)."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


def _weights(gen, f, e, bits, group, dev):
    from mxnet_tpu_torch.serving.quant import quantize_tensor
    w = (torch.rand((f, e), generator=gen) - 0.5) * 0.1   # U(-0.05, 0.05)
    qt = quantize_tensor(w, bits=bits, group=group)
    return qt.q.to(dev), qt.scale.to(dev)


def _cache(gen, s, l_, kv, d, kind, dev):
    """k, v (and row scales for int8) on the card."""
    if kind == "int8":
        k = torch.randint(-127, 128, (s, l_, kv, d), generator=gen,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (s, l_, kv, d), generator=gen,
                          dtype=torch.int8)
        ks = torch.rand((s, l_, kv), generator=gen) * 0.02 + 1e-3
        vs = torch.rand((s, l_, kv), generator=gen) * 0.02 + 1e-3
        return k.to(dev), v.to(dev), ks.to(dev), vs.to(dev)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    return (_rand(gen, (s, l_, kv, d), dt).to(dev),
            _rand(gen, (s, l_, kv, d), dt).to(dev), None, None)


def check_quant_matmul(K, dev, gen):
    """Every mode: int8 and int4 (groups 2, 16), f32/bf16 in and out, odd
    M and F (both forms of the tile: the tensor cores take bf16 x with E a
    multiple of 128 and int4 groups of a multiple of 16); then the 124M
    decode and prefill shapes. Then the batch-invariance gate: at every
    124M shape, int8 and int4 (group 128), the rows of x[:1], x[:7],
    x[:32] and x[:256] through the kernel are bitwise equal to the same
    rows of the product of all 256 (x[:160]: a verify round of 32 slots
    at spec_k = 4)."""
    cases = []
    for bits, group in ((8, None), (4, 2), (4, 16)):
        for xdt in (torch.float32, torch.bfloat16):
            for m, f, e in ((1, 37, 48), (7, 100, 96), (33, 65, 32),
                            (1, 37, 128), (33, 65, 256), (40, 130, 1024)):
                cases.append(("ragged", m, f, e, bits, group, xdt, xdt))
    cases.append(("ragged", 5, 40, 64, 8, None, torch.bfloat16,
                  torch.float32))
    for m in (32, 256):
        for f, e in ((2304, 768), (768, 768), (3072, 768), (768, 3072),
                     (32000, 768)):
            cases.append(("124M", m, f, e, 8, None, torch.bfloat16,
                          torch.bfloat16))
        cases.append(("124M", m, 3072, 768, 4, 128, torch.bfloat16,
                      torch.bfloat16))
        cases.append(("124M", m, 768, 3072, 4, 16, torch.float32,
                      torch.float32))
    worst = 0.0
    for tag, m, f, e, bits, group, xdt, odt in cases:
        x = _rand(gen, (m, e), xdt).to(dev)
        q, s = _weights(gen, f, e, bits, group, dev)
        got = K.quant_matmul(x, q, s, bits=bits, group=group, out_dtype=odt)
        want = K.quant_matmul_plain(x, q, s, bits, group, odt)
        torch.cuda.synchronize()
        err = compare("quant_matmul %s m=%d f=%d e=%d bits=%d" % (
            tag, m, f, e, bits), got, want)
        worst = max(worst, err)
    log("quant_matmul: %d cases agree, max |err| %.3g" % (len(cases), worst))
    gates = 0
    for f, e in QMM_SHAPES:
        for bits, group in ((8, None), (4, 128)):
            x = _rand(gen, (256, e), torch.bfloat16).to(dev)
            q, s = _weights(gen, f, e, bits, group, dev)
            full = K.quant_matmul(x, q, s, bits=bits, group=group)
            for m in (1, 7, 32, 160, 256):
                rows = K.quant_matmul(x[:m].clone(), q, s, bits=bits,
                                      group=group)
                if not torch.equal(rows, full[:m]):
                    raise AssertionError(
                        "quant_matmul F=%d E=%d bits=%d: rows of x[:%d] "
                        "differ from the same rows of the 256-row product "
                        "(max |diff| %.3g)" % (f, e, bits, m, (
                            rows.float() - full[:m].float()).abs().max()))
                gates += 1
    log("quant_matmul: batch invariance, %d subsets bitwise equal to the "
        "256-row product" % gates)
    return worst


# the 124M LM's quantized products (F, E): qkv, proj, ffn1, ffn2, lm_head
QMM_SHAPES = ((2304, 768), (768, 768), (3072, 768), (768, 3072),
              (32000, 768))
# the MoE LM's quantized products (F, E) at the 124M width with 8 experts
# of 3072 (phase 4g): the gate, the up stack's flattened [X*H, E] view and
# one expert's down slice; and the gate at 3 and 64 experts (F below and
# at one 64-channel tile)
QMM_MOE_SHAPES = (("gate", 8, 768), ("up", 8 * 3072, 768),
                  ("down", 768, 3072), ("gate3", 3, 768), ("gate64", 64, 768))


def check_quant_matmul_moe(K, dev, gen):
    """Phase 3 at the MoE LM's shapes (``QMM_MOE_SHAPES``), int8 and int4
    (group 128), bf16 x, M = 32 and 256: each against the plain version
    to phase 3's tolerance, then the batch-invariance gate (rows of x[:1],
    x[:7], x[:32], x[:256] bitwise the same rows of the 256-row product).
    The down slice is expert 3 of an [8, 768, 3072] stack (``q[3]``, a
    view at a 16-byte multiple) with its x the expert's rows of an [M, 8,
    3072] h, copied contiguous as the walk copies it. Then, bitwise, each
    rank's share of the gate and the up stack at ep=EP (its rows of the
    weight) against the same channels of the whole product: phase 4g's
    ep streams equal ep=1's because of it. Returns the worst error."""
    from mxnet_tpu_torch.serving.quant import (_kernel_slice,
                                               quantize_tensor)
    worst, n, gates = 0.0, 0, 0
    for what, f, e in QMM_MOE_SHAPES:
        for bits, group in ((8, None), (4, 128)):
            if what == "down":
                w = (torch.rand((8, f, e), generator=gen) - 0.5) * 0.1
                qt = _kernel_slice(quantize_tensor(w.to(dev), bits=bits,
                                                   group=group), 3)
                if qt.q.data_ptr() % 16 or not qt.q.is_contiguous():
                    raise AssertionError("the down slice is not a view")
                q, s = qt.q, qt.scale
                h = _rand(gen, (256, 8, e), torch.bfloat16).to(dev)
                x = h.movedim(1, 0).contiguous()[3]
            else:
                q, s = _weights(gen, f, e, bits, group, dev)
                x = _rand(gen, (256, e), torch.bfloat16).to(dev)
            full = K.quant_matmul(x, q, s, bits=bits, group=group)
            for m in (32, 256):
                got = K.quant_matmul(x[:m].clone(), q, s, bits=bits,
                                     group=group)
                want = K.quant_matmul_plain(x[:m], q, s, bits, group,
                                            torch.bfloat16)
                torch.cuda.synchronize()
                worst = max(worst, compare(
                    "quant_matmul MoE %s m=%d f=%d e=%d bits=%d" % (
                        what, m, f, e, bits), got, want))
                n += 1
            for m in (1, 7, 32, 256):
                rows = K.quant_matmul(x[:m].clone(), q, s, bits=bits,
                                      group=group)
                if not torch.equal(rows, full[:m]):
                    raise AssertionError(
                        "quant_matmul MoE %s F=%d E=%d bits=%d: rows of "
                        "x[:%d] differ from the same rows of the 256-row "
                        "product" % (what, f, e, bits, m))
                gates += 1
    # expert parallelism's premise (phase 4g): a rank's gate and up
    # products (its experts' rows of the weight) give the same channels,
    # bitwise, as the product over all experts
    parts = 0
    for what, f, e in QMM_MOE_SHAPES[:2]:
        for bits, group in ((8, None), (4, 128)):
            q, s = _weights(gen, f, e, bits, group, dev)
            x = _rand(gen, (256, e), torch.bfloat16).to(dev)
            full = K.quant_matmul(x, q, s, bits=bits, group=group)
            rows = f // EP
            for r in range(EP):
                sl = slice(r * rows, (r + 1) * rows)
                part = K.quant_matmul(x, q[sl].clone(), s[sl].clone(),
                                      bits=bits, group=group)
                if not torch.equal(part, full[:, sl]):
                    raise AssertionError(
                        "quant_matmul MoE %s bits=%d: rank %d's %d channels "
                        "differ from the same channels of the product over "
                        "all %d" % (what, bits, r, rows, f))
                parts += 1
    log("quant_matmul MoE shapes (%s): %d cases agree, max |err| %.3g; "
        "batch invariance, %d subsets bitwise equal to the 256-row product; "
        "%d rank products (the gate's and the up stack's rows at ep=%d) "
        "bitwise equal to their channels of the whole product"
        % (", ".join("%s F=%d E=%d" % c for c in QMM_MOE_SHAPES), n, worst,
           gates, parts, EP))
    return worst


def paged_cases(sms):
    """(S, C, H, KV, D, L, cache, q dtype, pos, dead rows NaN): float and
    int8 KV, C in {1, 5, 64, 256}, GQA 12->4, pos at 0, in the middle and at
    L-C; f32 and bf16; the 124M shapes in bf16. Then the short chunks the
    decode entry takes on a card of ``sms`` SMs: C in {1, 2, 4, 15} with
    pos on the edges of its key ranges (range - 1, range, L - C) and L not
    a multiple of the range (L = 1001, ranges of 126 keys at head_dim 64),
    GQA 12->3 and 12->4, NaN past each slot's live rows at C = 1 and 4, the
    int8 and f32 caches, and head_dim 16, 32, 100 and 128. Then the chunks
    the chunk entry takes, a bf16 q over the bf16 and over the int8 cache
    alike: C in {16, 64, 100, 128, 256}, pos 0, 512 and L-C (L=1024), one
    slot and three slots at those three positions, GQA 12->4 and 12->12,
    cases whose cache rows (int8: whose row scales) past each slot's live
    keys hold NaN (never read), and head_dim 16, 32 and 128. Then what the
    scalar entry still takes: an f32 q over an f32 cache at C = 64 and
    256, bf16 at head_dim 100 with C = 64, and the int8 cache under an f32
    q, with NaN scales past the live keys."""
    from mxnet_tpu_torch.ops.kernels import paged_decode_splits

    def edges(l_, d, c):
        w = -(-l_ // paged_decode_splits(l_, d, sms))
        return [w - 1, w, l_ - c]

    bf = torch.bfloat16
    f32 = torch.float32
    cases = []
    for kind in ("f32", "bf16", "int8"):
        for qdt in (torch.float32, bf):
            for c in (1, 5):
                for h, kv in ((12, 4), (4, 4)):
                    cases.append((3, c, h, kv, 64, 64, kind, qdt,
                                  [0, 31, 64 - c], False))
    cases.append((2, 64, 12, 4, 64, 128, "int8", bf, [0, 64], False))
    cases.append((1, 256, 12, 12, 64, 1024, "bf16", bf, [0], False))
    cases.append((1, 256, 12, 12, 64, 1024, "int8", bf, [0], False))
    cases.append((1, 64, 12, 12, 64, 1024, "bf16", bf, [0], False))
    cases.append((32, 1, 12, 12, 64, 1024, "bf16", bf, None, False))
    for c in (1, 2, 4, 15):
        for h, kv in ((12, 3), (12, 4)):
            cases.append((3, c, h, kv, 64, 1001, "bf16", bf,
                          edges(1001, 64, c), False))
    for c in (1, 4):
        for h, kv in ((12, 3), (12, 4)):
            cases.append((3, c, h, kv, 64, 1001, "bf16", bf,
                          edges(1001, 64, c), True))
    cases += [(3, 1, 12, 4, 64, 1001, "int8", bf, edges(1001, 64, 1), False),
              (3, 4, 12, 12, 64, 1001, "int8", bf, edges(1001, 64, 4),
               False),
              (3, 2, 12, 3, 64, 1001, "f32", f32, edges(1001, 64, 2), False)]
    for d, l_ in ((16, 1001), (32, 1001), (100, 1000), (128, 1001)):
        cases.append((3, 4, 12, 4, d, l_, "bf16", bf, edges(l_, d, 4),
                      False))
    cases.append((3, 1, 12, 3, 100, 1000, "int8", f32, edges(1000, 100, 1),
                  False))
    for kind in ("bf16", "int8"):
        for c in (16, 64, 100, 128, 256):
            for h, kv in ((12, 12), (12, 4)):
                at = [0, 512, 1024 - c]
                cases += [(1, c, h, kv, 64, 1024, kind, bf, [p], False)
                          for p in at]
                cases.append((3, c, h, kv, 64, 1024, kind, bf, at, False))
        cases += [(3, 100, 12, 4, 64, 1024, kind, bf, [0, 300, 924], True),
                  (1, 256, 12, 12, 64, 1024, kind, bf, [0], True)]
        cases += [(2, 100, 4, 2, d, 256, kind, bf, [0, 156], False)
                  for d in (16, 32, 128)]
        cases.append((3, 64, 12, 4, 128, 1024, kind, bf, [0, 300, 960],
                      True))
    cases += [(2, 64, 12, 4, 64, 1024, "f32", f32, [0, 960], False),
              (1, 256, 12, 12, 64, 1024, "f32", f32, [0], False),
              (2, 64, 12, 4, 100, 1000, "bf16", bf, [0, 936], False),
              (2, 64, 12, 4, 64, 1024, "int8", f32, [0, 512], False),
              (3, 100, 12, 4, 64, 1024, "int8", f32, [0, 300, 924], True)]
    return cases


def check_paged_attention(K, dev, gen):
    """Every case of ``paged_cases`` against the plain version, on the C
    entry ``K.paged_entry`` picks for it (asserted from the launch
    counters); every entry takes some case. A case with NaN past each
    slot's live rows (in the rows of a float cache, in the row scales of
    an int8 one) is held against the plain version slot by slot (it reads
    up to the largest pos + C of its batch). Returns {entry: max
    |err|}."""
    worst = {"paged_attention": 0.0, "paged_attention_chunk": 0.0,
             "paged_attention_decode": 0.0}
    counts = dict.fromkeys(worst, 0)
    cases = paged_cases(K._sm_count(dev))
    for s_, c, h, kv, d, l_, kind, qdt, pos, nan in cases:
        if pos is None:
            pos = torch.randint(0, l_ - c + 1, (s_,), generator=gen)
        pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
        q = _rand(gen, (s_, c, h, d), qdt).to(dev)
        k, v, ks, vs = _cache(gen, s_, l_, kv, d, kind, dev)
        if nan:
            for i, p in enumerate(pos.tolist()):
                for t in ((ks, vs) if kind == "int8" else (k, v)):
                    t[i, p + c:] = float("nan")
        entry = K.paged_entry(q.dtype, k.dtype, c, d)
        before = K.launch_counts()
        got = K.paged_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
        after = K.launch_counts()
        if nan:
            want = torch.cat([K.paged_attention_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], pos[i:i + 1],
                None if ks is None else ks[i:i + 1],
                None if vs is None else vs[i:i + 1])
                for i in range(s_)])
        else:
            want = K.paged_attention_plain(q, k, v, pos, ks, vs)
        torch.cuda.synchronize()
        ran = {e for e in after if after[e] != before[e]}
        if ran != {entry}:
            raise AssertionError("paged_attention s=%d c=%d %s %s launched %s,"
                                 " its route is %s" % (s_, c, kind, qdt,
                                                       sorted(ran), entry))
        err = compare("%s s=%d c=%d h=%d kv=%d d=%d l=%d pos=%s %s %s%s" % (
            entry, s_, c, h, kv, d, l_, pos.tolist()[:3], kind, qdt,
            " NaN past the live rows" if nan else ""), got, want)
        worst[entry] = max(worst[entry], err)
        counts[entry] += 1
    idle = [e for e, n in counts.items() if not n]
    if idle:
        raise AssertionError("paged_attention: no case reached %s" % idle)
    log("paged_attention: %d cases agree, %s by entry (%d with NaN past "
        "the live rows); max |err| %s" % (
            sum(counts.values()), counts, sum(1 for cs in cases if cs[-1]),
            {k_: "%.3g" % v_ for k_, v_ in worst.items()}))
    return worst


def check_paged_invariance(K, dev, gen):
    """The identities phase 4b's stream equality rests on, bitwise, at the
    124M serving shapes (bf16 cache, 12 heads of 64, L = 1024): each row of
    a verify chunk read through ``paged_attention_decode`` (S = 32, C = 5,
    random pos; also an f32 q, whose f32 rows show any difference, C = 2
    and GQA) equals a C = 1 read of the same cache at pos + c (a plain
    decode step's); and a prefill piece through ``paged_attention_chunk``
    at start 192, 256, 512 and 768 (C = 64 and 256, one slot) equals the
    same rows of one chunk over the whole prompt from pos 0 (what a
    prefix hit's suffix and a chunk piece compute, against a whole-prompt
    prefill)."""
    l_, h, d = 1024, 12, 64
    k, v, _, _ = _cache(gen, 32, l_, h, d, "bf16", dev)
    pos = torch.randint(0, l_ - 5, (32,), generator=gen,
                        dtype=torch.int32).to(dev)
    # an f32 q gives f32 rows, so any difference shows, not only one that
    # moves a bf16 rounding; C = 2 and 5, and GQA (12 heads over 4)
    for qdt, c_, kv in ((torch.bfloat16, 5, h), (torch.float32, 5, h),
                        (torch.float32, 2, h), (torch.float32, 5, 4)):
        q = _rand(gen, (32, c_, h, d), qdt).to(dev)
        kk, vv = (k, v) if kv == h else (k[:, :, :kv].contiguous(),
                                         v[:, :, :kv].contiguous())
        rows = K.paged_attention(q, kk, vv, pos)
        for c in range(c_):
            one = K.paged_attention(q[:, c:c + 1].contiguous(), kk, vv,
                                    pos + c)
            if not torch.equal(one[:, 0], rows[:, c]):
                raise AssertionError(
                    "paged_attention_decode: row %d of a C=%d read (%s q, %d "
                    "kv heads) differs from a C=1 read at pos + %d (max "
                    "|diff| %.3g)" % (c, c_, qdt, kv, c, (
                        one[:, 0].float() - rows[:, c].float()).abs().max()))
    k1, v1 = k[:1].contiguous(), v[:1].contiguous()
    qa = _rand(gen, (1, l_, h, d), torch.bfloat16).to(dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    whole = K.paged_attention(qa, k1, v1, zero)
    n = 0
    for start in (192, 256, 512, 768):
        for c in (64, 256):
            piece = K.paged_attention(qa[:, start:start + c].contiguous(),
                                      k1, v1, zero + start)
            if not torch.equal(piece, whole[:, start:start + c]):
                raise AssertionError(
                    "paged_attention_chunk: a C=%d piece at start %d differs "
                    "from the same rows of the whole chunk (max |diff| %.3g)"
                    % (c, start, (piece.float() - whole[:, start:start + c]
                                  .float()).abs().max()))
            n += 1
    log("paged_attention: the rows of C=5 and C=2 reads bitwise equal to "
        "C=1 reads at pos + c (S=32; bf16 and f32 q; 12 and 4 kv heads); %d "
        "chunk pieces at start > 0 bitwise equal to the rows of the "
        "whole-prompt chunk" % n)


def _fused_inputs(gen, s_, h, kv, d, l_, bits, group, xdt, cdt, dev, pos):
    e = h * d
    fq = e + 2 * kv * d
    wq, sq = _weights(gen, fq, e, bits, group, dev)
    wo, so = _weights(gen, e, e, bits, group, dev)
    bq = _rand(gen, (fq,), scale=0.1).to(dev)
    bo = _rand(gen, (e,), scale=0.1).to(dev)
    x = _rand(gen, (s_, e), xdt).to(dev)
    kc = _rand(gen, (s_, l_, kv, d), cdt).to(dev)
    vc = _rand(gen, (s_, l_, kv, d), cdt).to(dev)
    if pos is None:
        pos = torch.randint(0, l_, (s_,), generator=gen)
    pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
    return x, pos, kc, vc, wq, sq, bq, wo, so, bo


def check_fused_decode_attention(K, dev, gen):
    """int8 and int4 (group 16), rope on and off, GQA 12->4, pos at 0,
    in the middle and at L-1; f32 and bf16; the 124M shape in bf16, with
    12 and with 4 kv heads (and with pos on the edges of the read's key
    ranges), and in int4 (group 128) with rope. Then the
    batch-invariance gate: slots [5], [0, 3, 9, 20, 31] and all 32 of a
    124M step (int8, rope, 12 and 4 kv heads) give bitwise the same rows
    as among all 32."""
    cases = []
    for bits, group in ((8, None), (4, 16)):
        for rope in (True, False):
            for dt in (torch.float32, torch.bfloat16):
                cases.append((3, 12, 4, 8, 40, bits, group, rope, dt,
                              [0, 17, 39]))
    cases.append((4, 12, 12, 64, 128, 8, None, True, torch.bfloat16,
                  [0, 1, 63, 127]))
    cases.append((32, 12, 12, 64, 1024, 8, None, False, torch.bfloat16,
                  None))
    cases.append((32, 12, 4, 64, 1024, 8, None, True, torch.bfloat16,
                  None))
    cases.append((4, 12, 4, 64, 1024, 8, None, True, torch.bfloat16,
                  [511, 512, 513, 1023]))     # the key ranges' edges
    cases.append((32, 12, 12, 64, 1024, 4, 128, True, torch.bfloat16,
                  [0, 1023] + [None] * 30))
    worst = 0.0
    for s_, h, kv, d, l_, bits, group, rope, dt, pos in cases:
        if pos is not None and None in pos:
            pos = [p if p is not None else int(torch.randint(
                0, l_, (1,), generator=gen)) for p in pos]
        args = _fused_inputs(gen, s_, h, kv, d, l_, bits, group, dt, dt,
                             dev, pos)
        kw = dict(heads=h, kv_heads=kv, bits=bits, group=group, rope=rope)
        got = K.fused_decode_attention(*args, **kw)
        cos, sin = K._rope_tables(args[1], d // 2, rope, 10000.0)
        want = K.fused_decode_attention_plain(
            *args[:6], args[6].float(), *args[7:9], args[9].float(), cos,
            sin, h, bits, group, 1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        for part, g_, w_ in zip(("out", "k_new", "v_new"), got, want):
            err = compare("fused_decode_attention %s s=%d h=%d kv=%d l=%d "
                          "bits=%d rope=%s %s" % (part, s_, h, kv, l_, bits,
                                                   rope, dt), g_, w_)
            worst = max(worst, err)
    log("fused_decode_attention: %d cases agree, max |err| %.3g"
        % (len(cases), worst))
    for kv in (12, 4):
        args = _fused_inputs(gen, 32, 12, kv, 64, 1024, 8, None,
                             torch.bfloat16, torch.bfloat16, dev, None)
        kw = dict(heads=12, kv_heads=kv, bits=8, rope=True)
        full = K.fused_decode_attention(*args, **kw)
        for rows in ([5], [0, 3, 9, 20, 31], list(range(32))):
            sub = [a[rows].contiguous() if i < 4 else a
                   for i, a in enumerate(args)]
            for part, g_, f_ in zip(("out", "k_new", "v_new"),
                                    K.fused_decode_attention(*sub, **kw),
                                    full):
                if not torch.equal(g_, f_[rows]):
                    raise AssertionError(
                        "fused_decode_attention kv=%d: %s of slots %s alone"
                        " differs from the same slots among 32" % (
                            kv, part, rows[:5]))
    log("fused_decode_attention: batch invariance, slots at S=1, 5, 32 "
        "bitwise equal to the same slots among 32 (kv heads 12 and 4)")
    return worst


def time_kernels(K, dev, gen, worst):
    """Each kernel at a main-path shape of the 124M LM: its time, its
    plain version's, its bound and a library call's, in one entry of the
    kernels line (rows at the other main-path shapes are printed too)."""
    import torch.nn.functional as F
    timer = Timer(dev)
    entries = {}

    def row(name, shape, fn, plain, lib, nb, flops, dtype):
        ms, pms = timer(fn), timer(plain)
        lms = timer(lib) if lib is not None else None
        bms, by = bound_ms(nb, flops, dtype)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %s  "
            "bound %.4f ms (%s)" % (name, shape, ms, pms,
                                    "%.4f ms" % lms if lms else "none",
                                    bms, by))
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lms, "shape": shape}

    # quant_matmul: every product of a 124M decode step (M = 32 slots), of
    # a verify round (M = 160: 32 slots x spec_k + 1 = 5) and of a prefill
    # at the largest bucket (M = 256); beside the library
    # call (the f32 product of the dequantized weight), dense_bf16_ms:
    # F.linear on the weight already dequantized to bf16, twice the bytes
    for m in (32, 160, 256):
        for (f, e), what in zip(QMM_SHAPES, ("qkv", "proj", "ffn1", "ffn2",
                                             "lm_head")):
            x = _rand(gen, (m, e), torch.bfloat16).to(dev)
            q, s = _weights(gen, f, e, 8, None, dev)
            out = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
            r = row("quant_matmul", "%s M=%d F=%d E=%d" % (what, m, f, e),
                    lambda: K.quant_matmul(x, q, s),
                    lambda: K.quant_matmul_plain(x, q, s, 8, None,
                                                 torch.bfloat16),
                    lambda: torch.matmul(x.float(),
                                         (q.float() * s[:, None]).t()),
                    nbytes(x, q, s, out), 2 * m * f * e, torch.bfloat16)
            wd = (q.float() * s[:, None]).to(torch.bfloat16)
            r["dense_bf16_ms"] = timer(lambda: F.linear(x, wd))
            log("  quant_matmul %s M=%d: F.linear on the bf16 weight %.4f "
                "ms" % (what, m, r["dense_bf16_ms"]))
            del wd
            if what == "lm_head" and m == 32:
                entries["quant_matmul"] = r
            elif m == 160:          # a verify round's products (S=32, K=4)
                entries["quant_matmul"].setdefault("m160", {})[what] = {
                    k_: r[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                         "dense_bf16_ms", "bound_ms")}

    entries["quant_matmul"]["moe"] = time_quant_matmul_moe(K, dev, gen, row,
                                                           timer)

    # paged_attention: the serving buckets' prefill chunks (C = 64, 128,
    # 256 at pos 0) on the chunk entry, and the int8-KV serve's C = 256
    # chunk on it too (the chunk row's "int8"); the scalar entry's own row
    # at an f32 C = 256 chunk, on no path; then the decode entry at C = 1
    # over 32 slots with a bf16 cache (the default serving configuration's
    # read, beside SDPA with a mask) and with the int8 cache (the int8-KV
    # serve's), and at C = 4 and 5 (verify chunks at spec_k = 3 and 4, the
    # latter phase 4b's, beside SDPA with a mask). Each row off the
    # scalar entry puts the scalar entry beside it on the same inputs, in
    # turns.
    l_, h, d = 1024, 12, 64
    for s_, c, pos, kind in ((1, 64, [0], "bf16"), (1, 128, [0], "bf16"),
                             (1, 256, [0], "bf16"), (1, 256, [0], "int8"),
                             (1, 256, [0], "f32"),
                             (32, 1, None, "bf16"), (32, 1, None, "int8"),
                             (32, 4, None, "bf16"), (32, 5, None, "bf16")):
        if pos is None:
            pos = torch.randint(0, l_ - c + 1, (s_,), generator=gen)
        pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
        qdt = torch.float32 if kind == "f32" else torch.bfloat16
        q = _rand(gen, (s_, c, h, d), qdt).to(dev)
        k, v, ks, vs = _cache(gen, s_, l_, h, d, kind, dev)
        keys = [int(p) + cc + 1 for p in pos.tolist() for cc in range(c)]
        live_rows = sum(int(p) + c for p in pos.tolist())
        nb = nbytes(q) * 2 + live_rows * h * d * k.element_size() * 2 \
            + (live_rows * h * 4 * 2 if ks is not None else 0)
        flops = 4 * h * d * sum(keys)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        entry = K.paged_entry(q.dtype, k.dtype, c, d)
        shape = "S=%d C=%d H=12 L=1024 %s KV%s" % (
            s_, c, kind, ", f32 q" if kind == "f32" else "")
        lib = None
        if c < 16 and kind == "bf16":
            mask = (torch.arange(l_, device=dev)[None, None, :]
                    <= pos[:, None, None].long()
                    + torch.arange(c, device=dev)[None, :, None]
                    )[:, None]                            # [S, 1, C, L]

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        elif kind != "int8":
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt[:, :, :c], vt[:, :, :c], is_causal=True)

        def wrapper():
            return K.paged_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
        r = row(entry, shape, wrapper,
                lambda: K.paged_attention_plain(q, k, v, pos, ks, vs),
                lib, nb, flops, qdt)
        if entry != "paged_attention":
            out = torch.empty_like(q)
            P = K._ptr

            def scalar():
                K._launch("paged_attention", P(q), P(k), P(v), P(ks),
                          P(vs), P(pos), P(out), s_, c, h, h, l_, d,
                          1.0 / math.sqrt(d), K._CODE[q.dtype],
                          K._CODE[k.dtype])
            sms = [timer(f) for f in (scalar, wrapper, wrapper, scalar)]
            log("  A/B %s: scalar entry %.4f ms, %s %.4f ms, %.4f ms, "
                "scalar %.4f ms (same inputs, in turns)"
                % (shape, sms[0], entry, sms[1], sms[2], sms[3]))
            r["scalar_ms"] = statistics.median([sms[0], sms[3]])
        if entry == "paged_attention_decode" and c == 1 and kind == "bf16":
            entries[entry] = r
        elif entry == "paged_attention_decode" or kind == "int8":
            entries[entry]["int8" if kind == "int8" else "c%d" % c] = {
                k_: r[k_] for k_ in ("ms", "scalar_ms", "plain_ms",
                                     "library_ms", "bound_ms", "shape")}
        elif c == 256:
            entries[entry] = r

    # fused_decode_attention: one decode step of one attention node
    s_, h, d, l_ = 32, 12, 64, 1024
    args = _fused_inputs(gen, s_, h, h, d, l_, 8, None, torch.bfloat16,
                         torch.bfloat16, dev, None)
    x, pos = args[0], args[1]
    kw = dict(heads=h, kv_heads=h, bits=8, rope=False)
    cos, sin = K._rope_tables(pos, d // 2, False, 10000.0)
    e = h * d
    live = sum(pos.tolist())
    nb = nbytes(x, pos, *args[4:]) + live * h * d * 2 * 2 \
        + nbytes(x) + 2 * s_ * h * d * 2
    flops = 2 * s_ * (3 * e * e + e * e) + 4 * h * d * (live + s_)
    entries["fused_decode_attention"] = row(
        "fused_decode_attention", "S=32 E=768 L=1024 int8",
        lambda: K.fused_decode_attention(*args, **kw),
        lambda: K.fused_decode_attention_plain(
            *args[:6], args[6].float(), *args[7:9], args[9].float(), cos,
            sin, h, 8, None, 1.0 / math.sqrt(d)),
        None, nb, flops, torch.bfloat16)
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


def time_quant_matmul_moe(K, dev, gen, row, timer):
    """``quant_matmul`` at the MoE LM's products (phase 4g): the gate, the
    up stack and a down slice at M = 32 (a decode step) and 256 (a
    prefill at the largest bucket) in int8, and at M = 32 in int4 (group
    128); each beside the f32 product of the dequantized weight (the
    library row) and ``F.linear`` on the weight dequantized to bf16.
    ``row`` times and prints one row (``time_kernels``'). Returns {shape:
    its figures}."""
    import torch.nn.functional as F
    moe = {}
    for what, f, e in QMM_MOE_SHAPES[:3]:
        for m, bits in ((32, 8), (256, 8), (32, 4)):
            group = 128 if bits == 4 else None
            x = _rand(gen, (m, e), torch.bfloat16).to(dev)
            q, s = _weights(gen, f, e, bits, group, dev)
            w32 = K._dequant_w(q, s, bits, group)
            if bits == 8:
                w32 = w32 * s[:, None]
            out = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
            r = row("quant_matmul", "MoE %s M=%d F=%d E=%d int%d" % (
                what, m, f, e, bits),
                lambda: K.quant_matmul(x, q, s, bits=bits, group=group),
                lambda: K.quant_matmul_plain(x, q, s, bits, group,
                                             torch.bfloat16),
                lambda: torch.matmul(x.float(), w32.t()),
                nbytes(x, q, s, out), 2 * m * f * e, torch.bfloat16)
            wd = w32.to(torch.bfloat16)
            r["dense_bf16_ms"] = timer(lambda: F.linear(x, wd))
            log("  quant_matmul MoE %s M=%d int%d: F.linear on the bf16 "
                "weight %.4f ms" % (what, m, bits, r["dense_bf16_ms"]))
            del wd, w32
            moe["%s M=%d int%d" % (what, m, bits)] = {
                k_: r[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                     "dense_bf16_ms", "bound_ms",
                                     "bound_by")}
    return moe


# -- phase 3b: the training kernels against their plain versions ------------

# bf16 flash gradients: |kernel - plain| <= GRAD_REL * max|plain| per
# tensor. The kernels round P and dS to bf16 (2^-9 relative) for the
# products with V, K, Q and dO, where the plain version keeps them f32; a
# gradient sums up to T such rounded terms of mixed sign, and the results
# are stored in bf16 (2^-9 relative of the largest value): a few bf16 ulps
# of the tensor's largest value, not of each element (elements near 0 come
# from cancelling sums)
GRAD_REL = 2.0 ** -6


def compare_scaled(name, got, want, rel):
    """Max |got - want| / max|want|, raising past ``rel``."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    top = w.abs().max().item()
    if not torch.isfinite(g).all() or err > rel * top:
        raise AssertionError(
            "%s: kernel disagrees with the plain version: max |err| %.3g, "
            "%.3g of max |plain| %.3g (gate %.3g)" % (
                name, err, err / max(top, 1e-30), top, rel))
    return err


def _flash_inputs(gen, b, t, h, d, dtype, dev):
    return [_rand(gen, (b, t, h, d), dtype).to(dev) for _ in range(4)]


def flash_cases():
    """(B, T, H, D, causal, window, dtype, scale): the 124M training shape
    in bf16 (ParallelTrainer) and f32 (the Executor's LM), then ragged lengths (T=100, T=1000: not multiples of the 64-row tiles),
    non-causal and windowed, f32 and bf16, every head_dim the kernels take,
    and a negative and a zero scale (None: 1/sqrt(D))."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 1024, 12, 64, True, 0, bf, None),
             (8, 1024, 12, 64, True, 0, f32, None)]
    for dt in (f32, bf):
        for t in (100, 1000):
            cases += [(2, t, 3, 64, True, 0, dt, None),
                      (2, t, 3, 64, False, 0, dt, None),
                      (2, t, 3, 64, True, 33, dt, None)]
        for d in (16, 32, 128) + ((8,) if dt is f32 else ()):
            cases.append((2, 77, 2, d, True, 5 if d == 32 else 0, dt, None))
        cases += [(2, 100, 3, 64, True, 0, dt, -0.125),
                  (2, 100, 3, 64, False, 0, dt, 0.0)]
    return cases


def check_flash_attention(K, dev, gen):
    """Forward (o, lse), then dQ and dK/dV from the same o and lse, kernel
    against plain, in every case of ``flash_cases``; then the f32 forward
    and backward from q/k/v views whose rows are off 16-byte boundaries and
    from a dO off one. Returns the largest errors: {entry: max |err|}."""
    worst = {"flash_attention_fwd": 0.0, "flash_attention_dq": 0.0,
             "flash_attention_dkv": 0.0}
    for b, t, h, d, causal, window, dt, scale in flash_cases():
        q, k, v, do = _flash_inputs(gen, b, t, h, d, dt, dev)
        kw = dict(causal=causal, window=window, scale=scale)
        tag = "B=%d T=%d H=%d D=%d causal=%s window=%d scale=%s %s" % (
            b, t, h, d, causal, window, scale, dt)
        o, lse = K.flash_attention_fwd(q, k, v, **kw)
        o_p, lse_p = K.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                 window)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        grads_p = K.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                              scale, window)
        torch.cuda.synchronize()
        errs = {"fwd o": compare("flash fwd o " + tag, o, o_p),
                "fwd lse": compare("flash fwd lse " + tag, lse, lse_p)}
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"],
                                           *errs.values())
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p):
            entry = "flash_attention_dq" if name == "dq" else \
                "flash_attention_dkv"
            errs[name] = compare("flash %s %s" % (name, tag), g_, w_) \
                if dt is torch.float32 else \
                compare_scaled("flash %s %s" % (name, tag), g_, w_, GRAD_REL)
            worst[entry] = max(worst[entry], errs[name])
        if (b, t, h, dt) == (8, 1024, 12, torch.float32):
            log("flash %s (the Executor's LM shape): kernel against plain "
                "under TOL[f32], max |err| %s" % (tag, ", ".join(
                    "%s %.3g" % kv for kv in errs.items())))
    # the f32 kernels' 4-byte copies: q, k and v as views into one buffer
    # whose rows lie 97 floats apart, off 16-byte boundaries, with dO
    # starting one float past a 16-byte boundary; then contiguous q, k and
    # v with only dO (and o) off a boundary, so that dO alone picks the
    # backward's copies
    b, t, h, d = 2, 77, 2, 16
    buf = _rand(gen, (b, t, 3 * h * d + 1)).to(dev)
    views = [buf[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
             for i in range(3)]
    q0, k0, v0, do0 = _flash_inputs(gen, b, t, h, d, torch.float32, dev)

    def off16(a):
        """a's values, contiguous, one float past a 16-byte boundary."""
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        return flat[1:].view(a.shape).copy_(a)

    for what, (q, k, v), o_off in (
            ("q/k/v rows 97 floats apart, dO off 16 bytes", views, False),
            ("dO and o off 16 bytes", (q0, k0, v0), True)):
        o, lse = K.flash_attention_fwd(q, k, v, causal=True)
        o_p, lse_p = K.flash_attention_fwd_plain(q, k, v, True)
        if o_off:
            o = off16(o)
        do = off16(do0)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        grads_p = K.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        tag = "B=2 T=77 H=2 D=16 causal f32, " + what
        worst["flash_attention_fwd"] = max(
            worst["flash_attention_fwd"],
            compare("flash fwd o " + tag, o, o_p),
            compare("flash fwd lse " + tag, lse, lse_p))
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p):
            entry = "flash_attention_dq" if name == "dq" else \
                "flash_attention_dkv"
            worst[entry] = max(worst[entry], compare(
                "flash %s %s" % (name, tag), g_, w_))
    log("flash_attention: %d cases agree (fwd, dq, dk/dv; and the f32 "
        "forward and backward from misaligned views), max |err| %s" % (
            len(flash_cases()), {k: "%.3g" % v for k, v in worst.items()}))
    return worst


def check_flash_repeat(K, dev):
    """Two runs of the bf16 backward on the same (q, k, v, o, lse, dO) give
    the same bits (each output tile has one owner: no atomics), at the
    124M training shape and at a ragged windowed one (inputs from a
    generator of their own)."""
    gen = torch.Generator().manual_seed(2)
    for b, t, h, d, causal, window in ((8, 1024, 12, 64, True, 0),
                                       (2, 1000, 3, 64, True, 33)):
        q, k, v, do = _flash_inputs(gen, b, t, h, d, torch.bfloat16, dev)
        kw = dict(causal=causal, window=window)
        o, lse = K.flash_attention_fwd(q, k, v, **kw)
        runs = [K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        tag = "B=%d T=%d H=%d D=%d causal=%s window=%d bf16" % (
            b, t, h, d, causal, window)
        if not same:
            raise AssertionError("flash backward %s: two runs on the same "
                                 "inputs differ" % tag)
        log("flash backward %s: two runs give the same bits" % tag)


# -- phase 3d: striped_pair_attention against its plain version -------------

SP_RING, SP_C, SP_BH, SP_D = 4, 1024, 24, 64   # one hop of the SP main path


def spair_cases():
    """(BH, C, D, n, q_off, k_off, dtype): every ring position pair of the
    main path's hop (n=4, [24, 1024, 64]) in f32 and bf16; n=1 (the causal
    mask); n=3 at a ragged C=100 (not a multiple of the tiles), every pair;
    head_dim 32, 64 and 128, and in f32 also 8 and 16."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(SP_BH, SP_C, SP_D, SP_RING, qo, ko, dt) for dt in (f32, bf)
             for qo in range(SP_RING) for ko in range(SP_RING)]
    cases += [(6, 300, 64, 1, 0, 0, dt) for dt in (f32, bf)]
    cases += [(4, 100, 64, 3, qo, ko, dt) for dt in (f32, bf)
              for qo in range(3) for ko in range(3)]
    cases += [(4, 200, d, 4, qo, ko, dt) for d in (32, 64, 128)
              for dt in (f32, bf) for qo, ko in ((1, 2), (2, 1))]
    cases += [(4, 200, d, 4, qo, ko, f32) for d in (8, 16)
              for qo, ko in ((1, 2), (2, 1))]
    return cases


def check_striped_pair(K, dev, gen):
    """Forward (o, lse), then dQ and dK/dV from the same o and lse under a
    random g_o and a nonzero g_lse, kernel against plain, in every case of
    ``spair_cases``: o and f32 gradients to the dtype's tolerance, lse to
    the f32 tolerance, bf16 gradients to GRAD_REL of the tensor's largest
    value (the flash rule of phase 3b). At n=1 the hop is causal attention:
    its o, lse and gradients (g_lse = 0) are also held against the flash
    kernels on the same inputs. Returns {entry: max |err|}."""
    worst = dict.fromkeys(("striped_pair_fwd", "striped_pair_dq",
                           "striped_pair_dkv"), 0.0)
    cases = spair_cases()
    for bh, c, d, n, qo, ko, dt in cases:
        q, k, v, go = (_rand(gen, (bh, c, d), dt).to(dev) for _ in range(4))
        gl = _rand(gen, (bh, c, 1)).to(dev)
        tag = "BH=%d C=%d D=%d n=%d q_off=%d k_off=%d %s" % (
            bh, c, d, n, qo, ko, dt)
        o, lse = K.striped_pair_attention_fwd(q, k, v, qo, ko, n_stride=n)
        o_p, lse_p = K.striped_pair_attention_plain(q, k, v, qo, ko, n)
        grads = K.striped_pair_attention_bwd(q, k, v, o, lse, go, gl, qo, ko,
                                             n_stride=n)
        grads_p = K.striped_pair_attention_bwd_plain(q, k, v, o, lse, go, gl,
                                                     qo, ko, n)
        torch.cuda.synchronize()
        worst["striped_pair_fwd"] = max(
            worst["striped_pair_fwd"], compare("striped o " + tag, o, o_p),
            compare("striped lse " + tag, lse, lse_p))
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p):
            entry = "striped_pair_dq" if name == "dq" else "striped_pair_dkv"
            err = compare("striped %s %s" % (name, tag), g_, w_) \
                if dt is torch.float32 else \
                compare_scaled("striped %s %s" % (name, tag), g_, w_,
                               GRAD_REL)
            worst[entry] = max(worst[entry], err)
        if n == 1:
            as4 = [t[:, :, None, :] for t in (q, k, v, go)]
            fo, flse = K.flash_attention_fwd(*as4[:3], causal=True)
            fg = K.flash_attention_bwd(*as4[:3], fo, flse, as4[3],
                                       causal=True)
            sg = K.striped_pair_attention_bwd(q, k, v, o, lse, go,
                                              torch.zeros_like(gl), 0, 0,
                                              n_stride=1)
            torch.cuda.synchronize()
            same = torch.equal(fo[:, :, 0], o) and torch.equal(
                flse, lse[..., 0]) and all(
                torch.equal(a[:, :, 0], b) for a, b in zip(fg, sg))
            compare("striped n=1 o vs flash " + tag, o, fo[:, :, 0])
            compare("striped n=1 lse vs flash " + tag, lse[..., 0], flse)
            for name, a, b in zip(("dq", "dk", "dv"), sg, fg):
                if dt is torch.float32:
                    compare("striped n=1 %s vs flash %s" % (name, tag), a,
                            b[:, :, 0])
                else:
                    compare_scaled("striped n=1 %s vs flash %s" % (name, tag),
                                   a, b[:, :, 0], GRAD_REL)
            log("striped_pair n=1 %s: equals flash_attention causal (bitwise "
                "%s)" % (dt, same))
    log("striped_pair_attention: %d cases agree (fwd o and lse, dq, dk/dv "
        "with g_lse), max |err| %s" % (
            len(cases), {k_: "%.3g" % v_ for k_, v_ in worst.items()}))
    return worst


def time_striped_pair(K, dev, gen, worst):
    """One hop of the SP main path ([24, 1024, 64], n=4, q_off=1, k_off=2)
    in f32 (the main path's dtype: the kernels line) and bf16: each C
    entry's time, the plain version's, the bound from the hop's visible
    pairs, and the one PyTorch call that gives (o, lse) with the striped
    mask as a bias (``_scaled_dot_product_efficient_attention``) and the
    one that gives (dq, dk, dv) from it
    (``_scaled_dot_product_efficient_attention_backward``); then the
    compiler's line of each f32 forward kernel."""
    timer = Timer(dev)
    qo, ko = 1, 2
    mask = K._striped_mask(SP_C, SP_C, qo, ko, SP_RING, dev)
    pairs = int(mask.sum()) * SP_BH
    scale = 1.0 / math.sqrt(SP_D)
    entries = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, go = (_rand(gen, (SP_BH, SP_C, SP_D), dt).to(dev)
                       for _ in range(4))
        gl = _rand(gen, (SP_BH, SP_C, 1)).to(dev)
        o, lse = K.striped_pair_attention_fwd(q, k, v, qo, ko,
                                              n_stride=SP_RING)
        dcap = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        cfg = (SP_BH, SP_C, SP_C, SP_D, scale, SP_RING, qo, ko, K._CODE[dt])
        P = K._ptr

        def dq_launch():
            K._launch("striped_pair_dq", P(q), P(k), P(v), P(o), P(go),
                      P(lse), P(gl), P(dcap), P(dq), *cfg)

        def dkv_launch():
            K._launch("striped_pair_dkv", P(q), P(k), P(v), P(go), P(lse),
                      P(dcap), P(dk), P(dv), *cfg)

        dq_launch()
        bias = torch.zeros((SP_C, SP_C), dtype=dt, device=dev).masked_fill(
            ~mask, float("-inf"))[None, None].expand(1, SP_BH, SP_C, SP_C)
        q4, k4, v4 = (x[None] for x in (q, k, v))

        def lib():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, bias, True, scale=scale)

        lo4, llse, seed, offset = lib()
        go4 = go[None]

        def lib_bwd():
            return torch.ops.aten \
                ._scaled_dot_product_efficient_attention_backward(
                    go4, q4, k4, v4, bias, lo4, llse, seed, offset, 0.0,
                    [True, True, True, False], False, scale=scale)

        ms = {"fwd": timer(lambda: K.striped_pair_attention_fwd(
                  q, k, v, qo, ko, n_stride=SP_RING)),
              "dq": timer(dq_launch), "dkv": timer(dkv_launch)}
        plain = {"fwd": timer(lambda: K.striped_pair_attention_plain(
                     q, k, v, qo, ko, SP_RING)),
                 "bwd": timer(lambda: K.striped_pair_attention_bwd_plain(
                     q, k, v, o, lse, go, gl, qo, ko, SP_RING))}
        lib_ms = timer(lib)
        lib_bwd_ms = timer(lib_bwd)
        row = nbytes(q)
        spec = {
            # entry: (ms, plain ms, library ms, bytes, flops)
            "striped_pair_fwd": (ms["fwd"], plain["fwd"], lib_ms,
                                 4 * row + nbytes(lse), 4 * SP_D * pairs),
            "striped_pair_dq": (ms["dq"], plain["bwd"], lib_bwd_ms,
                                6 * row + 3 * nbytes(lse), 6 * SP_D * pairs),
            "striped_pair_dkv": (ms["dkv"], plain["bwd"], lib_bwd_ms,
                                 6 * row + 2 * nbytes(lse),
                                 8 * SP_D * pairs),
        }
        shape = "BH=24 C=1024 D=64 n=4 q_off=1 k_off=2 %s" % (
            "f32" if dt is torch.float32 else "bf16")
        for name, (kms, pms, lms, nb, flops) in spec.items():
            bms, by = bound_ms(nb, flops, dt)
            log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %s  "
                "bound %.4f ms (%s)" % (name, shape, kms, pms,
                                        "%.4f ms" % lms if lms else "none",
                                        bms, by))
            if dt is torch.float32:
                entries[name] = {"ms": kms, "plain_ms": pms,
                                 "library_ms": lms, "bound_ms": bms,
                                 "bound_by": by, "shape": shape}
    log("  (%d visible pairs of %d in the hop; plain dq and dkv times are "
        "the whole plain backward; the library times are the efficient "
        "attention forward with the mask as a bias and the logsumexp, and "
        "its backward (dq, dk, dv in one call, no lse cotangent) for both "
        "dq and dkv)" % (pairs, SP_BH * SP_C * SP_C))
    log(ptxas_lines(K, "striped_pair_attention",
                    ("fwd_f32", "dq_f32", "dkv_f32")))
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


def check_fused_linear(K, dev, gen):
    """Every activation at a ragged shape (M=100, K=70, N=130: no tile or
    16-byte multiple) in f32 and bf16, with and without bias, with and
    without the per-column ``scale`` (the folded BatchNorm of the conv
    path), then the 124M ffn1 shape (M=8192, K=768, N=3072, bf16, relu;
    also in f32, where it takes the 128-column tile) and the SP path's
    (one rank's M=2048, f32, relu with bias); then f32 at M=129, N=65 with
    K = 3, 5 and 767, and from a misaligned view of x."""
    cases = [(100, 70, 130, act, dt, bias, scale)
             for act in ("linear", "relu", "sigmoid", "tanh")
             for dt in (torch.float32, torch.bfloat16)
             for bias in (True, False) for scale in (False, True)]
    cases += [(8192, 768, 3072, "relu", torch.bfloat16, True, False),
              (8192, 768, 3072, "relu", torch.bfloat16, True, True),
              (33, 768, 2304, "tanh", torch.bfloat16, True, True),
              (2048, 768, 3072, "relu", torch.float32, True, False),
              (8192, 768, 3072, "relu", torch.float32, True, True)]
    # f32 around the register tiles (128 rows, 64 or 128 columns, K steps
    # of 16): one row and one column past a tile, K not a multiple of 4
    # or of 16; "view": x a contiguous view 4 bytes off a 16-byte boundary
    # (the guarded element loads)
    cases += [(129, kd, 65, "relu", torch.float32, True, True)
              for kd in (3, 5, 767)]
    cases += [(129, 64, 65, "linear", torch.float32, "view", False)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for m, kd, n, act, dt, bias, scale in cases:
        x = _rand(gen, (m, kd), dt).to(dev)
        if bias == "view":
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(m, kd)
            assert x.data_ptr() % 16 == 4
        w = _rand(gen, (n, kd), dt, 1.0 / math.sqrt(kd)).to(dev)
        b = _rand(gen, (n,), dt, 0.1).to(dev) if bias else None
        s = (torch.rand((n,), generator=gen) + 0.5).to(dev) if scale \
            else None
        got = K.fused_linear_fwd(x, w, b, act, s)
        want = K.fused_linear_plain(x, w, b, act, s)
        torch.cuda.synchronize()
        worst[dt] = max(worst[dt], compare(
            "fused_linear M=%d K=%d N=%d %s %s bias=%s scale=%s"
            % (m, kd, n, act, dt, bias, scale), got, want))
    log("fused_linear: %d cases agree (%d with scale), max |err| f32 %.3g, "
        "bf16 %.3g" % (len(cases), sum(bool(c[-1]) for c in cases),
                       worst[torch.float32], worst[torch.bfloat16]))
    return max(worst.values())


# -- phase 3c: the conv-net kernels against their plain versions ---------------

RESNET_CLASSES, RESNET_LAYERS, RESNET_HW = 1000, 50, 224
RESNET_B = 256                      # bench.py:115 bench_resnet50
# matmul_stats' column sums: |kernel - plain| <= STAT_REL * sum_m |y| for
# s1 and STAT_REL * sum_m y^2 for s2, per column. Both sum the same exact
# f32 products (bf16 x bf16 is exact in f32) in other orders, each a tree
# of partial sums (128-row tiles, then torch.sum): the error of such a sum
# of M terms grows like log2(M) f32 ulps of the sum of magnitudes, ~1e-6
# at M = 802816 (stage 1 at B=256); sqrt(M) ulps, the typical error of a
# sum in sequence, is 5.3e-5
STAT_REL = 1e-4


def chain_convs(sym, data):
    """Every conv -> BatchNorm chain of ``sym`` with input ``data`` (a
    shape), in the plan's order: {name, x, w (shapes), stride, pad,
    dilate, act, pointwise, from_data (x is the graph's input, NCHW)},
    from the port's FusionPlan and shape inference."""
    from mxnet_tpu_torch.ops.fusion import FusionPlan
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=data)
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._heads, outs)}
    convs = []
    plan = FusionPlan(sym._topo(), sym._heads)
    for kind, nodes in plan.chains.values():
        if kind == "fc_act":
            continue
        conv = nodes[0]
        p = conv.params
        (xn, xi), (wn, _) = conv.inputs[:2]
        convs.append(dict(
            name=conv.name, x=shape_of[(id(xn), xi)],
            w=shape_of[(id(wn), 0)], stride=tuple(p["stride"]),
            pad=tuple(p["pad"]), dilate=tuple(p["dilate"]),
            act="relu" if kind == "conv_bn_relu" else "linear",
            pointwise=FusionPlan._conv_is_pointwise(p),
            from_data=xn.is_var))
    return convs


def resnet_convs(batch):
    """ResNet-50's conv -> BatchNorm chains at ``batch`` x 3 x 224 x 224
    (:func:`chain_convs`)."""
    from mxnet_tpu_torch.models import get_resnet
    return chain_convs(get_resnet(RESNET_CLASSES, RESNET_LAYERS),
                       (batch, 3, RESNET_HW, RESNET_HW))


def zoo_convs(name, batch):
    """The conv -> BatchNorm chains of a zoo model (``get_symbol(name)``)
    at ``batch`` images of the size phase 7c feeds it."""
    from mxnet_tpu_torch.models import get_symbol
    hw = ZOO_HW[name]
    return chain_convs(get_symbol(name), (batch, 3, hw, hw))


def _stats_err(name, got, want, scale):
    """Max |got - want| / scale per column, raising past STAT_REL."""
    rel = ((got.float() - want.float()).abs() / scale.clamp_min(1e-30))
    if not torch.isfinite(got).all() or (rel > STAT_REL).any():
        raise AssertionError(
            "%s: kernel disagrees with the plain version: %.3g of the sum "
            "of magnitudes (gate %g)" % (name, rel.max().item(), STAT_REL))
    return rel.max().item()


def check_matmul_stats(K, dev, gen, dgen):
    """Each distinct pointwise conv of ResNet-50 at the main path's B=256
    in bf16 (M = 256 H W, K and N its channels; inputs drawn on the card
    from ``dgen``), each of ResNet-50 and Inception-BN at the legacy
    fits' B=64 in f32, then ragged shapes: (130, 70, 36) in f32 and
    bf16, M = 1000 (not a multiple of the 128-row tile), N = 130 past one
    column tile, K = 33 (the guarded scalar loads), and an f32 product
    large enough to take the 128-column f32 tile (25088, 256, 1024). y to
    the dtype's
    tolerance; s1 and s2 per column to STAT_REL of the sums of |y| and
    y^2. Returns the largest |y| error."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = sorted({(c["x"][0] * c["x"][2] * c["x"][3], c["w"][1], c["w"][0])
                    for c in resnet_convs(RESNET_B) if c["pointwise"]})
    cases = [(m, kd, n, bf, dgen) for m, kd, n in cases]
    # the legacy fit loops' f32 shapes at B=64: ResNet-50's (phase 7b) and
    # Inception-BN's (phase 7c: N = 64-352, some never seen in ResNet-50)
    fit = sorted({(c["x"][0] * c["x"][2] * c["x"][3], c["w"][1], c["w"][0])
                  for c in resnet_convs(CLASSIC_RESNET_B)
                  + zoo_convs("inception-bn", ZOO_FIT_B) if c["pointwise"]})
    cases += [(m, kd, n, f32, dgen) for m, kd, n in fit]
    n_model = len(cases)
    cases += [(m, kd, n, dt, gen) for m, kd, n, dt in (
        (130, 70, 36, f32), (130, 70, 36, bf), (1000, 64, 64, bf),
        (1000, 64, 64, f32), (257, 24, 130, bf), (77, 33, 20, bf),
        (77, 33, 20, f32), (25088, 256, 1024, f32))]
    worst, worst_stat = 0.0, 0.0
    for m, kd, n, dt, g in cases:
        x = _rand(g, (m, kd), dt).to(dev)
        w = _rand(g, (n, kd), dt, 1.0 / math.sqrt(kd)).to(dev)
        y, s1, s2 = K.matmul_stats_fwd(x, w)
        yp, s1p, s2p = K.matmul_stats_plain(x, w)
        mag = (x.float() @ w.float().t()).abs().sum(dim=0)
        torch.cuda.synchronize()
        tag = "M=%d K=%d N=%d %s" % (m, kd, n, dt)
        worst = max(worst, compare("matmul_stats y " + tag, y, yp))
        worst_stat = max(worst_stat,
                         _stats_err("matmul_stats s1 " + tag, s1, s1p, mag),
                         _stats_err("matmul_stats s2 " + tag, s2, s2p, s2p))
        del x, w, y, s1, s2, yp, s1p, s2p, mag
    log("matmul_stats: %d cases agree (%d ResNet-50 1x1 shapes at B=%d "
        "bf16; %d f32 1x1 shapes of the legacy fits of ResNet-50 and "
        "Inception-BN at B=%d), max |y err| %.3g, statistics within %.3g "
        "of their sums of magnitudes (gate %g)" % (
            len(cases), n_model - len(fit), RESNET_B, len(fit), ZOO_FIT_B,
            worst, worst_stat, STAT_REL))
    return worst


def _conv_inputs(gen, xs, ws, dt, dev):
    fan_in = ws[1] * ws[2] * ws[3]
    return (_rand(gen, xs, dt).to(dev),
            _rand(gen, ws, dt, 1.0 / math.sqrt(fan_in)).to(dev),
            (torch.rand((ws[0],), generator=gen, device=gen.device)
             + 0.5).to(dev),
            _rand(gen, (ws[0],), scale=0.1).to(dev))


def check_fused_conv_bn_act(K, dev, gen, dgen):
    """Each distinct conv of ResNet-50 at the main path's B=256 with its
    chain's activation: in f32 (what the eval forward runs: the implicit
    GEMM) from an NCHW and from a channels-last x (the stem's C = 3 takes
    the guarded element loads), in bf16 on the channels-last x the
    previous fused conv leaves (the stem's input NCHW; inputs drawn on the
    card from ``dgen``), each distinct chain of the eval forwards of phase
    7c in f32 (Inception-BN at B=256, Inception-v3 at B=64: its 1x7, 7x1,
    1x3 and 3x1 convs on the implicit GEMM, its stride-1 3x3 convs at the
    odd outputs 147, 71 and 35 on Winograd's ragged tiles; x channels-last
    but for the chain on the data; those two kinds are logged), then
    small ragged cases in f32 and bf16, relu and linear: 3x3 pad 1, 7x7/2
    pad 3, a non-square kernel with stride (2, 1), pad (1, 2) and dilation
    (2, 1), dilation 2, 1x1 stride 1 and stride 2, each from an NCHW and a
    channels-last x; then the Winograd path's ragged cases in f32 at B=2
    (odd H x W, 7 x 7, 3 x 3, 1 x 1, pads 0 and 2, C = 4 and 12, O past a
    64-channel block) and 3x3 convs that stay on the implicit GEMM (C = 3,
    stride 2), each asserted on the path ``kernels.conv_algo`` names and
    logged with it. Against the plain version (F.conv2d in f32, TF32 off),
    to the dtype's tolerance."""
    bf, f32 = torch.bfloat16, torch.float32
    seen, cases = set(), []
    for c in resnet_convs(RESNET_B):
        key = (c["x"], c["w"], c["stride"], c["pad"], c["dilate"], c["act"])
        if key not in seen:
            seen.add(key)
            cases += [key + (f32, dgen, cl) for cl in (False, True)]
            cases.append(key + (bf, dgen, c["x"][1] > 3))
    n_resnet = len(cases)
    # the eval forwards of phase 7c (f32): each distinct chain of
    # Inception-BN at B=256 and of Inception-v3 at B=64 (kh != kw on the
    # implicit GEMM: 1x7, 7x1, 1x3, 3x1; Winograd's ragged tiles at the
    # odd outputs 147, 71, 35), x channels-last as the previous chain or
    # Concat leaves it (NCHW for the chain on the data)
    for name, b in (("inception-bn", ZOO_PRED_B),
                    ("inception-v3", ZOO_V3_B)):
        for c in zoo_convs(name, b):
            key = (c["x"], c["w"], c["stride"], c["pad"], c["dilate"],
                   c["act"])
            if key not in seen:
                seen.add(key)
                cases.append(key + (f32, dgen, not c["from_data"], "zoo"))
    n_zoo = len(cases) - n_resnet
    for dt in (f32, bf):
        for ws, st, pd, dl, act in (
                ((9, 5, 3, 3), (1, 1), (1, 1), (1, 1), "relu"),
                ((9, 5, 7, 7), (2, 2), (3, 3), (1, 1), "relu"),
                ((9, 5, 3, 2), (2, 1), (1, 2), (2, 1), "linear"),
                ((9, 5, 3, 3), (1, 1), (2, 2), (2, 2), "linear"),
                ((9, 5, 1, 1), (1, 1), (0, 0), (1, 1), "relu"),
                ((9, 5, 1, 1), (2, 2), (0, 0), (1, 1), "linear")):
            for cl in (False, True):
                cases.append(((2, 5, 13, 10), ws, st, pd, dl, act, dt, gen,
                              cl))
    n_small = len(cases) - n_resnet - n_zoo
    # (x, w, stride, pad, act, the path): ragged Winograd cases, then 3x3
    # convs the rule keeps on the implicit GEMM
    wino = [((2, 8, 9, 13), (12, 8, 3, 3), 1, 0, "relu", "winograd"),
            ((2, 8, 9, 13), (72, 8, 3, 3), 1, 2, "linear", "winograd"),
            ((2, 16, 7, 7), (36, 16, 3, 3), 1, 1, "relu", "winograd"),
            ((2, 4, 5, 11), (9, 4, 3, 3), 1, 1, "linear", "winograd"),
            ((2, 4, 3, 3), (9, 4, 3, 3), 1, 0, "relu", "winograd"),
            ((2, 12, 1, 1), (33, 12, 3, 3), 1, 2, "linear", "winograd"),
            ((2, 3, 9, 13), (9, 3, 3, 3), 1, 1, "relu", "implicit"),
            ((2, 8, 9, 13), (12, 8, 3, 3), 2, 1, "relu", "implicit")]
    for xs, ws, st, pd, act, path in wino:
        for cl in (False, True):
            cases.append((xs, ws, (st, st), (pd, pd), (1, 1), act, f32, gen,
                          cl, path))
    worst = {f32: 0.0, bf: 0.0}
    paths = {}
    for xs, ws, st, pd, dl, act, dt, g, cl, *want_path in cases:
        x, w, s, b = _conv_inputs(g, xs, ws, dt, dev)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        kw = dict(stride=st, pad=pd, dilate=dl, act=act)
        path = K.conv_algo(dt, xs[1], ws[2:], st, pd, dl)
        paths[path] = paths.get(path, 0) + 1
        tag = "fused_conv_bn_act x=%s%s w=%s %s %s (%s)" % (
            xs, " channels-last" if cl else "", ws, kw, dt, path)
        zoo = want_path == ["zoo"]
        if want_path and not zoo and path != want_path[0]:
            raise AssertionError("%s: the rule names %s, the case wants %s"
                                 % (tag, path, want_path[0]))
        got = K.fused_conv_bn_act(x, w, s, b, **kw)
        want = K.fused_conv_bn_act_plain(x, w, s, b, **kw)
        torch.cuda.synchronize()
        err = compare(tag, got, want)
        worst[dt] = max(worst[dt], err)
        if want_path and (not zoo or ws[2] != ws[3]
                          or (path == "winograd" and got.shape[2] % 2)):
            log("  %s: max |err| %.3g" % (tag, err))
        del x, w, s, b, got, want
    log("fused_conv_bn_act: %d cases agree (%d ResNet-50 conv shapes at "
        "B=%d, each in f32 from NCHW and channels-last x and in bf16; %d "
        "distinct f32 chains of Inception-BN at B=%d and Inception-v3 at "
        "B=%d; %d small ragged; %d of the Winograd rule's edges), max |err| "
        "f32 %.3g, bf16 %.3g; cases by path %s" % (
            len(cases), n_resnet // 3, RESNET_B, n_zoo, ZOO_PRED_B,
            ZOO_V3_B, n_small, len(cases) - n_resnet - n_zoo - n_small,
            worst[f32], worst[bf], json.dumps(paths, sort_keys=True)))
    return max(worst.values())


def time_cnn_kernels(K, dev, gen, worst):
    """The conv-net kernels at ResNet-50's B=256 shapes (inputs drawn on
    the card from ``gen``; the checks above held both at these shapes):
    matmul_stats at stage 1's `_a` conv (M = 256*56*56, K = 256, N = 64),
    fused_conv_bn_act in f32 (the eval forward's path) at the stride-1 3x3
    convs of stages 1-4 (x channels-last, as the main path gives it, relu;
    Winograd F(2x2, 3x3)), the stem and stage 2's 1x1 stride-2 projection
    (the implicit GEMM), and in bf16 at stage 1's 3x3 conv, whose time
    includes the im2col gather (the GEMM alone is printed beside it); then
    the compiler's line (registers, spills) of each f32 conv and GEMM
    kernel. A Winograd row's bound is stated two ways: from the direct
    product's FLOPs, and from F(2x2, 3x3)'s 16 multiply-adds per 2 x 2
    output tile, channel and output channel (the operations the kernel
    does; its ``bound_ms``)."""
    import torch.nn.functional as F
    timer = Timer(dev)
    bf = torch.bfloat16
    entries = {}
    m, kd, n = RESNET_B * 56 * 56, 256, 64
    x = _rand(gen, (m, kd), bf).to(dev)
    w = _rand(gen, (n, kd), bf, 1.0 / math.sqrt(kd)).to(dev)
    kms, pms, lms, bms, by, _ = _time_stats(timer, K, x, w)
    shape = "stage1 _a M=%d K=%d N=%d bf16" % (m, kd, n)
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(matmul + two column sums)  bound %.4f ms (%s)" % (
            "matmul_stats", shape, kms, pms, lms, bms, by))
    entries["matmul_stats"] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                               "bound_ms": bms, "bound_by": by,
                               "shape": shape}
    del x, w

    # fused_conv_bn_act in f32 (the eval forward's path) at stage 1's 3x3
    # conv (the kernels line's row) and those of stages 2-4 (Winograd), the
    # stem (NCHW x, C = 3: the implicit GEMM's guarded loads) and stage
    # 2's 1x1 stride-2 projection; then bf16 at stage 1's 3x3 conv, with
    # its GEMM alone beside it (the bf16 path still gathers the patches by
    # one strided copy)
    P = K._ptr
    rows = {}
    for tag, xs, ws, st, pd, act, cl, dt in (
            ("f32", (RESNET_B, 64, 56, 56), (64, 64, 3, 3), 1, 1, "relu",
             True, torch.float32),
            ("stage2", (RESNET_B, 128, 28, 28), (128, 128, 3, 3), 1, 1,
             "relu", True, torch.float32),
            ("stage3", (RESNET_B, 256, 14, 14), (256, 256, 3, 3), 1, 1,
             "relu", True, torch.float32),
            ("stage4", (RESNET_B, 512, 7, 7), (512, 512, 3, 3), 1, 1,
             "relu", True, torch.float32),
            ("stem", (RESNET_B, 3, 224, 224), (64, 3, 7, 7), 2, 3, "relu",
             False, torch.float32),
            ("proj", (RESNET_B, 256, 56, 56), (512, 256, 1, 1), 2, 0,
             "linear", True, torch.float32),
            ("bf16", (RESNET_B, 64, 56, 56), (64, 64, 3, 3), 1, 1, "relu",
             True, bf)):
        kw = dict(stride=(st, st), pad=(pd, pd), dilate=(1, 1), act=act)
        x, w, s, b = _conv_inputs(gen, xs, ws, dt, dev)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        out = K.fused_conv_bn_act(x, w, s, b, **kw)
        wf = (w.float() * s[:, None, None, None]).to(dt)  # the folded weight
        bb = b.to(dt)
        act_fn = torch.relu if act == "relu" else (lambda y: y)
        kms = timer(lambda: K.fused_conv_bn_act(x, w, s, b, **kw))
        pms = timer(lambda: K.fused_conv_bn_act_plain(x, w, s, b, **kw))
        lms = timer(lambda: act_fn(F.conv2d(x, wf, bb, stride=st,
                                            padding=pd)))
        m, kdim = out.numel() // ws[0], ws[1] * ws[2] * ws[3]
        path = K.conv_algo(dt, xs[1], ws[2:], (st, st), (pd, pd), (1, 1))
        io = nbytes(x, w, s, b, out)
        bms, by = bound_ms(io, 2 * m * ws[0] * kdim, dt)
        shape = "%s %dx%d/%d x=%s%s %s %s (%s)" % (
            {"f32": "stage1", "bf16": "stage1", "stem": "stem",
             "proj": "stage2 projection"}.get(tag, tag), ws[2], ws[3], st,
            "x".join(map(str, xs)), " channels-last" if cl else " NCHW",
            "f32" if dt == torch.float32 else "bf16", act, path)
        row = {"ms": kms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bms, "bound_by": by, "shape": shape}
        extra = ""
        if path == "winograd":
            # F(2x2, 3x3): 16 multiply-adds per 2x2 outputs, i.e. 4 per
            # output position, input channel and output channel (the
            # function's own work; a ragged tile's padding is not counted)
            row["bound_direct_ms"], row["bound_direct_by"] = bms, by
            row["bound_ms"], row["bound_by"] = bound_ms(
                io, 2 * 4 * m * xs[1] * ws[0], dt)
            extra = " (bound from the direct product %.4f ms (%s))" % (
                bms, by)
            bms, by = row["bound_ms"], row["bound_by"]
        if dt == bf:
            xm, wm, _, _ = K._im2col(x, w, (st, st), (pd, pd), (1, 1))
            om = torch.empty((xm.shape[0], ws[0]), dtype=dt, device=dev)

            def gemm_only():
                K._launch("fused_conv_bn_act", P(xm), P(wm), P(s), P(b),
                          P(om), None, 0, 1, 1, xm.shape[0], xm.shape[1], 1,
                          xm.shape[0], ws[0], 1, 1, 1, 1, 0, 0, 1, 1, 1,
                          K._CODE[dt])

            row["gemm_ms"] = timer(gemm_only)
            extra = " (of which the GEMM %.4f ms, the im2col gather the " \
                "rest)" % row["gemm_ms"]
            del xm, wm, om
        log("time %-22s %-34s kernel %.4f ms%s  plain %.4f ms  library "
            "%.4f ms (F.conv2d with the scale folded%s%s)  bound %.4f ms "
            "(%s)%s" % ("fused_conv_bn_act", shape, kms,
                        extra if dt == bf else "", pms, lms,
                        " + relu" if act == "relu" else "",
                        ", TF32 off" if dt == torch.float32 else "", bms, by,
                        extra if path == "winograd" else ""))
        rows[tag] = row
        del x, w, s, b, out, wf, bb
    # the main path (the eval forward) runs the f32 path: stage 1's 3x3
    # conv is the kernels line's row, the other rows ride along in it
    entries["fused_conv_bn_act"] = dict(
        rows["f32"], **{t: rows[t] for t in ("stage2", "stage3", "stage4",
                                             "stem", "proj", "bf16")})
    for kname, keys in (("fused_linear", ("conv_wino", "wino_weights",
                                          "conv_f32", "fused_linear_f32")),
                        ("matmul_stats", ("matmul_stats_f32",))):
        log(ptxas_lines(K, kname, keys))
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


def check_mha_gqa(dev):
    """MultiHeadAttention's flash path with GQA (12 heads over 4 kv heads,
    the K/V repeat before the kernel), rope and a window, at T=100: its
    output and the gradients of sum(out * g) for the data and the four
    weights, on the card (the flash kernels) against the same op on the
    host (their plain versions), f32."""
    from mxnet_tpu_torch.ops.registry import get
    spec = get("MultiHeadAttention")
    b, t, e, h, kv = 2, 100, 768, 12, 4
    f = e + 2 * kv * (e // h)
    rng = np.random.RandomState(9)
    ins = [rng.randn(b, t, e), rng.randn(f, e) / math.sqrt(e),
           rng.randn(f) * 0.1, rng.randn(e, e) / math.sqrt(e),
           rng.randn(e) * 0.1]
    g = torch.from_numpy(rng.randn(b, t, e).astype(np.float32))
    worst = 0.0
    for window in (0, 33):
        p = spec.parse_params(dict(num_heads=h, num_kv_heads=kv, rope=True,
                                   window=window))
        res = {}
        for where in (dev, "cpu"):
            xs = [torch.from_numpy(a.astype(np.float32)).to(where)
                  .requires_grad_() for a in ins]
            out = spec.forward(p, xs, [], False, None)[0][0]
            (out * g.to(where)).sum().backward()
            res[str(where)] = [out.detach().cpu()] + [x.grad.cpu()
                                                      for x in xs]
        for i, (got, want) in enumerate(zip(res[str(dev)], res["cpu"])):
            worst = max(worst, compare("MultiHeadAttention GQA rope window=%d"
                                       " %s" % (window, ("out", "d_data",
                                                         "d_qkv_weight",
                                                         "d_qkv_bias",
                                                         "d_out_weight",
                                                         "d_out_bias")[i]),
                                       got, want))
    log("MultiHeadAttention GQA 12->4 rope, window 0 and 33, T=100: card "
        "against host agree, max |err| %.3g" % worst)


def time_train_kernels(K, dev, gen, worst):
    """The training kernels at the 124M step's shapes (B=8, T=1024, 12
    heads of 64, causal, bf16; ffn1 M=8192 K=768 N=3072 relu): time, plain
    time, bound and library time of each C entry; flash's f32 backward
    (the SP path's kernels under the flash mask) at B=1; and
    ``fused_linear`` at the SP step's f32 ffn1 (M=2048)."""
    import torch.nn.functional as F
    timer = Timer(dev)
    b, t, h, d = 8, 1024, 12, 64
    q, k, v, do = _flash_inputs(gen, b, t, h, d, torch.bfloat16, dev)
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    cfg = K._flash_kernel_args("flash_attention_dq", q, k, v) \
        + (1.0 / math.sqrt(d), 1, 0, K._CODE[torch.bfloat16])
    P = K._ptr

    def dq_launch():
        K._launch("flash_attention_dq", P(q), P(k), P(v), P(o), P(do),
                  P(lse), P(dcap), P(dq), *cfg)

    def dkv_launch():
        K._launch("flash_attention_dkv", P(q), P(k), P(v), P(do), P(lse),
                  P(dcap), P(dk), P(dv), *cfg)

    dq_launch()
    pairs = t * (t + 1) // 2 * b * h           # visible (query, key) pairs
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    gt = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True
                                       ).backward(gt)

    ms = {"fwd": timer(lambda: K.flash_attention_fwd(q, k, v, causal=True)),
          "dq": timer(dq_launch), "dkv": timer(dkv_launch)}
    plain = {"fwd": timer(lambda: K.flash_attention_fwd_plain(q, k, v,
                                                              True)),
             "bwd": timer(lambda: K.flash_attention_bwd_plain(
                 q, k, v, o, lse, do, True))}
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd = timer(sdpa_fwd_bwd) - lib_fwd
    row = nbytes(q)                             # one [B, T, H, D] tensor
    spec = {
        # entry: (ms, plain ms, library ms, bytes, flops)
        "flash_attention_fwd": (ms["fwd"], plain["fwd"], lib_fwd,
                                4 * row + nbytes(lse), 4 * d * pairs),
        "flash_attention_dq": (ms["dq"], plain["bwd"], lib_bwd,
                               6 * row + 2 * nbytes(lse), 6 * d * pairs),
        "flash_attention_dkv": (ms["dkv"], plain["bwd"], lib_bwd,
                                6 * row + 2 * nbytes(lse), 8 * d * pairs),
    }
    entries = {}
    shape = "B=8 T=1024 H=12 D=64 causal bf16"
    for name, (kms, pms, lms, nb, flops) in spec.items():
        bms, by = bound_ms(nb, flops, torch.bfloat16)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f "
            "ms  bound %.4f ms (%s)" % (name, shape, kms, pms, lms, bms, by))
        entries[name] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                         "bound_ms": bms, "bound_by": by, "shape": shape}
    log("  (plain and library times of dq and dkv are those of the whole "
        "backward: the plain backward, and SDPA forward+backward minus its "
        "forward)")
    # the f32 backward (the SP path's form, flash under Mask::Flash) at
    # B=1 T=1024: rows that ride along in the kernels line as "f32"
    b = 1
    q, k, v, do = _flash_inputs(gen, b, t, h, d, torch.float32, dev)
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    cfg = K._flash_kernel_args("flash_attention_dq", q, k, v) \
        + (1.0 / math.sqrt(d), 1, 0, K._CODE[torch.float32])
    dq_launch()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    gt = do.transpose(1, 2)
    ms = {"dq": timer(dq_launch), "dkv": timer(dkv_launch)}
    pms = timer(lambda: K.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    True))
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd = timer(sdpa_fwd_bwd) - lib_fwd
    pairs, row = t * (t + 1) // 2 * b * h, nbytes(q)
    shape = "B=1 T=1024 H=12 D=64 causal f32"
    for name, nb, flops in (
            ("flash_attention_dq", 6 * row + 2 * nbytes(lse), 6 * d * pairs),
            ("flash_attention_dkv", 6 * row + 2 * nbytes(lse),
             8 * d * pairs)):
        kms = ms[name.rsplit("_", 1)[1]]
        bms, by = bound_ms(nb, flops, torch.float32)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f "
            "ms  bound %.4f ms (%s)" % (name, shape, kms, pms, lib_bwd, bms,
                                        by))
        entries[name]["f32"] = {"ms": kms, "plain_ms": pms,
                                "library_ms": lib_bwd, "bound_ms": bms,
                                "bound_by": by, "shape": shape}

    m, kd, n = 8192, 768, 3072
    x = _rand(gen, (m, kd), torch.bfloat16).to(dev)
    w = _rand(gen, (n, kd), torch.bfloat16, 1.0 / math.sqrt(kd)).to(dev)
    bias = _rand(gen, (n,), torch.bfloat16, 0.1).to(dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    kms = timer(lambda: K.fused_linear_fwd(x, w, bias, "relu"))
    pms = timer(lambda: K.fused_linear_plain(x, w, bias, "relu"))
    lms = timer(lambda: torch.relu(F.linear(x, w, bias)))
    bms, by = bound_ms(nbytes(x, w, bias, out), 2 * m * n * kd,
                       torch.bfloat16)
    shape = "ffn1 M=8192 K=768 N=3072 bf16 relu"
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(F.linear + relu, two calls)  bound %.4f ms (%s)" % (
            "fused_linear", shape, kms, pms, lms, bms, by))
    entries["fused_linear"] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                               "bound_ms": bms, "bound_by": by,
                               "shape": shape}
    # the SP path's f32 ffn1 (one rank's M=2048), beside F.linear in f32
    # (TF32 off): the f32 row rides along in the kernels line
    m = 2048
    x = _rand(gen, (m, kd)).to(dev)
    w, bias = w.float(), bias.float()
    out = torch.empty((m, n), device=dev)
    kms = timer(lambda: K.fused_linear_fwd(x, w, bias, "relu"))
    pms = timer(lambda: K.fused_linear_plain(x, w, bias, "relu"))
    lms = timer(lambda: torch.relu(F.linear(x, w, bias)))
    bms, by = bound_ms(nbytes(x, w, bias, out), 2 * m * n * kd,
                       torch.float32)
    shape = "SP ffn1 M=2048 K=768 N=3072 f32 relu"
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(F.linear f32, TF32 off, + relu)  bound %.4f ms (%s)" % (
            "fused_linear", shape, kms, pms, lms, bms, by))
    entries["fused_linear"]["f32"] = {
        "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
        "bound_by": by, "shape": shape}
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


# -- phase 4: the main path -------------------------------------------------

VOCAB, LAYERS, EMBED, HEADS = 32000, 12, 768, 12
MAX_LEN, SLOTS, BUCKETS, STEPS_PER_ROUND = 1024, 32, (64, 128, 256), 8
N_REQUESTS, WAVES = 24, 9

# card vs host logits of the 124M LM in bf16: within LOGIT_ULPS bf16 ulps
# (2^-7 relative) of the row's largest |logit|. bf16 keeps 8 significant
# bits, and each side rounds the residual stream after each of ~10 ops per
# layer (120 roundings over 12 layers), in another order on each side: a
# random walk of ~sqrt(120) half-ulps, about 6 ulps, with room above it
LOGIT_ULPS = 16


def _lm_params(symbol, max_len, seed):
    """Seeded U(-0.05, 0.05) f32 weights for every argument of the LM."""
    shapes = {"data": (1, max_len), "softmax_label": (1, max_len)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.05, 0.05, sh).astype(np.float32)
            for n, sh in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}


def _serve_wave(engine, work, sampled=None):
    """Serve ``work`` [(prompt, budget)]: 8 requests up front, 4 more
    before each of the next rounds; ``sampled`` (index, temperature, seed)
    makes one request sampled. Returns (requests, seconds)."""
    work = list(work)
    handles = []
    t0 = time.perf_counter()
    while work or not engine.idle:
        for _ in range(8 if not handles else 4):
            if work:
                prompt, budget = work.pop(0)
                kw = {}
                if sampled is not None and len(handles) == sampled[0]:
                    kw = dict(temperature=sampled[1], seed=sampled[2])
                handles.append(engine.submit(prompt, max_tokens=budget,
                                             **kw))
        engine.step()
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0


def _wave_metrics(handles, seconds):
    """(tokens/s, ms per token p50, p99) of one wave."""
    ntok = sum(len(h.tokens) for h in handles)
    tpot = [(h.t_done - h.t_first) / (len(h.tokens) - 1) * 1e3
            for h in handles if len(h.tokens) > 1]
    return (ntok / seconds, float(np.percentile(tpot, 50)),
            float(np.percentile(tpot, 99)))


# -- the program layer: captured against uncaptured --------------------------

def check_compile_counts(engine, what):
    """The JAX package's compile contract for the waves served here: one
    decode program, no verify or copy program, one prefill program per
    bucket (every bucket is used)."""
    cc = engine.compile_counts
    want = {"decode": 1, "verify": 0, "prefill": dict.fromkeys(BUCKETS, 1),
            "copy": {}}
    if cc != want:
        raise AssertionError("%s: compile_counts %r, the contract wants %r"
                             % (what, cc, want))
    log("%s: compile_counts %s" % (what, json.dumps(
        {k: ({str(b): n for b, n in v.items()} if isinstance(v, dict)
             else v) for k, v in cc.items()})))


@contextlib.contextmanager
def eager_programs():
    """Every ``Program`` call inside runs its function uncaptured
    (``Program._run_eager``) over the same buffers: the captured paths
    are held against it, and its times stand for the uncaptured path."""
    from mxnet_tpu_torch.parallel.program import Program
    captured = Program.__call__
    Program.__call__ = Program._run_eager
    try:
        yield
    finally:
        Program.__call__ = captured


def free_programs():
    """Free the graphs and memory pools of the engines and trainers a
    phase left behind (each program and its owner refer to each other, so
    only the cycle collector frees them)."""
    gc.collect()
    torch.cuda.empty_cache()


def memory():
    """'peak P MB allocated, R MB reserved': the peak since the last
    reset, and the caching allocator's segments now, which hold the
    programs' graph pools (a captured program's intermediates stay in its
    pool between replays, reserved but not allocated)."""
    return "peak %.1f MB allocated, %.1f MB reserved" % (
        torch.cuda.max_memory_allocated() / 2**20,
        torch.cuda.memory_reserved() / 2**20)


def host_calls(prof):
    """{name: count} of the CUDA API calls (``cuda*`` and ``cu*``) that
    put work on the card (kernel and graph launches, copies, memsets) in
    a profile."""
    from torch.autograd import DeviceType
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith("cu")
            and any(w in e.key for w in ("Launch", "Memcpy", "Memset"))}


def check_eager_wave(engine, work, first):
    """The main path's wave through ``Program._run_eager``: its 24 streams
    must equal the captured wave's (``first``). Returns its tokens/s."""
    with eager_programs():
        handles, secs = _serve_wave(engine, work)
    for h, h0 in zip(handles, first):
        if h.tokens != h0.tokens:
            raise AssertionError(
                "request %s: the captured wave's stream differs from the "
                "same wave run uncaptured" % h.id)
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("main path, the same wave uncaptured (Program._run_eager): %d "
        "streams equal the captured wave's; %.1f tokens/s, ms per token "
        "p50 %.3f p99 %.3f; %s" % (len(handles), tps, p50, p99, card_line()))
    return tps


def check_sampled_wave(engine, work):
    """Sampled decoding on the card: one request (temperature 0.9, seed
    5) alone, then the same request inside a busy wave of sampled and
    greedy requests, each captured and uncaptured. Its stream must be
    the same in all four runs (a function of the seed and the positions,
    not of the batch), and the busy wave's streams captured must equal
    them uncaptured."""
    prompt = work[1][0]
    runs = {}
    for mode in ("captured", "uncaptured"):
        ctx = eager_programs() if mode == "uncaptured" \
            else contextlib.nullcontext()
        with ctx:
            alone = engine.submit(prompt, max_tokens=32, temperature=0.9,
                                  seed=5)
            while not engine.idle:
                engine.step()
            busy = [engine.submit(p, max_tokens=b,
                                  temperature=(0.7 if i % 2 else 0.0),
                                  seed=100 + i)
                    for i, (p, b) in enumerate(work[:12])]
            busy.insert(5, engine.submit(prompt, max_tokens=32,
                                         temperature=0.9, seed=5))
            while not engine.idle:
                engine.step()
        runs[mode] = (alone.tokens, [h.tokens for h in busy])
    streams = [runs[m][0] for m in runs] + [runs[m][1][5] for m in runs]
    if any(s != streams[0] for s in streams) or len(streams[0]) != 32:
        raise AssertionError("sampled request: its stream alone and in a "
                             "busy wave, captured and uncaptured, differ: "
                             "%r" % streams)
    if runs["captured"][1] != runs["uncaptured"][1]:
        raise AssertionError("sampled wave: captured and uncaptured "
                             "streams differ")
    log("sampled decoding: one request's 32 tokens equal alone and inside "
        "a busy wave beside 12 others (6 sampled), captured and uncaptured; "
        "the busy wave's streams equal captured and uncaptured (%d distinct "
        "tokens in the request's stream)" % len(set(streams[0])))


def serve_main_path(K, dev):
    """The 124M LM through save_checkpoint -> InferenceEngine.
    from_checkpoint -> WAVES waves of the same staggered greedy requests.
    Returns the launch counts of the served waves (counters zeroed just
    before the first and read just after the last), the checkpoint's
    prefix and the requests."""
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.serving import InferenceEngine

    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS)
    ckpt = os.path.join(HERE, "build", "smoke_ckpt")
    os.makedirs(ckpt, exist_ok=True)
    prefix = os.path.join(ckpt, "lm124m")
    t0 = time.perf_counter()
    save_checkpoint(prefix, 0, symbol, _lm_params(symbol, MAX_LEN, 0), {})
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused",
        compute_dtype="bfloat16", device=dev, prefix_cache_mb=0,
        prefill_chunk=0)
    torch.cuda.synchronize()
    log("main path: 124M LM (%d layers, E=%d, %d heads, vocab %d) "
        "checkpointed and loaded in %.1f s; int8 weights %.1f MB" % (
            LAYERS, EMBED, HEADS, VOCAB, time.perf_counter() - t0,
            engine.weight_bytes / 1e6))

    rs = np.random.RandomState(1)
    work = [(rs.randint(0, VOCAB, (int(rs.choice([24, 48, 96, 120, 200,
                                                  256])),)),
             int(rs.choice([32, 64]))) for _ in range(N_REQUESTS)]

    # warm-up: one request per bucket (first launches, cuBLAS-free path)
    for p in BUCKETS:
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()

    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    waves = [_serve_wave(engine, work) for _ in range(WAVES)]
    launches = K.launch_counts()
    rounds = engine.stats["steps"] - stats0["steps"]
    prefills = engine.stats["prefills"] - stats0["prefills"]
    steps = rounds * STEPS_PER_ROUND

    first = waves[0][0]
    for handles, _ in waves:
        for h, h0 in zip(handles, first):
            if not h.done or h.retire_reason != "length" \
                    or len(h.tokens) != h.limit:
                raise AssertionError("request %s did not finish its "
                                     "budget: %r" % (h.id, h))
            toks = np.asarray(h.tokens)
            if toks.min() < 0 or toks.max() >= VOCAB:
                raise AssertionError("request %s emitted ids outside the "
                                     "vocab" % h.id)
            if h.tokens != h0.tokens:
                raise AssertionError(
                    "request %s: a later wave's greedy stream differs from "
                    "the first wave's on the same prompt" % h.id)
    want = dict.fromkeys(launches, 0)   # the training entries stay 0
    want.update({"fused_decode_attention": LAYERS * steps,
                 # every prefill chunk (C = 64, 128, 256, bf16) takes the
                 # chunk entry; the scalar one stays 0
                 "paged_attention_chunk": LAYERS * prefills,
                 # per decode step: ffn1, ffn2 per layer + lm_head; per
                 # prefill also the qkv and out projections
                 "quant_matmul": (2 * LAYERS + 1) * steps
                 + (4 * LAYERS + 1) * prefills})
    if launches != want:
        raise AssertionError("launch counts %r, the main path wants %r"
                             % (launches, want))

    # two requests' streams against the offline decoder on the same weights
    dec = engine._dec
    checked = (first[0], max(first[1:], key=lambda r: len(r.prompt)))
    for h in checked:
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError(
                "request %s: the engine's greedy stream differs from "
                "Decoder.generate" % h.id)

    per_wave = [_wave_metrics(h, t) for h, t in waves]
    for i, ((hs, t), (tps, p50, p99)) in enumerate(zip(waves, per_wave)):
        log("main path wave %d: %d requests, %d tokens in %.3f s = %.1f "
            "tokens/s; ms per token p50 %.3f p99 %.3f" % (
                i, len(hs), sum(len(h.tokens) for h in hs), t, tps, p50,
                p99))
    cols = list(zip(*per_wave))
    log("main path: %d waves x %d requests, %d prefills, %d rounds x %d "
        "steps; median over waves (min-max): %.1f tokens/s (%.1f-%.1f), "
        "ms per token p50 %.3f (%.3f-%.3f), p99 %.3f (%.3f-%.3f); memory "
        "since the engine was built: %s; %s" % (
            WAVES, N_REQUESTS, prefills, rounds, STEPS_PER_ROUND,
            *(v for c in cols for v in (statistics.median(c), min(c),
                                        max(c))),
            memory(), card_line()))
    log("main path launches: %s" % json.dumps(launches))
    check_compile_counts(engine, "main path")
    check_eager_wave(engine, work, first)
    check_sampled_wave(engine, work)
    check_compile_counts(engine, "main path after the checks")
    check_main_against_host(prefix, dec, checked)
    profile_decode(engine, rs)
    with eager_programs():
        profile_decode(engine, rs, trace=None, what="uncaptured")
    time_prefill(K, dec)
    time_engine_prefill(engine)
    return launches, prefix, work, [h.tokens for h in first]


def time_prefill(K, dec, reps=10, profiled=3, what="124M"):
    """One 256-token prefill of the 124M decoder (the largest bucket, one
    slot, pos 0): its wall time after a synchronize (median and min-max of
    ``reps``), then, over ``profiled`` more under torch.profiler, its card
    kernel time and the paged chunk kernel's part of it (the kernels named
    ``fwd_mma``: the prefill runs no other attention forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = np.random.RandomState(5).randint(0, VOCAB, (1, BUCKETS[-1]))
    cache = dec.init_cache(1)
    for _ in range(2):
        dec.prefill(cache, prompt)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dec.prefill(cache, prompt)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            dec.prefill(cache, prompt)
        torch.cuda.synchronize()
    chunks = K.launch_counts()["paged_attention_chunk"]
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(us for _, us in rows) / profiled / 1e3
    paged = sum(us for key, us in rows if "fwd_mma" in key) / profiled / 1e3
    log("prefill of %d tokens (%s, one slot, pos 0): wall %.3f ms median "
        "(%.3f-%.3f) after a synchronize; card kernels %.3f ms, of which "
        "the paged chunk kernel %.4f ms (%d launches a prefill); %s" % (
            BUCKETS[-1], what, statistics.median(walls), min(walls),
            max(walls),
            total, paged, chunks // profiled, card_line()))


def time_engine_prefill(engine, prompt=None, what=None, reps=10,
                        profiled=3):
    """One admission through ``engine._admit`` with one request queued
    (what the engine runs for it: the prefix lookup and copy, the operand
    copy, the prefill replay and the first token's copy), by default of
    a 256-token prompt through the captured bucket-256 program: its wall
    time after a synchronize (median and min-max of ``reps``), then over
    ``profiled`` more under torch.profiler its card kernel time, its 16
    largest kernels and its host calls; the peak memory over all of them.
    Returns (median wall ms, card ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if prompt is None:
        prompt = np.random.RandomState(5).randint(0, VOCAB, (BUCKETS[-1],))
        what = "engine prefill of %d tokens (captured bucket-%d program, " \
            "one slot, pos 0)" % (BUCKETS[-1], BUCKETS[-1])

    def admit():
        engine.submit(prompt, max_tokens=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._admit()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def drain():
        while not engine.idle:
            engine.step()

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        walls.append(admit())
        drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            engine.submit(prompt, max_tokens=1)
        engine._admit()
        torch.cuda.synchronize()
    drain()
    rows = sorted(((e.self_device_time_total / profiled / 1e3,
                    e.count // profiled, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    card = sum(r[0] for r in rows)
    calls = host_calls(prof)
    log("%s: wall %.3f ms median (%.3f-%.3f) after a synchronize; card "
        "kernels %.3f ms; host calls per prefill %.1f %s; memory %s; %s" % (
            what, statistics.median(walls), min(walls), max(walls), card,
            sum(calls.values()) / profiled, json.dumps(calls), memory(),
            card_line()))
    log("  by kernel: %s" % "; ".join(
        "%s %.4f ms x%d" % (key[:60], ms, n) for ms, n, key in rows[:16]))
    return statistics.median(walls), card


def serve_default_path(K, dev, prefix, work):
    """The 124M checkpoint served as ``InferenceEngine.from_checkpoint``
    serves it by default (``weight_dtype`` and ``matmul_impl`` left to the
    decoder: float weights, dense products), in bf16: each decode step's
    attention is a C=1 read of the bf16 cache through
    ``paged_attention_decode``, each prefill chunk goes through
    ``paged_attention_chunk``. One wave of the main path's requests with
    the counters zeroed just before it and read just after: exact
    launches (no other kernel), every budget met, two requests' streams
    equal to ``Decoder.generate``; tokens/s, ms per token, and a 2-round
    decode profile (card kernel ms per decode step). Returns the launch
    counts."""
    from mxnet_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, compute_dtype="bfloat16",
        device=dev, prefix_cache_mb=0, prefill_chunk=0)
    dec = engine._dec
    if (dec.weight_dtype, dec._matmul_impl) != ("float", "dense"):
        raise AssertionError("the default engine took weight_dtype=%r, "
                             "matmul_impl=%r" % (dec.weight_dtype,
                                                 dec._matmul_impl))
    rs = np.random.RandomState(6)
    for p in BUCKETS:                    # warm-up: one request per bucket
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    launches = K.launch_counts()
    prefills = engine.stats["prefills"] - stats0["prefills"]
    steps = (engine.stats["steps"] - stats0["steps"]) * STEPS_PER_ROUND
    for h in handles:
        if not h.done or h.retire_reason != "length" \
                or len(h.tokens) != h.limit:
            raise AssertionError("default engine: request %s did not "
                                 "finish its budget: %r" % (h.id, h))
    want = dict.fromkeys(launches, 0)
    want.update({"paged_attention_decode": LAYERS * steps,
                 "paged_attention_chunk": LAYERS * prefills})
    if launches != want:
        raise AssertionError("default engine: launch counts %r, the path "
                             "wants %r" % (launches, want))
    for h in (handles[0], max(handles[1:], key=lambda r: len(r.prompt))):
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError("default engine: request %s's stream "
                                 "differs from Decoder.generate" % h.id)
    check_compile_counts(engine, "default engine")
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("default engine (float weights, dense products): %d requests, %d "
        "prefills, %d decode steps in %.3f s = %.1f tokens/s, ms per token "
        "p50 %.3f p99 %.3f; launches %s; %s" % (
            len(handles), prefills, steps, secs, tps, p50, p99,
            json.dumps({e: n for e, n in launches.items() if n}),
            card_line()))
    profile_decode(engine, rs, trace="decode_default_trace.json.gz")
    return launches


def serve_int8_kv_path(K, dev, prefix, work):
    """The 124M checkpoint served with the int8 KV cache
    (``cache_dtype="int8"``): the decode chain runs unfused, so each decode
    step's attention is a C=1 read of the int8 rows through
    ``paged_attention_decode``, and each prefill chunk (C >= 64) goes
    through ``paged_attention_chunk`` (the int8 tiles on the tensor cores),
    none through the scalar ``paged_attention`` entry. One wave of the main
    path's requests with the counters zeroed just before it and read just
    after: exact launches, every budget met, and two requests' streams
    equal to ``Decoder.generate`` of the same decoder; then one 256-token
    prefill's wall and card time. Returns the launch counts."""
    from mxnet_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused", cache_dtype="int8",
        compute_dtype="bfloat16", device=dev, prefix_cache_mb=0,
        prefill_chunk=0)
    rs = np.random.RandomState(4)
    for p in BUCKETS:                    # warm-up: one request per bucket
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    launches = K.launch_counts()
    prefills = engine.stats["prefills"] - stats0["prefills"]
    steps = (engine.stats["steps"] - stats0["steps"]) * STEPS_PER_ROUND
    for h in handles:
        if not h.done or h.retire_reason != "length" \
                or len(h.tokens) != h.limit:
            raise AssertionError("int8 KV: request %s did not finish its "
                                 "budget: %r" % (h.id, h))
    want = dict.fromkeys(launches, 0)
    want.update({"paged_attention_chunk": LAYERS * prefills,
                 "paged_attention_decode": LAYERS * steps,
                 # qkv, out, ffn1 and ffn2 per layer + lm_head, per decode
                 # step and per prefill
                 "quant_matmul": (4 * LAYERS + 1) * (steps + prefills)})
    if launches != want:
        raise AssertionError("int8 KV path: launch counts %r, the path "
                             "wants %r" % (launches, want))
    dec = engine._dec
    for h in (handles[0], max(handles[1:], key=lambda r: len(r.prompt))):
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError("int8 KV: request %s's stream differs from "
                                 "Decoder.generate" % h.id)
    check_compile_counts(engine, "int8 KV path")
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("int8 KV path: %d requests, %d prefills, %d decode steps in %.3f s "
        "= %.1f tokens/s, ms per token p50 %.3f p99 %.3f; launches %s" % (
            len(handles), prefills, steps, secs, tps, p50, p99,
            json.dumps({e: n for e, n in launches.items() if n})))
    time_prefill(K, dec, what="124M, int8 KV")
    time_engine_prefill(engine)
    return launches


# -- phase 4b: reuse and speculation -----------------------------------------

SPEC_K = 4
# the speculation waves' products: unfused, as a verify chunk's are. The
# fused decode step keeps q and the new token's k/v in f32 and rounds its
# output once after the bias, where the unfused walk rounds after each
# product: in bf16 a verify round's tokens and a fused step's part at
# near-ties, so a stream with speculation would not equal one without
SPEC_MM = "pallas"
SYSTEM_PROMPT = 192                  # tokens every prefix-wave request shares
POOL_MB = 160                        # 4 pool slots of 36 MiB at the 124M LM
CHUNK = 256


def _engine_4b(prefix, dev, **kw):
    """The 124M checkpoint behind the main path's engine configuration,
    with ``kw`` on top (every feature off unless given)."""
    from mxnet_tpu_torch.serving import InferenceEngine
    args = dict(max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
                steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
                weight_dtype="int8", matmul_impl="fused",
                compute_dtype="bfloat16", device=dev, prefix_cache_mb=0,
                prefill_chunk=0, draft="off")
    args.update(kw)
    return InferenceEngine.from_checkpoint(prefix, 0, **args)


def _build(engine, tags):
    """Run each program of ``tags`` once on the idle engine (every slot
    dead: nothing changes that a request reads), so that its warm-up runs
    and capture happen before a wave's launches are counted."""
    for tag in tags:
        engine._program(tag).run()
    torch.cuda.synchronize()


def _ttft_p50(handles):
    return float(np.percentile([(h.t_first - h.t_submit) * 1e3
                                for h in handles], 50))


def _pieces(engine, work):
    """The prefill buckets ``work`` uses on ``engine`` (chunk pieces as
    ``_advance_chunk`` splits them, prefix hits aside)."""
    used = set()
    for prompt, _ in work:
        n = len(prompt)
        while n > 0:
            piece = min(n, engine.prefill_chunk or BUCKETS[-1])
            used.add(engine._bucket_for(piece))
            n -= piece
    return used


def _contract(engine, what, prefill, copy=(), verify=0, draft=None):
    """The JAX package's compile contract for the configuration: one
    decode program, ``verify`` verify programs, one prefill program per
    bucket in ``prefill``, one copy program per bucket in ``copy``, and
    for a draft model one draft program and one draft prefill per bucket
    in ``draft``."""
    want = {"decode": 1, "verify": verify,
            "prefill": dict.fromkeys(sorted(prefill), 1),
            "copy": dict.fromkeys(sorted(copy), 1)}
    if draft is not None:
        want.update({"draft": 1,
                     "draft_prefill": dict.fromkeys(sorted(draft), 1)})
    cc = engine.compile_counts
    if cc != want:
        raise AssertionError("%s: compile_counts %r, the contract wants %r"
                             % (what, cc, want))
    return cc


def _equal_streams(what, handles, ref):
    """The streams of ``handles`` equal those of ``ref``."""
    for i, h in enumerate(handles):
        if not h.done or len(h.tokens) != h.limit:
            raise AssertionError("%s: request %s did not finish its "
                                 "budget: %r" % (what, h.id, h))
        if h.tokens != ref[i].tokens:
            raise AssertionError("%s: request %d's stream differs from the "
                                 "same engine's with the feature off"
                                 % (what, i))


def _equal_generate(what, dec, handles):
    for h in handles:
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError("%s: request %s's stream differs from "
                                 "Decoder.generate" % (what, h.id))


def _check_launches(K, what, want):
    got = K.launch_counts()
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError("%s: launch counts %r, the wave wants %r"
                             % (what, got, full))
    return got


def _wave_line(what, handles, secs, launches, extra=""):
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("%s: %d requests, %d tokens in %.3f s = %.1f tokens/s; ms per token "
        "p50 %.3f p99 %.3f; TTFT p50 %.3f ms%s; launches %s; %s" % (
            what, len(handles), sum(len(h.tokens) for h in handles), secs,
            tps, p50, p99, _ttft_p50(handles), extra,
            json.dumps({e: n for e, n in launches.items() if n}),
            card_line()))


def _card_ms(fn, n=3):
    """(wall ms median of 10 calls each after a synchronize, card kernel
    ms per call under torch.profiler over ``n`` more)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    card = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3
    return statistics.median(walls), card


def reuse_prefix_wave(K, dev, prefix, off, timer):
    """Wave 1: 24 requests share one 192-token system prompt, each with its
    own 8-56-token suffix, budgets 32/64, through a 160 MiB prefix pool
    (4 slots). Returns the wave's launches."""
    rs = np.random.RandomState(41)

    def wave(system):
        return [(np.concatenate([system, rs.randint(0, VOCAB, (int(n),))]),
                 int(rs.choice([32, 64])))
                for n in rs.randint(8, 57, N_REQUESTS)]
    warm = wave(rs.randint(0, VOCAB, (SYSTEM_PROMPT,)))
    work = wave(rs.randint(0, VOCAB, (SYSTEM_PROMPT,)))
    engine = _engine_4b(prefix, dev, prefix_cache_mb=POOL_MB)
    if engine._prefix.capacity != 4:
        raise AssertionError("prefix wave: %d pool slots, want 4"
                             % engine._prefix.capacity)
    _serve_wave(engine, warm)                  # every program built
    _build(engine, ("decode",))
    K.reset_launch_counts()
    s0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    d = {k: engine.stats[k] - s0[k] for k in engine.stats}
    steps = d["steps"] * STEPS_PER_ROUND
    launches = _check_launches(K, "prefix wave", {
        "fused_decode_attention": LAYERS * steps,
        "paged_attention_chunk": LAYERS * d["prefill_chunks"],
        "quant_matmul": (2 * LAYERS + 1) * steps
        + (4 * LAYERS + 1) * d["prefill_chunks"]})
    if d["prefix_hits"] < 20:
        raise AssertionError("prefix wave: %d hits, want >= 20"
                             % d["prefix_hits"])
    ref, _ = _serve_wave(off, work)
    _equal_streams("prefix wave", handles, ref)
    _equal_generate("prefix wave", engine._dec,
                    (handles[0], handles[1 + int(np.argmax(
                        [h.prefix_hit_tokens for h in handles[1:]]))]))
    _contract(engine, "prefix wave", {64, 256}, copy={256})
    _wave_line("phase 4b prefix wave (pool %d slots)" % (
        engine._prefix.capacity), handles, secs, launches,
        "; %d hits, %d hit tokens, %d copies, %d evictions" % (
            d["prefix_hits"], d["prefix_hit_tokens"], d["prefix_copies"],
            engine._prefix.evictions))

    # a hit's admission (the pool -> slot copy of 256 rows, then the
    # 64-bucket prefill of the last prompt token at start P-1) beside a
    # miss's (the 256-bucket prefill, no pool) on the same prompt
    prompt = handles[0].prompt
    hit = time_engine_prefill(
        engine, prompt, "phase 4b prefix hit's admission (%d-token prompt: "
        "copy + 64-bucket prefill at start %d)" % (len(prompt),
                                                   len(prompt) - 1))
    miss = time_engine_prefill(
        off, prompt, "phase 4b miss's admission (the same prompt, "
        "256-bucket prefill, no pool)")
    log("phase 4b a hit's admission against a miss's: %.2fx shorter wall, "
        "%.2fx card; %s" % (miss[0] / hit[0], miss[1] / hit[1],
                            card_line()))
    from mxnet_tpu_torch.serving.engine import _wide
    slot = torch.zeros(1, dtype=torch.int64, device=dev)

    def gather():                # as InferenceEngine._staged_run runs it
        for g, sg in zip(engine._groups, engine._stage_groups):
            torch.index_select(_wide(g), 1, slot,
                               out=_wide(sg)[:, :, :MAX_LEN])
    caches = engine._caches
    moved = 2 * sum(b[:1].numel() * b.element_size()
                    for e in caches for b in e)
    g_ms = timer(gather)
    c_ms = timer(engine._program(("copy", 256)).run)
    c_bytes = 2 * sum(b[:1, :256].numel() * b.element_size()
                      for e in caches for b in e)
    log("phase 4b gather-in (a slot's %d rows into the staging cache, one "
        "copy an allocation): %.4f ms for %.1f MB moved, bound %.4f ms; the "
        "copy program of bucket 256: %.4f ms for %.1f MB, bound %.4f ms; "
        "beside "
        "a 256-token prefill's %.3f ms of card time; %s" % (
            MAX_LEN, g_ms, moved / 1e6, moved / HBM_BYTES_PER_S * 1e3,
            c_ms, c_bytes / 1e6, c_bytes / HBM_BYTES_PER_S * 1e3, miss[1],
            card_line()))
    f_wall, f_card = _card_ms(engine._program("decode").run)
    log("phase 4b fused decode round of this engine (%d steps, 32 slots): "
        "wall %.3f ms, card %.3f ms = %.3f ms a step; %s" % (
            STEPS_PER_ROUND, f_wall, f_card, f_card / STEPS_PER_ROUND,
            card_line()))
    return launches


def reuse_chunk_wave(K, dev, prefix, off):
    """Wave 2: 20 short requests (24-120 tokens) decode while 4 prompts of
    600-1000 tokens admit in 256-token pieces. Returns the launches."""
    rs = np.random.RandomState(42)
    shorts = [(rs.randint(0, VOCAB, (int(rs.randint(24, 121)),)), 64)
              for _ in range(20)]
    longs = [(rs.randint(0, VOCAB, (int(n),)), 32)
             for n in (600, 777, 901, 1000)]
    work = shorts[:8] + longs[:2] + shorts[8:14] + longs[2:] + shorts[14:]
    is_long = [len(p) > BUCKETS[-1] for p, _ in work]
    engine = _engine_4b(prefix, dev, prefill_chunk=CHUNK)
    _serve_wave(engine, work)
    _build(engine, ("decode",))
    K.reset_launch_counts()
    s0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    d = {k: engine.stats[k] - s0[k] for k in engine.stats}
    steps = d["steps"] * STEPS_PER_ROUND
    launches = _check_launches(K, "chunk wave", {
        "fused_decode_attention": LAYERS * steps,
        # 12 a piece; the pieces after a long prompt's first run at
        # start > 0
        "paged_attention_chunk": LAYERS * d["prefill_chunks"],
        "quant_matmul": (2 * LAYERS + 1) * steps
        + (4 * LAYERS + 1) * d["prefill_chunks"]})
    later = sum(-(-len(p) // CHUNK) - 1 for p, _ in work)
    if d["prefill_chunks"] - d["prefills"] != later or later < 1:
        raise AssertionError("chunk wave: %d pieces for %d prefills, want "
                             "%d pieces at start > 0" % (
                                 d["prefill_chunks"], d["prefills"], later))
    _contract(engine, "chunk wave", _pieces(engine, work))
    ref, _ = _serve_wave(off, [w for w, lg in zip(work, is_long) if not lg])
    short_h = [h for h, lg in zip(handles, is_long) if not lg]
    _equal_streams("chunk wave", short_h, ref)
    long_h = [h for h, lg in zip(handles, is_long) if lg]
    _equal_generate("chunk wave", engine._dec, long_h)
    del engine
    free_programs()
    e128 = _engine_4b(prefix, dev, prefill_chunk=128)
    h128, _ = _serve_wave(e128, work)
    _equal_streams("chunk wave at prefill_chunk=128", handles, h128)
    tpot = [(h.t_done - h.t_first) / (len(h.tokens) - 1) * 1e3
            for h in short_h]
    _wave_line("phase 4b chunk wave (prefill_chunk=%d)" % CHUNK, handles,
               secs, launches,
               "; %d pieces for %d prefills (%d at start > 0); the 20 "
               "residents' ms per token p99 %.3f, p50 %.3f" % (
                   d["prefill_chunks"], d["prefills"], later,
                   float(np.percentile(tpot, 99)),
                   float(np.percentile(tpot, 50))))
    return launches


def _spec_launches(d, layers_d=None, drafts=0):
    """A speculating wave's launches from its stats, every product unfused
    (``SPEC_MM``): per verify round 12 ``paged_attention_decode`` (C = K+1)
    and 4*12+1 ``quant_matmul`` (M = S(K+1)); the same per plain decode
    step of a fallback round (C = 1, M = S); per prefill piece 12 chunk
    reads and 4*12+1 products; per run of the draft program over an
    ``layers_d``-layer draft, K walks (the catch-up chunk, then K-1 single
    tokens) of ``layers_d`` decode reads and 4 layers_d + 1 products each;
    per draft prefill ``layers_d`` chunk reads and 4 layers_d + 1
    products."""
    walks = d["spec_rounds"] + d["spec_fallback_rounds"] * STEPS_PER_ROUND
    want = {"paged_attention_decode": LAYERS * walks,
            "paged_attention_chunk": LAYERS * d["prefill_chunks"],
            "quant_matmul": (4 * LAYERS + 1) * (walks
                                                + d["prefill_chunks"])}
    if layers_d:
        ld = layers_d
        want["paged_attention_decode"] += ld * SPEC_K * drafts
        want["paged_attention_chunk"] += ld * d["prefills"]
        want["quant_matmul"] += (4 * ld + 1) * (SPEC_K * drafts
                                                + d["prefills"])
    return want


def _spec_work(seed):
    """24 prompts that repeat a 16-token phrase 3-15 times, budgets
    32/64."""
    rs = np.random.RandomState(seed)
    return [(np.tile(rs.randint(0, VOCAB, (16,)), int(rs.randint(3, 16))),
             int(rs.choice([32, 64]))) for _ in range(N_REQUESTS)]


def reuse_ngram_wave(K, dev, prefix, off, timer):
    """Wave 3: n-gram speculation (spec_k=4) over prompts that repeat a
    16-token phrase; one sampled request alone and in the wave, with
    speculation on and off. Returns the launches."""
    work = _spec_work(43)
    engine = _engine_4b(prefix, dev, draft="ngram", spec_k=SPEC_K,
                        matmul_impl=SPEC_MM)
    _serve_wave(engine, work)
    _build(engine, ("decode", "verify"))
    host = []
    spec_round = engine._spec_round

    def timed_round(busy):
        t0 = time.perf_counter()
        out = spec_round(busy)
        if out:
            host.append((time.perf_counter() - t0) * 1e3)
        return out
    engine._spec_round = timed_round
    K.reset_launch_counts()
    s0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    d = {k: engine.stats[k] - s0[k] for k in engine.stats}
    del engine._spec_round
    launches = _check_launches(K, "n-gram wave", _spec_launches(d))
    if d["spec_rounds"] < 1:
        raise AssertionError("n-gram wave: no verify round ran")
    ref, _ = _serve_wave(off, work)
    _equal_streams("n-gram wave", handles, ref)
    _equal_generate("n-gram wave", engine._dec,
                    (handles[0], max(handles[1:], key=lambda h: len(
                        h.prompt))))
    _contract(engine, "n-gram wave", _pieces(engine, work), verify=1)
    _wave_line("phase 4b n-gram wave (spec_k=%d)" % SPEC_K, handles, secs,
               launches,
               "; %d verify rounds, %d fallback rounds, %d drafted, %d "
               "accepted (%.3f a verify round); _spec_round host time "
               "median %.3f ms a verify round" % (
                   d["spec_rounds"], d["spec_fallback_rounds"],
                   d["spec_drafted"], d["spec_accepted"],
                   d["spec_accepted"] / max(1, d["spec_rounds"]),
                   statistics.median(host)))
    streams = []
    for eng in (engine, off):
        alone, _ = _serve_wave(eng, work[5:6], sampled=(0, 0.9, 5))
        busy, _ = _serve_wave(eng, work, sampled=(5, 0.9, 5))
        streams += [alone[0].tokens, busy[5].tokens]
    if any(s != streams[0] for s in streams):
        raise AssertionError("n-gram wave: the sampled request's stream "
                             "alone and in the wave, speculation on and "
                             "off, differ: %r" % streams)
    # a verify round against a plain decode round, on the idle engine
    # (every slot computed either way)
    v_wall, v_card = _card_ms(engine._program("verify").run)
    p_wall, p_card = _card_ms(engine._program("decode").run)
    log("phase 4b verify round (S=%d, C=%d): wall %.3f ms, card %.3f ms "
        "(events %.4f ms) for up to %d tokens a slot; unfused decode round "
        "(%d steps) wall %.3f ms, card %.3f ms = %.3f ms a step (events "
        "%.4f ms a step); sampled stream of %d tokens equal alone and in "
        "the wave, speculation on and off; %s" % (
            SLOTS, SPEC_K + 1, v_wall, v_card,
            timer(engine._program("verify").run), SPEC_K + 1,
            STEPS_PER_ROUND, p_wall, p_card, p_card / STEPS_PER_ROUND,
            timer(engine._program("decode").run) / STEPS_PER_ROUND,
            len(streams[0]), card_line()))
    return launches


def reuse_draft_waves(K, dev, prefix, off, timer):
    """Wave 4: draft-model speculation with (a) the target's own
    checkpoint as the draft, through ``from_checkpoint(draft_prefix=...)``,
    and (b) a 2-layer LM of the same width from seed 1. Returns the
    launches of both."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import Decoder
    work = _spec_work(44)
    ref, _ = _serve_wave(off, work)
    total = {}
    small = get_transformer_lm(VOCAB, num_layers=2, embed_dim=EMBED,
                               num_heads=HEADS)
    for what, layers_d in (("draft = the target", LAYERS),
                           ("draft = a 2-layer LM", 2)):
        if layers_d == LAYERS:
            # draft=None: a draft checkpoint turns draft="model" on
            engine = _engine_4b(prefix, dev, spec_k=SPEC_K, draft=None,
                                draft_prefix=prefix, draft_epoch=0,
                                matmul_impl=SPEC_MM)
            target = engine._dec
        else:
            ddec = Decoder(small, _lm_params(small, MAX_LEN, 1), MAX_LEN,
                           compute_dtype="bfloat16", device=dev)
            from mxnet_tpu_torch.serving import InferenceEngine
            engine = InferenceEngine(
                target, slots=SLOTS, prefill_buckets=BUCKETS,
                steps_per_round=STEPS_PER_ROUND, prefix_cache_mb=0,
                prefill_chunk=0, spec_k=SPEC_K, draft="model",
                draft_decoder=ddec)
        if engine.spec_draft != "model":
            raise AssertionError("%s: draft=%r" % (what, engine.spec_draft))
        _serve_wave(engine, work)
        _build(engine, ("decode", "verify", "draft"))
        runs = [0]
        prog = engine._program("draft")
        replay = prog.run

        def counted():
            runs[0] += 1
            return replay()
        prog.run = counted
        K.reset_launch_counts()
        s0 = dict(engine.stats)
        handles, secs = _serve_wave(engine, work)
        d = {k: engine.stats[k] - s0[k] for k in engine.stats}
        prog.run = replay
        launches = _check_launches(K, what, _spec_launches(
            d, layers_d, runs[0]))
        _equal_streams(what, handles, ref)
        _contract(engine, what, _pieces(engine, work), verify=1,
                  draft=_pieces(engine, work))
        if layers_d == LAYERS and d["spec_accepted"] <= d["spec_rounds"]:
            raise AssertionError("%s: %d accepted in %d verify rounds, want "
                                 "more" % (what, d["spec_accepted"],
                                           d["spec_rounds"]))
        _wave_line("phase 4b %s (spec_k=%d)" % (what, SPEC_K), handles,
                   secs, launches,
                   "; %d verify rounds, %d fallback rounds, %d draft runs, "
                   "%d drafted, %d accepted (%.3f a verify round); the "
                   "draft program %.4f ms of card time a run (events)" % (
                       d["spec_rounds"], d["spec_fallback_rounds"], runs[0],
                       d["spec_drafted"], d["spec_accepted"],
                       d["spec_accepted"] / max(1, d["spec_rounds"]),
                       timer(prog.run)))
        for e, n in launches.items():
            total[e] = total.get(e, 0) + n
        del engine, prog
        free_programs()
    return total


def reuse_main_path(K, dev, prefix):
    """Phase 4b: the 124M LM from phase 4's checkpoint behind the main
    path's engine configuration (the speculation waves with unfused
    products, ``SPEC_MM``), one wave each of prefix reuse, chunked
    prefill, n-gram speculation and draft-model speculation (two drafts);
    each wave's streams equal the same configuration's with the feature
    off, exact launches, the JAX compile contract. Returns the launches of
    every wave, summed."""
    timer = Timer(dev)
    total = {}

    def add(launches):
        for e, n in launches.items():
            total[e] = total.get(e, 0) + n
        free_programs()
    off = _engine_4b(prefix, dev)
    add(reuse_prefix_wave(K, dev, prefix, off, timer))
    add(reuse_chunk_wave(K, dev, prefix, off))
    del off
    free_programs()
    off = _engine_4b(prefix, dev, matmul_impl=SPEC_MM)
    add(reuse_ngram_wave(K, dev, prefix, off, timer))
    add(reuse_draft_waves(K, dev, prefix, off, timer))
    log("phase 4b launches: %s" % json.dumps(
        {e: n for e, n in total.items() if n}))
    return total


# -- phase 4c: robustness and observability ----------------------------------

WATCHDOG_MS = 50.0
# how far close() must bring memory_allocated back to its value before the
# engine was built
CLOSE_SLACK = 64 << 20
_PHASES = ("sched", "prefix_lookup", "h2d", "prefill", "copy", "dispatch",
           "drain")


def _decoder_4c(prefix, dev, mm="fused"):
    """The 124M checkpoint as phase 4's engine loads it (int8 weights,
    paged attention, bf16), products ``mm``."""
    from mxnet_tpu_torch.parallel import Decoder
    return Decoder.from_checkpoint(prefix, 0, MAX_LEN, attn_impl="paged",
                                   weight_dtype="int8", matmul_impl=mm,
                                   compute_dtype="bfloat16", device=dev)


def _engine_4c(dec, **kw):
    """Phase 4's engine configuration over ``dec``, ``kw`` on top."""
    from mxnet_tpu_torch.serving import InferenceEngine
    args = dict(slots=SLOTS, prefill_buckets=BUCKETS,
                steps_per_round=STEPS_PER_ROUND, prefix_cache_mb=0,
                prefill_chunk=0, draft="off")
    args.update(kw)
    return InferenceEngine(dec, **args)


def _warm(engine, seed=2):
    """One request per bucket: every prefill and the decode program are
    captured before a wave is timed or counted."""
    rs = np.random.RandomState(seed)
    for p in BUCKETS:
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()


def _counters():
    from mxnet_tpu_torch import telemetry
    return {n: m.value for n, m in list(telemetry._state.metrics.items())
            if n.startswith("serving.") and m.kind == "counter"}


def _main_launches(d):
    """Phase 4's launches for stats deltas ``d`` (fused decode step)."""
    steps = d["steps"] * STEPS_PER_ROUND
    return {"fused_decode_attention": LAYERS * steps,
            "paged_attention_chunk": LAYERS * d["prefill_chunks"],
            "quant_matmul": (2 * LAYERS + 1) * steps
            + (4 * LAYERS + 1) * d["prefill_chunks"]}


def _ledger(engine, since):
    """(rounds, mean wall ms a round, {phase: mean ms a round}) over the
    round ledger's dispatching rows after round ``since``."""
    rows = [r for r in engine.round_table()
            if r["round"] > since and r["dispatched"]]
    n = max(1, len(rows))
    return len(rows), sum(r["wall_ms"] for r in rows) / n, {
        k: sum(r["phases_ms"].get(k, 0.0) for r in rows) / n
        for k in _PHASES}


def _same_streams(what, handles, streams):
    for h, s in zip(handles, streams):
        if h.tokens != s:
            raise AssertionError("%s: request %s's stream differs from "
                                 "phase 4's" % (what, h.id))


def layer_cost(K, dec, work, streams):
    """4c.1: phase 4's wave on two engines in turns, 9 waves each: (a) the
    JAX package's defaults (telemetry on, a 256-request flight recorder),
    (b) ``telemetry.enable(False)`` and ``flight_recorder=0``. Streams
    equal phase 4's; the compile contract and the launches a round are
    phase 4's. Returns engine (a) and the launches."""
    from mxnet_tpu_torch import telemetry
    on = _engine_4c(dec)
    off = _engine_4c(dec, flight_recorder=0)
    if on.flight.retain != 256 or not telemetry.enabled():
        raise AssertionError("phase 4c: the defaults are not the JAX "
                             "package's (flight %d, telemetry %s)" % (
                                 on.flight.retain, telemetry.enabled()))
    for eng in (on, off):
        _warm(eng)
    marks = {id(e): e.round_table(1)[-1]["round"] for e in (on, off)}
    stats0 = {id(e): dict(e.stats) for e in (on, off)}
    K.reset_launch_counts()
    runs = {"on": [], "off": []}
    try:
        for i in range(WAVES):
            turn = (("on", on), ("off", off))
            for name, eng in (turn if i % 2 == 0 else turn[::-1]):
                telemetry.enable(name == "on")
                runs[name].append(_serve_wave(eng, work))
    finally:
        telemetry.enable(True)
    launches = K.launch_counts()
    want = dict.fromkeys(launches, 0)
    for e in (on, off):
        d = {k: e.stats[k] - stats0[id(e)][k] for k in e.stats}
        for k, n in _main_launches(d).items():
            want[k] += n
    if launches != want:
        raise AssertionError("phase 4c: launch counts %r, phase 4's "
                             "rounds want %r" % (launches, want))
    for name in runs:
        for handles, _ in runs[name]:
            _same_streams("phase 4c (%s)" % name, handles, streams)
    check_compile_counts(on, "phase 4c defaults on")
    check_compile_counts(off, "phase 4c layer off")
    for key, eng, name in (("on", on, "telemetry on, flight recorder 256"),
                           ("off", off, "telemetry off, flight recorder 0")):
        per = [_wave_metrics(h, t) for h, t in runs[key]]
        cols = list(zip(*per))
        n, wall, phases = _ledger(eng, marks[id(eng)])
        log("phase 4c layer cost (%s): %d waves in turns, median (min-max) "
            "%.1f tokens/s (%.1f-%.1f), ms per token p50 %.3f, p99 %.3f; "
            "round ledger over %d rounds: wall %.4f ms a round, by phase "
            "%s; %s" % (
                name, len(per), statistics.median(cols[0]), min(cols[0]),
                max(cols[0]), statistics.median(cols[1]),
                statistics.median(cols[2]), n, wall,
                json.dumps({k: round(v, 4) for k, v in phases.items()}),
                card_line()))
    ratio = statistics.median(_wave_metrics(h, t)[0] for h, t in runs["on"]) \
        / statistics.median(_wave_metrics(h, t)[0] for h, t in runs["off"])
    log("phase 4c layer cost: tokens/s with the layer on over off %.4f; "
        "streams of (a) and (b) equal phase 4's; compile_counts and "
        "launches a round equal phase 4's; launches %s" % (
            ratio, json.dumps({e: n for e, n in launches.items() if n})))
    del off
    return on, launches


def _hostile_work(rs):
    """48 greedy requests of 24-600 tokens (every second one past the
    system prompt's length shares a 192-token system prompt), budgets 64
    for the first 16 and 32/64 after."""
    system = rs.randint(0, VOCAB, (SYSTEM_PROMPT,))
    work = []
    for i in range(48):
        n = int(rs.randint(24, 601))
        if i % 2 and n > SYSTEM_PROMPT + 8:
            prompt = np.concatenate([system, rs.randint(
                0, VOCAB, (n - SYSTEM_PROMPT,))])
        else:
            prompt = rs.randint(0, VOCAB, (n,))
        work.append((prompt, 64 if i < 16 else int(rs.choice([32, 64]))))
    return work


def hostile_wave(K, dec):
    """4c.2: 48 requests against 32 slots with ``overload="shed_oldest"``
    and ``max_queue=8`` (prefix pool and 256-token chunks on): 32 come as
    the queue has room, at most 4 a round, then a burst of 16 at once;
    8 are cancelled and 4 have their deadline forced past 3 rounds after
    admission, 4 carry ``ttft_deadline_ms=0``. Survivors equal a
    feature-off engine's streams, the retired ones' partial streams are
    prefixes of them, ``stats`` and the ``serving.*`` counters count
    exactly the cancelled, deadline and shed requests, and free slots and
    prefix pins return. Returns the launches."""
    rs = np.random.RandomState(46)
    work = _hostile_work(rs)
    cancel, ttft0, late = range(0, 16, 2), (1, 5, 9, 13), (3, 7, 11, 15)
    ref_eng = _engine_4c(dec, prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK)
    ref, _ = _serve_wave(ref_eng, work)
    del ref_eng
    free_programs()
    eng = _engine_4c(dec, prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK,
                     overload="shed_oldest", max_queue=8)
    _serve_wave(eng, _hostile_work(np.random.RandomState(47))[:8])
    free0, pins0 = len(eng._free), eng._prefix.pinned
    s0, c0 = dict(eng.stats), _counters()
    K.reset_launch_counts()
    hs, admitted_at, rnd, nxt = [None] * 48, {}, 0, 0
    t0 = time.perf_counter()
    while nxt < 48 or not eng.idle:
        sent = 0
        while nxt < 32 and sent < 4 and eng.queued() < eng.max_queue:
            kw = {"ttft_deadline_ms": 0.0} if nxt in ttft0 else \
                {"deadline_ms": 1e9} if nxt in late else {}
            hs[nxt] = eng.submit(work[nxt][0], max_tokens=work[nxt][1],
                                 **kw)
            nxt, sent = nxt + 1, sent + 1
        if nxt == 32 and not sent:
            for i in range(32, 48):               # the burst
                hs[i] = eng.submit(work[i][0], max_tokens=work[i][1])
            nxt = 48
        for i in list(cancel) + list(late):
            h = hs[i]
            if h is not None and h.t_admit is not None \
                    and i not in admitted_at:
                admitted_at[i] = rnd
            if admitted_at.get(i) == rnd - 3 and not h.done:
                if i in late:
                    h._deadline = 0.0
                elif not eng.cancel(h.id):
                    raise AssertionError("hostile wave: cancel(%r) found "
                                         "no live request" % h.id)
        eng.step()
        rnd += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = {k: eng.stats[k] - s0[k] for k in eng.stats}
    c1 = _counters()
    dc = {k: c1[k] - c0.get(k, 0) for k in c1}
    launches = _check_launches(K, "hostile wave", _main_launches(d))
    reasons = collections.Counter(h.retire_reason for h in hs)
    for i, h in enumerate(hs):
        want = ("cancelled",) if i in cancel else ("deadline",) \
            if i in ttft0 or i in late else ("length", "shed")
        if h.retire_reason not in want or not h.done:
            raise AssertionError("hostile wave: request %d retired %r, "
                                 "want %r" % (i, h.retire_reason, want))
        if h.tokens != ref[i].tokens[:len(h.tokens)]:
            raise AssertionError("hostile wave: request %d's stream is not "
                                 "a prefix of the feature-off stream" % i)
        if h.retire_reason == "length" and h.tokens != ref[i].tokens:
            raise AssertionError("hostile wave: survivor %d's stream "
                                 "differs from the feature-off one" % i)
        if i in ttft0 and h.t_admit is not None:
            raise AssertionError("hostile wave: request %d expired in a "
                                 "slot, not in the queue" % i)
    want_counts = {"cancelled": 8, "deadline_missed": 8,
                   "shed": reasons["shed"], "errors": 0}
    got = ({k: d[k] for k in want_counts},
           {k: dc["serving." + n] for k, n in (
               ("cancelled", "cancelled"), ("deadline_missed",
                                            "deadline_missed"),
               ("shed", "shed"), ("errors", "request_errors"))})
    if reasons["cancelled"] != 8 or reasons["deadline"] != 8 \
            or reasons["shed"] < 8 or any(g != want_counts for g in got):
        raise AssertionError("hostile wave: retire reasons %r, stats and "
                             "counters %r" % (dict(reasons), got))
    if (len(eng._free), eng._prefix.pinned) != (free0, pins0):
        raise AssertionError("hostile wave: %d free slots and %d pins after "
                             "the wave, %d and %d before" % (
                                 len(eng._free), eng._prefix.pinned, free0,
                                 pins0))
    survivors = [h for h in hs if h.retire_reason == "length"]
    tps, _, p99 = _wave_metrics(survivors, secs)
    log("phase 4c hostile wave: 48 requests in %.3f s over %d rounds; "
        "retired %s; stats and serving.* counters count exactly the "
        "cancelled, deadline and shed ones; %d survivors equal the "
        "feature-off streams at %.1f tokens/s, ms per token p99 %.3f; "
        "partial streams are prefixes; free slots %d and pins %d as "
        "before; %d prefix hits; %s" % (
            secs, rnd, json.dumps(dict(reasons)), len(survivors), tps, p99,
            len(eng._free), eng._prefix.pinned, d["prefix_hits"],
            card_line()))
    return launches


def watchdog(engine, work, streams):
    """4c.3: ``round_timeout_ms=50`` under a 5 s injected round hang: the
    drain raises EngineStuck, ``health()`` says stuck, and once the hang
    is gone the same engine drains and finishes byte-identically. Then
    waves with the watchdog armed and not, in turns: no trip, and what
    recording and polling the round's event costs."""
    from mxnet_tpu_torch.serving import EngineStuck
    from mxnet_tpu_torch.testing.faults import FaultInjector
    engine.round_timeout_ms = WATCHDOG_MS
    fi = FaultInjector()
    hs = [engine.submit(p, max_tokens=b) for p, b in work[:8]]
    t0 = time.perf_counter()
    with fi.serving_round_hang(seconds=5):
        try:
            engine.serve_forever()
            raise AssertionError("watchdog: no EngineStuck under the hang")
        except EngineStuck:
            trip = time.perf_counter() - t0
        stuck = engine.health()["stuck"]
    if not stuck or engine.stats["watchdog_trips"] != 1:
        raise AssertionError("watchdog: health %r, %d trips" % (
            engine.health(), engine.stats["watchdog_trips"]))
    engine.serve_forever()
    if engine.health()["stuck"]:
        raise AssertionError("watchdog: still stuck after the drain")
    _same_streams("watchdog", hs, streams)
    spent = []
    dispatched = engine._dispatched

    def timed():
        t = time.perf_counter()
        ev = dispatched()
        spent.append(time.perf_counter() - t)
        return ev
    engine._dispatched = timed
    tps = {WATCHDOG_MS: [], 0.0: []}
    polls = {WATCHDOG_MS: 0, 0.0: 0}
    guard = engine._guard_ready

    def counted(ev):
        polls[engine.round_timeout_ms] += 1
        return guard(ev)
    engine._guard_ready = counted
    try:
        for i in range(6):
            engine.round_timeout_ms = (WATCHDOG_MS, 0.0)[i % 2]
            hs, secs = _serve_wave(engine, work)
            _same_streams("watchdog wave", hs, streams)
            tps[engine.round_timeout_ms].append(
                _wave_metrics(hs, secs)[0])
    finally:
        del engine._dispatched, engine._guard_ready
        engine.round_timeout_ms = 0.0
    if engine.stats["watchdog_trips"] != 1:
        raise AssertionError("watchdog: tripped without a fault")
    # the poll of a round that is done: one query of its event
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        ev.query()
    query_us = (time.perf_counter() - t0) * 1e3
    log("phase 4c watchdog: EngineStuck %.1f ms after serve_forever "
        "began under a 5 s hang (round_timeout_ms=%g), health stuck, then "
        "the same engine finished 8 requests equal to phase 4's; 3 waves "
        "armed and 3 not, in turns, no trip: %.1f and %.1f tokens/s "
        "(median); the poll's host cost a round: recording the round's "
        "event %.2f us (median of %d) and one query of a finished round's "
        "event %.2f us; %d drain polls; %s" % (
            trip * 1e3, WATCHDOG_MS, statistics.median(tps[WATCHDOG_MS]),
            statistics.median(tps[0.0]),
            statistics.median(spent) * 1e6, len(spent), query_us,
            polls[WATCHDOG_MS], card_line()))


def poison_and_close(engine, work, streams):
    """4c.5: two injected staging failures retire exactly two requests
    with ``"error"`` and leave the rest equal; ``serve_forever()`` over a
    seeded arrival generator; ``close()`` with 4 requests queued fails
    each with EngineClosed, and a second ``close()`` is a no-op."""
    from mxnet_tpu_torch.serving import EngineClosed
    from mxnet_tpu_torch.testing.faults import FaultInjector
    fi = FaultInjector()
    with fi.serving_h2d_failures(2):
        hs, _ = _serve_wave(engine, work)
    bad = [h for h in hs if h.retire_reason == "error"]
    if len(bad) != 2 or [k for k, _ in fi.log] != ["h2d_fail"] * 2:
        raise AssertionError("poison: %d errors, log %r" % (len(bad),
                                                           fi.log))
    for h, s in zip(hs, streams):
        if h.retire_reason != "error" and h.tokens != s:
            raise AssertionError("poison: request %s's stream differs"
                                 % h.id)
    rs = np.random.RandomState(48)

    def arrivals():
        for i, (p, b) in enumerate(work):
            for _ in range(int(rs.randint(0, 3))):
                yield None
            yield dict(prompt=p, max_tokens=b, request_id=("arrival", i))
    t0 = time.perf_counter()
    done = engine.serve_forever(arrivals())
    secs = time.perf_counter() - t0
    by_id = {h.id: h for h in done}
    if len(by_id) != len(work):
        raise AssertionError("serve_forever: %d of %d requests returned"
                             % (len(by_id), len(work)))
    _same_streams("serve_forever", [by_id[("arrival", i)]
                                    for i in range(len(work))], streams)
    queued = [engine.submit(p, max_tokens=b) for p, b in work[:4]]
    engine.close()
    for h in queued:
        try:
            h.result()
            raise AssertionError("close: request %s did not fail" % h.id)
        except EngineClosed:
            pass
        if h.retire_reason != "closed":
            raise AssertionError("close: request %s retired %r" % (
                h.id, h.retire_reason))
    engine.close()
    log("phase 4c poison and close: 2 injected staging failures retired "
        "requests %s with 'error', the other 22 equal phase 4's; "
        "serve_forever over a seeded arrival process (None gaps) returned "
        "all 24 in %.3f s, equal; close() with 4 queued failed each with "
        "EngineClosed, a second close() did nothing; %s" % (
            [h.id for h in bad], secs, card_line()))


def _crash_work(rs):
    """24 requests: 8 past a shared 192-token system prompt (prefix hits),
    4 of 600-900 tokens (chunked), 12 repeating a 16-token phrase
    (n-gram drafts), budgets 32/64."""
    system = rs.randint(0, VOCAB, (SYSTEM_PROMPT,))
    work = []
    for i in range(N_REQUESTS):
        if i % 3 == 0:
            p = np.concatenate([system, rs.randint(0, VOCAB,
                                                   (int(rs.randint(8, 57)),))])
        elif i % 6 == 1:
            p = rs.randint(0, VOCAB, (int(rs.randint(600, 901)),))
        else:
            p = np.tile(rs.randint(0, VOCAB, (16,)), int(rs.randint(3, 12)))
        work.append((p, int(rs.choice([32, 64]))))
    return work


def crash_and_restore(dev, prefix):
    """4c.4: phase 4b's prefix + chunk + n-gram engine, crashed 20 rounds
    into a 24-request wave (``serving_crash_mid_round``); ``snapshot()``,
    ``close()``, ``restore()`` onto a fresh engine over the same decoder.
    Every stream equals the uninterrupted wave's; the time to recover and
    memory_allocated before the engine, after close() and after
    restore()."""
    from mxnet_tpu_torch.serving import InferenceEngine
    from mxnet_tpu_torch.testing.faults import FaultInjector, InjectedCrash
    dec = _decoder_4c(prefix, dev, SPEC_MM)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    kw = dict(prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK, draft="ngram",
              spec_k=SPEC_K)
    engine = _engine_4c(dec, **kw)
    work = _crash_work(np.random.RandomState(49))
    ref, _ = _serve_wave(engine, work)
    built = torch.cuda.memory_allocated()
    fi = FaultInjector()
    hs, pending = [], list(work)

    def round_():
        for _ in range(8 if not hs else 4):
            if pending:
                p, b = pending.pop(0)
                hs.append(engine.submit(p, max_tokens=b))
        engine.step()
    for _ in range(20):
        round_()
    rounds = 20
    with fi.serving_crash_mid_round(1):
        try:
            while pending or not engine.idle:
                rounds += 1
                round_()
            raise AssertionError("crash: the wave ended before the crash")
        except InjectedCrash:
            pass
    snap = json.loads(json.dumps(engine.snapshot()))
    pending_ids = [r["id"] for r in snap["requests"]]
    engine.close()
    del engine
    gc.collect()
    torch.cuda.synchronize()
    closed = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine2, handles = InferenceEngine.restore(snap, dec)
    want = {rid: len(h.tokens) for rid, h in handles.items()}
    while any(len(handles[rid].tokens) == want[rid] and not
              handles[rid].done for rid in want):
        engine2.step()
    torch.cuda.synchronize()
    recover = time.perf_counter() - t0
    restored = torch.cuda.memory_allocated()
    for p, b in pending:              # what the crash left unsubmitted
        hs.append(engine2.submit(p, max_tokens=b))
    engine2.serve_forever()
    final = [handles.get(h.id, h) for h in hs]
    for h, r in zip(final, ref):
        if h.tokens != r.tokens or not h.done:
            raise AssertionError("crash: request %s's stream differs from "
                                 "the uninterrupted wave's" % h.id)
    if engine2._prefix.pinned or len(engine2._free) != SLOTS:
        raise AssertionError("crash: pins or slots leaked after restore")
    if closed - before > CLOSE_SLACK:
        raise AssertionError("crash: memory_allocated %.1f MiB after "
                             "close(), %.1f MiB before the engine" % (
                                 closed / 2**20, before / 2**20))
    log("phase 4c crash and restore: InjectedCrash in round %d of a "
        "24-request wave (prefix pool %d MiB, prefill_chunk %d, n-gram "
        "spec_k %d), %d requests in the snapshot; restore() to every "
        "resumed request's next token %.3f s (programs captured anew "
        "included); every stream equals the uninterrupted wave's; "
        "memory_allocated %.1f MiB before the engine (the decoder), %.1f "
        "MiB with it, %.1f MiB after close(), %.1f MiB after restore(); "
        "%s" % (
            rounds, POOL_MB, CHUNK, SPEC_K, len(pending_ids), recover,
            before / 2**20, built / 2**20, closed / 2**20,
            restored / 2**20, card_line()))
    engine2.close()


def robust_main_path(K, dev, prefix, work, streams):
    """Phase 4c: the robustness and observability layer on phase 4's 124M
    int8 configuration. Returns the launches it counted."""
    t0 = time.perf_counter()
    dec = _decoder_4c(prefix, dev)
    engine, launches = layer_cost(K, dec, work, streams)
    total = dict(launches)
    watchdog(engine, work, streams)
    poison_and_close(engine, work, streams)
    del engine
    free_programs()
    for e, n in hostile_wave(K, dec).items():
        total[e] = total.get(e, 0) + n
    del dec
    free_programs()
    crash_and_restore(dev, prefix)
    free_programs()
    log("phase 4c: every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t0,
        json.dumps({e: n for e, n in total.items() if n})))
    return total


# -- phase 4d: the serving fleet ---------------------------------------------

# a prompt of the long-prompt mix: 200-256 tokens (a 256-bucket prefill)
LONG_PROMPT = (200, 257)
# fleet rounds into phase 4's wave before a replica is killed or drained:
# on two replicas every request of the wave is in by round 5 and the
# last finish by ~round 14, so round 6 finds the most work in flight
FAIL_ROUND = 6
SCRAPE_S = 0.05
SCRAPES = ("/metrics", "/healthz", "/fleet")


def _fleet(engines, **kw):
    from mxnet_tpu_torch.serving import FleetRouter
    args = dict(heartbeat_ms=1e6)
    args.update(kw)
    return FleetRouter(engines, **args)


def _stats_delta(engines, before):
    return [{k: e.stats[k] - before[i][k] for k in e.stats}
            for i, e in enumerate(engines)]


def _fleet_launches(deltas):
    """Phase 4's launches for the engines' ``stats`` deltas, summed."""
    want = {}
    for d in deltas:
        for k, n in _main_launches(d).items():
            want[k] = want.get(k, 0) + n
    return want


def _warm_pairs(prefills, decodes):
    """Every prefill engine exports a package of every bucket to every
    decode engine, delivered by hand (``take_handoffs`` ->
    ``admit_handoff`` -> ``resolve``): each prefill, decode and row mover
    program is captured before a wave is counted or timed."""
    rs = np.random.RandomState(3)
    for p in prefills:
        for d in decodes:
            for b in BUCKETS:
                p.submit(rs.randint(0, VOCAB, (b,)), max_tokens=4)
                pkgs = []
                while not pkgs:
                    p.step()
                    pkgs = p.take_handoffs()
                d.admit_handoff(pkgs[0].payload())
                pkgs[0].resolve()
                d.serve_forever()
    torch.cuda.synchronize()


def _check_roles(prefills, decodes, what):
    """The per-role compile contract: a prefill engine built each bucket's
    prefill and row mover once and no decode or verify program; a decode
    engine its decode program and each bucket's row mover once, no
    prefill."""
    every = dict.fromkeys(BUCKETS, 1)
    for e in prefills:
        cc = e.compile_counts
        if cc != {"decode": 0, "verify": 0, "prefill": every, "copy": {},
                  "handoff": every}:
            raise AssertionError("%s: prefill engine compile_counts %r"
                                 % (what, cc))
    for e in decodes:
        cc = e.compile_counts
        if cc != {"decode": 1, "verify": 0, "prefill": {}, "copy": {},
                  "handoff": every}:
            raise AssertionError("%s: decode engine compile_counts %r"
                                 % (what, cc))


def capture_and_replay(dec, work, streams, outdir):
    """4d.1: phase 4's wave with capture on and off, in turns, 3 waves
    each; the capture replayed ``verify``-clean on a fresh engine and at
    another round geometry. Returns the capture."""
    from mxnet_tpu_torch.serving import load_capture
    from mxnet_tpu_torch.serving import replay as rp
    capdir = os.path.join(outdir, "capture")
    if os.path.isdir(capdir):
        for f in os.listdir(capdir):
            os.remove(os.path.join(capdir, f))
    on = _engine_4c(dec, capture_dir=capdir)
    off = _engine_4c(dec)
    for e in (on, off):
        _warm(e)
    # the host time of each record (serialization, write and flush)
    spent = []
    write = on.capture._write

    def timed(rec, always=False):
        t = time.perf_counter()
        try:
            return write(rec, always)
        finally:
            spent.append(time.perf_counter() - t)
    on.capture._write = timed
    tps = {"on": [], "off": []}
    for i in range(3):
        turn = (("on", on), ("off", off))
        for name, eng in (turn if i % 2 == 0 else turn[::-1]):
            hs, secs = _serve_wave(eng, work)
            _same_streams("phase 4d capture %s" % name, hs, streams)
            tps[name].append(_wave_metrics(hs, secs)[0])
    del on.capture._write
    path = on.capture.path
    on.close()
    off.close()
    size = os.path.getsize(path)
    cap = load_capture(path)
    nreq = len(cap["submits"])
    if nreq != 3 * N_REQUESTS + len(BUCKETS) \
            or len(cap["retires"]) != nreq:
        raise AssertionError("phase 4d capture: %d submits, %d retires"
                             % (nreq, len(cap["retires"])))
    reports = []
    other = dict(prefill_chunk=BUCKETS[1],
                 steps_per_round=STEPS_PER_ROUND // 2)
    for what, over in (("the captured geometry", {}),
                       ("prefill_chunk=%(prefill_chunk)d, "
                        "steps_per_round=%(steps_per_round)d" % other,
                        other)):
        eng = rp.build_engine(cap, dec, **over)
        t0 = time.perf_counter()
        rep = rp.replay(cap, eng, timing="max", verify=True)
        if rep["mismatches"] or rep["verified"] != nreq \
                or rep["verify_mode"] != "exact":
            raise AssertionError("phase 4d replay (%s): %r" % (what, rep))
        reports.append("%s %d verified, %.1f tokens/s, %.2f s" % (
            what, rep["verified"], rep["tokens_per_sec"],
            time.perf_counter() - t0))
        eng.close()
    log("phase 4d capture: tokens/s with capture on over off %.4f (median "
        "of 3 waves each in turns: %.1f against %.1f); streams equal phase "
        "4's; %d requests in %d bytes = %.1f bytes a request; a record's "
        "host time (serialize, write, flush) median %.1f us, max %.1f us, "
        "%.3f ms a wave; replay verify clean: %s; %s" % (
            statistics.median(tps["on"]) / statistics.median(tps["off"]),
            statistics.median(tps["on"]), statistics.median(tps["off"]),
            nreq, size, size / nreq, statistics.median(spent) * 1e6,
            max(spent) * 1e6, sum(spent) / 3 * 1e3, "; ".join(reports),
            card_line()))
    return cap


def _row_movers(p, d):
    """Export and import at each bucket: wall ms (median of 10, the copy
    out or in included) and card ms (CUDA events around the program's
    replay), wire bytes native and int8 and ``pack_rows``' host ms."""
    from mxnet_tpu_torch.serving import pack_rows
    out = []
    for b in BUCKETS:
        exp = p._handoff_program(b, False)
        imp = d._handoff_program(b, True)
        rows = p._export_rows(0, b)
        walls = {"export": [], "import": []}
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = p._export_rows(0, b)
            walls["export"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            d._import_rows(0, b, rows)
            torch.cuda.synchronize()
            walls["import"].append((time.perf_counter() - t0) * 1e3)
        card = {}
        for name, prog in (("export", exp), ("import", imp)):
            a, z = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            ts = []
            for _ in range(10):
                a.record()
                prog.run()
                z.record()
                z.synchronize()
                ts.append(a.elapsed_time(z))
            card[name] = statistics.median(ts)
        _, native = pack_rows(rows, "native")
        packs = []
        for _ in range(5):
            t0 = time.perf_counter()
            _, q8 = pack_rows(rows, "int8")
            packs.append((time.perf_counter() - t0) * 1e3)
        out.append("bucket %d: export wall %.3f ms card %.4f ms, import wall "
                   "%.3f ms card %.4f ms; wire %d bytes native, %d int8 "
                   "(%.3f), pack_rows int8 %.2f ms host" % (
                       b, statistics.median(walls["export"]),
                       card["export"], statistics.median(walls["import"]),
                       card["import"], native, q8, q8 / native,
                       statistics.median(packs)))
    return out


def _long_mix(rs):
    """20 short requests (32-127 tokens) beside 4 prompts of 200-256
    tokens, budgets 64."""
    work = []
    for i in range(N_REQUESTS):
        n = int(rs.randint(*LONG_PROMPT)) if i % 6 == 5 \
            else int(rs.randint(BUCKETS[0] // 2, BUCKETS[1]))
        work.append((rs.randint(0, VOCAB, (n,)), 8 * STEPS_PER_ROUND))
    return work


def _cadence(handles, work):
    """ms a token p50 and p99 of the short requests of ``work``."""
    ms = [(h.t_done - h.t_first) / (len(h.tokens) - 1) * 1e3
          for h, (p, _) in zip(handles, work) if len(p) < LONG_PROMPT[0]]
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def disaggregation(K, dec, work, streams):
    """4d.2: 1P1D and 2P2D fleets over phase 4's wave; row movers; the
    int8 handoff; decode-side cadence under a long-prompt mix. Returns
    the launches counted."""
    total = {}
    lines = []
    for np_, nd in ((1, 1), (2, 2)):
        pre = [_engine_4c(dec, role="prefill") for _ in range(np_)]
        dco = [_engine_4c(dec, role="decode") for _ in range(nd)]
        engines = pre + dco
        _warm_pairs(pre, dco)
        fleet = _fleet(engines)
        before = [dict(e.stats) for e in engines]
        K.reset_launch_counts()
        hs, secs = _serve_wave(fleet, work)
        launches = K.launch_counts()
        deltas = _stats_delta(engines, before)
        want = dict.fromkeys(launches, 0)
        want.update(_fleet_launches(deltas))
        if launches != want:
            raise AssertionError("phase 4d %dP%dD: launch counts %r, the "
                                 "engines' rounds want %r"
                                 % (np_, nd, launches, want))
        _same_streams("phase 4d %dP%dD" % (np_, nd), hs, streams)
        out = sum(d["handoffs_out"] for d in deltas)
        inn = sum(d["handoffs_in"] for d in deltas)
        if out != N_REQUESTS or inn != N_REQUESTS \
                or fleet.stats["handoffs"] != N_REQUESTS:
            raise AssertionError("phase 4d %dP%dD: %d handoffs out, %d in"
                                 % (np_, nd, out, inn))
        _check_roles(pre, dco, "phase 4d %dP%dD" % (np_, nd))
        for e, n in launches.items():
            total[e] = total.get(e, 0) + n
        tps, p50, p99 = _wave_metrics(hs, secs)
        lines.append("%dP%dD %.1f tokens/s, ms a token p50 %.3f p99 %.3f, "
                     "%d handoffs, %.1f MB shipped" % (
                         np_, nd, tps, p50, p99, fleet.stats["handoffs"],
                         fleet.stats["handoff_bytes"] / 1e6))
        if np_ == 1:
            movers = _row_movers(pre[0], dco[0])
        fleet.close()
        del fleet, engines, pre, dco
        free_programs()
    log("phase 4d disaggregation: every stream of the 1P1D and 2P2D waves "
        "equals phase 4's; 24 handoffs out and in each; prefill engines "
        "built prefill + handoff and no decode, decode engines decode + "
        "handoff and no prefill; exact launches from stats; %s; all "
        "engines share one card; %s" % ("; ".join(lines), card_line()))
    log("phase 4d row movers (one card: the rows go out to the host and "
        "back): %s" % "; ".join(movers))

    # the int8 handoff: JAX's contract is agreement on a prefix
    pre = _engine_4c(dec, role="prefill", handoff_dtype="int8")
    dco = _engine_4c(dec, role="decode")
    fleet = _fleet([pre, dco])
    hs, _ = _serve_wave(fleet, work)
    agree, full = [], 0
    for h, s in zip(hs, streams):
        if not h.done or len(h.tokens) != len(s) or h.tokens[0] != s[0]:
            raise AssertionError("phase 4d int8 handoff: request %s "
                                 "finished %r against %d tokens, first "
                                 "token %s" % (h.id, h.retire_reason,
                                               len(s), h.tokens[:1]))
        n = next((i for i, (a, b) in enumerate(zip(h.tokens, s)) if a != b),
                 len(s))
        agree.append(n / len(s))
        full += n == len(s)
    shipped = fleet.stats["handoff_bytes"]
    fleet.close()
    del fleet, pre, dco
    log("phase 4d int8 handoff: %d of %d streams equal phase 4's in full, "
        "the first token always (it is the prefill engine's); mean share "
        "of each stream agreeing before its first difference %.3f; %.1f MB "
        "shipped" % (full, N_REQUESTS, statistics.mean(agree),
                     shipped / 1e6))

    # decode cadence under long prompts: 1P1D against one unified engine
    mix = _long_mix(np.random.RandomState(61))
    uni = _engine_4c(dec)
    _warm(uni)
    pre = _engine_4c(dec, role="prefill")
    dco = _engine_4c(dec, role="decode")
    _warm_pairs([pre], [dco])
    fleet = _fleet([pre, dco])
    runs = {"unified": [], "1P1D": []}
    for i in range(2):
        for name, eng in ((("unified", uni), ("1P1D", fleet)) if i == 0
                          else (("1P1D", fleet), ("unified", uni))):
            hs, secs = _serve_wave(eng, mix)
            runs[name].append((_cadence(hs, mix), _wave_metrics(hs, secs)[0],
                               [h.tokens for h in hs]))
    if runs["unified"][0][2] != runs["1P1D"][0][2]:
        raise AssertionError("phase 4d long-prompt mix: 1P1D streams "
                             "differ from the unified engine's")
    log("phase 4d long-prompt mix (20 short beside 4 of 200-256 tokens; "
        "both roles share ONE card): short requests' ms a token p50/p99 "
        "%s; tokens/s %s; streams equal" % (
            "; ".join("%s %.3f/%.3f" % (k, v[0][0][0], v[0][0][1])
                      + " (again %.3f/%.3f)" % v[1][0] for k, v in
                      runs.items()),
            ", ".join("%s %.1f %.1f" % (k, v[0][1], v[1][1])
                      for k, v in runs.items())))
    fleet.close()
    uni.close()
    return total


def _kill_wave(fleet, work, victim_at, act):
    """Phase 4's staggered wave through ``fleet``; ``act(fleet)`` runs
    before fleet round ``victim_at`` and returns ``(handles it moved,
    t0)``. Returns (handles, seconds to every moved request's next
    token)."""
    work = list(work)
    handles = []
    rounds = 0
    moved, t0, recover = None, None, None
    while work or not fleet.idle:
        for _ in range(8 if not handles else 4):
            if work:
                p, b = work.pop(0)
                handles.append(fleet.submit(p, max_tokens=b))
        if rounds == victim_at:
            moved, t0 = act(fleet, handles)
            if not moved:
                raise AssertionError("phase 4d: the victim had no work")
        fleet.step()
        rounds += 1
        if moved is not None and recover is None \
                and all(h.done or len(h.tokens) > n for h, n in moved):
            torch.cuda.synchronize()
            recover = time.perf_counter() - t0
    return handles, recover, moved


def failover_and_drain(dec, cap, work, streams):
    """4d.3: two unified replicas: a kill and a drain + successor mid-wave,
    the capture through a 2-replica rolling restart, memory after
    close()."""
    from mxnet_tpu_torch.serving import replay as rp
    from mxnet_tpu_torch.testing.faults import FaultInjector
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    a, b = _engine_4c(dec), _engine_4c(dec)
    for e in (a, b):
        _warm(e)
    fleet = _fleet([a, b])
    fi = FaultInjector()

    def kill(fl, hs):
        victim = max((a, b), key=lambda e: len(e._active)).engine_id
        moved = [(h, len(h.tokens)) for h in hs
                 if h.replica_id == victim and not h.done]
        t0 = time.perf_counter()
        with fi.fleet_kill_replica(victim):
            fl.step()
        if fl.stats["failovers"] != 1:
            raise AssertionError("phase 4d kill: no failover")
        return moved, t0
    hs, recover, moved = _kill_wave(fleet, work, FAIL_ROUND, kill)
    _same_streams("phase 4d kill", hs, streams)
    kill_line = ("kill in round %d: %d requests migrated, every stream "
                 "equals phase 4's; kill to every migrated request's next "
                 "token %.3f s" % (FAIL_ROUND, len(moved), recover))
    fleet.close()
    del fleet, a, b
    free_programs()

    a, b = _engine_4c(dec), _engine_4c(dec)
    for e in (a, b):
        _warm(e)
    succ = _engine_4c(dec)
    _warm(succ)
    fleet = _fleet([a, b])

    def drain(fl, hs):
        victim = max((a, b), key=lambda e: len(e._active)).engine_id
        moved = [(h, len(h.tokens)) for h in hs
                 if h.replica_id == victim and not h.done]
        t0 = time.perf_counter()
        fl.drain(victim)
        fl.add_replica(succ)
        return moved, t0
    hs, recover_d, moved_d = _kill_wave(fleet, work, FAIL_ROUND, drain)
    _same_streams("phase 4d drain", hs, streams)
    failed = [h for h in hs if h.retire_reason not in ("length", "eos")]
    if failed or fleet.stats["drains"] != 1:
        raise AssertionError("phase 4d drain: %d failed, stats %r" % (
            len(failed), dict(fleet.stats)))
    fleet.close()
    del fleet, a, b, succ
    free_programs()

    # the capture of 4d.1 through a 2-replica rolling restart
    def mkreplica():
        return rp.build_engine(cap, dec)
    fleet = _fleet([mkreplica(), mkreplica()])
    on_round = rp.rolling_restart(fleet, cap, mkreplica)
    rep = rp.replay(cap, fleet, timing="max", verify=True,
                    on_round=on_round)
    nfail = len(rep["mismatches"])
    if nfail or rep["verified"] != len(cap["submits"]) \
            or fleet.stats["drains"] != 2:
        raise AssertionError("phase 4d rolling restart: %r, %r"
                             % (rep, dict(fleet.stats)))
    migrated = fleet.stats["migrated_requests"]
    fleet.close()
    del fleet
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if after - before > CLOSE_SLACK:
        raise AssertionError("phase 4d: memory_allocated %.1f MiB after the "
                             "fleets closed, %.1f MiB before" % (
                                 after / 2**20, before / 2**20))
    log("phase 4d failover and drain (2 unified replicas on ONE card): %s; "
        "drain + add_replica in round %d: %d requests migrated, 0 failed, "
        "every stream equals phase 4's, drain to every migrated request's "
        "next token %.3f s; the capture (%d requests) through a 2-replica "
        "rolling restart: verify clean, 0 failed, 2 drains, %d migrated; "
        "memory_allocated %.1f MiB before the fleets, %.1f MiB after "
        "close(); %s" % (
            kill_line, FAIL_ROUND, len(moved_d), recover_d,
            len(cap["submits"]), migrated, before / 2**20, after / 2**20,
            card_line()))


def _prometheus_ok(text):
    """Every sample line of a Prometheus text exposition is ``name`` or
    ``name{labels}``, then a float."""
    import re
    pat = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                     r'(-?[0-9.eE+-]+|NaN|[+-]Inf)$')
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not pat.match(line):
            raise AssertionError("phase 4d /metrics: not Prometheus text: "
                                 "%r" % line)
        n += 1
    return n


def http_exposition(dec, work, streams):
    """4d.4: the exposition server during 1P1D waves: a scraper thread
    reads /metrics, /healthz, /fleet and /fleet/flight/<id> every 50 ms;
    tokens/s with the scraper against without, in turns."""
    import threading
    import urllib.request
    from mxnet_tpu_torch import telemetry
    pre = _engine_4c(dec, role="prefill")
    dco = _engine_4c(dec, role="decode")
    _warm_pairs([pre], [dco])
    fleet = _fleet([pre, dco])
    srv = telemetry.serve(port=0)
    stop = threading.Event()
    times, errors, journeys, samples = [], [], [], []

    def scrape_once():
        try:
            for path in SCRAPES:
                t0 = time.perf_counter()
                with urllib.request.urlopen(srv.url + path,
                                            timeout=10) as r:
                    body = r.read()
                times.append((time.perf_counter() - t0) * 1e3)
                if path == "/metrics":
                    samples.append(_prometheus_ok(body.decode()))
            retired = json.loads(body)["fleets"][0]["flight"]["retired"]
            if retired:
                t0 = time.perf_counter()
                with urllib.request.urlopen(
                        srv.url + "/fleet/flight/%s" % retired[-1],
                        timeout=10) as r:
                    journeys.append(json.loads(r.read()))
                times.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:     # noqa: BLE001 — reported below
            errors.append(repr(e))

    def scrape():
        # every 50 ms while the wave runs, and once after it ends (its
        # journeys have retired by then)
        while not stop.wait(SCRAPE_S):
            scrape_once()
        scrape_once()
    tps = {"scraped": [], "quiet": []}
    try:
        for i in range(4):
            name = ("scraped", "quiet")[i % 2]
            th = None
            if name == "scraped":
                stop.clear()
                th = threading.Thread(target=scrape, daemon=True)
                th.start()
            hs, secs = _serve_wave(fleet, work)
            if th is not None:
                stop.set()
                th.join()
            _same_streams("phase 4d http (%s)" % name, hs, streams)
            tps[name].append(_wave_metrics(hs, secs)[0])
    finally:
        stop.set()
        telemetry.stop_server()
    if errors or not journeys or not samples:
        raise AssertionError("phase 4d http: errors %r, %d journeys, %d "
                             "metrics scrapes" % (errors[:3], len(journeys),
                                                  len(samples)))
    hops = journeys[-1]["hops"]
    if hops != [pre.engine_id, dco.engine_id]:
        raise AssertionError("phase 4d http: /fleet/flight hops %r, want "
                             "the prefill then the decode engine" % hops)
    fleet.close()
    log("phase 4d http: %d scrapes of %s and /fleet/flight/<id>, %.3f ms a "
        "scrape (median; p99 %.3f); /metrics parses as Prometheus text "
        "(%d samples); /fleet/flight stitches the prefill and decode hops; "
        "tokens/s with the scraper over without %.4f (%.1f against %.1f, "
        "2 waves each in turns)" % (
            len(times), ", ".join(SCRAPES), statistics.median(times),
            float(np.percentile(times, 99)), samples[-1],
            statistics.median(tps["scraped"])
            / statistics.median(tps["quiet"]),
            statistics.median(tps["scraped"]),
            statistics.median(tps["quiet"])))


def fleet_main_path(K, dev, prefix, work, streams):
    """Phase 4d: the serving fleet on phase 4's 124M int8 configuration,
    every replica an engine on the one card over one decoder. Returns the
    launches it counted."""
    t0 = time.perf_counter()
    outdir = os.path.join(HERE, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    dec = _decoder_4c(prefix, dev)
    cap = capture_and_replay(dec, work, streams, outdir)
    free_programs()
    launches = disaggregation(K, dec, work, streams)
    free_programs()
    failover_and_drain(dec, cap, work, streams)
    free_programs()
    http_exposition(dec, work, streams)
    del dec
    free_programs()
    log("phase 4d: every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t0,
        json.dumps({e: n for e, n in launches.items() if n})))
    return launches


# -- phase 4e: tensor-parallel serving ---------------------------------------

TP = 2
TP_WAVES = 3                        # phase 4's wave at each degree, in turns
TP_INT8_WAVES = 2                   # the same with the int8 KV cache
# both degrees' products: unfused (the fused step is not eligible under tp,
# and it rounds a bf16 step differently from the unfused chain)
TP_MM = "pallas"
TP_NOTE = "two ranks on ONE card, not a multi-card figure"


def check_head_split(K, dev, gen):
    """What byte-identity across degrees rests on, bitwise, at the 124M
    serving shapes (12 heads of 64, L = 1024): the paged read of a tp rank
    (its 6 query heads over its 6 kv heads, each contiguous) equals the
    same heads of the 12-head read, through the decode entry (S = 32, C = 1
    and 5, bf16 and int8 caches) and the chunk entry (S = 1, C = 64 and
    256, bf16 and int8), random pos."""
    l_, h, d = 1024, HEADS, EMBED // HEADS
    hl = h // TP
    n = 0
    for s_, c_, kind in ((32, 1, "bf16"), (32, 5, "bf16"), (32, 1, "int8"),
                         (1, 64, "bf16"), (1, 256, "bf16"),
                         (1, 256, "int8")):
        k, v, ks, vs = _cache(gen, s_, l_, h, d, kind, dev)
        q = _rand(gen, (s_, c_, h, d), torch.bfloat16).to(dev)
        pos = torch.randint(0, l_ - c_, (s_,), generator=gen,
                            dtype=torch.int32).to(dev)

        def read(lo, hi):
            sc = {} if ks is None else dict(
                k_scale=ks[:, :, lo:hi].contiguous(),
                v_scale=vs[:, :, lo:hi].contiguous())
            return K.paged_attention(
                q[:, :, lo:hi].contiguous(), k[:, :, lo:hi].contiguous(),
                v[:, :, lo:hi].contiguous(), pos, **sc)
        whole = read(0, h)
        for r in range(TP):
            part = read(r * hl, (r + 1) * hl)
            if not torch.equal(part, whole[:, :, r * hl:(r + 1) * hl]):
                raise AssertionError(
                    "paged_attention (%s, S=%d, C=%d, %s cache): rank %d's "
                    "heads differ from the same heads of the 12-head read "
                    "(max |diff| %.3g)" % (
                        K.paged_entry(q.dtype, k.dtype, c_, d), s_, c_, kind,
                        r, (part.float() - whole[:, :, r * hl:(r + 1) * hl]
                            .float()).abs().max()))
            n += 1
    log("phase 4e head split: %d rank reads (decode entry C=1/5, chunk entry "
        "C=64/256, bf16 and int8 caches) bitwise equal to the same heads of "
        "the 12-head read" % n)


def _tp_launches(d, tp, spec=False):
    """Launches for an engine's stats deltas ``d`` at degree ``tp`` with
    unfused products: tp=1's (per decode step 12 decode reads and 4*12+1
    products; per prefill piece 12 chunk reads and 4*12+1 products; under
    speculation ``_spec_launches``) with ``tp`` times the paged reads (one
    a rank) and the products once (they run replicated, once)."""
    if spec:
        want = _spec_launches(d)
    else:
        steps = d["steps"] * STEPS_PER_ROUND
        want = {"paged_attention_decode": LAYERS * steps,
                "paged_attention_chunk": LAYERS * d["prefill_chunks"],
                "quant_matmul": (4 * LAYERS + 1)
                * (steps + d["prefill_chunks"])}
    for e in ("paged_attention_decode", "paged_attention_chunk"):
        want[e] *= tp
    return want


def _delta(engine, before):
    return {k: engine.stats[k] - before[k] for k in engine.stats}


def _kv_gauge():
    from mxnet_tpu_torch import telemetry
    return telemetry.snapshot()["serving"]["kv_bytes_per_shard"]


def _check_tp_shards(engine, dev):
    """Each rank's slot cache: every buffer ``[32, 1024, 6, ...]`` on the
    card, contiguous and an allocation of its own rank."""
    if len(engine._caches) != TP:
        raise AssertionError("phase 4e: %d cache shards, want %d"
                             % (len(engine._caches), TP))
    owners = []
    for tree in engine._caches:
        ptrs = set()
        for entry in tree:
            for b in entry:
                if tuple(b.shape[:3]) != (SLOTS, MAX_LEN, HEADS // TP) \
                        or not b.is_contiguous() or b.device != dev:
                    raise AssertionError(
                        "phase 4e: a shard buffer %s %s (contiguous %s), "
                        "want [%d, %d, %d, ...] on %s" % (
                            tuple(b.shape), b.device, b.is_contiguous(),
                            SLOTS, MAX_LEN, HEADS // TP, dev))
                ptrs.add(b.untyped_storage().data_ptr())
        owners.append(ptrs)
    if owners[0] & owners[1]:
        raise AssertionError("phase 4e: two ranks share an allocation")


def tp_pair(dec, mesh, dev, what, **kw):
    """The tp=1 engine and the tp=2 one over ``dec`` (phase 4's
    configuration, ``kw`` on top): the shards checked, the per-shard
    gauge half of tp=1's."""
    one = _engine_4c(dec, **kw)
    g1 = _kv_gauge()
    two = _engine_4c(dec, mesh=mesh, **kw)
    g2 = _kv_gauge()
    _check_tp_shards(two, dev)
    if 2 * g2 != g1 or two.tp != TP:
        raise AssertionError("phase 4e %s: kv_bytes_per_shard %d at tp=2, "
                             "%d at tp=1" % (what, g2, g1))
    return one, two, g1, g2


def _tp_equal(what, handles, streams):
    for h, s in zip(handles, streams):
        if not h.done or h.tokens != s:
            raise AssertionError("phase 4e %s: request %s's stream differs "
                                 "from the tp=1 engine's" % (what, h.id))


def _waves_in_turns(K, what, one, two, work, waves):
    """``waves`` of ``work`` on the tp=1 engine ``one`` and the tp=2
    engine ``two`` in turns (each warmed first), counters zeroed just
    before and read just after: exact launches from both engines'
    ``stats``, every stream of either equal to tp=1's first wave. Returns
    ``({tp: [(handles, seconds)]}, launches, tp=2's share)``."""
    for e in (one, two):
        _warm(e)
    s0 = {id(e): dict(e.stats) for e in (one, two)}
    K.reset_launch_counts()
    runs = {1: [], TP: []}
    for i in range(waves):
        turn = ((1, one), (TP, two))
        for tp, eng in (turn if i % 2 == 0 else turn[::-1]):
            runs[tp].append(_serve_wave(eng, work))
    launches = K.launch_counts()
    want = dict.fromkeys(launches, 0)
    share = {}
    for tp, e in ((1, one), (TP, two)):
        for k, n in _tp_launches(_delta(e, s0[id(e)]), tp).items():
            want[k] += n
            if tp == TP:
                share[k] = n
    if launches != want:
        raise AssertionError("phase 4e %s: launch counts %r, the waves "
                             "want %r" % (what, launches, want))
    streams = [h.tokens for h in runs[1][0][0]]
    for tp in runs:
        for handles, _ in runs[tp]:
            for h in handles:
                if not h.done or len(h.tokens) != h.limit:
                    raise AssertionError("phase 4e %s: request %s did not "
                                         "finish its budget" % (what, h.id))
            _tp_equal("%s (tp=%d)" % (what, tp), handles, streams)
    return runs, launches, share


def _tps(runs):
    """{tp: median tokens/s over its waves}."""
    return {tp: statistics.median(_wave_metrics(h, t)[0] for h, t in r)
            for tp, r in runs.items()}


def tp_wave(K, dec, mesh, dev, work, timer):
    """4e.1: phase 4's wave at tp=2 and tp=1, TP_WAVES waves each in
    turns: streams equal (and two equal ``Decoder.generate``), exact
    launches, shards, gauge, compile counts; the decode round's wall and
    card time at each degree. Returns the launches, the tp=2 engine's
    share of them, and the tp=1 streams."""
    one, two, g1, g2 = tp_pair(dec, mesh, dev, "wave")
    runs, launches, share = _waves_in_turns(K, "wave", one, two, work,
                                            TP_WAVES)
    streams = [h.tokens for h in runs[1][0][0]]
    first = runs[TP][0][0]
    _equal_generate("phase 4e wave", dec, (first[0], max(
        first[1:], key=lambda h: len(h.prompt))))
    check_compile_counts(one, "phase 4e tp=1")
    check_compile_counts(two, "phase 4e tp=2")
    tps = {tp: [_wave_metrics(h, t) for h, t in runs[tp]] for tp in runs}
    for tp in runs:
        cols = list(zip(*tps[tp]))
        log("phase 4e wave at tp=%d (%s): %d waves in turns, median "
            "(min-max) %.1f tokens/s (%.1f-%.1f), ms per token p50 %.3f, "
            "p99 %.3f; %s" % (
                tp, TP_NOTE if tp > 1 else "one rank",
                len(cols[0]), statistics.median(cols[0]), min(cols[0]),
                max(cols[0]), statistics.median(cols[1]),
                statistics.median(cols[2]), card_line()))
    med = _tps(runs)
    ratio = med[TP] / med[1]
    log("phase 4e wave: tokens/s at tp=2 over tp=1 %.4f (%s); every stream "
        "equal at both degrees and to phase 4e's first wave; two equal "
        "Decoder.generate; compile_counts equal; each rank's shard "
        "[%d, %d, %d, %d] contiguous; kv_bytes_per_shard %d at tp=2 against "
        "%d at tp=1; launches %s (tp=2's share %s)" % (
            ratio, TP_NOTE, SLOTS, MAX_LEN, HEADS // TP, EMBED // HEADS, g2,
            g1, json.dumps({e: n for e, n in launches.items() if n}),
            json.dumps(share)))
    rs = np.random.RandomState(7)
    for tp, eng in ((1, one), (TP, two)):
        profile_decode(eng, rs, trace=None,
                       what="phase 4e tp=%d, unfused products (%s)" % (
                           tp, TP_NOTE if tp > 1 else "one rank"))
    rounds = {tp: timer(e._program("decode").run) / STEPS_PER_ROUND
              for tp, e in ((1, one), (TP, two))}
    walls = {tp: _card_ms(e._program("decode").run)
             for tp, e in ((1, one), (TP, two))}
    log("phase 4e decode round on the idle engine (%d steps): tp=1 wall %.3f "
        "ms, card %.3f ms, events %.4f ms a step; tp=2 wall %.3f ms, card "
        "%.3f ms, events %.4f ms a step (%s); %s" % (
            STEPS_PER_ROUND, walls[1][0], walls[1][1], rounds[1],
            walls[TP][0], walls[TP][1], rounds[TP], TP_NOTE, card_line()))
    one.close()
    two.close()
    return launches, share, streams


def tp_int8_kv(K, prefix, mesh, dev, work):
    """4e.2: the int8 KV cache at tp=2 against tp=1, TP_INT8_WAVES waves
    each in turns: streams equal, exact launches (the decode entry and the
    int8 chunk entry, a rank each)."""
    from mxnet_tpu_torch.parallel import Decoder
    dec8 = Decoder.from_checkpoint(prefix, 0, MAX_LEN, attn_impl="paged",
                                   weight_dtype="int8", matmul_impl=TP_MM,
                                   compute_dtype="bfloat16",
                                   cache_dtype="int8", device=dev)
    one, two, g1, g2 = tp_pair(dec8, mesh, dev, "int8 KV")
    runs, total, _ = _waves_in_turns(K, "int8 KV", one, two, work,
                                     TP_INT8_WAVES)
    med = _tps(runs)
    log("phase 4e int8 KV: %d waves at each degree in turns, every stream "
        "equal; median tokens/s %.1f at tp=2, %.1f at tp=1, ratio %.4f "
        "(%s); kv_bytes_per_shard %d against %d; launches %s" % (
            TP_INT8_WAVES, med[TP], med[1], med[TP] / med[1], TP_NOTE, g2,
            g1, json.dumps({e: n for e, n in total.items() if n})))
    one.close()
    two.close()
    return total


def _gauntlet_work(seed):
    """24 requests: 10 sharing a 192-token system prompt (prefix hits), 4
    of 600-1000 tokens (chunked), 10 repeating a 16-token phrase (n-gram
    drafts accepted); budgets 32/64."""
    rs = np.random.RandomState(seed)
    system = rs.randint(0, VOCAB, (SYSTEM_PROMPT,))
    work = [(np.concatenate([system, rs.randint(0, VOCAB, (int(n),))]),
             int(rs.choice([32, 64]))) for n in rs.randint(8, 57, 10)]
    work += [(rs.randint(0, VOCAB, (int(n),)), 32)
             for n in rs.randint(600, 1001, 4)]
    work += [(np.tile(rs.randint(0, VOCAB, (16,)), int(rs.randint(3, 16))),
              int(rs.choice([32, 64]))) for _ in range(10)]
    order = rs.permutation(len(work))
    return [work[i] for i in order]


def tp_gauntlet(K, dec, mesh, dev):
    """4e.3: the reuse gauntlet (a 160 MiB prefix pool, ``prefill_chunk=
    256``, n-gram ``spec_k=4``) at tp=2 and tp=1: the same wave twice on
    each (the first builds every program), the second counted: streams
    and reuse stats equal, exact launches, compile counts equal."""
    work = _gauntlet_work(44)
    kw = dict(prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK, draft="ngram",
              spec_k=SPEC_K)
    one, two, _, _ = tp_pair(dec, mesh, dev, "gauntlet", **kw)
    if one._prefix.capacity != two._prefix.capacity:
        raise AssertionError("phase 4e gauntlet: pool of %d slots at tp=2, "
                             "%d at tp=1" % (two._prefix.capacity,
                                             one._prefix.capacity))
    total, out, deltas = {}, {}, {}
    for tp, e in ((1, one), (TP, two)):
        _serve_wave(e, work)
        _build(e, ("decode", "verify"))
        s0 = dict(e.stats)
        K.reset_launch_counts()
        handles, secs = _serve_wave(e, work)
        deltas[tp] = d = _delta(e, s0)
        got = _check_launches(K, "phase 4e gauntlet tp=%d" % tp,
                              _tp_launches(d, tp, spec=True))
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        out[tp] = (handles, secs)
    _tp_equal("gauntlet", out[TP][0], [h.tokens for h in out[1][0]])
    keys = ("prefix_hits", "prefix_hit_tokens", "prefill_chunks",
            "spec_rounds", "spec_accepted", "tokens")
    if any(deltas[1][k] != deltas[TP][k] for k in keys) \
            or deltas[TP]["prefix_hits"] < 5 \
            or deltas[TP]["spec_accepted"] < 1 \
            or deltas[TP]["prefill_chunks"] <= len(work):
        raise AssertionError("phase 4e gauntlet: stats %r at tp=2, %r at "
                             "tp=1" % ({k: deltas[TP][k] for k in keys},
                                       {k: deltas[1][k] for k in keys}))
    if one.compile_counts != two.compile_counts:
        raise AssertionError("phase 4e gauntlet: compile_counts %r at tp=2, "
                             "%r at tp=1" % (two.compile_counts,
                                             one.compile_counts))
    log("phase 4e gauntlet (prefix pool %d slots, prefill_chunk=%d, n-gram "
        "spec_k=%d): %d streams equal at tp=2 and tp=1; %s equal; "
        "compile_counts equal %s; tokens/s %.1f at tp=2, %.1f at tp=1 (%s); "
        "launches %s" % (
            two._prefix.capacity, CHUNK, SPEC_K, len(work),
            json.dumps({k: deltas[TP][k] for k in keys}),
            json.dumps({k: (v if not isinstance(v, dict) else
                            {str(b): n for b, n in v.items()})
                        for k, v in two.compile_counts.items()}),
            _wave_metrics(*out[TP])[0], _wave_metrics(*out[1])[0], TP_NOTE,
            json.dumps({e: n for e, n in total.items() if n})))
    one.close()
    two.close()
    return total


def tp_restore_and_handoff(dec, mesh, work, streams):
    """4e.4: a tp=2 snapshot taken 6 rounds into phase 4's wave restored
    at tp=1, and a tp=1 one at tp=2 (``mesh=`` in the overrides): both the
    donor and the restored engine finish every stream equal to the tp=1
    engine's. 4e.5: the wave through a tp=2 prefill specialist and a tp=1
    decode specialist, and the other way round: 24 handoffs, streams
    equal."""
    from mxnet_tpu_torch.serving import InferenceEngine
    for src, over in (({"mesh": mesh}, {"tp": 1}), ({}, {"mesh": mesh})):
        eng = _engine_4c(dec, **src)
        hs = [eng.submit(p, max_tokens=b) for p, b in work]
        for _ in range(6):
            eng.step()
        snap = eng.snapshot()
        resumed = sum(1 for r in snap["requests"] if r["tokens"])
        new, handles = InferenceEngine.restore(snap, dec, **over)
        new.serve_forever()
        eng.serve_forever()
        _tp_equal("snapshot at tp=%d (donor)" % eng.tp, hs, streams)
        _tp_equal("restore at tp=%d" % new.tp,
                  [handles.get(h.id, h) for h in hs], streams)
        log("phase 4e snapshot at tp=%d, 6 rounds in (%d requests with "
            "tokens), restored at tp=%d: every stream of the donor and the "
            "restored engine equals the tp=1 engine's" % (
                eng.tp, resumed, new.tp))
        eng.close()
        new.close()
        free_programs()
    for p_kw, d_kw in (({"mesh": mesh}, {}), ({}, {"mesh": mesh})):
        pre = _engine_4c(dec, role="prefill", **p_kw)
        dco = _engine_4c(dec, role="decode", **d_kw)
        for p, b in work:
            pre.submit(p, max_tokens=b)
        pkgs = []
        while len(pkgs) < len(work):
            pre.step()
            pkgs += pre.take_handoffs()
        t0 = time.perf_counter()
        reqs = {}
        for pkg in pkgs:
            reqs[pkg.id] = dco.admit_handoff(pkg.payload())
            pkg.resolve()
        admit = time.perf_counter() - t0
        dco.serve_forever()
        _tp_equal("handoff tp=%d -> tp=%d" % (pre.tp, dco.tp),
                  [reqs[i] for i in range(len(work))], streams)
        log("phase 4e handoff from a tp=%d prefill engine to a tp=%d decode "
            "engine: %d packages, every stream equals the tp=1 engine's; "
            "%.1f ms to admit them all (%s)" % (
                pre.tp, dco.tp, len(pkgs), admit * 1e3, TP_NOTE))
        pre.close()
        dco.close()
        free_programs()


def tp_main_path(K, dev, prefix, work):
    """Phase 4e: tensor-parallel serving of phase 4's 124M LM at tp=2 on a
    2-rank mesh over the one card (``[cuda:0] * 2``), against tp=1 from
    the same weights, both with unfused products (``TP_MM``). Returns the
    launches it counted."""
    from mxnet_tpu_torch.parallel import model_parallel_mesh
    t0 = time.perf_counter()
    check_head_split(K, dev, torch.Generator().manual_seed(4))
    mesh = model_parallel_mesh(TP, devices=[dev] * TP)
    dec = _decoder_4c(prefix, dev, mm=TP_MM)
    timer = Timer(dev)
    total = {}

    def add(launches):
        for e, n in launches.items():
            total[e] = total.get(e, 0) + n
        free_programs()
    launches, share, streams = tp_wave(K, dec, mesh, dev, work, timer)
    add(launches)
    add(tp_int8_kv(K, prefix, mesh, dev, work))
    add(tp_gauntlet(K, dec, mesh, dev))
    tp_restore_and_handoff(dec, mesh, work, streams)
    del dec
    free_programs()
    log("phase 4e: every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t0,
        json.dumps({e: n for e, n in total.items() if n})))
    return total


# -- phase 4f: the dense, blocked and windowed reads -------------------------

WINDOW = 256                        # the windowed cell's ring rows
DW_WAVES = 2                        # paged and dense waves, in turns
# the windowed wave: 4 prompt lengths x 9 requests (36 > 32 slots: slots
# are reused), prompts past the window and a budget that carries the short
# ones past it during decode; pieces of CHUNK tokens
WIN_GROUPS = ((40, 224), (300, 64), (600, 48), (900, 32))
WIN_PER_GROUP = 9
BEAM_B, BEAM_P, BEAM_STEPS, BEAM_K = 2, 64, 32, 4


def _decoder_4f(prefix, dev, symbol=None, **kw):
    """The 124M checkpoint (int8 weights, unfused products, bf16) as a
    decoder of ``kw``'s read; ``symbol`` rebuilds it over another graph of
    the same parameters (the windowed LM)."""
    from mxnet_tpu_torch.model import load_checkpoint
    from mxnet_tpu_torch.parallel import Decoder
    args = dict(weight_dtype="int8", matmul_impl=TP_MM,
                compute_dtype="bfloat16", device=dev)
    args.update(kw)
    if symbol is None:
        return Decoder.from_checkpoint(prefix, 0, MAX_LEN, **args)
    _, arg_params, aux_params = load_checkpoint(prefix, 0)
    return Decoder(symbol, arg_params, MAX_LEN, aux_params=aux_params,
                   **args)


def _unfused_launches(d, spec=False):
    """The launches of a dense or windowed engine's stats deltas ``d``:
    the products only (4*12+1 a walk: a decode step, a verify round, a
    prefill piece), no paged read and no fused step."""
    walks = d["steps"] * STEPS_PER_ROUND
    if spec:
        walks = d["spec_rounds"] + d["spec_fallback_rounds"] \
            * STEPS_PER_ROUND
    return {"quant_matmul": (4 * LAYERS + 1) * (walks + d["prefill_chunks"])}


def _equal_generate_grouped(what, dec, handles):
    """Every stream of ``handles`` equal to ``Decoder.generate``, one batch
    a prompt length, decoded to the group's longest budget (a greedy
    stream's first n tokens are its n-token generation): the dense,
    blocked and ring reads and ``quant_matmul`` give a row the same bits
    whatever the batch (phase 4f.1 gates the reads' batch invariance).
    Returns the seconds of offline decoding."""
    groups = collections.defaultdict(list)
    for h in handles:
        if not h.done or len(h.tokens) != h.limit:
            raise AssertionError("%s: request %s did not finish its budget"
                                 % (what, h.id))
        groups[len(h.prompt)].append(h)
    t0 = time.perf_counter()
    for p, hs in groups.items():
        n = max(len(h.tokens) for h in hs)
        ref = dec.generate(np.stack([np.asarray(h.prompt) for h in hs]),
                           n)[:, p:].cpu().tolist()
        for h, r in zip(hs, ref):
            if r[:len(h.tokens)] != h.tokens:
                raise AssertionError("%s: request %s's stream differs from "
                                     "Decoder.generate" % (what, h.id))
    return time.perf_counter() - t0


def _live_blocked(dec, q, entry, pos):
    """The JAX package's blocked read: each row runs its own
    ``ceil((pos + 1) / cache_block)`` live blocks (a row past them keeps
    its carry, as the vmapped loop of the JAX package keeps it)."""
    b, c, h, d = q.shape
    bl = dec._cache_block
    qf = q.to(torch.float32)
    m = torch.full((b, h, c), -math.inf, device=q.device)
    s = torch.zeros((b, h, c), device=q.device)
    acc = torch.zeros((b, h, c, d), device=q.device)
    live = (pos.long() + bl) // bl
    for i in range(int(live.max())):
        kb, vb = dec._cache_block_rows(entry, i * bl)
        m2, s2, a2 = dec._block_update(qf, kb, vb, i * bl, pos, (m, s, acc))
        on = (i < live)[:, None, None]
        m, s, acc = (torch.where(on, m2, m), torch.where(on, s2, s),
                     torch.where(on[..., None], a2, acc))
    return (acc / s[..., None]).to(q.dtype).transpose(1, 2)


def check_dense_reads(dec, dec8, decw, dev):
    """4f.1, before any engine runs: (a) the blocked read over all 8
    blocks bitwise equal to the loop over each row's live blocks (C=1, 32
    slots at random positions, bf16 and int8 caches, junk past each
    position); (b) the dense read's rows: the port reads all max_len rows
    in every call (no static clamp to pos + C is kept, so there is none to
    gate); (c) a row's bits whatever the batch: the blocked, dense and
    ring reads of 1 and 6 slots against the same slots among 32, and a
    200-row dense chunk against its rows of the 256-row bucket (the
    engine's rounds equal ``Decoder.generate`` only so); (d) the windowed
    ring write of a right-padded piece bitwise equal to the exact-length
    piece's (ring K/V and positions) at the 124M shapes, a piece longer
    than the window first, and the 124M windowed LM's padded prefill
    against its exact one (reported)."""
    g = torch.Generator(device=dev).manual_seed(41)
    hd = EMBED // HEADS
    n = 0
    for d in (dec, dec8):
        for trial in range(2):
            pos = torch.randint(0, MAX_LEN, (SLOTS,), generator=g,
                                device=dev, dtype=torch.int32)
            if trial:
                pos[0], pos[1] = 0, MAX_LEN - 1       # the edge blocks
            q = torch.randn((SLOTS, 1, HEADS, hd), generator=g, device=dev,
                            dtype=torch.bfloat16)
            shape = (SLOTS, MAX_LEN, HEADS, hd)
            if d._cache_int8:
                def vals():
                    return torch.randint(-127, 128, shape, generator=g,
                                         device=dev, dtype=torch.int8)

                def scales():
                    return torch.rand(shape[:3], generator=g, device=dev) \
                        * 0.02 + 1e-3
                entry = (vals(), scales(), vals(), scales())
            else:
                entry = tuple(torch.randn(shape, generator=g, device=dev,
                                          dtype=torch.bfloat16)
                              for _ in range(2))
            got = d._blocked_attn(q, entry, pos)
            want = _live_blocked(d, q, entry, pos)
            if not torch.equal(got, want):
                raise AssertionError(
                    "phase 4f: the blocked read over all %d blocks differs "
                    "from the live blocks' loop (%s cache, max |diff| %.3g)"
                    % (MAX_LEN // d._cache_block,
                       "int8" if d._cache_int8 else "bf16",
                       (got.float() - want.float()).abs().max()))
            n += 1
    log("phase 4f reads (a): the blocked read over all %d blocks of %d rows "
        "bitwise equal to the loop over each slot's live blocks in %d "
        "cases (C=1, %d slots at random positions, bf16 and int8 caches)"
        % (MAX_LEN // dec._cache_block, dec._cache_block, n, SLOTS))
    log("phase 4f reads (b): the dense read takes all %d rows in every call "
        "(prefill, step and the engine's programs alike); the JAX "
        "package's static clamp to pos + C is not kept, so no clamp is "
        "gated" % MAX_LEN)
    # (c) a row's bits do not depend on the batch: rows 0, 0-5 of a
    # 32-slot read against the same rows read alone (the blocked read, the
    # dense read at C=1 and a 200-row chunk against its 256-row bucket)
    n = 0
    for d in (dec, dec8):
        pos = torch.randint(0, MAX_LEN, (SLOTS,), generator=g, device=dev,
                            dtype=torch.int32)
        q = torch.randn((SLOTS, 1, HEADS, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        entry = tuple(torch.randn((SLOTS, MAX_LEN, HEADS, hd), generator=g,
                                  device=dev, dtype=torch.bfloat16)
                      for _ in range(2))
        if d._cache_int8:
            entry = d._cache_rows(*entry)

        def reads(sl):
            ctx = {"rows": pos[sl].long()[:, None]}
            return (d._blocked_attn(q[sl], tuple(t[sl] for t in entry),
                                    pos[sl]),
                    d._dense_attn(q[sl], tuple(t[sl] for t in entry), ctx))
        full = reads(slice(0, SLOTS))
        for sl in (slice(0, 1), slice(0, 6)):
            for got, want in zip(reads(sl), full):
                if not torch.equal(got, want[sl]):
                    raise AssertionError(
                        "phase 4f: a read of %d slots differs from the same "
                        "slots among %d" % (sl.stop, SLOTS))
                n += 1
    qc = torch.randn((1, 256, HEADS, hd), generator=g, device=dev,
                     dtype=torch.bfloat16)
    rows = 300 + torch.arange(256, device=dev)[None]
    one = tuple(torch.randn((1, MAX_LEN, HEADS, hd), generator=g,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
    chunk = dec._dense_attn(qc, one, {"rows": rows})
    part = dec._dense_attn(qc[:, :200], one, {"rows": rows[:, :200]})
    if not torch.equal(part, chunk[:, :200]):
        raise AssertionError("phase 4f: the dense read of a 200-row chunk "
                             "differs from its rows of the 256-row bucket")
    posw = torch.randint(WINDOW, MAX_LEN, (SLOTS,), generator=g, device=dev,
                         dtype=torch.int32)
    ring = [torch.randn((SLOTS, WINDOW, HEADS, hd), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2)]
    back = posw[:, None].long() - 1 - torch.arange(WINDOW, device=dev)
    cpos = torch.zeros((SLOTS, WINDOW), dtype=torch.int32, device=dev)
    cpos.scatter_(1, back % WINDOW, back.to(torch.int32))
    qkv = [torch.randn((SLOTS, 1, HEADS, hd), generator=g, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]

    def ring_read(sl):
        e = (ring[0][sl].clone(), ring[1][sl].clone(), cpos[sl].clone())
        return decw._window_attn(*(t[sl] for t in qkv), e, posw[sl],
                                 WINDOW)[0]
    full = ring_read(slice(0, SLOTS))
    for sl in (slice(0, 1), slice(0, 6)):
        if not torch.equal(ring_read(sl), full[sl]):
            raise AssertionError("phase 4f: a ring read of %d slots differs "
                                 "from the same slots among %d"
                                 % (sl.stop, SLOTS))
        n += 1
    log("phase 4f reads (c): %d batch checks bitwise (the blocked and dense "
        "reads of 1 and 6 slots against the same slots among %d, bf16 and "
        "int8 caches; the ring read likewise; a 200-row dense chunk against "
        "its rows of the 256-row bucket)" % (n + 1, SLOTS))
    # (d) the write alone: the same rows, a padded and an exact piece
    win = decw._node_window(decw._mha[0])
    q, k, v = (torch.randn((1, 512, HEADS, hd), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    exact = decw.init_cache(1)[0]
    padded = decw.init_cache(1)[0]
    same_o = True
    start = 0
    for real, pad in ((300, 300), (150, 256)):
        sl = slice(start, start + real)
        o_e, _ = decw._window_attn(q[:, sl], k[:, sl], v[:, sl], exact,
                                   torch.tensor([start], device=dev), win)
        sp = slice(start, start + pad)
        o_p, _ = decw._window_attn(q[:, sp], k[:, sp], v[:, sp], padded,
                                   torch.tensor([start], device=dev), win,
                                   valid_len=torch.tensor([start + real],
                                                          device=dev))
        same_o &= torch.equal(o_p[:, :real], o_e)
        for x, y in zip(padded, exact):
            if not torch.equal(x, y):
                raise AssertionError(
                    "phase 4f: the ring written by a piece of %d real rows "
                    "padded to %d differs from the exact piece's" % (real,
                                                                     pad))
        start += real
    # the whole LM: a 200-token prompt, exact and padded to 256
    toks = torch.randint(0, VOCAB, (1, 200), generator=g, device=dev)
    pad = torch.cat([toks, torch.zeros((1, 56), dtype=toks.dtype,
                                       device=dev)], 1)
    le, ce = decw._run(decw._params, decw._aux, decw.init_cache(1), 0, toks)
    lp, cp = decw._run(decw._params, decw._aux, decw.init_cache(1), 0, pad,
                       valid_len=200)
    rings = sum(all(torch.equal(x, y) for x, y in zip(a, b))
                for a, b in zip(cp, ce))
    log("phase 4f reads (d): the ring write of a padded piece (300 rows, "
        "then 150 padded to 256, window %d, bf16) bitwise equal to the "
        "exact pieces': ring K/V and positions; the real rows' outputs "
        "bitwise equal: %s; the 124M windowed LM's 200-token prefill padded "
        "to 256: %d of %d layers' rings and the last logits (%s) bitwise "
        "equal to the exact prefill's" % (
            win, same_o, rings, LAYERS,
            "equal" if torch.equal(lp[0, 199], le[0, 199]) else
            "max |diff| %.3g" % (lp[0, 199].float()
                                 - le[0, 199].float()).abs().max()))


def dense_engine(K, dec, paged, work):
    """4f.2 and 4f.3's 124M part: phase 4's wave on the dense engine
    (``cache_block`` auto = 128: decode steps on the blocked read, prefill
    pieces on the dense read) and on the paged one, DW_WAVES each in turns
    (both unfused, ``TP_MM``): every dense stream equal to the dense
    ``Decoder.generate``, exact launches from ``stats``, the JAX compile
    contract; how many streams the two reads share (bf16: not gated);
    tokens/s of each; the dense decode profile. Returns the launches."""
    de = _engine_4c(dec)
    pe = _engine_4c(paged)
    if de.attn_impl != "dense" or dec._cache_block != 128:
        raise AssertionError("phase 4f: the dense engine reads %s with "
                             "cache_block %r" % (de.attn_impl,
                                                 dec._cache_block))
    for e in (de, pe):
        _warm(e)
    s0 = {id(e): dict(e.stats) for e in (de, pe)}
    K.reset_launch_counts()
    runs = {"dense": [], "paged": []}
    for i in range(DW_WAVES):
        turn = (("dense", de), ("paged", pe))
        for what, e in (turn if i % 2 == 0 else turn[::-1]):
            runs[what].append(_serve_wave(e, work))
    launches = K.launch_counts()
    want = dict.fromkeys(launches, 0)
    dd = _delta(de, s0[id(de)])
    want.update(_unfused_launches(dd))
    for k, nl in _tp_launches(_delta(pe, s0[id(pe)]), 1).items():
        want[k] = want.get(k, 0) + nl
    if launches != want:
        raise AssertionError("phase 4f dense wave: launch counts %r, the "
                             "waves want %r" % (launches, want))
    first = runs["dense"][0][0]
    for what in runs:
        for handles, _ in runs[what]:
            for h, h0 in zip(handles, runs[what][0][0]):
                if not h.done or len(h.tokens) != h.limit \
                        or h.tokens != h0.tokens:
                    raise AssertionError("phase 4f %s wave: request %s "
                                         "differs between waves" % (what,
                                                                    h.id))
    gen_s = _equal_generate_grouped("phase 4f dense wave", dec, first)
    check_compile_counts(de, "phase 4f dense")
    shared = sum(h.tokens == hp.tokens
                 for h, hp in zip(first, runs["paged"][0][0]))
    tps = {w: statistics.median(_wave_metrics(h, t)[0] for h, t in r)
           for w, r in runs.items()}
    log("phase 4f dense wave (cache_block %d): %d streams equal the dense "
        "Decoder.generate (%.1f s of offline decoding); %d of %d streams "
        "equal the paged engine's (bf16: the reads round differently; not "
        "gated); tokens/s dense %.1f, paged %.1f (median of %d waves each, "
        "in turns, unfused products), dense/paged %.3f; launches %s; %s" % (
            dec._cache_block, len(first), gen_s, shared, len(first),
            tps["dense"], tps["paged"], DW_WAVES,
            tps["dense"] / tps["paged"],
            json.dumps({e: n for e, n in launches.items() if n}),
            card_line()))
    profile_decode(de, np.random.RandomState(8), trace=None,
                   what="phase 4f dense, cache_block 128")
    profile_decode(pe, np.random.RandomState(8), trace=None,
                   what="phase 4f paged, unfused")
    de.close()
    pe.close()
    return launches


def dense_gauntlet(K, prefix, dev):
    """4f.2's reuse gauntlet (phase 4e(3)'s: a 160 MiB prefix pool,
    ``prefill_chunk=256``, n-gram ``spec_k=4``) on a dense engine with
    ``cache_block=None``, the JAX engine's serving configuration (a
    verify round reads its chunk densely in q's dtype; so does a decode
    step then): the wave twice (the first builds every program), the
    second counted: exact launches, prefix hits and accepted drafts, every
    stream equal to the dense offline decoder's. Returns the launches."""
    dec = _decoder_4f(prefix, dev, attn_impl="dense", cache_block=None)
    work = _gauntlet_work(44)
    e = _engine_4c(dec, prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK,
                   draft="ngram", spec_k=SPEC_K)
    _serve_wave(e, work)
    _build(e, ("decode", "verify"))
    s0 = dict(e.stats)
    K.reset_launch_counts()
    handles, secs = _serve_wave(e, work)
    d = _delta(e, s0)
    got = _check_launches(K, "phase 4f dense gauntlet",
                          _unfused_launches(d, spec=True))
    if d["prefix_hits"] < 1 or d["spec_accepted"] < 1 \
            or d["prefill_chunks"] <= len(work):
        raise AssertionError("phase 4f dense gauntlet: stats %r" % d)
    _equal_generate_grouped("phase 4f dense gauntlet", dec, handles)
    _wave_line("phase 4f dense gauntlet (cache_block None)", handles, secs,
               got, "; prefix hits %d, accepted drafts %d of %d, prefill "
               "pieces %d; every stream equal the dense Decoder.generate"
               % (d["prefix_hits"], d["spec_accepted"], d["spec_drafted"],
                  d["prefill_chunks"]))
    e.close()
    return got


def check_paged_equals_dense_f32(dev):
    """4f.3: a 2-layer f32 LM on the card, a paged and a dense engine over
    a small gauntlet (a prefix pool, 16-token pieces, n-gram drafts, 4
    slots for 12 requests): streams byte-identical (the JAX contract,
    ``tests/test_paged_attention.py``)."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import Decoder
    from mxnet_tpu_torch.serving import InferenceEngine

    symbol = get_transformer_lm(97, num_layers=2, embed_dim=64, num_heads=4)
    params = _small_params(symbol, 64)
    rs = np.random.RandomState(9)
    base = rs.randint(0, 97, (20,))
    work = [(base, 8), (base[:12].copy(), 10),
            (np.concatenate([base[:12], rs.randint(0, 97, (9,))]), 8),
            (np.tile(rs.randint(0, 97, (4,)), 5), 20)]
    work += [(rs.randint(0, 97, (int(n),)), 12)
             for n in rs.randint(3, 40, 8)]
    streams = {}
    for impl in ("paged", "dense"):
        d = Decoder(symbol, params, max_len=64, attn_impl=impl,
                    cache_block=None, device=dev)
        e = InferenceEngine(d, slots=4, prefill_buckets=(8, 16, 32),
                            prefix_cache_mb=0.2, prefill_chunk=16,
                            draft="ngram", spec_k=3)
        hs = [e.submit(p, max_tokens=b) for p, b in work]
        e.serve_forever()
        streams[impl] = ([h.tokens for h in hs], dict(e.stats))
        e.close()
    if streams["paged"][0] != streams["dense"][0]:
        raise AssertionError("phase 4f: the paged and dense engines' f32 "
                             "streams differ")
    st = streams["dense"][1]
    log("phase 4f paged = dense (2-layer f32 LM, gauntlet of %d requests "
        "over 4 slots): every stream byte-identical (prefix hits %d, "
        "accepted drafts %d, prefill pieces %d)" % (
            len(work), st["prefix_hits"], st["spec_accepted"],
            st["prefill_chunks"]))


def _window_work(rs):
    return [(rs.randint(0, VOCAB, (p,)), b) for p, b in WIN_GROUPS
            for _ in range(WIN_PER_GROUP)]


def window_engine(K, decw, dev):
    """4f.4: the 124M LM built with ``window=256`` behind the engine:
    asked for the paged read and n-gram speculation it warns and serves
    its dense ring read without speculation and without a prefix pool; a
    prefill role is refused. Its wave (36 requests over 32 slots, prompts
    of 40-900 tokens in pieces of 256, rings wrapping across pieces and
    during decode) with exact launches and the compile
    contract: every stream equal to the windowed ``Decoder.generate``;
    then the wave at tp=2 on two ranks of the card, streams equal. Returns
    the launches."""
    import warnings as _w
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import model_parallel_mesh
    from mxnet_tpu_torch.serving import InferenceEngine

    try:
        InferenceEngine(decw, slots=2, role="prefill")
    except MXNetError as err:
        if "serve unified" not in str(err):
            raise
    else:
        raise AssertionError("phase 4f: a windowed prefill engine was "
                             "built")
    with _w.catch_warnings(record=True) as caught:
        _w.simplefilter("always")
        e = _engine_4c(decw, attn_impl="paged", draft="ngram", spec_k=SPEC_K,
                       prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK)
    texts = " | ".join(str(c.message) for c in caught
                       if issubclass(c.category, UserWarning))
    if "exact dense ring walk" not in texts or "draft='off'" not in texts \
            or e.attn_impl != "dense" or e.spec_draft != "off" \
            or e._prefix is not None:
        raise AssertionError("phase 4f windowed engine: warnings %r, read "
                             "%s, draft %s, pool %r" % (
                                 texts, e.attn_impl, e.spec_draft,
                                 e._prefix))
    work = _window_work(np.random.RandomState(45))
    _warm(e)
    s0 = dict(e.stats)
    K.reset_launch_counts()
    handles, secs = _serve_wave(e, work)
    d = _delta(e, s0)
    got = _check_launches(K, "phase 4f windowed wave", _unfused_launches(d))
    check_compile_counts(e, "phase 4f windowed")
    gen_s = _equal_generate_grouped("phase 4f windowed wave", decw,
                                    handles)
    _wave_line("phase 4f windowed wave (window %d, prefill_chunk %d, %d "
               "requests over %d slots)" % (WINDOW, CHUNK, len(work), SLOTS),
               handles, secs, got,
               "; prefill pieces %d; every stream equal the windowed "
               "Decoder.generate (%.1f s offline, one batch a prompt length)"
               % (d["prefill_chunks"], gen_s))
    e.prefill_chunk = 0      # the profile's 32 prompts admit at once
    profile_decode(e, np.random.RandomState(8), trace=None,
                   what="phase 4f windowed, window %d" % WINDOW)
    e.close()
    mesh = model_parallel_mesh(TP, devices=[dev] * TP)
    two = _engine_4c(decw, mesh=mesh, prefill_chunk=CHUNK)
    _warm(two)
    s0 = dict(two.stats)
    K.reset_launch_counts()
    h2, secs2 = _serve_wave(two, work)
    g2 = _check_launches(K, "phase 4f windowed wave tp=2",
                         _unfused_launches(_delta(two, s0)))
    for h, r in zip(h2, handles):
        if not h.done or h.tokens != r.tokens:
            raise AssertionError("phase 4f windowed tp=2: request %s's "
                                 "stream differs from tp=1's" % h.id)
    log("phase 4f windowed tp=2 (%s): %d streams equal tp=1's; %.1f "
        "tokens/s; %s" % (TP_NOTE, len(h2), _wave_metrics(h2, secs2)[0],
                          card_line()))
    two.close()
    total = dict(got)
    for k, n in g2.items():
        total[k] = total.get(k, 0) + n
    return total


def check_beam(K, dec, dev):
    """4f.5: ``beam_search`` on the 124M paged decoder (B=2, a 64-token
    prompt, 32 steps, beams of 4, with and without an EOS): exact
    launches; ``beam_size=1`` equal to greedy ``generate``; each score
    within its bound of the sum of its sequence's log-probs recomputed by
    one teacher-forced prefill (bf16: per token 2 x LOGIT_ULPS bf16 ulps,
    2^-7 relative, of the row's largest |logit|: the logit and the
    log-sum-exp each); beams best first. Returns the launches."""
    g = torch.Generator(device=dev).manual_seed(46)
    prompt = torch.randint(0, VOCAB, (BEAM_B, BEAM_P), generator=g,
                           device=dev)
    one, _ = dec.beam_search(prompt, BEAM_STEPS, 1)
    if not torch.equal(one[:, 0], dec.generate(prompt, BEAM_STEPS)):
        raise AssertionError("phase 4f beam: beam_size=1 differs from "
                             "greedy generate")
    seqs0, _ = dec.beam_search(prompt, BEAM_STEPS, BEAM_K)
    eos = int(seqs0[0, 0, BEAM_P + 3])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    seqs, scores = dec.beam_search(prompt, BEAM_STEPS, BEAM_K)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / BEAM_STEPS
    walks = BEAM_STEPS
    got = _check_launches(K, "phase 4f beam", {
        "paged_attention_chunk": LAYERS,
        "paged_attention_decode": LAYERS * (walks - 1),
        "quant_matmul": (4 * LAYERS + 1) * walks})
    worst = 0.0
    for eos_id, (sq, sc) in ((None, (seqs, scores)),
                             (eos, dec.beam_search(prompt, BEAM_STEPS,
                                                   BEAM_K, eos_id=eos))):
        if (sc[:, 1:] > sc[:, :-1]).any():
            raise AssertionError("phase 4f beam: beams not best first")
        flat = sq.reshape(BEAM_B * BEAM_K, -1)
        logits, _ = dec.prefill(dec.init_cache(flat.shape[0]), flat)
        lg = logits[:, BEAM_P - 1:-1].float()
        lp = torch.log_softmax(lg, -1).gather(
            2, flat[:, BEAM_P:, None])[..., 0]
        live = torch.ones_like(lp, dtype=torch.bool)
        if eos_id is not None:
            hit = (flat[:, BEAM_P:] == eos_id).long().cumsum(1)
            live = (hit - (flat[:, BEAM_P:] == eos_id).long()) == 0
        want = (lp * live).sum(1)
        bound = (2 * LOGIT_ULPS * 2.0 ** -7
                 * lg.abs().amax(-1) * live).sum(1)
        err = (sc.reshape(-1) - want).abs()
        if (err > bound).any():
            raise AssertionError("phase 4f beam (eos %r): scores %s, "
                                 "recomputed %s, bound %s" % (
                                     eos_id, sc.tolist(), want.tolist(),
                                     bound.tolist()))
        worst = max(worst, float((err / bound).max()))
    log("phase 4f beam search (124M paged, B=%d, a %d-token prompt, %d "
        "steps, beams of %d): beam_size=1 equals greedy generate; scores "
        "within %.3f of their bound from a teacher-forced prefill, with and "
        "without an EOS (%d); best first; %.3f ms a step; launches %s; %s"
        % (BEAM_B, BEAM_P, BEAM_STEPS, BEAM_K, worst, eos, ms,
           json.dumps({e: n for e, n in got.items() if n}), card_line()))
    return got


def _small_params(symbol, max_len):
    """Fan-in scaled f32 weights (far from ties), from seed 2."""
    shapes = {"data": (1, max_len), "softmax_label": (1, max_len)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(2)
    return {n: (rng.randn(*sh) * (1.5 / np.sqrt(sh[1]) if len(sh) == 2
                                  else 0.1)
                + (n.endswith("_gamma"))).astype(np.float32)
            for n, sh in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}


def check_small_reads_against_host(dev):
    """4f.6: 2-layer LMs in f32 on the card and on the host from the same
    weights, through the dense read (GQA, rope, an int8 cache), the
    blocked read (cache_block 16 of 64) and the ring (window 8, GQA, rope,
    an int8 cache): prefill logits within 1e-3 and greedy tokens equal."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import Decoder

    configs = [
        (dict(num_kv_heads=2, pos_encoding="rope"),
         dict(attn_impl="dense", cache_block=None, cache_dtype="int8")),
        (dict(num_kv_heads=2), dict(attn_impl="dense", cache_block=16,
                                    weight_dtype="int8",
                                    matmul_impl="pallas")),
        (dict(window=8, num_kv_heads=2, pos_encoding="rope"),
         dict(cache_dtype="int8")),
        (dict(window=8), dict(weight_dtype="int8", matmul_impl="pallas")),
    ]
    prompt = np.random.RandomState(3).randint(0, 97, (2, 11))
    for mkw, dkw in configs:
        symbol = get_transformer_lm(97, num_layers=2, embed_dim=64,
                                    num_heads=4, **mkw)
        params = _small_params(symbol, 64)
        out = {}
        for where in (dev, "cpu"):
            d = Decoder(symbol, params, max_len=64, device=where, **dkw)
            logits, _ = d.prefill(d.init_cache(2), prompt)
            out[str(where)] = (logits.cpu(), d.generate(prompt, 30).cpu())
        (lg, tg), (lh, th) = out[str(dev)], out["cpu"]
        err = (lg - lh).abs().max().item()
        if err > 1e-3 or not torch.equal(tg, th):
            raise AssertionError(
                "phase 4f small LM %s %s: card and host disagree (max "
                "|logit err| %.3g, tokens equal %s)" % (
                    mkw, dkw, err, torch.equal(tg, th)))
        log("phase 4f small LM %s %s: card vs host prefill logits max |err| "
            "%.3g, 30 greedy tokens equal (%d distinct)" % (
                mkw, dkw, err, len(set(tg[:, 11:].flatten().tolist()))))


def dense_main_path(K, dev, prefix, work):
    """Phase 4f: the dense, blocked and windowed reads of ``Decoder`` and
    the engine's dense and windowed paths on phase 4's 124M LM (int8
    weights, unfused products, bf16). Returns the launches it counted."""
    from mxnet_tpu_torch.models import get_transformer_lm
    t0 = time.perf_counter()
    dec = _decoder_4f(prefix, dev, attn_impl="dense")
    dec8 = _decoder_4f(prefix, dev, attn_impl="dense", cache_dtype="int8")
    symw = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                              num_heads=HEADS, window=WINDOW)
    decw = _decoder_4f(prefix, dev, symbol=symw)
    if decw._attn_impl != "dense":
        raise AssertionError("phase 4f: the windowed decoder reads %s"
                             % decw._attn_impl)
    check_dense_reads(dec, dec8, decw, dev)
    del dec8
    paged = _decoder_4c(prefix, dev, mm=TP_MM)
    total = {}

    def add(launches):
        for e, n in launches.items():
            total[e] = total.get(e, 0) + n
        free_programs()
    add(dense_engine(K, dec, paged, work))
    add(dense_gauntlet(K, prefix, dev))
    check_paged_equals_dense_f32(dev)
    add(window_engine(K, decw, dev))
    add(check_beam(K, paged, dev))
    check_small_reads_against_host(dev)
    del dec, decw, paged
    free_programs()
    log("phase 4f: every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t0,
        json.dumps({e: n for e, n in total.items() if n})))
    return total


def check_main_against_host(prefix, dec, handles, steps=16):
    """The 124M decoder rebuilt on the host from the same checkpoint (the
    plain versions, bf16) against the card's, for each served request:
    prefill logits over the prompt and its served stream agree within
    LOGIT_ULPS; each token the card chose is the host's argmax up to that
    tolerance; and the host's own greedy stream of ``steps`` tokens is
    reported against the card's (random weights leave near ties)."""
    from mxnet_tpu_torch.parallel import Decoder

    host = Decoder.from_checkpoint(
        prefix, 0, MAX_LEN, attn_impl="paged", weight_dtype="int8",
        matmul_impl="fused", compute_dtype="bfloat16", device="cpu")
    for h in handles:
        p = len(h.prompt)
        seq = np.concatenate([np.asarray(h.prompt),
                              np.asarray(h.tokens[:-1])])[None]
        lc, _ = dec.prefill(dec.init_cache(1), seq)
        lh, _ = host.prefill(host.init_cache(1), seq)
        lc, lh = lc[0].float().cpu(), lh[0].float()
        tol = LOGIT_ULPS * 2.0 ** -7 * lh.abs().amax(dim=-1)
        err = (lc - lh).abs().amax(dim=-1)
        rows = lh[p - 1:]
        toks = torch.as_tensor(h.tokens)
        gap = rows.amax(dim=-1) - rows.gather(1, toks[:, None])[:, 0]
        if (err > tol).any() or (gap > tol[p - 1:]).any():
            raise AssertionError(
                "request %s: the 124M LM on the card and on the host "
                "disagree: max |logit err| %.4g (tolerance %.4g), the "
                "card's tokens up to %.4g below the host's best" % (
                    h.id, err.max().item(), tol.min().item(),
                    gap.max().item()))
        ref = host.generate(np.asarray(h.prompt)[None], steps)[0, p:]
        same = next((i for i, (a, b) in enumerate(zip(ref.tolist(),
                                                      h.tokens))
                     if a != b), steps)
        log("124M card vs host, request %s (prompt %d): prefill logits max "
            "|err| %.4g = %.2f ulps of the row max (tolerance %d); card "
            "tokens the host's argmax at %d of %d positions, all within "
            "tolerance; host greedy stream equals the card's for %d of %d "
            "tokens" % (
                h.id, p, err.max().item(),
                (err / (2.0 ** -7 * lh.abs().amax(dim=-1))).max().item(),
                LOGIT_ULPS, int((rows.argmax(dim=-1) == toks).sum()),
                len(toks), same, steps))


def profile_decode(engine, rs, rounds=2, trace="decode_trace.json",
                   what="captured"):
    """Where a decode round's time goes: every slot busy (prompts of 64,
    long budgets), ``rounds`` rounds after one warm round: their wall
    time and the card's time over them by CUDA events, then the same
    number of rounds under torch.profiler. Prints the wall time per step,
    the card's kernel time per step (the profiler's sum; the events' span
    beside it) and its idle share (1 - kernel time / wall time), the host
    calls per round that put work on the card, the kernels by device time,
    and the peak memory; the trace goes to chiprun_out/ unless ``trace``
    is None. Returns the figures per step (wall and card ms, the idle
    share, host calls a round, {kernel: card ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(SLOTS):
        engine.submit(rs.randint(0, VOCAB, (64,)),
                      max_tokens=(2 * rounds + 2) * STEPS_PER_ROUND)
    engine.step()                        # admit all, one warm round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = Timer._events(1)[0]
    t0 = time.perf_counter()
    a.record()
    for _ in range(rounds):
        engine.step()
    b.record()
    torch.cuda.synchronize()
    wall_ev = time.perf_counter() - t0
    span_ms = a.elapsed_time(b)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while not engine.idle:
        engine.step()
    steps = rounds * STEPS_PER_ROUND
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    calls = host_calls(prof)
    log("decode profile (%s): %d steps x %d slots; wall %.3f ms per step "
        "(unprofiled: %.3f, card span by events %.3f), card kernels %.3f "
        "ms per step, idle share %.3f; host calls per round %.1f %s; memory "
        "%s; %s" % (
            what, steps, SLOTS, wall * 1e3 / steps, wall_ev * 1e3 / steps,
            span_ms / steps, busy_us / 1e3 / steps,
            1.0 - busy_us / 1e6 / wall, sum(calls.values()) / rounds,
            json.dumps(calls), memory(), card_line()))
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log("  %-60s %8.3f ms per step  %5d calls" % (
            key[:60], us / 1e3 / steps, n))
    result = {"wall_ms": wall * 1e3 / steps, "card_ms": busy_us / 1e3 / steps,
              "idle": 1.0 - busy_us / 1e6 / wall,
              "host_calls": sum(calls.values()) / rounds,
              "by_kernel": {key: us / 1e3 / steps for key, us, _ in rows}}
    if trace is None:
        return result
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, trace))
    return result


def check_small_against_host(dev):
    """A 2-layer LM served on the card (kernels) and on the host (plain
    versions) from the same seeded weights, in the decoder's other modes
    too: f32 prefill logits within 1e-3 (sums run in other orders) and
    greedy tokens equal. Weights are fan-in scaled so that the streams
    vary and the logits are far from ties."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import Decoder

    configs = [  # (model kwargs, decoder kwargs)
        (dict(num_kv_heads=2), dict(weight_dtype="int8",
                                    matmul_impl="fused")),
        (dict(num_kv_heads=2, pos_encoding="rope"),
         dict(weight_dtype="int4", matmul_impl="fused")),
        (dict(), dict(weight_dtype="int8", matmul_impl="pallas",
                      cache_dtype="int8")),
        (dict(pos_encoding="rope"), dict(weight_dtype="float")),
    ]
    prompt = np.random.RandomState(3).randint(0, 97, (2, 11))
    for mkw, dkw in configs:
        symbol = get_transformer_lm(97, num_layers=2, embed_dim=64,
                                    num_heads=4, **mkw)
        shapes = {"data": (1, 64), "softmax_label": (1, 64)}
        arg_shapes, _, _ = symbol.infer_shape(**shapes)
        rng = np.random.RandomState(2)
        params = {n: (rng.randn(*sh) * (1.5 / np.sqrt(sh[1])
                                        if len(sh) == 2 else 0.1)
                      + (n.endswith("_gamma"))).astype(np.float32)
                  for n, sh in zip(symbol.list_arguments(), arg_shapes)
                  if n not in shapes}
        out = {}
        for where in (dev, "cpu"):
            d = Decoder(symbol, params, max_len=64, device=where, **dkw)
            logits, _ = d.prefill(d.init_cache(2), prompt)
            out[str(where)] = (logits.cpu(), d.generate(prompt, 20).cpu())
        (lg, tg), (lh, th) = out[str(dev)], out["cpu"]
        err = (lg - lh).abs().max().item()
        same = torch.equal(tg, th)
        if err > 1e-3 or not same:
            raise AssertionError(
                "small LM %s %s: card and host disagree (max |logit err| "
                "%.3g, tokens equal %s)" % (mkw, dkw, err, same))
        log("small LM %s %s: card vs host prefill logits max |err| %.3g, "
            "greedy tokens equal (%d distinct)" % (
                mkw, dkw, err, len(set(tg[:, 11:].flatten().tolist()))))


# -- phase 4g: the mixture-of-experts LM served -------------------------------

MOE_X, MOE_K = 8, 2          # Mixtral 8x7B's routing (Jiang et al., 2024)
MOE_WAVES = 3
MOE_MM = "pallas"            # the ep and gauntlet engines' products, unfused
EP = 2
EP_NOTE = "ranks on ONE card, not a multi-card figure"
MOE_INPUTS = ("gate_weight", "expert_w1", "expert_b1", "expert_w2",
              "expert_b2")


def _moe_symbol(layers=LAYERS):
    """The 124M LM at full width with every block a MoE block of MOE_X
    experts of 4E, top-MOE_K routing."""
    from mxnet_tpu_torch.models import get_transformer_lm
    return get_transformer_lm(VOCAB, num_layers=layers, embed_dim=EMBED,
                              num_heads=HEADS, num_experts=MOE_X,
                              moe_top_k=MOE_K)


def _moe_layer_qmm(ep=1, fused=False):
    """``quant_matmul`` launches of one MoE layer's walk: the qkv and out
    projections unless the fused step takes them, then on each expert
    rank its gate and its up stack (``serving/quant.py``
    ``moe_ffn_forward``), and one down product an expert."""
    return (0 if fused else 2) + 2 * ep + MOE_X


def _moe_launches(d, fused=False, ep=1, tp=1, spec=False):
    """A MoE engine's launches from its stats deltas ``d``: per decode
    walk (each step of a round, or under speculation each verify round and
    each step of a fallback round) LAYERS fused steps (``fused``) or
    ``tp`` x LAYERS decode reads, and the layers' products plus the
    lm_head; per prefill piece ``tp`` x LAYERS chunk reads and the unfused
    products plus the lm_head."""
    walks = (d["spec_rounds"] + d["spec_fallback_rounds"] * STEPS_PER_ROUND
             if spec else d["steps"] * STEPS_PER_ROUND)
    pieces = d["prefill_chunks"]
    want = {"paged_attention_chunk": tp * LAYERS * pieces,
            "quant_matmul": (LAYERS * _moe_layer_qmm(ep) + 1) * pieces
            + (LAYERS * _moe_layer_qmm(ep, fused) + 1) * walks}
    want["fused_decode_attention" if fused else "paged_attention_decode"] = \
        (1 if fused else tp) * LAYERS * walks
    return want


def _check_expert_shards(engine, dev, what):
    """Each MoE input of every layer: ``EP`` shards of MOE_X/EP experts on
    the card, each (a quantized stack's values and scales alike) an
    allocation no other rank shares."""
    for i in range(LAYERS):
        for name in MOE_INPUTS:
            shards = engine._params["layer%d_%s" % (i, name)]
            if not isinstance(shards, list) or len(shards) != EP:
                raise AssertionError("%s: layer%d_%s is not %d rank shards"
                                     % (what, i, name, EP))
            owners = []
            for sh in shards:
                leaves = (sh.q, sh.scale) if hasattr(sh, "q") else (sh,)
                for t in leaves:
                    if t.shape[0] != MOE_X // EP or t.device != dev \
                            or not t.is_contiguous():
                        raise AssertionError(
                            "%s: a layer%d_%s shard %s on %s" % (
                                what, i, name, tuple(t.shape), t.device))
                owners.append({t.untyped_storage().data_ptr()
                               for t in leaves})
            if owners[0] & owners[1]:
                raise AssertionError("%s: two ranks share layer%d_%s"
                                     % (what, i, name))


def moe_wave(K, dev, prefix, work):
    """4g.1: the MoE checkpoint through ``from_checkpoint`` on phase 4's
    settings (int8 weights, the fused decode step, paged reads), MOE_WAVES
    of phase 4's wave: streams equal the first wave's and two equal
    ``Decoder.generate``, exact launches, the compile contract; tokens/s,
    ms per token, the decode profile, one 256-token prefill. Returns the
    launches."""
    from mxnet_tpu_torch.serving import InferenceEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused", compute_dtype="bfloat16",
        device=dev, prefix_cache_mb=0, prefill_chunk=0)
    torch.cuda.synchronize()
    log("phase 4g: MoE LM loaded in %.1f s; int8 weights %.1f MB" % (
        time.perf_counter() - t0, engine.weight_bytes / 1e6))
    _warm(engine)
    s0 = dict(engine.stats)
    K.reset_launch_counts()
    waves = [_serve_wave(engine, work) for _ in range(MOE_WAVES)]
    launches = _check_launches(K, "phase 4g wave", _moe_launches(
        _delta(engine, s0), fused=True))
    first = waves[0][0]
    for handles, _ in waves:
        _equal_streams("phase 4g wave", handles, first)
    _equal_generate("phase 4g wave", engine._dec, (first[0], max(
        first[1:], key=lambda h: len(h.prompt))))
    check_compile_counts(engine, "phase 4g")
    per = [_wave_metrics(h, t) for h, t in waves]
    cols = list(zip(*per))
    log("phase 4g wave: %d waves x %d requests; median (min-max) %.1f "
        "tokens/s (%.1f-%.1f), ms per token p50 %.3f, p99 %.3f; every "
        "stream equal to the first wave's, two equal Decoder.generate; "
        "launches %s (per decode step %d fused steps and %d quant_matmul; "
        "per prefill %d chunk reads and %d quant_matmul); %s" % (
            MOE_WAVES, len(work), statistics.median(cols[0]), min(cols[0]),
            max(cols[0]), statistics.median(cols[1]),
            statistics.median(cols[2]),
            json.dumps({e: n for e, n in launches.items() if n}), LAYERS,
            LAYERS * _moe_layer_qmm(1, True) + 1, LAYERS,
            LAYERS * _moe_layer_qmm(1) + 1, card_line()))
    prof = profile_decode(engine, np.random.RandomState(8), trace=None,
                          what="phase 4g MoE, fused step")
    qmm = sum(ms for key, ms in prof["by_kernel"].items()
              if "quant_matmul" in key)
    log("phase 4g decode step: wall %.3f ms, card %.3f ms, idle share %.3f, "
        "host calls a round %.1f; quant_matmul %.3f ms a step = %.3f of the "
        "card's time; %s" % (
            prof["wall_ms"], prof["card_ms"], prof["idle"],
            prof["host_calls"], qmm, qmm / max(prof["card_ms"], 1e-9),
            card_line()))
    time_engine_prefill(engine, what="phase 4g engine prefill of %d tokens "
                        "(captured bucket-%d program, one slot, pos 0)" % (
                            BUCKETS[-1], BUCKETS[-1]),
                        prompt=np.random.RandomState(5).randint(
                            0, VOCAB, (BUCKETS[-1],)))
    engine.close()
    return launches


def check_small_moe_against_host(dev):
    """4g.2: a 2-layer f32 MoE LM (top-2 of 4 experts) served on the card
    (kernels) and on the host (plain versions) from the same fan-in scaled
    weights, float, int8 and int4 weights at ``matmul_impl="dense"`` and
    ``"pallas"``: prefill logits within 1e-3 (sums in other orders) and
    greedy tokens equal."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import Decoder
    symbol = get_transformer_lm(97, num_layers=2, embed_dim=64, num_heads=4,
                                num_experts=4, moe_top_k=2)
    shapes = {"data": (1, 64), "softmax_label": (1, 64)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(2)
    params = {n: (rng.randn(*sh) * (1.5 / np.sqrt(sh[-1]) if len(sh) >= 2
                                    else 0.1)
                  + (n.endswith("_gamma"))).astype(np.float32)
              for n, sh in zip(symbol.list_arguments(), arg_shapes)
              if n not in shapes}
    prompt = np.random.RandomState(3).randint(0, 97, (2, 11))
    for wd in ("float", "int8", "int4"):
        for mm in ("dense", "pallas"):
            out = {}
            for where in (dev, "cpu"):
                d = Decoder(symbol, params, max_len=64, device=where,
                            weight_dtype=wd, matmul_impl=mm)
                logits, _ = d.prefill(d.init_cache(2), prompt)
                out[str(where)] = (logits.cpu(),
                                   d.generate(prompt, 20).cpu())
            (lg, tg), (lh, th) = out[str(dev)], out["cpu"]
            err = (lg - lh).abs().max().item()
            if err > 1e-3 or not torch.equal(tg, th):
                raise AssertionError(
                    "phase 4g small MoE LM %s %s: card and host disagree "
                    "(max |logit err| %.3g, tokens equal %s)" % (
                        wd, mm, err, torch.equal(tg, th)))
            log("phase 4g small MoE LM (2 layers, top-2 of 4) %s weights, "
                "%s products: card vs host prefill logits max |err| %.3g, "
                "greedy tokens equal (%d distinct)" % (
                    wd, mm, err, len(set(tg[:, 11:].flatten().tolist()))))


def moe_ep(K, dec, dev, work):
    """4g.3: ep=2 on ``build_mesh({"expert": 2, "model": 1}, [card] * 2)``
    and ep=2, tp=2 on ``[card] * 4`` against ep=1 from the same weights,
    unfused products (``MOE_MM``), one wave each in turns after a warm-up:
    every stream equal to ep=1's (two of which equal ``Decoder.generate``),
    each rank's stacks its own allocation of MOE_X/EP experts, exact
    launches, equal compile counts; tokens/s over ep=1's and the idle
    decode round's card ms. Returns the launches and ep=1's streams."""
    from mxnet_tpu_torch.parallel import build_mesh
    meshes = {(EP, 1): build_mesh({"expert": EP, "model": 1}, [dev] * EP),
              (EP, 2): build_mesh({"expert": EP, "model": 2}, [dev] * 2 * EP)}
    engines = {(1, 1): _engine_4c(dec)}
    for (ep, tp), mesh in meshes.items():
        engines[(ep, tp)] = _engine_4c(dec, mesh=mesh, ep=ep)
        _check_expert_shards(engines[(ep, tp)], dev,
                             "phase 4g ep=%d tp=%d" % (ep, tp))
    for e in engines.values():
        _warm(e)
    s0 = {k: dict(e.stats) for k, e in engines.items()}
    K.reset_launch_counts()
    runs = {k: _serve_wave(e, work) for k, e in engines.items()}
    launches = K.launch_counts()
    want = dict.fromkeys(launches, 0)
    share = {}
    for (ep, tp), e in engines.items():
        for k_, n in _moe_launches(_delta(e, s0[(ep, tp)]), ep=ep,
                                   tp=tp).items():
            want[k_] = want.get(k_, 0) + n
            share.setdefault("ep=%d tp=%d" % (ep, tp), {})[k_] = n
    if launches != want:
        raise AssertionError("phase 4g ep: launch counts %r, the waves want "
                             "%r" % (launches, want))
    ref = runs[(1, 1)][0]
    _equal_generate("phase 4g ep=1", dec, (ref[0], max(
        ref[1:], key=lambda h: len(h.prompt))))
    for k, (handles, _) in runs.items():
        _equal_streams("phase 4g ep=%d tp=%d" % k, handles, ref)
        if engines[k].compile_counts != engines[(1, 1)].compile_counts:
            raise AssertionError("phase 4g ep=%d tp=%d: compile_counts %r"
                                 % (k + (engines[k].compile_counts,)))
    check_compile_counts(engines[(1, 1)], "phase 4g ep=1")
    tps = {k: _wave_metrics(*r)[0] for k, r in runs.items()}
    cards = {k: _card_ms(e._program("decode").run)
             for k, e in engines.items()}
    log("phase 4g ep: one wave at each of ep=1, ep=%d and ep=%d tp=2 in "
        "turns, unfused products; every stream equals ep=1's (two equal "
        "Decoder.generate); each rank's gate and stacks (values and scales) "
        "an allocation of %d experts; compile_counts equal; launches %s" % (
            EP, EP, MOE_X // EP, json.dumps(share)))
    for k in engines:
        log("phase 4g ep=%d tp=%d (%s): %.1f tokens/s, %.4f of ep=1's; the "
            "idle decode round (%d steps) wall %.3f ms, card %.3f ms = %.4f "
            "ms a step; %s" % (
                k[0], k[1], EP_NOTE if k != (1, 1) else "one rank", tps[k],
                tps[k] / tps[(1, 1)], STEPS_PER_ROUND, cards[k][0],
                cards[k][1], cards[k][1] / STEPS_PER_ROUND, card_line()))
    for e in engines.values():
        e.close()
    return launches, [h.tokens for h in ref]


def moe_gauntlet_and_restore(K, dec, dev, work, streams):
    """4g.4: phase 4e(3)'s reuse gauntlet (the 160 MiB prefix pool,
    ``prefill_chunk=256``, n-gram ``spec_k=4``) at ep=1 and ep=2: the wave
    twice on each (the first builds every program), the second counted:
    streams, prefix hits and accepted drafts equal, exact launches. Then
    an ep=2 snapshot 6 rounds into phase 4's wave restored at ep=1: the
    donor's and the restored engine's streams equal ep=1's. Returns the
    launches."""
    from mxnet_tpu_torch.parallel import build_mesh
    from mxnet_tpu_torch.serving import InferenceEngine
    mesh = build_mesh({"expert": EP, "model": 1}, [dev] * EP)
    gwork = _gauntlet_work(44)
    kw = dict(prefix_cache_mb=POOL_MB, prefill_chunk=CHUNK, draft="ngram",
              spec_k=SPEC_K)
    total, out, deltas = {}, {}, {}
    for ep in (1, EP):
        e = _engine_4c(dec, **(dict(kw, mesh=mesh, ep=ep) if ep > 1 else kw))
        _serve_wave(e, gwork)
        _build(e, ("decode", "verify"))
        s0 = dict(e.stats)
        K.reset_launch_counts()
        out[ep] = _serve_wave(e, gwork)
        deltas[ep] = d = _delta(e, s0)
        for k_, n in _check_launches(K, "phase 4g gauntlet ep=%d" % ep,
                                     _moe_launches(d, ep=ep,
                                                   spec=True)).items():
            total[k_] = total.get(k_, 0) + n
        e.close()
        free_programs()
    _equal_streams("phase 4g gauntlet ep=%d" % EP, out[EP][0], out[1][0])
    keys = ("prefix_hits", "prefix_hit_tokens", "prefill_chunks",
            "spec_rounds", "spec_accepted", "tokens")
    if any(deltas[1][k] != deltas[EP][k] for k in keys) \
            or deltas[EP]["prefix_hits"] < 5 \
            or deltas[EP]["spec_accepted"] < 1:
        raise AssertionError("phase 4g gauntlet: stats %r at ep=%d, %r at "
                             "ep=1" % ({k: deltas[EP][k] for k in keys}, EP,
                                       {k: deltas[1][k] for k in keys}))
    log("phase 4g gauntlet (prefix pool, prefill_chunk=%d, n-gram spec_k=%d)"
        ": %d streams equal at ep=%d and ep=1; %s equal; tokens/s %.1f at "
        "ep=%d, %.1f at ep=1 (%s); launches %s" % (
            CHUNK, SPEC_K, len(gwork), EP,
            json.dumps({k: deltas[EP][k] for k in keys}),
            _wave_metrics(*out[EP])[0], EP, _wave_metrics(*out[1])[0],
            EP_NOTE, json.dumps({e: n for e, n in total.items() if n})))
    eng = _engine_4c(dec, mesh=mesh, ep=EP)
    hs = [eng.submit(p, max_tokens=b) for p, b in work]
    for _ in range(6):
        eng.step()
    snap = eng.snapshot()
    new, handles = InferenceEngine.restore(snap, dec, ep=1)
    new.serve_forever()
    eng.serve_forever()
    for what, got in (("donor", hs),
                      ("restored", [handles.get(h.id, h) for h in hs])):
        for h, s_ in zip(got, streams):
            if not h.done or h.tokens != s_:
                raise AssertionError("phase 4g snapshot at ep=%d (%s): "
                                     "request %s differs from ep=1's"
                                     % (EP, what, h.id))
    log("phase 4g snapshot at ep=%d 6 rounds in (%d requests with tokens), "
        "restored at ep=%d: every stream of the donor and the restored "
        "engine equals ep=1's" % (
            EP, sum(1 for r in snap["requests"] if r["tokens"]), new.ep))
    eng.close()
    new.close()
    return total


def moe_main_path(K, dev, work):
    """Phase 4g: the MoE LM (phase 4's 124M LM with every block a MoE
    block of MOE_X experts, top-MOE_K) saved with ``save_checkpoint`` and
    served. Returns the launches it counted."""
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.parallel import Decoder
    t_phase = time.perf_counter()
    symbol = _moe_symbol()
    ckpt = os.path.join(HERE, "build", "smoke_ckpt")
    os.makedirs(ckpt, exist_ok=True)
    prefix = os.path.join(ckpt, "moe124m")
    t0 = time.perf_counter()
    params = _lm_params(symbol, MAX_LEN, 0)
    n_params = sum(v.size for v in params.values())
    save_checkpoint(prefix, 0, symbol, params, {})
    del params
    log("phase 4g: MoE LM (%d layers, E=%d, %d heads, %d experts of %d, "
        "top-%d, vocab %d): %.1f M parameters, checkpointed in %.1f s" % (
            LAYERS, EMBED, HEADS, MOE_X, 4 * EMBED, MOE_K, VOCAB,
            n_params / 1e6, time.perf_counter() - t0))
    total = {}

    def add(launches):
        for e, n in launches.items():
            total[e] = total.get(e, 0) + n
        free_programs()
    add(moe_wave(K, dev, prefix, work))
    check_small_moe_against_host(dev)
    dec = Decoder.from_checkpoint(prefix, 0, MAX_LEN, attn_impl="paged",
                                  weight_dtype="int8", matmul_impl=MOE_MM,
                                  compute_dtype="bfloat16", device=dev)
    launches, streams = moe_ep(K, dec, dev, work)
    add(launches)
    add(moe_gauntlet_and_restore(K, dec, dev, work, streams))
    del dec
    free_programs()
    log("phase 4g: every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t_phase,
        json.dumps({e: n for e, n in total.items() if n})))
    return total


# -- phase 5: the training main path -----------------------------------------

TRAIN_B, TRAIN_T = 8, 1024          # bench.py:214 bench_transformer_lm
WARM_STEPS, TIMED_STEPS = 3, 12
TRAIN_ENTRIES = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "fused_linear")
# card vs host after one f32 step from the same weights (TF32 off on the
# card). The step's softmax output: within PROB_REL of its largest value
# (sums in other orders). The parameter deltas, per tensor:
# ||delta_card - delta_host|| / ||delta_host|| <= DELTA_REL, and every
# element within ELEM_REL of the tensor's largest delta. Both are far
# looser than f32 rounding because of the ReLU kink: a pre-activation
# within an ulp of zero lands on either side under any change of
# summation order, which flips that unit's derivative, rewrites its row of
# the ffn1 gradient and moves every gradient below it. Two correct host
# implementations (plain flash attention against dense attention) differ
# by up to 3.8e-3 per tensor in the norm and 0.040 of the largest element;
# a wrong kernel moves whole tensors by O(1)
PROB_REL = 1e-4
DELTA_REL = 2e-2
ELEM_REL = 0.1


def _lm_train_loss(outs, label):
    """Mean -log p[label] of the [B, V, T] softmax output."""
    p = outs[0].float()
    return -torch.log(p.gather(1, label[:, None, :]).clamp_min(1e-30)
                      ).mean().item()


def _train_batch(seed, b, t):
    rs = np.random.RandomState(seed)
    return {"data": rs.randint(0, VOCAB, (b, t)).astype(np.int32),
            "softmax_label": rs.randint(0, VOCAB, (b, t)).astype(np.int32)}


def _trainer(dev, b, t, compute_dtype):
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer
    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS, impl="flash")
    return ParallelTrainer(
        symbol, {"data": (b, t), "softmax_label": (b, t)}, optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        compute_dtype=compute_dtype, seed=0, device=dev).init_params()


def train_main_path(K, dev):
    """The 124M LM trained by ParallelTrainer(device=None) in bf16 at
    B=8, T=1024 on one repeated seeded batch: WARM_STEPS steps, then
    TIMED_STEPS steps with the launch counters zeroed just before and read
    just after. Returns the launch counts of the timed steps."""
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(None, TRAIN_B, TRAIN_T, "bfloat16")
    if trainer.device != dev:
        raise AssertionError("device=None resolved to %s" % trainer.device)
    batch = _train_batch(7, TRAIN_B, TRAIN_T)
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(_lm_train_loss(trainer.step(batch), label))
    torch.cuda.synchronize()
    log("train: 124M LM (%d layers, E=%d, %d heads, vocab %d), B=%d T=%d "
        "bf16, SGD lr 1e-3 momentum 0.9; %d warm-up steps in %.1f s" % (
            LAYERS, EMBED, HEADS, VOCAB, TRAIN_B, TRAIN_T, WARM_STEPS,
            time.perf_counter() - t0))
    K.reset_launch_counts()
    secs, queued = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        outs = trainer.step(batch)
        queued.append(time.perf_counter() - t0)   # the host's part
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(_lm_train_loss(outs, label))
    launches = K.launch_counts()
    mem = memory()
    want = dict.fromkeys(launches, 0)
    want.update({e: LAYERS * TIMED_STEPS for e in TRAIN_ENTRIES})
    if launches != want:
        raise AssertionError("train launch counts %r, the main path wants %r"
                             % (launches, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.01:
        raise AssertionError("the loss on the repeated batch did not fall: "
                             "%r" % losses)
    tokens = TRAIN_B * TRAIN_T
    tps = [tokens / s for s in secs]
    REPORT["sgd_step_ms"] = statistics.median(secs) * 1e3
    n_params = LAYERS * (12 * EMBED * EMBED) + VOCAB * EMBED
    flops_per_tok = 6.0 * n_params + 12.0 * LAYERS * EMBED * TRAIN_T
    med = statistics.median(tps)
    log("train: %d timed steps; tokens/s median %.1f (min %.1f, max %.1f); "
        "ms per step median %.3f (min %.3f, max %.3f); MFU %.4f (%.4g "
        "FLOP per token, bench.py:231-236, over 989 TFLOP/s); memory since "
        "the trainer was built: %s; %s" % (
            TIMED_STEPS, med, min(tps), max(tps),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            med * flops_per_tok / 989e12, flops_per_tok, mem,
            card_line()))
    log("train: step() returns to the host after %.3f ms (median; min "
        "%.3f, max %.3f); the card finishes the step %.3f ms after it "
        "began (median); where the two are close, the host bounds the "
        "step" % (
            statistics.median(queued) * 1e3, min(queued) * 1e3,
            max(queued) * 1e3, statistics.median(secs) * 1e3))
    log("train: loss over the %d steps %s" % (
        len(losses), " ".join("%.4f" % v for v in losses)))
    log("train launches: %s" % json.dumps(launches))
    profile_train(trainer, batch)
    time_train_uncaptured(trainer, batch, secs)
    check_train_capture(trainer, batch, outs)
    return launches


def time_train_uncaptured(trainer, batch, captured_secs, steps=5):
    """The same step through ``Program._run_eager`` (uncaptured, over the
    same buffers): ``steps`` steps' wall time and the host's part, beside
    the captured steps' wall time; then a 2-step profile of it."""
    prog = trainer._step_program(batch, "step")

    def eager_step():
        trainer._next_lr()
        return [o.clone() for o in prog._run_eager()]

    eager_step()
    torch.cuda.synchronize()
    secs, queued = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        eager_step()
        queued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log("train uncaptured (Program._run_eager): ms per step median %.3f "
        "(min %.3f, max %.3f), the host's part %.3f; captured: %.3f; %s" % (
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            statistics.median(queued) * 1e3,
            statistics.median(captured_secs) * 1e3, card_line()))
    profile_train(trainer, batch, trace=None, what="train uncaptured",
                  call=eager_step)


def check_train_capture(trainer, batch, outs, n=3):
    """From the same parameters (``set_params``, zero momentum), one
    captured step and one uncaptured step (``Program._run_eager``) must
    give the same parameters bitwise; ``multi_step(batch, n)`` the same
    bitwise as ``n`` captured ``step()``s. Then the cost of ``step()``'s
    output copy (CUDA events), and TIMED_STEPS steps as one
    ``multi_step`` (wall time per step)."""
    init, _ = trainer.get_params()
    prog = trainer._step_program(batch, "step")

    def after(run):
        trainer.set_params(init)
        run()
        torch.cuda.synchronize()
        return trainer._flat.clone()

    def eager():
        trainer._next_lr()
        prog._run_eager()

    cap = after(lambda: trainer.step(batch))
    eag = after(eager)
    if not torch.equal(cap, eag):
        raise AssertionError(
            "a captured train step and an uncaptured one from the same "
            "parameters differ: max |diff| %.3g" % (cap - eag).abs().max())
    steps = after(lambda: [trainer.step(batch) for _ in range(n)])
    multi = after(lambda: trainer.multi_step(batch, n))
    if not torch.equal(steps, multi):
        raise AssertionError(
            "multi_step(batch, %d) and %d captured steps differ: max |diff| "
            "%.3g" % (n, n, (steps - multi).abs().max()))
    copy_ms = Timer(trainer.device)(lambda: [o.clone() for o in outs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.multi_step(batch, TIMED_STEPS)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / TIMED_STEPS
    log("train capture: a captured step equals an uncaptured one bitwise "
        "(%d parameters); multi_step(batch, %d) equals %d captured steps "
        "bitwise; step()'s output copy (%.1f MB) %.4f ms; multi_step(batch, "
        "%d) %.3f ms per step; %s" % (
            cap.numel(), n, n, nbytes(*outs) / 1e6, copy_ms, TIMED_STEPS,
            per * 1e3, card_line()))


def profile_train(trainer, batch, steps=2, trace="train_trace.json",
                  what="train", call=None):
    """Where a train step's time goes: ``steps`` calls of ``call`` (a
    train step by default) under torch.profiler. Prints the wall and card
    kernel time per step, the card's busy share (kernel time / wall time),
    and the kernels by device time; the trace is written beside the other
    traces unless ``trace`` is None. Returns (wall ms, kernel ms, busy
    share) per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call = call or (lambda: trainer.step(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    calls = host_calls(prof)
    log("%s profile: %d steps; wall %.3f ms per step, card kernels %.3f "
        "ms per step, busy share %.3f, idle share %.3f; host calls per "
        "step %.1f %s" % (
            what, steps, wall * 1e3 / steps, busy_us / 1e3 / steps,
            busy_us / 1e6 / wall, 1.0 - busy_us / 1e6 / wall,
            sum(calls.values()) / steps, json.dumps(calls)))
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log("  %-60s %8.3f ms per step  %5d calls" % (
            key[:60], us / 1e3 / steps, n))
    result = (wall * 1e3 / steps, busy_us / 1e3 / steps, busy_us / 1e6 / wall)
    if trace is None:
        return result
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, trace))
    return result


def check_train_against_host(dev, b=1, t=128):
    """The 124M LM with the same seeded initial weights takes one f32
    step at B=1, T=128 on the card (the kernels) and on the host (their
    plain versions): the softmax outputs agree within PROB_REL and every
    parameter's delta within DELTA_REL and ELEM_REL (see above)."""
    batch = _train_batch(11, b, t)
    res = {}
    for where in (dev, "cpu"):
        tr = _trainer(where, b, t, None)
        before = {n: v.clone() for n, v in tr.params.items()}
        probs = tr.step(batch)[0].cpu()
        res[str(where)] = (probs, {n: (tr.params[n] - before[n]).cpu()
                                   for n in before})
    (pc, card), (ph, host) = res[str(dev)], res["cpu"]
    perr = (pc - ph).abs().max().item() / ph.abs().max().item()
    rows = []
    for n, dh in host.items():
        fro = ((card[n] - dh).norm() / dh.norm()).item()
        top = ((card[n] - dh).abs().max() / dh.abs().max()).item()
        rows.append((fro, top, n))
    rows.sort(reverse=True)
    if not perr <= PROB_REL or not all(r[0] <= DELTA_REL and r[1] <= ELEM_REL
                                       for r in rows):
        raise AssertionError(
            "card vs host step: softmax output %.3g of its max (gate %g); "
            "worst deltas (norm, largest element) %s (gates %g, %g)" % (
                perr, PROB_REL,
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL, ELEM_REL))
    worst_elem = max(rows, key=lambda r: r[1])
    log("train card vs host: one f32 step of the 124M LM at B=%d T=%d; "
        "softmax output max |err| %.3g of its max (gate %g); %d parameter "
        "deltas agree, worst in norm %s %.3g (gate %g), worst element %s "
        "%.3g of its largest delta (gate %g)" % (
            b, t, perr, PROB_REL, len(rows), rows[0][2], rows[0][0],
            DELTA_REL, worst_elem[2], worst_elem[1], ELEM_REL))


# -- phase 5b: training the mixture-of-experts LM -----------------------------

MOE_TIMED_STEPS = 6


def _moe_trainer(dev, b, t, compute_dtype, layers=LAYERS):
    from mxnet_tpu_torch.parallel import ParallelTrainer
    return ParallelTrainer(
        _moe_symbol(layers), {"data": (b, t), "softmax_label": (b, t)},
        optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        compute_dtype=compute_dtype, seed=0, device=dev).init_params()


def moe_flops_per_token(t=TRAIN_T):
    """The step's FLOP per token by ``bench.py:231-236``'s count (6 per
    parameter a token and 12 L E T for the attention scores), over the MoE
    LM's parameters: each layer's attention (4 E^2), gate (X E) and every
    expert's two products (2 X E H, static routing computes every expert
    for every token), and the embedding (V E). A stated count, not a
    measured one."""
    h = 4 * EMBED
    n_params = LAYERS * (4 * EMBED * EMBED + MOE_X * EMBED
                         + 2 * MOE_X * EMBED * h) + VOCAB * EMBED
    return 6.0 * n_params + 12.0 * LAYERS * EMBED * t


def moe_train_path(K, dev):
    """Phase 5b: the MoE LM (``impl="flash"``) trained by
    ``ParallelTrainer(device=None)`` in bf16 over f32 masters, SGD lr 1e-3
    momentum 0.9, at B=8, T=1024 on one repeated seeded batch: WARM_STEPS
    steps, then MOE_TIMED_STEPS with the counters zeroed just before and
    read just after: per step LAYERS launches of each flash entry and one
    ``fused_linear`` a FullyConnected -> Activation chain of the graph
    (``FusionPlan``; a MoE block has none); the loss must fall. Returns the
    launches."""
    from mxnet_tpu_torch.ops.fusion import FusionPlan
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = _moe_trainer(None, TRAIN_B, TRAIN_T, "bfloat16")
    if trainer.device != dev:
        raise AssertionError("device=None resolved to %s" % trainer.device)
    symbol = trainer.symbol
    plan = FusionPlan(symbol._topo(), symbol._heads)
    fc_act = sum(1 for kind, _ in plan.chains.values() if kind == "fc_act")
    batch = _train_batch(7, TRAIN_B, TRAIN_T)
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(_lm_train_loss(trainer.step(batch), label))
    torch.cuda.synchronize()
    log("phase 5b: MoE LM (%d layers, E=%d, %d experts of %d, top-%d), "
        "B=%d T=%d bf16, SGD lr 1e-3 momentum 0.9; built and %d warm-up "
        "steps in %.1f s" % (LAYERS, EMBED, MOE_X, 4 * EMBED, MOE_K,
                             TRAIN_B, TRAIN_T, WARM_STEPS,
                             time.perf_counter() - t0))
    K.reset_launch_counts()
    secs = []
    for _ in range(MOE_TIMED_STEPS):
        t0 = time.perf_counter()
        outs = trainer.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(_lm_train_loss(outs, label))
    launches = _check_launches(K, "phase 5b", dict(
        {e: LAYERS * MOE_TIMED_STEPS for e in TRAIN_ENTRIES[:3]},
        fused_linear=fc_act * MOE_TIMED_STEPS))
    mem = memory()
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.01:
        raise AssertionError("phase 5b: the loss on the repeated batch did "
                             "not fall: %r" % losses)
    tps = [TRAIN_B * TRAIN_T / s for s in secs]
    med = statistics.median(tps)
    fpt = moe_flops_per_token()
    log("phase 5b: %d timed steps; tokens/s median %.1f (min %.1f, max "
        "%.1f); ms per step median %.3f (min %.3f, max %.3f); MFU %.4f "
        "(%.4g FLOP per token stated, %.4g a step, over 989 TFLOP/s); "
        "memory since the trainer was built: %s; loss %s; launches %s "
        "(%d fused_linear chains in the graph); %s" % (
            MOE_TIMED_STEPS, med, min(tps), max(tps),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            med * fpt / 989e12, fpt, fpt * TRAIN_B * TRAIN_T, mem,
            " ".join("%.4f" % v for v in losses),
            json.dumps({e: n for e, n in launches.items() if n}), fc_act,
            card_line()))
    profile_train(trainer, batch, trace=None, what="phase 5b MoE train")
    del trainer, outs
    free_programs()
    check_moe_train_against_host(dev)
    log("phase 5b: every check passed in %.1f s" % (
        time.perf_counter() - t_phase))
    return launches


def check_moe_train_against_host(dev, b=1, t=128, layers=2):
    """A 2-layer MoE LM at full width with the same seeded initial weights
    takes one f32 step at B=1, T=128 on the card (the kernels) and on the
    host (their plain versions): the softmax outputs agree within PROB_REL
    and every parameter's delta within DELTA_REL by per-tensor norm (the
    ReLU kink and near-tied routing move single elements, so the largest
    element's share is reported, not gated)."""
    batch = _train_batch(11, b, t)
    res = {}
    for where in (dev, "cpu"):
        tr = _moe_trainer(where, b, t, None, layers)
        before = {n: v.clone() for n, v in tr.params.items()}
        probs = tr.step(batch)[0].cpu()
        res[str(where)] = (probs, {n: (tr.params[n] - before[n]).cpu()
                                   for n in before})
        del tr
    (pc, card), (ph, host) = res[str(dev)], res["cpu"]
    perr = (pc - ph).abs().max().item() / ph.abs().max().item()
    rows = sorted((((card[n] - dh).norm() / dh.norm()).item(),
                   ((card[n] - dh).abs().max() / dh.abs().max()).item(), n)
                  for n, dh in host.items())[::-1]
    if not perr <= PROB_REL or not all(r[0] <= DELTA_REL for r in rows):
        raise AssertionError(
            "phase 5b card vs host step: softmax output %.3g of its max "
            "(gate %g); worst deltas (norm, largest element) %s (gate %g)"
            % (perr, PROB_REL,
               ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
               DELTA_REL))
    worst_elem = max(rows, key=lambda r: r[1])
    log("phase 5b card vs host: one f32 step of the %d-layer MoE LM at B=%d "
        "T=%d; softmax output max |err| %.3g of its max (gate %g); %d "
        "parameter deltas agree, worst in norm %s %.3g (gate %g), worst "
        "element %s %.3g of its largest delta (reported)" % (
            layers, b, t, perr, PROB_REL, len(rows), rows[0][2], rows[0][0],
            DELTA_REL, worst_elem[2], worst_elem[1]))


# -- phase 5c: the LM trained as users train it -------------------------------

FIT_BATCHES, FIT_EPOCHS, FIT_WARMUP = 24, 2, 4
MARKOV_SUCC = 4
# GPT-3 Small's recipe (Brown et al. 2020, Table 2.1 and Appendix B): AdamW
# beta1 0.9, beta2 0.95, eps 1e-8, weight decay 0.1; peak lr 6e-4 after a
# linear warmup, cosine decay to 10%; global-norm clip 1.0
GPT3_ADAMW = dict(learning_rate=6e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
                  wd=0.1)
CAPTURE_STEPS = 4
# the optimizers' functional updates, card against host, f32: elementwise
# arithmetic (FMA contraction, pow) and AdaFactor's means summed in other
# orders; |card - host| <= OPT_ATOL + OPT_RTOL * |host| on the weights
# (~N(0, 1)) and every state leaf
OPT_ATOL, OPT_RTOL = 1e-6, 1e-5
# the 9 optimizers of optimizer.py (ccSGD is SGD's math), at the settings
# the functional check runs
OPTIMIZERS_5C = [
    ("sgd", dict(learning_rate=0.01, momentum=0.9, wd=0.01)),
    ("sgld", dict(learning_rate=0.01)),  # no wd: the noise stays apart
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adamw", dict(GPT3_ADAMW)),
    ("adafactor", dict(learning_rate=0.01, beta1=0.9, wd=0.01)),
    ("adagrad", dict(learning_rate=0.05, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01)),
    ("adadelta", dict(wd=0.01)),
    ("test", dict(rescale_grad=0.5)),
]
REPORT = {}


def markov_batches(seed, n, t, succ=MARKOV_SUCC):
    """``n`` rows of an order-1 Markov chain over the vocabulary (each
    token has ``succ`` successors, drawn from the seed), as token ids
    ``[n, t]`` and the labels shifted by one: a stream whose loss can fall
    from ln(VOCAB) toward ln(succ)."""
    vocab = VOCAB
    rs = np.random.RandomState(seed)
    nxt = rs.randint(0, vocab, (vocab, succ))
    seq = np.empty((n, t + 1), np.int64)
    seq[:, 0] = rs.randint(0, vocab, n)
    for i in range(1, t + 1):
        seq[:, i] = nxt[seq[:, i - 1], rs.randint(0, succ, n)]
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def _recipe_trainer(dev, b, t, compute_dtype, layers=None,
                    optimizer="adamw", optimizer_params=None):
    """The 124M LM ending in ``loss_layout="ce"``, trained with the GPT-3
    recipe (or ``optimizer``): ``rescale_grad`` 1/(B T) (the clip bounds
    the mean token's gradient), the cosine schedule over the phase's
    FIT_EPOCHS x FIT_BATCHES steps, the clip at 1.0, seed 0."""
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer
    symbol = get_transformer_lm(VOCAB, num_layers=layers or LAYERS,
                                embed_dim=EMBED, num_heads=HEADS,
                                impl="flash", loss_layout="ce")
    params = dict(GPT3_ADAMW if optimizer_params is None
                  else optimizer_params)
    params.setdefault("rescale_grad", 1.0 / (b * t))
    params.setdefault("lr_scheduler", CosineScheduler(
        FIT_EPOCHS * FIT_BATCHES, final_lr=6e-5, warmup_steps=FIT_WARMUP))
    return ParallelTrainer(
        symbol, {"data": (b, t), "softmax_label": (b, t)},
        optimizer=optimizer, optimizer_params=params,
        compute_dtype=compute_dtype, clip_grad_norm=1.0, seed=0,
        device=dev).init_params()


def _param_count(symbol):
    arg_shapes, _, _ = symbol.infer_shape(data=(1, TRAIN_T),
                                          softmax_label=(1, TRAIN_T))
    return sum(int(np.prod(s)) for n, s in zip(symbol.list_arguments(),
                                               arg_shapes)
               if n not in ("data", "softmax_label"))


def _sizes(*paths):
    return sum(os.path.getsize(p) for p in paths)


def fit_main_path(K, dev):
    """Phase 5c: the 124M LM trained as users train it, through
    ``ParallelTrainer(device=None).fit``: each check on its own ``phase
    5c`` line. Returns the fit's launches."""
    import shutil
    t_phase = time.perf_counter()
    ckdir = os.path.join(HERE, "build", "ckpt5c")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    try:
        launches, final = fit_run(K, dev, os.path.join(ckdir, "lm"))
        free_programs()
        check_fit_resume(dev, os.path.join(ckdir, "lm"), final)
        del final
        free_programs()
        for name in ("adamw", "adafactor", "sgld"):
            check_capture_with_t(dev, name)
            free_programs()
        check_recipe_against_host(dev)
        check_optimizers_against_host(dev)
        check_ce_loss_against_host(dev)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log("phase 5c: every check passed in %.1f s" % (
        time.perf_counter() - t_phase))
    return launches


def fit_run(K, dev, prefix):
    """The configuration through ``fit``: an ``NDArrayIter`` of
    FIT_BATCHES Markov batches over FIT_EPOCHS epochs, ``device_metric``
    on ``metric.Loss()``, a ``Speedometer`` batch callback, and an
    epoch-end callback saving ``.params`` and ``.states`` (and, after the
    first epoch, a sharded checkpoint). One warm-up step builds the step
    program first; the parameters and the optimizer are then set back to
    their initial values and the counters zeroed. Gates: exact launches (a
    step: LAYERS of each flash entry, one ``fused_linear`` a
    FullyConnected -> Activation chain), every epoch's loss finite, the
    last below the first. Then tokens/s of ``fit`` with
    ``device_metric=False`` (one more epoch) and of 12 ``step()`` calls;
    the optimizer update's card time against its bound. Returns (the
    launches, the flat parameters after the FIT_EPOCHS epochs)."""
    from mxnet_tpu_torch import callback, metric
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.ops.fusion import FusionPlan
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = _recipe_trainer(None, TRAIN_B, TRAIN_T, "bfloat16")
    if trainer.device != dev:
        raise AssertionError("device=None resolved to %s" % trainer.device)
    data, label = markov_batches(17, FIT_BATCHES * TRAIN_B, TRAIN_T)
    first = {"data": data[:TRAIN_B], "softmax_label": label[:TRAIN_B]}
    init = trainer.get_params()
    trainer.step(first)
    trainer.set_params(*init)
    torch.cuda.synchronize()
    plan = FusionPlan(trainer.symbol._topo(), trainer.symbol._heads)
    fc_act = sum(1 for kind, _ in plan.chains.values() if kind == "fc_act")
    n_params = _param_count(trainer.symbol)
    log("phase 5c: 124M LM (%d layers, E=%d, %d heads, vocab %d, "
        "loss_layout=\"ce\", %d parameters), B=%d T=%d bf16 over f32 "
        "masters; AdamW lr 6e-4 beta2 0.95 wd 0.1, %d warmup steps then "
        "cosine to 6e-5 over %d, clip 1.0; order-1 Markov data (%d "
        "successors a token); built and warmed up in %.1f s" % (
            LAYERS, EMBED, HEADS, VOCAB, n_params, TRAIN_B, TRAIN_T,
            FIT_WARMUP, FIT_EPOCHS * FIT_BATCHES, MARKOV_SUCC,
            time.perf_counter() - t0))
    marks, ckpts, losses = {}, [], []

    def last_batch(param):
        if param.nbatch == FIT_BATCHES - 1:
            torch.cuda.synchronize()
            marks[("end", param.epoch)] = time.perf_counter()

    def on_epoch(epoch, symbol, arg, aux):
        losses.append(trainer.last_train_metric[1])
        t1 = time.perf_counter()
        blob = trainer.get_optimizer_states()
        t2 = time.perf_counter()
        save_checkpoint(prefix, epoch + 1, symbol, arg, aux,
                        optimizer_states=blob)
        t3 = time.perf_counter()
        row = dict(epoch=epoch + 1, states_s=t2 - t1, save_s=t3 - t2,
                   bytes=_sizes("%s-%04d.params" % (prefix, epoch + 1),
                                "%s-%04d.states" % (prefix, epoch + 1)))
        if epoch == 0:
            trainer.save_sharded_checkpoint(prefix + "-sharded")
            row["sharded_s"] = time.perf_counter() - t3
            row["sharded_bytes"] = _sizes(prefix + "-sharded-manifest.json",
                                          prefix + "-sharded-shards-p0.npz")
        ckpts.append(row)
        del blob
        marks[("start", epoch + 1)] = time.perf_counter()

    K.reset_launch_counts()
    marks[("start", 0)] = time.perf_counter()
    trainer.fit(NDArrayIter(data, label, batch_size=TRAIN_B),
                eval_metric=metric.Loss(), num_epoch=FIT_EPOCHS,
                batch_end_callback=[callback.Speedometer(TRAIN_B, 8),
                                    last_batch],
                epoch_end_callback=on_epoch, device_metric=True)
    launches = _check_launches(K, "phase 5c fit", dict(
        {e: LAYERS * FIT_EPOCHS * FIT_BATCHES for e in TRAIN_ENTRIES[:3]},
        fused_linear=fc_act * FIT_EPOCHS * FIT_BATCHES))
    final = trainer._flat.clone()
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError("phase 5c: the epochs' mean loss did not fall: "
                             "%r" % losses)
    tokens = FIT_BATCHES * TRAIN_B * TRAIN_T
    fit_s = marks[("end", 1)] - marks[("start", 1)]
    log("phase 5c fit: %d epochs of %d batches, device_metric=True on "
        "metric.Loss(): epoch mean loss %s (ln %d = %.3f, ln %d = %.3f); "
        "the second epoch %.3f s = %.1f tokens/s; launches %s (%d "
        "fused_linear chains in the graph); %s" % (
            FIT_EPOCHS, FIT_BATCHES, " ".join("%.4f" % v for v in losses),
            VOCAB, math.log(VOCAB), MARKOV_SUCC, math.log(MARKOV_SUCC),
            fit_s, tokens / fit_s,
            json.dumps({e: n for e, n in launches.items() if n}), fc_act,
            card_line()))
    for row in ckpts:
        log("phase 5c checkpoint after epoch %d: get_optimizer_states %.3f "
            "s, save_checkpoint (.params + .states) %.3f s, %d bytes%s" % (
                row["epoch"], row["states_s"], row["save_s"], row["bytes"],
                "" if "sharded_s" not in row else
                "; save_sharded_checkpoint %.3f s, %d bytes" % (
                    row["sharded_s"], row["sharded_bytes"])))
    # fit with the metric read on the host every batch: one more epoch
    marks.clear()
    t0 = time.perf_counter()
    trainer.fit(NDArrayIter(data, label, batch_size=TRAIN_B),
                eval_metric=metric.Loss(), num_epoch=1,
                batch_end_callback=last_batch, device_metric=False)
    host_s = marks[("end", 0)] - t0
    secs = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.step(first)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_tps = TRAIN_B * TRAIN_T / statistics.median(secs)
    fpt = 6.0 * (LAYERS * 12 * EMBED * EMBED + VOCAB * EMBED) \
        + 12.0 * LAYERS * EMBED * TRAIN_T
    log("phase 5c tokens/s: fit with device_metric=True %.1f (%.4f of "
        "step()'s), with device_metric=False %.1f (%.4f); %d timed step() "
        "calls %.1f (ms per step median %.3f, min %.3f, max %.3f; phase 5's "
        "SGD step of the \"reference\" layout %s ms); MFU of step() %.4f "
        "(%.4g FLOP per token, phase 5's count); memory since the trainer "
        "was built: %s; %s" % (
            tokens / fit_s, tokens / fit_s / step_tps, tokens / host_s,
            tokens / host_s / step_tps, TIMED_STEPS, step_tps,
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            "%.3f" % REPORT["sgd_step_ms"] if "sgd_step_ms" in REPORT
            else "not measured", step_tps * fpt / 989e12, fpt, memory(),
            card_line()))
    time_optimizer_update(trainer)
    profile_train(trainer, first, trace=None, what="phase 5c AdamW train")
    return launches, final


def time_optimizer_update(trainer):
    """The AdamW update of the trainer's 124M flat parameters alone, over
    copies of its buffers (``FlatOptState.update``, uncaptured): CUDA
    events (Timer) and a 2-call profile (card kernel time and kernels a
    call), beside its bound: it must read w, g, m and v and write w, m
    and v, 7 x 4 bytes a parameter, over 3.35 TB/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.parallel.optim import FlatOptState
    dev = trainer.device
    flat = trainer._flat.clone()
    shapes = [trainer.arg_shapes[n] for n in trainer.param_names]
    state = FlatOptState(trainer.optimizer, trainer.param_names, shapes,
                         flat)
    grad = torch.randn(flat.shape, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev) * 1e-4
    lr = torch.tensor(6e-4, device=dev)
    t = torch.tensor(10.0, device=dev)

    def update():
        state.update(flat, grad, lr, t)

    ms = Timer(dev)(update)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            update()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    card = sum(e.self_device_time_total for e in rows) / 2 / 1e3
    kernels = sum(e.count for e in rows) / 2
    n = flat.numel()
    bound, by = bound_ms(28 * n, 0, torch.float32)
    log("phase 5c AdamW update of %d parameters (FlatOptState.update, "
        "uncaptured): %.3f ms (CUDA events, median of %d), card kernels "
        "%.3f ms a call and %.1f kernels a call (2-call profile); bound "
        "%.3f ms (%s: 28 bytes a parameter over 3.35 TB/s), %.2fx it; "
        "%s" % (n, ms, TIMING_RUNS, card, kernels, bound, by, ms / bound,
                card_line()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log("  %-60s %8.3f ms a call  %4d calls" % (
            e.key[:60], e.self_device_time_total / 2 / 1e3, e.count))
    REPORT["adamw_update"] = dict(ms=ms, card_ms=card, kernels=kernels,
                                  bound_ms=bound)


def check_fit_resume(dev, prefix, final):
    """Crash and resume: with the epoch-2 ``.params`` gone (a crash before
    it was published), ``latest_checkpoint`` finds epoch 1; a fresh
    trainer loads its ``.params`` and ``.states`` and fits the second
    epoch; its parameters equal the uninterrupted run's bitwise. The same
    from the sharded checkpoint through ``resume_sharded_checkpoint``."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.model import (latest_checkpoint, load_checkpoint,
                                       load_optimizer_states)
    data, label = markov_batches(17, FIT_BATCHES * TRAIN_B, TRAIN_T)
    os.remove("%s-%04d.params" % (prefix, FIT_EPOCHS))
    epoch = latest_checkpoint(prefix)
    if epoch != FIT_EPOCHS - 1:
        raise AssertionError("latest_checkpoint found %r" % (epoch,))
    for how in ("whole", "sharded"):
        t0 = time.perf_counter()
        tr = _recipe_trainer(dev, TRAIN_B, TRAIN_T, "bfloat16")
        if how == "whole":
            _, arg, aux = load_checkpoint(prefix, epoch)
            tr.init_params(arg, aux)
            tr.set_optimizer_states(load_optimizer_states(prefix, epoch))
        elif tr.resume_sharded_checkpoint(prefix + "-sharded") \
                != FIT_BATCHES:
            raise AssertionError("resume_sharded_checkpoint: wrong step")
        t1 = time.perf_counter()
        tr.fit(NDArrayIter(data, label, batch_size=TRAIN_B),
               eval_metric=metric.Loss(), num_epoch=1, device_metric=True)
        torch.cuda.synchronize()
        if not torch.equal(tr._flat, final):
            raise AssertionError(
                "phase 5c %s resume: the parameters after the resumed "
                "epoch differ from the uninterrupted run's: max |diff| %.3g"
                % (how, (tr._flat - final).abs().max()))
        log("phase 5c resume (%s): epoch %d restored in %.3f s, the next "
            "epoch's parameters equal the uninterrupted run's bitwise (%d "
            "parameters); %s" % (how, epoch, t1 - t0, final.numel(),
                                 card_line()))
        del tr
        free_programs()


def check_capture_with_t(dev, name):
    """From the same parameters (``set_params``, the generator's state put
    back), CAPTURE_STEPS captured steps equal as many uncaptured ones
    (``Program._run_eager``) bitwise, parameters and optimizer state, with
    the lr and the update count t advancing each run; ``multi_step(batch,
    3)`` equals 3 ``step()`` calls bitwise. For AdamW also: the captured
    run differs from one whose t stays at 1 (the gate can fail)."""
    params = {"adamw": None,
              "adafactor": dict(learning_rate=1e-2, beta1=0.9, wd=0.1),
              "sgld": dict(learning_rate=1e-4, wd=0.1)}[name]
    tr = _recipe_trainer(dev, TRAIN_B, TRAIN_T, "bfloat16", optimizer=name,
                         optimizer_params=params)
    data, label = markov_batches(17, TRAIN_B, TRAIN_T)
    batch = {"data": data, "softmax_label": label}
    init = tr.get_params()
    gen0 = tr._gen.get_state()
    prog = tr._step_program(batch, "step")

    def after(run):
        tr.set_params(*init)
        tr._gen.set_state(gen0)
        run()
        torch.cuda.synchronize()
        return [tr._flat.clone()] + [b.clone() for b in tr._state.buffers()]

    def eager(n, frozen=False):
        for _ in range(n):
            tr._next_lr()
            if frozen:
                tr._tdev.fill_(1.0)
            prog._run_eager()

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    cap = after(lambda: [tr.step(batch) for _ in range(CAPTURE_STEPS)])
    eag = after(lambda: eager(CAPTURE_STEPS))
    if not equal(cap, eag):
        raise AssertionError(
            "phase 5c %s: %d captured steps and %d uncaptured ones from the "
            "same parameters differ: max |diff| %.3g" % (
                name, CAPTURE_STEPS, CAPTURE_STEPS,
                max((x - y).abs().max().item() for x, y in zip(cap, eag))))
    steps = after(lambda: [tr.step(batch) for _ in range(3)])
    multi = after(lambda: tr.multi_step(batch, 3))
    if not equal(steps, multi):
        raise AssertionError("phase 5c %s: multi_step(batch, 3) differs "
                             "from 3 step() calls" % name)
    extra = ""
    if name == "adamw":
        frozen = after(lambda: eager(CAPTURE_STEPS, frozen=True))
        diff = (frozen[0] - cap[0]).abs().max().item()
        if diff == 0:
            raise AssertionError("phase 5c: a run with t frozen at 1 gives "
                                 "the same parameters: t is not read")
        extra = "; t frozen at 1 moves the parameters by up to %.3g" % diff
    log("phase 5c capture (%s, %d state buffers): %d captured steps equal "
        "%d uncaptured ones bitwise (parameters and state; lr %s); "
        "multi_step(batch, 3) equals 3 step() calls bitwise%s; %s" % (
            name, len(tr._state.buffers()), CAPTURE_STEPS, CAPTURE_STEPS,
            " ".join("%.3g" % tr.optimizer.lr_scheduler(i + 1)
                     for i in range(CAPTURE_STEPS)), extra, card_line()))


def check_recipe_against_host(dev, b=1, t=128, layers=2):
    """One f32 step of the recipe (AdamW, the clip, "ce") of a 2-layer LM
    of the 124M's width at B=1, T=128, on the card and on the host from
    the same seeded weights: the per-token losses within PROB_REL of their
    largest, every parameter's delta within DELTA_REL by per-tensor norm
    (the ReLU-kink rule of phase 5)."""
    data, label = markov_batches(19, b, t)
    batch = {"data": data, "softmax_label": label}
    res = {}
    for where in (dev, "cpu"):
        tr = _recipe_trainer(where, b, t, None, layers=layers)
        before = {n: v.clone() for n, v in tr.params.items()}
        loss = tr.step(batch)[0].cpu()
        res[str(where)] = (loss, {n: (tr.params[n] - before[n]).cpu()
                                  for n in before})
        del tr
    (lc, card), (lh, host) = res[str(dev)], res["cpu"]
    lerr = (lc - lh).abs().max().item() / lh.abs().max().item()
    rows = _delta_rows(card, host)
    if not lerr <= PROB_REL or not all(r[0] <= DELTA_REL for r in rows):
        raise AssertionError(
            "phase 5c card vs host AdamW step: loss %.3g of its max (gate "
            "%g); worst deltas (norm, largest element) %s (gate %g)" % (
                lerr, PROB_REL,
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL))
    elem = max(rows, key=lambda r: r[1])
    log("phase 5c card vs host: one f32 AdamW step (clip 1.0, \"ce\") of "
        "the %d-layer LM at B=%d T=%d; per-token loss max |err| %.3g of its "
        "max (gate %g); %d parameter deltas agree, worst in norm %s %.3g "
        "(gate %g), worst element %s %.3g of its largest delta "
        "(reported)" % (layers, b, t, lerr, PROB_REL, len(rows), rows[0][2],
                        rows[0][0], DELTA_REL, elem[2], elem[1]))


def check_optimizers_against_host(dev, steps=3):
    """Each optimizer's functional update (the trainers' path: lr and t as
    0-dim f32 tensors) on a [257, 131] and a [131] weight, ``steps`` steps
    on the card and on the host from the same values: weights and state
    leaves within OPT_ATOL + OPT_RTOL |host|. SGLD's noise is each
    device's own draw, so its noise is taken out first (drawn again from a
    copy of the generator's state) and the rest compared."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.parallel.optim import make_functional
    rs = np.random.RandomState(23)
    shapes = [(257, 131), (131,)]
    w0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rs.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(steps)]
    worst = []
    for name, kw in OPTIMIZERS_5C:
        out = []
        for where in (dev, torch.device("cpu")):
            init, update = make_functional(opt_mod.create(name, **kw))
            ws = [torch.from_numpy(w.copy()).to(where) for w in w0]
            states = [init(w) for w in ws]
            gen = torch.Generator(device=where).manual_seed(5)
            noise = [torch.zeros_like(w) for w in ws]
            for k, step in enumerate(gs):
                lr = torch.tensor(0.01 * (k + 1), device=where)
                if name == "sgld":
                    replay = torch.Generator(device=where)
                    replay.set_state(gen.get_state())
                    for nz, w in zip(noise, ws):
                        nz += torch.randn(w.shape, generator=replay,
                                          device=where) * torch.sqrt(lr)
                update(ws, [torch.from_numpy(g).to(where) for g in step],
                       states, lr, torch.tensor(float(k + 1), device=where),
                       gen)
            out.append([w - nz for w, nz in zip(ws, noise)]
                       + [leaf for s in states for leaf in s])
        err = 0.0
        for got, want in zip(*out):
            g, w = got.cpu(), want
            e = (g - w).abs()
            if not torch.isfinite(g).all() \
                    or (e > OPT_ATOL + OPT_RTOL * w.abs()).any():
                raise AssertionError(
                    "phase 5c %s functional update, card vs host: max "
                    "|err| %.3g (atol %g, rtol %g)" % (
                        name, e.max().item(), OPT_ATOL, OPT_RTOL))
            err = max(err, e.max().item())
        worst.append("%s %.3g" % (name, err))
    log("phase 5c optimizers card vs host: %d functional steps at [257, "
        "131] and [131], weights and state leaves within atol %g rtol %g; "
        "max |err| %s" % (steps, OPT_ATOL, OPT_RTOL, ", ".join(worst)))


def check_ce_loss_against_host(dev):
    """``SoftmaxCELoss`` on the 124M LM's [B T, V] = [8192, 32000] bf16
    logits: the f32 loss and the bf16 gradient on the card against the
    same op on the host, at phase 3's tolerances for their dtypes; the
    forward's and the backward's card time (CUDA events) beside the
    bytes they must move (the forward reads the logits; the backward reads
    them and writes the gradient)."""
    from mxnet_tpu_torch.ops import registry as reg
    spec = reg.get("SoftmaxCELoss")
    p = spec.parse_params({})
    gen = torch.Generator(device=dev).manual_seed(29)
    logits = (torch.randn((TRAIN_B * TRAIN_T, VOCAB), generator=gen,
                          device=dev) * 2).to(torch.bfloat16)
    labels = torch.randint(0, VOCAB, (TRAIN_B * TRAIN_T,), generator=gen,
                           device=dev, dtype=torch.int32)
    res = []
    for x, lab in ((logits, labels), (logits.cpu(), labels.cpu())):
        d = x.detach().requires_grad_(True)
        out = spec.forward(p, [d, lab], [], True, None)[0][0]
        out.backward(torch.ones_like(out))
        res.append((out.detach().cpu(), d.grad.cpu()))
    (card_loss, card_grad), (host_loss, host_grad) = res
    e_loss = compare("SoftmaxCELoss loss", card_loss, host_loss)
    e_grad = compare("SoftmaxCELoss grad", card_grad, host_grad)
    timer = Timer(dev)
    d = logits.detach().requires_grad_(True)
    fwd_ms = timer(lambda: spec.forward(p, [d, labels], [], True, None))
    out = spec.forward(p, [d, labels], [], True, None)[0][0]
    ones = torch.ones_like(out)
    bwd_ms = timer(lambda: torch.autograd.grad(out, d, ones,
                                               retain_graph=True))
    fb, _ = bound_ms(nbytes(logits, labels, out), 0, torch.bfloat16)
    bb, _ = bound_ms(2 * nbytes(logits) + nbytes(labels), 0, torch.bfloat16)
    log("phase 5c SoftmaxCELoss [%d, %d] bf16, card vs host: loss max |err| "
        "%.3g (f32), gradient max |err| %.3g (bf16); forward %.4f ms (bound "
        "%.4f, bytes), backward %.4f ms (bound %.4f, bytes); %s" % (
            TRAIN_B * TRAIN_T, VOCAB, e_loss, e_grad, fwd_ms, fb, bwd_ms, bb,
            card_line()))


# -- phase 5d: the other parallelisms ------------------------------------------

PAR_DP = 2                          # ranks of the data-parallel mesh
PAR_PP, PAR_M = 4, 8                # pipeline stages and microbatches
PAR_WARM, PAR_TIMED = 3, 6
PIPE_WARM, PIPE_TIMED = 1, 2
FLASH_ENTRIES = TRAIN_ENTRIES[:3]
PAR_NOTE = "ranks on ONE card, not a multi-card figure"
PAR_BATCH = 13                      # the seed of the f32 agreement batch


def _par_symbol(stages=None, dropout=0.0):
    from mxnet_tpu_torch.models import get_transformer_lm
    return get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                              num_heads=HEADS, impl="flash",
                              pipeline_stages=stages, dropout=dropout)


def _par_trainer(dev, n, compute_dtype, optimizer="sgd", params=None, **kw):
    """The 124M LM's ParallelTrainer at B=8, T=1024, seed 0 (so every
    trainer starts from the same weights): on the mesh {dp: n} over
    [dev] * n, or on ``dev`` alone for n = 1."""
    from mxnet_tpu_torch.parallel import ParallelTrainer, build_mesh
    mesh = build_mesh({"dp": n}, [dev] * n) if n > 1 else None
    return ParallelTrainer(
        _par_symbol(), {"data": (TRAIN_B, TRAIN_T),
                        "softmax_label": (TRAIN_B, TRAIN_T)},
        optimizer=optimizer,
        optimizer_params=params or {"learning_rate": 1e-3,
                                    "momentum": 0.9},
        compute_dtype=compute_dtype, seed=0, mesh=mesh,
        device=None if mesh else dev, **kw).init_params()


def _all_flats(tr):
    """Every rank's stored parameters, one tensor."""
    if tr._sharded is None:
        return tr._flat.clone()
    return torch.cat([f.to(tr.device) for f in tr._sharded.flats])


def _deltas(after, before):
    return {n: after[n].float() - before[n].float() for n in before}


def _delta_gate(what, got, want):
    """Per-tensor delta agreement (``_delta_rows``) within DELTA_REL by
    norm; returns the worst row."""
    rows = _delta_rows(got, want)
    if not all(r[0] <= DELTA_REL for r in rows):
        raise AssertionError("%s: parameter deltas disagree: worst (norm, "
                             "largest element) %s (gate %g)" % (
                                 what, ["%s %.3g %.3g" % (n, f, e)
                                        for f, e, n in rows[:5]],
                                 DELTA_REL))
    return rows[0]


def _same(a, b):
    """(bitwise, worst per-tensor |a - b| over |b|'s largest value)."""
    eq = all(torch.equal(a[n], b[n]) for n in b)
    worst = max(((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(
        1e-30)).item() for n in b)
    return eq, worst


def _f32_reference(dev):
    """One f32 step of the one-device ParallelTrainer (fused_linear chains
    on) from its seeded weights, on the PAR_BATCH batch: (the batch, the
    weights, the deltas), on the host. The oracle of every phase 5d
    trainer's step: f32, where two correct implementations differ by the
    ReLU kink rule (DELTA_REL); in bf16 the rounding of two paths alone
    moves a LayerNorm gain's delta by a few percent."""
    batch = _train_batch(PAR_BATCH, TRAIN_B, TRAIN_T)
    ref = _par_trainer(dev, 1, None)
    init = ref.get_params()[0]
    ref.step(batch)
    want = _deltas(ref.get_params()[0], init)
    del ref
    free_programs()
    return batch, init, want


def par_dp(K, dev, ref):
    """Check 1: ParallelTrainer on {dp: 2} over [dev] * 2, bf16 over f32
    masters, SGD lr 1e-3 momentum 0.9, B=8 T=1024 (4 rows a rank): 3
    warm-up and 6 timed steps, exactly LAYERS x 2 launches of each flash
    entry a step and no fused_linear (no chain fuses on a multi-rank
    mesh), a falling loss; a captured step equal to an uncaptured one
    bitwise; then one f32 step of the same mesh trainer against the
    one-device f32 step (``_f32_reference``; deltas within DELTA_REL by
    norm). Returns the timed launches."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _par_trainer(dev, PAR_DP, "bfloat16")
    init = tr.get_params()
    batch = _train_batch(7, TRAIN_B, TRAIN_T)
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    losses = [_lm_train_loss(tr.step(batch), label)
              for _ in range(PAR_WARM)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    K.reset_launch_counts()
    secs = []
    for _ in range(PAR_TIMED):
        t1 = time.perf_counter()
        outs = tr.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        losses.append(_lm_train_loss(outs, label))
    launches = _check_launches(K, "phase 5d dp", {
        e: LAYERS * PAR_DP * PAR_TIMED for e in FLASH_ENTRIES})
    mem = memory()
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.01:
        raise AssertionError("phase 5d dp: the loss did not fall: %r"
                             % losses)
    tps = [TRAIN_B * TRAIN_T / s for s in secs]
    log("phase 5d dp: 124M LM through ParallelTrainer(mesh={dp: %d} over "
        "[%s] * %d; %s), B=%d T=%d bf16 over f32 masters, SGD lr 1e-3 "
        "momentum 0.9; built and %d warm-up steps in %.1f s; %d timed "
        "steps: tokens/s median %.1f (min %.1f, max %.1f), ms per step "
        "median %.3f (min %.3f, max %.3f); loss %s; launches a step %s; "
        "memory since the trainer was built: %s; %s" % (
            PAR_DP, dev, PAR_DP, PAR_NOTE, TRAIN_B, TRAIN_T, PAR_WARM,
            warm_s, PAR_TIMED, statistics.median(tps), min(tps), max(tps),
            statistics.median(secs) * 1e3, min(secs) * 1e3,
            max(secs) * 1e3, " ".join("%.4f" % v for v in losses),
            json.dumps({e: n // PAR_TIMED for e, n in launches.items()
                        if n}), mem, card_line()))
    # captured against uncaptured, from the same parameters
    prog = tr._step_program(batch, "step")

    def after(run):
        tr.set_params(*init)
        run()
        torch.cuda.synchronize()
        return _all_flats(tr)

    def eager():
        tr._next_lr()
        prog._run_eager()

    cap = after(lambda: tr.step(batch))
    eag = after(eager)
    if not torch.equal(cap, eag):
        raise AssertionError(
            "phase 5d dp: a captured step and an uncaptured one differ: "
            "max |diff| %.3g" % (cap - eag).abs().max())
    del cap, eag, tr, prog
    free_programs()
    rbatch, rinit, want = ref
    f32 = _par_trainer(dev, PAR_DP, None)
    f32.init_params(rinit)
    f32.step(rbatch)
    got = _deltas(f32.get_params()[0], rinit)
    del f32
    free_programs()
    worst = _delta_gate("phase 5d dp vs one device", got, want)
    log("phase 5d dp capture and agreement: a captured step equals an "
        "uncaptured one bitwise (%d parameters on %d ranks); one f32 step "
        "on the mesh against the one-device f32 step (fused_linear chains "
        "on): %d parameter deltas within %g by norm, worst %s %.3g "
        "(largest element %.3g of its largest delta)" % (
            2 * sum(v.numel() for v in init[0].values()), PAR_DP,
            len(got), DELTA_REL, worst[2], worst[0], worst[1]))
    return launches


def par_zero(K, dev):
    """Check 2: AdamW (GPT-3 Small's settings) at dp=2, 3 steps each of
    plain data parallelism, zero1 and fsdp from the same weights: each
    equal to plain (bitwise expected; gate: deltas within DELTA_REL by
    norm), and each rank's stored bytes: zero1 half the optimizer state
    plus the padding, fsdp half the parameters and half the state."""
    batch = _train_batch(9, TRAIN_B, TRAIN_T)
    res, rows = {}, []
    init = None
    for kw in ({}, {"zero1": True}, {"fsdp": True}):
        torch.cuda.reset_peak_memory_stats()
        tr = _par_trainer(dev, PAR_DP, "bfloat16", optimizer="adamw",
                          params=dict(GPT3_ADAMW), **kw)
        if init is None:
            init = tr.get_params()[0]
        t0 = time.perf_counter()
        for _ in range(3):
            tr.step(batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        name = next(iter(kw), "plain")
        res[name] = tr.get_params()[0]
        sh = tr._sharded
        whole = sum(v.numel() for v in init.values())
        sizes = [sh.state_bytes(r) for r in range(PAR_DP)]
        rows.append((name, sizes, sh.pad, secs, memory()))
        if name == "zero1":
            for pb, sb in sizes:
                if sb * PAR_DP != 2 * 4 * (whole + sh.pad) \
                        or pb != 4 * (whole + sh.pad):
                    raise AssertionError("phase 5d zero1: a rank stores "
                                         "%d / %d bytes" % (pb, sb))
        if name == "fsdp":
            stored = sum(int(np.prod(s)) for s in sh.shard_shapes.values())
            for pb, sb in sizes:
                if pb != 4 * stored or sb != 2 * pb \
                        or stored * PAR_DP != whole:
                    raise AssertionError("phase 5d fsdp: a rank stores "
                                         "%d / %d bytes of %d parameters"
                                         % (pb, sb, whole))
        del tr
        free_programs()
    base = _deltas(res["plain"], init)
    for name in ("zero1", "fsdp"):
        bitwise, worst_abs = _same(res[name], res["plain"])
        worst = _delta_gate("phase 5d %s vs plain dp" % name,
                            _deltas(res[name], init), base)
        log("phase 5d %s: 3 AdamW steps equal plain dp=%d: bitwise %s "
            "(worst |diff| %.3g of a tensor's largest value); deltas "
            "within %g by norm, worst %s %.3g" % (
                name, PAR_DP, bitwise, worst_abs, DELTA_REL, worst[2],
                worst[0]))
    for name, sizes, pad, secs, mem in rows:
        log("phase 5d %s bytes a rank (parameters, optimizer state): %s of "
            "%d parameters (%d bytes f32), padding %d elements; 3 steps in "
            "%.3f s (with the capture); %s; %s" % (
                name, sizes, sum(v.numel() for v in init.values()),
                4 * sum(v.numel() for v in init.values()), pad, secs, mem,
                card_line()))


def par_remat(dev):
    """Check 3: one step of the dp=2 bf16 SGD trainer with remat=True
    against remat=False from the same weights (bitwise expected; gate:
    deltas within DELTA_REL by norm), and both peak memories."""
    batch = _train_batch(7, TRAIN_B, TRAIN_T)
    res, peaks = {}, {}
    init = None
    for remat in (False, True):
        free_programs()
        torch.cuda.reset_peak_memory_stats()
        tr = _par_trainer(dev, PAR_DP, "bfloat16", remat=remat)
        if init is None:
            init = tr.get_params()[0]
        tr.step(batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**20
        res[remat] = tr.get_params()[0]
        del tr
    free_programs()
    bitwise, worst_abs = _same(res[True], res[False])
    worst = _delta_gate("phase 5d remat", _deltas(res[True], init),
                        _deltas(res[False], init))
    log("phase 5d remat: one dp=%d step with remat=True equals remat=False: "
        "bitwise %s (worst |diff| %.3g); deltas within %g by norm, worst "
        "%s %.3g; peak memory (build, capture and step) %.1f MB without, "
        "%.1f MB with remat; %s" % (
            PAR_DP, bitwise, worst_abs, DELTA_REL, worst[2], worst[0],
            peaks[False], peaks[True], card_line()))


def _pipe_launches(schedule, steps, groups=1, m=PAR_M):
    """Flash launches of a pipeline step: every layer runs each of its
    microbatches once forward and once backward; 1F1B's backward
    recomputes the stage's forward, so it launches the forward twice."""
    n = LAYERS * m * groups * steps
    return {"flash_attention_fwd": n * (2 if schedule == "1f1b" else 1),
            "flash_attention_dq": n, "flash_attention_dkv": n}


def _pipe_trainer(dev, mesh_axes, m, schedule, dropout=0.0):
    from mxnet_tpu_torch.parallel import PipelineTrainer, build_mesh
    n = int(np.prod(list(mesh_axes.values())))
    return PipelineTrainer(
        _par_symbol(mesh_axes["pp"], dropout),
        {"data": (TRAIN_B, TRAIN_T), "softmax_label": (TRAIN_B, TRAIN_T)},
        build_mesh(mesh_axes, [dev] * n), num_microbatches=m,
        optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        seed=0, schedule=schedule)


def par_pipeline(K, dev, ref):
    """Check 4: PipelineTrainer on pipeline_stages=4 over {pp: 4} ([dev] *
    4), f32, B=8 T=1024, M=8 (one row a microbatch), from the one-device
    f32 trainer's seeded weights: GPipe and 1F1B, PIPE_WARM warm-up and
    PIPE_TIMED timed steps each, exact launches (``_pipe_launches``), a
    falling loss, tokens/s and peak memory, 1F1B's peak below GPipe's; one
    step of each
    against the one-device f32 ParallelTrainer on the untagged LM
    (deltas within DELTA_REL by norm), and the same for GPipe on {dp: 2,
    pp: 2} over [dev] * 4 (M=4). Returns the timed launches."""
    batch, init, want = ref
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    launches, peaks = {}, {}
    for schedule in ("gpipe", "1f1b"):
        free_programs()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pp = _pipe_trainer(dev, {"pp": PAR_PP}, PAR_M, schedule)
        pp.init_params(init)
        losses = [_lm_train_loss([pp.step(batch)], label)
                  for _ in range(PIPE_WARM)]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        K.reset_launch_counts()
        secs = []
        for _ in range(PIPE_TIMED):
            t1 = time.perf_counter()
            out = pp.step(batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            losses.append(_lm_train_loss([out], label))
        got = _check_launches(K, "phase 5d %s" % schedule,
                              _pipe_launches(schedule, PIPE_TIMED))
        for e, n in got.items():
            launches[e] = launches.get(e, 0) + n
        peaks[schedule] = torch.cuda.max_memory_allocated() / 2**20
        mem = memory()
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError("phase 5d %s: the loss did not fall: %r"
                                 % (schedule, losses))
        pp.init_params(init)
        pp.step(batch)
        worst = _delta_gate("phase 5d %s vs one device" % schedule,
                            _deltas(pp.get_params(), init), want)
        tps = [TRAIN_B * TRAIN_T / s for s in secs]
        log("phase 5d %s: PipelineTrainer(pipeline_stages=%d, mesh={pp: %d} "
            "over [%s] * %d; %s), B=%d T=%d f32, M=%d, SGD lr 1e-3 momentum "
            "0.9; built and %d warm-up steps in %.1f s; %d timed steps: "
            "tokens/s median %.1f (min %.1f, max %.1f), ms per step median "
            "%.3f; loss %s; launches a step %s; in flight at most %d "
            "microbatches a stage; peak %.1f MB (%s); one step against the "
            "one-device f32 trainer: deltas within %g by norm, worst %s "
            "%.3g; %s" % (
                schedule, PAR_PP, PAR_PP, dev, PAR_PP, PAR_NOTE, TRAIN_B,
                TRAIN_T, PAR_M, PIPE_WARM, warm_s, PIPE_TIMED,
                statistics.median(tps), min(tps), max(tps),
                statistics.median(secs) * 1e3,
                " ".join("%.4f" % v for v in losses),
                json.dumps({e: n // PIPE_TIMED for e, n in got.items()
                            if n}),
                pp.max_in_flight if schedule == "1f1b" else PAR_M,
                peaks[schedule], mem, DELTA_REL, worst[2], worst[0],
                card_line()))
        del pp
    if not peaks["1f1b"] < peaks["gpipe"]:
        raise AssertionError("phase 5d: 1F1B's peak %.1f MB is not below "
                             "GPipe's %.1f MB" % (peaks["1f1b"],
                                                  peaks["gpipe"]))
    free_programs()
    pp = _pipe_trainer(dev, {"dp": 2, "pp": 2}, PAR_M // 2, "gpipe")
    pp.init_params(init)
    pp.step(batch)          # builds the step program (two warm-up runs)
    pp.init_params(init)
    K.reset_launch_counts()
    pp.step(batch)
    got = _check_launches(K, "phase 5d dp x pp",
                          _pipe_launches("gpipe", 1, 2, PAR_M // 2))
    worst = _delta_gate("phase 5d dp x pp vs one device",
                        _deltas(pp.get_params(), init), want)
    del pp
    free_programs()
    log("phase 5d dp x pp: PipelineTrainer(pipeline_stages=2, mesh={dp: 2, "
        "pp: 2} over [%s] * 4), M=%d a group, f32: one step's launches %s; "
        "deltas against the one-device f32 trainer within %g by norm, "
        "worst %s %.3g; 1F1B peak %.1f MB below GPipe's %.1f MB; %s" % (
            dev, PAR_M // 2, json.dumps({e: n for e, n in got.items() if n}),
            DELTA_REL, worst[2], worst[0], peaks["1f1b"], peaks["gpipe"],
            card_line()))
    return launches


PAR_DROPOUT = 0.1                   # the draws of the recompute checks
DROP_PP, DROP_M, DROP_STEPS = 2, 4, 4


def par_remat_draws(dev):
    """Check 6: a graph that draws, recomputed inside captured steps. The
    124M LM with dropout PAR_DROPOUT, one device, bf16 over f32 masters:
    one captured step with remat=True against remat=False from the same
    seed, bitwise (the recompute takes the forward's draws from its
    ``DrawTape``, and the generator ends where a plain step leaves it: a
    second step is bitwise too)."""
    from mxnet_tpu_torch.parallel import ParallelTrainer
    batch = _train_batch(17, TRAIN_B, TRAIN_T)
    res, peaks = {}, {}
    for remat in (False, True):
        free_programs()
        torch.cuda.reset_peak_memory_stats()
        tr = ParallelTrainer(
            _par_symbol(dropout=PAR_DROPOUT),
            {"data": (TRAIN_B, TRAIN_T), "softmax_label": (TRAIN_B, TRAIN_T)},
            optimizer="sgd",
            optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
            compute_dtype="bfloat16", seed=0, device=dev,
            remat=remat).init_params()
        outs = []
        for _ in range(2):
            outs.append(tr.step(batch)[0].clone())
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**20
        res[remat] = (outs, tr.get_params()[0])
        del tr
    free_programs()
    same_outs = all(torch.equal(a, b) for a, b in zip(res[True][0],
                                                       res[False][0]))
    bitwise, worst = _same(res[True][1], res[False][1])
    if not (same_outs and bitwise):
        raise AssertionError("phase 5d remat with dropout: not bitwise "
                             "(outputs equal %s, worst parameter diff %.3g)"
                             % (same_outs, worst))
    log("phase 5d remat with dropout %g: two captured steps of the 124M LM "
        "(one device, bf16) with remat=True bitwise equal to remat=False "
        "from seed 0: outputs and parameters; peak memory %.1f MB without, "
        "%.1f MB with remat; %s" % (PAR_DROPOUT, peaks[False], peaks[True],
                                   card_line()))


def _compare_recomputes(pp, counts):
    """Wrap ``pp._stage`` so each 1F1B recompute (the call with grad on)
    is held against the outputs its forward (under no_grad) gave: adds
    the elements that differ to ``counts[0]`` and those compared to
    ``counts[1]`` (device tensors, so the comparison is captured with the
    step). A stage's backwards run in its forwards' order."""
    kept = collections.defaultdict(collections.deque)
    real = pp._stage

    def stage(s, x, inputs, params, gen, is_train=True):
        y, o = real(s, x, inputs, params, gen, is_train)
        vals = [y] if o is None else list(o)
        if not torch.is_grad_enabled():
            kept[s].append(vals)
            return y, o
        for a, f in zip(vals, kept[s].popleft()):
            counts[0] += (a.detach() != f).sum()
            counts[1] += f.numel()
        return y, o

    pp._stage = stage


def par_1f1b_draws(K, dev):
    """Check 7: 1F1B over a graph that draws. PipelineTrainer on
    pipeline_stages=DROP_PP over {pp: DROP_PP}, dropout PAR_DROPOUT, f32,
    M=DROP_M: DROP_STEPS captured steps after the one that builds the
    program, every recomputed stage output (boundary activations and the
    last stage's softmax) equal to what its forward produced, element for
    element (``_compare_recomputes``), exact launches, a falling loss;
    the peak memory against the same trainer without dropout (the draw
    tapes' cost)."""
    batch = _train_batch(19, TRAIN_B, TRAIN_T)
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    peaks = {}
    for dropout in (0.0, PAR_DROPOUT):
        free_programs()
        torch.cuda.reset_peak_memory_stats()
        pp = _pipe_trainer(dev, {"pp": DROP_PP}, DROP_M, "1f1b", dropout)
        pp.init_params()
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        _compare_recomputes(pp, counts)
        losses = [_lm_train_loss([pp.step(batch)], label)]
        counts.zero_()
        K.reset_launch_counts()
        for _ in range(DROP_STEPS):
            losses.append(_lm_train_loss([pp.step(batch)], label))
        torch.cuda.synchronize()
        peaks[dropout] = torch.cuda.max_memory_allocated() / 2**20
        got = _check_launches(K, "phase 5d 1f1b with dropout %g" % dropout,
                              _pipe_launches("1f1b", DROP_STEPS, m=DROP_M))
        differ, compared = counts.tolist()
        want = DROP_STEPS * DROP_M * TRAIN_B // DROP_M * TRAIN_T * (
            EMBED * (DROP_PP - 1) + VOCAB)
        if differ or compared != want:
            raise AssertionError(
                "phase 5d 1f1b with dropout %g: %d of %d recomputed "
                "elements differ from the forward's (want %d compared)"
                % (dropout, differ, compared, want))
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError("phase 5d 1f1b with dropout %g: the loss "
                                 "did not fall: %r" % (dropout, losses))
        del pp
    free_programs()
    log("phase 5d 1f1b with dropout %g: PipelineTrainer(pipeline_stages=%d, "
        "{pp: %d} over [%s] * %d), f32, M=%d: %d captured steps, %d "
        "recomputed stage-output elements equal to the forward's (0 "
        "differ); loss %s; launches %s; peak memory (build, capture and "
        "steps) %.1f MB, against %.1f MB without dropout; %s" % (
            PAR_DROPOUT, DROP_PP, DROP_PP, dev, DROP_PP, DROP_M, DROP_STEPS,
            compared, " ".join("%.4f" % v for v in losses),
            json.dumps({e: n for e, n in got.items() if n}),
            peaks[PAR_DROPOUT], peaks[0.0], card_line()))
    return got


def par_graphsafe_probe(dev):
    """An observation, not a gate: the capture-safe generator calls as a
    recompute's restore. Inside one captured graph, draw, restore the
    generator to what ``graphsafe_get_state()`` (or ``clone_state()``)
    returned before the draw, draw again; replayed twice. A recompute
    needs the two draws of a replay equal, and a replay's draws new."""
    n = 1 << 16
    for how in ("graphsafe_get_state", "clone_state"):
        g = torch.Generator(device=dev).manual_seed(0)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(g)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.graph(graph, stream=side):
                live = g.graphsafe_get_state()
                snap = live if how == "graphsafe_get_state" \
                    else g.clone_state()
                a = torch.rand(n, generator=g, device=dev)
                g.graphsafe_set_state(snap)
                b = torch.rand(n, generator=g, device=dev)
                g.graphsafe_set_state(live)
            seen = []
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                seen.append((a.clone(), torch.equal(a, b)))
            said = "the two draws of a replay equal: %s, %s; the first " \
                "draw new in the second replay: %s" % (
                    seen[0][1], seen[1][1],
                    not torch.equal(seen[0][0], seen[1][0]))
        except Exception as e:  # the observation is the failure itself
            said = "raised %s: %s" % (type(e).__name__,
                                      str(e).splitlines()[0][:200])
        del graph
        log("phase 5d graphsafe probe: restore by %s inside a captured "
            "draw: %s" % (how, said))


FF_BATCHES, FF_BATCH = 8, 128


def par_feedforward(dev):
    """Check 5: FeedForward(ctx=[gpu(0)] * 2) fits the zoo's MLP on
    synthetic data through the fused loop (a dp=2 mesh on one card, the
    default there), one epoch of FF_BATCHES batches, against
    FeedForward(ctx=gpu(0)) from the same weights: deltas within
    DELTA_REL by norm."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import _fused_fit_eligible
    from mxnet_tpu_torch.models.classifiers import get_mlp
    sym = get_mlp(10)
    rs = np.random.RandomState(21)
    X = rs.randn(FF_BATCHES * FF_BATCH, 784).astype(np.float32)
    y = np.argmax(X @ rs.randn(784, 10), axis=1).astype(np.float32)
    arg_shapes, _, _ = sym.infer_shape(data=(FF_BATCH, 784),
                                       softmax_label=(FF_BATCH,))
    init = {n: rs.uniform(-0.05, 0.05, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    two = [mx.gpu(0)] * 2
    sgd = mx.optimizer.create("sgd")
    if not _fused_fit_eligible(two, None, None, None, None, sgd):
        raise AssertionError("phase 5d: FeedForward over [gpu(0)] * 2 does "
                             "not take the fused loop")
    got, secs = [], []
    for ctx in (mx.gpu(0), two):
        model = mx.model.FeedForward(
            sym, ctx=ctx, num_epoch=1,
            arg_params={n: mx.nd.array(v, ctx=mx.cpu())
                        for n, v in init.items()},
            learning_rate=0.1, momentum=0.9)
        t0 = time.perf_counter()
        model.fit(mx.io.NDArrayIter(X, y, batch_size=FF_BATCH))
        secs.append(time.perf_counter() - t0)
        got.append({n: torch.from_numpy(v.asnumpy())
                    for n, v in model.arg_params.items()})
    base = {n: torch.from_numpy(v) for n, v in init.items()}
    worst = _delta_gate("phase 5d FeedForward", _deltas(got[1], base),
                        _deltas(got[0], base))
    free_programs()
    log("phase 5d FeedForward: get_mlp(10) fit for one epoch of %d batches "
        "of %d through the fused loop on ctx=[gpu(0)] * 2 (a dp=2 mesh) "
        "against ctx=gpu(0): deltas within %g by norm, worst %s %.3g; "
        "fit %.3f s and %.3f s (with the capture)" % (
            FF_BATCHES, FF_BATCH, DELTA_REL, worst[2], worst[0], secs[1],
            secs[0]))


def parallel_main_path(K, dev):
    """Phase 5d: the other parallelisms at the 124M LM's width, each
    check on its own ``phase 5d`` line, the phase's seconds last. Returns
    the launches of its gated runs."""
    t_phase = time.perf_counter()
    ref = _f32_reference(dev)
    launches = dict(par_dp(K, dev, ref))
    free_programs()
    par_zero(K, dev)
    par_remat(dev)
    for e, n in par_pipeline(K, dev, ref).items():
        launches[e] = launches.get(e, 0) + n
    par_feedforward(dev)
    par_graphsafe_probe(dev)
    par_remat_draws(dev)
    for e, n in par_1f1b_draws(K, dev).items():
        launches[e] = launches.get(e, 0) + n
    log("phase 5d: every check passed in %.1f s" % (
        time.perf_counter() - t_phase))
    return launches


# -- phase 6: the conv-net path: ResNet-50 -------------------------------------

RESNET_FLOPS_PER_IMG = 3 * 4.1e9    # bench.py:39, forward + backward
RESNET_CHAINS, RESNET_POINTWISE = 53, 33
GATE = "MXNET_PALLAS_CONVBN_TRAIN"
# card vs host, f32, from the same weights: log-probabilities of the eval
# forward within LOGP_ATOL (53 convs summed in other orders, the card's
# fused_conv_bn_act against F.conv2d on the host); one train step's
# softmax output and parameter deltas within the LM check's gates
# (PROB_REL, DELTA_REL, ELEM_REL: the ReLU kink, above)
LOGP_ATOL = 1e-3


def _resnet_trainer(dev, b, compute_dtype, lr=0.1):
    from mxnet_tpu_torch.models import get_resnet
    from mxnet_tpu_torch.parallel import ParallelTrainer
    return ParallelTrainer(
        get_resnet(RESNET_CLASSES, RESNET_LAYERS),
        {"data": (b, 3, RESNET_HW, RESNET_HW), "softmax_label": (b,)},
        optimizer="sgd", optimizer_params={"learning_rate": lr,
                                           "momentum": 0.9, "wd": 1e-4},
        compute_dtype=compute_dtype, seed=0, device=dev)


def _resnet_batch(seed, b, dev=None):
    """Images uniform in [0, 1) and integer labels from one seed (as
    bench.py makes them), on ``dev`` when given (a device-resident batch,
    as bench.py times it)."""
    rs = np.random.RandomState(seed)
    batch = {"data": rs.rand(b, 3, RESNET_HW, RESNET_HW).astype(np.float32),
             "softmax_label": rs.randint(0, RESNET_CLASSES, (b,)
                                         ).astype(np.int32)}
    if dev is not None:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return batch


def _resnet_scaled_params(seed):
    """Fan-in scaled weights, gamma near 1 but near 0.2 at the end of each
    residual branch (so the residual stream stays O(1) through 16 units
    and the logits O(1): log-probabilities are then comparable and the
    top-1 far from ties), nonzero beta and moving statistics (so the eval
    fold does real work)."""
    from mxnet_tpu_torch.models import get_resnet
    sym = get_resnet(RESNET_CLASSES, RESNET_LAYERS)
    shapes = {"data": (1, 3, RESNET_HW, RESNET_HW), "softmax_label": (1,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, sh in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            v = rng.randn(*sh) * np.sqrt(2.0 / np.prod(sh[1:]))
        elif n.endswith("_gamma"):
            v = (0.2 if n.endswith("_c_bn_gamma") else 1.0) \
                * (1.0 + 0.1 * rng.randn(*sh))
        else:
            v = 0.1 * rng.randn(*sh)
        args[n] = v.astype(np.float32)
    aux = {n: (0.1 * rng.randn(*sh) if n.endswith("mean")
               else rng.uniform(0.5, 1.5, sh)).astype(np.float32)
           for n, sh in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _resnet_loss(outs, label):
    p = outs[0].float()
    return -torch.log(p.gather(1, label[:, None]).clamp_min(1e-30)
                      ).mean().item()


def _resnet_steps(K, trainer, batch, label, losses, steps):
    """``steps`` timed train steps with the launch counters zeroed just
    before and read just after: (seconds, host seconds, launches, the
    memory since the trainer was built)."""
    K.reset_launch_counts()
    secs, queued = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        outs = trainer.step(batch)
        queued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(_resnet_loss(outs, label))
    return secs, queued, K.launch_counts(), memory()


def _report_resnet(what, b, secs, queued, mem, busy):
    ips = [b / t for t in secs]
    med = statistics.median(ips)
    log("%s: %d timed steps at B=%d; img/s median %.1f (min %.1f, max "
        "%.1f); ms per step median %.3f (min %.3f, max %.3f); MFU %.4f "
        "(%.3g FLOP per image, bench.py:39, over 989 TFLOP/s); step() "
        "returns after %.3f ms (median); busy share %.3f (profiled); memory "
        "since the trainer was built: %s; %s" % (
            what, len(secs), b, med, min(ips), max(ips),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            med * RESNET_FLOPS_PER_IMG / 989e12, RESNET_FLOPS_PER_IMG,
            statistics.median(queued) * 1e3, busy, mem,
            card_line()))


def train_resnet(K, dev):
    """ResNet-50 trained by ParallelTrainer(device=None) as bench.py:115-124
    trains it (B=256, 224 x 224, bf16 over f32 master weights, SGD lr 0.1
    momentum 0.9 wd 1e-4, default init) with MXNET_PALLAS_CONVBN_TRAIN=1
    set before the trainer is built: WARM_STEPS steps, then TIMED_STEPS
    with exactly RESNET_POINTWISE matmul_stats launches per step and a
    falling loss, a 2-step profile; then the same TIMED_STEPS with the
    gate unset (no launch: the unfused ops). Returns the gate-on launch
    counts."""
    os.environ[GATE] = "1"
    torch.cuda.reset_peak_memory_stats()
    trainer = _resnet_trainer(None, RESNET_B, "bfloat16").init_params()
    if trainer.device != dev:
        raise AssertionError("device=None resolved to %s" % trainer.device)
    batch = _resnet_batch(0, RESNET_B, dev)
    label = batch["softmax_label"].long()
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(_resnet_loss(trainer.step(batch), label))
    torch.cuda.synchronize()
    log("resnet train: ResNet-50, B=%d 3x%dx%d bf16, SGD lr 0.1 momentum "
        "0.9 wd 1e-4, %s=1; %d warm-up steps in %.1f s" % (
            RESNET_B, RESNET_HW, RESNET_HW, GATE, WARM_STEPS,
            time.perf_counter() - t0))
    secs, queued, launches, peak = _resnet_steps(
        K, trainer, batch, label, losses, TIMED_STEPS)
    want = dict.fromkeys(launches, 0)
    want["matmul_stats"] = RESNET_POINTWISE * TIMED_STEPS
    if launches != want:
        raise AssertionError("resnet train launch counts %r, the main path "
                             "wants %r" % (launches, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.01:
        raise AssertionError("the ResNet-50 loss on the repeated batch did "
                             "not fall: %r" % losses)
    _, _, busy = profile_train(trainer, batch, trace="resnet_train_trace.json",
                               what="resnet train (%s=1)" % GATE)
    _report_resnet("resnet train (%s=1)" % GATE, RESNET_B, secs, queued,
                   peak, busy)
    # phase 7d holds the step fed from records against this one
    REPORT["resnet_ms"] = statistics.median(secs) * 1e3
    REPORT["resnet_busy"] = busy
    log("resnet train: loss over the %d steps %s" % (
        len(losses), " ".join("%.4f" % v for v in losses)))
    log("resnet train launches: %s" % json.dumps(launches))

    # the step program read the gate when it was built, as the JAX
    # package reads it when it traces: the gate-off steps take a trainer
    # built with the gate unset, from the same seeded initial weights
    del os.environ[GATE]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = _resnet_trainer(None, RESNET_B, "bfloat16").init_params()
    trainer.step(batch)                 # the unfused step's capture
    torch.cuda.synchronize()
    secs, queued, off, peak = _resnet_steps(K, trainer, batch, label, [],
                                            TIMED_STEPS)
    if any(off.values()):
        raise AssertionError("with %s unset the step launched %r" % (
            GATE, off))
    _, _, busy = profile_train(trainer, batch, trace=None,
                               what="resnet train (%s unset)" % GATE)
    _report_resnet("resnet train (%s unset)" % GATE, RESNET_B, secs, queued,
                   peak, busy)
    return {"matmul_stats": launches["matmul_stats"]}


def eval_resnet(K, dev):
    """ResNet-50's inference forward, ``trainer.forward()`` at B=256 of
    the bf16 trainer, from fan-in scaled weights and nonzero moving
    statistics. As in the JAX package, forward() runs on the f32 master
    parameters and the batch as given, so the chains run the kernel's f32
    path: 2 warm-up forwards, then TIMED_STEPS with exactly RESNET_CHAINS
    fused_conv_bn_act launches each; finite probabilities that sum to 1.
    Returns the launch counts."""
    trainer = _resnet_trainer(None, RESNET_B, "bfloat16")
    trainer.init_params(*_resnet_scaled_params(1))
    batch = _resnet_batch(2, RESNET_B, dev)
    for _ in range(2):
        trainer.forward(batch)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    secs, outs = [], None
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        outs = trainer.forward(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want["fused_conv_bn_act"] = RESNET_CHAINS * TIMED_STEPS
    if launches != want:
        raise AssertionError("resnet eval launch counts %r, the main path "
                             "wants %r" % (launches, want))
    p = outs[0].float()
    if p.shape != (RESNET_B, RESNET_CLASSES) or not torch.isfinite(p).all() \
            or (p.sum(dim=1) - 1).abs().max().item() > 1e-2:
        raise AssertionError("resnet eval: the probabilities are not finite "
                             "rows of %d summing to 1" % RESNET_CLASSES)
    _, _, busy = profile_train(trainer, batch, trace=None,
                               what="resnet eval",
                               call=lambda: trainer.forward(batch))
    ips = [RESNET_B / t for t in secs]
    log("resnet eval: %d forwards at B=%d f32 (bf16 trainer); img/s median "
        "%.1f (min %.1f, "
        "max %.1f); ms per forward median %.3f; busy share %.3f (profiled); "
        "peak memory %.1f MB; %d distinct top-1 classes; %s" % (
            TIMED_STEPS, RESNET_B, statistics.median(ips), min(ips),
            max(ips), statistics.median(secs) * 1e3, busy, peak / 2**20,
            len(set(p.argmax(dim=1).tolist())), card_line()))
    log("resnet eval launches: %s" % json.dumps(launches))

    # the same forwards with no chain fused (F.conv2d, BatchNorm and relu
    # as separate ops, no kernel of the port): what the fold costs or
    # saves
    from mxnet_tpu_torch.ops.fusion import eval_graph
    topo, heads = trainer.symbol._topo(), trainer.symbol._heads
    fused_fn = trainer._graph_fn
    trainer._graph_fn = lambda a, x, t, g: eval_graph(topo, heads, a, x, t,
                                                      g)[:2]
    for _ in range(2):
        trainer.forward(batch)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    usecs = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        uouts = trainer.forward(batch)
        torch.cuda.synchronize()
        usecs.append(time.perf_counter() - t0)
    trainer._graph_fn = fused_fn
    if any(K.launch_counts().values()):
        raise AssertionError("the unfused forward launched %r"
                             % K.launch_counts())
    q = uouts[0].float()
    log("resnet eval unfused (no chain fused): %d forwards at B=%d f32; "
        "ms per forward median %.3f (min %.3f, max %.3f) against %.3f "
        "fused; probabilities max |fused - unfused| %.3g, top-1 equal for "
        "%d of %d; %s" % (
            TIMED_STEPS, RESNET_B, statistics.median(usecs) * 1e3,
            min(usecs) * 1e3, max(usecs) * 1e3, statistics.median(secs) * 1e3,
            (p - q).abs().max().item(),
            int((p.argmax(dim=1) == q.argmax(dim=1)).sum()), RESNET_B,
            card_line()))
    return {"fused_conv_bn_act": launches["fused_conv_bn_act"]}


def check_resnet_against_host(dev, b=2):
    """ResNet-50 in f32 at B=2 from the same fan-in scaled weights on the
    card (the kernels) and on the host (their plain versions), with
    MXNET_PALLAS_CONVBN_TRAIN=1: the eval forward's log-probabilities
    within LOGP_ATOL and the same top-1; then one train step's softmax
    output within PROB_REL and each parameter's delta within DELTA_REL
    (norm) and ELEM_REL (largest element)."""
    os.environ[GATE] = "1"
    args, aux = _resnet_scaled_params(3)
    batch = _resnet_batch(4, b)
    res = {}
    for where in (dev, "cpu"):
        tr = _resnet_trainer(where, b, None)
        tr.init_params(args, aux)
        logp = torch.log(tr.forward(batch)[0].cpu())
        before = {n: v.clone() for n, v in tr.params.items()}
        probs = tr.step(batch)[0].cpu()
        res[str(where)] = (logp, probs, {n: (tr.params[n] - before[n]).cpu()
                                         for n in before})
    del os.environ[GATE]
    (lc, pc, card), (lh, ph, host) = res[str(dev)], res["cpu"]
    lerr = (lc - lh).abs().max().item()
    top = lh.topk(2, dim=1).values
    gap = (top[:, 0] - top[:, 1]).min().item()
    same = torch.equal(lc.argmax(dim=1), lh.argmax(dim=1))
    perr = (pc - ph).abs().max().item() / ph.abs().max().item()
    rows = sorted((((card[n] - dh).norm() / dh.norm()).item(),
                   ((card[n] - dh).abs().max() / dh.abs().max()).item(), n)
                  for n, dh in host.items())[::-1]
    # written so that a NaN fails every gate
    if not (lerr <= LOGP_ATOL and same and perr <= PROB_REL) \
            or not all(r[0] <= DELTA_REL and r[1] <= ELEM_REL for r in rows):
        raise AssertionError(
            "resnet card vs host: eval log-probabilities max |err| %.3g (gate "
            "%g), top-1 equal %s; train softmax %.3g of its max (gate %g); "
            "worst deltas (norm, largest element) %s (gates %g, %g)" % (
                lerr, LOGP_ATOL, same, perr, PROB_REL,
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL, ELEM_REL))
    worst_elem = max(rows, key=lambda r: r[1])
    log("resnet card vs host: ResNet-50 f32 at B=%d, %s=1; eval "
        "log-probabilities max |err| %.3g (gate %g), top-1 equal (smallest "
        "top-2 gap %.3g); one train step: softmax output %.3g of its max "
        "(gate %g), %d parameter deltas agree, worst in norm %s %.3g (gate "
        "%g), worst element %s %.3g (gate %g)" % (
            b, GATE, lerr, LOGP_ATOL, gap, perr, PROB_REL, len(rows),
            rows[0][2], rows[0][0], DELTA_REL, worst_elem[2], worst_elem[1],
            ELEM_REL))


# -- phase 7: the sequence-parallel training path ----------------------------

SP_B, SP_T = 2, 4096                # 8192 tokens a step, as TRAIN_B x TRAIN_T
SP_TIMED_STEPS = 6                  # phase 7's timed steps (7f sp pays)
SP_MESH = {"dp": 1, "sp": SP_RING}
SP_ENTRIES = ("striped_pair_fwd", "striped_pair_dq", "striped_pair_dkv")
# the striped ring against dense causal attention on the card, f32 (TF32
# off): tests/test_parallel.py's ring tolerance
RING_TOL = (2e-4, 2e-5)
# the f32 SP loss is computed the same way every step; f32 noise on a loss
# of ~10.4 is ~1e-5, so a fall of LOSS_FALL is a real one
LOSS_FALL = 1e-3


def _sp_mesh(dev):
    from mxnet_tpu_torch.parallel import build_mesh
    return build_mesh(SP_MESH, [dev] * SP_RING)


def check_ring_on_card(dev):
    """striped_ring_attention over a 4-rank mesh on one card ([cuda:0] *
    4: every hop runs the pair kernel at a real striped offset) against
    dense causal attention, values and the q/k/v gradients of sum(out *
    w), f32, at T=32 (tests/test_parallel.py's shape) and at a ragged
    T=4*100 with 3 heads of 64 (local C=100: not a multiple of the
    tiles)."""
    from mxnet_tpu_torch.parallel import striped_ring_attention
    mesh = _sp_mesh(dev)
    rtol, atol = RING_TOL
    worst = 0.0
    for b, t, h, d in ((2, 32, 2, 8), (2, 400, 3, 64)):
        rng = np.random.RandomState(t)
        q, k, v, w = (torch.from_numpy(rng.randn(b, t, h, d).astype(
            np.float32)).to(dev).requires_grad_() for _ in range(4))
        res = []
        for fn in (lambda: striped_ring_attention(q, k, v, mesh),
                   lambda: _dense_causal(q, k, v)):
            out = fn()
            res.append([out.detach()] + list(torch.autograd.grad(
                (out * w).sum(), (q, k, v))))
        torch.cuda.synchronize()
        for name, got, want in zip(("out", "dq", "dk", "dv"), *res):
            err = (got - want).abs()
            if not torch.isfinite(got).all() \
                    or (err > atol + rtol * want.abs()).any():
                raise AssertionError(
                    "striped ring on %s vs dense causal, %s B=%d T=%d H=%d "
                    "D=%d: max |err| %.3g" % (mesh, name, b, t, h, d,
                                              err.max().item()))
            worst = max(worst, err.max().item())
    log("striped ring on a 4-rank mesh on one card vs dense causal "
        "attention: out, dq, dk, dv agree at T=32 and T=400, max |err| "
        "%.3g (rtol %g, atol %g)" % (worst, rtol, atol))


def _dense_causal(q, k, v):
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(dim=-1), v)


def _sp_trainer(dev, b, t, arg_params=None):
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import SequenceParallelTrainer
    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS, impl="ring_striped")
    return SequenceParallelTrainer(
        symbol, {"data": (b, t), "softmax_label": (b, t)}, _sp_mesh(dev),
        optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        seed=0).init_params(arg_params)


def sp_main_path(K, dev):
    """The 124M LM (impl="ring_striped") trained by SequenceParallelTrainer
    on the mesh {dp: 1, sp: 4} over [cuda:0] * 4 at B=2, T=4096 (local
    C=1024 a rank), f32, SGD lr 1e-3 momentum 0.9, rescale_grad 1/(B T),
    the default Uniform(0.05) init from seed 0, on one repeated seeded
    batch: WARM_STEPS steps, then SP_TIMED_STEPS with the launch counters
    zeroed just before and read just after. Per step, exactly 12 layers x
    4 ranks x 4 hops = 192 launches of each striped_pair entry and 12 x 4
    of fused_linear (each rank's ffn1 + relu chains). Returns the launch
    counts of the timed steps."""
    trainer = _sp_trainer(dev, SP_B, SP_T)
    batch = _train_batch(7, SP_B, SP_T)
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(trainer.step(batch).item())
    torch.cuda.synchronize()
    log("sp train: 124M LM (%d layers, E=%d, %d heads, vocab %d, "
        "impl=ring_striped), B=%d T=%d f32 on the mesh %s over %d x %s, "
        "local C=%d; SGD lr 1e-3 momentum 0.9; %d warm-up steps in %.1f s"
        % (LAYERS, EMBED, HEADS, VOCAB, SP_B, SP_T, SP_MESH, SP_RING, dev,
           SP_T // SP_RING, WARM_STEPS, time.perf_counter() - t0))
    _sp_oracle_record(trainer, losses)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    secs, queued = [], []
    for _ in range(SP_TIMED_STEPS):
        t0 = time.perf_counter()
        nll = trainer.step(batch)
        queued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(nll.item())
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = dict.fromkeys(launches, 0)
    per_step.update({e: LAYERS * SP_RING * SP_RING for e in SP_ENTRIES})
    per_step["fused_linear"] = LAYERS * SP_RING
    want = {e: n * SP_TIMED_STEPS for e, n in per_step.items()}
    if launches != want:
        raise AssertionError("sp train launch counts %r, the main path "
                             "wants %r" % (launches, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - LOSS_FALL:
        raise AssertionError("the SP loss on the repeated batch did not "
                             "fall: %r" % losses)
    REPORT["sp_ms"] = statistics.median(secs) * 1e3
    tokens = SP_B * SP_T
    tps = [tokens / s for s in secs]
    log("sp train: %d timed steps; tokens/s median %.1f (min %.1f, max "
        "%.1f); ms per step median %.3f (min %.3f, max %.3f); step() "
        "returns after %.3f ms (median; min %.3f, max %.3f); peak memory "
        "%.1f MB; %s" % (
            SP_TIMED_STEPS, statistics.median(tps), min(tps), max(tps),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            statistics.median(queued) * 1e3, min(queued) * 1e3,
            max(queued) * 1e3, peak / 2**20, card_line()))
    log("sp train: loss over the %d steps %s" % (
        len(losses), " ".join("%.5f" % v for v in losses)))
    log("sp train launches per step: %s" % json.dumps(
        {e: n for e, n in per_step.items() if n}))
    # gzipped: the 2 steps make a trace of over 30 MB
    profile_train(trainer, batch, trace="sp_train_trace.json.gz",
                  what="sp train")
    return launches


def _sp_oracle_record(trainer, losses):
    """Phase 7f's ``sp`` oracle from phase 7's trainer after its warm-up
    steps (``dist_worker``'s SP trainer at the full size, the same
    weights and batch; as many steps): the digests of its state and its
    losses."""
    from mxnet_tpu_torch.testing import dist_worker as W
    if WARM_STEPS != W.LM_STEPS or W.SP_SIZES["full"]["b"] != SP_B \
            or W.SP_SIZES["full"]["t"] != SP_T or W.LM_SEED != 7:
        raise AssertionError("phase 7's SP run is no longer 7f sp's oracle")
    REPORT["sp_oracle"] = dict(digests=W.digests(W.sp_state(trainer)),
                               loss=list(losses))


def _delta_rows(got, want):
    """[(norm of the difference / norm of want, largest |difference| /
    largest |want|, name)] per tensor, worst norm first."""
    return sorted((((got[n] - dw).norm() / dw.norm()).item(),
                   ((got[n] - dw).abs().max() / dw.abs().max()).item(), n)
                  for n, dw in want.items())[::-1]


def check_sp_against_flash(dev, b=1, t=1024):
    """One f32 step of the 124M LM from the same seeded weights through
    SequenceParallelTrainer(impl="ring_striped") on [cuda:0] * 4 and
    through ParallelTrainer(impl="flash", device=None), both with
    rescale_grad 1/(B T): every parameter's delta agrees within DELTA_REL
    of its norm (the ReLU kink rule). The on-card oracle that the striped
    ring is causal attention. The same step with impl="dense" is the
    yardstick of what two correct attentions differ by at this length:
    its distance from the flash step is reported beside the SP step's,
    per tensor in the norm and in the largest element (where a few kink
    flips show most)."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer

    def single(impl):
        symbol = get_transformer_lm(VOCAB, num_layers=LAYERS,
                                    embed_dim=EMBED, num_heads=HEADS,
                                    impl=impl)
        return ParallelTrainer(
            symbol, {"data": (b, t), "softmax_label": (b, t)},
            optimizer="sgd",
            optimizer_params={"learning_rate": 1e-3, "momentum": 0.9,
                              "rescale_grad": 1.0 / (b * t)},
            seed=0, device=None)

    flash = single("flash")
    params = _lm_params(flash.symbol, t, 5)
    batch = _train_batch(13, b, t)
    deltas = []
    for tr in (_sp_trainer(dev, b, t, params), flash.init_params(params),
               single("dense").init_params(params)):
        before = {n: v.clone() for n, v in tr.params.items()}
        tr.step(batch)
        deltas.append({n: (tr.params[n] - before[n]).cpu() for n in before})
        del tr, before
    torch.cuda.synchronize()
    sp, want, dense = deltas
    rows, ref = _delta_rows(sp, want), _delta_rows(dense, want)
    if not all(r[0] <= DELTA_REL for r in rows):
        raise AssertionError(
            "sp ring_striped vs flash step: worst deltas (norm, largest "
            "element) %s (gate %g on the norm)" % (
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL))
    elem, ref_elem = max(rows, key=lambda r: r[1]), max(ref,
                                                        key=lambda r: r[1])
    log("sp vs flash: one f32 step of the 124M LM at B=%d T=%d, "
        "SequenceParallelTrainer(ring_striped, sp=4 on one card) against "
        "ParallelTrainer(flash); %d parameter deltas agree, worst in norm "
        "%s %.3g (gate %g); worst element %s %.3g of its largest delta. "
        "Yardstick, ParallelTrainer(dense) against flash: worst in norm %s "
        "%.3g, worst element %s %.3g" % (
            b, t, len(rows), rows[0][2], rows[0][0], DELTA_REL, elem[2],
            elem[1], ref[0][2], ref[0][0], ref_elem[2], ref_elem[1]))


def check_sp_resume(dev, b=1, t=1024, before=3, after=2):
    """The SP trainer of phase 7 at B=1, T=1024: ``before`` steps,
    ``save_sharded_checkpoint``, ``after`` more; a fresh trainer restores
    the checkpoint and takes the same ``after`` steps: its parameters and
    momentum equal the uninterrupted run's bitwise."""
    import shutil
    ckdir = os.path.join(HERE, "build", "ckpt7")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    prefix = os.path.join(ckdir, "sp")
    try:
        batch = _train_batch(31, b, t)
        tr = _sp_trainer(dev, b, t)
        for _ in range(before):
            tr.step(batch)
        t0 = time.perf_counter()
        tr.save_sharded_checkpoint(prefix)
        save_s = time.perf_counter() - t0
        want = [tr.step(batch).item() for _ in range(after)]
        flat, state = tr._flat.clone(), [x.clone()
                                         for x in tr._state.buffers()]
        del tr
        fresh = _sp_trainer(dev, b, t)
        t0 = time.perf_counter()
        fresh.restore_sharded_checkpoint(prefix)
        load_s = time.perf_counter() - t0
        got = [fresh.step(batch).item() for _ in range(after)]
        torch.cuda.synchronize()
        if got != want or not torch.equal(fresh._flat, flat) or not all(
                torch.equal(x, y)
                for x, y in zip(fresh._state.buffers(), state)):
            raise AssertionError(
                "sp resume: the restored trainer's next %d steps differ from "
                "the uninterrupted run's: losses %r against %r, max |diff| "
                "%.3g" % (after, got, want,
                          (fresh._flat - flat).abs().max().item()))
        log("sp resume: %d steps at B=%d T=%d, save_sharded_checkpoint %.3f "
            "s, restore %.3f s; the next %d steps' losses %s and the "
            "parameters and momentum equal the uninterrupted run's bitwise; "
            "%s" % (before, b, t, save_s, load_s, after,
                    " ".join("%.5f" % v for v in got), card_line()))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


# -- main -------------------------------------------------------------------

# -- phase 7b: the classic API --------------------------------------------------

CLASSIC_WARM, CLASSIC_STEPS = 2, 5
CLASSIC_DOT = 4096
CLASSIC_RESNET_B, CLASSIC_RESNET_BATCHES = 64, 4
CLASSIC_PRED_B, CLASSIC_PRED_BATCHES = 256, 2
RESNET_CHAINS = 53          # conv -> BatchNorm chains of ResNet-50's eval
RESNET_POINTWISE = 33       # of them 1x1 stride-1 (matmul_stats in training)
MLP_TOL = 1e-5


def _line7b(t0, what, text):
    log("phase 7b %s: %s (%.1f s into the phase)" % (
        what, text, time.perf_counter() - t0))


def classic_ndarray(dev, t0):
    """7b.1: NDArray on gpu(0): views write through, ``dot`` at [4096,
    4096] f32 against the host, a save/load round trip, ``mx.random``
    reproducible under ``seed``."""
    import mxnet_tpu_torch as mx
    ctx = mx.gpu(0)
    a = mx.nd.zeros((6, 4), ctx=ctx)
    a[2:4][:] = 7.0
    a.reshape((4, 6))[0:1] = 1.0
    row = a[5]
    row += 2.0
    want = np.zeros((6, 4), np.float32)
    want[2:4] = 7.0
    want.reshape(4, 6)[0] = 1.0
    want[5] += 2.0
    if not np.array_equal(a.asnumpy(), want) or a._tensor.device != dev:
        raise AssertionError("NDArray views on the card: %r" % a.asnumpy())
    n = CLASSIC_DOT
    rs = np.random.RandomState(0)
    x = rs.standard_normal((n, n)).astype(np.float32)
    y = rs.standard_normal((n, n)).astype(np.float32)
    xd, yd = mx.nd.array(x, ctx), mx.nd.array(y, ctx)
    z = mx.nd.dot(xd, yd).asnumpy()
    ref = x @ y
    err = float(np.abs(z - ref).max() / np.abs(ref).max())
    if not err <= TOL[torch.float32][0]:
        raise AssertionError("nd.dot on the card: %.3g of the largest "
                             "element" % err)
    ms = Timer(dev)(lambda: mx.nd.dot(xd, yd))
    _line7b(t0, "nd", "views write through on %s; dot [%d, %d] f32 max "
            "|err| %.3g of the largest element against the host; %.4f ms "
            "(%.1f TFLOP/s); %s" % (a.context, n, n, err, ms,
                                    2.0 * n ** 3 / ms / 1e9, card_line()))
    path = os.path.join(HERE, "build", "nd7b.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mx.nd.save(path, {"x": xd, "a": a})
    back = mx.nd.load(path)
    os.remove(path)
    if back["x"].context != mx.cpu() \
            or not np.array_equal(back["x"].asnumpy(), x) \
            or not np.array_equal(back["a"].asnumpy(), want):
        raise AssertionError("nd.save/nd.load round trip")
    draws = []
    for _ in range(2):
        mx.random.seed(7)
        draws.append((mx.random.uniform(-1, 1, (1000, 1000), ctx=ctx)
                      .asnumpy(), mx.random.normal(2, 3, (1000, 1000),
                                                   ctx=ctx).asnumpy()))
    u, g = draws[0]
    if not all(np.array_equal(p, q) for p, q in zip(*draws)) \
            or abs(u.mean()) > 0.01 or abs(g.mean() - 2) > 0.01 \
            or abs(g.std() - 3) > 0.01:
        raise AssertionError("mx.random on the card: not reproducible or "
                             "off its moments")
    _line7b(t0, "nd", "save/load round trip to cpu() bitwise; mx.random "
            "reproducible under seed on the card, uniform mean %.4f, "
            "normal mean %.4f std %.4f" % (u.mean(), g.mean(), g.std()))


def _classic_lm_step(exe, names, updater):
    def step():
        exe.forward(is_train=True)
        exe.backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
    return step


def classic_lm(K, dev, t0):
    """7b.2: the 124M LM of phase 5 (f32) through ``simple_bind`` on
    gpu(0), phase 5's seeded weights, SGD through ``get_updater``: warm-up
    and timed forward/backward/update steps with exact launches and a
    falling loss, ms a step, a 2-step profile, peak memory; then one f32
    step at B=1 T=128 against ``ParallelTrainer(device=None)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import get_transformer_lm
    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS, impl="flash")
    names = [n for n in symbol.list_arguments()
             if n not in ("data", "softmax_label")]
    torch.cuda.reset_peak_memory_stats()
    exe = symbol.simple_bind(mx.gpu(0), data=(TRAIN_B, TRAIN_T),
                             softmax_label=(TRAIN_B, TRAIN_T))
    exe.copy_params_from(dict(_trainer(dev, TRAIN_B, TRAIN_T, None).params))
    batch = _train_batch(7, TRAIN_B, TRAIN_T)
    for k, v in batch.items():
        exe.arg_dict[k][:] = v
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    updater = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", learning_rate=1e-3, momentum=0.9, rescale_grad=1.0 / TRAIN_B))
    step = _classic_lm_step(exe, names, updater)
    losses = []
    for _ in range(CLASSIC_WARM):
        step()
        losses.append(_lm_train_loss([exe.outputs[0]._tensor], label))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    card_ms, wall = [], []
    for _ in range(CLASSIC_STEPS):
        a, b = Timer._events(1)[0]
        w0 = time.perf_counter()
        a.record()
        step()
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        card_ms.append(a.elapsed_time(b))
        losses.append(_lm_train_loss([exe.outputs[0]._tensor], label))
    launches = _check_launches(K, "phase 7b.2 executor", {
        e: LAYERS * CLASSIC_STEPS for e in TRAIN_ENTRIES})
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError("phase 7b.2: the loss did not fall: %r"
                             % losses)
    mem = memory()
    med = statistics.median(card_ms)
    _line7b(t0, "lm", "124M LM through simple_bind(mx.gpu(0), data=(%d, "
            "%d)) f32, SGD lr 1e-3 momentum 0.9 via get_updater (%d "
            "parameters a step); %d timed steps: ms a step by CUDA events "
            "median %.3f (min %.3f, max %.3f), wall %.3f, %.1f tokens/s; "
            "loss %s; launches %s; %s; %s" % (
                TRAIN_B, TRAIN_T, len(names), CLASSIC_STEPS, med,
                min(card_ms), max(card_ms), statistics.median(wall),
                TRAIN_B * TRAIN_T / med * 1e3,
                " ".join("%.4f" % v for v in losses),
                json.dumps({e: n for e, n in launches.items() if n}), mem,
                card_line()))
    REPORT["classic_lm_ms"] = med
    wall_ms, kern_ms, busy = profile_train(
        None, None, steps=2, trace=None, what="phase 7b.2 executor step",
        call=step)
    _line7b(t0, "lm", "2-step profile: wall %.3f ms a step, card kernels "
            "%.3f, busy share %.3f, idle share %.3f" % (
                wall_ms, kern_ms, busy, 1.0 - busy))
    # debug_str resets the card's peak counter to measure its forward's
    # temporaries: the phase's peak (mem) is read above, before it, and
    # nothing after it reads the peak
    _line7b(t0, "lm", "debug_str: %s" % exe.debug_str().splitlines()[-1])
    del exe, step
    free_programs()
    classic_lm_against_trainer(dev, symbol, names, t0)
    return launches


def classic_lm_against_trainer(dev, symbol, names, t0, b=1, t=128):
    """One f32 step of the 124M LM at B=1 T=128 through the Executor (the
    default context, gpu(0)) and through ``ParallelTrainer(device=None)``
    from the same weights and lr: per-tensor delta norms within
    DELTA_REL."""
    import mxnet_tpu_torch as mx
    if mx.current_context() != mx.gpu(0):
        raise AssertionError("the default context is %s"
                             % mx.current_context())
    tr = _trainer(None, b, t, None)
    exe = symbol.simple_bind(mx.current_context(), data=(b, t),
                             softmax_label=(b, t))
    exe.copy_params_from(dict(tr.params))
    before = {n: v.clone() for n, v in tr.params.items()}
    batch = _train_batch(11, b, t)
    for k, v in batch.items():
        exe.arg_dict[k][:] = v
    _classic_lm_step(exe, names, mx.optimizer.get_updater(
        mx.optimizer.create("sgd", learning_rate=1e-3, momentum=0.9,
                            rescale_grad=1.0 / b)))()
    tr.step(batch)
    rows = []
    for n in names:
        dt = tr.params[n] - before[n]
        de = exe.arg_dict[n]._tensor - before[n]
        rows.append((((de - dt).norm() / dt.norm()).item(), n))
    rows.sort(reverse=True)
    if not rows[0][0] <= DELTA_REL:
        raise AssertionError("phase 7b.2: executor vs trainer deltas %s "
                             "(gate %g)" % (rows[:5], DELTA_REL))
    _line7b(t0, "lm", "one f32 step at B=%d T=%d, Executor against "
            "ParallelTrainer(device=None) from the same weights: %d "
            "parameter deltas agree, worst in norm %s %.3g (gate %g)" % (
                b, t, len(rows), rows[0][1], rows[0][0], DELTA_REL))


def classic_resnet(K, dev, t0):
    """7b.3: ResNet-50 through FeedForward(ctx=mx.gpu(0)) in f32: fit on
    the default (fused) loop and on the legacy loop (MXNET_FUSED_FIT=0,
    the conv-BN train gate on, kvstore "local") over an NDArrayIter of
    4 seeded batches of 64, in turns, with exact matmul_stats launches on
    the legacy loop, img/s and the card's busy share of each second fit;
    then predict and score over 2 batches of 256 with exact
    fused_conv_bn_act launches, score equal to predict's accuracy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import get_resnet
    sym = get_resnet(RESNET_CLASSES, RESNET_LAYERS)
    args, aux = _resnet_scaled_params(5)
    rs = np.random.RandomState(3)
    n = CLASSIC_RESNET_B * CLASSIC_RESNET_BATCHES
    X = rs.rand(n, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, n).astype(np.float32)
    launches = collections.Counter()
    rates = {}
    for turn in range(2):
        for fused in (True, False):
            what = "fused" if fused else "legacy"
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if turn else contextlib.nullcontext()
            w0 = time.perf_counter()
            with prof:
                stamps, _, got, trainer, _ = _fit_on_card(
                    K, sym, X, y, args, aux, fused, CLASSIC_RESNET_B)
            wall = time.perf_counter() - w0
            if (trainer is not None) != fused:
                raise AssertionError("phase 7b.3: fit took the %s loop" % (
                    "legacy" if fused else "fused"))
            del trainer
            want = {} if fused else {
                "matmul_stats": RESNET_POINTWISE * CLASSIC_RESNET_BATCHES}
            full = dict.fromkeys(got, 0)
            full.update(want)
            if got != full:
                raise AssertionError("phase 7b.3 %s fit: launches %r, want "
                                     "%r" % (what, got, full))
            launches.update(got)
            step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
            busy = ""
            if turn:
                kern = sum(e.self_device_time_total
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA) / 1e6
                busy = "; over the whole fit call (set-up included) %.3f " \
                    "s wall, %.3f s card kernels, busy share %.3f, idle " \
                    "share %.3f" % (wall, kern, kern / wall, 1 - kern / wall)
                rates[what] = CLASSIC_RESNET_B / step_s
            _line7b(t0, "resnet", "ResNet-50 f32 FeedForward(ctx=mx.gpu(0))"
                    ".fit on the %s loop%s, B=%d, %d batches (turn %d): "
                    "%.3f ms a step (batch ends 1-%d), %.1f img/s; "
                    "launches %s%s; %s" % (
                        what, "" if fused else " (MXNET_FUSED_FIT=0, %s=1, "
                        "kvstore local)" % GATE, CLASSIC_RESNET_B,
                        CLASSIC_RESNET_BATCHES, turn, step_s * 1e3,
                        len(stamps), CLASSIC_RESNET_B / step_s,
                        json.dumps({e: c for e, c in got.items() if c}),
                        busy, card_line()))
            free_programs()
    _line7b(t0, "resnet", "legacy over fused img/s %.3f" % (
        rates["legacy"] / rates["fused"]))
    del X, y
    pb, nb = CLASSIC_PRED_B, CLASSIC_PRED_BATCHES
    Xp = rs.rand(pb * nb, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    yp = rs.randint(0, RESNET_CLASSES, pb * nb).astype(np.float32)
    model = mx.model.FeedForward(
        sym, ctx=mx.gpu(0), numpy_batch_size=pb,
        arg_params={k: mx.nd.array(v) for k, v in args.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    want = {"fused_conv_bn_act": RESNET_CHAINS * nb}
    K.reset_launch_counts()
    w0 = time.perf_counter()
    prob = model.predict(mx.io.NDArrayIter(Xp, yp, batch_size=pb))
    p_secs = time.perf_counter() - w0
    got = _check_launches(K, "phase 7b.3 predict", want)
    launches.update(got)
    K.reset_launch_counts()
    w0 = time.perf_counter()
    acc = model.score(mx.io.NDArrayIter(Xp, yp, batch_size=pb), "acc")
    s_secs = time.perf_counter() - w0
    launches.update(_check_launches(K, "phase 7b.3 score", want))
    want_acc = float((prob.argmax(axis=1) == yp).mean())
    if prob.shape != (pb * nb, RESNET_CLASSES) \
            or not np.isfinite(prob).all() \
            or not np.allclose(prob.sum(axis=1), 1.0, atol=1e-4) \
            or abs(acc - want_acc) > 1e-9:
        raise AssertionError("phase 7b.3 predict/score: shape %s, score "
                             "%r against predict's %r" % (prob.shape, acc,
                                                          want_acc))
    _line7b(t0, "resnet", "predict over %d batches of %d: %.3f s (%.1f "
            "img/s, host copies included), score %.3f s, accuracy %.5f = "
            "predict's argmax; %d fused_conv_bn_act launches a forward; %s"
            % (nb, pb, p_secs, pb * nb / p_secs, s_secs, acc, RESNET_CHAINS,
               card_line()))
    return dict(launches)


def _mlp_symbol(num_hidden=64, k=5):
    import mxnet_tpu_torch as mx
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=num_hidden)
    act = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act, name="fc2", num_hidden=k)
    return mx.sym.SoftmaxOutput(data=fc2, name="softmax")


def classic_mlp(K, dev, t0):
    """7b.4: an MLP through the legacy fit on the card (MXNET_FUSED_FIT=0):
    ctx=[gpu(0)] * 2 against [gpu(0)] within MLP_TOL after 2 epochs; a
    Monitor(1) reports every node; crash and resume from
    fit(checkpoint_prefix=) equals the uninterrupted run bitwise."""
    import shutil
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(7)
    X = rs.randn(2000, 20).astype(np.float32)
    y = np.argmax(X @ rs.randn(20, 5), axis=1).astype(np.float32)
    sym = _mlp_symbol()
    arg_shapes, _, _ = sym.infer_shape(data=(100, 20))
    init = {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    saved = os.environ.get("MXNET_FUSED_FIT")
    os.environ["MXNET_FUSED_FIT"] = "0"
    try:
        def run(ctx, epochs=2, **kw):
            model = mx.model.FeedForward(
                sym, ctx=ctx, num_epoch=epochs, learning_rate=0.1,
                momentum=0.9, wd=1e-4,
                arg_params={n: mx.nd.array(v) for n, v in init.items()})
            model.fit(mx.io.NDArrayIter(X, y, batch_size=100),
                      kvstore="local", **kw)
            return model

        one, two = run([mx.gpu(0)]), run([mx.gpu(0)] * 2)
        err = max(float(np.abs(one.arg_params[n].asnumpy()
                               - two.arg_params[n].asnumpy()).max())
                  for n in init)
        if not err <= MLP_TOL:
            raise AssertionError("phase 7b.4: 2 contexts against 1: %.3g"
                                 % err)
        acc = one.score(mx.io.NDArrayIter(X, y, batch_size=100))
        _line7b(t0, "mlp", "legacy fit ctx=[gpu(0)] * 2 (kvstore "
                "local_update_cpu) against [gpu(0)]: parameters within "
                "%.3g after 2 epochs (gate %g); accuracy %.4f" % (
                    err, MLP_TOL, acc))

        class Recorder(mx.Monitor):
            rows = []

            def toc_print(self):
                self.rows.extend(self.toc())

        mon = Recorder(1)
        run([mx.gpu(0)], epochs=1, monitor=mon)
        nodes = {"fc1_output", "relu1_output", "fc2_output",
                 "softmax_output"} | set(sym.list_arguments())
        per_step = collections.defaultdict(set)
        for step, name, _ in mon.rows:
            per_step[step].add(name)
        if len(per_step) != 20 or any(s != nodes
                                      for s in per_step.values()):
            raise AssertionError("phase 7b.4: the monitor saw %r"
                                 % dict(per_step))
        ckpt = os.path.join(HERE, "build", "ckpt7b")
        shutil.rmtree(ckpt, ignore_errors=True)
        os.makedirs(ckpt)
        prefix = os.path.join(ckpt, "mlp")
        straight = run([mx.gpu(0)], epochs=3)

        def crash(epoch, *_):
            if epoch == 1:
                raise RuntimeError("killed")

        try:
            run([mx.gpu(0)], epochs=3, checkpoint_prefix=prefix,
                epoch_end_callback=crash)
            raise AssertionError("phase 7b.4: the crash did not happen")
        except RuntimeError:
            pass
        resumed = run([mx.gpu(0)], epochs=3, checkpoint_prefix=prefix)
        shutil.rmtree(ckpt, ignore_errors=True)
        if resumed.begin_epoch != 1 or not all(
                torch.equal(resumed.arg_params[n]._tensor,
                            straight.arg_params[n]._tensor) for n in init):
            raise AssertionError("phase 7b.4: the resumed run differs from "
                                 "the uninterrupted one")
        _line7b(t0, "mlp", "Monitor(1): every node and argument reported "
                "at each of %d batches; crash at epoch 2 and resume from "
                "fit(checkpoint_prefix=): parameters equal the "
                "uninterrupted run's bitwise" % len(per_step))
    finally:
        os.environ.pop("MXNET_FUSED_FIT", None)
        if saved is not None:
            os.environ["MXNET_FUSED_FIT"] = saved


def classic_serving(K, dev, prefix, work, streams, t0):
    """7b.5: FeedForward.load of phase 4's checkpoint, as_serving_engine
    with phase 4's settings: one wave of phase 4's requests with exact
    launches from engine.stats and streams equal to phase 4's."""
    import mxnet_tpu_torch as mx
    model = mx.model.FeedForward.load(prefix, 0, ctx=mx.gpu(0))
    engine = model.as_serving_engine(
        MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused", compute_dtype="bfloat16",
        prefix_cache_mb=0, prefill_chunk=0)
    rs = np.random.RandomState(2)
    for p in BUCKETS:
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    steps = (engine.stats["steps"] - stats0["steps"]) * STEPS_PER_ROUND
    prefills = engine.stats["prefills"] - stats0["prefills"]
    launches = _check_launches(K, "phase 7b.5 as_serving_engine", {
        "fused_decode_attention": LAYERS * steps,
        "paged_attention_chunk": LAYERS * prefills,
        "quant_matmul": (2 * LAYERS + 1) * steps
        + (4 * LAYERS + 1) * prefills})
    if [h.tokens for h in handles] != streams:
        raise AssertionError("phase 7b.5: the engine's streams differ from "
                             "phase 4's")
    tps, p50, p99 = _wave_metrics(handles, secs)
    _line7b(t0, "serving", "FeedForward.load -> as_serving_engine (phase "
            "4's settings): %d requests, %d tokens in %.3f s = %.1f "
            "tokens/s; ms per token p50 %.3f p99 %.3f; TTFT p50 %.3f ms; "
            "streams equal phase 4's; launches %s; %s" % (
                len(handles), sum(len(h.tokens) for h in handles), secs,
                tps, p50, p99, _ttft_p50(handles),
                json.dumps({e: n for e, n in launches.items() if n}),
                card_line()))
    engine.close()
    return launches


def classic_main_path(K, dev, prefix, work, streams):
    """Phase 7b, the classic API: NDArray, the Executor, FeedForward's two
    loops, predict/score, the Monitor, crash-resume and
    ``as_serving_engine``. Returns the launches of its gated runs."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    classic_ndarray(dev, t0)
    launches.update(classic_lm(K, dev, t0))
    free_programs()
    launches.update(classic_resnet(K, dev, t0))
    free_programs()
    classic_mlp(K, dev, t0)
    free_programs()
    launches.update(classic_serving(K, dev, prefix, work, streams, t0))
    free_programs()
    _line7b(t0, "done", "launches %s" % json.dumps(
        {e: n for e, n in launches.items() if n}))
    return dict(launches)


def time_classic_kernels(K, dev, gen, timed):
    """The f32 shapes the Executor's LM puts on a path (phase 7b): the
    flash forward at B=8 T=1024 H=12 D=64 causal beside SDPA f32 (TF32
    off), and fused_linear at ffn1 M=8192 K=768 N=3072 relu beside
    F.linear + relu in f32; rows "lm_f32" of the kernels line."""
    import torch.nn.functional as F
    timer = Timer(dev)
    b, t, h, d = 8, 1024, 12, 64
    q, k, v, _ = _flash_inputs(gen, b, t, h, d, torch.float32, dev)
    o, _ = K.flash_attention_fwd(q, k, v, causal=True)
    po, plse = K.flash_attention_fwd_plain(q, k, v, True)
    err = compare("flash fwd o B=8 T=1024 H=12 D=64 causal f32", o, po)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kms = timer(lambda: K.flash_attention_fwd(q, k, v, causal=True))
    pms = timer(lambda: K.flash_attention_fwd_plain(q, k, v, True))
    lms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    pairs = t * (t + 1) // 2 * b * h
    bms, by = bound_ms(4 * nbytes(q) + nbytes(plse), 4 * d * pairs,
                       torch.float32)
    shape = "B=8 T=1024 H=12 D=64 causal f32"
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(SDPA f32, TF32 off)  bound %.4f ms (%s); max |err| %.3g" % (
            "flash_attention_fwd", shape, kms, pms, lms, bms, by, err))
    timed["flash_attention_fwd"]["lm_f32"] = {
        "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
        "bound_by": by, "shape": shape, "max_abs_err": err}
    m, kd, n = 8192, 768, 3072
    x = _rand(gen, (m, kd)).to(dev)
    w = _rand(gen, (n, kd), scale=1.0 / math.sqrt(kd)).to(dev)
    bias = _rand(gen, (n,), scale=0.1).to(dev)
    out = K.fused_linear_fwd(x, w, bias, "relu")
    err = compare("fused_linear ffn1 M=8192 K=768 N=3072 f32 relu", out,
                  K.fused_linear_plain(x, w, bias, "relu"))
    kms = timer(lambda: K.fused_linear_fwd(x, w, bias, "relu"))
    pms = timer(lambda: K.fused_linear_plain(x, w, bias, "relu"))
    lms = timer(lambda: torch.relu(F.linear(x, w, bias)))
    bms, by = bound_ms(nbytes(x, w, bias, out), 2 * m * n * kd,
                       torch.float32)
    shape = "ffn1 M=8192 K=768 N=3072 f32 relu"
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(F.linear f32, TF32 off, + relu)  bound %.4f ms (%s); max |err| "
        "%.3g" % ("fused_linear", shape, kms, pms, lms, bms, by, err))
    timed["fused_linear"]["lm_f32"] = {
        "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
        "bound_by": by, "shape": shape, "max_abs_err": err}


# -- phase 7c: the model zoo through the classic API --------------------------

ZOO_HW = {"inception-bn": 224, "inception-v3": 299, "vgg": 224,
          "alexnet": 224, "fcn-xs": 224}
ZOO_CLASSES = 1000
ZOO_FIT_B, ZOO_FIT_BATCHES, ZOO_FIT_EPOCHS = 64, 4, 2
ZOO_PRED_B, ZOO_PRED_BATCHES = 256, 2
ZOO_V3_B, ZOO_VGG_B, ZOO_ALEX_B, ZOO_FCN_B = 64, 64, 64, 1
ZOO_HOST_B = 2
ZOO_LR = 0.01                       # train_imagenet.py's --lr default
INCEPTION_BN_CHAINS = 69            # conv -> BatchNorm -> relu chains
INCEPTION_BN_POINTWISE = 37         # of them 1x1 stride-1 unpadded
INCEPTION_V3_CHAINS = 94
VGG_FC_CHAINS = ALEXNET_FC_CHAINS = 2   # fc6, fc7: FullyConnected -> relu
FCN_CLASSES = 21
# example/rnn/lstm_ptb.py's defaults over a 10000-word vocabulary
LSTM_PTB = dict(num_lstm_layer=2, seq_len=32, input_size=10000,
                num_hidden=200, num_embed=200, num_label=10000)
LSTM_B = 32
# example/autoencoder/mnist_sae.py: its default dims, data, batch and lr,
# with a nonzero sparsity penalty (enc_0, enc_1 and dec_1 end in a relu)
SAE_DIMS, SAE_PEN, SAE_FC_CHAINS = (784, 256, 64), 1e-3, 3
SAE_N, SAE_B, SAE_LR = 6000, 100, 0.02


def _line7c(t0, what, text):
    log("phase 7c %s: %s (%.1f s into the phase)" % (
        what, text, time.perf_counter() - t0))


def _zoo_params(sym, shapes, seed):
    """Seeded f32 parameters for ``sym`` at input ``shapes`` (numpy):
    fan-in scaled weights (sqrt(2 / fan-in), so activations stay O(1)
    through the relu stacks and the logits O(1)), gammas 1 + 0.1 N(0, 1),
    biases and betas 0.1 N(0, 1), moving means 0.1 N(0, 1) and variances
    U(0.5, 1.5); drawn by a torch generator on the host (VGG-16's 138 M
    values in well under a second)."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    gen = torch.Generator().manual_seed(seed)

    def normal(sh, scale):
        return (torch.randn(sh, generator=gen) * scale).numpy()

    args = {}
    for n, sh in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            args[n] = normal(sh, math.sqrt(2.0 / np.prod(sh[1:])))
        elif n.endswith("_gamma"):
            args[n] = 1.0 + normal(sh, 0.1)
        else:
            args[n] = normal(sh, 0.1)
    aux = {n: normal(sh, 0.1) if n.endswith("mean")
           else (torch.rand(sh, generator=gen) + 0.5).numpy()
           for n, sh in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _fit_on_card(K, sym, X, y, args, aux, fused, batch_size, num_epoch=1,
                 lr=1e-3, eval_metric="acc", shuffle=False):
    """FeedForward(ctx=mx.gpu(0)).fit over an NDArrayIter of (X, y): the
    fused loop by default, or the legacy loop with the conv-BN train gate
    on (MXNET_FUSED_FIT=0, kvstore "local"). Returns (batch-end times, the
    metric of each batch alone, launches, the fused loop's trainer or
    None, the model)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import model as mx_model
    ran = []
    real = mx_model._train_fused

    def spy(*a, **kw):
        trainer = real(*a, **kw)
        ran.append(trainer)
        return trainer

    env = {} if fused else {"MXNET_FUSED_FIT": "0", GATE: "1"}
    saved = {k: os.environ.get(k) for k in ("MXNET_FUSED_FIT", GATE)}
    stamps, per_batch, last = [], [], [0.0, 0]

    def batch_end(p):
        stamps.append(time.perf_counter())
        m = p.eval_metric
        if m.num_inst < last[1]:            # the epoch's reset
            last[:] = [0.0, 0]
        per_batch.append((m.sum_metric - last[0])
                         / max(m.num_inst - last[1], 1))
        last[:] = [m.sum_metric, m.num_inst]

    mx_model._train_fused = spy
    try:
        for k in saved:
            os.environ.pop(k, None)
        os.environ.update(env)
        model = mx.model.FeedForward(
            sym, ctx=mx.gpu(0), num_epoch=num_epoch, optimizer="sgd",
            learning_rate=lr, momentum=0.9,
            arg_params=None if args is None else {
                k: mx.nd.array(v) for k, v in args.items()},
            aux_params=None if aux is None else {
                k: mx.nd.array(v) for k, v in aux.items()})
        K.reset_launch_counts()
        model.fit(mx.io.NDArrayIter(X, y, batch_size=batch_size,
                                    shuffle=shuffle),
                  kvstore="local", eval_metric=eval_metric,
                  batch_end_callback=batch_end)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    finally:
        mx_model._train_fused = real
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return stamps, per_batch, launches, (ran[0] if ran else None), model


def _zoo_against_host(dev, t0, what, sym, hw, args, aux, seed, train):
    """ZOO_HOST_B images from the same weights through
    ``ParallelTrainer`` on the card (the kernels) and on the host (their
    plain versions), f32: the eval log-probabilities within LOGP_ATOL and
    the same top-1. With ``train`` (and MXNET_PALLAS_CONVBN_TRAIN=1), one
    SGD step on each and on the host in f64 (the exact step, to f32's
    rounding): each parameter's card delta within DELTA_REL of the f64
    delta by norm, or no further from it than twice the host's own f32
    delta is. Inception-BN's deltas at B=2 are ill-conditioned in f32 (a
    BatchNorm after a BatchNorm sums gradients that cancel, and the ReLU
    kink flips single units): the host's f32 step itself lies ~3% from the
    f64 step in norm (PERF.md §6), so two correct f32 steps cannot
    meet DELTA_REL against each other."""
    from mxnet_tpu_torch.parallel import ParallelTrainer
    b = ZOO_HOST_B
    rs = np.random.RandomState(seed)
    batch = {"data": rs.rand(b, 3, hw, hw).astype(np.float32),
             "softmax_label": rs.randint(0, ZOO_CLASSES, (b,)
                                         ).astype(np.int32)}
    res = {}
    runs = [(dev, None), ("cpu", None)] + ([("cpu", "float64")] if train
                                           else [])
    try:
        for where, dtype in runs:
            # the f32 steps with the conv-BN train gate on (matmul_stats
            # on the card); the f64 step unfused (the kernel takes f32
            # and bf16)
            if train and dtype is None:
                os.environ[GATE] = "1"
            else:
                os.environ.pop(GATE, None)
            tr = ParallelTrainer(
                sym, {"data": (b, 3, hw, hw), "softmax_label": (b,)},
                optimizer="sgd", optimizer_params={
                    "learning_rate": ZOO_LR, "momentum": 0.9},
                seed=0, device=where, compute_dtype=dtype)
            tr.init_params(args, aux)
            logp = torch.log(tr.forward(batch)[0].cpu())
            deltas = None
            if train:
                before = {n: v.clone() for n, v in tr.params.items()}
                tr.step(batch)
                deltas = {n: (tr.params[n] - before[n]).cpu().double()
                          for n in before}
            res[(str(where), dtype)] = (logp, deltas)
            del tr
            free_programs()
    finally:
        os.environ.pop(GATE, None)
    (lc, card), (lh, host) = res[(str(dev), None)], res[("cpu", None)]
    lerr = (lc - lh).abs().max().item()
    top = lh.topk(2, dim=1).values
    gap = (top[:, 0] - top[:, 1]).min().item()
    same = torch.equal(lc.argmax(dim=1), lh.argmax(dim=1))
    rows = []
    if train:
        exact = res[("cpu", "float64")][1]
        for n, d64 in exact.items():
            ref = d64.norm().item()
            c, h = (card[n] - d64).norm().item(), (host[n] - d64).norm().item()
            rows.append((c / max(DELTA_REL * ref, 2 * h, 1e-30),
                         c / max(ref, 1e-30), h / max(ref, 1e-30),
                         ((card[n] - host[n]).norm() / max(ref, 1e-30)
                          ).item(), n))
        rows.sort(reverse=True)
    # written so that a NaN fails every gate
    if not (lerr <= LOGP_ATOL and same) or not all(r[0] <= 1 for r in rows):
        raise AssertionError(
            "phase 7c %s card vs host: eval log-probabilities max |err| "
            "%.3g (gate %g), top-1 equal %s; worst deltas (over the gate, "
            "card and host f32 from f64, card from host, by norm) %s" % (
                what, lerr, LOGP_ATOL, same,
                ["%s %.3g %.3g %.3g %.3g" % (n, r, c, h, ch)
                 for r, c, h, ch, n in rows[:5]]))
    text = "B=%d f32 from the same weights, card against host: eval " \
        "log-probabilities max |err| %.3g (gate %g), top-1 equal (smallest " \
        "top-2 gap %.3g)" % (b, lerr, LOGP_ATOL, gap)
    if train:
        r, c, h, ch, n = rows[0]
        text += "; one SGD step (lr %g, %s=1) against the host's f64 step: " \
            "%d parameter deltas pass, worst %s at %.3g of its gate (card " \
            "%.3g, host f32 %.3g of the f64 delta's norm from it); largest " \
            "card and host f32 distances from it %.3g, %.3g; card from host " \
            "f32 at most %.3g" % (
                ZOO_LR, GATE, len(rows), n, r, c, h,
                max(x[1] for x in rows), max(x[2] for x in rows),
                max(x[3] for x in rows))
    _line7c(t0, what, text)


def _zoo_predict(K, dev, t0, what, sym, args, aux, b, nb, hw, want):
    """``FeedForward(ctx=mx.gpu(0)).predict`` over ``nb`` seeded batches of
    ``b`` with exactly ``want`` launches a forward; finite probabilities
    summing to 1. Returns (probabilities, labels, launches, seconds,
    model)."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(7)
    X = rs.rand(b * nb, 3, hw, hw).astype(np.float32)
    y = rs.randint(0, ZOO_CLASSES, b * nb).astype(np.float32)
    model = mx.model.FeedForward(
        sym, ctx=mx.gpu(0), numpy_batch_size=b,
        arg_params={k: mx.nd.array(v) for k, v in args.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    model.predict(mx.io.NDArrayIter(X[:b], batch_size=b))   # binds, warms
    torch.cuda.synchronize()
    K.reset_launch_counts()
    w0 = time.perf_counter()
    prob = model.predict(mx.io.NDArrayIter(X, y, batch_size=b))
    secs = time.perf_counter() - w0
    got = _check_launches(K, "phase 7c %s predict" % what,
                          {e: n * nb for e, n in want.items()})
    if prob.shape != (b * nb, ZOO_CLASSES) or not np.isfinite(prob).all() \
            or not np.allclose(prob.sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError("phase 7c %s predict: shape %s, finite %s" % (
            what, prob.shape, np.isfinite(prob).all()))
    _line7c(t0, what, "predict over %d batches of %d at %dx%d f32: %.3f s "
            "(%.1f img/s, host copies included); %s a forward; %s" % (
                nb, b, hw, hw, secs, b * nb / secs, json.dumps(want),
                card_line()))
    return prob, y, got, secs, model


def _chain_copies(K, model, X, b):
    """One predict batch of ``model`` with ``kernels._conv_operands``
    watched: how many conv -> BatchNorm chains got an x that is not
    channels-last in memory (each costs one NHWC copy before the kernel),
    and the forward's device kernels by kind under the profiler, with the
    copy kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    real = K._conv_operands
    copied = []

    def watched(x, *a):
        copied.append(not x.permute(0, 2, 3, 1).is_contiguous())
        return real(x, *a)

    K._conv_operands = watched
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.predict(mx.io.NDArrayIter(X[:b], batch_size=b))
            torch.cuda.synchronize()
    finally:
        K._conv_operands = real
    kinds, copies = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        key = e.key.lower()
        kind = ("concat" if "cat" in key and "copy" in key else
                "copy" if "copy" in key else "other")
        kinds[kind] += e.count
        if kind == "copy":
            copies[e.key[:70]] += e.count
    return sum(copied), len(copied), dict(kinds), dict(copies)


def zoo_inception_bn(K, dev, t0):
    """7c.1, the slice's main path: Inception-BN at full width (224 x 224,
    1000 classes, seeded weights) through FeedForward(ctx=mx.gpu(0)) in
    f32: fit for ZOO_FIT_EPOCHS epochs over an NDArrayIter of
    ZOO_FIT_BATCHES seeded batches of ZOO_FIT_B on the default (fused)
    loop and on the legacy loop (MXNET_FUSED_FIT=0, the conv-BN train gate
    on, kvstore "local": exactly 37 matmul_stats a step), in turns, the
    cross-entropy of the second epoch below the first's, ms a step, img/s
    and the busy share of each second fit, a 2-step profile of the fused
    fit's step; predict and score over ZOO_PRED_BATCHES batches of
    ZOO_PRED_B (exactly 69 fused_conv_bn_act a forward, score equal to
    predict's accuracy) and the chains whose x needs a copy; B=2 card
    against host, eval and one train step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.models  # noqa: F401  (mx.models)
    hw = ZOO_HW["inception-bn"]
    sym = mx.models.get_symbol("inception-bn", num_classes=ZOO_CLASSES)
    args, aux = _zoo_params(sym, {"data": (1, 3, hw, hw),
                                  "softmax_label": (1,)}, 21)
    rs = np.random.RandomState(5)
    n = ZOO_FIT_B * ZOO_FIT_BATCHES
    X = rs.rand(n, 3, hw, hw).astype(np.float32)
    y = rs.randint(0, ZOO_CLASSES, n).astype(np.float32)
    steps = ZOO_FIT_BATCHES * ZOO_FIT_EPOCHS
    launches = collections.Counter()
    rates = {}
    for turn in range(2):
        for fused in (True, False):
            what = "fused" if fused else "legacy"
            # the card's kernels only: recording every host op of a fit
            # makes the profile's summary take longer than the fit
            prof = profile(activities=[ProfilerActivity.CUDA]) \
                if turn else contextlib.nullcontext()
            w0 = time.perf_counter()
            with prof:
                stamps, losses, got, trainer, _ = _fit_on_card(
                    K, sym, X, y, args, aux, fused, ZOO_FIT_B,
                    ZOO_FIT_EPOCHS, ZOO_LR, "ce")
            wall = time.perf_counter() - w0
            if (trainer is not None) != fused:
                raise AssertionError("phase 7c inception-bn: fit took the "
                                     "other loop than the %s one" % what)
            want = {} if fused else {
                "matmul_stats": INCEPTION_BN_POINTWISE * steps}
            full = dict.fromkeys(got, 0)
            full.update(want)
            if got != full:
                raise AssertionError("phase 7c inception-bn %s fit: "
                                     "launches %r, want %r" % (what, got,
                                                               full))
            launches.update(got)
            first = statistics.mean(losses[:ZOO_FIT_BATCHES])
            second = statistics.mean(losses[ZOO_FIT_BATCHES:])
            if len(losses) != steps \
                    or not all(math.isfinite(v) for v in losses) \
                    or not second < first:
                raise AssertionError("phase 7c inception-bn %s fit: the "
                                     "loss did not fall: %r" % (what,
                                                                losses))
            step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
            busy = ""
            if turn:
                kern = sum(e.self_device_time_total
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA) / 1e6
                busy = "; over the whole fit call (set-up included) %.3f " \
                    "s wall, %.3f s card kernels, busy share %.3f, idle " \
                    "share %.3f" % (wall, kern, kern / wall, 1 - kern / wall)
                rates[what] = ZOO_FIT_B / step_s
                REPORT["inception_%s_ms" % what] = step_s * 1e3
            _line7c(t0, "inception-bn", "Inception-BN f32 FeedForward(ctx="
                    "mx.gpu(0)).fit on the %s loop%s, B=%d, %d batches x %d "
                    "epochs, SGD lr %g momentum 0.9 (turn %d): %.3f ms a "
                    "step (batch ends 1-%d), %.1f img/s; cross-entropy a "
                    "batch %s (epoch means %.4f -> %.4f); launches %s%s; %s"
                    % (what, "" if fused else " (MXNET_FUSED_FIT=0, %s=1, "
                       "kvstore local)" % GATE, ZOO_FIT_B, ZOO_FIT_BATCHES,
                       ZOO_FIT_EPOCHS, ZOO_LR, turn, step_s * 1e3,
                       len(stamps), ZOO_FIT_B / step_s,
                       " ".join("%.4f" % v for v in losses), first, second,
                       json.dumps({e: c for e, c in got.items() if c}),
                       busy, card_line()))
            if fused and turn:
                wall_ms, kern_ms, busy_p = profile_train(
                    trainer, {"data": X[:ZOO_FIT_B],
                              "softmax_label": y[:ZOO_FIT_B]},
                    trace="inception_fit_trace.json.gz",
                    what="phase 7c Inception-BN fused fit step")
                _line7c(t0, "inception-bn", "2-step profile of the fused "
                        "fit's step: wall %.3f ms a step, card kernels %.3f, "
                        "busy share %.3f (trace inception_fit_trace.json.gz)"
                        % (wall_ms, kern_ms, busy_p))
            del trainer
            free_programs()
    _line7c(t0, "inception-bn", "legacy over fused img/s %.3f" % (
        rates["legacy"] / rates["fused"]))
    del X, y
    pb, nb = ZOO_PRED_B, ZOO_PRED_BATCHES
    want = {"fused_conv_bn_act": INCEPTION_BN_CHAINS}
    prob, yp, got, p_secs, model = _zoo_predict(
        K, dev, t0, "inception-bn", sym, args, aux, pb, nb, hw, want)
    launches.update(got)
    Xp = np.random.RandomState(7).rand(pb * nb, 3, hw, hw).astype(np.float32)
    K.reset_launch_counts()
    w0 = time.perf_counter()
    acc = model.score(mx.io.NDArrayIter(Xp, yp, batch_size=pb), "acc")
    s_secs = time.perf_counter() - w0
    launches.update(_check_launches(K, "phase 7c inception-bn score", {
        e: n * nb for e, n in want.items()}))
    want_acc = float((prob.argmax(axis=1) == yp).mean())
    if abs(acc - want_acc) > 1e-9:
        raise AssertionError("phase 7c inception-bn: score %r against "
                             "predict's accuracy %r" % (acc, want_acc))
    copies, chains, kinds, names = _chain_copies(K, model, Xp, pb)
    _line7c(t0, "inception-bn", "score over the same %d images %.3f s, "
            "accuracy %.5f = predict's argmax; chains whose x is not "
            "channels-last (one NHWC copy each) %d of %d a forward; the "
            "forward's device kernels by kind %s, the copies %s" % (
                pb * nb, s_secs, acc, copies, chains, json.dumps(kinds),
                json.dumps(names)))
    del model, Xp, prob
    free_programs()
    _zoo_against_host(dev, t0, "inception-bn", sym, hw, args, aux, 9,
                      train=True)
    return dict(launches)


def zoo_predict_paths(K, dev, t0):
    """7c.2: Inception-v3 (299 x 299) predict at B=ZOO_V3_B with exactly
    94 fused_conv_bn_act a forward, and VGG-16 predict at B=ZOO_VGG_B with
    exactly 2 fused_linear a forward, each over 2 batches; each at B=2
    card against host (eval)."""
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.models  # noqa: F401  (mx.models)
    launches = collections.Counter()
    for name, b, want, seed in (
            ("inception-v3", ZOO_V3_B,
             {"fused_conv_bn_act": INCEPTION_V3_CHAINS}, 22),
            ("vgg", ZOO_VGG_B, {"fused_linear": VGG_FC_CHAINS}, 23)):
        hw = ZOO_HW[name]
        sym = mx.models.get_symbol(name, num_classes=ZOO_CLASSES)
        args, aux = _zoo_params(sym, {"data": (1, 3, hw, hw),
                                      "softmax_label": (1,)}, seed)
        _, _, got, _, model = _zoo_predict(K, dev, t0, name, sym, args, aux,
                                           b, 2, hw, want)
        launches.update(got)
        del model
        free_programs()
        _zoo_against_host(dev, t0, name, sym, hw, args, aux, seed,
                          train=False)
    return dict(launches)


def _bind_step(K, what, sym, shapes, fill, want):
    """One ``simple_bind(mx.gpu(0))`` forward(is_train=True) and backward
    with exactly ``want`` launches: the outputs have the inferred shapes
    and are finite, and so are the gradients. ``fill(name, shape)`` gives
    each argument's numpy value. Returns (outputs on the host, launches,
    ms of the forward and backward)."""
    import mxnet_tpu_torch as mx
    exe = sym.simple_bind(mx.gpu(0), **shapes)
    for n, arr in exe.arg_dict.items():
        arr[:] = fill(n, arr.shape)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    w0 = time.perf_counter()
    exe.forward(is_train=True)
    exe.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - w0) * 1e3
    got = _check_launches(K, "phase 7c %s" % what, want)
    _, out_shapes, _ = sym.infer_shape(**shapes)
    outs = [o.asnumpy() for o in exe.outputs]
    if [o.shape for o in outs] != [tuple(s) for s in out_shapes] \
            or not all(np.isfinite(o).all() for o in outs) \
            or not all(torch.isfinite(g._tensor).all()
                       for g in exe.grad_dict.values()):
        raise AssertionError("phase 7c %s: outputs %s against the inferred "
                             "%s, or not finite" % (
                                 what, [o.shape for o in outs], out_shapes))
    del exe
    return outs, got, ms


def zoo_simple_binds(K, dev, t0):
    """7c.3: AlexNet (LRN; B=ZOO_ALEX_B, exactly 2 fused_linear a forward),
    FCN-32s (Deconvolution, Crop; B=ZOO_FCN_B at 224 x 224, labels with
    the ignored 255) and the unrolled LSTM at lstm_ptb.py's defaults, one
    simple_bind forward/backward each on the card: the inferred shapes,
    finite outputs and gradients; the FCN's per-pixel and the LSTM's
    per-step probabilities sum to 1."""
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.models  # noqa: F401  (mx.models)
    launches = collections.Counter()
    rs = np.random.RandomState(31)
    hw = ZOO_HW["alexnet"]
    sym = mx.models.get_symbol("alexnet", num_classes=ZOO_CLASSES)
    shapes = {"data": (ZOO_ALEX_B, 3, hw, hw),
              "softmax_label": (ZOO_ALEX_B,)}
    args, _ = _zoo_params(sym, shapes, 24)
    args["data"] = rs.rand(*shapes["data"]).astype(np.float32)
    args["softmax_label"] = rs.randint(0, ZOO_CLASSES, ZOO_ALEX_B
                                       ).astype(np.float32)
    outs, got, ms = _bind_step(K, "alexnet", sym, shapes,
                               lambda n, s: args[n],
                               {"fused_linear": ALEXNET_FC_CHAINS})
    launches.update(got)
    if not np.allclose(outs[0].sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError("phase 7c alexnet: rows do not sum to 1")
    _line7c(t0, "alexnet", "AlexNet (LRN) simple_bind(mx.gpu(0), data=%s) "
            "f32 forward/backward %.1f ms, outputs %s finite, %d "
            "fused_linear a forward" % (shapes["data"], ms, outs[0].shape,
                                        ALEXNET_FC_CHAINS))
    free_programs()

    hw = ZOO_HW["fcn-xs"]
    sym = mx.models.get_symbol("fcn-xs", num_classes=FCN_CLASSES)
    shapes = {"data": (ZOO_FCN_B, 3, hw, hw),
              "softmax_label": (ZOO_FCN_B, hw, hw)}
    args, _ = _zoo_params(sym, shapes, 25)
    args["data"] = rs.rand(*shapes["data"]).astype(np.float32)
    label = rs.randint(0, FCN_CLASSES, shapes["softmax_label"])
    label[:, :8] = 255
    args["softmax_label"] = label.astype(np.float32)
    outs, got, ms = _bind_step(K, "fcn-32s", sym, shapes,
                               lambda n, s: args[n], {})
    launches.update(got)
    if not np.allclose(outs[0].sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError("phase 7c fcn-32s: pixels do not sum to 1")
    _line7c(t0, "fcn-32s", "FCN-32s (Deconvolution 64x64/32, Crop) "
            "simple_bind(mx.gpu(0), data=%s) f32 forward/backward %.1f ms, "
            "outputs %s finite, per-pixel probabilities sum to 1" % (
                shapes["data"], ms, outs[0].shape))
    free_programs()

    p = LSTM_PTB
    sym = mx.models.lstm_unroll(**p)
    shapes = {"data": (LSTM_B, p["seq_len"])}
    for i in range(p["num_lstm_layer"]):
        shapes["l%d_init_c" % i] = shapes["l%d_init_h" % i] = \
            (LSTM_B, p["num_hidden"])
    for t in range(p["seq_len"]):
        shapes["t%d_label" % t] = (LSTM_B,)

    def fill(n, s):
        if n == "data" or n.endswith("_label"):
            return rs.randint(0, p["input_size"], s).astype(np.float32)
        if "init" in n:
            return np.zeros(s, np.float32)
        return rs.uniform(-0.1, 0.1, s).astype(np.float32)

    outs, got, ms = _bind_step(K, "lstm", sym, shapes, fill, {})
    launches.update(got)
    if len(outs) != p["seq_len"] or not all(
            np.allclose(o.sum(axis=1), 1.0, atol=1e-4) for o in outs):
        raise AssertionError("phase 7c lstm: per-step probabilities")
    _line7c(t0, "lstm", "lstm_unroll (%d layers, %d hidden, %d embed, seq "
            "%d, vocab %d) simple_bind(mx.gpu(0), batch %d) f32 "
            "forward/backward %.1f ms: %d step heads %s, finite, each "
            "step's probabilities sum to 1" % (
                p["num_lstm_layer"], p["num_hidden"], p["num_embed"],
                p["seq_len"], p["input_size"], LSTM_B, ms, len(outs),
                outs[0].shape))
    free_programs()
    return dict(launches)


def sae_symbol(dims, sparse_pen):
    """``example/autoencoder/mnist_sae.py``'s ``autoencoder_symbol`` built
    with the port's ``mx.symbol`` (the example imports the JAX
    package)."""
    import mxnet_tpu_torch as mx
    data = mx.symbol.Variable("data")
    x = data
    for i, d in enumerate(dims[1:]):
        x = mx.symbol.FullyConnected(data=x, name="enc_%d" % i, num_hidden=d)
        x = mx.symbol.Activation(data=x, act_type="relu",
                                 name="enc_act_%d" % i)
        if sparse_pen > 0:
            x = mx.symbol.IdentityAttachKLSparseReg(
                data=x, penalty=sparse_pen, name="sparse_%d" % i)
    for i, d in reversed(list(enumerate(dims[:-1]))):
        x = mx.symbol.FullyConnected(data=x, name="dec_%d" % i, num_hidden=d)
        if i != 0:
            x = mx.symbol.Activation(data=x, act_type="relu",
                                     name="dec_act_%d" % i)
    return mx.symbol.LinearRegressionOutput(data=x, name="softmax")


def zoo_sparse_autoencoder(K, dev, t0):
    """7c.4: mnist_sae.py's sparse autoencoder (dims 784,256,64, its
    seeded data, batch 100, lr 0.02 momentum 0.9) with
    IdentityAttachKLSparseReg (penalty SAE_PEN) and LinearRegressionOutput:
    one FeedForward(ctx=mx.gpu(0)).fit epoch on the default loop, exactly
    3 fused_linear a step (enc_0, enc_1, dec_1; and a run of the step
    program's warm-ups), the last batch's MSE below the first's, and each
    moving_avg moved off its initial 0."""
    rng = np.random.RandomState(0)
    d0 = SAE_DIMS[0]
    base = rng.rand(20, d0).astype(np.float32) / 20.0
    coef = rng.rand(SAE_N, 20).astype(np.float32)
    x = coef @ base + 0.02 * rng.rand(SAE_N, d0).astype(np.float32)
    sym = sae_symbol(SAE_DIMS, SAE_PEN)
    w0 = time.perf_counter()
    stamps, mse, got, trainer, model = _fit_on_card(
        K, sym, x, x.copy(), None, None, True, SAE_B, 1, SAE_LR, "mse",
        shuffle=True)
    secs = time.perf_counter() - w0
    from mxnet_tpu_torch.parallel.program import WARMUP
    steps = SAE_N // SAE_B
    # the step program's first call runs it WARMUP times before capturing
    # it (the capture launches nothing), then replays it once a step
    got = _check_launches(K, "phase 7c sparse autoencoder fit", {
        "fused_linear": SAE_FC_CHAINS * (steps + WARMUP)})
    avg = {n: v.asnumpy() for n, v in model.aux_params.items()
           if n.endswith("moving_avg")}
    if trainer is None or len(mse) != steps \
            or not all(math.isfinite(v) for v in mse) \
            or not mse[-1] < mse[0] or len(avg) != len(SAE_DIMS) - 1 \
            or not all(np.isfinite(v).all() and np.abs(v).max() > 0
                       for v in avg.values()):
        raise AssertionError("phase 7c sparse autoencoder: fused loop %s, "
                             "MSE a batch %r, moving averages %r" % (
                                 trainer is not None, mse[::10], avg))
    _line7c(t0, "sae", "mnist_sae.py's autoencoder %s with "
            "IdentityAttachKLSparseReg(penalty=%g) and "
            "LinearRegressionOutput, FeedForward(ctx=mx.gpu(0)).fit one "
            "epoch of %d batches of %d (fused loop; %d fused_linear a step "
            "and in each of the step program's %d warm-ups): %.3f s; MSE "
            "first batch %.6f, last %.6f; moving_avg means %s; launches %s"
            % (
                ",".join(map(str, SAE_DIMS)), SAE_PEN, steps, SAE_B,
                SAE_FC_CHAINS, WARMUP, secs,
                mse[0], mse[-1], {n: round(float(v.mean()), 5)
                                  for n, v in sorted(avg.items())},
                json.dumps({e: n for e, n in got.items() if n})))
    del trainer, model
    return got


def zoo_main_path(K, dev):
    """Phase 7c, the model zoo through the classic API: Inception-BN's
    fit, predict, score and card-against-host checks (the slice's main
    path), Inception-v3 and VGG-16 predict, AlexNet, FCN-32s and the
    unrolled LSTM through simple_bind, and the sparse autoencoder's fit.
    Returns the launches of its gated runs."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    for part in (zoo_inception_bn, zoo_predict_paths, zoo_simple_binds,
                 zoo_sparse_autoencoder):
        launches.update(part(K, dev, t0))
        free_programs()
    _line7c(t0, "done", "launches %s" % json.dumps(
        {e: n for e, n in launches.items() if n}))
    return dict(launches)


def _time_stats(timer, K, x, w):
    """matmul_stats at x [M, K], w [N, K]: (kernel, plain, library ms,
    bound ms, bound by, max |y err|), after holding y to its plain
    version."""
    y, _, _ = K.matmul_stats_fwd(x, w)
    err = compare("matmul_stats y M=%d K=%d N=%d %s" % (
        x.shape[0], x.shape[1], w.shape[0], x.dtype), y,
        K.matmul_stats_plain(x, w)[0])

    def lib_stats():
        out = torch.matmul(x, w.t())
        return out.sum(dim=0, dtype=torch.float32), \
            out.float().square().sum(dim=0)

    m, kd = x.shape
    n = w.shape[0]
    bms, by = bound_ms(nbytes(x, w, y) + 2 * 4 * n,
                       2 * m * n * kd + 3 * m * n, x.dtype)
    return (timer(lambda: K.matmul_stats_fwd(x, w)),
            timer(lambda: K.matmul_stats_plain(x, w)), timer(lib_stats),
            bms, by, err)


def time_zoo_kernels(K, dev, gen, timed):
    """The f32 shapes phase 7c puts on a path, and the f32 shapes of
    phase 7b that were timed only elsewhere (rows of the kernels line):
    ``fused_conv_bn_act`` at Inception-v3's first 1x7 (in_b1, B=64) and at
    Inception-BN's 3x3 stride-2 conv (in3c, B=256), both on the implicit
    GEMM, x channels-last; ``matmul_stats`` at Inception-BN's widest
    pointwise chain of the legacy fit (B=64), and ResNet-50's 33 pointwise
    chains of a legacy-fit step (B=64; each distinct shape timed once and
    counted as often as a step runs it, the row the sum a step);
    ``fused_linear`` at VGG-16's fc6 (M=64, K=25088, N=4096, relu); flash
    dQ and dK/dV at B=8 T=1024 H=12 D=64 causal (the Executor's LM step of
    phase 7b) beside SDPA f32's backward. Each is held to its plain
    version first (TOL[f32]); inputs drawn on the card from ``gen``; TF32
    off."""
    import torch.nn.functional as F
    timer = Timer(dev)
    f32 = torch.float32
    convs = {c["name"]: c for c in zoo_convs("inception-v3", ZOO_V3_B)}
    convs.update((c["name"], c) for c in zoo_convs("inception-bn",
                                                    ZOO_PRED_B))
    for tag, name in (("v3_1x7", "in_b1_1x7a_conv"),
                      ("bn_3x3s2", "in3c_3x3_conv")):
        c = convs[name]
        xs, ws = c["x"], c["w"]
        kw = dict(stride=c["stride"], pad=c["pad"], dilate=c["dilate"],
                  act=c["act"])
        x, w, sc, b = _conv_inputs(gen, xs, ws, f32, dev)
        x = x.contiguous(memory_format=torch.channels_last)
        out = K.fused_conv_bn_act(x, w, sc, b, **kw)
        path = K.conv_algo(f32, xs[1], ws[2:], c["stride"], c["pad"],
                           c["dilate"])
        shape = "%s %dx%d/%d pad %s x=%s channels-last f32 %s (%s)" % (
            name, ws[2], ws[3], c["stride"][0], c["pad"],
            "x".join(map(str, xs)), c["act"], path)
        err = compare("fused_conv_bn_act " + shape, out,
                      K.fused_conv_bn_act_plain(x, w, sc, b, **kw))
        wf = w * sc[:, None, None, None]
        kms = timer(lambda: K.fused_conv_bn_act(x, w, sc, b, **kw))
        pms = timer(lambda: K.fused_conv_bn_act_plain(x, w, sc, b, **kw))
        lms = timer(lambda: torch.relu(F.conv2d(
            x, wf, b, stride=c["stride"], padding=c["pad"])))
        m = out.numel() // ws[0]
        bms, by = bound_ms(nbytes(x, w, sc, b, out),
                           2 * m * ws[0] * ws[1] * ws[2] * ws[3], f32)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f "
            "ms (F.conv2d f32 with the scale folded, TF32 off, + relu)  "
            "bound %.4f ms (%s); max |err| %.3g" % (
                "fused_conv_bn_act", shape, kms, pms, lms, bms, by, err))
        timed["fused_conv_bn_act"][tag] = {
            "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
            "bound_by": by, "shape": shape, "max_abs_err": err}
        del x, w, sc, b, out, wf

    pw = [c for c in zoo_convs("inception-bn", ZOO_FIT_B) if c["pointwise"]]
    c = max(pw, key=lambda c: (c["w"][0], c["x"][0] * c["x"][2] * c["x"][3]))
    m, kd, n = c["x"][0] * c["x"][2] * c["x"][3], c["w"][1], c["w"][0]
    x = _rand(gen, (m, kd)).to(dev)
    w = _rand(gen, (n, kd), scale=1.0 / math.sqrt(kd)).to(dev)
    kms, pms, lms, bms, by, err = _time_stats(timer, K, x, w)
    shape = "%s M=%d K=%d N=%d f32 (legacy fit B=%d)" % (
        c["name"], m, kd, n, ZOO_FIT_B)
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(matmul f32 + two column sums)  bound %.4f ms (%s); max |err| "
        "%.3g" % ("matmul_stats", shape, kms, pms, lms, bms, by, err))
    timed["matmul_stats"]["bn_widest"] = {
        "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
        "bound_by": by, "shape": shape, "max_abs_err": err}

    counts = collections.Counter(
        (c["x"][0] * c["x"][2] * c["x"][3], c["w"][1], c["w"][0])
        for c in resnet_convs(CLASSIC_RESNET_B) if c["pointwise"])
    tot = [0.0, 0.0, 0.0, 0.0]
    by_ops, err = 0.0, 0.0
    for (m, kd, n), cnt in sorted(counts.items()):
        x = _rand(gen, (m, kd)).to(dev)
        w = _rand(gen, (n, kd), scale=1.0 / math.sqrt(kd)).to(dev)
        kms, pms, lms, bms, by, e = _time_stats(timer, K, x, w)
        for i, v in enumerate((kms, pms, lms, bms)):
            tot[i] += cnt * v
        by_ops += cnt * bms * (by == "operations")
        err = max(err, e)
        log("  matmul_stats ResNet-50 legacy fit M=%d K=%d N=%d f32, %d a "
            "step: kernel %.4f ms  plain %.4f ms  library %.4f ms  bound "
            "%.4f ms (%s)" % (m, kd, n, cnt, kms, pms, lms, bms, by))
    by = "operations" if by_ops >= tot[3] / 2 else "bytes"
    shape = "ResNet-50 legacy fit B=%d f32, %d chains a step (%d shapes), " \
        "the sum a step" % (CLASSIC_RESNET_B, sum(counts.values()),
                            len(counts))
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(matmul f32 + two column sums)  bound %.4f ms (mostly %s); max "
        "|err| %.3g" % ("matmul_stats", shape, tot[0], tot[1], tot[2],
                        tot[3], by, err))
    timed["matmul_stats"]["resnet_fit_f32"] = {
        "ms": tot[0], "plain_ms": tot[1], "library_ms": tot[2],
        "bound_ms": tot[3], "bound_by": by, "shape": shape,
        "max_abs_err": err}
    del x, w

    m, kd, n = ZOO_VGG_B, 512 * 7 * 7, 4096
    x = _rand(gen, (m, kd)).to(dev)
    w = _rand(gen, (n, kd), scale=1.0 / math.sqrt(kd)).to(dev)
    bias = _rand(gen, (n,), scale=0.1).to(dev)
    out = K.fused_linear_fwd(x, w, bias, "relu")
    shape = "VGG-16 fc6 M=%d K=%d N=%d f32 relu" % (m, kd, n)
    err = compare("fused_linear " + shape, out,
                  K.fused_linear_plain(x, w, bias, "relu"))
    kms = timer(lambda: K.fused_linear_fwd(x, w, bias, "relu"))
    pms = timer(lambda: K.fused_linear_plain(x, w, bias, "relu"))
    lms = timer(lambda: torch.relu(F.linear(x, w, bias)))
    bms, by = bound_ms(nbytes(x, w, bias, out), 2 * m * n * kd, f32)
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(F.linear f32, TF32 off, + relu)  bound %.4f ms (%s); max |err| "
        "%.3g" % ("fused_linear", shape, kms, pms, lms, bms, by, err))
    timed["fused_linear"]["vgg_fc6"] = {
        "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
        "bound_by": by, "shape": shape, "max_abs_err": err}
    del x, w, bias, out

    b, t, h, d = 8, 1024, 12, 64
    q, k, v, do = _flash_inputs(gen, b, t, h, d, f32, dev)
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    grads = K.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    grads_p = K.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    shape = "B=8 T=1024 H=12 D=64 causal f32"
    errs = [compare("flash %s %s" % (nm, shape), g_, w_)
            for nm, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p)]
    del grads, grads_p
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    cfg = K._flash_kernel_args("flash_attention_dq", q, k, v) \
        + (1.0 / math.sqrt(d), 1, 0, K._CODE[f32])
    P = K._ptr
    ms = {"flash_attention_dq": timer(lambda: K._launch(
        "flash_attention_dq", P(q), P(k), P(v), P(o), P(do), P(lse),
        P(dcap), P(dq), *cfg)),
        "flash_attention_dkv": timer(lambda: K._launch(
            "flash_attention_dkv", P(q), P(k), P(v), P(do), P(lse),
            P(dcap), P(dk), P(dv), *cfg))}
    pms = timer(lambda: K.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    True))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    qg, kg, vg = (a.detach().clone().requires_grad_() for a in (qt, kt, vt))
    gt = do.transpose(1, 2)
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd = timer(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True).backward(gt)) - lib_fwd
    pairs, row = t * (t + 1) // 2 * b * h, nbytes(q)
    for name, flops, e in (("flash_attention_dq", 6 * d * pairs, errs[0]),
                           ("flash_attention_dkv", 8 * d * pairs,
                            max(errs[1:]))):
        bms, by = bound_ms(6 * row + 2 * nbytes(lse), flops, f32)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms (whole "
            "backward)  library %.4f ms (SDPA f32 fwd+bwd - fwd, TF32 off)  "
            "bound %.4f ms (%s); max |err| %.3g" % (
                name, shape, ms[name], pms, lib_bwd, bms, by, e))
        timed[name]["f32_b8"] = {
            "ms": ms[name], "plain_ms": pms, "library_ms": lib_bwd,
            "bound_ms": bms, "bound_by": by, "shape": shape,
            "max_abs_err": e}


# -- phase 7d: the IO layer: training fed from records ----------------------------

IO_SIDE = 256                       # the device-augment records' side
IO_SIDES = (288, 384)               # the host path's records: sides drawn
IO_CLASSES = 16                     # labels (a colour tint each)
# an epoch: 12 batches of 256 (3072 records of 256x256, 604 MB) and 24 of
# 64 (1536 records of 288-384 px, ~520 MB); the two sets are written one
# after the other, each removed after its runs. With queue_depth 1 a
# worker holds at most 2 batches ahead, so each trains through several
# batches a worker, decoded while the card steps
IO_RESNET_BATCHES, IO_EPOCHS = 12, 2
IO_INC_B, IO_INC_BATCHES, IO_VAL_BATCHES = 64, 24, 2
IO_QUEUE_DEPTH = 1                  # of the training runs' pools
IO_MEAN = (123.68, 116.779, 103.939)    # train_imagenet.py's mean_r/g/b
IO_SWEEP_B, IO_SWEEP_S = 16, 0.75   # batch, most seconds a pool size runs
IO_HEADROOM = 1.2                   # the pool's img/s over the step's need
IO_CHECK_B = 32
IO_FEED_BATCHES = 6                 # the fed batches checked
IO_RESNET_LR = 0.02                 # SGD from scratch on the tinted records
IO_KILL_TIMEOUT = 20.0              # MXNET_IO_WORKER_TIMEOUT of the kill


def _line7d(t0, what, text):
    log("phase 7d %s: %s (%.1f s into the phase)" % (
        what, text, time.perf_counter() - t0))


def _io_records(path, n, sides, seed):
    """``n`` seeded RAW0 records, record i of label i % IO_CLASSES: noise
    in [0, 64) under a tint of its class (one channel, a class-dependent
    level), so the label survives any crop and a loss can fall. ``sides``:
    one side, or the (low, high) range each side is drawn from. Returns
    the bytes written."""
    from mxnet_tpu_torch import recordio
    rng = np.random.default_rng(seed)
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        c = i % IO_CLASSES
        h, wd = (sides, sides) if isinstance(sides, int) else \
            (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
        img = np.frombuffer(rng.bytes(h * wd * 3), np.uint8).reshape(
            h, wd, 3) & np.uint8(63)
        img[..., c % 3] += np.uint8(60 + 20 * (c // 3))
        w.write(recordio.pack_img((0, float(c), i, 0), img, img_fmt=".raw"))
    w.close()
    return os.path.getsize(path)


def _poison_consumer_decode():
    """From here on a record decoded in this process raises: the forked
    pool workers keep their own code, so training from a pool shows the
    consumer decodes nothing. Returns the undo."""
    from mxnet_tpu_torch import image_io

    real = image_io._PyEngine._load

    def poisoned(*a, **k):
        raise AssertionError("phase 7d: a record was decoded in the "
                             "consumer process")

    image_io._PyEngine._load = poisoned
    return lambda: setattr(image_io._PyEngine, "_load", real)


def io_sweep(t0, what, path, shape, kw, counts):
    """The serial engine and the pool at each of ``counts`` workers, each
    inside ONE epoch (no reset, so no pool restart, in the window): img/s
    at IO_SWEEP_B a batch, after as many batches as there are workers
    (the freshly forked workers' first, slowed by copy-on-write faults),
    to the epoch's end or IO_SWEEP_S seconds, whichever comes first; the
    pool's wait p50/p99 (the telemetry's bucket bounds), io.pool_starved
    and the decode time an image over the same window. Returns {workers:
    img/s}."""
    from mxnet_tpu_torch import telemetry as tele
    from mxnet_tpu_torch.image_io import ImageRecordIter
    rates = {}
    for n in [0] + list(counts):
        it = ImageRecordIter(path, shape, IO_SWEEP_B, num_workers=n, **kw)
        for _ in range(max(n, 1)):
            it.iter_next()
        tele.reset()
        k, w0 = 0, time.perf_counter()
        while time.perf_counter() - w0 < IO_SWEEP_S and it.iter_next():
            k += 1
        secs = time.perf_counter() - w0
        whole = not it.iter_next()
        it.close()
        rates[n] = k * IO_SWEEP_B / secs
        wait = tele.histogram("io.pool_wait_ms")
        dec = tele.histogram("io.decode_batch_ms")
        pool = "serial engine" if n == 0 else "%d worker%s" % (
            n, "s" if n > 1 else "")
        stats = "" if n == 0 else (
            "; io.pool_wait_ms p50 <= %g p99 <= %g (bucket bounds), "
            "io.pool_starved %d of %d batches; decode %.3f ms an image "
            "(io.decode_batch_ms mean)" % (
                wait.percentile(50), wait.percentile(99),
                tele.counter("io.pool_starved").value,
                tele.counter("io.pool_batches").value,
                dec._sum / max(dec._count, 1) / IO_SWEEP_B))
        _line7d(t0, "throughput", "%s, %s: %d batches of %d after the "
                "first %d (%s) in %.3f s = %.1f img/s%s" % (
                    what, pool, k, IO_SWEEP_B, max(n, 1),
                    "to the epoch's end" if whole else "of one epoch", secs,
                    rates[n], stats))
    return rates


def _feeding(rates, need):
    """The fewest swept workers whose img/s reaches IO_HEADROOM x
    ``need``, else None."""
    ok = [n for n, r in sorted(rates.items())
          if n and r >= IO_HEADROOM * need]
    return ok[0] if ok else None


def io_pool_equals_serial(t0, what, path, shape, kw, workers):
    """The pool's first batches byte-identical to the serial engine's,
    shuffle and draws on."""
    from mxnet_tpu_torch.image_io import ImageRecordIter
    got = []
    for n in (0, workers):
        it = ImageRecordIter(path, shape, IO_CHECK_B, shuffle=True, seed=8,
                             num_workers=n, **kw)
        got.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                    for _, b in zip(range(2), it)])
        it.close()
    for (d0, l0), (d1, l1) in zip(*got):
        if not (np.array_equal(d0, d1) and np.array_equal(l0, l1)):
            raise AssertionError("phase 7d: the pool's batch of %s "
                                 "differs from the serial engine's" % what)
    _line7d(t0, "checks", "the pool (%d workers) byte-identical to the "
            "serial engine on %s (shuffle, crop and mirror draws)"
            % (workers, what))


def _host_crop(host, y0, x0, flip, crop):
    """The numpy crop, mirror and normalization of a uint8 NHWC batch at
    the given offsets and flags, NCHW float32."""
    want = np.empty((host.shape[0], 3, crop, crop), np.float32)
    for i in range(host.shape[0]):
        im = host[i, y0[i]:y0[i] + crop, x0[i]:x0[i] + crop]
        im = im[:, ::-1] if flip[i] else im
        want[i] = ((im.astype(np.float32) - np.asarray(IO_MEAN, np.float32))
                   * np.float32(1 / 58.0)).transpose(2, 0, 1)
    return want


def io_checks(dev, t0, dpath, cpus):
    """The correctness gates of the device-augment records: the pool's
    batches byte-identical to the serial engine's; DeviceAugmentIter's
    card batch equal to the numpy centre crop and normalization without
    draws, and to the host crop and mirror at the drawn offsets with
    them; the pool fed through DeviceAugmentIter and DevicePrefetchIter
    equal, data and labels, to the serial engine's centre crop; a killed
    worker raises within MXNET_IO_WORKER_TIMEOUT."""
    import signal
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.image_io import ImageRecordIter
    io_pool_equals_serial(t0, "the device-augment records", dpath,
                          (3, IO_SIDE, IO_SIDE),
                          dict(resize=IO_SIDE, device_augment=True),
                          min(4, cpus))
    base = ImageRecordIter(dpath, (3, IO_SIDE, IO_SIDE), IO_CHECK_B,
                           resize=IO_SIDE, device_augment=True)
    u8 = [b.data[0].asnumpy().copy() for _, b in zip(range(2), base)]
    crop = RESNET_HW
    for draws in (False, True):
        base.reset()
        aug = mx.DeviceAugmentIter(base, crop_shape=(crop, crop),
                                   rand_crop=draws, rand_mirror=draws,
                                   mean=IO_MEAN, scale=1 / 58.0, seed=6)
        g = torch.Generator(device=dev).manual_seed(6)
        for _, batch, host in zip(range(2), aug, u8):
            card = batch.data[0]._tensor
            if card.device != dev or card.dtype != torch.float32:
                raise AssertionError("phase 7d: DeviceAugmentIter's batch "
                                     "is %s on %s" % (card.dtype,
                                                      card.device))
            b = host.shape[0]
            if draws:
                y0 = torch.randint(0, IO_SIDE - crop + 1, (b,), generator=g,
                                   device=dev).tolist()
                x0 = torch.randint(0, IO_SIDE - crop + 1, (b,), generator=g,
                                   device=dev).tolist()
                flip = (torch.rand((b,), generator=g, device=dev)
                        < 0.5).tolist()
            else:
                y0 = x0 = [(IO_SIDE - crop) // 2] * b
                flip = [False] * b
            want = _host_crop(host, y0, x0, flip, crop)
            if not np.array_equal(card.cpu().numpy(), want):
                raise AssertionError("phase 7d: DeviceAugmentIter (draws "
                                     "%s) differs from the host crop" % draws)
    # the feed as training takes it: the pool, then DeviceAugmentIter and
    # DevicePrefetchIter's thread, side stream and event; data and labels
    # batch for batch as the serial engine's
    pool = ImageRecordIter(dpath, (3, IO_SIDE, IO_SIDE), IO_CHECK_B,
                           resize=IO_SIDE, device_augment=True,
                           shuffle=True, seed=8, num_workers=min(4, cpus),
                           queue_depth=IO_QUEUE_DEPTH)
    feed = mx.DevicePrefetchIter(mx.DeviceAugmentIter(
        pool, crop_shape=(crop, crop), rand_crop=False, rand_mirror=False,
        mean=IO_MEAN, scale=1 / 58.0), depth=2)
    serial = ImageRecordIter(dpath, (3, IO_SIDE, IO_SIDE), IO_CHECK_B,
                             resize=IO_SIDE, device_augment=True,
                             shuffle=True, seed=8)
    fed = 0
    for _, batch, host in zip(range(IO_FEED_BATCHES), feed, serial):
        b = IO_CHECK_B
        want = _host_crop(host.data[0].asnumpy(),
                          [(IO_SIDE - crop) // 2] * b,
                          [(IO_SIDE - crop) // 2] * b, [False] * b, crop)
        if not (np.array_equal(batch.data[0]._tensor.cpu().numpy(), want)
                and np.array_equal(batch.label[0]._tensor.cpu().numpy(),
                                   host.label[0].asnumpy())):
            raise AssertionError("phase 7d: the fed batch %d differs from "
                                 "the serial engine's crop or labels" % fed)
        fed += 1
    if fed != IO_FEED_BATCHES:
        raise AssertionError("phase 7d: the feed gave %d batches" % fed)
    feed.close()
    pool.close()
    serial.close()
    base.close()
    os.environ["MXNET_IO_WORKER_TIMEOUT"] = str(IO_KILL_TIMEOUT)
    try:
        it = ImageRecordIter(dpath, (3, IO_SIDE, IO_SIDE), IO_CHECK_B,
                             resize=IO_SIDE, device_augment=True,
                             num_workers=2, queue_depth=1)
        it.iter_next()
        os.kill(it._py._workers[1].pid, signal.SIGKILL)
        k0 = time.perf_counter()
        try:
            for _ in range(3):
                while it.iter_next():
                    pass
                it.reset()
        except MXNetError as e:
            if "died" not in str(e):
                raise
        else:
            raise AssertionError("phase 7d: a killed decode worker did not "
                                 "raise")
        killed_s = time.perf_counter() - k0
        if killed_s > IO_KILL_TIMEOUT:
            raise AssertionError("phase 7d: the killed worker raised after "
                                 "%.1f s" % killed_s)
        it.close()
    finally:
        del os.environ["MXNET_IO_WORKER_TIMEOUT"]
    _line7d(t0, "checks", "DeviceAugmentIter's card batch equal to the "
            "numpy centre crop and normalization without draws, and to the "
            "host crop and mirror at the drawn offsets with them, exactly; "
            "%d batches of the pool through DeviceAugmentIter and "
            "DevicePrefetchIter equal to the serial engine's centre crop "
            "and labels, exactly; a killed worker raised MXNetError %.3f s "
            "after the kill (timeout %g s)" % (
                IO_FEED_BATCHES, killed_s, IO_KILL_TIMEOUT))


class _Stamps:
    """batch_end_callback: the time and the metric of each training batch
    alone (the metric's running sums differenced); ``eval`` as the
    eval_batch_end_callback: the time each validation batch ended."""

    def __init__(self):
        self.times, self.values, self.eval_times = [], [], []
        self._last = (0.0, 0)

    def __call__(self, p):
        self.times.append(time.perf_counter())
        m = p.eval_metric
        if m.num_inst < self._last[1]:      # an epoch's reset
            self._last = (0.0, 0)
        self.values.append((m.sum_metric - self._last[0])
                           / max(m.num_inst - self._last[1], 1))
        self._last = (m.sum_metric, m.num_inst)

    def eval(self, p):
        self.eval_times.append(time.perf_counter())

    def epoch_ms(self, per_epoch):
        """ms a step of the last epoch, every wait on input included:
        from the end of what ran before it (the previous epoch's last
        training or validation batch) to its last batch's end, over its
        batches; the pool restarts at the epoch's reset, inside that
        window. And the ms between its batch ends (its first batch's wait
        left out)."""
        first = self.times[-per_epoch]
        start = max([self.times[-per_epoch - 1]]
                    + [t for t in self.eval_times if t < first])
        return ((self.times[-1] - start) / per_epoch * 1e3,
                (self.times[-1] - first) / (per_epoch - 1) * 1e3)


def _falls(values, per_epoch, what):
    first = statistics.mean(values[:per_epoch])
    second = statistics.mean(values[per_epoch:])
    if not all(math.isfinite(v) for v in values) or not second < first:
        raise AssertionError("phase 7d %s: the loss did not fall: %r"
                             % (what, values))
    return first, second


def io_resnet(K, dev, t0, path, pools):
    """ResNet-50 bf16 at B=256 with the conv-BN train gate on, fed from
    records: ParallelTrainer.fit over DevicePrefetchIter(DeviceAugmentIter(
    ImageRecordIter(device_augment=True, num_workers=n,
    queue_depth=IO_QUEUE_DEPTH))) for each n of ``pools``, IO_EPOCHS
    epochs of IO_RESNET_BATCHES batches each, the consumer's decode
    poisoned; exactly RESNET_POINTWISE matmul_stats a step, a falling
    cross-entropy (the first pool's fit; the trainer trains on through
    the others, finite), the last epoch's ms a step with its input waits
    (``_Stamps.epoch_ms``) and img/s against phase 6's device-resident
    batch, the pool's and the pipeline's starvation counters and the
    workers' decode time an image; the busy share of one more epoch
    (profiled) on the last pool. Returns the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry as tele
    from mxnet_tpu_torch.image_io import ImageRecordIter
    os.environ[GATE] = "1"
    try:
        trainer = _resnet_trainer(None, RESNET_B, "bfloat16",
                                  IO_RESNET_LR).init_params()
        # the step program's build and capture, on a device batch: its
        # warm-up runs count as launches, so they come before the count
        trainer.step(_resnet_batch(0, RESNET_B, dev))
        torch.cuda.synchronize()
    finally:
        del os.environ[GATE]
    total = collections.Counter()
    for workers in pools:
        base = ImageRecordIter(path, (3, IO_SIDE, IO_SIDE), RESNET_B,
                               resize=IO_SIDE, device_augment=True,
                               shuffle=True, seed=3, num_workers=workers,
                               queue_depth=IO_QUEUE_DEPTH)
        feed = mx.DevicePrefetchIter(mx.DeviceAugmentIter(
            base, crop_shape=(RESNET_HW, RESNET_HW), rand_crop=True,
            rand_mirror=True, mean=IO_MEAN, seed=4), depth=2)
        undo = _poison_consumer_decode()
        profiled = ""
        try:
            tele.reset()
            stamps = _Stamps()
            K.reset_launch_counts()
            w0 = time.perf_counter()
            trainer.fit(feed, eval_metric="ce", num_epoch=IO_EPOCHS,
                        batch_end_callback=stamps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            steps = IO_EPOCHS * IO_RESNET_BATCHES
            launches = _check_launches(K, "phase 7d resnet fit", {
                "matmul_stats": RESNET_POINTWISE * steps})
            total.update(launches)
            starved = (tele.counter("io.pool_starved").value,
                       tele.counter("io.pipeline_starved").value,
                       tele.counter("io.pool_batches").value)
            inwait = tele.histogram("train.input_wait_ms")
            dec = tele.histogram("io.decode_batch_ms")
            if workers == pools[0]:
                first, second = _falls(stamps.values, IO_RESNET_BATCHES,
                                       "resnet fit")
            else:   # the same trainer trained on: finite, not gated to fall
                if not all(math.isfinite(v) for v in stamps.values):
                    raise AssertionError("phase 7d resnet fit: %r"
                                         % stamps.values)
                first, second = (
                    statistics.mean(stamps.values[:IO_RESNET_BATCHES]),
                    statistics.mean(stamps.values[IO_RESNET_BATCHES:]))
            if workers == pools[-1]:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    p0 = time.perf_counter()
                    trainer.fit(feed, eval_metric="ce", num_epoch=1)
                    torch.cuda.synchronize()
                    pwall = time.perf_counter() - p0
                kern = sum(e.self_device_time_total
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA) / 1e6
                profiled = "; one more epoch profiled: %.3f s wall, %.3f s " \
                    "card kernels, busy share %.3f" % (pwall, kern,
                                                       kern / pwall)
        finally:
            undo()
            feed.close()
            base.close()
        ms, between = stamps.epoch_ms(IO_RESNET_BATCHES)
        ref = REPORT.get("resnet_ms")
        _line7d(t0, "resnet-50", "ResNet-50 B=%d bf16 (%s=1) trained by "
                "ParallelTrainer.fit from records: DevicePrefetchIter("
                "DeviceAugmentIter(ImageRecordIter(%dx%d RAW0, "
                "device_augment, num_workers=%d, queue_depth=%d)), crop %d, "
                "mirror, mean %s); %d epochs x %d batches (%.1f a worker) in "
                "%.3f s; the last epoch %.3f ms a step with every input wait "
                "(the pool's restart included), %.1f img/s, %.3f ms between "
                "its batch ends; against phase 6's device-resident batch "
                "%.3f ms, %.1f img/s: %.3f of its img/s (%.3f between batch "
                "ends); cross-entropy a batch %s (epoch means %.4f -> %.4f); "
                "launches %s; io.pool_starved %d, io.pipeline_starved %d of "
                "%d batches; train.input_wait_ms mean %.3f; decode %.3f ms "
                "an image (io.decode_batch_ms mean)%s; %s" % (
                    RESNET_B, GATE, IO_SIDE, IO_SIDE, workers,
                    IO_QUEUE_DEPTH, RESNET_HW, IO_MEAN, IO_EPOCHS,
                    IO_RESNET_BATCHES, IO_RESNET_BATCHES / workers, wall, ms,
                    RESNET_B / ms * 1e3, between, ref or float("nan"),
                    RESNET_B / ref * 1e3 if ref else float("nan"),
                    ref / ms if ref else float("nan"),
                    ref / between if ref else float("nan"),
                    " ".join("%.4f" % v for v in stamps.values), first,
                    second,
                    json.dumps({e: n for e, n in launches.items() if n}),
                    starved[0], starved[1], starved[2],
                    inwait._sum / max(inwait._count, 1),
                    dec._sum / max(dec._count, 1) / RESNET_B, profiled,
                    card_line()))
        del feed, base
    del trainer
    free_programs()
    return dict(total)


def io_inception(K, dev, t0, path, workers):
    """Inception-BN f32 at B=IO_INC_B, train_imagenet.py's network and
    host recipe: FeedForward(ctx=mx.gpu(0)).fit from ImageRecordIter(
    resize=256, random crop 224, mirror, mean_r/g/b, num_workers=workers)
    queue_depth=IO_QUEUE_DEPTH) with a validation iterator (IO_VAL_BATCHES
    batches of the centre crop), IO_EPOCHS epochs of IO_INC_BATCHES
    batches, on the fused loop
    and on the legacy loop (MXNET_FUSED_FIT=0, the conv-BN train gate on),
    the consumer's decode poisoned; exact launches (the legacy loop's
    INCEPTION_BN_POINTWISE matmul_stats a step, INCEPTION_BN_CHAINS
    fused_conv_bn_act an eval forward on both loops), then ``score`` over
    the validation records; the last epoch's ms a step with its input
    waits (``_Stamps.epoch_ms``) against phase 7c's. Returns the
    launches."""
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.models  # noqa: F401  (mx.models)
    from mxnet_tpu_torch import telemetry as tele
    from mxnet_tpu_torch.image_io import ImageRecordIter
    sym = mx.models.get_symbol("inception-bn", num_classes=ZOO_CLASSES)
    args, aux = _zoo_params(sym, {"data": (1, 3, 224, 224),
                                  "softmax_label": (1,)}, 21)
    recipe = dict(resize=256, mean_r=IO_MEAN[0], mean_g=IO_MEAN[1],
                  mean_b=IO_MEAN[2])
    total = collections.Counter()
    steps = IO_EPOCHS * IO_INC_BATCHES
    for fused in (True, False):
        what = "fused" if fused else "legacy"
        train = ImageRecordIter(path, (3, 224, 224), IO_INC_B,
                                rand_crop=True, rand_mirror=True,
                                shuffle=True, seed=5, num_workers=workers,
                                queue_depth=IO_QUEUE_DEPTH, **recipe)
        val_base = ImageRecordIter(path, (3, 224, 224), IO_INC_B,
                                   num_workers=2, **recipe)
        val = mx.io.ResizeIter(val_base, IO_VAL_BATCHES)
        env = {} if fused else {"MXNET_FUSED_FIT": "0", GATE: "1"}
        os.environ.update(env)
        undo = _poison_consumer_decode()
        try:
            model = mx.model.FeedForward(
                sym, ctx=mx.gpu(0), num_epoch=IO_EPOCHS, optimizer="sgd",
                learning_rate=ZOO_LR, momentum=0.9,
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in args.items()},
                aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in aux.items()})
            stamps = _Stamps()
            tele.reset()
            K.reset_launch_counts()
            w0 = time.perf_counter()
            model.fit(X=train, eval_data=val, eval_metric="ce",
                      kvstore="local", batch_end_callback=stamps,
                      eval_batch_end_callback=stamps.eval)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            want = {"fused_conv_bn_act": INCEPTION_BN_CHAINS * IO_EPOCHS
                    * IO_VAL_BATCHES}
            if not fused:
                want["matmul_stats"] = INCEPTION_BN_POINTWISE * steps
            got = _check_launches(K, "phase 7d inception-bn %s fit" % what,
                                  want)
            total.update(got)
            first, second = _falls(stamps.values, IO_INC_BATCHES,
                                   "inception-bn %s fit" % what)
            starved = (tele.counter("io.pool_starved").value,
                       tele.counter("io.pool_batches").value)
            dec = tele.histogram("io.decode_batch_ms")
            K.reset_launch_counts()
            s0 = time.perf_counter()
            acc = model.score(val, "acc")
            s_secs = time.perf_counter() - s0
            total.update(_check_launches(
                K, "phase 7d inception-bn score",
                {"fused_conv_bn_act": INCEPTION_BN_CHAINS
                 * IO_VAL_BATCHES}))
            if not 0.0 <= acc <= 1.0:
                raise AssertionError("phase 7d inception-bn score: %r"
                                     % acc)
        finally:
            undo()
            for k in env:
                del os.environ[k]
            train.close()
            val_base.close()
        ms, between = stamps.epoch_ms(IO_INC_BATCHES)
        ref = REPORT.get("inception_%s_ms" % what)
        _line7d(t0, "inception-bn", "Inception-BN f32 FeedForward(ctx="
                "mx.gpu(0)).fit on the %s loop%s from records: "
                "ImageRecordIter(%d-%d px RAW0, resize 256, random crop 224, "
                "mirror, mean %s, num_workers=%d, queue_depth=%d) with a "
                "validation iterator of %d batches; B=%d, %d epochs x %d "
                "batches (%.1f a worker) in %.3f s; the last epoch %.3f ms a "
                "step with every input wait (the pool's restart included), "
                "%.1f img/s, %.3f ms between its batch ends; phase 7c's "
                "device-ready NDArrayIter %.3f ms a step: %.3f "
                "of its img/s; cross-entropy a batch %s (epoch means %.4f "
                "-> %.4f); io.pool_starved %d of %d batches (train and "
                "validation pools); decode %.3f ms an image "
                "(io.decode_batch_ms mean); score (accuracy, eval-mode "
                "BatchNorm) %.4f in %.3f s; launches %s; %s" % (
                    what, "" if fused else " (MXNET_FUSED_FIT=0, %s=1)"
                    % GATE, IO_SIDES[0], IO_SIDES[1], IO_MEAN, workers,
                    IO_QUEUE_DEPTH, IO_VAL_BATCHES, IO_INC_B, IO_EPOCHS,
                    IO_INC_BATCHES, IO_INC_BATCHES / workers, wall, ms,
                    IO_INC_B / ms * 1e3, between, ref or float("nan"),
                    ref / ms if ref else float("nan"),
                    " ".join("%.4f" % v for v in stamps.values), first,
                    second, starved[0], starved[1],
                    dec._sum / max(dec._count, 1) / IO_INC_B, acc, s_secs,
                    json.dumps({e: n for e, n in got.items() if n}),
                    card_line()))
        del model, train, val, val_base
        free_programs()
    return dict(total)


def io_main_path(K, dev):
    """Phase 7d: the IO layer feeding training. Under a temporary directory
    (removed after), for each record set in turn, written from seeded
    numpy and removed after its runs: the throughput of the serial engine
    and the pool at 1, 2, 3, 4, 6 and os.cpu_count() workers, the
    correctness gates and the training fed from it (ResNet-50 from the
    device-augment set, Inception-BN from the host float set), with the
    fewest swept workers whose img/s reaches IO_HEADROOM x the step's
    need; ResNet-50 again with as many workers as the training runs may
    take (os.cpu_count() - 2). Returns the launches of the gated runs."""
    import tempfile
    t0 = time.perf_counter()
    cpus = os.cpu_count() or 1
    counts = sorted({n for n in (1, 2, 3, 4, 6, cpus) if n <= cpus})
    most = max(1, cpus - 2)         # the training runs' cap on workers
    launches = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="mx_io7d_") as tmp:
        dpath = os.path.join(tmp, "train256.rec")
        n_r = RESNET_B * IO_RESNET_BATCHES
        t1 = time.perf_counter()
        size = _io_records(dpath, n_r, IO_SIDE, 1)
        _line7d(t0, "records", "%d RAW0 records of %dx%d, %.1f MB, written "
                "in %.1f s; os.cpu_count() %d" % (
                    n_r, IO_SIDE, IO_SIDE, size / 2**20,
                    time.perf_counter() - t1, cpus))
        rates = io_sweep(t0, "device_augment %dx%d" % (IO_SIDE, IO_SIDE),
                         dpath, (3, IO_SIDE, IO_SIDE),
                         dict(resize=IO_SIDE, device_augment=True,
                              shuffle=True), counts)
        need = RESNET_B / REPORT["resnet_ms"] * 1e3 \
            if "resnet_ms" in REPORT else 1700.0
        feed = _feeding(rates, need)
        _line7d(t0, "workers", "to feed ResNet-50's %.1f img/s with %gx "
                "headroom the device-augment pool needs %s (of %d cores; "
                "the training runs take at most %d)" % (
                    need, IO_HEADROOM, "%d worker(s)" % feed if feed else
                    "more than %d workers" % counts[-1], cpus, most))
        io_checks(dev, t0, dpath, cpus)
        free_programs()
        pick = min(feed or counts[-1], most)
        launches.update(io_resnet(K, dev, t0, dpath,
                                  sorted({pick, most})))
        os.remove(dpath)
        hpath = os.path.join(tmp, "train_mixed.rec")
        n_i = IO_INC_B * IO_INC_BATCHES
        t1 = time.perf_counter()
        size = _io_records(hpath, n_i, IO_SIDES, 2)
        _line7d(t0, "records", "the 256x256 set removed; %d RAW0 records of "
                "%d-%d px sides, %.1f MB, written in %.1f s" % (
                    n_i, IO_SIDES[0], IO_SIDES[1], size / 2**20,
                    time.perf_counter() - t1))
        host_kw = dict(resize=256, rand_crop=True, rand_mirror=True,
                       mean_r=IO_MEAN[0], mean_g=IO_MEAN[1],
                       mean_b=IO_MEAN[2])
        rates = io_sweep(t0, "host float (resize 256, crop 224, mirror, "
                         "mean)", hpath, (3, 224, 224),
                         dict(host_kw, shuffle=True), counts)
        need = IO_INC_B / REPORT["inception_fused_ms"] * 1e3 \
            if "inception_fused_ms" in REPORT else 970.0
        feed = _feeding(rates, need)
        _line7d(t0, "workers", "to feed Inception-BN's %.1f img/s (the "
                "fused loop) with %gx headroom the host float pool needs %s "
                "(of %d cores; the training runs take at most %d)" % (
                    need, IO_HEADROOM, "%d worker(s)" % feed if feed else
                    "more than %d workers" % counts[-1], cpus, most))
        io_pool_equals_serial(t0, "the host-path records", hpath,
                              (3, 224, 224), host_kw, min(4, cpus))
        launches.update(io_inception(K, dev, t0, hpath,
                                     min(feed or counts[-1], most)))
    _line7d(t0, "done", "every check passed in %.1f s; the records' "
            "directory removed; launches %s" % (
                time.perf_counter() - t0, json.dumps(dict(launches))))
    return dict(launches)


# -- phase 7e: the periphery ------------------------------------------------

PERI_PRED_B = 64                    # the Predictor's and the C client's batch
PERI_TOL = 1e-5                     # Predictor and C client against predict
PERI_PRED_REPS = 5                  # timed Predictor forwards
PERI_ASYNC_BOUND = 50000            # fc1_weight (100352 values) partitioned
PERI_PARTIAL = "stage3_unit1_out"   # the partial-out head (a unit's output)
PERI_MLP = (512, 256, 10)           # the custom-op fit's MLP
PERI_MLP_B, PERI_MLP_BATCHES = 128, 8
RTC_N = 1 << 24                     # saxpy's values
RTC_SRC = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
           "if (i < x_dims[0]) y[i] += 2.0f * x[i];")
PERI_NOTE = "two ranks on ONE card, not a multi-card figure"


def _line7e(t0, what, text):
    log("phase 7e %s: %s (%.1f s into the phase)" % (
        what, text, time.perf_counter() - t0))


def _local_oracle(K, sym, args, aux, X, y, steps):
    """ResNet-50 through FeedForward(ctx=[gpu(0)] * 2).fit on the legacy
    loop with the gate on and kvstore local, cuDNN deterministic (as the
    dist workers run it): (the model, the batch-end times, the update's
    seconds a step), after its exact matmul_stats launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import model as mx_model
    from mxnet_tpu_torch.testing import dist_worker as W
    saved = {k: os.environ.get(k) for k in (GATE, "MXNET_FUSED_FIT")}
    os.environ.update({GATE: "1", "MXNET_FUSED_FIT": "0"})
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    stamps, upd = [], []
    real = mx_model._update_params_on_kvstore

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        real(*a, **kw)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - tic)

    def stamp(p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    mx_model._update_params_on_kvstore = timed_update
    try:
        model = mx.model.FeedForward(
            sym, ctx=[mx.gpu(0)] * 2, num_epoch=W.RESNET_EPOCHS,
            learning_rate=W.RESNET_LR, momentum=0.9,
            arg_params={k: mx.nd.array(v) for k, v in args.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
        K.reset_launch_counts()
        model.fit(mx.io.NDArrayIter(X, y, batch_size=W.RESNET_GB),
                  eval_metric="ce", kvstore="local",
                  batch_end_callback=stamp)
        torch.cuda.synchronize()
        local_launches = K.launch_counts()
    finally:
        mx_model._update_params_on_kvstore = real
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    # 33 a step in each of the two contexts' executors
    if local_launches["matmul_stats"] != 2 * RESNET_POINTWISE * steps:
        raise AssertionError("phase 7e local oracle: %d matmul_stats" %
                             local_launches["matmul_stats"])
    return model, stamps, upd


def _peri_dist(K, dev, t0, out):
    """7e.1-2: two workers on the one card through the unchanged
    ``tools/launch.py -n 2``: ResNet-50 under dist_sync (the legacy fit,
    the conv-BN train gate on) and the MLP over the dist_async servers
    (fc1_weight range-partitioned). Their results are held here: exact
    launches, falling loss, bitwise ranks, the one-process
    ``[gpu(0)] * 2`` local oracle within DELTA_REL by norm, async accuracy
    and push/pull counts."""
    from mxnet_tpu_torch.models import get_resnet
    from mxnet_tpu_torch.testing import dist_worker as W
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ)
    env.update(MXNET_DISTTEST_CHECKS="resnet_sync,mlp_async,card_routes",
               MXNET_DISTTEST_OUT=out,
               MXNET_KVSTORE_BIGARRAY_BOUND=str(PERI_ASYNC_BOUND),
               PYTHONPATH=HERE + os.pathsep + env.get("PYTHONPATH", ""))
    for k in ("MXNET_TPU_COORDINATOR", "MXNET_KVSTORE_PORT_BASE",
              "MXNET_TPU_LOCAL_DEVICES", GATE, "MXNET_FUSED_FIT"):
        env.pop(k, None)
    w0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "launch.py"), "-n", "2",
         "--", sys.executable, "-m", "mxnet_tpu_torch.testing.dist_worker"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - w0
    if proc.returncode != 0 or proc.stdout.count("OK all") != 2:
        raise AssertionError("phase 7e dist workers failed (rc %d):\n%s\n%s"
                             % (proc.returncode, proc.stdout[-3000:],
                                proc.stderr[-6000:]))
    res = [json.load(open(os.path.join(out, "resnet_sync-%d.json" % r)))
           for r in range(2)]
    card_routes = [json.load(open(os.path.join(out, "card_routes-%d.json"
                                                % r))) for r in range(2)]
    want_routes = {"broadcast": "host", "all_reduce": "cuda",
                   "reduce_scatter": "cuda", "all_gather": "cuda"}
    if card_routes != [want_routes] * 2:
        raise AssertionError("phase 7e card_routes: values kept on the card "
                             "handed gloo %r, want %r" % (card_routes,
                                                          want_routes))
    steps = W.RESNET_BATCHES * W.RESNET_EPOCHS
    for r, d in enumerate(res):
        if d["steps"] != steps \
                or d["matmul_stats"] != RESNET_POINTWISE * steps:
            raise AssertionError("phase 7e dist_sync rank %d: %d steps, "
                                 "%d matmul_stats (want %d a step)" % (
                                     r, d["steps"], d["matmul_stats"],
                                     RESNET_POINTWISE))
        if not d["loss"][1] < d["loss"][0]:
            raise AssertionError("phase 7e dist_sync rank %d: the loss did "
                                 "not fall: %s" % (r, d["loss"]))
    ranks = [dict(np.load(os.path.join(out, "resnet_sync-%d.npz" % r)))
             for r in range(2)]
    if not all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]):
        raise AssertionError("phase 7e dist_sync: the ranks' parameters "
                             "differ")
    # the one-process oracle: [gpu(0)] * 2 and kvstore local on the same
    # global batches, the same weights, the legacy loop
    sym = get_resnet(RESNET_CLASSES, RESNET_LAYERS)
    args, aux = W.resnet_params(sym, 5)
    X, y = W.resnet_batches()
    model, stamps, upd = _local_oracle(K, sym, args, aux, X, y, steps)
    want = {k: torch.from_numpy(model.arg_params[k].asnumpy() - args[k])
            for k in args}
    got = {k: torch.from_numpy(ranks[0][k] - args[k]) for k in args}
    rows = _delta_rows(got, want)
    if not rows[0][0] <= DELTA_REL:
        # a second oracle run: is the gap the dist path's, or two runs'?
        again = _local_oracle(K, sym, args, aux, X, y, steps)[0]
        twice = _delta_rows({k: torch.from_numpy(
            again.arg_params[k].asnumpy() - args[k]) for k in args}, want)
        raise AssertionError(
            "phase 7e dist_sync against [gpu(0)] * 2: deltas worst %s; two "
            "oracle runs against each other: %s (gate %g)" % (
                rows[:3], twice[:3], DELTA_REL))
    worst = rows[0]
    bitwise = all(np.array_equal(ranks[0][k],
                                 model.arg_params[k].asnumpy())
                  for k in args)
    del model, X
    free_programs()
    # the steady steps: every step but the first of the run
    d = res[0]
    dist_ms = statistics.median(d["step_ms"])
    local_ms = statistics.median(
        [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])])
    dist_upd = statistics.median(d["update_ms"][1:])
    local_upd = statistics.median([t * 1e3 for t in upd[1:]])
    push_mb = d["sync_bytes"] / steps / 1e6
    _line7e(t0, "dist_sync", "ResNet-50 f32 224x224 1000 classes, "
            "FeedForward(ctx=mx.gpu(0)).fit(kvstore='dist_sync') on the "
            "legacy loop (%s=1), B=%d a worker x 2 workers (%s), %d batches "
            "x %d epochs, SGD lr %g momentum 0.9: %d matmul_stats a step in "
            "each worker, ce by epoch rank 0 %s rank 1 %s, ranks bitwise "
            "equal; against ctx=[gpu(0)] * 2 kvstore local: deltas worst "
            "%s by norm %.3g (gate %g)%s; ms a step dist %.3f (median of "
            "steps 2-%d; step 1 %.1f ms) local %.3f (x%.3f); push/pull of "
            "every key a step (the update, synchronized) dist %.3f ms local "
            "%.3f ms; %d collectives a step in %.3f ms; %.3f MB all-reduced "
            "a step a worker; routes %s (the device of the tensors each "
            "collective handed gloo: the legacy fit's store lives with its "
            "host arg_params); values kept on the card (exact f32 and int32 "
            "sums, replicated and reduce-scattered keys) handed gloo %s; "
            "the launch took %.1f s; %s" % (
                GATE, W.RESNET_GB // 2, PERI_NOTE, W.RESNET_BATCHES,
                W.RESNET_EPOCHS, W.RESNET_LR, RESNET_POINTWISE,
                ["%.4f" % v for v in res[0]["loss"]],
                ["%.4f" % v for v in res[1]["loss"]], worst[2], worst[0],
                DELTA_REL, " (bitwise)" if bitwise else "", dist_ms,
                steps, d["first_step_ms"], local_ms, dist_ms / local_ms,
                dist_upd, local_upd, d["sync_calls"] // steps,
                d["sync_ms_total"] / steps, push_mb,
                json.dumps(d["routes"]), json.dumps(card_routes[0]), wall,
                card_line()))
    REPORT["dist"] = dict(dist_ms=dist_ms, local_ms=local_ms,
                          dist_upd=dist_upd, local_upd=local_upd,
                          push_mb=push_mb)
    am = [json.load(open(os.path.join(out, "mlp_async-%d.json" % r)))
          for r in range(2)]
    for r, a in enumerate(am):
        if not (a["acc"] > 0.85 and a["pushes"] == a["steps"] * a["keys"]
                and a["pulls"] == (a["steps"] + 1) * a["keys"]
                and a["parts_fc1"] == 2
                and a["fused_linear"] == 2 * a["steps"]):
            raise AssertionError("phase 7e dist_async rank %d: %s" % (r, a))
    rates = ["push %.1f MB/s pull %.1f MB/s" % (
        a["push_bytes"] / a["push_s"] / 1e6,
        a["pull_bytes"] / a["pull_s"] / 1e6) for a in am]
    _line7e(t0, "dist_async", "train_mnist's MLP %s on gpu(0) in each of 2 "
            "workers over the dist_async servers (%s), fc1_weight range-"
            "partitioned over 2 servers (MXNET_KVSTORE_BIGARRAY_BOUND=%d): "
            "accuracy %s, %s steps, kvstore.pushes %s = steps x keys, pulls "
            "%s = (steps + 1) x keys, 2 fused_linear a step; rank 0 %s, "
            "rank 1 %s; %s" % (
                "-".join(map(str, W.MLP_DIMS)), PERI_NOTE, PERI_ASYNC_BOUND,
                ["%.4f" % a["acc"] for a in am], [a["steps"] for a in am],
                [a["pushes"] for a in am], [a["pulls"] for a in am],
                rates[0], rates[1], card_line()))
    launches = collections.Counter()
    for d in res:
        launches.update({k: v for k, v in d["launches"].items()})
    launches["fused_linear"] += sum(a["fused_linear"] for a in am)
    return launches


def _peri_predict(K, dev, t0, out):
    """7e.3: ResNet-50 f32 saved as prefix-symbol.json/.params; Predictor
    on the card at B=PERI_PRED_B (exact fused_conv_bn_act launches,
    FeedForward.predict within PERI_TOL, a partial-out head at an internal
    layer with its inferred shape, img/s); then the port's C predict
    client over the same files on the card (within PERI_TOL of Python,
    ms a forward)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import capi
    from mxnet_tpu_torch.models import get_resnet
    from mxnet_tpu_torch.predict import Predictor
    from mxnet_tpu_torch.testing import dist_worker as W
    sym = get_resnet(RESNET_CLASSES, RESNET_LAYERS)
    args, aux = W.resnet_params(sym, 5)
    os.makedirs(out, exist_ok=True)
    prefix = os.path.join(out, "resnet50")
    mx.model.save_checkpoint(prefix, 0, sym, {k: mx.nd.array(v, mx.cpu())
                                              for k, v in args.items()},
                             {k: mx.nd.array(v, mx.cpu())
                              for k, v in aux.items()})
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    b = PERI_PRED_B
    X = np.random.RandomState(7).rand(b, 3, RESNET_HW, RESNET_HW).astype(
        np.float32)
    shapes = {"data": X.shape}
    pred = Predictor(*files, shapes, dev_type="gpu", dev_id=0)
    K.reset_launch_counts()
    prob = pred.forward(data=X).get_output(0)
    launches = collections.Counter(_check_launches(
        K, "phase 7e Predictor", {"fused_conv_bn_act": RESNET_CHAINS}))
    model = mx.model.FeedForward(
        sym, ctx=mx.gpu(0), numpy_batch_size=b,
        arg_params={k: mx.nd.array(v) for k, v in args.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    want = model.predict(X)
    err = float(np.abs(prob - want).max())
    if prob.shape != (b, RESNET_CLASSES) or not err <= PERI_TOL:
        raise AssertionError("phase 7e Predictor: shape %s, max |p - "
                             "predict| %.3g" % (prob.shape, err))
    del model
    free_programs()
    xd = torch.from_numpy(X).to(dev)
    for _ in range(2):
        pred.forward(data=xd)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(PERI_PRED_REPS):
        pred.forward(data=xd)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - tic) / PERI_PRED_REPS * 1e3
    # the partial-out head, with the shape the symbol infers for it
    internals = sym.get_internals()
    name = PERI_PARTIAL + "_output"
    _, ishapes, _ = internals.infer_shape(**shapes)
    ishape = tuple(dict(zip(internals.list_outputs(), ishapes))[name])
    part = Predictor(*files, shapes, dev_type="gpu",
                     output_names=[PERI_PARTIAL])
    feat = part.forward(data=X).get_output(0)
    if feat.shape != ishape or not np.isfinite(feat).all():
        raise AssertionError("phase 7e partial out: %s, inferred %s" % (
            feat.shape, ishape))
    del part
    _line7e(t0, "predictor", "ResNet-50 f32 Predictor(dev_type='gpu') at "
            "B=%d: %d fused_conv_bn_act a forward, max |p - "
            "FeedForward.predict| %.3g (gate %g); %.3f ms a forward (%d "
            "timed, synchronized), %.1f img/s; partial out at %s: %s = the "
            "inferred shape; %s" % (
                b, RESNET_CHAINS, err, PERI_TOL, fwd_ms, PERI_PRED_REPS,
                b / fwd_ms * 1e3, PERI_PARTIAL, feat.shape, card_line()))
    # the C client, on the card, over the same files
    exe = capi.build_example("predict_example")
    w0 = time.perf_counter()
    r = subprocess.run([exe, files[0], files[1], "2", "0"]
                       + [str(s) for s in X.shape],
                       input=X.astype("<f4").tobytes(), capture_output=True,
                       timeout=300)
    c_wall = time.perf_counter() - w0
    if r.returncode != 0:
        raise AssertionError("phase 7e C predict client failed: %s"
                             % r.stderr.decode()[-3000:])
    got = np.array(r.stdout.split(), dtype=np.float32).reshape(prob.shape)
    cerr = float(np.abs(got - prob).max())
    c_ms = float(r.stderr.decode().split("forward_ms")[-1].split()[0])
    if not cerr <= PERI_TOL:
        raise AssertionError("phase 7e C predict client: max |c - python| "
                             "%.3g" % cerr)
    _line7e(t0, "c_predict", "the port's C predict client (predict_example "
            "over libmxnet_tpu_torch_predict.so, dev_type 2) on the same "
            "files at B=%d: max |c - Python| %.3g (gate %g); %.3f ms its "
            "second MXTPredForward (outputs copied to the host included); "
            "the whole process %.1f s (interpreter, torch and CUDA start); "
            "%s" % (b, cerr, PERI_TOL, c_ms, c_wall, card_line()))
    REPORT["predict"] = dict(fwd_ms=fwd_ms, img_s=b / fwd_ms * 1e3,
                             c_ms=c_ms)
    return launches, pred


def _peri_graph_abi(t0, out):
    """7e.4: the port's train_c on the card through the graph ABI alone
    (accuracy > 0.9); MXDataIter over a CSV iterator handle the C ABI
    created, against CSVIter."""
    import ctypes
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import capi
    exe = capi.build_example("train_c")
    os.makedirs(out, exist_ok=True)
    w0 = time.perf_counter()
    r = subprocess.run([exe, "2", "0"], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, TMPDIR=out))
    secs = time.perf_counter() - w0
    if r.returncode != 0 or "C-ABI training OK" not in r.stdout:
        raise AssertionError("phase 7e train_c: %s %s" % (
            r.stdout[-2000:], r.stderr[-3000:]))
    acc = float(r.stdout.split("accuracy")[-1])
    if not acc > 0.9:
        raise AssertionError("phase 7e train_c: accuracy %.4f" % acc)
    rs = np.random.RandomState(9)
    x = rs.randn(1000, 20).astype(np.float32)
    y = rs.randint(0, 5, 1000).astype(np.float32)
    dpath, lpath = os.path.join(out, "d.csv"), os.path.join(out, "l.csv")
    np.savetxt(dpath, x, delimiter=",", fmt="%.9g")
    np.savetxt(lpath, y, delimiter=",", fmt="%d")
    lib = ctypes.CDLL(capi.build("graph"))
    lib.MXTApiGetLastError.restype = ctypes.c_char_p
    n = ctypes.c_uint()
    creators = ctypes.POINTER(ctypes.c_void_p)()
    if lib.MXTListDataIters(ctypes.byref(n), ctypes.byref(creators)):
        raise AssertionError(lib.MXTApiGetLastError())
    csv = None
    for i in range(n.value):
        nm, desc = ctypes.c_char_p(), ctypes.c_char_p()
        na = ctypes.c_uint()
        an, at, ad = (ctypes.POINTER(ctypes.c_char_p)() for _ in range(3))
        lib.MXTDataIterGetIterInfo(
            ctypes.c_void_p(creators[i]), ctypes.byref(nm),
            ctypes.byref(desc), ctypes.byref(na), ctypes.byref(an),
            ctypes.byref(at), ctypes.byref(ad))
        if nm.value == b"CSVIter":
            csv = creators[i]
    keys = [b"data_csv", b"data_shape", b"label_csv", b"batch_size"]
    vals = [dpath.encode(), b"(20,)", lpath.encode(), b"100"]
    h = ctypes.c_void_p()
    if csv is None or lib.MXTDataIterCreateIter(
            ctypes.c_void_p(csv), 4, (ctypes.c_char_p * 4)(*keys),
            (ctypes.c_char_p * 4)(*vals), ctypes.byref(h)):
        raise AssertionError("phase 7e: CSVIter handle: %s"
                             % lib.MXTApiGetLastError())
    got = mx.io.MXDataIter(h.value)
    want = mx.io.CSVIter(data_csv=dpath, data_shape=(20,), label_csv=lpath,
                         batch_size=100)
    nb = 0
    for bg, bw in zip(got, want):
        if not (np.array_equal(bg.data[0].asnumpy(), bw.data[0].asnumpy())
                and np.array_equal(bg.label[0].asnumpy(),
                                   bw.label[0].asnumpy())):
            raise AssertionError("phase 7e MXDataIter: batch %d differs"
                                 % nb)
        nb += 1
    if nb != 10:
        raise AssertionError("phase 7e MXDataIter: %d batches" % nb)
    _line7e(t0, "graph_abi", "the port's train_c (libmxnet_tpu_torch_capi."
            "so, dev_type 2: CSVIter, Symbol compose, Executor, KVStore with "
            "a C momentum-SGD updater) trained its MLP to accuracy %.4f in "
            "%.1f s (process start included); MXDataIter over a C-created "
            "CSVIter handle: %d batches equal CSVIter's; %s" % (
                acc, secs, nb, card_line()))


def _custom_softmax(mx):
    class Softmax(mx.operator.NumpyOp):
        """softmax forward, p - onehot(label) backward, on the host."""

        def __init__(self):
            super().__init__(False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            e = np.exp(x - x.max(axis=1, keepdims=True))
            out_data[0][:] = e / e.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            g = out_data[0].copy()
            g[np.arange(lab.shape[0]), lab] -= 1.0
            in_grad[0][:] = g
    return Softmax()


def _peri_extensions(K, dev, t0, timed):
    """7e.5: a NumpyOp softmax inside an MLP fit on the card against the
    built-in SoftmaxOutput (deltas within PERI_TOL by norm; the step ran
    uncaptured, counted); TorchModuleOp(nn.Linear) forward and backward
    against F.linear's; an Rtc saxpy compiled at run time on gpu(0)
    NDArrays against torch's, timed into ``timed``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import telemetry as tele
    from mxnet_tpu_torch.parallel.program import WARMUP
    launches = collections.Counter()
    d_in, hid, k = PERI_MLP
    rs = np.random.RandomState(11)
    n = PERI_MLP_B * PERI_MLP_BATCHES
    protos = rs.randn(k, d_in)
    y = rs.randint(0, k, n)
    X = (0.1 * (protos[y] + rs.randn(n, d_in))).astype(np.float32)
    y = y.astype(np.float32)
    deltas = []
    for custom in (False, True):
        s = mx.symbol
        net = s.FullyConnected(data=s.Variable("data"), num_hidden=hid,
                               name="fc1")
        net = s.Activation(data=net, act_type="relu", name="relu1")
        net = s.FullyConnected(data=net, num_hidden=k, name="fc2")
        net = _custom_softmax(mx)(data=net, name="softmax") if custom \
            else s.SoftmaxOutput(data=net, name="softmax")
        arg_shapes, _, _ = net.infer_shape(data=(PERI_MLP_B, d_in))
        prs = np.random.RandomState(12)
        init = {nm: (0.05 * prs.randn(*sh)).astype(np.float32)
                for nm, sh in zip(net.list_arguments(), arg_shapes)
                if nm not in ("data", "softmax_label")}
        model = mx.model.FeedForward(
            net, ctx=mx.gpu(0), num_epoch=2, learning_rate=0.1,
            momentum=0.9, arg_params={nm: mx.nd.array(v)
                                      for nm, v in init.items()})
        unc0 = tele.counter("program.uncaptured_runs").value
        K.reset_launch_counts()
        model.fit(mx.io.NDArrayIter(X, y, batch_size=PERI_MLP_B),
                  kvstore="local")
        torch.cuda.synchronize()
        got = K.launch_counts()
        unc = tele.counter("program.uncaptured_runs").value - unc0
        steps = 2 * PERI_MLP_BATCHES
        # a captured program also launches in its warm-up runs
        warm = 0 if custom else WARMUP
        if unc != (steps if custom else 0) \
                or got["fused_linear"] != steps + warm:
            raise AssertionError("phase 7e custom-op fit (custom %s): %d "
                                 "uncaptured runs, %d fused_linear over %d "
                                 "steps" % (custom, unc,
                                            got["fused_linear"], steps))
        launches.update(got)
        deltas.append({nm: torch.from_numpy(model.arg_params[nm].asnumpy()
                                            - v) for nm, v in init.items()})
        del model
        free_programs()
    rows = _delta_rows(deltas[1], deltas[0])
    if not rows[0][0] <= PERI_TOL:
        raise AssertionError("phase 7e NumpyOp softmax fit: deltas %s"
                             % rows[:3])
    _line7e(t0, "custom_op", "an MLP %d-%d-%d fit on gpu(0) (the fused "
            "loop), 2 epochs of %d batches of %d, with a NumpyOp softmax: "
            "deltas against the built-in SoftmaxOutput worst %s %.3g by norm "
            "(gate %g); the step program ran uncaptured %d times "
            "(program.uncaptured_runs; 0 with the built-in op, captured "
            "after its %d warm-ups); 1 fused_linear a step" % (
                d_in, hid, k, PERI_MLP_BATCHES, PERI_MLP_B, rows[0][2],
                rows[0][0], PERI_TOL, 2 * PERI_MLP_BATCHES, WARMUP))
    # TorchModuleOp(nn.Linear) against F.linear
    gen = torch.Generator().manual_seed(13)
    lin = torch.nn.Linear(1024, 1024).to(dev)
    x = torch.randn(256, 1024, generator=gen).to(dev)
    head = torch.randn(256, 1024, generator=gen).to(dev)
    net = mx.th.TorchModuleOp(lin)(data=mx.sym.Variable("data"), name="lin")
    exe = net.simple_bind(mx.gpu(0), data=(256, 1024))
    exe.arg_dict["data"][:] = x
    exe.forward(is_train=True)
    exe.backward([mx.nd.array(head)])
    xr = x.clone().requires_grad_(True)
    ref = torch.nn.functional.linear(xr, lin.weight, lin.bias)
    ref.backward(head)
    ferr = (exe.outputs[0]._tensor - ref.detach()).abs().max().item()
    berr = (exe.grad_dict["data"]._tensor - xr.grad).abs().max().item()
    if ferr > 1e-6 or berr > 1e-6:
        raise AssertionError("phase 7e TorchModuleOp: forward %.3g "
                             "backward %.3g" % (ferr, berr))
    _line7e(t0, "torch_module", "TorchModuleOp(nn.Linear(1024, 1024)) bound "
            "on gpu(0) at B=256: forward max err %.3g, input gradient max "
            "err %.3g against F.linear and autograd" % (ferr, berr))
    # Rtc: saxpy compiled through NVRTC, launched on torch's stream
    xs = torch.randn(RTC_N, generator=gen).to(dev)
    ys = torch.randn(RTC_N, generator=gen).to(dev)
    xn, yn = mx.nd.array(xs), mx.nd.array(ys)
    w0 = time.perf_counter()
    kern = rtc.Rtc("saxpy", [("x", xn)], [("y", yn)], RTC_SRC)
    grid, block = ((RTC_N + 255) // 256, 1, 1), (256, 1, 1)
    rtc.LAUNCHES.clear()
    kern.push([xn], [yn], grid, block)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - w0
    want = ys + 2.0 * xs
    err = (yn._tensor - want).abs().max().item()
    if not torch.allclose(yn._tensor, want, rtol=1e-6, atol=1e-6):
        raise AssertionError("phase 7e Rtc saxpy: max err %.3g" % err)
    main_launches = rtc.LAUNCHES["saxpy"]
    timer = Timer(dev)
    ms = timer(lambda: kern.push([xn], [yn], grid, block))
    plain = timer(lambda: yn._tensor.add_(2.0 * xn._tensor))
    lib = timer(lambda: torch.add(yn._tensor, xn._tensor, alpha=2.0,
                                  out=yn._tensor))
    bms, by = bound_ms(3 * RTC_N * 4, 2 * RTC_N, torch.float32)
    timed["rtc_saxpy"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bms, bound_by=by, library_ms=lib,
                              shape="n=%d f32" % RTC_N)
    _line7e(t0, "rtc", "Rtc('saxpy') over gpu(0) NDArrays of %d f32, "
            "compiled through NVRTC for the card and launched with "
            "cuLaunchKernel on torch's stream: max err %.3g against torch "
            "(compile and first launch %.3f s); %.4f ms a launch, plain "
            "(y += 2 * x, two kernels) %.4f, torch.add(alpha=2) %.4f, bound "
            "%.4f (%s); %s" % (RTC_N, err, compile_s, ms, plain, lib, bms,
                               by, card_line()))
    return launches, main_launches


def _decode_flops():
    """The decode program's operations a round from the kernels' shapes:
    STEPS_PER_ROUND steps of, a layer, fused_decode_attention's QKV and
    output GEMMs and its read of every cached row, the two FFN
    quant_matmuls; and the LM head's quant_matmul."""
    s, e, d = SLOTS, EMBED, EMBED // HEADS
    layer = 2 * s * 3 * e * e + 4 * s * HEADS * MAX_LEN * d \
        + 2 * s * e * e + 2 * (2 * s * 4 * e * e)
    return STEPS_PER_ROUND * (LAYERS * layer + 2 * s * VOCAB * e)


def _peri_profiler(K, dev, t0, out, pred, prefix):
    """7e.6: profiler.start/scope/stop around a Predictor forward (the
    trace names the scope and the fused_conv_bn_act kernels); then an
    engine with phase 4's settings serves, collect_program_stats: the
    decode program's flops equal the kernels' count within 1%, and
    /metrics shows them."""
    import re
    import urllib.request
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler, telemetry
    src = open(os.path.join(HERE, "mxnet_tpu_torch", "ops", "csrc",
                            "fused_linear.cu")).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]"
                       r"|\([^()]*\))*\)\s+)?(\w+)", src)
    xd = torch.from_numpy(np.random.RandomState(7).rand(
        PERI_PRED_B, 3, RESNET_HW, RESNET_HW).astype(np.float32)).to(dev)
    tdir = os.path.join(out, "trace")
    profiler.start(tdir)
    with profiler.scope("predictor_forward"):
        pred.forward(data=xd)
        torch.cuda.synchronize()
    path = profiler.stop()
    events = json.load(open(path))["traceEvents"]
    scoped = [e for e in events if e.get("name") == "predictor_forward"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and any(nm in e.get("name", "") for nm in names)]
    if not scoped or len(kern) < RESNET_CHAINS:
        raise AssertionError("phase 7e profiler: %d scope events, %d "
                             "fused_linear.cu kernels" % (len(scoped),
                                                          len(kern)))
    mem = profiler.device_memory()
    _line7e(t0, "profiler", "start/scope/stop around a Predictor forward: "
            "the trace (%s, %.1f MB) names the scope and %d kernels of "
            "fused_linear.cu (%s); device_memory %s" % (
                os.path.basename(path), os.path.getsize(path) / 2**20,
                len(kern), ", ".join(sorted({nm for nm in names if any(
                    nm in e["name"] for e in kern)})),
                json.dumps({k: int(v) for k, v in mem.items()})))
    os.remove(path)
    model = mx.model.FeedForward.load(prefix, 0, ctx=mx.gpu(0))
    engine = model.as_serving_engine(
        MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused", compute_dtype="bfloat16",
        prefix_cache_mb=0, prefill_chunk=0)
    rs = np.random.RandomState(2)
    for p in BUCKETS:
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    K.reset_launch_counts()
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    launches = collections.Counter(K.launch_counts())
    profiler.collect_program_stats()
    flops = telemetry.gauge("program.serving_decode.flops").value
    nbytes_ = telemetry.gauge("program.serving_decode.bytes_accessed").value
    want = _decode_flops()
    if not (flops > 0 and abs(flops - want) <= 0.01 * want):
        raise AssertionError("phase 7e program flops: %.6g, the kernels' "
                             "count %.6g" % (flops, want))
    srv = telemetry.serve(port=0)
    try:
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
    finally:
        srv.stop()
    line = [ln for ln in text.splitlines()
            if ln.startswith("mxnet_program_serving_decode_flops ")]
    if not line or float(line[0].split()[1]) != flops:
        raise AssertionError("phase 7e /metrics: %r" % line)
    _line7e(t0, "program_cost", "an engine with phase 4's settings served "
            "3 requests; program.serving_decode.flops %.6g against the "
            "kernels' count %.6g (%+.4f%%), bytes_accessed %.6g; /metrics "
            "shows %r; registered %s" % (
                flops, want, (flops - want) / want * 100, nbytes_, line[0],
                profiler.registered_programs()))
    engine.close()
    del model
    free_programs()
    return launches


def periphery_main_path(K, dev, prefix):
    """Phase 7e, the periphery on the card: the distributed store (two
    workers on one card), Predictor and the C predict ABI, the C graph
    ABI, the extension points, the profiler and the program-cost gauges.
    Returns (the launches of its gated runs, in-process and the workers',
    the Rtc launches, the Rtc timing row)."""
    t0 = time.perf_counter()
    out = os.path.join(HERE, "build", "periphery7e")
    launches = collections.Counter()
    timed = {}
    try:
        launches.update(_peri_dist(K, dev, t0, os.path.join(out, "dist")))
        got, pred = _peri_predict(K, dev, t0, os.path.join(out, "predict"))
        launches.update(got)
        _peri_graph_abi(t0, os.path.join(out, "capi"))
        got, rtc_launches = _peri_extensions(K, dev, t0, timed)
        launches.update(got)
        launches.update(_peri_profiler(K, dev, t0, out, pred, prefix))
    finally:
        import shutil
        shutil.rmtree(out, ignore_errors=True)
    _line7e(t0, "done", "every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t0, json.dumps(
            {e: n for e, n in launches.items() if n})))
    return dict(launches), rtc_launches, timed


# -- phase 7f: multi-process training -----------------------------------------

MP_NOTE = "two processes on ONE card, not a multi-card figure"
MP_CHECKS = "lm_dp,bn_global,ckpt,shardio,pipe,sp"
MP_SIZE = "full"                    # dist_worker's LM_SIZES / BN_SIZES


def _line7f(t0, what, text):
    log("phase 7f %s: %s (%.1f s into the phase)" % (
        what, text, time.perf_counter() - t0))


def _timed_steps(tr, batches):
    """Step over ``batches``: (ms a step of every step after the first,
    synchronized; the launches of those steps)."""
    from mxnet_tpu_torch.ops import kernels as K
    ms = []
    for i, b in enumerate(batches):
        if i == 1:
            K.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.step(b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    return ms[1:], {k: v for k, v in K.launch_counts().items() if v}


def _mp_oracle(W, dev, what, make, batches, state=None):
    """The one-process run over ``[dev] * 2`` (one captured program):
    (its state's digests (``state(trainer)``, default
    ``dist_worker.trainer_state``), ms a step, launches a step)."""
    from mxnet_tpu_torch.testing import dist_worker as Wm
    tr = make()
    ms, launches = _timed_steps(tr, batches)
    digests = Wm.digests((state or Wm.trainer_state)(tr))
    if tr.compile_counts != {"step": 1}:
        raise AssertionError("phase 7f %s oracle: compile_counts %r"
                             % (what, tr.compile_counts))
    del tr
    free_programs()
    return digests, ms, launches


def _same_digests(what, got, want):
    bad = sorted(k for k in want if got.get(k) != want[k])
    if bad or sorted(got) != sorted(want):
        raise AssertionError("phase 7f %s: not bitwise: %d of %d arrays "
                             "differ (%s)" % (what, len(bad), len(want),
                                              bad[:4]))


def multiproc_main_path(K, dev, checks=MP_CHECKS):
    """Phase 7f: ``ParallelTrainer``, ``PipelineTrainer`` and
    ``SequenceParallelTrainer`` over one mesh across two processes on the
    one card (``tools/launch.py -n 2``,
    ``mxnet_tpu_torch.testing.dist_worker`` at its full size; the kernels
    built by this process first): the 124M LM (plain, zero1, fsdp;
    AdaFactor with fsdp), ResNet-50 f32 with global BatchNorm,
    checkpoints from both processes (after ``lm_dp``), the sharded-IO
    fit, the pipelined LM (GPipe and 1F1B, a stage a process), the
    sequence-parallel LM (phase 7's cell, 2 ranks a process); each held
    against the one-process run over ``[dev] * 2`` here (``sp``: phase
    7's run over ``[dev] * 4``), bitwise. ``checks``: which of
    ``MP_CHECKS`` run. Returns the workers' launches."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.testing import dist_worker as W
    t0 = time.perf_counter()
    out = os.path.join(HERE, "build", "multiproc7f")
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ)
    env.update(MXNET_DISTTEST_CHECKS=checks, MXNET_DISTTEST_OUT=out,
               MXNET_DISTTEST_SIZE=MP_SIZE,
               PYTHONPATH=HERE + os.pathsep + env.get("PYTHONPATH", ""))
    for k in ("MXNET_TPU_COORDINATOR", "MXNET_KVSTORE_PORT_BASE",
              "MXNET_TPU_LOCAL_DEVICES", "MXNET_DISTTEST_CTX", GATE):
        env.pop(k, None)
    try:
        w0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "tools", "launch.py"), "-n",
             "2", "--", sys.executable, "-m",
             "mxnet_tpu_torch.testing.dist_worker"],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - w0
        if proc.returncode != 0 or proc.stdout.count("OK all") != 2:
            raise AssertionError(
                "phase 7f workers failed (rc %d):\n%s\n%s" % (
                    proc.returncode, proc.stdout[-3000:],
                    proc.stderr[-6000:]))
        timing = [ln for ln in proc.stdout.splitlines()
                  if ln.startswith("TIMING")]
        _line7f(t0, "workers", "2 processes through tools/launch.py -n 2 "
                "in %.1f s (%s); %s" % (wall, "; ".join(timing), MP_NOTE))
        names = checks.split(",")
        launches = collections.Counter()
        if "lm_dp" in names:
            launches.update(_mp_lm(W, par, dev, t0, out))
            launches.update(_mp_adafactor(W, par, dev, t0, out))
        if "bn_global" in names:
            _mp_resnet(W, par, dev, t0, out)
        if "ckpt" in names:
            _mp_ckpt(W, par, dev, t0, out)
        if "shardio" in names:
            _mp_shardio(W, t0, out)
        if "pipe" in names:
            launches.update(_mp_pipe(W, par, dev, t0, out, timing))
        if "sp" in names:
            launches.update(_mp_sp(W, dev, t0, out, timing))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _line7f(t0, "done", "every check passed in %.1f s; launches %s" % (
        time.perf_counter() - t0, json.dumps(launches)))
    return dict(launches)


def _mp_shardio(W, t0, out):
    """7f.4: the sharded-IO fit's accuracy, above 0.85 and equal in both
    processes."""
    acc = [json.load(open(os.path.join(out, "shardio-%d.json" % r)))
           for r in range(2)]
    if not (acc[0]["acc"] > 0.85 and acc[0]["acc"] == acc[1]["acc"]):
        raise AssertionError("phase 7f shardio: %s" % acc)
    _line7f(t0, "shardio", "RAW0 records (%d of %dx%d, %d classes) "
            "written by rank 0, ImageRecordIter(num_parts=2, "
            "part_index=rank) into fit(device_metric=True) over {dp: 2} "
            "(global batch 16), 30 epochs: accuracy %s, equal in both "
            "processes; fit %.1f s; %s" % (
                W.SHARDIO_N, W.SHARDIO_HW, W.SHARDIO_HW, W.SHARDIO_K,
                [a["acc"] for a in acc], acc[0]["fit_s"], card_line()))


def _mp_pipe_launches(schedule, layers, steps):
    """Flash launches of ``steps`` pipeline steps over ``layers`` layers
    (a process's stage, or every stage in one process), PIPE_M
    microbatches each; 1F1B's backward recomputes the forward."""
    from mxnet_tpu_torch.testing import dist_worker as W
    n = layers * W.PIPE_M * steps
    return {"flash_attention_fwd": n * (2 if schedule == "1f1b" else 1),
            "flash_attention_dq": n, "flash_attention_dkv": n}


def _mp_pipe(W, par, dev, t0, out, timing):
    """7f.5: ``PipelineTrainer`` on the 124M LM at full width f32
    (``pipeline_stages=2``), global B=8 T=1024, M=4, over {pp: 2} with
    one stage in each of the two processes, GPipe and 1F1B, 3 SGD
    momentum steps on one batch: each process's state (the whole
    parameters from ``get_params``, its rank's momentum) bitwise the
    one-process run over [dev] * 2 here, both ranks' parameters equal,
    the head only in the last stage's process, a falling loss, exactly
    the stage's flash launches, the step one uncaptured program (a gloo
    hop each tick); ms a step against the one-process captured run, the
    hops' MB and calls a step. Returns the workers' launches."""
    cfg = W.LM_SIZES[MP_SIZE]
    batch = W.lm_batch(cfg)
    layers = cfg["layers"] if dev.type == "cuda" else 0
    steps = W.LM_STEPS - 1
    launches = collections.Counter()
    rows = []
    t1 = time.perf_counter()
    for schedule in W.pipe_schedules("a"):
        want, one_ms, one_launches = _mp_oracle(
            W, dev, "pipe %s" % schedule,
            lambda: W.pipe_trainer(par, cfg, par.build_mesh(
                {"pp": 2}, [dev] * 2), schedule),
            [batch] * W.LM_STEPS, state=W.pipe_state)
        if one_launches != {e: n for e, n in _mp_pipe_launches(
                schedule, layers, steps).items() if n}:
            raise AssertionError("phase 7f pipe %s oracle: launches %r"
                                 % (schedule, one_launches))
        res = [json.load(open(os.path.join(out, "pipe-a-%s-%d.json"
                                                % (schedule, r))))
               for r in range(2)]
        for r, d in enumerate(res):
            what = "pipe %s rank %d" % (schedule, r)
            got = d["digests"]
            _same_digests(what, got, {k: want[k] for k in got})
            if not all(k in got for k in want if k.startswith("arg:")):
                raise AssertionError("phase 7f %s: parameters missing"
                                     % what)
            if d["has_head"] != (r == 1):
                raise AssertionError("phase 7f %s: a head where the "
                                     "process runs no last stage, or none "
                                     "where it does" % what)
            if not all(math.isfinite(v) for v in d["loss"]) \
                    or not d["loss"][-1] < d["loss"][0] \
                    or d["loss"] != res[0]["loss"]:
                raise AssertionError("phase 7f %s: loss %s" % (what,
                                                               d["loss"]))
            if d["launches"] != {e: n for e, n in _mp_pipe_launches(
                    schedule, layers // 2, steps).items() if n}:
                raise AssertionError("phase 7f %s: launches %r" % (
                    what, d["launches"]))
            if d["compile_counts"] != {"step": 1} or d["programs"] != 1 \
                    or d["captured"] != 0:
                raise AssertionError("phase 7f %s: programs %d, %d "
                                     "captured, compile_counts %r" % (
                                         what, d["programs"], d["captured"],
                                         d["compile_counts"]))
            launches.update(d["launches"])
        if set(res[0]["digests"]) | set(res[1]["digests"]) != set(want):
            raise AssertionError("phase 7f pipe %s: the ranks' states do "
                                 "not cover the one-process state"
                                 % schedule)
        rows.append(
            "%s: ms a step %.3f across the processes (steps 2-%d: %s) "
            "against %.3f in one process (captured; %s), hops and the "
            "loss's sum %.3f ms and %.2f MB sent a process a step in %.1f "
            "calls (rank 0 %.2f MB, rank 1 %.2f MB), loss %s, launches "
            "a step in each process %s" % (
                schedule, statistics.median(res[0]["ms"][1:]), W.LM_STEPS,
                ["%.3f" % v for v in res[0]["ms"][1:]],
                statistics.median(one_ms), ["%.3f" % v for v in one_ms],
                res[0]["cross_ms"], res[0]["cross_bytes"] / 1e6,
                res[0]["cross_calls"], res[0]["cross_bytes"] / 1e6,
                res[1]["cross_bytes"] / 1e6,
                ["%.4f" % v for v in res[0]["loss"]],
                json.dumps({e: n // steps
                            for e, n in res[0]["launches"].items()})))
    _line7f(t0, "pipe", "PipelineTrainer, LM (%d layers, E=%d, %d heads, "
            "vocab %d) f32 with pipeline_stages=2, global B=%d T=%d, M=%d, "
            "over {pp: 2} with one stage in each of 2 processes (%s), SGD "
            "lr %g momentum 0.9, %d steps on one batch: GPipe and 1F1B "
            "each bitwise equal to one process over [%s] * 2 (parameters "
            "in both ranks, each rank's momentum), the head only in rank "
            "1, one uncaptured program a step; %s; the workers' pipe "
            "check %s, the one-process runs here %.1f s; %s" % (
                cfg["layers"], cfg["embed"], cfg["heads"], cfg["vocab"],
                cfg["b"], cfg["t"], W.PIPE_M, MP_NOTE, W.LM_LR, W.LM_STEPS,
                dev, "; ".join(rows), "; ".join(
                    t for t in timing if t.startswith("TIMING pipe")),
                time.perf_counter() - t1, card_line()))
    return dict(launches)


def _mp_lm(W, par, dev, t0, out):
    """7f.1: the 124M LM at full width, bf16 over f32 masters, global B=8
    T=1024 over {dp: 2} across the two processes, SGD lr 1e-3 momentum
    0.9, LM_DP_STEPS steps on one batch: each variant's ranks bitwise
    equal, equal
    to the one-process [dev] * 2 run, zero1 and fsdp to plain, a falling
    loss, 12 launches of each flash entry a step in each process, the
    compute and the update captured with the collective between them."""
    cfg = W.LM_SIZES[MP_SIZE]
    nsteps = W.LM_DP_STEPS[MP_SIZE]
    batch = W.lm_batch(cfg)
    card = dev.type == "cuda"
    want, one_ms, one_launches = _mp_oracle(
        W, dev, "lm", lambda: W.lm_trainer(par, cfg, par.build_mesh(
            {"dp": 2}, [dev] * 2)), [batch] * nsteps)
    steps = nsteps - 1
    layers = cfg["layers"] if card else 0
    for e in FLASH_ENTRIES:
        if one_launches.get(e, 0) != 2 * layers * steps:
            raise AssertionError("phase 7f lm oracle: launches %r"
                                 % one_launches)
    launches = collections.Counter()
    rows = []
    for variant, _ in W.LM_VARIANTS:
        res = [json.load(open(os.path.join(out, "lm_dp-%s-%d.json"
                                                % (variant, r))))
               for r in range(2)]
        for r, d in enumerate(res):
            _same_digests("lm %s rank %d" % (variant, r), d["digests"],
                          want)
            if not all(math.isfinite(v) for v in d["loss"]) \
                    or not d["loss"][-1] < d["loss"][0]:
                raise AssertionError("phase 7f lm %s: the loss did not "
                                     "fall: %s" % (variant, d["loss"]))
            flash = {e: d["launches"].get(e, 0) for e in FLASH_ENTRIES}
            if flash != {e: layers * steps for e in FLASH_ENTRIES} \
                    or set(d["launches"]) - set(FLASH_ENTRIES):
                raise AssertionError("phase 7f lm %s rank %d: launches %r "
                                     "(want %d of each flash entry a step)"
                                     % (variant, r, d["launches"], layers))
            if d["compile_counts"] != {"step.compute": 1,
                                       "step.update": 1} \
                    or d["programs"] != 2 \
                    or d["captured"] != (2 if card else 0):
                raise AssertionError("phase 7f lm %s: programs %s, %d "
                                     "captured, compile_counts %r" % (
                                         variant, d["programs"],
                                         d["captured"], d["compile_counts"]))
            launches.update(d["launches"])
        d = res[0]
        rows.append("%s: ms a step %.3f (steps 2-%d: %s), the collectives "
                    "%.3f ms and %.1f MB a step in %d calls, %d programs a "
                    "step (%d captured) and %d host stages, loss %s, rank "
                    "0 stores %.1f MB of parameters and %.1f MB of state" % (
                        variant, statistics.median(d["ms"][1:]),
                        nsteps, ["%.3f" % v for v in d["ms"][1:]],
                        d["cross_ms"], d["cross_bytes"] / 1e6,
                        d["cross_calls"], d["programs"], d["captured"],
                        d["host_stages"], ["%.4f" % v for v in d["loss"]],
                        d["state_bytes"][0][0] / 1e6,
                        d["state_bytes"][0][1] / 1e6))
    REPORT["mp_lm"] = dict(one_ms=statistics.median(one_ms))
    _line7f(t0, "lm_dp", "LM (%d layers, E=%d, %d heads, vocab %d) %s "
            "over f32 masters, global B=%d T=%d over {dp: 2} "
            "across 2 processes (%s), SGD lr %g momentum 0.9, %d steps on "
            "one batch: plain, zero1 and fsdp each bitwise equal on both "
            "ranks, to each other and to one process over [%s] * 2 (one "
            "captured program: ms a step %.3f, steps 2-%d: %s); %d of each "
            "flash entry a step in each process; %s; %s" % (
                cfg["layers"], cfg["embed"], cfg["heads"], cfg["vocab"],
                cfg["dtype"] or "f32",
                cfg["b"], cfg["t"], MP_NOTE, W.LM_LR, nsteps, dev,
                statistics.median(one_ms), nsteps,
                ["%.3f" % v for v in one_ms], layers, "; ".join(rows),
                card_line()))
    return dict(launches)


def _mp_adafactor(W, par, dev, t0, out):
    """7f.1b: the LM of 7f.1 with AdaFactor (lr 1e-3) and fsdp, its
    factored state leaves sharded over dp with the parameters across the
    two processes, LM_DP_STEPS steps: both ranks bitwise equal to
    the one-process [dev] * 2 run, a falling loss, the flash launches,
    the compute and the update captured with a host stage gathering the
    shards before the update."""
    variant, kw = W.LM_ADAFACTOR
    cfg = W.LM_SIZES[MP_SIZE]
    nsteps = W.LM_DP_STEPS[MP_SIZE]
    batch = W.lm_batch(cfg)
    card = dev.type == "cuda"
    want, one_ms, one_launches = _mp_oracle(
        W, dev, variant, lambda: W.lm_trainer(par, cfg, par.build_mesh(
            {"dp": 2}, [dev] * 2), **kw), [batch] * nsteps)
    steps = nsteps - 1
    layers = cfg["layers"] if card else 0
    if any(one_launches.get(e, 0) != 2 * layers * steps
           for e in FLASH_ENTRIES):
        raise AssertionError("phase 7f %s oracle: launches %r"
                             % (variant, one_launches))
    res = [json.load(open(os.path.join(out, "lm_dp-%s-%d.json"
                                            % (variant, r))))
           for r in range(2)]
    launches = collections.Counter()
    for r, d in enumerate(res):
        what = "%s rank %d" % (variant, r)
        _same_digests(what, d["digests"], want)
        if not all(math.isfinite(v) for v in d["loss"]) \
                or not d["loss"][-1] < d["loss"][0] \
                or d["loss"] != res[0]["loss"]:
            raise AssertionError("phase 7f %s: loss %s" % (what, d["loss"]))
        if d["launches"] != {e: layers * steps for e in FLASH_ENTRIES
                             if layers}:
            raise AssertionError("phase 7f %s: launches %r"
                                 % (what, d["launches"]))
        if d["compile_counts"] != {"step.compute": 1, "step.update": 1} \
                or d["captured"] != (2 if card else 0) \
                or d["host_stages"] != 4:
            raise AssertionError("phase 7f %s: %d captured, %d host "
                                 "stages, compile_counts %r" % (
                                     what, d["captured"], d["host_stages"],
                                     d["compile_counts"]))
        launches.update(d["launches"])
    d = res[0]
    _line7f(t0, variant, "LM (%d layers, E=%d, %d heads, vocab %d) %s over "
            "f32 masters, global B=%d T=%d over {dp: 2} across 2 processes "
            "(%s), AdaFactor lr %g with fsdp (its state leaves sharded with "
            "the parameters), %d steps: bitwise equal on both ranks and to "
            "one process over [%s] * 2 (ms a step %s); ms a step %s across "
            "the processes, the collectives %.3f ms and %.1f MB a step in "
            "%d calls, %d host stages; loss %s; rank 0 stores %.1f MB of "
            "parameters and %.1f MB of state; %s" % (
                cfg["layers"], cfg["embed"], cfg["heads"], cfg["vocab"],
                cfg["dtype"] or "f32", cfg["b"], cfg["t"], MP_NOTE,
                W.LM_LR, nsteps, dev, ["%.3f" % v for v in one_ms],
                ["%.3f" % v for v in d["ms"][1:]], d["cross_ms"],
                d["cross_bytes"] / 1e6, d["cross_calls"], d["host_stages"],
                ["%.4f" % v for v in d["loss"]],
                d["state_bytes"][0][0] / 1e6, d["state_bytes"][0][1] / 1e6,
                card_line()))
    return dict(launches)


def _mp_sp(W, dev, t0, out, timing):
    """7f.6: SequenceParallelTrainer, phase 7's cell (the 124M LM,
    ring_striped, f32, B=2 T=4096, SGD lr 1e-3 momentum 0.9) over {dp: 1,
    sp: 4} with 2 ranks in each of the two processes on the one card
    (layout "b": two hops of each rotation cross), 3 steps: both
    processes' parameters and momentum bitwise phase 7's run over [dev] *
    4 after as many steps (run here when phase 7 did not), the losses its
    losses, exactly 2 ranks x 4 hops x 12 layers = 96 launches of each
    striped_pair entry and 24 of fused_linear a step in each process; ms
    a step against phase 7's, the exchanges' ms, MB and calls a step (the
    checkpoint across processes is the tiny size's, in the CPU tests).
    Returns the workers' launches."""
    cfg = W.SP_SIZES[MP_SIZE]
    layers = cfg["layers"] if dev.type == "cuda" else 0
    ranks = W.SP_AXES["b"]["sp"] // 2
    if "sp_oracle" not in REPORT:
        tr = _sp_trainer(dev, cfg["b"], cfg["t"])
        batch = W.lm_batch(cfg)
        losses, secs = [], []
        for _ in range(W.LM_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(tr.step(batch).item())
            secs.append(time.perf_counter() - t1)
        _sp_oracle_record(tr, losses)
        REPORT["sp_ms"] = statistics.median(secs[1:]) * 1e3
        del tr
    want = REPORT["sp_oracle"]
    steps = W.LM_STEPS - 1
    per_step = {e: ranks * W.SP_AXES["b"]["sp"] * layers
                for e in SP_ENTRIES}
    per_step["fused_linear"] = ranks * layers
    launches = collections.Counter()
    res = [json.load(open(os.path.join(out, "sp-%s-b-%d.json"
                                            % (cfg["impls"][0], r))))
           for r in range(2)]
    for r, d in enumerate(res):
        what = "sp rank %d" % r
        _same_digests(what, d["digests"], want["digests"])
        if d["loss"] != want["loss"] or not d["loss"][-1] < d["loss"][0]:
            raise AssertionError("phase 7f %s: loss %s, one process %s"
                                 % (what, d["loss"], want["loss"]))
        if d["launches"] != {e: n * steps for e, n in per_step.items()
                             if n}:
            raise AssertionError("phase 7f %s: launches %r, want %r a "
                                 "step" % (what, d["launches"], per_step))
        launches.update(d["launches"])
    d = res[0]
    one = REPORT["sp_ms"]
    _line7f(t0, "sp", "SequenceParallelTrainer, LM (%d layers, E=%d, %d "
            "heads, vocab %d, impl=%s) f32, global B=%d T=%d over {dp: 1, "
            "sp: 4} with %d ranks in each of 2 processes (%s), SGD lr %g "
            "momentum 0.9, %d steps on one batch: parameters and momentum "
            "in both processes bitwise equal to phase 7's one process over "
            "[%s] * 4, the losses its losses %s; launches a step in each "
            "process %s; ms a step %s across the processes (steps 2-%d) "
            "against %s in one process (phase 7's median, or steps 2-3 "
            "here when it did not run); the exchanges "
            "(hops, deals, the gradient's and the loss's sums) %.3f ms, "
            "%.2f MB sent and %.1f calls a step a process; %s; %s" % (
                cfg["layers"], cfg["embed"], cfg["heads"], cfg["vocab"],
                cfg["impls"][0], cfg["b"], cfg["t"], ranks, MP_NOTE,
                W.LM_LR, W.LM_STEPS, dev,
                ["%.5f" % v for v in d["loss"]], json.dumps(
                    {e: n for e, n in per_step.items() if n}),
                ["%.3f" % v for v in d["ms"][1:]], W.LM_STEPS,
                "%.3f" % one, d["cross_ms"], d["cross_bytes"] / 1e6,
                d["cross_calls"],
                "; ".join(t for t in timing if t.startswith("TIMING sp")),
                card_line()))
    return dict(launches)


def _mp_resnet(W, par, dev, t0, out):
    """7f.2: ResNet-50 f32 224x224 at global B=64 over {dp: 2} across the
    two processes, 2 steps, cuDNN deterministic and TF32 off, BatchNorm
    over the global batch: parameters, moving averages and optimizer
    state bitwise the one-process [dev] * 2 run's."""
    import mxnet_tpu_torch as mx
    cfg = W.BN_SIZES[MP_SIZE]
    sym = W.bn_symbol(mx, cfg)
    args, aux, batches = W.bn_problem(sym, cfg)
    shapes = {k: v.shape for k, v in batches[0].items()}
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def make():
        tr = par.ParallelTrainer(
            sym, shapes, optimizer="sgd",
            mesh=par.build_mesh({"dp": 2}, [dev] * 2),
            optimizer_params={"learning_rate": W.BN_LR, "momentum": 0.9},
            clip_grad_norm=cfg["clip"])
        tr.init_params(args, aux)
        return tr

    try:
        want, one_ms, _ = _mp_oracle(W, dev, "resnet", make, batches)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    res = [json.load(open(os.path.join(out, "bn_global-1-%d.json" % r)))
           for r in range(2)]
    for r, d in enumerate(res):
        _same_digests("resnet rank %d" % r, d["digests"], want)
        if d["programs"] != 2 or d["captured"] != (dev.type == "cuda"):
            raise AssertionError("phase 7f resnet: %d programs, %d "
                                 "captured (the walk holds BatchNorm's "
                                 "collectives: the update alone)" % (
                                     d["programs"], d["captured"]))
    d = res[0]
    _line7f(t0, "resnet", "%s f32 %dx%d %d classes, global B=%d "
            "over {dp: 2} across 2 processes (%s), cuDNN deterministic, "
            "TF32 off, SGD lr %g momentum 0.9, %d steps: parameters, "
            "moving averages and momentum bitwise equal on both ranks and "
            "to one process over [%s] * 2; ms a step %.3f against %.3f in "
            "one process (the second step); the collectives %.3f ms and "
            "%.1f MB a step in %d calls (BatchNorm's sums in the walk, "
            "uncaptured, and the gradient sum); %d programs a step, %d "
            "captured; %s" % (
                "ResNet-50" if cfg["hw"] == W.RESNET_HW else "a conv net",
                cfg["hw"], cfg["hw"], cfg["classes"],
                cfg["b"], MP_NOTE, W.BN_LR, W.BN_STEPS, dev, d["ms"][-1],
                one_ms[-1], d["cross_ms"], d["cross_bytes"] / 1e6,
                d["cross_calls"], d["programs"], d["captured"],
                card_line()))


def _mp_ckpt(W, par, dev, t0, out):
    """7f.3: the checkpoint of 7f.1's fsdp LM written by both processes
    (synchronous; ``dist_worker.CKPT_KINDS``; restored in both processes
    by the workers) restored here in one process over [dev] * 2: its
    state bitwise the saved one, which is 7f.1's (so the one-process
    run's)."""
    cfg = W.LM_SIZES[MP_SIZE]
    res = [json.load(open(os.path.join(out, "ckpt-%d.json" % r)))
           for r in range(2)]
    _same_digests("ckpt ranks", res[1]["digests"], res[0]["digests"])
    _same_digests("ckpt is 7f.1's fsdp state", res[0]["digests"], json.load(
        open(os.path.join(out, "lm_dp-fsdp-0.json")))["digests"])
    secs = []
    tr = W.lm_trainer(par, cfg, par.build_mesh({"dp": 2}, [dev] * 2),
                      fsdp=True)
    kinds = W.CKPT_KINDS[MP_SIZE]
    for how in kinds:
        prefix = os.path.join(out, "ckpt-" + how)
        with open(prefix + "-manifest.json") as f:
            nprocs = json.load(f)["nprocs"]
        if nprocs != 2:
            raise AssertionError("phase 7f ckpt %s: nprocs %s"
                                 % (how, nprocs))
        t1 = time.perf_counter()
        tr.restore_sharded_checkpoint(prefix)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        _same_digests("ckpt %s restored in one process" % how,
                      W.digests(W.trainer_state(tr)), res[0]["digests"])
    del tr
    free_programs()
    d = res[0]
    _line7f(t0, "ckpt", "the fsdp LM of 7f.1 after its %d steps, "
            "save_sharded_checkpoint from both processes (%s): %s; each "
            "restored bitwise in both processes and here in one process "
            "over [%s] * 2 (restore_sharded_checkpoint %s); %s" % (
                d["step"], ", ".join(kinds), "; ".join(
                    "%s %.2f s (to finalize), %.1f MB a process's file"
                    % (how, d["save_s"][how], d["bytes"][how] / 1e6)
                    for how in kinds), dev,
                ", ".join("%.2f s" % v for v in secs), card_line()))


_WALL = []
# the sources main() builds on a thread while the serving phases run
LATE_SOURCES = ("flash_attention", "striped_pair_attention", "fused_linear",
                "matmul_stats")


def wall(what):
    """Log the wall seconds since the previous call (each phase's share
    of the run; the first call starts the clock)."""
    now = time.perf_counter()
    if _WALL:
        log("wall: %s %.1f s" % (what, now - _WALL[-1]))
    _WALL.append(now)


def ptxas_summary(K, name, rows=None):
    """The build log of source ``name`` (or its ``K.ptxas_report`` rows)
    in a few lines: its compiled functions, their largest register count,
    and each function that spills, with its registers and spilled
    bytes."""
    rows = rows or K.ptxas_report(K.build_log(name))
    regs = [r["registers"] for r in rows if r["registers"] is not None]
    spills = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    return "  ptxas %s: %d functions, registers max %d, %d spill%s" % (
        name, len(regs), max(regs), len(spills), "".join(
            "\n    spills: %s: %s registers, %d bytes stored, %d loaded"
            % (r["name"], r["registers"], r["spill_stores"],
               r["spill_loads"]) for r in spills))


def ptxas_lines(K, name, keys):
    """One line per function of source ``name`` whose demangled name holds
    one of ``keys``: its registers and spilled bytes."""
    rows = [r for r in K.ptxas_report(K.build_log(name))
            if any(k in r["name"] for k in keys)]
    return "\n".join("  ptxas %s: %s registers, %d bytes spill stores, %d "
                     "spill loads" % (r["name"], r["registers"],
                                      r["spill_stores"], r["spill_loads"])
                     for r in rows)


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device — this script runs on the card")
        return 2
    sys.path.insert(0, HERE)
    from mxnet_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log("card: %s | nvidia-smi: %s | torch %s cuda %s" % (
        name, card, torch.__version__, torch.version.cuda))

    t_start = t0 = time.perf_counter()
    wall("start")
    # the training kernels' sources (a minute or two of nvcc) build on a
    # thread while the serving kernels are checked and phases 4-4g run,
    # which launch none of them; their checks come after
    late, late_err = {}, []

    def build_late():
        try:
            late.update(K.build(LATE_SOURCES))
        except BaseException as e:  # raised after the join
            late_err.append(e)

    nvcc = threading.Thread(target=build_late, name="nvcc")
    nvcc.start()
    secs = K.build(tuple(k for k in K.KERNELS if k not in LATE_SOURCES))
    log("build of the serving kernels: %.1f s wall (%s)" % (
        time.perf_counter() - t0, ", ".join(
            "%s %.1f s" % kv for kv in secs.items())))
    # the paged chunk's instantiations, bf16 and int8 cache; the int8
    # ones must not spill
    log(ptxas_lines(K, "paged_attention", ["fwd_mma"]))
    spilled = [r["name"] for r in K.ptxas_report(
        K.build_log("paged_attention"))
        if "fwd_mma" in r["name"] and "signed char" in r["name"]
        and (r["spill_stores"] or r["spill_loads"])]
    if spilled:
        raise AssertionError("the int8 paged chunk spills: %s" % spilled)

    gen = torch.Generator().manual_seed(0)
    worst = {"quant_matmul": check_quant_matmul(K, dev, gen),
             "fused_decode_attention": check_fused_decode_attention(
                 K, dev, gen)}
    worst["quant_matmul"] = max(worst["quant_matmul"],
                                check_quant_matmul_moe(K, dev, gen))
    worst.update(check_paged_attention(K, dev, gen))
    check_paged_invariance(K, dev, gen)
    wall("phase 3 (the serving kernels)")
    launches, prefix, work, streams = serve_main_path(K, dev)
    free_programs()
    launches["paged_attention_decode"] = serve_default_path(
        K, dev, prefix, work)["paged_attention_decode"]
    free_programs()
    serve_int8_kv_path(K, dev, prefix, work)
    free_programs()
    wall("phase 4")
    for e, n in reuse_main_path(K, dev, prefix).items():
        launches[e] += n
    free_programs()
    wall("phase 4b")
    for e, n in robust_main_path(K, dev, prefix, work, streams).items():
        launches[e] += n
    free_programs()
    wall("phase 4c")
    for e, n in fleet_main_path(K, dev, prefix, work, streams).items():
        launches[e] += n
    free_programs()
    wall("phase 4d")
    for e, n in tp_main_path(K, dev, prefix, work).items():
        launches[e] += n
    free_programs()
    wall("phase 4e")
    for e, n in dense_main_path(K, dev, prefix, work).items():
        launches[e] += n
    free_programs()
    wall("phase 4f")
    check_small_against_host(dev)
    moe = moe_main_path(K, dev, work)
    for e, n in moe.items():
        launches[e] += n
    free_programs()
    wall("phase 4g")
    nvcc.join()
    if late_err:
        raise late_err[0]
    secs.update(late)
    log("build: the training kernels ready %.1f s after the start (%s)" % (
        time.perf_counter() - t0, ", ".join(
            "%s %.1f s" % (k, late[k]) for k in LATE_SOURCES)))
    for kname in K.KERNELS:
        log(ptxas_summary(K, kname))
    worst.update(check_flash_attention(K, dev, gen))
    check_flash_repeat(K, dev)
    worst["fused_linear"] = check_fused_linear(K, dev, gen)
    dgen = torch.Generator(device=dev).manual_seed(1)
    worst["matmul_stats"] = check_matmul_stats(K, dev, gen, dgen)
    worst["fused_conv_bn_act"] = check_fused_conv_bn_act(K, dev, gen, dgen)
    worst.update(check_striped_pair(K, dev, gen))
    check_mha_gqa(dev)
    timed = time_kernels(K, dev, gen, worst)
    timed.update(time_train_kernels(K, dev, gen, worst))
    timed.update(time_cnn_kernels(K, dev, dgen, worst))
    timed.update(time_striped_pair(K, dev, gen, worst))
    time_classic_kernels(K, dev, gen, timed)
    time_zoo_kernels(K, dev, dgen, timed)
    wall("phase 3 (the training kernels and every timing)")
    launches.update({e: n for e, n in train_main_path(K, dev).items()
                     if e in TRAIN_ENTRIES})
    free_programs()
    check_train_against_host(dev)
    free_programs()
    wall("phase 5")
    for e, n in moe_train_path(K, dev).items():
        launches[e] += n
        moe[e] = moe.get(e, 0) + n
    free_programs()
    wall("phase 5b")
    fit = fit_main_path(K, dev)
    free_programs()
    wall("phase 5c")
    par = parallel_main_path(K, dev)
    for e, n in par.items():
        launches[e] += n
    free_programs()
    wall("phase 5d")
    launches.update(train_resnet(K, dev))
    free_programs()
    launches.update(eval_resnet(K, dev))
    check_resnet_against_host(dev)
    free_programs()
    wall("phase 6")
    check_ring_on_card(dev)
    launches.update({e: n for e, n in sp_main_path(K, dev).items()
                     if e in SP_ENTRIES})
    check_sp_against_flash(dev)
    check_sp_resume(dev)
    free_programs()
    wall("phase 7")
    classic = classic_main_path(K, dev, prefix, work, streams)
    for e, n in classic.items():
        launches[e] += n
    free_programs()
    wall("phase 7b")
    zoo = zoo_main_path(K, dev)
    for e, n in zoo.items():
        launches[e] += n
    free_programs()
    wall("phase 7c")
    io = io_main_path(K, dev)
    for e, n in io.items():
        launches[e] += n
    free_programs()
    wall("phase 7d")
    peri, rtc_launches, rtc_timed = periphery_main_path(K, dev, prefix)
    for e, n in peri.items():
        launches[e] += n
    free_programs()
    wall("phase 7e")
    mp = multiproc_main_path(K, dev)
    for e, n in mp.items():
        launches[e] += n
    wall("phase 7f")
    replaces = {
        "paged_attention": 1115, "paged_attention_chunk": 1115,
        "paged_attention_decode": 1115,
        "quant_matmul": 1259,
        "fused_decode_attention": 1389,
        "flash_attention_fwd": 107,     # _attn_fwd_kernel
        "flash_attention_dq": 200,      # _attn_dq_kernel
        "flash_attention_dkv": 241,     # _attn_dkv_kernel
        "striped_pair_fwd": 445,        # _spair_fwd_kernel
        "striped_pair_dq": 491,         # _spair_dq_kernel
        "striped_pair_dkv": 528,        # _spair_dkv_kernel
        "fused_linear": 725,            # _gemm_epi_kernel
        "fused_conv_bn_act": 838,
        "matmul_stats": 876}            # _gemm_stats_kernel
    # the scalar paged entry takes what no path runs (an f32 q or cache
    # at C >= 16, an int8 cache under an f32 q): its row is off the paths
    missing = [e for e in K.SOURCE if not launches[e]
               and e not in OFF_PATH]
    if missing:
        raise AssertionError("the main paths never launched %s" % missing)
    line = {"kernels": [dict(
        name=e, route="cuda",
        source="mxnet_tpu_torch/ops/csrc/%s.cu" % K.SOURCE[e],
        replaces="mxnet_tpu/ops/pallas_kernels.py:%d" % replaces[e],
        launches=launches[e], max_abs_err=timed[e]["max_abs_err"],
        ms=timed[e]["ms"], plain_ms=timed[e]["plain_ms"],
        bound_ms=timed[e]["bound_ms"], bound_by=timed[e]["bound_by"],
        library_ms=timed[e]["library_ms"], shape=timed[e]["shape"],
        moe_launches=moe.get(e, 0), fit_launches=fit.get(e, 0),
        classic_launches=classic.get(e, 0), zoo_launches=zoo.get(e, 0),
        io_launches=io.get(e, 0), periphery_launches=peri.get(e, 0),
        multiproc_launches=mp.get(e, 0),
        **{"5d_launches": par.get(e, 0)},
        **{k: timed[e][k] for k in ("stage2", "stage3", "stage4", "stem",
                                    "proj", "bf16", "f32", "scalar_ms",
                                    "int8", "c4", "c5", "m160", "moe",
                                    "lm_f32", "f32_b8", "v3_1x7",
                                    "bn_3x3s2", "bn_widest",
                                    "resnet_fit_f32", "vgg_fc6")
           if k in timed[e]})
        for e in K.SOURCE]}
    # phase 7e's runtime user kernel (NVRTC), the port's rtc.Rtc
    line["kernels"].append(dict(
        name="rtc_saxpy", route="cuda", source="mxnet_tpu_torch/rtc.py",
        replaces="mxnet_tpu/rtc.py:80", launches=rtc_launches,
        periphery_launches=rtc_launches, **rtc_timed["rtc_saxpy"]))
    log("chip_smoke: every phase passed in %.1f s"
        % (time.perf_counter() - t_start))
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase7f_alone(checks):
    """``python3 chip_smoke.py --7f CHECKS``: phase 7f's checks alone
    (``CHECKS`` a comma list of ``MP_CHECKS``; ``ckpt`` reads ``lm_dp``'s
    state), after building every kernel source; it prints the 7f lines
    and the card's line, no kernels line and no result line."""
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device — this script runs on the card")
        return 2
    sys.path.insert(0, HERE)
    from mxnet_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.build()
    multiproc_main_path(K, torch.device("cuda", 0), checks)
    log(card_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--7f"]:
        sys.exit(phase7f_alone(sys.argv[2] if len(sys.argv) > 2
                               else MP_CHECKS))
    sys.exit(main())
