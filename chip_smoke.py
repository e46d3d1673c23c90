#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`attention_tpu_torch`) on one
NVIDIA card.  Run it from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``, and imports
nothing of JAX.  Every phase raises on a failure, so the script exits
non-zero unless all of them pass:

1. build    all nine CUDA kernels from ``attention_tpu_torch/csrc`` (one
            ``nvcc`` a translation unit, as many at once as there are
            cores; three kernels have their max_mode variants' instances
            in units of their own, the int8/int4 decode kernel its int4
            instances); print the card's name and power limit.
2. kernels  each kernel against its plain PyTorch version on the card,
            under the limits of `reference.mismatch`: flash in f32 with
            dk != dv and ragged edges, in bf16 causal GQA with softcap,
            at the op path's shape, at the served model's causal forward
            (32 q / 4 kv heads, sequence 4096, without and with softcap
            50) and as a cached prefill (512 rows into a 1152-row cache,
            ``kv_valid``, with softcap 50 and without, where SDPA's time
            is like for like), each flash line with the kernel body
            (bf16 must run "wgmma") and its key split; ragged on a
            step that the port's own scheduler packed at the serving
            geometry, with decode, prefill, pad and one poisoned slot,
            and on a decode-only step (8 one-token slots), each line
            with its launch plan (bf16 must run the "wgmma" body for
            prefill slots and the key split for decode slots), the
            decode-only call and the paged decode kernel on the same
            work timed on the card by `torch.profiler`;
            decode and paged decode at the serving geometry on 8
            sequences of lengths 0 to 4096 (one token, with softcap, with
            a 512-row and a 100-row window and 4 sinks, the band crossing
            split boundaries, chunks of 4 and of 256, the paged partials,
            an empty and a poisoned sequence), and at `generate`'s own
            geometry (8 sequences of 513 to 544 rows in a 544-row cache),
            in f32 and bf16, each case line with the key split and grid
            of its launch (the serving decode must be split over more
            than 132 CTAs; its bf16 call and SDPA's, and the paged
            softcap call, also timed on the card alone by
            `torch.profiler`, since their calls are host-bound); the
            quantized decode kernels on the bf16 decode
            case's caches quantized three ways (int8 one token, with
            softcap, with the window and sinks, a chunk of 4; feature-dim
            and token-paired int4), each also within the JAX package's
            budget of the bf16 decode kernel's output, after the two int4
            entry points ran once as a user calls them.  Each kernel must
            give the same bits on a second call, and the plain output with
            a planted fault (its last key tile dropped, or its scale 2%
            off; for the decode kernels also one middle split of the
            longest sequence's keys dropped; for causal flash also the
            diagonal tile of the middle row block, the tile the kernel's
            mask range must test) must fail the check.  The sliding
            window: flash at 32 q / 4 kv heads over 8192 rows, causal,
            bf16, at window 4096 with 4 sinks, at window 1024 and without
            a window, each without and with softcap 50, on the "wgmma"
            body, its visited tiles equal to the tiles that hold a kept
            key, timed beside SDPA with the band as a boolean mask (the
            windowed calls' card time must fall: 4096 at or below the
            call without a window, 1024 under half of it); an f32 call on
            the "fma" body (dk != dv, window 100, 5 sinks); the
            ragged kernel with window 256 and 4 sinks on the scheduler's
            packed step and the decode-only step.  A band one key tile
            longer and a dropped sink tile must fail.  Packed sequences
            (segment ids): flash at 32 q / 4 kv heads over 8192 rows
            packed from documents of 3072, 1187, 96, 1, 2048, 517 and
            1271 tokens, causal, bf16, the same ids under window 1024,
            interleaved ids (row i in segment i % 3), each on "wgmma"
            against the plain version, the same bits twice, the kernel
            with the key ids shifted by one key failing the check, timed
            beside the call without ids, SDPA under the mask and the
            bound of the kept pairs (25.2% of the causal ones); all-equal
            ids give the bits of no ids; an f32 call on "fma" with m != n
            and rows whose id no key holds.  The build prints registers
            and spills of every segment-id instance, and of every kernel's
            instances by max_mode variant (an instance of a kernel over the
            variant steps that spills, online or not, fails), and each
            translation unit's CPU seconds.
2a. max_modes  the rescaling-math variants (`phase_max_modes`): flash at
            32 q / 4 kv heads over 8192 rows, causal, bf16, without and
            with softcap 50, under "online", "bound", "flashd" and "amla",
            normalized and as partials (each variant's stats by its
            contract), each held against its plain version with planted
            faults, "bound" under torch.cuda.set_sync_debug_mode("error")
            and its guard's verdicts printed; an f32 call on the "fma"
            body under each; a planted outlier key (norm 4000) whose guard
            demotes the call to the online body's bits; decode at the
            serving width (8 sequences to 2048 rows) and the ragged mixed
            step under "flashd" and "amla"; each variant's device ms
            beside online's in the same call; the bound-against-online
            crossover at 512 to 8192 rows.  Phase 7 counts the forward's
            launches by variant (the layer runs "bound") and the guard's
            demotions, and runs the fused steps again under "online" from
            the same start: step 1's loss, and both runs' step ms.
2b. backward the training forward's partials and the three backward
            kernels (fused, dQ, dK/dV) at the serving geometry as a
            training call (b = 1, 32 q / 4 kv heads, m = n = 4096, d 128,
            causal, bf16), with and without softcap 50, at phase 7's
            layer call (b = 4, m = n = 2048, softcap 50, strided operands
            as the attention layer passes them), at head dim 64 (b = 2,
            16 q / 2 kv heads, 2048 rows) and on the edges (m = 1000, n =
            1003, kv_valid 900, keys shifted 37 rows past the queries, so
            that the first rows see no key; with and without softcap 50),
            against `flash_backward_plain` under
            `reference.grad_mismatch`; each case prints the fused
            kernel's body and `bwd_work_plan` and the pair's body and
            plan (bf16 must run "wgmma" on both paths); the same bits on
            a second call (the fused dQ, whose tiles add in no fixed
            order, within the limit of the first); a dropped key tile in
            dK and a 2% scale error in dQ must fail; each kernel timed
            alone and `flash_backward` end to end on each path at the
            serving geometry, with SDPA's backward as the yardstick (for
            the pair: the sum of its two kernels' device ms).  The band:
            the three kernels at 32 q / 4 kv heads over 8192 rows, causal,
            bf16, at window 4096 with 4 sinks, at 1024, without a window
            and at 1024 with softcap 50, held against the plain backward
            over the band and sinks (the kernels take the band, the sink
            patch the sinks), each printing its body ("wgmma") and work
            plan, the same bits twice (the fused dQ within the limit); the
            kernels run with a band one key tile longer, and without the
            sink patch, must fail; each kernel's device ms beside its bound
            (the band's pairs) and SDPA's backward with the band as a
            boolean mask, and the band must shrink each kernel's card time
            (window 4096 at or under the causal call's, 1024 under half);
            an f32 case on the FMA bodies (dk != dv, window 100, 5 sinks)
            and the edges (m 1000, n 1003, kv_valid 900, window 200, 3
            sinks, q_offset 37).  Packed sequences: the three kernels at
            phase 2's packed case against the plain backward, "wgmma" on
            both paths, the same bits twice (the fused dQ within the
            limit), the kernels with shifted key ids failing, all-equal
            ids giving the bits of no ids, each kernel timed beside the
            call without ids (SDPA's backward under the mask beside the
            fused one); a packed `flash_attention_diff` forward and
            backward on each path, its launches exact; f32 on "fma" with
            m != n and rows that see no key (dQ 0).
3. op path  the ``scale4`` testcase (m = n = 8192, dk = dv = 128) from
            the port's generator, through ``cli run --backend flash`` in
            f32 and bf16: both must print ``Correct!``; then the flash
            kernel timed on its inputs (bf16 takes the key split) and at
            the served model's causal forward without and with softcap
            50 (softcap's own cost), each with its device time by
            `torch.profiler` beside the CUDA-event time.
3b. distributed a gloo world of 4 ranks on the one card (NCCL takes one
            rank per card), spawned with `torch.multiprocessing.spawn`; a
            failed rank fails the phase.  Rank 0 prints the world, the
            card's name and power limit and each collective's route (the
            device tensor to gloo, or a host copy).  (1) ``scale4`` through
            ``cli run`` for kv-sharded, q-sharded, auto and ring in f32 and
            bf16: ``Correct!`` on rank 0.  (2) The served model's causal
            forward (32 q / 4 kv heads, 4096 rows, d 128, bf16, without and
            with softcap 50) on kv-sharded, ring (contiguous and zigzag) and
            ulysses, each against one `flash_attention` call under
            `reference.mismatch`, the same bits on every rank; the same
            on 3-D views with window 4096 and 4 sinks, window 1024 and 4
            sinks, and packed ids (the phase 2 documents halved).  (3) Each
            rank's partials against `flash_attention_partials_plain`: the
            shards of n = 5 (the last all padding, ``kv_valid`` 0: row max
            -inf, sum 0), of ``scale4`` and of n = 8195 (the thin grid's key
            split, the last shard partly padding), every contiguous and
            zigzag ring step (the steps whose keys lie in the queries'
            future must see nothing).  (4) Flash launches per call on every
            rank: 1 kv-sharded, q-sharded, auto and ulysses, 4 ring, 12
            zigzag.  (5) Rank 0's CUDA-event ms between barriers of each
            backend beside the flash call alone, and the collectives' host
            ms in one more call: four processes share the card, so these are
            not scaling numbers.
3c. cp training a gloo world of 4 ranks on the one card, spawned as 3b is; a
            failed rank fails the phase; rank 0 prints the card's name and
            power limit.  (1) The differentiable paths on whole tensors
            (`cp_flash_attention`, `ring_attention_diff` contiguous and
            zigzag, `ulysses_attention`) at 32 q / 4 kv heads, 8192 rows,
            d 128, causal, bf16, with a fixed random dout, each under its
            default max_mode ("bound", resolved by each call's size):
            output, dq, dk, dv against one single-device
            `flash_attention_diff` call under the variant the path's calls
            ran (`mismatch`, `grad_mismatch`) and against a float64
            recompute of the first kv head's group (each path's largest
            error at most `CP_F64_SLACK` times the single call's), the
            same bits on every rank, launches exact (1, R, 3R, 1 forward
            and backward calls), the root mean square error against the
            witness at most `CP_F64_SLACK` times the single call's.  The
            ring's calls bound a row by their own shard's keys, which no
            single call reproduces: its elements and largest witness error
            are printed, and the ring and the zigzag run again with every
            call bounded by the whole sequence's key norms
            (`cp_same_bound`), held on every element and the witness;
            the causal case on the dQ + dK/dV pair too; 3-D views with
            window 4096 + 4 sinks on every path, window 1024 + 4 sinks on
            both ring schedules, phase 2's packed ids on the ring and the
            all-gather; the ring's backward calls where a shard sees
            nothing (n = 8195: the last shard partly padding, shards above
            the diagonal; a shard all padding): dK, dV zero past the keys
            any query sees, dQ zero where nothing is seen, no NaN.  (2) The
            serving widths at depth 2 (four replicas of float32 masters and
            moments share the card) on one sequence of 8193 tokens, 2 steps
            of `make_train_step` on the flat sp mesh for every `cp_impl`,
            ring and zigzag also under `TRAIN_BAND`, then the ring on
            `make_mesh_3d` (dp 2 x sp 2, 2 x 8193 tokens): step 1's loss
            within `CP_LOSS_RTOL` of the single-device loss, the norm of
            every parameter's step-1 gradient (summed over the ranks) within
            `CP_GRAD_NORM_RTOL` of the single device's and step 2's loss
            (after step 1's update) within `CP_STEP2_RTOL` of its, the
            losses and every parameter's bits the same on every rank after
            each step,
            launches exact; step ms, the collectives' share of the second
            step (`Mesh.timings`), each rank's peak memory.  (3) Phase 6's
            small f32 model (the FMA bodies) under each `cp_impl` against
            its single-device step on the card: loss 1e-5 relative,
            gradients 3e-5.
3d. mesh training the trainer's parameter layouts (JAX's `shard_params`
            table, Megatron's tp split, FSDP, experts over tp or over the
            tokens' axis, pipeline stages) on a gloo world of 4 ranks on
            the one card, after each model's single-device run on the card
            alone.  At the serving widths, `CP_TRAIN_STEPS` steps each: the
            dense model (depth 2) on (dp, sp, tp) = (1, 1, 4) and on (2, 1,
            2) with FSDP (4 x 2049 tokens), on (1, 2, 2) with the ring over
            sp (1 x 8193), the MoE model (`SERVE_MOE`, depth 1) on (2, 1,
            2) with FSDP, and on (4, 1, 1) with its experts over "dp"
            (``moe_dp4_ep``: all-to-alls move the tokens to the rank that
            holds their expert; each rank's expert state a quarter of the
            whole, or the phase fails):
            step 1's loss within `CP_LOSS_RTOL` of the single device's,
            step 2's within `CP_STEP2_RTOL` (the MoE run's within
            `MESH_MOE_STEP2_RTOL`: top-k routing turns any reordering of
            the forward into other choices for tokens whose top two
            nearly tie; the single device's own ``impl="xla"`` run's
            distance is printed beside it), every parameter's whole
            step-1 gradient norm within `CP_GRAD_NORM_RTOL`, the losses
            the same on every rank, each parameter block the same bits on
            every rank that holds it, the flash forward and the fused
            backward exactly once a layer a step on each rank (twice under
            the ring); step ms beside the single device's, the
            collectives' share of the second step, each rank's peak and
            float32 state bytes (masters and moments) beside the single
            device's (about 1 / (dp·tp) under FSDP, or the phase fails).
            The pipelined run (``pp4``): the dense model at `PP_DEPTH` on
            ("pp",) of 4 ranks, one block a stage, 4 x 2049 tokens in
            `PP_MICRO` microbatches, from `init_pipelined_train` through
            `make_pipelined_train_step`, held to `make_train_step` on one
            device by the same bars (each block's gradient norm from the
            rank whose stage holds it), the embedding, norm and head the
            same bits on every rank after each step, the flash forward
            and the fused backward once a microbatch a step on each rank;
            step ms, the point-to-point and collective share, each rank's
            peak and float32 state beside the single device's.
            Then `train_with_recovery(model, mesh, ..., fsdp=True)` of the
            small bf16 model on (2, 1, 2) on the dQ + dK/dV pair: run to
            `RECOVERY_STEPS`; again, every rank dying after
            `RECOVERY_CRASH` steps (exit 17, the world's every rank); a
            second world resumes from the checkpoint, its losses and
            whole masters the uninterrupted run's bits, launches exact.
4. generate `TinyDecoder` at the BASELINE.md config-5 attention geometry
            (32 q / 4 kv heads, head_dim 128, dim 4096), depth 4, vocab
            32000, rope, softcap 50, bf16, random weights from a seed:
            greedy `generate` on 8 prompts of 512 tokens, then
            `generate_ragged` and `generate_paged` on the serving trace's
            8 prompts (128-1024 tokens), and `generate(int8_cache=True)`
            on the equal prompts, 32 steps each; every logit finite, the
            flash kernel for each prefill and the decode (paged, int8)
            kernel for each step, nothing else; then one 4-token
            chunk-verify call on int8 caches, the int8 kernel once per
            layer.  Then the same weights as a windowed model (window
            256, 4 sinks): `generate(rolling_cache=True)` and the full-
            cache `generate` on the 512-token prompts (the first tokens
            equal, the equal share printed), `generate_paged` and
            `generate(int8_cache=True)`, the same launch checks.
5. serving  the same model serving 8 greedy requests (the same prompts,
            32 output tokens each) through `ServingEngine` in
            ``step_mode="ragged"`` (the ragged kernel) and then
            ``"two_call"`` (the paged kernel); the windowed model in
            ``"two_call"`` and, without its sinks, in ``"ragged"``; then
            the ragged run once more under `torch.profiler` for device
            time by kernel.
5e. durability the same model and serving trace at `SERVE_ENGINE`,
            ``async_steps=True``: greedy sync, async, async, sync runs
            (streams equal token for token, launches exact, each run's
            median step ms and host overhead printed), then sampled at
            temperature 0.8 sync and async (equal) and in two-call mode
            (the share equal printed).  A `SnapshotManager` (every 16,
            keep 2) on the async engine: the snapshot cut at step 16
            (inside decode) restored into a fresh engine, the state
            fingerprints equal, its drained streams equal to the
            uninterrupted run's bit for bit; snapshot bytes, `save_s`,
            `restore_s`.  The managed engine runs 5 steps past the cut
            and dies (its journal closed, nothing detached):
            `recover_engine` (warm) and `resume_request` of every live
            request with its streamed tokens into a fresh engine (cold)
            each drain, every request finishing with its 32 tokens, every
            logit finite, free pages plus prefix-held pages equal to the
            pool; `recover_s`, `journal_events`, each request's seconds to
            its next token on both paths, and each path's share of tokens
            equal to the uninterrupted run (the journal's tail is
            recomputed by chunked prefill, another bf16 order).
5f. tp serving a gloo world of 4 ranks on the one card, spawned as 3b
            is, after the single-device side has run on the card alone; a
            failed rank fails the phase.  Each rank holds the whole
            weights and one of the serving model's 4 kv heads (8 q heads)
            of every cache and pool.  (a) Each public function of
            `parallel.serving` at the serving geometry (bf16): the cache-
            sharded decode of 8 sequences over 4096 rows (all valid, and
            3000), the head-sharded decode, int8 decode and paged decode
            at `DECODE_LENS`, the ragged step (append and attention) of 8
            decode slots at those lengths and a 256-token prefill slot,
            and the prefill of 2048 rows: held against the kernel's plain
            version (`mismatch`), beside the single-device call on the
            same inputs (max abs difference, same bits or not printed),
            the kernel launched once a call, the same result on every
            rank.  (b) `TinyDecoder(tp_axis="tp")` at the serving widths
            (depth 4): greedy `generate` on 8 prompts of 512 tokens,
            `generate_paged` on the trace's prompts, `generate(
            int8_cache=True)`, the `SERVE_BAND` model's rolling cache,
            `generate_beam` (3 beams), 16 steps each, and speculative
            decoding (32 steps, gamma 4, the depth-1 seed-1 draft tp
            too): launches exact, the first-step logits within
            `mismatch`'s bf16 limit of the single device's, the share of
            tokens equal to the single device's printed, every rank's
            tokens equal to rank 0's.  (c) `ServingEngine(mesh_shards=
            4)` at `SERVE_ENGINE` on the serving trace, ragged and two-
            call, greedy and sampled: launches exact, every request
            finished, every rank's streams equal to rank 0's, each run's
            median step ms beside the single engine's (the same call);
            one more greedy run with the mesh's collectives timed (the
            card synchronised around each): the all-gather's share of
            the run, each rank's pool bytes and peak memory.  (d) A mesh
            snapshot cut at step 16 (inside decode): `save` (every rank;
            ``pools.0..3``), `restore` on the world, the fingerprints
            equal, the restored and the live engine drained to the
            uninterrupted mesh run's streams; a byte flipped in
            ``pools.2`` is a `SnapshotCorruptError` naming it.  (e) The
            small f32 model (2 kv heads: blocks of 2 ranks) through (b)
            and (c): tokens and streams exactly equal to the single
            device's.
5b. moe     the same model with 8 experts, top 2, capacity factor 1.25
            (Mixtral 8x7B's routing on the repo's 4·d tanh-GELU experts),
            depth 4: greedy `generate` on the 8 prompts of 512 tokens and
            the serving trace in both step modes, with phase 4's and 5's
            launch checks (ragged launches exactly steps x depth), every
            request finished with its 32 tokens, every logit finite; the
            ragged run under `torch.profiler`, the experts' products a
            class of their own.
5c. decoding the phase 4 model's other ways to tokens.  Beam search
            (`generate_beam`, 4 beams over phase 4's 8 prompts of 512
            tokens, 32 steps, bf16 and int8 caches): launches exact,
            scores finite and within `BEAM_SCORE_TOL` of a teacher-forced
            re-score through the flash forward (a search whose gather is
            skipped must fail it), beams = 1 equal to greedy `generate`,
            the gather's device ms.  Parallel sampling over forked pages
            (one prompt of 1000 tokens forked 8 ways by `paged_fork`, 32
            sampled steps through the paged kernel): refcounts and free
            pages, the shared pages bit-equal after the appends, each
            fork's first step within `mismatch` of the dense decode of
            the unforked context.  Speculative decoding (one prompt of
            512, 64 greedy steps, gamma 4, on the dense, ragged, int8 and
            paged caches; drafts: the target itself and a depth-1 model of
            seed 1): launches exact, acceptance, tokens per target
            forward, host syncs, ms per token beside `generate`'s, the
            share of tokens equal to it.
5d. seq2seq `TinySeq2Seq` at the serving widths (2 + 2 blocks, 1.2e9
            parameters) on 8 x (512 + 114) tokens: the kernels' logits
            and ``impl="xla"``'s against a float32 witness, both forwards
            timed; 5 `MasterAdamW` steps (the loss falls; launches exact;
            step ms, peak); the step's own backward calls (encoder
            non-causal 512 x 512, cross non-causal 113 x 512, decoder
            causal 113) on both paths against float64, the plain version
            setting the bar (`hold_captured_backward`); `generate_seq2seq`
            for 32 greedy steps (launches exact); each call's forward and
            backward device ms, the m = 1 cross step's flash call held
            against its plain version and timed beside the decode kernel.
6. reference a small f32 model on the card against the same model on
            the CPU (plain versions): logits, each side the same bits
            twice (the CPU's f32 settings printed first, any
            reduced-precision f32 path pinned to full f32; should two CPU
            forwards part, the first module whose output differs is
            named before the check fails); greedy engine streams in both
            step modes; greedy
            tokens of the three generate functions; teacher-forced
            int8-cache logits and greedy `generate(int8_cache=True)`
            tokens; training: loss and every gradient of one step, then
            three AdamW steps' losses, against the CPU.  The same model
            with window 24 and 4 sinks: logits, and greedy streams of
            `generate` on full and rolling caches (equal to each other
            too), `generate_ragged`, `generate_paged`,
            `generate(int8_cache=True)` and two-call serving; and its
            training against the CPU as above.  The same model with 4
            experts at capacity factor 1.25 (both sides drop pairs):
            logits, greedy streams of the engine in both step modes and
            of the three generate functions, training as above (the
            router's gradient included), the smallest top-k margin of
            the routing printed.  This slice's paths on the small model:
            beam search (beams 3, dense and int8 caches) tokens equal and
            scores within the logits' limits, speculative greedy streams
            equal to greedy `generate` on every cache type and between
            the sides, the small encoder-decoder's logits within 1e-4 and
            its `generate_seq2seq` streams equal.  The async engine on
            the small model: a crash between snapshots, then warm
            recovery: streams equal the uninterrupted run's on each side
            and card against CPU.
7. train    the phase 4 model trained on float32 masters of its bf16
            weights (float32 moments): `init_train`, 5 fused steps of
            `make_train_step` on a seeded batch of 4 x 2049 tokens (every
            loss finite, the last below the first; the flash kernel and
            the fused backward kernel once per layer per step), 2 steps
            from the same start on the dQ + dK/dV pair (losses equal to
            the fused run's); every parameter's gradient from the seeded
            start, the fused path's run again and the pair's, against
            the fused one's (relative L2 within 2^-6), a 2% scale error
            planted in the fused dK must fail;
            the forward and backward with ``remat=True`` from the seeded
            start (the same loss, gradients within 2^-6, a lower peak);
            the optimizer step's span on the card by CUDA events
            (gradient carry, AdamW, the masters' copy back); one step
            under `torch.profiler`.  Then
            checkpoint and resume at the same width: three pair steps
            straight through against two, `save_checkpoint`, a fresh
            model and optimizer restored, and the third (the same
            bits), a torn step directory passed over by `latest_step`.
            Then the same model with window 4096 and 4 sinks on one
            sequence of 8193 tokens (the same 8192 predicted tokens a
            step), the same steps, launch counts, gradient checks and
            profiled step; then the MoE model at depth 2 the same way,
            its aux loss printed apart; the attention device ms of the
            three cells side by side.
8. head dim 256 (`phase_head_dim_256`) Gemma 2 9B's head split
            (`D256_MODEL`: 16 q / 8 kv heads x 256, softcap 50, dim 4096,
            depth 4).  Every kernel at d 256 against its plain version
            (one launch a call, the same bits twice, planted faults): the
            flash forward at 16 / 8 heads over 4096 rows causal, without
            and with softcap (SDPA beside); the fused, dQ and dK/dV
            kernels plain, at window 1024 with 4 sinks, with softcap 50
            and on packed ids (`DIST_PACKED_DOCS`), each path under
            `grad_mismatch` (SDPA's backward beside the causal case), the
            FMA instances' registers, shared bytes and spills (none may
            spill); decode, paged decode, a ragged step and int8, int4 and
            token-paired int4 decode on 8 sequences of 0 to 4096 rows, and
            int8 at d 96, int4 at d 80 (`D256_ODD_QUANT`), the quantized
            ones within the JAX package's budgets of the bf16 decode
            kernel.  Then the model: greedy `generate` on bf16 and int8
            caches (8 prompts of 512, 32 steps), the serving trace in both
            step modes, the training of phase 7 (5 fused and 2 pair steps,
            the gradient checks) with each fused step's loss held against
            the same steps in PyTorch ops (``impl="xla"``), and the small
            f32 model with head dim 256 (`D256_SMALL`) on the card against
            the CPU as phase 6 holds `SMALL_MODEL` (its gradients, which
            part from the CPU's past the f32 limit on the card with or
            without the kernels, held to float64 gradients as closely as
            the card's plain attention's).  Each d = 256 case
            joins its kernel's record under ``"d256"``; the phase's and
            the smoke's seconds are printed.

Launch counts are reset just before each run of a path (op path, the
int4 entry points, each distributed backend's run on each rank, each
phase 3c path and training run on each rank, each generate function,
the chunk verify, each phase 3d run and recovery run on each rank,
each serving run, each stretch of the durability
phase's engines, each phase 5f call, run and drain on each rank, each
training run, each beam, fork,
speculative and encoder-decoder run, each packed
`flash_attention_diff` run) and read just after it (the MoE model's
generate and serving runs too); rank 0's distributed and phase 3c, 3d
and phase 5f launches join the kernels' counts.  Kernel times are CUDA-event
medians after warm-up, over back-to-back calls of the wrapper, so a call
whose host work outlasts its kernels is timed by its host work.  The second-to-last stdout line is the
``{"kernels": [...]}`` record, the last ``{"ok": true, "device":
...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

SEED = 0
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the key tile of attend_mma's loops (64 rows): the keys a planted
# dropped-tile fault removes
KEY_TILE = 64
# the decode cases' lengths: 8 sequences from empty to the full capacity
DECODE_LENS = [0, 1, 517, 1024, 2047, 3000, 4095, 4096]
SERVE_MODEL = dict(vocab=32000, dim=4096, depth=4, num_q_heads=32,
                   num_kv_heads=4, rope=True, softcap=50.0)
SERVE_ENGINE = dict(step_mode="ragged", page_size=128, num_pages=512,
                    max_seq_len=2048, max_decode_batch=8,
                    max_prefill_rows=2, prefill_chunk=256,
                    token_budget=512)
# phase 5e: the sampled serving runs' temperature; the snapshot period
# (the prefill of the trace's 4,600 prompt tokens ends near step 10, so
# step 16 lands inside decode); the steps run past it before the crash
SERVE_TEMPERATURE = 0.8
SNAPSHOT_EVERY = 16
CRASH_AFTER = 5
# the __graft_entry__.entry() model
SMALL_MODEL = dict(vocab=256, dim=256, depth=2, num_q_heads=8,
                   num_kv_heads=2, rope=True, softcap=50.0)
# the mixture-of-experts cells: Mixtral 8x7B's expert count and top-2
# routing on the serving model's width (the repo's own 4·d tanh-GELU
# experts), at the JAX package's capacity factor 1.25.  Served at depth 4
# (4.3e9 expert parameters, 8.6 GB in bf16); trained at depth 2: 2.5e9
# parameters at 16 bytes each (bf16 weight and gradient, float32 master,
# two float32 moments), float32 gradients and the update's temporaries
# come to about 55 GB, which fits 80 GB; depth 4 would need over 100
SERVE_MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_TRAIN_DEPTH = 2
# phase 6's MoE model: the small f32 model with 4 experts at capacity
# factor 1.25, so that both sides drop pairs
SMALL_MOE = dict(moe_experts=4, moe_capacity_factor=1.25)
# the checkpoint phase's model: the serving model's width at this depth
CKPT_DEPTH = 4
# the sliding-window flash cases of phase 2: the served attention geometry
# (q heads, kv heads, rows, d) at 8192 rows, causal, bf16; the published
# window of Mistral 7B v0.1 and Gemma 2 (4096) with StreamingLLM's 4 sinks,
# a 1024 window, and the same call without one
WINDOW_FLASH = (32, 4, 8192, 128)
WINDOW_BANDS = {"window4096_sinks4": (4096, 4), "window1024": (1024, None),
                "causal": (None, None)}
# the windowed backward cases of phase 2b: the same geometry and bands,
# and softcap 50 at window 1024 (case, window, sinks, softcap)
WINDOW_BWD_BANDS = (("window4096_sinks4", 4096, 4, None),
                    ("window1024", 1024, None, None),
                    ("causal", None, None, None),
                    ("window1024_softcap50", 1024, None, 50.0))
# the packed-sequence cases of phases 2 and 2b: the same geometry (3-D
# tensors, as segment ids take them), 8192 rows packed from 7 documents
# of uneven lengths (a long one, a one-token one, short ones), causal:
# 8,470,298 of the 33,558,528 causal pairs (25.2%) are kept.  Phase 3b
# packs its 4096 rows from the same documents, each about halved
PACKED_DOCS = (3072, 1187, 96, 1, 2048, 517, 1271)
DIST_PACKED_DOCS = (1536, 593, 48, 1, 1024, 258, 636)
# the windowed serving model of phases 2 and 4-6: window 256, so that the
# band and the ring wrap on the trace's 128-1024-token prompts (at 4096
# nothing would wrap below 2048 rows), with 4 sinks; the small f32 model
# of phase 6 takes window 24 with 4 sinks
SERVE_BAND = dict(window=256, attn_sinks=4)
SMALL_BAND = dict(window=24, attn_sinks=4)
# the distributed phase: a gloo world of ranks on the one card, and the
# served model's causal forward they shard (heads, kv heads, rows, d)
DIST_WORLD = 4
DIST_FORWARD = (32, 4, 4096, 128)
# flash kernel launches per call on each rank, by backend: ring zigzag
# makes 3 chunk-pair calls a step (the fourth pair is skipped when the
# schedule is built); auto takes q-sharded on scale4
DIST_LAUNCHES = {"kv-sharded": 1, "q-sharded": 1, "auto": 1,
                 "ring": DIST_WORLD, "ring_zigzag": 3 * DIST_WORLD,
                 "ulysses": 1}
# phase 3c: context-parallel training on a gloo world of ranks on the one
# card.  The ops at the served attention geometry (q heads, kv heads,
# rows, d) at 8192 rows; each path's largest error against a float64
# recompute of the first kv
# head's group may be this many times the single-device call's; the
# edge calls' rows (the last ring shard partly padding)
CP_WORLD = 4
CP_OPS = (32, 4, 8192, 128)
CP_IMPLS = ("allgather", "ring", "zigzag", "ulysses")
CP_F64_SLACK = 1.5
CP_EDGE_ROWS = 8195
# training at the serving widths: four replicas of the weights with
# float32 masters and AdamW moments share the card (about 10 GB a rank
# at depth 2; depth is the only cut); (cp_impl, TRAIN_BAND, mesh) runs
# of CP_TRAIN_STEPS steps on one sequence of 8193 tokens on the flat sp
# mesh, two on make_mesh_3d (dp 2 x sp 2); step 1's loss within
# CP_LOSS_RTOL of the single-device loss (bf16 in another order), each
# parameter's step-1 gradient norm within CP_GRAD_NORM_RTOL of the single
# device's (AdamW's first update is nearly the gradient's sign, so a
# gradient off by a factor would not show in the loss), and step 2's loss,
# which step 1's gradients and update decide, within CP_STEP2_RTOL.  Each
# bar is about 4-9x the largest error measured on the H100 (step 1
# 1.1e-5, deterministic; step 2 9.8e-5; gradient norms 4.6e-4)
CP_TRAIN_DEPTH = 2
CP_TRAIN_STEPS = 2
CP_TRAIN_BATCH = {"flat": (1, 8193), "mesh3d": (2, 8193)}
CP_RUNS = (("allgather", False, "flat"), ("ring", False, "flat"),
           ("zigzag", False, "flat"), ("ulysses", False, "flat"),
           ("ring", True, "flat"), ("zigzag", True, "flat"),
           ("ring", False, "mesh3d"))
CP_LOSS_RTOL = 1e-4
CP_GRAD_NORM_RTOL = 2e-3
CP_STEP2_RTOL = 5e-4
# phase 6's small f32 model under each cp_impl against its single-device
# step on the card: JAX's tests/test_cp.py tolerances
CP_F32_LOSS_RTOL = 1e-5
CP_F32_GRAD_ATOL = 3e-5
# phase 5f: tensor-parallel serving on a gloo world of ranks on the one
# card, each rank the whole weights and a quarter of the kv heads (one of
# the serving model's four).  (b)'s decode steps, speculative steps and
# beams; the small f32 model's 2 kv heads split over blocks of 2 ranks,
# on prompts of this many tokens; its first-step logits against the
# single device's, max abs (the f32 bar of phase 6's logits)
TP_WORLD = 4
TP_STEPS = 16
TP_SPEC_STEPS = 32
TP_BEAMS = 3
TP_SMALL_SHARDS = 2
TP_SMALL_ROWS = 128
TP_F32_LOGITS_TOL = 1e-4
# decode steps of the generate phase
GEN_STEPS = 32
# beam search: 4 beams over phase 4's 8 prompts of 512 tokens (32 cache
# rows), 32 steps; the search's score against the teacher-forced
# re-score of its tokens, max abs over the 8 sequences, in nats (see
# `phase_beam`)
BEAMS = 4
BEAM_STEPS = GEN_STEPS
BEAM_SCORE_TOL = 1.0
# parallel sampling: one prompt of 1000 tokens (7 full pages of 128 and
# a 104-row tail) forked 8 ways, 32 sampled steps
FORK_PROMPT = 1000
FORK_COPIES = 8
FORK_STEPS = 32
# speculative decoding: 64 greedy steps after a 512-token prompt, gamma 4
SPEC_STEPS = 64
SPEC_GAMMA = 4
# the encoder-decoder cell: the serving model's widths, 2 + 2 blocks
# (about 1.2e9 parameters), on 8 sequences of 512 source and 114 target
# tokens (T5's span-corruption lengths, Raffel et al. 2020); 5 AdamW
# steps; the kernels' logits may stand at most this many times further
# from a float32 witness than the plain path's (both round the same
# quantities to bf16 once; a dropped tile or a wrong mask moves logits
# by O(1))
SEQ2SEQ_MODEL = dict(vocab=32000, dim=4096, enc_depth=2, dec_depth=2,
                     num_q_heads=32, num_kv_heads=4, rope=True, softcap=50.0)
SEQ2SEQ_BATCH = (8, 512, 114)
SEQ2SEQ_STEPS = 5
SEQ2SEQ_WITNESS_RATIO = 2.0
# the training step's own backward calls against float64: each kernel
# path's relative L2 distance, per 64-row tile, at most this many times
# the plain version's in the same tile (measured within 1% of it on the
# cross-attention call: both round P and dS to bf16 at the same points;
# a 2% error in one tile reads 4-6 times it)
CAPTURED_BWD_SLACK = 1.25
# the rows of a tile of `hold_captured_backward`: the kernels' query and
# key tiles
BWD_HOLD_TILE = 64
# phase 6's encoder-decoder: the small model's widths, 2 + 2 blocks
SMALL_SEQ2SEQ = dict(vocab=256, dim=256, enc_depth=2, dec_depth=2,
                     num_q_heads=8, num_kv_heads=2, rope=True, softcap=50.0)
# card against CPU on the small f32 model with int8 caches, max abs
# logits (PERF.md section 2 gives the reasons)
INT8_LOGITS_TOL = 1e-2
# the training phase: batch (sequences, tokens), fused steps, learning rate
TRAIN_BATCH = (4, 2049)
# phase 7's windowed cell: the serving model with Mistral's and Gemma 2's
# window and StreamingLLM's sinks, trained on one sequence of 8193 tokens,
# the same 8192 predicted tokens a step as the unwindowed cell's 4 x 2049
TRAIN_BAND = dict(window=4096, attn_sinks=4)
WINDOW_TRAIN_BATCH = (1, 8193)
TRAIN_STEPS = 5
TRAIN_LR = 1e-3
# the two-kernel run's second loss against the fused run's, max abs: the
# two backward paths sum their fp32 gradients in another order, so a few
# bf16 gradients round one ulp apart and flip AdamW's first update
# (lr·sign(g)) only where g is near 0; measured about 1e-4 apart on a
# loss of about 10 (H100), so 1e-2 leaves a wide margin at 0.1% of the loss
TRAIN_LOSS_TOL = 1e-2
# full-width gradients of two backward paths, relative L2 per parameter:
# once two bf16 backward passes part anywhere (the fused dQ's atomics add
# in another order each run; the pair sums in another order again), the
# layers' bf16 roundings spread it to a floor of their own size in the
# lowest layer, measured on an H100 at 5.0e-3 to 6.6e-3 for the fused
# path against itself and 7.4e-3 for the pair against it.  2^-6 is twice
# the largest reading; a 2% error in dK reads 2.2e-2, beyond it.
# Elementwise limits do not fit weight gradients: long sums that cancel,
# and f32 norm scales that carry bf16 arithmetic
TRAIN_GRAD_REL_TOL = 2.0 ** -6
# card against CPU on the small f32 model: loss max abs (the logits agree
# to 1e-4 and the loss is a mean of their log-softmax), each step's loss
# after AdamW updates (the same, plus updates that differ only where a
# gradient is near 0)
TRAIN_F32_LOSS_TOL = 1e-5
# phase 8: each fused step's loss against the same steps with the
# attention in PyTorch ops (impl="xla"), relative, up to the first step
# at which the plain loss rises: the two bf16 paths round apart and AdamW
# carries it on (seed 0 at d 256, 5 steps: 3e-7, 2.9e-5, 3.3e-5, 1.6e-4,
# then 8.2e-4 at the fifth, where the loss jumps from 8.14 to 17.17 on
# both paths; attention_tpu_torch/measure_d256_train.py reads other seeds)
TRAIN_PLAIN_RTOL = 2e-3
TRAIN_F32_STEP_LOSS_TOL = 1e-4
# phase 3d: the trainer's parameter layouts on a gloo world of ranks on
# the one card, at the serving widths (depth is the only cut), each run
# CP_TRAIN_STEPS steps held to its single-device run on the card by phase
# 3c's tolerances: (run, model, (dp, sp, tp), model keywords, fsdp,
# batch); the MoE run's step 2 is held to MESH_MOE_STEP2_RTOL instead.
# The MoE run is cut to depth 1: at depth 2 one device needs
# about 55 GB alone (SERVE_MOE's comment); depth 1 is 1.4e9 parameters,
# about 28 GB on one device, and 4 FSDP ranks of it hold a quarter of the
# state each (about 4.9 GB) beside the gathered tp block and its gradients
MESH_WORLD = 4
MESH_MOE_DEPTH = 1
# top-2 routing turns any reordering of the forward into other choices
# where a token's top two nearly tie, and step 1's update carries them
# into step 2: on the H100 the MoE mesh run's step 2 read 6.8e-4-8.4e-4
# from the single device's, the single device's own impl="xla" run
# 3.1e-3 (printed beside it as the witness of such a reordering), so the
# bar sits between the two
MESH_MOE_STEP2_RTOL = 2e-3
MESH_RUNS = (
    ("tp4", "dense", (1, 1, 4), {}, False, TRAIN_BATCH),
    ("dp2_tp2_fsdp", "dense", (2, 1, 2), {}, True, TRAIN_BATCH),
    ("sp2_tp2_ring", "dense", (1, 2, 2), dict(cp_axis="sp", cp_impl="ring"),
     False, (1, 8193)),
    ("moe_dp2_tp2_fsdp", "moe", (2, 1, 2), dict(ep_axis="tp"), True,
     TRAIN_BATCH),
    # the experts over "dp", whose ranks hold other tokens: all-to-alls
    # move the tokens to their experts; a quarter of them a rank
    ("moe_dp4_ep", "moe", (4, 1, 1), dict(ep_axis="dp"), False,
     TRAIN_BATCH))
# phase 3d's pipelined run: the serving model at depth 4 on ("pp",) of
# MESH_WORLD ranks (one block a stage), TRAIN_BATCH in PP_MICRO
# microbatches, CP_TRAIN_STEPS steps, held to make_train_step on one
# device by phase 3c's bars
PP_DEPTH = 4
PP_MICRO = 4
# phase 3d's train_with_recovery check: the small model in bf16 on the
# dQ + dK/dV pair (deterministic bits), (2, 1, 2) with FSDP, RECOVERY_STEPS
# steps of (4, 129) tokens, a checkpoint every RECOVERY_EVERY; every rank
# of the first world dies after RECOVERY_CRASH steps, a second resumes
RECOVERY_STEPS = 4
RECOVERY_EVERY = 2
RECOVERY_CRASH = 3
RECOVERY_BATCH = (4, 129)
# phase 8: Gemma 2 9B's head split (google/gemma-2-9b, config.json: 16
# attention heads, 8 key-value heads, head_dim 256,
# attn_logit_softcapping 50.0) at the serving model's vocab and depth; dim
# 4096, not 3584, since TinyDecoder ties the head dim to dim // q heads
D256_MODEL = dict(vocab=32000, dim=4096, depth=4, num_q_heads=16,
                  num_kv_heads=8, rope=True, softcap=50.0)
# its kernel cases (q heads, kv heads, rows, d): the operations of the
# serving model's 32 / 4 heads at d 128 (PERF.md rows 1, 3-5)
D256_OPS = (16, 8, 4096, 256)
# the small f32 model with head dim 256 of the card-against-CPU checks
D256_SMALL = dict(vocab=256, dim=512, depth=2, num_q_heads=2,
                  num_kv_heads=1, rope=True, softcap=50.0)
# the quantized cases at head dims off the powers of two: int8 at 96
# (the D = 128 instance), int4 at 80 (40-byte rows: 4-byte copies)
D256_ODD_QUANT = (("int8", 96), ("int4", 80))


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time for ``nbytes`` of traffic and ``ops`` operations
    at the card's peaks, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes > t_ops else "operations")


def time_ms(fn, *, calls: int = 5, reps: int = 7) -> float:
    """Median over ``reps`` CUDA-event windows of ``calls`` back-to-back
    calls, per call, after two warm-up calls."""
    fn()
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def held(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """A kernel's output against its plain version's on the same inputs,
    under `reference.mismatch`'s limits: (max abs error, largest share
    of the limit).  Raises beyond the limits."""
    from attention_tpu_torch.ops.reference import mismatch

    torch.cuda.synchronize()
    err, ratio = mismatch(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"max abs err {err}: {ratio} x the limit")
    return err, ratio


def rejected(planted: dict, want: torch.Tensor) -> dict:
    """Plain outputs with a fault planted in them must fail the check
    that the kernel passes: {fault: share of the limit}."""
    from attention_tpu_torch.ops.reference import mismatch

    out = {what: mismatch(got, want)[1] for what, got in planted.items()}
    if not all(ratio > 1.0 for ratio in out.values()):
        raise AssertionError(f"the check passes a planted fault: {out}")
    return out


def same_bits(a, b, what: str = "two calls on the same inputs") -> None:
    """Two calls on the same inputs must give the same bits (tensors or
    tuples of tensors)."""
    for x, y in zip(*((t,) if torch.is_tensor(t) else t for t in (a, b))):
        ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
        if not torch.equal(x.view(ints), y.view(ints)):
            raise AssertionError(
                f"{what} differ: {(x != y).sum().item()} of {x.numel()} "
                f"elements, max abs {(x - y).abs().max().item()}")


def decode_work(lens, s_new, h, hkv, d, item, window=None, sinks=None,
                kv_row_bytes=None):
    """(bytes, operations) one decode call needs on these lengths: q read
    and the output written once, each sequence's K/V rows that any of its
    rows sees read once per kv head (``kv_row_bytes`` for K and V
    together, default 2·d·item), every visible (row, key) pair scored and
    summed.  Row s of a sequence of length L sits at L - S + s."""
    kv_row_bytes = kv_row_bytes or 2 * d * item
    nbytes = 2 * len(lens) * h * s_new * d * item
    pairs = 0
    for length in lens:
        length, lo = max(length, 0), max(length, 0)
        for s in range(s_new):
            pos = length - s_new + s
            if pos < 0:
                continue
            first = 0 if window is None else max(pos - window + 1, 0)
            pairs += pos - first + 1 + min(sinks or 0, first)
            lo = min(lo, first)
        rows = length - lo + min(sinks or 0, lo)
        nbytes += hkv * rows * kv_row_bytes
    return nbytes, 4.0 * d * h * pairs


def split_of(b, hkv, h, s_new, n, window=None) -> dict:
    """The key split of a decode launch on this card (`split_plan`) and
    its grid: (row blocks, B·Hkv, splits)."""
    from attention_tpu_torch.ops.decode import ROW_BLOCK, split_plan

    rows = h // hkv * s_new
    splits, chunk = split_plan(
        b, hkv, rows, n, s_new, window,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(splits=splits, chunk=chunk,
                grid=[-(-rows // ROW_BLOCK), b * hkv, splits])


def case_name(dtype, s_new, kw) -> str:
    """dtype, tokens per sequence and options, e.g.
    ``bfloat16_S1_window512_sinks``."""
    opts = [f"window{kw['window']}" if k == "window" else k for k in kw]
    return f"{str(dtype)[6:]}_S{s_new or 1}_{'_'.join(opts) or 'plain'}"


def without_middle_split(q, k, v, lens, split, *, stats=False, **kw):
    """The plain output (or partials) with the keys of the longest
    sequence's middle split masked out: a merge that lost one split's
    partials."""
    from attention_tpu_torch.ops.decode import split_owner
    from attention_tpu_torch.ops.reference import decode_reference

    q4 = q if q.dim() == 4 else q[:, :, None]
    lens = lens.clamp(min=0)
    owner = split_owner(lens, k.shape[2], q4.shape[2], kw.get("window"),
                        split["splits"], split["chunk"])
    longest = int(lens.argmax())
    cols = torch.ones_like(owner, dtype=torch.bool)
    cols[longest] = owner[longest] != split["splits"] // 2
    out = decode_reference(q4, k, v, lens, scale=q.shape[-1] ** -0.5,
                           partials=stats, columns=cols, **kw)
    if stats:
        return tuple(t[:, :, 0] for t in out)
    return out if q.dim() == 4 else out[:, :, 0]


def flash_plan(q, k, v, kv_valid=None, window=None, sinks=None) -> dict:
    """The body and key split a flash call on these inputs runs."""
    from attention_tpu_torch.ops.flash import flash_launch_plan

    plan = flash_launch_plan(q, k, v, kv_valid=kv_valid, window=window,
                             sinks=sinks)
    return dict(body=plan["body"], splits=plan["splits"])


def without_diagonal_tile(q, k, v, **kw):
    """The plain flash output with the keys of one row block's diagonal
    tile (the first tile its CTA masks, `tile_plan`'s ``mask``) dropped
    for that block's rows, the middle block of the call: a kernel whose
    mask range lost the tile that needs the mask."""
    from attention_tpu_torch.ops.decode import merge_splits
    from attention_tpu_torch.ops.flash import (
        KEY_TILE,
        ROW_BLOCK,
        flash_attention_plain,
        tile_plan,
    )
    from attention_tpu_torch.ops.reference import \
        attention_reference_partials

    out = flash_attention_plain(q, k, v, **kw).clone()
    m, n = q.shape[-2], k.shape[-2]
    m0 = (-(-m // ROW_BLOCK) // 2) * ROW_BLOCK
    q_offset, kv_offset = kw.get("q_offset", 0), kw.get("kv_offset", 0)
    valid = n if kw.get("kv_valid") is None else kw["kv_valid"]
    t = tile_plan(m0, m, valid, kw.get("causal", False), q_offset,
                  kv_offset)[2]
    rows = q[..., m0:m0 + ROW_BLOCK, :]
    parts = [attention_reference_partials(
        rows, k[..., lo:hi, :], v[..., lo:hi, :],
        scale=kw.get("scale"), causal=kw.get("causal", False),
        softcap=kw.get("softcap"), q_offset=q_offset + m0,
        kv_offset=kv_offset + lo, kv_valid=min(max(valid - lo, 0), hi - lo))
        for lo, hi in ((0, t * KEY_TILE), ((t + 1) * KEY_TILE, n))
        if hi > lo]
    acc, mx, sm = (torch.stack(x, dim=-2 if i == 0 else -1)
                   for i, x in enumerate(zip(*parts)))
    out[..., m0:m0 + ROW_BLOCK, :] = merge_splits(acc, mx, sm,
                                                  dtype=out.dtype)
    return out


def hold(kernels, kernel, case, *, run, plain, faults, work, dtype,
         library=None, view=lambda out: out, **extra) -> dict:
    """Hold one kernel case against its plain version: the same bits on
    a second call, within `reference.mismatch` of the plain output (after
    ``view``), each planted fault rejected; then time the kernel, the
    plain version and, where one exists, the one library call."""
    got = run()
    same_bits(got, run())
    want = view(plain())
    err, ratio = held(view(got), want)
    faults = rejected({k: view(f()) for k, f in faults.items()}, want)
    b_ms, b_by = bound_ms(*work, dtype)
    rec = dict(ms=time_ms(run), plain_ms=time_ms(plain), bound_ms=b_ms,
               bound_by=b_by,
               library_ms=None if library is None else time_ms(library))
    kernels[kernel]["max_abs_err"] = max(kernels[kernel]["max_abs_err"], err)
    emit(phase="kernels", kernel=kernel, case=case, max_abs_err=err,
         share_of_limit=ratio, planted_faults_share_of_limit=faults,
         **rec, **extra)
    return rec


#: the kernel templates whose last template argument is the max_mode
#: variant (0 online, 1 bound, 2 FLASH-D, 3 AMLA): the wgmma body, the
#: decode rows' kernel, and the other variants' kernels of the flash and
#: ragged CUDA-core loops
VARIANT_TEMPLATES = ("flash_fwd_wgmma", "decode_kernel", "_kernel_var")
#: the kernels built over the softmax steps that take a variant
#: (attention_tile.cuh's `attend`, `attend_mma` and `softmax_tile`,
#: decode_rows.cuh, the wgmma body): none of their instances may spill
VARIANT_STEP_KERNELS = ("flash_fwd", "ragged_paged", "decode",
                        "paged_decode", "quant_decode", "quant_tok4")


def ptxas_instances(report) -> list:
    """Registers and spill bytes of every kernel instance in nvcc's
    ``-Xptxas -v`` reports (`ops.build`): its kernel, function, ``seg``
    where its segment-id argument is true, and its max_mode ``variant``
    (0 for online and for a kernel that takes none)."""
    out, cur = [], None
    for kernel, rec in report.items():
        for line in rec["ptxas"].splitlines():
            found = re.search(r"Compiling entry function '([^']+)'", line)
            if found:
                name = found.group(1)
                var = re.search(r"Li(\d)EEEv", name)
                variant = int(var.group(1)) if var and any(
                    t in name for t in VARIANT_TEMPLATES) else 0
                cur = dict(kernel=kernel, function=name,
                           seg=bool(re.search(r"Lb1E(Li\dE)?EEv", name)),
                           variant=variant, registers=None,
                           spill_bytes=[0, 0])
                out.append(cur)
                continue
            if cur is None:
                continue
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if found:
                cur["spill_bytes"] = [int(x) for x in found.groups()]
            found = re.search(r"Used (\d+) registers", line)
            if found:
                cur["registers"] = int(found.group(1))
    return out


def phase_build(ops) -> None:
    t0 = time.perf_counter()
    report = ops.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels={k: v["seconds"] for k, v in report.items()},
         cpu_seconds={k: v.get("cpu_seconds") for k, v in report.items()},
         units={k: v["units"] for k, v in report.items() if "units" in v})
    # every instance's registers at launch and spills (the wgmma
    # consumers' 240 registers a thread are set by setmaxnreg): the
    # segment-id instances one by one, the rest by kernel and variant
    # (0 online, 1 bound, 2 FLASH-D, 3 AMLA): how many, their registers'
    # range, how many spill; an instance of a kernel over the variant
    # steps that spills, online or not, fails the build
    instances = ptxas_instances(report)
    groups = {}
    for rec in instances:
        if rec["seg"]:
            emit(phase="build", ptxas=rec)
        agg = groups.setdefault(f"{rec['kernel']}/{rec['variant']}",
                                dict(instances=0, registers=[999, 0],
                                     spilling=0))
        agg["instances"] += 1
        if rec["registers"] is not None:
            agg["registers"] = [min(agg["registers"][0], rec["registers"]),
                                max(agg["registers"][1], rec["registers"])]
        agg["spilling"] += any(rec["spill_bytes"])
    emit(phase="build", instances=groups)
    spilling = [rec for rec in instances if any(rec["spill_bytes"])
                and rec["kernel"] in VARIANT_STEP_KERNELS]
    if spilling:
        raise AssertionError(f"instances spill: {spilling}")
    # ptxas's performance warnings (wgmma serialized, and the like)
    for kernel, rec in report.items():
        for line in rec["ptxas"].splitlines():
            if "Performance" in line or "serializ" in line:
                emit(phase="build", kernel=kernel, ptxas_warning=line)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def ragged_step_from_scheduler(model):
    """A packed step at the serving geometry, built by the port's own
    scheduler: an engine over ``model`` runs until some requests decode
    while others still prefill, then packs its next step.  Layer 0's
    step comes back on copies of its pools, with one prefill slot's
    last page unclaimed so that the append poisons that slot."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        RequestState,
        ServingEngine,
        synthetic_trace,
    )
    from attention_tpu_torch.engine.sim import sampling_of

    eng = ServingEngine(model, EngineConfig(**SERVE_ENGINE))
    for e in synthetic_trace(8, vocab=model.vocab, seed=SEED + 1,
                             prompt_len_min=128, prompt_len_max=1024,
                             max_tokens=32, arrival_every=0):
        eng.add_request(e["prompt"], sampling_of(e), request_id=e["id"])

    def states():
        return {r.state for r in eng.scheduler.running}

    for _ in range(64):
        if RequestState.DECODING in states() and (
                eng.scheduler.waiting or RequestState.PREFILLING in states()):
            break
        eng.step()
    else:
        raise AssertionError("no step mixes decode and prefill")
    sched = eng.scheduler.schedule(eng.current_step)
    _, caches, batch = eng.pack_step(sched)
    step = caches[0]
    last = len(sched.decode) + len(sched.prefill) - 1
    if not (sched.decode and sched.prefill and batch.width > batch.num_real):
        raise AssertionError("the packed step lacks decode, prefill or pad")
    table = step.page_table.clone()
    end = int(batch.cu_q_lens[last + 1]) - 1
    table[last, int(batch.token_pos[end]) // step.page_size] = -1
    return step._replace(k_pool=step.k_pool.clone(),
                         v_pool=step.v_pool.clone(), page_table=table)


def ragged_work(step, q, window=None, sinks=None) -> tuple[float, float]:
    """(bytes, operations) one ragged call needs on this step's data:
    real query rows and the output read/written once, each live slot's
    K/V rows that a token sees read once, every visible (token,
    position) pair scored and summed: causally, and under a ``window``
    only the band's and the ``sinks``' positions."""
    hq, d = q.shape[1], q.shape[-1]
    hkv = step.k_pool.shape[1]
    item = q.element_size()
    cu = step.cu_q_lens.tolist()
    lens = step.kv_lens.tolist()
    real = cu[int(step.distribution[1])]
    nbytes = hq * (real + q.shape[2]) * d * item
    pairs = 0
    for s in range(int(step.distribution[1])):
        q_len, kv_len = cu[s + 1] - cu[s], lens[s]
        if q_len <= 0 or kv_len < 0:
            continue
        if window is None:
            nbytes += 2 * hkv * kv_len * d * item
            pairs += q_len * (kv_len - q_len) + q_len * (q_len + 1) // 2
            continue
        lo = max(kv_len - q_len - window + 1, 0)
        nbytes += 2 * hkv * (kv_len - lo + min(sinks or 0, lo)) * d * item
        for pos in range(kv_len - q_len, kv_len):
            first = max(pos - window + 1, 0)
            pairs += pos - first + 1 + min(sinks or 0, first)
    return nbytes, 2.0 * (d + d) * hq * pairs


# the decode-only ragged step: one token for each of 8 decode slots over
# the seed-0 serving trace's prompt lengths plus 16 decoded tokens (the
# steady state of the serving run), 2 prefill slots idle
RAGGED_DECODE_LENS = [907, 926, 637, 733, 754, 269, 923, 672]


def ragged_step(gen, spans, *, hq=32, hkv=4, d=128, page=128,
                slots=10, pages_per_slot=16, dtype=torch.bfloat16):
    """(q, step) of a packed step over random pools at the serving
    geometry: (tokens, length after the append) per active slot, decode
    slots first, each slot its own pages, the other slots idle; the
    width and query tile bucketed as the engine buckets them; q as the
    attention layer passes it ((1, T, Hq, d) storage)."""
    from attention_tpu_torch.ops import ragged_paged as rp

    group = hq // hkv
    num_decode = sum(1 for n, _ in spans if n == 1)
    real = sum(n for n, _ in spans)
    max_q = max((n for n, _ in spans[num_decode:]), default=1)
    q_tile = rp.recommended_q_tile(max_q, group)
    width = rp.packed_bucket(max(real, q_tile))
    pages = slots * pages_per_slot
    perm = torch.randperm(pages, generator=gen, device="cuda").to(
        torch.int32)
    table = torch.full((slots, pages_per_slot), -1, dtype=torch.int32,
                       device="cuda")
    cu, lens = [0], []
    for s, (n, kv_len) in enumerate(spans):
        used = -(-kv_len // page)
        first = s * pages_per_slot
        table[s, :used] = perm[first:first + used]
        cu.append(cu[-1] + n)
        lens.append(kv_len)
    cu += [cu[-1]] * (slots + 1 - len(cu))
    lens += [0] * (slots - len(lens))

    def dev(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    step = rp.RaggedPagedStep(
        randn(pages, hkv, page, d), randn(pages, hkv, page, d), table,
        dev(lens), dev(cu), dev([num_decode, len(spans)]),
        dev([0] * width), dev([-1] * width), q_tile)
    return randn(1, width, hq, d).transpose(1, 2), step


def ragged_plan(q, step, window=None) -> dict:
    """The launch plan of a ragged call on this card; raises unless bf16
    at head dim 128 and page 128 runs the wgmma body for its prefill
    slots and the split (more than one split, four key groups) for its
    decode slots."""
    from attention_tpu_torch.ops.ragged_paged import ragged_launch_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ragged_launch_plan(q, step, sms=sms, window=window)
    if (q.dtype == torch.bfloat16 and q.shape[-1] == 128
            and step.page_size == 128
            and not (plan["body"] == "wgmma" and plan["splits"] > 1
                     and plan["kg"] == 4)):
        raise AssertionError(f"the ragged serving geometry runs {plan}")
    return plan


def phase_kernels(kernels, serve_model):
    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_append,
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [
        ("f32_dk_ne_dv_ragged", torch.float32,
         ((4, 200, 64), (2, 333, 64), (2, 333, 96)), {}),
        ("bf16_causal_gqa_softcap", torch.bfloat16,
         ((1, 32, 1024, 128), (1, 4, 1024, 128), (1, 4, 1024, 128)),
         {"causal": True, "softcap": 50.0}),
        ("f32_op_path_shape", torch.float32,
         ((8192, 128), (8192, 128), (8192, 128)), {}),
        ("bf16_op_path_shape", torch.bfloat16,
         ((8192, 128), (8192, 128), (8192, 128)), {}),
        ("bf16_serving_causal_gqa", torch.bfloat16,
         ((1, 32, 4096, 128), (1, 4, 4096, 128), (1, 4, 4096, 128)),
         {"causal": True}),
        ("bf16_serving_causal_gqa_softcap50", torch.bfloat16,
         ((1, 32, 4096, 128), (1, 4, 4096, 128), (1, 4, 4096, 128)),
         {"causal": True, "softcap": 50.0}),
    ]
    for name, dtype, shapes, kw in cases:
        q, k, v = (randn(*s, dtype=dtype) for s in shapes)
        plan = flash_plan(q, k, v)
        if dtype is torch.bfloat16 and plan["body"] != "wgmma":
            raise AssertionError(f"{name} runs the {plan['body']} body")
        got = flash_attention(q, k, v, **kw)
        same_bits(got, flash_attention(q, k, v, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        err, ratio = held(got, want)
        planted = {
            "dropped_last_key_tile": flash_attention_plain(
                q, k[..., :-KEY_TILE, :], v[..., :-KEY_TILE, :], **kw),
            "scale_off_2pct": flash_attention_plain(
                q, k, v, scale=1.02 * q.shape[-1] ** -0.5, **kw),
        }
        if kw.get("causal"):
            planted["dropped_diagonal_tile"] = without_diagonal_tile(
                q, k, v, **kw)
        faults = rejected(planted, want)
        kernels["flash_fwd"]["max_abs_err"] = max(
            kernels["flash_fwd"]["max_abs_err"], err)
        emit(phase="kernels", kernel="flash_fwd", case=name, **plan,
             max_abs_err=err, share_of_limit=ratio,
             planted_faults_share_of_limit=faults)

    step = ragged_step_from_scheduler(serve_model)
    hq, hkv = serve_model.num_q_heads, serve_model.num_kv_heads
    width, d = step.token_pos.shape[0], serve_model.head_dim
    dtype = step.k_pool.dtype
    step = ragged_paged_append(step, randn(1, hkv, width, d, dtype=dtype),
                               randn(1, hkv, width, d, dtype=dtype))
    q = randn(1, hq, width, d, dtype=dtype)
    cu = step.cu_q_lens.tolist()
    active = int(step.distribution[1])
    lens = step.kv_lens.tolist()
    poisoned = [s for s in range(active) if lens[s] < 0]
    if len(poisoned) != 1:
        raise AssertionError(f"expected one poisoned slot, got {poisoned}")
    # a decode slot's one token sees its whole cache: cutting the slot's
    # length drops its last key tile
    longest = max(range(int(step.distribution[0])), key=lambda s: lens[s])
    if lens[longest] <= KEY_TILE:
        raise AssertionError(f"no decode slot longer than a key tile: {lens}")
    cut = list(lens)
    cut[longest] -= (lens[longest] - 1) % KEY_TILE + 1
    cut = torch.tensor(cut, dtype=torch.int32, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        st = step._replace(k_pool=step.k_pool.to(dt),
                           v_pool=step.v_pool.to(dt))
        qd = q.to(dt)
        got = ragged_paged_attention(qd, st, softcap=50.0)
        same_bits(got, ragged_paged_attention(qd, st, softcap=50.0))
        want = ragged_paged_attention_plain(qd, st, softcap=50.0)
        err, ratio = held(got, want)
        faults = rejected({
            "dropped_last_key_tile": ragged_paged_attention_plain(
                qd, st._replace(kv_lens=cut), softcap=50.0),
            "scale_off_2pct": ragged_paged_attention_plain(
                qd, st, scale=1.02 * d ** -0.5, softcap=50.0),
        }, want)
        s = poisoned[0]
        if not (got[:, :, cu[s]:cu[s + 1]].isnan().all()
                and (got[:, :, cu[active]:] == 0).all()):
            raise AssertionError("poisoned rows not NaN or pad not zero")
        kernels["ragged_paged"]["max_abs_err"] = max(
            kernels["ragged_paged"]["max_abs_err"], err)
        emit(phase="kernels", kernel="ragged_paged", case=f"{dt}"[6:],
             decode_slots=int(step.distribution[0]), active_slots=active,
             real_tokens=cu[active], width=width, poisoned_slot=s,
             kv_lens=lens, plan=ragged_plan(qd, st), max_abs_err=err,
             share_of_limit=ratio, planted_faults_share_of_limit=faults)
    phase_ragged_decode(kernels, gen)
    return step, q


#: the max_mode phase's flash cases (PERF.md row 1): 32 q / 4 kv heads,
#: head dim 128, causal, bf16, without and with softcap 50
MODE_FLASH = (32, 4, 8192, 128)
MODE_DECODE_LENS = [1, 100, 517, 1024, 1500, 2000, 2047, 2048]
#: sequence lengths of the bound-against-online crossover (32/4 heads,
#: causal, bf16, the threshold pinned to 0 so that bound runs at each)
MODE_CROSSOVER = (512, 1024, 2048, 4096, 8192)


def queued_ms(fn, calls: int, host_s: float) -> float | None:
    """Device ms per call of ``calls`` calls of ``fn`` by CUDA events,
    the calls queued behind `torch.cuda._sleep` so that the card never
    waits for the host between them (``host_s``: one call's host
    seconds): the card's time for the whole calls, the gaps between
    their kernels in it.  None where the calls outran every backlog (a
    call that waits for the card)."""
    backlog = 2 * host_s * calls + 1e-3
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda._sleep(int(backlog * 2e9))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued_first = not start.query()
        end.synchronize()
        if queued_first:
            return start.elapsed_time(end) / calls
        backlog *= 4
    return None


def kernel_device_ms(fn, name: str, *, calls: int = 20) -> tuple:
    """(device ms per call of every kernel ``fn`` launches, of those
    whose name holds ``name``, and where they came from), after two
    warm-up calls.  By `torch.profiler` ("profiler"), a profile taken
    only where it recorded every call: each kernel a multiple of
    ``calls`` times, and calls of a millisecond or more within 10% of
    `queued_ms` on the same calls, where it reads (a 5-call profile of
    the d 256 dK/dV kernel has counted every call and read a fifth
    low).  A profile of
    the card's activity alone has missed calls on the H100 (about half
    of 30 calls of tens of µs, or all of 5 calls of tens of ms): then a
    profile held open a quarter second, or as long as the calls take,
    before and after them (which took the short calls whole).  Failing
    that, `queued_ms` ("cuda_events"; the named kernels' share is then
    not measured, None).  A line names each profile that was not taken
    and what replaced it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host_s = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    pad, queued = 0.0, None
    for attempt in ("profiler", "padded_profiler"):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        pad = max(0.25, time.perf_counter() - t0)
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        seen: dict[str, int] = {}
        for e in events:
            seen[e.name] = seen.get(e.name, 0) + 1
        total = sum(e.time_range.elapsed_us() for e in events) / calls / 1e3
        whole = bool(seen) and all(c % calls == 0 for c in seen.values())
        if whole and total >= 1.0:
            queued = queued_ms(fn, calls, host_s) if queued is None \
                else queued
            whole = queued is None or abs(total - queued) <= 0.1 * queued
        if whole:
            own = sum(e.time_range.elapsed_us() for e in events
                      if name in e.name)
            return total, own / calls / 1e3, "profiler"
        emit(phase="profiler", attempt=attempt, calls=calls,
             kernels_recorded=seen, profile_ms=total, queued_ms=queued)
    ms = queued_ms(fn, calls, host_s) if queued is None else queued
    if ms is None:
        raise AssertionError("no whole profile, and the calls outran every "
                             "backlog: no device time")
    emit(phase="profiler", replaced_by="cuda_events", ms=ms)
    return ms, None if name else ms, "cuda_events"


def device_ms(fn, *, calls: int = 30) -> float:
    """Device time per call of every kernel ``fn`` launches
    (`kernel_device_ms`): the card's share of a call whose host time
    `time_ms` would measure instead."""
    return kernel_device_ms(fn, "", calls=calls)[0]


def device_time(fn, *, calls: int = 30, key: str = "device_ms") -> dict:
    """`device_ms` under ``key``, and beside it under ``key``_source
    where the number came from (`kernel_device_ms`)."""
    total, _, source = kernel_device_ms(fn, "", calls=calls)
    return {key: total, f"{key}_source": source}


def mode_device_ms(run, modes, kernel: str = "flash_fwd") -> dict:
    """Each variant's device ms of ``run(mode)``, all its kernels and the
    kernel's own (its name holds ``kernel``; the rest is a guard's or a
    merge's work), measured in turns in one call: online, the others,
    online again (its two readings bracket the others')."""
    order = ["online", *(m for m in modes if m != "online"), "online"]
    out = {}
    for mode in order:
        total, own, source = kernel_device_ms(lambda: run(mode), kernel)
        rec = dict(device_ms=total, kernel_device_ms=own,
                   device_ms_source=source)
        out[mode] = rec if mode not in out else [out[mode], rec]
    return out


def held_variant_stats(parts, plain, mode) -> float:
    """A variant's partials stats (`flash_attention_partials`) against
    its plain version's: the same rows see no key; elsewhere the
    log-sum-exp (row max + log row sum) within relative 1e-5 (the same
    arithmetic in another order), and the variant's own contract: the
    row bound ("bound") and the largest score ("online") within relative
    1e-5, sums of 1 ("flashd"), whole log2 units at most one apart
    ("amla": a score within rounding of a whole unit may ceil either
    way on the two sides).  Returns the lse's relative error."""
    (_, mx, sm), (_, pmx, psm) = parts, plain
    seen = psm != 0
    if not torch.equal(sm != 0, seen):
        raise AssertionError(f"{mode}: the rows that see no key differ")
    lse, plse = (a[seen] + torch.log(b[seen]) for a, b in ((mx, sm),
                                                          (pmx, psm)))
    rel = ((lse - plse).abs().max() / plse.abs().max()).item()
    units = mx[seen] / math.log(2)
    ok = {"online": lambda: ((mx - pmx)[seen].abs().max()
                             <= 1e-5 * pmx[seen].abs().max()),
          "bound": lambda: ((mx - pmx).abs().max()
                            <= 1e-5 * pmx.abs().max()),
          "flashd": lambda: torch.equal(sm, seen.float()),
          "amla": lambda: ((units - units.round()).abs().max() <= 1e-5
                           and (mx - pmx)[seen].abs().max()
                           <= math.log(2) * 1.0001)}[mode]()
    if not rel <= 1e-5 or not bool(ok):
        raise AssertionError(f"{mode} stats: lse off by {rel}, contract "
                             f"{bool(ok)}")
    return rel


def phase_max_modes(kernels, step, q_step) -> None:
    """The rescaling-math variants (the TPU kernels' max_mode) on the
    card, each held against its plain version: the flash forward at
    `MODE_FLASH` (normalized and partials, without and with softcap 50,
    and an f32 FMA-body case), "bound" under
    ``torch.cuda.set_sync_debug_mode("error")`` (its guard adds no host
    sync); a planted outlier key whose guard demotes the call to the
    online body's bits; decode at the serving width (B 8, lengths to
    2048) and the ragged mixed step under "flashd" and "amla"; the
    bound-against-online crossover.  Each line carries the variant's
    device ms beside online's in the same call."""
    from attention_tpu_torch.ops import _native, decode, flash
    from attention_tpu_torch.ops import ragged_paged as rp

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    h, hkv, m, d = MODE_FLASH
    q, k, v = randn(1, h, m, d), randn(1, hkv, m, d), randn(1, hkv, m, d)
    variants = {}
    for cap in (None, 50.0):
        kw = dict(causal=True, softcap=cap)
        want = flash.flash_attention_plain(q, k, v, **kw)
        planted = {
            "dropped_last_key_tile": flash.flash_attention_plain(
                q, k[..., :-KEY_TILE, :], v[..., :-KEY_TILE, :], **kw),
            "scale_off_2pct": flash.flash_attention_plain(
                q, k, v, scale=1.02 * d ** -0.5, **kw)}
        faults = rejected(planted, want)
        del planted
        plain_ms = time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw),
                           calls=1, reps=3)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + want.numel())
        b_ms, b_by = bound_ms(nbytes, 2.0 * h * m * (m + 1) / 2 * 2 * d,
                              q.dtype)

        def run(mode, partials=False):
            fn = (flash.flash_attention_partials if partials
                  else flash.flash_attention)
            return fn(q, k, v, max_mode=mode, **kw)

        dev = mode_device_ms(run, flash.MAX_MODES)
        case = f"causal{'_softcap50' if cap else ''}"
        for mode in flash.MAX_MODES:
            resolved = flash.resolve_max_mode(mode, heads=h, m=m, n=m,
                                              causal=True)
            before = _native.demotion_count()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, again = run(mode), run(mode)
                parts = run(mode, partials=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            demoted = _native.demotion_count() - before
            same_bits(got, again)
            err, ratio = held(got, want)
            pw = flash.variant_partials_plain(q, k, v, resolved, **kw)
            stat_rel = held_variant_stats(parts, pw, resolved)
            perr, pratio = held(
                (parts[0] / parts[2].clamp(min=1e-30)[..., None]).to(q.dtype),
                (pw[0] / pw[2].clamp(min=1e-30)[..., None]).to(q.dtype))
            if demoted:
                raise AssertionError(f"the guard demoted {demoted}")
            kernels["flash_fwd"]["max_abs_err"] = max(
                kernels["flash_fwd"]["max_abs_err"], err, perr)
            ms = time_ms(lambda: run(mode))
            variants.setdefault("flash_fwd", {})[f"{case}_{mode}"] = dict(
                ms=ms, **(dev[mode] if mode != "online" else dev[mode][0]))
            emit(phase="max_modes", kernel="flash_fwd", case=case,
                 variant=mode, resolved=resolved, shape=list(MODE_FLASH),
                 **flash_plan(q, k, v), max_abs_err=err, share_of_limit=ratio,
                 partials_max_abs_err=perr, partials_share_of_limit=pratio,
                 partials_stats_rel=stat_rel, guard_demoted=demoted,
                 planted_faults_share_of_limit=faults, ms=ms,
                 device=dev[mode], online_device=dev["online"],
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del want

    # the f32 FMA body
    qf, kf, vf = (randn(1, s, 1000, 64, dtype=torch.float32)
                  for s in (8, 2, 2))
    want = flash.flash_attention_plain(qf, kf, vf, causal=True)
    for mode in flash.MAX_MODES:
        with_pin = contextlib.ExitStack()
        if mode == "bound":
            # below the threshold "bound" resolves to online: pin it so
            # that the FMA body's bound instance runs
            old = flash._BOUND_MIN_SCORE_ELEMS
            flash._BOUND_MIN_SCORE_ELEMS = 0
            with_pin.callback(setattr, flash, "_BOUND_MIN_SCORE_ELEMS", old)
        with with_pin:
            got = flash.flash_attention(qf, kf, vf, causal=True,
                                        max_mode=mode)
            parts = flash.flash_attention_partials(qf, kf, vf, causal=True,
                                                   max_mode=mode)
            pw = flash.variant_partials_plain(qf, kf, vf, mode, causal=True)
            plan = flash.flash_launch_plan(qf, kf, vf, variant=mode)
        err, ratio = held(got, want)
        stat = held_variant_stats(parts, pw, mode)
        perr, pratio = held(*(o / s.clamp(min=1e-30)[..., None]
                              for o, _, s in (parts, pw)))
        if plan["body"] != "fma":
            raise AssertionError(f"f32 {mode} runs {plan['body']}")
        emit(phase="max_modes", kernel="flash_fwd", case="f32_fma",
             variant=mode, body=plan["body"], max_abs_err=err,
             share_of_limit=ratio, partials_max_abs_err=perr,
             partials_share_of_limit=pratio, partials_stats_rel=stat)

    # a planted outlier key: the guard demotes, the online body's bits
    k[0, 1, m // 2] *= 4000.0 / k[0, 1, m // 2].float().norm()
    before = _native.demotion_count()
    got = flash.flash_attention(q, k, v, causal=True, max_mode="bound")
    demoted = _native.demotion_count() - before
    online = flash.flash_attention(q, k, v, causal=True, max_mode="online")
    if demoted != 1 or not torch.equal(got, online) \
            or not got.isfinite().all():
        raise AssertionError(f"planted overshoot: demoted {demoted}")
    emit(phase="max_modes", case="planted_overshoot", guard_demoted=demoted,
         online_bits=True, finite=True)
    del q, k, v, got, online

    # decode at the serving width, and the ragged mixed step
    lens = torch.tensor(MODE_DECODE_LENS, dtype=torch.int32, device="cuda")
    b, n = len(MODE_DECODE_LENS), max(MODE_DECODE_LENS)
    qd, kc, vc = randn(b, h, d), randn(b, hkv, n, d), randn(b, hkv, n, d)
    want = decode.flash_decode_plain(qd, kc, vc, lens)
    split = split_of(b, hkv, h, 1, n)
    faults = rejected({"dropped_middle_split": without_middle_split(
        qd, kc, vc, lens, split)}, want)
    dev = mode_device_ms(
        lambda mode: decode.flash_decode(qd, kc, vc, lens, max_mode=mode),
        decode.DECODE_MAX_MODES, kernel="decode")
    rdev = mode_device_ms(
        lambda mode: rp.ragged_paged_attention(q_step, step, softcap=50.0,
                                               max_mode=mode),
        decode.DECODE_MAX_MODES, kernel="")
    rwant = rp.ragged_paged_attention_plain(q_step, step, softcap=50.0)
    live = ~rwant.isnan()
    for mode in decode.DECODE_MAX_MODES[1:]:
        got = decode.flash_decode(qd, kc, vc, lens, max_mode=mode)
        same_bits(got, decode.flash_decode(qd, kc, vc, lens, max_mode=mode))
        err, ratio = held(got, want)
        kernels["decode"]["max_abs_err"] = max(
            kernels["decode"]["max_abs_err"], err)
        ms = time_ms(lambda: decode.flash_decode(qd, kc, vc, lens,
                                                 max_mode=mode))
        variants.setdefault("decode", {})[mode] = dict(ms=ms, **dev[mode])
        emit(phase="max_modes", kernel="decode", variant=mode,
             lens=MODE_DECODE_LENS, **split, max_abs_err=err,
             share_of_limit=ratio, planted_faults_share_of_limit=faults,
             ms=ms, device=dev[mode], online_device=dev["online"])
        got = rp.ragged_paged_attention(q_step, step, softcap=50.0,
                                        max_mode=mode)
        same_bits(got, rp.ragged_paged_attention(q_step, step, softcap=50.0,
                                                 max_mode=mode))
        if not torch.equal(got.isnan(), ~live):
            raise AssertionError(f"ragged {mode}: NaN rows moved")
        # the poisoned slot's NaN rows apart, each row under its own limit
        err, ratio = held(got.nan_to_num(), rwant.nan_to_num())
        kernels["ragged_paged"]["max_abs_err"] = max(
            kernels["ragged_paged"]["max_abs_err"], err)
        variants.setdefault("ragged_paged", {})[mode] = rdev[mode]
        emit(phase="max_modes", kernel="ragged_paged", variant=mode,
             plan=ragged_plan(q_step, step), max_abs_err=err,
             share_of_limit=ratio, device=rdev[mode],
             online_device=rdev["online"])
    del qd, kc, vc, want

    # where bound overtakes online on this card
    old = flash._BOUND_MIN_SCORE_ELEMS
    flash._BOUND_MIN_SCORE_ELEMS = 0
    try:
        for rows in MODE_CROSSOVER:
            qx, kx, vx = (randn(1, s, rows, d) for s in (h, hkv, hkv))
            cdev = mode_device_ms(
                lambda mode: flash.flash_attention(qx, kx, vx, causal=True,
                                                   max_mode=mode),
                ("online", "bound"))
            emit(phase="max_modes", case="bound_crossover", rows=rows,
                 score_elements=h * rows * rows // 2, device=cdev)
    finally:
        flash._BOUND_MIN_SCORE_ELEMS = old
    for name, rec in variants.items():
        kernels[name]["variants"] = rec
    emit(phase="max_modes", seconds=time.perf_counter() - t0,
         launches=_native.variant_counts())


def phase_ragged_decode(kernels, gen) -> None:
    """The ragged kernel on a decode-only step (`RAGGED_DECODE_LENS`,
    bf16, softcap 50) held against its plain version, and the device
    time of the call beside the paged decode kernel's on the same pools,
    tables and lengths as a (8, 1) call: the two-call lowering of the
    same work, the nearest yardstick (no PyTorch call computes ragged
    paged attention)."""
    from attention_tpu_torch.ops.paged import PagedKV, paged_flash_decode
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    spans = [(1, n + 16) for n in RAGGED_DECODE_LENS]
    q, step = ragged_step(gen, spans)
    n = len(spans)
    lens = step.kv_lens.tolist()
    cut = list(lens)
    cut[0] -= (lens[0] - 1) % KEY_TILE + 1
    cut = torch.tensor(cut, dtype=torch.int32, device="cuda")
    nbytes, ops_count = ragged_work(step, q)

    def run():
        return ragged_paged_attention(q, step, softcap=50.0)

    def plain(**kw):
        return ragged_paged_attention_plain(q, step._replace(**kw),
                                            softcap=50.0)

    cache = PagedKV(step.k_pool, step.v_pool,
                    step.page_table[:n].contiguous(),
                    step.kv_lens[:n].contiguous())
    q3 = q[0, :, :n].transpose(0, 1).contiguous()  # (8, Hq, d)
    times = dict(device_ms=device_ms(run), paged_decode_device_ms=device_ms(
        lambda: paged_flash_decode(q3, cache, softcap=50.0)))
    rec = hold(
        kernels, "ragged_paged", "bfloat16_decode_only", run=run,
        plain=plain,
        faults={"dropped_last_key_tile": lambda: plain(kv_lens=cut),
                "scale_off_2pct": lambda: ragged_paged_attention_plain(
                    q, step, scale=1.02 * 128 ** -0.5, softcap=50.0)},
        work=(nbytes, ops_count), dtype=q.dtype, kv_lens=lens,
        plan=ragged_plan(q, step), **times)
    kernels["ragged_paged"]["decode_only"] = dict(
        ms=rec["ms"], bound_ms=rec["bound_ms"], **times)


def band_tiles(m, window, sinks) -> tuple[int, int, int]:
    """(visited, banded, pairs) of one head's causal m x m call: the key
    tiles its row blocks visit by the kernel's plan (`tile_plan`), the
    (row block, tile) pairs that hold a key some row keeps, counted on
    the mask itself, and the kept (row, key) pairs."""
    from attention_tpu_torch.ops.flash import ROW_BLOCK, tile_plan
    from attention_tpu_torch.ops.flash import KEY_TILE as TILE
    from attention_tpu_torch.ops.reference import attention_mask

    keep = attention_mask(m, m, causal=True, window=window, sinks=sinks,
                          device="cuda")
    blocks = keep.view(m // ROW_BLOCK, ROW_BLOCK, m // TILE, TILE)
    banded = int(blocks.any(3).any(1).sum())
    visited = sum(len(tile_plan(m0, m, m, True, 0, 0, window=window,
                                sinks=sinks).tiles())
                  for m0 in range(0, m, ROW_BLOCK))
    return visited, banded, int(keep.sum())


def phase_window_kernels(kernels, step, q_step) -> None:
    """Phase 2's sliding-window cases.  The flash kernel at the served
    geometry over 8192 rows (`WINDOW_FLASH`), each band of
    `WINDOW_BANDS` without and with softcap 50: the wgmma body, its
    visited tiles equal to the tiles holding a kept key, held against
    the plain version (a band one key tile longer, a dropped sink tile
    and a 2% scale error must fail), timed beside SDPA with the band as
    a boolean mask; the band must shrink the card's time (window 4096 at
    or below the call without one, window 1024 under half of it).  An
    f32 call on the FMA body with dk != dv.  The ragged kernel with the
    serving band (`SERVE_BAND`) on the scheduler-packed step and on the
    decode-only one."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )
    from attention_tpu_torch.ops.reference import attention_mask

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    h, hkv, m, d = WINDOW_FLASH
    q, k, v = (torch.randn((1, heads, m, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for heads in (h, hkv, hkv))
    kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    cases = kernels["flash_fwd"].setdefault("window_cases", {})
    for softcap in (None, 50.0):
        for band, (window, sinks) in WINDOW_BANDS.items():
            kw = dict(causal=True, softcap=softcap, window=window,
                      sinks=sinks)

            def run(kw=kw):
                return flash_attention(q, k, v, **kw)

            def plain(kw=kw, **over):
                return flash_attention_plain(q, k, v, **dict(kw, **over))

            plan = flash_plan(q, k, v, window=window, sinks=sinks)
            visited, banded, pairs = band_tiles(m, window, sinks)
            if plan["body"] != "wgmma" or visited != banded:
                raise AssertionError(f"{band}: {plan}, {visited} tiles "
                                     f"visited for {banded} in the band")
            got = run()
            same_bits(got, run())
            want = plain()
            err, ratio = held(got, want)
            planted = {"scale_off_2pct": plain(scale=1.02 * d ** -0.5)}
            if window is not None:
                planted["band_one_tile_longer"] = plain(window=window + 128)
            if sinks:
                planted["dropped_sink_tile"] = plain(sinks=None)
            faults = rejected(planted, want)
            del got, want, planted
            rec = dict(ms=time_ms(run), device_ms=device_ms(run),
                       plain_ms=time_ms(plain, calls=1, reps=3))
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                (2 * h + 2 * hkv) * m * d * 2, 2.0 * (d + d) * h * pairs,
                torch.bfloat16)
            if softcap is None:
                # SDPA has no softcap: its time stands beside the
                # uncapped calls only
                mask = None if window is None else attention_mask(
                    m, m, causal=True, window=window, sinks=sinks,
                    device="cuda")

                def library(mask=mask):
                    return F.scaled_dot_product_attention(
                        q, kx, vx, attn_mask=mask, is_causal=mask is None)

                rec.update(library_ms=time_ms(library),
                           library_device_ms=device_ms(library))
                del mask
            case = f"bfloat16_{band}" + ("_softcap50" if softcap else "")
            cases[case] = rec
            kernels["flash_fwd"]["max_abs_err"] = max(
                kernels["flash_fwd"]["max_abs_err"], err)
            emit(phase="kernels", kernel="flash_fwd", case=case,
                 shape=list(WINDOW_FLASH), window=window, sinks=sinks,
                 **plan, visited_tiles=h * visited, band_tiles=h * banded,
                 kept_pairs=h * pairs, max_abs_err=err,
                 share_of_limit=ratio, planted_faults_share_of_limit=faults,
                 **rec)
        cap = "_softcap50" if softcap else ""
        full = cases["bfloat16_causal" + cap]["device_ms"]
        w4096 = cases["bfloat16_window4096_sinks4" + cap]["device_ms"]
        w1024 = cases["bfloat16_window1024" + cap]["device_ms"]
        emit(phase="kernels", kernel="flash_fwd", softcap=softcap,
             window4096_over_causal=w4096 / full,
             window1024_over_causal=w1024 / full)
        if not (w4096 <= full and w1024 < 0.5 * full):
            raise AssertionError(f"the band does not shrink the work: "
                                 f"{w4096}, {w1024} against {full} ms")
    del q, k, v, kx, vx

    # the FMA body: f32, dk != dv, a cached prefill's offset
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((4, 200, 64), (2, 333, 64), (2, 333, 96)))
    kw = dict(causal=True, window=100, sinks=5, q_offset=133)
    pairs = 4 * int(attention_mask(200, 333, causal=True, q_offset=133,
                                   window=100, sinks=5).sum())
    hold(kernels, "flash_fwd", "f32_fma_dk_ne_dv_window100_sinks5",
         run=lambda: flash_attention(q, k, v, **kw),
         plain=lambda: flash_attention_plain(q, k, v, **kw),
         faults={"dropped_sink_tile": lambda: flash_attention_plain(
             q, k, v, **dict(kw, sinks=None)),
             "band_one_tile_longer": lambda: flash_attention_plain(
                 q, k, v, **dict(kw, window=100 + KEY_TILE))},
         work=(4 * (4 * 200 * 64 + 2 * 333 * (64 + 96) + 4 * 200 * 96),
               2.0 * (64 + 96) * pairs), dtype=torch.float32,
         **flash_plan(q, k, v, window=100, sinks=5))

    band = dict(window=SERVE_BAND["window"], sinks=SERVE_BAND["attn_sinks"])
    decode_only = ragged_step(gen, [(1, n + 16) for n in RAGGED_DECODE_LENS])
    for name, (qr, st) in (("scheduler_step", (q_step, step)),
                           ("decode_only", decode_only)):

        def run(qr=qr, st=st):
            return ragged_paged_attention(qr, st, softcap=50.0, **band)

        def plain(qr=qr, st=st, **over):
            return ragged_paged_attention_plain(qr, st, softcap=50.0,
                                                **dict(band, **over))

        dms = device_ms(run)
        rec = hold(
            kernels, "ragged_paged",
            f"bfloat16_{name}_window{band['window']}_sinks{band['sinks']}",
            run=run, plain=plain,
            faults={"dropped_sink_tile": lambda plain=plain: plain(
                sinks=None), "band_one_tile_longer": lambda plain=plain:
                plain(window=band["window"] + KEY_TILE)},
            work=ragged_work(st, qr, **band), dtype=torch.bfloat16,
            plan=ragged_plan(qr, st, window=band["window"]),
            kv_lens=st.kv_lens.tolist(), device_ms=dms)
        kernels["ragged_paged"].setdefault("window_cases", {})[name] = dict(
            ms=rec["ms"], device_ms=dms, plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"])
    emit(phase="kernels", window_seconds=time.perf_counter() - t0)


def packed_ids(docs) -> torch.Tensor:
    """int32 segment ids of documents of these lengths packed in a row,
    on the card."""
    return torch.repeat_interleave(
        torch.arange(len(docs), dtype=torch.int32),
        torch.tensor(docs)).cuda()


def shifted(ids: torch.Tensor) -> torch.Tensor:
    """A planted fault's key ids: each key takes the id of the key before
    it, which moves every boundary by one key."""
    return torch.cat([ids[:1], ids[:-1]])


def phase_segment_kernels(kernels) -> None:
    """Phase 2's packed sequences.  The flash kernel at the served
    geometry over 8192 rows (`WINDOW_FLASH`, 3-D) with segment ids:
    `PACKED_DOCS` causal, the same ids under window 1024, interleaved ids
    (row i in segment i % 3) causal; each on the wgmma body, held against
    the plain version, the same bits on a second call, and the kernel run
    with the key ids shifted by one key must fail the check; timed beside
    the same call without ids, with SDPA under the mask as a boolean mask
    and the bound of the kept pairs.  The share of the causal pairs the
    packing keeps.  With ids all equal the kernel gives the bits of the
    call without them.  An f32 call on the FMA body with m != n (a cached
    prefill's offset, rows whose id no key holds)."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from attention_tpu_torch.ops.reference import attention_mask

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    h, hkv, m, d = WINDOW_FLASH
    q, k, v = (torch.randn((heads, m, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for heads in (h, hkv, hkv))
    kx, vx = (t.repeat_interleave(h // hkv, dim=0)[None] for t in (k, v))
    packed = packed_ids(PACKED_DOCS)
    interleaved = (torch.arange(m, device="cuda") % 3).to(torch.int32)
    cases = kernels["flash_fwd"].setdefault("segment_cases", {})
    unsegmented = {}
    for window in (None, 1024):
        unsegmented[window] = device_ms(
            lambda window=window: flash_attention(q, k, v, causal=True,
                                                  window=window))
    zeros = torch.zeros(m, dtype=torch.int32, device="cuda")
    same_bits(flash_attention(q, k, v, causal=True, q_segment_ids=zeros,
                              kv_segment_ids=zeros),
              flash_attention(q, k, v, causal=True),
              "all-equal ids and no ids")
    causal_pairs = m * (m + 1) // 2
    for case, ids, window in (("packed_causal", packed, None),
                              ("packed_window1024", packed, 1024),
                              ("interleaved_causal", interleaved, None)):
        kw = dict(causal=True, window=window, q_segment_ids=ids,
                  kv_segment_ids=ids)

        def run(kw=kw):
            return flash_attention(q, k, v, **kw)

        def plain(kw=kw):
            return flash_attention_plain(q, k, v, **kw)

        plan = flash_plan(q, k, v, window=window)
        if plan["body"] != "wgmma":
            raise AssertionError(f"{case}: {plan}")
        got = run()
        same_bits(got, run())
        want = plain()
        err, ratio = held(got, want)
        faults = rejected({"kv_ids_shifted_one_key": flash_attention(
            q, k, v, **dict(kw, kv_segment_ids=shifted(ids)))}, want)
        del got, want
        mask = attention_mask(m, m, causal=True, window=window,
                              q_segment_ids=ids, kv_segment_ids=ids,
                              device="cuda")
        pairs = int(mask.sum())

        def library(mask=mask):
            return F.scaled_dot_product_attention(q[None], kx, vx,
                                                  attn_mask=mask)

        rec = dict(ms=time_ms(run), device_ms=device_ms(run),
                   unsegmented_device_ms=unsegmented[window],
                   plain_ms=time_ms(plain, calls=1, reps=3),
                   library_ms=time_ms(library),
                   library_device_ms=device_ms(library))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            (2 * h + 2 * hkv) * m * d * 2, 2.0 * (d + d) * h * pairs,
            torch.bfloat16)
        del mask
        cases[case] = rec
        kernels["flash_fwd"]["max_abs_err"] = max(
            kernels["flash_fwd"]["max_abs_err"], err)
        emit(phase="kernels", kernel="flash_fwd", case=case,
             shape=[h, hkv, m, d], window=window, **plan,
             kept_pairs=h * pairs, share_of_causal_pairs=pairs / causal_pairs,
             max_abs_err=err, share_of_limit=ratio,
             planted_faults_share_of_limit=faults,
             over_unsegmented=rec["device_ms"] / unsegmented[window],
             over_kept_pairs_bound=rec["device_ms"] / rec["bound_ms"], **rec)
    del q, k, v, kx, vx

    # the FMA body: f32, m != n, a cached prefill's offset, rows 0-9 of
    # an id no key holds
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((4, 200, 64), (2, 333, 64), (2, 333, 96)))
    q_ids = (torch.arange(200, device="cuda") // 50).to(torch.int32)
    q_ids[:10] = 9
    kv_ids = (torch.arange(333, device="cuda") // 80).to(torch.int32)
    kw = dict(causal=True, q_offset=133, q_segment_ids=q_ids,
              kv_segment_ids=kv_ids)
    pairs = 4 * int(attention_mask(200, 333, causal=True, q_offset=133,
                                   q_segment_ids=q_ids,
                                   kv_segment_ids=kv_ids,
                                   device="cuda").sum())
    hold(kernels, "flash_fwd", "f32_fma_m_ne_n_segments",
         run=lambda: flash_attention(q, k, v, **kw),
         plain=lambda: flash_attention_plain(q, k, v, **kw),
         faults={"kv_ids_shifted_one_key": lambda: flash_attention(
             q, k, v, **dict(kw, kv_segment_ids=shifted(kv_ids)))},
         work=(4 * (4 * 200 * 64 + 2 * 333 * (64 + 96) + 4 * 200 * 96),
               2.0 * (64 + 96) * pairs), dtype=torch.float32,
         **flash_plan(q, k, v))
    emit(phase="kernels", segment_seconds=time.perf_counter() - t0)


def phase_decode_kernels(kernels):
    """The decode, paged decode and cached-prefill flash cases at the
    serving geometry (32 q / 4 kv heads, d 128): 8 sequences whose
    lengths run from 0 to the full 4096-row capacity.  Returns the bf16
    decode caches."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops.decode import (
        flash_decode,
        flash_decode_chunk,
        flash_decode_plain,
    )
    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from attention_tpu_torch.ops.paged import (
        PagedKV,
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    h, hkv, n, d, page = 32, 4, 4096, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    b = len(DECODE_LENS)
    # the longest sequence's last key tile dropped
    cut = lens.clone()
    cut[-1] -= KEY_TILE
    scale_off = 1.02 * d ** -0.5
    decode_rec = paged_rec = None
    # generate's own geometry: 8 prompts of 512 tokens and 32 steps in a
    # 544-row cache, the sequences 513 to 544 rows long
    gen_n = 544
    gen_lens = torch.tensor([513, 517, 522, 526, 531, 535, 540, 544],
                            dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        k, v = randn(b, hkv, n, d, dtype=dtype), randn(b, hkv, n, d,
                                                       dtype=dtype)
        item = k.element_size()
        for s_new, kw in ((0, {}), (0, {"softcap": 50.0}),
                          (0, {"window": 512, "sinks": 4}),
                          (0, {"window": 100, "sinks": 4}),
                          (4, {"softcap": 50.0})):
            q = randn(b, h, *([s_new] if s_new else []), d, dtype=dtype)
            fn = flash_decode_chunk if s_new else flash_decode
            split = split_of(b, hkv, h, s_new or 1, n, kw.get("window"))
            library = None
            if not s_new and not kw:
                mask = (torch.arange(n, device="cuda") < lens[:, None])
                library = lambda: F.scaled_dot_product_attention(  # noqa
                    q[:, :, None], k, v, attn_mask=mask[:, None, None],
                    enable_gqa=True)
                if not (split["splits"] > 1 and
                        split["grid"][1] * split["splits"] > 132):
                    raise AssertionError(f"the serving decode is not "
                                         f"split across the SMs: {split}")
            rec = hold(
                kernels, "decode", case_name(dtype, s_new, kw),
                run=lambda: fn(q, k, v, lens, **kw),
                plain=lambda: flash_decode_plain(q, k, v, lens, **kw),
                faults={"dropped_last_key_tile": lambda: flash_decode_plain(
                    q, k, v, cut, **kw),
                    "scale_off_2pct": lambda: flash_decode_plain(
                        q, k, v, lens, scale=scale_off, **kw),
                    "dropped_middle_split": lambda: without_middle_split(
                        q, k, v, lens, split, **kw)},
                work=decode_work(DECODE_LENS, s_new or 1, h, hkv, d, item,
                                 kw.get("window"), kw.get("sinks")),
                dtype=dtype, library=library, lengths=DECODE_LENS, **split)
            if dtype is torch.bfloat16 and not s_new and not kw:
                decode_rec = rec
                # a call is host-bound here: the card's time beside SDPA's
                emit(phase="kernels", kernel="decode",
                     case=case_name(dtype, s_new, kw),
                     device_ms=device_ms(lambda: fn(q, k, v, lens)),
                     library_device_ms=device_ms(library))

        # generate's own geometry
        kg, vg = (x[:, :, :gen_n].contiguous() for x in (k, v))
        q = randn(b, h, d, dtype=dtype)
        split = split_of(b, hkv, h, 1, gen_n)
        gcut = gen_lens.clone()
        gcut[-1] -= KEY_TILE
        hold(kernels, "decode", f"{str(dtype)[6:]}_S1_generate_geometry",
             run=lambda: flash_decode(q, kg, vg, gen_lens),
             plain=lambda: flash_decode_plain(q, kg, vg, gen_lens),
             faults={"dropped_last_key_tile": lambda: flash_decode_plain(
                 q, kg, vg, gcut),
                 "scale_off_2pct": lambda: flash_decode_plain(
                     q, kg, vg, gen_lens, scale=scale_off),
                 "dropped_middle_split": lambda: without_middle_split(
                     q, kg, vg, gen_lens, split)},
             work=decode_work(gen_lens.tolist(), 1, h, hkv, d, item),
             dtype=dtype, lengths=gen_lens.tolist(), **split)

        # the same caches behind a shuffled page table; sequence 0 (length
        # 0) has an all -1 table row, sequence 1 is poisoned (length -1)
        per = n // page
        perm = torch.randperm(b * per, generator=gen, device="cuda")

        def pool(x):
            out = torch.empty(b * per, hkv, page, d, dtype=x.dtype,
                              device="cuda")
            out[perm] = x.view(b, hkv, per, page, d).transpose(1, 2) \
                .reshape(b * per, hkv, page, d)
            return out

        table = perm.view(b, per).to(torch.int32)
        table[0] = -1
        plens = lens.clone()
        plens[1] = -1
        cache = PagedKV(pool(k), pool(v), table.contiguous(), plens)
        pcut = cache._replace(lengths=torch.where(
            torch.arange(b, device="cuda") == b - 1, cut, plens))
        for s_new, bsz, kw in ((0, b, {"softcap": 50.0}),
                               (0, b, {"window": 512, "sinks": 4}),
                               (0, b, {"window": 100, "sinks": 4}),
                               (0, b, {"return_stats": True}),
                               (256, 2, {"softcap": 50.0})):
            # chunk: the two-call prefill's (2, 256) rows, on the last two
            # sequences
            c, cc, kd, vd = cache, pcut, k, v
            if bsz != b:
                c, cc = (PagedKV(x.k_pool, x.v_pool, x.page_table[-bsz:],
                                 x.lengths[-bsz:]) for x in (cache, pcut))
                kd, vd = k[-bsz:], v[-bsz:]
            q = randn(bsz, h, *([s_new] if s_new else []), d, dtype=dtype)
            stats = kw.get("return_stats", False)
            band = {k_: v_ for k_, v_ in kw.items() if k_ != "return_stats"}
            split = split_of(bsz, hkv, h, s_new or 1, n, kw.get("window"))

            def view(out, stats=stats):
                if not stats:
                    return out
                o, _, l_ = out
                return (o / l_.clamp(min=1e-30)[..., None]).to(dtype)

            def middle(q=q, c=c, kd=kd, vd=vd, band=band, stats=stats,
                       split=split, kw=kw):
                # the longest (last) sequence's rows without its middle
                # split, in the plain output
                out = without_middle_split(q, kd, vd, c.lengths, split,
                                           stats=stats, **band)
                if stats:
                    return out
                want = paged_flash_decode_plain(q, c, **kw).clone()
                want[-1] = out[-1]
                return want

            lens_here = [max(x, 0) for x in c.lengths.tolist()]
            rec = hold(
                kernels, "paged_decode", case_name(dtype, s_new, kw),
                run=lambda: paged_flash_decode(q, c, **kw),
                plain=lambda: paged_flash_decode_plain(q, c, **kw),
                faults={"dropped_last_key_tile": lambda: (
                    paged_flash_decode_plain(q, cc, **kw)),
                    "scale_off_2pct": lambda: paged_flash_decode_plain(
                        q, c, scale=scale_off, **kw),
                    "dropped_middle_split": middle},
                work=decode_work(lens_here, s_new or 1, h, hkv, d, item,
                                 kw.get("window"), kw.get("sinks")),
                dtype=dtype, view=view, lengths=c.lengths.tolist(), **split)
            out = paged_flash_decode(q, c, **kw)
            if not stats and bsz == b and not (
                    (out[0] == 0).all() and out[1].isnan().all()
                    and not out[2:].isnan().any()):
                raise AssertionError("the empty row is not 0 or the "
                                     "poisoned row not NaN")
            if dtype is torch.bfloat16 and not s_new and "softcap" in kw:
                paged_rec = rec
                emit(phase="kernels", kernel="paged_decode",
                     case=case_name(dtype, s_new, kw), device_ms=device_ms(
                         lambda: paged_flash_decode(q, c, **kw)))

        # cached prefill: 512 new rows at the start of a 1152-row cache,
        # with the serving model's softcap 50 and without it (SDPA has no
        # softcap: only the second is like for like)
        m, cap = 512, 1152
        q = randn(b, h, m, d, dtype=dtype)
        kc, vc = (randn(b, hkv, cap, d, dtype=dtype) for _ in range(2))
        plan = flash_plan(q, kc, vc, kv_valid=m)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, kc[:, :, :m], vc[:, :, :m], is_causal=True,
                enable_gqa=True)

        for softcap in (50.0, None):
            kw = dict(causal=True, q_offset=0, kv_valid=m, softcap=softcap)

            def run():
                return flash_attention(q, kc, vc, **kw)

            hold(kernels, "flash_fwd",
                 f"{str(dtype)[6:]}_cached_prefill"
                 + ("_softcap50" if softcap else ""),
                 run=run,
                 plain=lambda: flash_attention_plain(q, kc, vc, **kw),
                 faults={
                     "dropped_last_key_tile": lambda: flash_attention_plain(
                         q, kc, vc, **dict(kw, kv_valid=m - KEY_TILE)),
                     "scale_off_2pct": lambda: flash_attention_plain(
                         q, kc, vc, scale=scale_off, **kw),
                     "dropped_diagonal_tile": lambda: without_diagonal_tile(
                         q, kc, vc, **kw)},
                 work=(2 * (b * h * m + b * hkv * m) * d * item,
                       4.0 * d * b * h * m * (m + 1) / 2),
                 dtype=dtype, library=sdpa, **plan,
                 device_ms=device_ms(run),
                 library_device_ms=device_ms(sdpa))
    kernels["decode"].update(decode_rec)
    kernels["paged_decode"].update(paged_rec)
    return k, v


def phase_quant_kernels(ops, kernels, k, v) -> None:
    """The quantized decode kernels on the bf16 decode case's caches
    (serving geometry, `DECODE_LENS`, capacity 4096), quantized three
    ways.  First the two int4 entry points once each, as a user calls
    them (their path's launches); then each case held against its plain
    version (`hold`) and against the bf16 decode kernel on the
    unquantized caches, at the JAX package's budgets: int8 within 0.02
    (tests/test_quant.py:51), int4 below 0.15 (tests/test_quant.py:331),
    on the sequences of 100 rows or more, as those tests measure them (a
    one-row sequence returns its one value row, whose quantization error
    no softmax averages: up to amax/254 in int8, amax/14 in int4).  Each
    case prints its launch (`quant.launch_plan`: splits, chunk, key
    groups; the one-token cases must split and take KG = 4), the
    kernel's registers, shared bytes and CTAs per SM, and its device ms
    by `torch.profiler` beside its bound.  Last, NaN scales on the last
    rows (an overflowing int8 append's, and the key scales alone) and a
    window of 2, one token and a chunk of 4: every row sees only
    NaN-scaled columns and must come out NaN, as the plain version's.
    Bytes for the bound: per token and kv head, K and V of d (int8) or
    d/2 (int4) bytes and one fp32 scale each."""
    from attention_tpu_torch.ops import quant
    from attention_tpu_torch.ops.decode import flash_decode, \
        flash_decode_chunk

    b, hkv, n, d = k.shape
    h = 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    cut = lens.clone()
    cut[-1] -= KEY_TILE
    scale_off = 1.02 * d ** -0.5
    caches = {"int8": quant.quantize_kv(k, v),
              "int4": quant.quantize_kv_int4(k, v),
              "int4_tok": quant.quantize_kv_int4_tok(k, v)}
    row_bytes = {"int8": 2 * (d + 4), "int4": 2 * (d // 2 + 4),
                 "int4_tok": 2 * (d // 2 + 4)}
    op_of = {("int8", 0): quant.flash_decode_quantized,
             ("int8", 4): quant.flash_decode_quantized_chunk,
             ("int4", 0): quant.flash_decode_int4,
             ("int4_tok", 0): quant.flash_decode_int4_tok}
    kernel_of = {"int8": "quant_decode", "int4": "quant_decode",
                 "int4_tok": "quant_tok4"}
    kind_of = {"int8": quant.QuantizedKV, "int4": quant.Int4KV,
               "int4_tok": quant.Int4TokKV}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q1 = randn(b, h, d)
    long = [i for i, n_i in enumerate(DECODE_LENS) if n_i >= 100]
    ops.reset_launch_counts()
    quant.flash_decode_int4(q1, caches["int4"], lens)
    quant.flash_decode_int4_tok(q1, caches["int4_tok"], lens)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"quant_decode": 1, "quant_tok4": 1}
    if {name: c for name, c in launches.items() if c} != want:
        raise AssertionError(f"int4 entry points launched {launches}")
    for name, count in want.items():
        kernels[name]["launches"] += count
    emit(phase="quant_kernels", op_path=["flash_decode_int4",
                                         "flash_decode_int4_tok"],
         launches=launches)

    for fmt, s_new, kw in (("int8", 0, {}), ("int8", 0, {"softcap": 50.0}),
                           ("int8", 0, {"window": 512, "sinks": 4}),
                           ("int8", 4, {"softcap": 50.0}),
                           ("int4", 0, {}), ("int4_tok", 0, {})):
        cache, fn = caches[fmt], op_of[fmt, s_new]
        q = randn(b, h, s_new, d) if s_new else q1
        name = f"{fmt}_S{s_new or 1}_{'_'.join(kw) or 'plain'}"
        plan = quant.launch_plan(q, cache, kw.get("window"), sms=sms)
        if not s_new and not (plan["splits"] > 1 and plan["kg"] == 4):
            raise AssertionError(f"{name}: one-token launch {plan}")
        run = lambda: fn(q, cache, lens, **kw)  # noqa: E731
        dev = device_ms(run)
        rec = hold(
            kernels, kernel_of[fmt], name, run=run,
            plain=lambda: quant.quant_decode_plain(q, cache, lens, **kw),
            faults={"dropped_last_key_tile": lambda: quant.quant_decode_plain(
                q, cache, cut, **kw),
                "scale_off_2pct": lambda: quant.quant_decode_plain(
                    q, cache, lens, scale=scale_off, **kw)},
            work=decode_work(DECODE_LENS, s_new or 1, h, hkv, d, 2,
                             kw.get("window"), kw.get("sinks"),
                             kv_row_bytes=row_bytes[fmt]),
            dtype=torch.bfloat16, lengths=DECODE_LENS, **plan,
            resources=quant.kernel_resources(kind_of[fmt], d, plan["kg"]),
            device_ms=dev)
        bf16 = (flash_decode_chunk if s_new else flash_decode)(
            q, k, v, lens, **kw)
        err = (fn(q, cache, lens, **kw)[long].float()
               - bf16[long].float()).abs().max().item()
        budget = 0.02 if fmt == "int8" else 0.15
        emit(phase="quant_kernels", case=name, vs_bf16_kernel_max_abs_err=err,
             budget=budget)
        if not (err <= budget if fmt == "int8" else err < budget):
            raise AssertionError(f"{name}: {err} off the bf16 decode kernel")
        if not s_new and not kw and fmt != "int4":
            kernels[kernel_of[fmt]].update(rec, device_ms=dev)

    # an append past the capacity poisons the last rows' scales, key and
    # value ("both"); "keys" poisons the key scales alone, whose NaN scores
    # only the rows' sums carry.  With a window of 2 they are all each row
    # sees.
    for s_new in (1, 4):
        q = randn(b, h, s_new, d) if s_new > 1 else q1
        fn = op_of["int8", 4 if s_new > 1 else 0]
        for scales in ("both", "keys"):
            cache = quant.QuantizedKV(*(t.clone() for t in caches["int8"]))
            if scales == "both":
                quant.update_quantized_kv(cache, randn(b, hkv, s_new, d),
                                          randn(b, hkv, s_new, d),
                                          n - s_new + 1)
            else:
                cache.k_scale[:, :, -s_new:] = float("nan")
            got = fn(q, cache, n + 1, window=2)
            same_bits(got, fn(q, cache, n + 1, window=2))
            want = quant.quant_decode_plain(q, cache, n + 1, window=2)
            if not (want.isnan().all() and got.isnan().all()):
                raise AssertionError(
                    f"NaN window, S = {s_new}, {scales}: "
                    f"{int(got.isnan().sum())} of {got.numel()} NaN (plain "
                    f"{int(want.isnan().sum())})")
            emit(phase="quant_kernels",
                 case=f"int8_S{s_new}_nan_{scales}_window2", nan_rows="all",
                 **quant.launch_plan(q, cache, 2, sms=sms))


def phase_op_path(ops, kernels) -> None:
    from attention_tpu_torch import cli
    from attention_tpu_torch.core.testcase import (
        SUITE,
        generate_testcase,
        write_testcase,
    )
    from attention_tpu_torch.ops._native import BUILD_DIR
    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )

    m, n, dk, dv = SUITE["scale4"]
    path = os.path.join(BUILD_DIR, "scale4.bin")
    t0 = time.perf_counter()
    case = generate_testcase(m, n, dk, dv, seed=SEED)
    write_testcase(path, case)
    emit(phase="op_path", wrote=path, seconds=time.perf_counter() - t0)

    ops.reset_launch_counts()
    for dtype in ("f32", "bf16"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", path, "--backend", "flash", "--dtype",
                           dtype, "--repeats", "5", "--stats"])
        lines = buf.getvalue().splitlines()
        emit(phase="op_path", dtype=dtype, cli=lines)
        if rc != 0 or lines[0] != "Correct!":
            raise AssertionError(f"cli run --dtype {dtype}: {lines}")
    launches = ops.launch_counts()
    if launches["flash_fwd"] < 1:
        raise AssertionError(f"the op path launched no flash kernel: "
                             f"{launches}")
    kernels["flash_fwd"]["launches"] = launches["flash_fwd"]

    nbytes = (m * dk + n * dk + n * dv + m * dv)
    ops_count = 2.0 * (dk + dv) * m * n
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.as_tensor(x).to("cuda", dtype)
                   for x in (case.q, case.k, case.v))
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
        # SDPA on (1, 1, m, d), the layout its fused kernels take
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q[None, None], k[None, None], v[None, None]))
        b_ms, b_by = bound_ms(nbytes * q.element_size(), ops_count, dtype)
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        emit(phase="op_path", kernel="flash_fwd", dtype=f"{dtype}"[6:],
             shape=[m, n, dk, dv], **flash_plan(q, k, v),
             device_ms=device_ms(lambda: flash_attention(q, k, v)),
             gflop_s=ops_count / ms / 1e6, **rec)
        if dtype is torch.bfloat16:
            kernels["flash_fwd"].update(rec)

    # the served model's uncached causal forward at sequence 4096: many
    # heads, so many more CTAs than scale4's single head gives
    h, hkv, s, d = 32, 4, 4096, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((1, heads, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for heads in (h, hkv, hkv))
    kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    ops_count = 2.0 * (d + d) * h * s * (s + 1) / 2
    plan = flash_plan(q, k, v)
    b_ms = bound_ms((2 * h + 2 * hkv) * s * d * 2, ops_count,
                    torch.bfloat16)[0]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kx, vx, is_causal=True)

    # without softcap (SDPA computes the same), then with the served
    # model's softcap 50 (SDPA has none): the difference is softcap's cost
    nocap_ms = None
    for softcap in (None, 50.0):
        def run(softcap=softcap):
            return flash_attention(q, k, v, causal=True, softcap=softcap)

        ms = time_ms(run)
        rec = dict(ms=ms, device_ms=device_ms(run),
                   gflop_s=ops_count / ms / 1e6, bound_ms=b_ms)
        if softcap is None:
            nocap_ms = ms
            rec.update(library_ms=time_ms(sdpa), library_device_ms=device_ms(
                sdpa))
        else:
            rec.update(softcap=softcap, softcap_cost_ms=ms - nocap_ms)
        emit(phase="op_path", kernel="flash_fwd", dtype="bfloat16",
             shape=[h, hkv, s, d], causal=True, **plan, **rec)


def held_partials(part, plain, dtype):
    """The flash kernel's partials against the plain version's: the
    same rows see no key (row max -inf, sum 0 and output 0 on both
    sides), the row stats elsewhere within relative 1e-5 (the same
    arithmetic in another order), the normalised outputs in ``dtype``
    under `reference.mismatch`.  Returns (max abs err, share of the
    limit, rows that saw no key)."""
    torch.cuda.synchronize()
    live = plain[1].isfinite()
    dead = ~live
    if not torch.equal(part[1].isfinite(), live):
        raise AssertionError("partials' empty rows differ")
    if not ((part[2][dead] == 0).all() and (part[0][dead] == 0).all()
            and (plain[2][dead] == 0).all()):
        raise AssertionError("an empty row's partials are not 0")
    if live.any():
        rel = max(((a - b)[live].abs().max() / b[live].abs().max()).item()
                  for a, b in zip(part[1:], plain[1:]))
        if not rel <= 1e-5:
            raise AssertionError(f"partials' row stats off by {rel}")
    norm = [(o / l_.clamp(min=1e-30)[..., None]).to(dtype)
            for o, _, l_ in (part, plain)]
    err, ratio = held(*norm)
    return err, ratio, int(dead.sum())


def between_barriers_ms(fn, *, reps: int = 5) -> float:
    """Median CUDA-event ms of ``fn`` on this rank over ``reps`` calls,
    each between two barriers of the world, after one warm-up call."""
    import torch.distributed as dist

    fn()
    out = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        dist.barrier()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def distributed_rank(rank: int, world: int, init_file: str,
                     out_file: str, bin_path: str) -> None:
    """One rank of the distributed phase; rank 0 prints its lines and
    writes its launch count and largest error to ``out_file``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        rec = distributed_checks(rank, world, bin_path)
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def distributed_checks(rank: int, world: int, bin_path: str) -> dict:
    import torch.distributed as dist

    from attention_tpu_torch import cli, ops
    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_partials,
        flash_attention_partials_plain,
    )
    from attention_tpu_torch.parallel import (
        kv_sharded_attention,
        ring_attention,
        ulysses_attention,
    )
    from attention_tpu_torch.parallel.kv_sharded import _rows
    from attention_tpu_torch.parallel.mesh import (
        GLOO_CUDA_ROUTES,
        default_mesh,
    )

    def say(**record):
        if rank == 0:
            emit(phase="distributed", **record)

    def gathered(record: dict) -> list:
        out = [None] * world
        dist.all_gather_object(out, record)
        return out

    mesh = default_mesh("kv")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(world=world, card=smi, backend=dist.get_backend(),
        collective_routes={name: mesh.route(name, torch.device("cuda"))
                           for name in GLOO_CUDA_ROUTES})
    launches, max_err = 0, 0.0

    # 1. the .bin contract on scale4 through the CLI's run path
    for backend in ("kv-sharded", "q-sharded", "auto", "ring"):
        for dtype in ("f32", "bf16"):
            ops.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["run", bin_path, "--backend", backend,
                               "--dtype", dtype, "--repeats", "3",
                               "--stats"])
            n = ops.launch_counts()["flash_fwd"]
            lines = buf.getvalue().splitlines()
            say(case="scale4_cli", backend=backend, dtype=dtype, cli=lines,
                flash_launches=n)
            # one untimed call and three timed ones
            if n != 4 * DIST_LAUNCHES[backend]:
                raise AssertionError(f"rank {rank}: {backend} launched "
                                     f"{n} flash kernels")
            if rank == 0 and (rc != 0 or lines[0] != "Correct!"):
                raise AssertionError(f"cli run --backend {backend} "
                                     f"--dtype {dtype}: {lines}")
            launches += n

    # 2. the served model's causal forward, against one flash call
    h, hkv, s, d = DIST_FORWARD
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((1, heads, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for heads in (h, hkv, hkv))
    runs = {
        "kv-sharded": lambda m, **kw: kv_sharded_attention(
            q, k, v, causal=True, mesh=m, axis_name="kv", **kw),
        "ring": lambda m, **kw: ring_attention(
            q, k, v, causal=True, mesh=m, axis_name="kv", **kw),
        "ring_zigzag": lambda m, **kw: ring_attention(
            q, k, v, causal=True, schedule="zigzag", mesh=m,
            axis_name="kv", **kw),
        "ulysses": lambda m, **kw: ulysses_attention(
            q, k, v, causal=True, mesh=m, axis_name="kv", **kw),
    }
    for softcap in (None, 50.0):
        want = flash_attention(q, k, v, causal=True, softcap=softcap)
        for name, run in runs.items():
            ops.reset_launch_counts()
            got = run(mesh, softcap=softcap)
            torch.cuda.synchronize()
            n = ops.launch_counts()["flash_fwd"]
            if n != DIST_LAUNCHES[name]:
                raise AssertionError(f"rank {rank}: {name} launched {n} "
                                     "flash kernels")
            launches += n
            err, ratio = held(got, want)
            max_err = max(max_err, err)
            every = mesh.all_gather(got[None], "kv", dim=0)
            same = [torch.equal(every[0], x) for x in every]
            if not all(same):
                raise AssertionError(f"{name}: ranks differ from rank 0: "
                                     f"{same}")
            say(case="served_forward", backend=name, softcap=softcap,
                shape=[h, hkv, s, d], flash_launches=n,
                vs_flash_max_abs_err=err, share_of_limit=ratio,
                same_bits_on_every_rank=True)

    # 2b. the masking surface on 3-D views of the same inputs: window
    # 4096 with 4 sinks (at 4096 rows the band holds every causal pair:
    # the sinks' path), window 1024 with 4 sinks (the band crosses the
    # shards) and packed ids (`DIST_PACKED_DOCS`), each backend against
    # one flash call
    ids = packed_ids(DIST_PACKED_DOCS)
    q3, k3, v3 = q[0], k[0], v[0]
    masked_runs = {
        "kv-sharded": lambda m, **kw: kv_sharded_attention(
            q3, k3, v3, causal=True, mesh=m, axis_name="kv", **kw),
        "ring": lambda m, **kw: ring_attention(
            q3, k3, v3, causal=True, mesh=m, axis_name="kv", **kw),
        "ring_zigzag": lambda m, **kw: ring_attention(
            q3, k3, v3, causal=True, schedule="zigzag", mesh=m,
            axis_name="kv", **kw),
        "ulysses": lambda m, **kw: ulysses_attention(
            q3, k3, v3, causal=True, mesh=m, axis_name="kv", **kw),
    }
    for feature, fkw in (
            ("window4096_sinks4", dict(window=4096, sinks=4)),
            ("window1024_sinks4", dict(window=1024, sinks=4)),
            ("packed", dict(q_segment_ids=ids, kv_segment_ids=ids))):
        want = flash_attention(q3, k3, v3, causal=True, **fkw)
        for name, run in masked_runs.items():
            ops.reset_launch_counts()
            got = run(mesh, **fkw)
            torch.cuda.synchronize()
            n = ops.launch_counts()["flash_fwd"]
            if n != DIST_LAUNCHES[name]:
                raise AssertionError(f"rank {rank}: {name} {feature} "
                                     f"launched {n} flash kernels")
            launches += n
            err, ratio = held(got, want)
            max_err = max(max_err, err)
            every = mesh.all_gather(got[None], "kv", dim=0)
            same = [torch.equal(every[0], x) for x in every]
            if not all(same):
                raise AssertionError(f"{name} {feature}: ranks differ from "
                                     f"rank 0: {same}")
            say(case="served_forward_masked", backend=name, feature=feature,
                shape=[h, hkv, s, d], flash_launches=n,
                vs_flash_max_abs_err=err, share_of_limit=ratio,
                same_bits_on_every_rank=True)
    del q3, k3, v3, want, got, every

    # 3. the edge cases, each shard's partials against the plain version
    edges = []

    def hold_parts(case, qs, ks, vs, kw, dtype, empty=None):
        part = flash_attention_partials(qs, ks, vs, **kw)
        plain = flash_attention_partials_plain(qs, ks, vs, **kw)
        err, ratio, dead = held_partials(part, plain, dtype)
        rows = plain[1].numel()
        if empty is not None and (dead == rows) != empty:
            raise AssertionError(f"rank {rank} {case}: {dead} of {rows} "
                                 f"rows saw no key, expected all: {empty}")
        edges.append(dict(case=case, rank=rank, max_abs_err=err,
                          share_of_limit=ratio, rows_seeing_no_key=dead,
                          rows=rows, **flash_plan(qs, ks, vs,
                                                  kw.get("kv_valid"))))
        return err

    for n, dtype, m in ((5, torch.float32, 64), (5, torch.bfloat16, 64),
                        (8192, torch.bfloat16, 8192),
                        (8195, torch.bfloat16, 8192)):
        qe, ke, ve = (torch.randn((rows, d), generator=gen, device="cuda")
                      .to(dtype) for rows in (m, n, n))
        n_local = -(-n // world)
        lo = rank * n_local
        valid = min(max(n - lo, 0), n_local)
        max_err = max(max_err, hold_parts(
            f"kv_shard_n{n}_{str(dtype)[6:]}", qe, _rows(ke, lo, n_local),
            _rows(ve, lo, n_local), dict(kv_valid=valid, kv_offset=lo),
            dtype, empty=valid == 0))
        held(kv_sharded_attention(qe, ke, ve), flash_attention(qe, ke, ve))
    # every ring step's calls; the steps whose keys all lie in the
    # queries' future must see nothing
    m_local = s // world
    qb = q[:, :, rank * m_local:(rank + 1) * m_local]
    for t in range(world):
        shard = (rank - t) % world
        kv = [x[:, :, shard * m_local:(shard + 1) * m_local] for x in (k, v)]
        hold_parts(f"ring_step{t}", qb, *kv,
                   dict(causal=True, q_offset=rank * m_local,
                        kv_offset=shard * m_local), torch.bfloat16,
                   empty=shard > rank)
    chunk = s // (2 * world)

    def chunk_of(x, c):
        return x[:, :, c * chunk:(c + 1) * chunk]

    a, b = rank, 2 * world - 1 - rank
    for t in range(world):
        e = (rank - t) % world
        for qc, kc in ((b, e), (a, e), (b, 2 * world - 1 - e)):
            hold_parts(f"zigzag_step{t}_q{qc}_kv{kc}", chunk_of(q, qc),
                       chunk_of(k, kc), chunk_of(v, kc),
                       dict(causal=True, q_offset=qc * chunk,
                            kv_offset=kc * chunk), torch.bfloat16,
                       empty=kc > qc)
    all_edges = gathered(edges)
    for rank_edges in all_edges:
        for rec in rank_edges:
            say(**rec)
    max_err = max(max_err, *(rec["max_abs_err"] for rank_edges in all_edges
                             for rec in rank_edges))

    # 4. times on rank 0 between barriers: each backend beside the one
    # flash call on the same inputs, and the collectives' share of a
    # call (host seconds inside them, the card synchronised around each)
    def flash_alone():
        if rank == 0:
            flash_attention(q, k, v, causal=True)

    single_ms = between_barriers_ms(flash_alone)
    for name, run in runs.items():
        ms = between_barriers_ms(lambda: run(mesh))
        mesh.timings = {}
        dist.barrier()
        t0 = time.perf_counter()
        run(mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        coll = {name: sec * 1e3 for name, sec in mesh.timings.items()}
        mesh.timings = None
        say(case="served_forward_times", backend=name, card=smi, ms=ms,
            single_flash_ms=single_ms, instrumented_call_ms=wall,
            collectives_ms=coll, collectives_share=sum(coll.values()) / wall,
            ranks_on_one_card=world)
    return dict(launches=launches, max_abs_err=max_err)


def phase_distributed(kernels) -> None:
    """Spawn the gloo world on the card; a failed rank fails the phase."""
    import torch.multiprocessing as mp

    from attention_tpu_torch.ops._native import BUILD_DIR

    init = os.path.join(BUILD_DIR, f"distributed-{os.getpid()}.init")
    out = os.path.join(BUILD_DIR, f"distributed-{os.getpid()}.json")
    for stale in (init, out):
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    mp.spawn(distributed_rank, nprocs=DIST_WORLD,
             args=(DIST_WORLD, init, out,
                   os.path.join(BUILD_DIR, "scale4.bin")))
    with open(out) as f:
        rec = json.load(f)
    kernels["flash_fwd"]["launches"] += rec["launches"]
    kernels["flash_fwd"]["max_abs_err"] = max(
        kernels["flash_fwd"]["max_abs_err"], rec["max_abs_err"])
    emit(phase="distributed", seconds=time.perf_counter() - t0,
         rank0_flash_launches=rec["launches"])


# ------------------------------------------------ phase 3c: cp training


def cp_launches(impl: str, sp: int) -> int:
    """Flash forward (and backward) kernel calls of one attention call of
    ``impl`` on each rank of an sp axis of ``sp`` ranks: the ring makes
    one a step, zigzag three, the all-gather and Ulysses one."""
    return {"ring": sp, "zigzag": 3 * sp}.get(impl, 1)


def cp_exact_group(q, k, v, dout, *, scale, window=None, sinks=None,
                   ids=None):
    """out, dq of the first kv head's q heads and dk, dv of that kv head,
    in float64 from the (h, n, d) bf16 operands of a causal call (the
    mask of `reference.attention_mask`), one q head at a time: the witness
    that each path's and the single-device call's errors are measured
    against."""
    from attention_tpu_torch.ops.reference import attention_mask

    group = q.shape[0] // k.shape[0]
    n = k.shape[1]
    keep = attention_mask(n, n, causal=True, window=window, sinks=sinks,
                          q_segment_ids=ids, kv_segment_ids=ids,
                          device=q.device)
    k0, v0 = k[0].double(), v[0].double()
    outs, dqs = [], []
    dk = torch.zeros_like(k0)
    dv = torch.zeros_like(v0)
    for j in range(group):
        qj, doj = q[j].double(), dout[j].double()
        s = (qj @ k0.T * scale).masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        out = p @ v0
        ds = p * (doj @ v0.T - (doj * out).sum(-1, keepdim=True))
        dqs.append(ds @ k0 * scale)
        dk += ds.T @ qj * scale
        dv += p.T @ doj
        outs.append(out)
        del p, ds
    return torch.stack(outs), torch.stack(dqs), dk, dv


def cp_digest(tensors) -> torch.Tensor:
    """int64 (2,) checksum of the bits of ``tensors`` (each element's
    bits summed plain and weighted by its index mod 8191): two ranks whose
    digests agree hold the same bits."""
    total = torch.zeros(2, dtype=torch.int64, device="cuda")
    for t in tensors:
        bits = t.detach().contiguous().view(
            {2: torch.int16, 4: torch.int32}[t.element_size()]).reshape(-1)
        bits = bits.to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
        total[0] += bits.sum()
        total[1] += (bits * w).sum()
    return total


@contextlib.contextmanager
def cp_same_bound(k):
    """Every flash call's bound from the key norms of the whole of ``k``
    and the bound threshold at 0: each call of a path runs the bound body
    and bounds a row as one call over every key does."""
    from attention_tpu_torch.ops import flash

    whole = flash.key_norm_max(k if k.dim() == 4 else k[None])
    saved = flash.key_norm_max, flash._BOUND_MIN_SCORE_ELEMS
    flash.key_norm_max = lambda k4: whole
    flash._BOUND_MIN_SCORE_ELEMS = 0
    try:
        yield
    finally:
        flash.key_norm_max, flash._BOUND_MIN_SCORE_ELEMS = saved


def cp_ops(rank: int, world: int, say, launches: dict,
           failures: list) -> float:
    """Part 1 of phase 3c: the four differentiable paths on whole tensors
    at the served attention geometry, each under its default max_mode
    ("bound"), against one single-device `flash_attention_diff` call
    under the variant the path's calls ran and a float64 witness; the
    edges.  A check that fails joins ``failures``.  Returns the largest
    error of a held run against the single-device call."""
    import torch.distributed as dist

    from attention_tpu_torch import ops
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
    from attention_tpu_torch.ops.reference import (
        attention_mask,
        grad_ratios,
        mismatch,
    )
    from attention_tpu_torch.parallel import (
        cp_flash_attention,
        ring_attention_diff,
        ulysses_attention,
    )
    from attention_tpu_torch.parallel.mesh import default_mesh

    mesh = default_mesh("sp")
    h, hkv, s, d = CP_OPS
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    q, k, v, dout = (torch.randn((1, heads, s, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for heads in (h, hkv, hkv, h))
    paths = {
        "allgather": lambda *a, **kw: cp_flash_attention(
            *a, mesh=mesh, **kw),
        "ring": lambda *a, **kw: ring_attention_diff(*a, mesh=mesh, **kw),
        "zigzag": lambda *a, **kw: ring_attention_diff(
            *a, mesh=mesh, schedule="zigzag", **kw),
        "ulysses": lambda *a, **kw: ulysses_attention(*a, mesh=mesh, **kw)}
    ids = packed_ids(PACKED_DOCS)
    # Each path runs its default, "bound", which every call resolves by
    # its own size as JAX's does, and is held against one call under the
    # variant its calls ran (`ops.variant_counts`): the all-gather and
    # Ulysses make one bound call over every key, as the single call
    # does; windowed calls, and the zigzag's chunk pairs at this size,
    # resolve to online.  The ring's calls run bound with each row's bound
    # from its own shard's largest key norm (as JAX's ring does), so P =
    # exp(s - b) rounds against a b no single call has: its elements and
    # its largest error against the witness are printed, not held (its
    # root mean square error against the witness is), and the ring and
    # the zigzag run again with every call bounded by the whole
    # sequence's key norms (`cp_same_bound`), held on every element and
    # the witness.  Every run: the root mean square error against the
    # witness at most CP_F64_SLACK times the single call's.
    # feature: (keywords, paths, 3-D views)
    features = {
        "causal": ({}, tuple(paths), False),
        "window4096_sinks4": (dict(window=4096, sinks=4), tuple(paths),
                              True),
        "window1024_sinks4": (dict(window=1024, sinks=4),
                              ("ring", "zigzag"), True),
        "packed": (dict(q_segment_ids=ids, kv_segment_ids=ids),
                   ("allgather", "ring"), True)}
    worst = 0.0

    def grads(fn, args, kw):
        xs = [x.detach().requires_grad_() for x in args]
        out = fn(*xs, causal=True, **kw)
        out.backward(dout[0] if args[0].dim() == 3 else dout)
        torch.cuda.synchronize()
        return [out.detach()] + [x.grad for x in xs]

    def compare(got, want, exact, keys_seen):
        """({what: vs single}, {what: vs float64}, the checks beyond
        their limits, those of the root mean square error against the
        witness, dQ's rows beyond the limit and the most keys one of them
        sees)."""
        vs_single, bad, bad_rms = {}, [], []
        for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            if what == "out":
                err, ratio = mismatch(a, b)
            else:
                e, r = grad_ratios(a, b)
                err, ratio = e.max().item(), r.max().item()
                if what == "dq":
                    over = r.reshape(-1, s, d).amax(dim=(0, 2)) > 1.0
                    dq_over = dict(rows=int(over.sum()), most_keys_seen=int(
                        keys_seen.masked_fill(~over, 0).max()))
            vs_single[what] = dict(max_abs_err=err, share_of_limit=ratio)
            if not ratio <= 1.0:
                bad.append(what)
        group = h // hkv
        picks = [lambda t: t[:group], lambda t: t[:group],
                 lambda t: t[0], lambda t: t[0]]
        vs_f64 = {}
        for what, pick, a, b, x in zip(
                ("out", "dq", "dk", "dv"), picks,
                [t[0] if t.dim() == 4 else t for t in got],
                [t[0] if t.dim() == 4 else t for t in want], exact):
            err = (pick(a).double() - x).abs()
            one = (pick(b).double() - x).abs()
            rms = [err.square().mean().sqrt().item(),
                   one.square().mean().sqrt().item()]
            vs_f64[what] = dict(
                path=err.max().item(), single=one.max().item(),
                ratio=err.max().item() / one.max().item(), rms=rms,
                rms_ratio=rms[0] / rms[1])
            if not vs_f64[what]["ratio"] <= CP_F64_SLACK:
                bad.append(f"{what}_f64")
            if not vs_f64[what]["rms_ratio"] <= CP_F64_SLACK:
                bad_rms.append(f"{what}_f64_rms")
        return vs_single, vs_f64, bad, bad_rms, dq_over

    for feature, (kw, names, three_d) in features.items():
        args = [x[0] for x in (q, k, v)] if three_d else [q, k, v]
        want = exact = keys_seen = None
        if rank == 0:
            want = {mode: grads(flash_attention_diff, args,
                                {**kw, "max_mode": mode})
                    for mode in ("bound", "online")}
            g3 = [t[0] if t.dim() == 4 else t for t in
                  (*args, dout[0])]
            exact = cp_exact_group(
                *g3, scale=scale, window=kw.get("window"),
                sinks=kw.get("sinks"), ids=kw.get("q_segment_ids"))
            keys_seen = attention_mask(
                s, s, causal=True, window=kw.get("window"),
                sinks=kw.get("sinks"), q_segment_ids=kw.get("q_segment_ids"),
                kv_segment_ids=kw.get("kv_segment_ids"),
                device=q.device).sum(-1)
        for name in names:
            runs = [("default", pair) for pair in
                    ((False, True) if feature == "causal" else (False,))]
            if name in ("ring", "zigzag") and "window" not in kw:
                runs.append(("same_bound", False))
            for bound, pair in runs:
                same = bound == "same_bound"
                flash_bwd._FORCE_TWO_KERNEL = pair
                ops.reset_launch_counts()
                with cp_same_bound(k) if same else contextlib.nullcontext():
                    got = grads(paths[name], args, kw)
                counts = {kn: c for kn, c in ops.launch_counts().items()
                          if c}
                variants = ops.variant_counts().get("flash_fwd", {})
                flash_bwd._FORCE_TWO_KERNEL = False
                per = cp_launches(name, world)
                bwd = ({"flash_bwd_dq": per, "flash_bwd_dkv": per} if pair
                       else {"flash_bwd_fused": per})
                if counts != {"flash_fwd": per, **bwd} or len(variants) != 1:
                    failures.append(f"rank {rank} {name} {feature}: "
                                    f"launched {counts}, {variants}")
                if same and variants != {"bound": per}:
                    failures.append(f"{name} {feature} {bound}: {variants}")
                if not same:
                    for kn, c in counts.items():
                        launches[kn] = launches.get(kn, 0) + c
                finite = all(bool(t.isfinite().all()) for t in got)
                every = mesh.all_gather(cp_digest(got)[None], "sp", dim=0)
                if not (finite and all(torch.equal(every[0], x)
                                       for x in every)):
                    failures.append(f"{name} {feature}: finite {finite}, "
                                    f"digests {every.tolist()}")
                if rank:
                    continue
                ran = next(iter(variants))
                # the ring's own per-shard bounds: held on the witness's
                # root mean square error, the rest printed
                held_here = same or not (name == "ring" and ran == "bound")
                vs_single, vs_f64, bad, bad_rms, dq_over = compare(
                    got, want[ran], exact, keys_seen)
                if held_here:
                    worst = max(worst, *(r["max_abs_err"]
                                         for r in vs_single.values()))
                say(case="cp_op", path=name, feature=feature,
                    backward="pair" if pair else "fused", bound=bound,
                    shape=[h, hkv, s, d], launches=counts,
                    flash_fwd_variants=variants, single_call=ran,
                    held=held_here, vs_single_device=vs_single,
                    vs_f64=vs_f64, dq_rows_over_limit=dq_over,
                    same_bits_on_every_rank=True)
                bad = bad_rms + (bad if held_here else [])
                if bad:
                    failures.append(f"{name} {feature} {bound} "
                                    f"{'pair' if pair else 'fused'}: {bad}")
        dist.barrier()
    edges = [None] * world
    dist.all_gather_object(edges, cp_edges(rank, world, failures))
    for rec in (rec for rank_edges in edges for rec in rank_edges):
        say(case="cp_edge", **rec)
    return worst


def cp_edges(rank: int, world: int, failures: list) -> list:
    """The ring's backward calls where a shard sees nothing: every step
    of the contiguous ring over n = `CP_EDGE_ROWS` (the last shard partly
    padding; shards above the diagonal), and a shard all padding
    (``kv_valid`` 0): dK and dV exactly zero on every row that is
    padding or sees no query, dQ zero where nothing is seen, no NaN.
    Returns this rank's records."""
    from attention_tpu_torch.ops.flash_bwd import flash_backward
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl

    h, hkv, _, d = CP_OPS
    n = CP_EDGE_ROWS
    n_local = -(-n // world)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 37 + rank)
    qb, do = (torch.randn((h, n_local, d), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    cases = []
    for shard in range(world):
        valid = min(max(n - shard * n_local, 0), n_local)
        cases.append((f"ring_shard{shard}", shard * n_local, valid))
    cases.append(("all_padding", (world - 1) * n_local, 0))
    q_offset = rank * n_local
    records = []
    for case, kv_offset, valid in cases:
        kb, vb = (torch.randn((hkv, n_local, d), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        kw = dict(scale=d ** -0.5, causal=True, q_offset=q_offset,
                  kv_offset=kv_offset, kv_valid=valid)
        out, lse = _flash_fwd_impl(qb, kb, vb, **kw)
        dq, dk, dv = flash_backward(qb, kb, vb, out, lse, do, **kw)
        torch.cuda.synchronize()
        seen = min(valid, max(0, q_offset + n_local - kv_offset))
        finite = all(bool(t.isfinite().all()) for t in (dq, dk, dv))
        zero_tail = bool((dk[:, seen:] == 0).all()
                         and (dv[:, seen:] == 0).all())
        sees_none = seen == 0
        zero_dq = bool((dq == 0).all()) if sees_none else None
        rec = dict(edge=case, rank=rank, kv_offset=kv_offset,
                   q_offset=q_offset, kv_valid=valid, keys_seen=seen,
                   finite=finite, dkv_zero_past_seen=zero_tail,
                   dq_zero=zero_dq)
        if not (finite and zero_tail and zero_dq in (None, True)):
            failures.append(f"cp edge: {rec}")
        records.append(rec)
    return records


def cp_train(rank: int, world: int, say, launches: dict, single: dict,
             failures: list) -> None:
    """Part 2 of phase 3c: the serving model's widths at depth
    `CP_TRAIN_DEPTH` trained `CP_TRAIN_STEPS` steps under each cp_impl
    on the flat sp mesh of the world (and the ring and zigzag under
    `TRAIN_BAND`), then the ring on `make_mesh_3d` (dp 2 x sp 2): step
    1's loss against the single-device run's (``single``, by batch and
    band; `cp_single_device`), each parameter's step-1 gradient norm and
    step 2's loss against its, the loss and every parameter's bits the
    same on every rank after each step, launches exact; step ms, the
    collectives' share of the second step (`Mesh.timings`) and each
    rank's peak."""
    from attention_tpu_torch import ops
    from attention_tpu_torch.models import (
        TinyDecoder,
        init_train,
        make_mesh_3d,
        make_train_step,
    )
    from attention_tpu_torch.parallel.mesh import default_mesh

    flat, mesh3d = default_mesh("sp"), make_mesh_3d(world)
    for impl, band, mesh_name in CP_RUNS:
        mesh = mesh3d if mesh_name == "mesh3d" else flat
        batch_shape = CP_TRAIN_BATCH[mesh_name]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        batch = torch.randint(0, SERVE_MODEL["vocab"], batch_shape,
                              generator=gen, device="cuda")
        model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                            cp_axis="sp", cp_impl=impl, mesh=mesh,
                            **dict(SERVE_MODEL, depth=CP_TRAIN_DEPTH),
                            **(TRAIN_BAND if band else {}))
        optimizer = init_train(model, seed=SEED, lr=TRAIN_LR, mesh=mesh)
        step = make_train_step(model, optimizer, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, digests, coll = [], [], [], None
        ops.reset_launch_counts()
        for i in range(CP_TRAIN_STEPS):
            if i == CP_TRAIN_STEPS - 1:
                mesh.timings = {}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            losses.append(step(batch).item())
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            digests.append(cp_digest([p for p in model.parameters()]))
            if i == 0:
                norms = grad_norms(optimizer)
        coll, mesh.timings = mesh.timings, None
        counts = {kn: c for kn, c in ops.launch_counts().items() if c}
        per = (cp_launches(impl, mesh.shape["sp"]) * CP_TRAIN_DEPTH
               * CP_TRAIN_STEPS)
        if counts != {"flash_fwd": per, "flash_bwd_fused": per}:
            failures.append(f"rank {rank} {impl}: launched {counts}")
        for kn, c in counts.items():
            launches[kn] = launches.get(kn, 0) + c
        record = torch.tensor([*losses, torch.cuda.max_memory_allocated()],
                              dtype=torch.float64, device="cuda")
        bits = flat.all_gather(torch.stack(digests)[None], "sp", dim=0)
        every = flat.all_gather(record[None], "sp", dim=0)
        same = all(torch.equal(bits[0], x) for x in bits) and all(
            torch.equal(every[0, :-1], x[:-1]) for x in every)
        one = single[f"{mesh_name}_{'band' if band else 'dense'}"]
        want = one["losses"]
        rel, rel2 = (abs(losses[i] - want[i]) / abs(want[i]) for i in (0, 1))
        norm_err = {n: abs(x - one["grad_norms"][n]) / one["grad_norms"][n]
                    for n, x in norms.items()}
        worst = max(norm_err, key=norm_err.get)
        cell = f"{impl}{'_band' if band else ''}_{mesh_name}"
        say(case="cp_train", run=cell, shape=list(batch_shape),
            mesh=dict(mesh.shape), depth=CP_TRAIN_DEPTH, losses=losses,
            single_device_losses=want, step1_rel_err=rel,
            step2_rel_err=rel2,
            grad_norm_worst={"param": worst, "rel_err": norm_err[worst]},
            tol={"step1": CP_LOSS_RTOL, "step2": CP_STEP2_RTOL,
                 "grad_norm": CP_GRAD_NORM_RTOL},
            same_loss_and_weights_on_every_rank=same,
            step_ms=step_ms, single_device_step_ms=one["step_ms"],
            collectives_ms={
                kn: t * 1e3 for kn, t in coll.items()},
            collectives_share=sum(coll.values()) * 1e3 / step_ms[-1],
            peak_memory_gib=[x[-1].item() / 2**30 for x in every],
            launches=counts)
        if not (same and rel <= CP_LOSS_RTOL and rel2 <= CP_STEP2_RTOL
                and norm_err[worst] <= CP_GRAD_NORM_RTOL
                and all(np.isfinite(losses))):
            failures.append(f"cp train {cell}: losses {losses} against "
                            f"{want}, {worst} norm {norm_err[worst]}, "
                            f"same {same}")
        del model, optimizer, step
        torch.cuda.empty_cache()


def cp_f32(rank: int, say, failures: list) -> None:
    """Part 3 of phase 3c: phase 6's small f32 model (the FMA bodies)
    under each cp_impl on the flat sp mesh against its single-device
    step on the card, loss within `CP_F32_LOSS_RTOL`, every gradient
    within `CP_F32_GRAD_ATOL` (JAX's tests/test_cp.py tolerances)."""
    from attention_tpu_torch.models import (
        TinyDecoder,
        init_params,
        value_and_grad,
    )
    from attention_tpu_torch.parallel.mesh import default_mesh

    mesh = default_mesh("sp")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, SMALL_MODEL["vocab"], (2, 257))).cuda()
    one = TinyDecoder(dtype=torch.float32, device="cuda", **SMALL_MODEL)
    weights = init_params(one, SEED)
    one.load_state_dict(weights)
    want_loss, want = value_and_grad(one, tokens)
    for impl in CP_IMPLS:
        model = TinyDecoder(dtype=torch.float32, device="cuda",
                            cp_axis="sp", cp_impl=impl, mesh=mesh,
                            **SMALL_MODEL)
        model.load_state_dict(weights)
        loss, got = value_and_grad(model, tokens, mesh)
        rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        say(case="cp_f32", cp_impl=impl, loss=loss.item(),
            single_device_loss=want_loss.item(), loss_rel_err=rel,
            grads_max_abs_err=err, tol=[CP_F32_LOSS_RTOL, CP_F32_GRAD_ATOL])
        if not (rel <= CP_F32_LOSS_RTOL and err <= CP_F32_GRAD_ATOL):
            failures.append(f"cp f32 {impl}: loss {rel}, grads {err}")


def cp_rank(rank: int, world: int, init_file: str, out_file: str,
            single: dict) -> None:
    """One rank of phase 3c; rank 0 prints the lines and writes the
    launches and largest error to ``out_file``.  Every part runs to its
    end; the rank fails after them if a check failed."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)

    def say(**record):
        if rank == 0:
            emit(phase="cp_training", **record)

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        say(world=world, card=smi, backend=dist.get_backend())
        launches, failures = {}, []
        t0 = time.perf_counter()
        try:
            worst = cp_ops(rank, world, say, launches, failures)
        except Exception:
            traceback.print_exc()
            raise
        t1 = time.perf_counter()
        cp_train(rank, world, say, launches, single, failures)
        t2 = time.perf_counter()
        cp_f32(rank, say, failures)
        say(seconds={"ops": t1 - t0, "train": t2 - t1,
                     "f32": time.perf_counter() - t2})
        if failures:
            raise AssertionError(f"rank {rank}: {failures}")
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump(dict(launches=launches, max_abs_err=worst), f)
    finally:
        dist.destroy_process_group()


def grad_norms(optimizer) -> dict:
    """{name: L2 norm} of the float32 gradients a `MasterAdamW` step just
    applied (each master keeps its ``.grad`` until the next step)."""
    return {n: torch.linalg.vector_norm(optimizer.masters[n].grad).item()
            for n, _ in optimizer.named}


def cp_single_device() -> dict:
    """The single-device runs beside phase 3c's: the depth-
    `CP_TRAIN_DEPTH` model on each training batch (without and with
    `TRAIN_BAND` on one sequence), `CP_TRAIN_STEPS` steps of
    `make_train_step` from the same seeded start on the card: {run:
    {losses, step 1's gradient norms, step ms, peak GiB}}; every CP run
    is held against it."""
    from attention_tpu_torch.models import (
        TinyDecoder,
        init_train,
        make_train_step,
    )

    out = {}
    for key, band, shape in (("flat_dense", False, CP_TRAIN_BATCH["flat"]),
                             ("flat_band", True, CP_TRAIN_BATCH["flat"]),
                             ("mesh3d_dense", False,
                              CP_TRAIN_BATCH["mesh3d"])):
        model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                            **dict(SERVE_MODEL, depth=CP_TRAIN_DEPTH),
                            **(TRAIN_BAND if band else {}))
        optimizer = init_train(model, seed=SEED, lr=TRAIN_LR)
        step = make_train_step(model, optimizer)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        batch = torch.randint(0, SERVE_MODEL["vocab"], shape, generator=gen,
                              device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(CP_TRAIN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            losses.append(step(batch).item())
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            if len(losses) == 1:
                norms = grad_norms(optimizer)
        out[key] = dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del model, optimizer, step
        torch.cuda.empty_cache()
    return out


def phase_cp_training(kernels) -> None:
    """Spawn phase 3c's gloo world on the card; a failed rank fails the
    phase."""
    import torch.multiprocessing as mp

    from attention_tpu_torch.ops._native import BUILD_DIR

    t0 = time.perf_counter()
    single = cp_single_device()
    init = os.path.join(BUILD_DIR, f"cp-{os.getpid()}.init")
    out = os.path.join(BUILD_DIR, f"cp-{os.getpid()}.json")
    for stale in (init, out):
        if os.path.exists(stale):
            os.remove(stale)
    mp.spawn(cp_rank, nprocs=CP_WORLD, args=(CP_WORLD, init, out, single))
    with open(out) as f:
        rec = json.load(f)
    for kn, c in rec["launches"].items():
        kernels[kn]["launches"] += c
    emit(phase="cp_training", seconds=time.perf_counter() - t0,
         single_device=single, rank0_launches=rec["launches"])


# ------------------------------------------- phase 3d: mesh training layouts


def mesh_model_kw(kind: str) -> dict:
    """Phase 3d's model at the serving widths: dense at `CP_TRAIN_DEPTH`,
    `SERVE_MOE` at `MESH_MOE_DEPTH`, or the pipelined run's dense model
    at `PP_DEPTH`."""
    if kind == "moe":
        return dict(SERVE_MODEL, depth=MESH_MOE_DEPTH, **SERVE_MOE)
    return dict(SERVE_MODEL, depth=PP_DEPTH if kind == "pp"
                else CP_TRAIN_DEPTH)


def mesh_batch(shape) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    return torch.randint(0, SERVE_MODEL["vocab"], shape, generator=gen,
                         device="cuda")


def mesh_single_device() -> dict:
    """The single-device runs beside phase 3d's, on the card alone before
    the world starts: each (model, batch) of `MESH_RUNS` trained
    `CP_TRAIN_STEPS` steps of `make_train_step` from the seeded start:
    {key: {losses, step 1's gradient norms, step ms, peak GiB, float32
    state bytes}}, and the pipelined run's model on `TRAIN_BATCH` (key
    "pp").  The MoE model also runs with ``impl="xla"`` (the attention
    in PyTorch ops: a sound reordering of the forward), whose distance
    from the kernels' run (``"xla"``: each step's loss and the worst
    gradient norm, relative) bounds its mesh run's step 2."""
    from attention_tpu_torch.models import (
        TinyDecoder,
        init_train,
        make_train_step,
    )

    out = {}
    runs = [(f"{kind}_{shape[0]}x{shape[1]}", kind, shape)
            for _, kind, _, _, _, shape in MESH_RUNS]
    for key, kind, shape in runs + [("pp", "pp", TRAIN_BATCH)]:
        if key in out:
            continue
        for impl in ("flash", "xla") if kind == "moe" else ("flash",):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                                impl=impl, **mesh_model_kw(kind))
            optimizer = init_train(model, seed=SEED, lr=TRAIN_LR)
            step = make_train_step(model, optimizer)
            batch = mesh_batch(shape)
            losses, step_ms = [], []
            for _ in range(CP_TRAIN_STEPS):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in "se")
                start.record()
                losses.append(step(batch).item())
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
                if len(losses) == 1:
                    norms = grad_norms(optimizer)
            if impl == "xla":
                one = out[key]
                one["xla"] = dict(
                    losses=losses,
                    rel_err=[abs(a - b) / abs(b)
                             for a, b in zip(losses, one["losses"])],
                    grad_norm_rel_err=max(
                        abs(norms[n] - x) / x
                        for n, x in one["grad_norms"].items()))
            else:
                out[key] = dict(
                    losses=losses, grad_norms=norms, step_ms=step_ms,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    state_bytes=state_bytes(optimizer))
            del model, optimizer, step
            torch.cuda.empty_cache()
    return out


def state_bytes(optimizer) -> int:
    """The bytes of a `MasterAdamW`'s float32 masters and moments on this
    rank."""
    total = 0
    for _, m in optimizer.pairs():
        total += m.numel() * m.element_size()
        total += sum(t.numel() * t.element_size()
                     for k, t in optimizer.state[m].items() if k != "step")
    return total


def expert_state_share(optimizer, layout) -> float | None:
    """This rank's float32 state of the MoE experts (masters and
    moments) as a share of the whole experts' (None without experts)."""
    mine = whole = 0
    for n, _ in optimizer.named:
        if "experts" in n:
            m = optimizer.masters[n]
            mine += m.numel() + sum(t.numel() for k, t in
                                    optimizer.state[m].items() if k != "step")
            whole += 3 * int(np.prod(layout.shapes[n]))
    return mine / whole if whole else None


def mesh_grad_norms(optimizer, layout) -> dict:
    """{name: L2 norm of the whole float32 gradient} from this rank's
    blocks (each master's ``.grad``): the blocks' sums of squares summed
    over every axis that splits the parameter (a replicated value divided
    by the axis's size first, exactly), then the root."""
    names = [n for n, _ in optimizer.named]
    sq = torch.stack([optimizer.masters[n].grad.double().square().sum()
                      for n in names])
    for axis in ("dp", "sp", "tp"):
        size = layout.mesh.shape.get(axis, 1)
        if size == 1:
            continue
        split = torch.tensor([layout.split(n, axis) for n in names],
                             device=sq.device)
        sq = layout.mesh.all_reduce(torch.where(split, sq, sq / size), axis)
    return {n: v.sqrt().item() for n, v in zip(names, sq)}


def mesh_train(rank: int, world: int, say, launches: dict, single: dict,
               failures: list) -> None:
    """Phase 3d's runs (`MESH_RUNS`): each model trained `CP_TRAIN_STEPS`
    steps on its mesh, held to its single-device run: step 1's loss
    within `CP_LOSS_RTOL`, step 2's within `CP_STEP2_RTOL` (the MoE
    run's within `MESH_MOE_STEP2_RTOL`), every parameter's whole step-1
    gradient norm within `CP_GRAD_NORM_RTOL`; the losses the same on
    every rank, and each block the same bits on every rank that holds it
    (every rank for a replicated parameter);
    the flash forward and the fused backward launched exactly once a
    layer a step on each rank (the ring's count under sp); step ms, the
    collectives' share of the second step (`Mesh.timings`), each rank's
    peak and float32 state bytes beside the whole model's."""
    from attention_tpu_torch import ops
    from attention_tpu_torch.models import (
        TinyDecoder,
        init_train,
        make_train_step,
    )
    from attention_tpu_torch.parallel.mesh import default_mesh, grid_mesh

    every_rank = default_mesh("world")
    for run, kind, sizes, kw, fsdp, shape in MESH_RUNS:
        mesh = grid_mesh(("dp", "sp", "tp"), sizes)
        model_kw = mesh_model_kw(kind)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = TinyDecoder(dtype=torch.bfloat16, device="cuda", mesh=mesh,
                            **model_kw, **kw)
        optimizer = init_train(model, seed=SEED, lr=TRAIN_LR, mesh=mesh,
                               fsdp=fsdp)
        layout = model.layout
        step = make_train_step(model, optimizer, mesh)
        batch = mesh_batch(shape)
        losses, step_ms = [], []
        ops.reset_launch_counts()
        for i in range(CP_TRAIN_STEPS):
            if i == CP_TRAIN_STEPS - 1:
                mesh.timings = {}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            losses.append(step(batch).item())
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            if i == 0:
                norms = mesh_grad_norms(optimizer, layout)
        coll, mesh.timings = mesh.timings, None
        counts = {kn: c for kn, c in ops.launch_counts().items() if c}
        per = (cp_launches(kw.get("cp_impl", "allgather"), sizes[1])
               * model_kw["depth"] * CP_TRAIN_STEPS)
        if counts != {"flash_fwd": per, "flash_bwd_fused": per}:
            failures.append(f"rank {rank} {run}: launched {counts}, want "
                            f"{per} each")
        for kn, c in counts.items():
            launches[kn] = launches.get(kn, 0) + c
        names = [n for n, _ in model.named_parameters()]
        digests = torch.stack([cp_digest([p]) for _, p in
                               model.named_parameters()])
        coords = torch.tensor(
            [[mesh.index(a) if a is not None else -1
              for a in layout.specs[n] + (None,) * (3 - len(layout.specs[n]))]
             for n in names], device="cuda")
        mine = state_bytes(optimizer)
        experts = expert_state_share(optimizer, layout)
        record = torch.tensor([*losses, torch.cuda.max_memory_allocated(),
                               mine], dtype=torch.float64, device="cuda")
        every = every_rank.all_gather(record[None], "world", dim=0)
        bits = every_rank.all_gather(digests[None], "world", dim=0)
        where = every_rank.all_gather(coords[None], "world", dim=0)
        same_loss = all(torch.equal(every[0, :CP_TRAIN_STEPS],
                                    x[:CP_TRAIN_STEPS]) for x in every)
        parted, replicated = [], 0
        for j, n in enumerate(names):
            groups = {}
            for r in range(world):
                groups.setdefault(tuple(where[r, j].tolist()), []).append(r)
            replicated += len(groups) == 1
            for ranks in groups.values():
                if any(not torch.equal(bits[ranks[0], j], bits[r, j])
                       for r in ranks[1:]):
                    parted.append(n)
        one = single[f"{kind}_{shape[0]}x{shape[1]}"]
        want = one["losses"]
        rel, rel2 = (abs(losses[i] - want[i]) / abs(want[i]) for i in (0, 1))
        step2_tol = MESH_MOE_STEP2_RTOL if kind == "moe" else CP_STEP2_RTOL
        norm_err = {n: abs(x - one["grad_norms"][n]) / one["grad_norms"][n]
                    for n, x in norms.items()}
        worst = max(norm_err, key=norm_err.get)
        per_rank = [x[-1].item() for x in every]
        say(case="mesh_train", run=run, mesh=dict(mesh.shape), fsdp=fsdp,
            model=model_kw, shape=list(shape), losses=losses,
            single_device_losses=want, step1_rel_err=rel,
            step2_rel_err=rel2,
            grad_norm_worst={"param": worst, "rel_err": norm_err[worst]},
            tol={"step1": CP_LOSS_RTOL, "step2": step2_tol,
                 "grad_norm": CP_GRAD_NORM_RTOL},
            single_device_xla=one.get("xla"),
            same_loss_on_every_rank=same_loss,
            blocks_parted_between_ranks=parted,
            replicated_params=replicated,
            step_ms=step_ms, single_device_step_ms=one["step_ms"],
            collectives_ms={kn: t * 1e3 for kn, t in coll.items()},
            collectives_share=sum(coll.values()) * 1e3 / step_ms[-1],
            peak_memory_gib=[x[-2].item() / 2**30 for x in every],
            single_device_peak_gib=one["peak_gib"],
            state_bytes_per_rank=per_rank,
            single_device_state_bytes=one["state_bytes"],
            state_share_per_rank=[b / one["state_bytes"] for b in per_rank],
            expert_state_share_rank0=experts,
            launches=counts)
        if not (same_loss and not parted and rel <= CP_LOSS_RTOL
                and rel2 <= step2_tol
                and norm_err[worst] <= CP_GRAD_NORM_RTOL
                and all(np.isfinite(losses))):
            failures.append(f"mesh train {run}: losses {losses} against "
                            f"{want}, {worst} norm {norm_err[worst]}, "
                            f"same loss {same_loss}, parted {parted}")
        if fsdp and max(per_rank) > 1.1 * one["state_bytes"] / (
                sizes[0] * sizes[2]):
            failures.append(f"mesh train {run}: state bytes {per_rank} of "
                            f"{one['state_bytes']} over 1/(dp tp)")
        ep = kw.get("ep_axis")
        if ep is not None and not fsdp and experts != 1 / mesh.shape[ep]:
            failures.append(f"mesh train {run}: rank {rank} holds "
                            f"{experts} of the experts' state, not 1/"
                            f"{mesh.shape[ep]}")
        del model, optimizer, step, layout
        torch.cuda.empty_cache()


def pipeline_train(rank: int, world: int, say, launches: dict, single: dict,
                   failures: list) -> None:
    """Phase 3d's pipelined run: the serving model at `PP_DEPTH` on
    ("pp",) of ``world`` ranks, `TRAIN_BATCH` in `PP_MICRO` microbatches,
    `CP_TRAIN_STEPS` steps of `make_pipelined_train_step` from
    `init_pipelined_train`'s seeded start, held to the single device's
    `make_train_step` run by phase 3c's bars (step 1, step 2, every
    parameter's step-1 gradient norm, each from the rank whose stage
    holds it); the losses the same on every rank and the replicated
    embedding, norm and head the same bits after each step; the flash
    forward and the fused backward launched exactly once a block a
    microbatch a step; step ms, the point-to-point and collective share
    of the second step (`Mesh.timings`), each rank's peak and float32
    state beside the single device's."""
    from attention_tpu_torch import ops
    from attention_tpu_torch.models import (
        TinyDecoder,
        init_pipelined_train,
        make_pipelined_train_step,
    )
    from attention_tpu_torch.parallel.mesh import default_mesh, grid_mesh

    every_rank = default_mesh("world")
    mesh = grid_mesh(("pp",), (world,))
    model_kw = mesh_model_kw("pp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **model_kw)
    optimizer = init_pipelined_train(model, mesh, seed=SEED, lr=TRAIN_LR)
    step = make_pipelined_train_step(model, optimizer, mesh,
                                     n_micro=PP_MICRO)
    batch = mesh_batch(TRAIN_BATCH)
    replicated = [p for n, p in model.named_parameters()
                  if not n.startswith("blocks.")]
    losses, step_ms, same_bits = [], [], []
    ops.reset_launch_counts()
    for i in range(CP_TRAIN_STEPS):
        if i == CP_TRAIN_STEPS - 1:
            mesh.timings = {}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        losses.append(step(batch).item())
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        if i == 0:
            norms = grad_norms(optimizer)
        bits = every_rank.all_gather(cp_digest(replicated)[None], "world",
                                     dim=0)
        same_bits.append(all(torch.equal(bits[0], b) for b in bits))
    coll, mesh.timings = mesh.timings, None
    counts = {kn: c for kn, c in ops.launch_counts().items() if c}
    per = PP_DEPTH // world * PP_MICRO * CP_TRAIN_STEPS
    if counts != {"flash_fwd": per, "flash_bwd_fused": per}:
        failures.append(f"rank {rank} pp: launched {counts}, want {per} "
                        "each")
    for kn, c in counts.items():
        launches[kn] = launches.get(kn, 0) + c
    # each parameter's norm from the rank that holds it (the replicated
    # ones from every rank: the same bits)
    names = [n for n, _ in model.named_parameters()]
    held = torch.tensor([norms.get(n, -1.0) for n in names],
                        dtype=torch.float64, device="cuda")
    held = every_rank.all_reduce(held, "world", "max")
    whole_norms = dict(zip(names, held.tolist()))
    record = torch.tensor([*losses, torch.cuda.max_memory_allocated(),
                           state_bytes(optimizer)], dtype=torch.float64,
                          device="cuda")
    every = every_rank.all_gather(record[None], "world", dim=0)
    same_loss = all(torch.equal(every[0, :CP_TRAIN_STEPS],
                                x[:CP_TRAIN_STEPS]) for x in every)
    one = single["pp"]
    want = one["losses"]
    rel, rel2 = (abs(losses[i] - want[i]) / abs(want[i]) for i in (0, 1))
    norm_err = {n: abs(x - one["grad_norms"][n]) / one["grad_norms"][n]
                for n, x in whole_norms.items()}
    worst = max(norm_err, key=norm_err.get)
    per_rank = [x[-1].item() for x in every]
    say(case="pipeline_train", run="pp4", mesh=dict(mesh.shape),
        model=model_kw, shape=list(TRAIN_BATCH), n_micro=PP_MICRO,
        bubble_share=(world - 1) / (PP_MICRO + world - 1), losses=losses,
        single_device_losses=want, step1_rel_err=rel, step2_rel_err=rel2,
        grad_norm_worst={"param": worst, "rel_err": norm_err[worst]},
        block_grad_norm_rel_err={n: e for n, e in norm_err.items()
                                 if n.startswith("blocks.")},
        tol={"step1": CP_LOSS_RTOL, "step2": CP_STEP2_RTOL,
             "grad_norm": CP_GRAD_NORM_RTOL},
        same_loss_on_every_rank=same_loss,
        replicated_same_bits_after_each_step=same_bits,
        step_ms=step_ms, single_device_step_ms=one["step_ms"],
        collectives_ms={kn: t * 1e3 for kn, t in coll.items()},
        collectives_share=sum(coll.values()) * 1e3 / step_ms[-1],
        peak_memory_gib=[x[-2].item() / 2**30 for x in every],
        single_device_peak_gib=one["peak_gib"],
        state_bytes_per_rank=per_rank,
        single_device_state_bytes=one["state_bytes"],
        state_share_per_rank=[b / one["state_bytes"] for b in per_rank],
        launches=counts)
    if not (same_loss and all(same_bits) and rel <= CP_LOSS_RTOL
            and rel2 <= CP_STEP2_RTOL
            and norm_err[worst] <= CP_GRAD_NORM_RTOL
            and all(np.isfinite(losses))):
        failures.append(f"pp: losses {losses} against {want}, {worst} norm "
                        f"{norm_err[worst]}, same loss {same_loss}, "
                        f"replicated bits equal {same_bits}")
    del model, optimizer, step, replicated
    torch.cuda.empty_cache()


def recovery_batch(step: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(SEED + 40 + step).integers(
        0, SMALL_MODEL["vocab"], RECOVERY_BATCH))


def recovery_run(rank: int, ckpt_dir: str, launches: dict, *,
                 crash: int = 0) -> torch.Tensor:
    """`train_with_recovery` of the small bf16 model on (2, 1, 2) with
    FSDP on the dQ + dK/dV pair, to `RECOVERY_STEPS` (every rank dying
    by ``os._exit(17)`` after ``crash`` steps of this call, if set);
    the launches of its steps join ``launches``.  Returns the digest of
    the whole float32 masters, gathered on every rank."""
    import torch.distributed as dist

    from attention_tpu_torch import ops
    from attention_tpu_torch.models import TinyDecoder, train_with_recovery
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.parallel.mesh import grid_mesh

    mesh = grid_mesh(("dp", "sp", "tp"), (2, 1, 2))
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **SMALL_MODEL)
    done = [0]

    def on_step(step, loss):
        done[0] += 1
        if crash and done[0] >= crash:
            dist.barrier()
            os._exit(17)  # every rank at the same step, no cleanup

    flash_bwd._FORCE_TWO_KERNEL = True
    ops.reset_launch_counts()
    try:
        optimizer, losses = train_with_recovery(
            model, mesh, recovery_batch, steps=RECOVERY_STEPS,
            ckpt_dir=ckpt_dir, ckpt_every=RECOVERY_EVERY, seed=SEED,
            lr=TRAIN_LR, fsdp=True, on_step=on_step)
    finally:
        flash_bwd._FORCE_TWO_KERNEL = False
    counts = {kn: c for kn, c in ops.launch_counts().items() if c}
    per = SMALL_MODEL["depth"] * len(losses)
    if counts != {"flash_fwd": per, "flash_bwd_dq": per,
                  "flash_bwd_dkv": per}:
        raise AssertionError(f"rank {rank} recovery: launched {counts}")
    for kn, c in counts.items():
        launches[kn] = launches.get(kn, 0) + c
    whole = [model.layout.whole(n, m)
             for (n, _), (_, m) in zip(optimizer.named, optimizer.pairs())]
    return cp_digest(whole), losses


def mesh_rank(rank: int, world: int, init_file: str, out_file: str,
              single: dict, ckpt_dir: str) -> None:
    """One rank of phase 3d's first world: the runs, the uninterrupted
    recovery run, then the crashed one (every rank exits 17 after
    `RECOVERY_CRASH` steps).  Rank 0 prints the lines and writes the
    launches and the uninterrupted run's digest and losses to
    ``out_file`` before the crash."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)

    def say(**record):
        if rank == 0:
            emit(phase="mesh_training", **record)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(world=world, card=smi, backend=dist.get_backend())
    launches, failures = {}, []
    t0 = time.perf_counter()
    mesh_train(rank, world, say, launches, single, failures)
    t_pp = time.perf_counter()
    pipeline_train(rank, world, say, launches, single, failures)
    t1 = time.perf_counter()
    digest, losses = recovery_run(rank, os.path.join(ckpt_dir, "ref"),
                                  launches)
    if failures:
        raise AssertionError(f"rank {rank}: {failures}")
    if rank == 0:
        with open(out_file, "w") as f:
            json.dump(dict(launches=launches, digest=digest.tolist(),
                           losses=losses, seconds={
                               "runs": t_pp - t0, "pipeline": t1 - t_pp,
                               "recovery": time.perf_counter() - t1}), f)
    dist.barrier()
    recovery_run(rank, os.path.join(ckpt_dir, "crash"), {},
                 crash=RECOVERY_CRASH)
    raise AssertionError(f"rank {rank} outlived its crash")


def resume_rank(rank: int, world: int, init_file: str, out_file: str,
                ckpt_dir: str) -> None:
    """One rank of phase 3d's second world: `train_with_recovery` resumed
    from the crashed run's checkpoints; rank 0 writes the digest, the
    losses of the steps it ran and its launches to ``out_file``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        launches = {}
        digest, losses = recovery_run(rank, os.path.join(ckpt_dir, "crash"),
                                      launches)
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump(dict(digest=digest.tolist(), losses=losses,
                               launches=launches), f)
    finally:
        dist.destroy_process_group()


def spawned(fn, args, want_code: int) -> None:
    """Run ``fn(rank, MESH_WORLD, *args)`` on a world of `MESH_WORLD`
    processes; every rank must exit with ``want_code``.  A rank that
    exits otherwise stops the others (they would wait in a collective)
    and fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, nprocs=MESH_WORLD, join=False,
                   args=(MESH_WORLD, *args))
    while any(p.exitcode is None for p in ctx.processes):
        if any(p.exitcode not in (None, want_code) for p in ctx.processes):
            for p in ctx.processes:
                p.kill()
            break
        time.sleep(0.5)
    for p in ctx.processes:
        p.join()
    codes = [p.exitcode for p in ctx.processes]
    if codes != [want_code] * MESH_WORLD:
        errors = []
        for path in ctx.error_files:  # a rank's traceback, where it raised
            if os.path.exists(path) and os.path.getsize(path):
                with open(path, "rb") as f:
                    errors.append(pickle.load(f))
        raise AssertionError(f"{fn.__name__}: exit codes {codes}, want "
                             f"{want_code} on every rank; {errors}")


def phase_mesh_training(kernels) -> None:
    """Phase 3d: the single-device runs on the card alone, then a gloo
    world of `MESH_WORLD` ranks on the one card (`mesh_rank`: the runs,
    the uninterrupted recovery run, the crashed one), then a second world
    resuming (`resume_rank`), whose masters must be the uninterrupted
    run's bits; a rank that fails, or exits otherwise than the crash,
    fails the phase."""
    from attention_tpu_torch.ops._native import BUILD_DIR

    t0 = time.perf_counter()
    single = mesh_single_device()
    t1 = time.perf_counter()
    init = os.path.join(BUILD_DIR, f"mesh-{os.getpid()}.init")
    resume_init = os.path.join(BUILD_DIR, f"mesh-resume-{os.getpid()}.init")
    out = os.path.join(BUILD_DIR, f"mesh-{os.getpid()}.json")
    resumed = os.path.join(BUILD_DIR, f"mesh-resume-{os.getpid()}.json")
    for stale in (init, resume_init, out, resumed):
        if os.path.exists(stale):
            os.remove(stale)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        spawned(mesh_rank, (init, out, single, ckpt_dir), 17)
        spawned(resume_rank, (resume_init, resumed, ckpt_dir), 0)
    with open(out) as f:
        rec = json.load(f)
    with open(resumed) as f:
        res = json.load(f)
    same = res["digest"] == rec["digest"]
    emit(phase="mesh_training", case="recovery", mesh=[2, 1, 2], fsdp=True,
         backward="pair", steps=RECOVERY_STEPS, crash_after=RECOVERY_CRASH,
         uninterrupted_losses=rec["losses"], resumed_losses=res["losses"],
         masters_same_bits=same)
    if not (same and res["losses"]
            == rec["losses"][RECOVERY_STEPS - len(res["losses"]):]
            and len(res["losses"]) == RECOVERY_STEPS - RECOVERY_EVERY):
        raise AssertionError(f"mesh resume: digests {res['digest']} against "
                             f"{rec['digest']}, losses {res['losses']} "
                             f"against {rec['losses']}")
    for kn, c in rec["launches"].items():
        kernels[kn]["launches"] += c
    for kn, c in res["launches"].items():
        kernels[kn]["launches"] += c
    emit(phase="mesh_training", seconds=time.perf_counter() - t0,
         single_device_seconds=t1 - t0, world_seconds=rec["seconds"],
         single_device=single, rank0_launches=rec["launches"])


@contextlib.contextmanager
def watched(model):
    """CUDA events around every forward call of ``model``, and a count,
    kept on the card, of the non-finite logits those calls returned."""
    calls = []
    bad = torch.zeros((), dtype=torch.int64, device="cuda")

    def pre(mod, args):
        calls.append([torch.cuda.Event(enable_timing=True)])
        calls[-1][0].record()

    def post(mod, args, out):
        logits = out[0] if isinstance(out, tuple) else out
        bad.add_((~torch.isfinite(logits)).sum())
        calls[-1].append(torch.cuda.Event(enable_timing=True))
        calls[-1][1].record()

    hooks = (model.register_forward_pre_hook(pre),
             model.register_forward_hook(post))
    try:
        yield calls, bad
    finally:
        for hk in hooks:
            hk.remove()


def trace_prompts(vocab: int):
    """The serving trace's 8 prompts (128-1024 tokens) right-padded into
    one (8, S_max) batch, with their lengths."""
    from attention_tpu_torch.engine import synthetic_trace

    prompts = [e["prompt"] for e in synthetic_trace(
        8, vocab=vocab, seed=SEED, prompt_len_min=128, prompt_len_max=1024,
        max_tokens=GEN_STEPS, arrival_every=0)]
    lens = [len(p) for p in prompts]
    batch = np.zeros((len(prompts), max(lens)), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    return torch.from_numpy(batch).cuda(), torch.tensor(lens)


def phase_generate(ops, kernels, model) -> None:
    """The three generate functions at full width, greedy, 32 steps:
    `generate` on 8 equal prompts of 512 tokens, `generate_ragged` and
    `generate_paged` on the serving trace's prompts."""
    from attention_tpu_torch.models import decode as gen

    equal = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model.vocab, (8, 512))).cuda()
    ragged, lens = trace_prompts(model.vocab)
    runs = {
        "generate": lambda: gen.generate(model, equal, steps=GEN_STEPS),
        "generate_int8": lambda: gen.generate(model, equal, steps=GEN_STEPS,
                                              int8_cache=True),
        "generate_ragged": lambda: gen.generate_ragged(
            model, ragged, lens, steps=GEN_STEPS),
        "generate_paged": lambda: gen.generate_paged(
            model, ragged, lens, steps=GEN_STEPS)[0],
    }
    kernel_of = {"generate": "decode", "generate_int8": "quant_decode",
                 "generate_ragged": "decode",
                 "generate_paged": "paged_decode"}
    tokens = generate_runs(ops, kernels, model, runs, kernel_of,
                           dict(generate=equal.numel(),
                                generate_int8=equal.numel(),
                                generate_ragged=int(lens.sum()),
                                generate_paged=int(lens.sum())))
    share = (tokens["generate_ragged"] == tokens["generate_paged"]) \
        .float().mean().item()
    int8_share = (tokens["generate_int8"] == tokens["generate"]) \
        .float().mean().item()
    emit(phase="generate", ragged_vs_paged_equal_token_share=share,
         int8_vs_bf16_equal_token_share=int8_share)
    phase_chunk_verify(ops, kernels, model, equal)


def generate_runs(ops, kernels, model, runs, kernel_of, prompt_tokens):
    """Each of ``runs`` (name: a generate call of ``model``) once, its
    launch counts reset just before and read just after: the flash kernel
    once per layer for the prefill and ``kernel_of[name]`` once per layer
    per step, nothing else; every logit finite.  Returns {name: tokens}."""
    tokens = {}
    for name, run in runs.items():
        with watched(model) as (calls, bad):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
        step_ms = [a.elapsed_time(b) for a, b in calls[1:]]
        want = {"flash_fwd": model.depth,
                kernel_of[name]: GEN_STEPS * model.depth}
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"{name} launches {launches}, want {want}")
        if toks.shape != (8, GEN_STEPS) or int(bad):
            raise AssertionError(f"{name}: tokens {tuple(toks.shape)}, "
                                 f"{int(bad)} non-finite logits")
        kernels[kernel_of[name]]["launches"] += launches[kernel_of[name]]
        tokens[name] = toks
        emit(phase="generate", run=name, wall_ms=wall * 1e3,
             prefill_ms=calls[0][0].elapsed_time(calls[0][1]),
             decode_step_ms=statistics.median(step_ms),
             tokens_per_s=toks.numel() / wall, launches=launches,
             prompt_tokens=prompt_tokens[name])
    return tokens


def phase_chunk_verify(ops, kernels, model, equal) -> None:
    """A speculative-verify chunk of 4 tokens on int8 caches: one model
    call, the int8 kernel once per layer in chunk mode."""
    from attention_tpu_torch.models import decode as gen

    chunk = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, model.vocab, (8, 4))).cuda()
    with torch.no_grad():
        caches = tuple(c.quantize() for c in gen.prefill(
            model, equal, equal.shape[1] + 128)[1])
        ops.reset_launch_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        logits, caches = model(chunk, caches)
        end.record()
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    if {k: v for k, v in launches.items() if v} != {
            "quant_decode": model.depth} or not logits.isfinite().all() \
            or caches[0].length != equal.shape[1] + 4:
        raise AssertionError(f"int8 chunk verify: launches {launches}")
    kernels["quant_decode"]["launches"] += launches["quant_decode"]
    emit(phase="generate", run="int8_chunk_verify", chunk=list(chunk.shape),
         ms=start.elapsed_time(end), launches=launches)


def phase_window_generate(ops, kernels, model) -> None:
    """The windowed serving model (`SERVE_BAND`) at full width, greedy,
    32 steps: `generate(rolling_cache=True)` and the full-cache
    `generate` on phase 4's 8 prompts of 512 tokens (the ring of 260
    slots wraps), `generate_paged` on the trace's prompts (rope + sinks
    through `paged_sink_decode`) and `generate(int8_cache=True)` (the int8
    sink rotation); launch counts as in phase 4.  The ring and the full
    cache share the prefill's bits, so the first tokens must agree; the
    decode kernels then sum in another order (the ring's slots against
    the band's positions), and bf16 rounding parts a share of the greedy
    streams, printed (the f32 model of phase 6 must agree in full)."""
    from attention_tpu_torch.models import decode as gen

    t0 = time.perf_counter()
    equal = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model.vocab, (8, 512))).cuda()
    ragged, lens = trace_prompts(model.vocab)
    runs = {
        "window_rolling": lambda: gen.generate(
            model, equal, steps=GEN_STEPS, rolling_cache=True),
        "window_generate": lambda: gen.generate(model, equal,
                                                steps=GEN_STEPS),
        "window_generate_paged": lambda: gen.generate_paged(
            model, ragged, lens, steps=GEN_STEPS)[0],
        "window_generate_int8": lambda: gen.generate(
            model, equal, steps=GEN_STEPS, int8_cache=True),
    }
    tokens = generate_runs(
        ops, kernels, model, runs,
        dict(window_rolling="decode", window_generate="decode",
             window_generate_paged="paged_decode",
             window_generate_int8="quant_decode"),
        dict(window_rolling=equal.numel(), window_generate=equal.numel(),
             window_generate_paged=int(lens.sum()),
             window_generate_int8=equal.numel()))
    rolling, full = tokens["window_rolling"], tokens["window_generate"]
    if not torch.equal(rolling[:, 0], full[:, 0]):
        raise AssertionError("the ring's first tokens differ from the full "
                             "cache's")
    emit(phase="generate", model=SERVE_BAND,
         rolling_vs_full_cache_equal_token_share=(rolling == full).float()
         .mean().item(), seconds=time.perf_counter() - t0)


def serving_trace(vocab: int):
    """The serving phases' trace: 8 greedy requests at once, 128-1024
    prompt tokens, 32 output tokens each."""
    from attention_tpu_torch.engine import synthetic_trace

    return synthetic_trace(8, vocab=vocab, seed=SEED, prompt_len_min=128,
                           prompt_len_max=1024, max_tokens=32,
                           arrival_every=0)


def phase_serving(ops, kernels, model) -> None:
    trace = serving_trace(model.vocab)
    streams = serve_runs(ops, kernels, trace,
                         [("ragged", "ragged_paged", model),
                          ("two_call", "paged_decode", model)])
    same = [a == b for e in trace for a, b in zip(
        streams["ragged"][e["id"]], streams["two_call"][e["id"]])]
    emit(phase="serving", two_call_vs_ragged_equal_token_share=sum(same)
         / len(same))


def phase_window_serving(ops, kernels, model, model_no_sinks) -> None:
    """The windowed serving model in two-call mode (its rope + sinks
    decode through `paged_sink_decode`; the packed step refuses them),
    and the same model without sinks in ragged mode (the ragged kernel
    with the band)."""
    t0 = time.perf_counter()
    serve_runs(ops, kernels, serving_trace(model.vocab),
               [("two_call", "paged_decode", model),
                ("ragged", "ragged_paged", model_no_sinks)])
    emit(phase="serving", window_seconds=time.perf_counter() - t0)


def serve_runs(ops, kernels, trace, runs, **engine_kw) -> dict:
    """Each (step mode, its kernel, model) of ``runs`` serving ``trace``
    at `SERVE_ENGINE` (with ``engine_kw``), its launch counts reset just
    before and read just after: one launch of the kernel per layer per
    model call and no other kernel, every request finished, every logit
    finite.  Returns {mode: outputs}."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
    )

    streams = {}
    for mode, kernel, model in runs:
        eng = ServingEngine(model, EngineConfig(**dict(
            SERVE_ENGINE, step_mode=mode, **engine_kw)))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary, outputs = replay(eng, trace, max_steps=500)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        if not all(len(outputs.get(e["id"], [])) == 32 for e in trace):
            raise AssertionError(f"{mode}: unfinished requests: "
                                 f"{ {k: len(v) for k, v in outputs.items()} }")
        # one model call per busy step (two_call: per non-empty half of
        # it), one kernel launch per layer per call, and no other kernel
        calls = sum(bool(m.decode_tokens) + bool(m.prefill_tokens)
                    if mode == "two_call"
                    else bool(m.decode_tokens or m.prefill_tokens)
                    for m in eng.metrics.steps)
        if eng.model_calls != calls or {
                k: v for k, v in launches.items() if v} != {
                kernel: calls * model.depth}:
            raise AssertionError(f"{mode}: launches {launches} for "
                                 f"{eng.model_calls} model calls")
        if eng.nonfinite_events:
            raise AssertionError(f"{mode}: {eng.nonfinite_events} "
                                 "non-finite logits")
        kernels[kernel]["launches"] += launches[kernel]
        streams[mode] = outputs
        emit(phase="serving", step_mode=mode,
             async_steps=eng.config.async_steps,
             temperature=trace[0]["temperature"], window=model.window,
             sinks=model.attn_sinks, experts=model.moe_experts,
             steps=summary["num_steps"],
             model_calls=eng.model_calls, launches=launches,
             prompt_tokens=summary["prompt_tokens"],
             output_tokens=summary["output_tokens"], wall_s=wall,
             output_tokens_per_s=summary["output_tokens"] / wall,
             median_step_ms=summary["median_step_ms"],
             mean_host_overhead_ms=summary["mean_host_overhead_ms"],
             pad_tokens=summary["pad_tokens_total"],
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    return streams


def served(ops, kernels, eng, run):
    """``run()`` on ``eng`` with the launch counts reset just before and
    read just after: one ragged launch per layer per model call it made,
    at least one, and no other kernel."""
    calls = eng.model_calls
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    want = (eng.model_calls - calls) * eng.model.depth
    if not want or launches != {"ragged_paged": want}:
        raise AssertionError(f"launches {launches} for "
                             f"{eng.model_calls - calls} model calls")
    kernels["ragged_paged"]["launches"] += want
    return out


def equal_share(got: dict, want: dict) -> float:
    same = [a == b for rid in want for a, b in zip(got[rid], want[rid])]
    return sum(same) / len(same)


def phase_durability(ops, kernels, model) -> None:
    """Phase 5e: the serving engine's async loop and durability at
    `SERVE_ENGINE` on the serving trace (pools of 512 MiB)."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        RequestState,
        ServingEngine,
        SnapshotManager,
        recover_engine,
        state_fingerprint,
    )
    from attention_tpu_torch.engine.sim import sampling_of
    from attention_tpu_torch.engine.snapshot import (
        list_snapshots,
        restore,
        save,
    )

    t_phase = time.perf_counter()
    trace = serving_trace(model.vocab)
    ragged = [("ragged", "ragged_paged", model)]
    # (1) async against sync: greedy in turns (sync, async, async, sync),
    # then sampled with a seed per request; the two-call oracle sampled
    runs = [serve_runs(ops, kernels, trace, ragged, async_steps=a)["ragged"]
            for a in (False, True, True, False)]
    if any(r != runs[0] for r in runs):
        raise AssertionError("greedy async streams differ from sync")
    uninterrupted = runs[0]
    sampled = [dict(e, temperature=SERVE_TEMPERATURE) for e in trace]
    s_sync, s_async = (
        serve_runs(ops, kernels, sampled, ragged, async_steps=a)["ragged"]
        for a in (False, True))
    if s_async != s_sync:
        raise AssertionError("sampled async streams differ from sync")
    two_call = serve_runs(ops, kernels, sampled,
                          [("two_call", "paged_decode", model)])
    emit(phase="durability", async_equals_sync=True,
         sampled_two_call_vs_ragged_equal_token_share=equal_share(
             two_call["two_call"], s_sync))

    config = EngineConfig(**dict(SERVE_ENGINE, async_steps=True))
    streamed: dict[str, list[int]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (2) a snapshot cut inside decode, restored into a fresh engine
        snaps = os.path.join(tmp, "snaps")
        eng = ServingEngine(model, config, on_token=lambda r, t: streamed
                            .setdefault(r.request_id, []).append(t))
        SnapshotManager(eng, snaps, every=SNAPSHOT_EVERY, keep=2)
        for e in trace:
            eng.add_request(e["prompt"], sampling_of(e), request_id=e["id"])

        def to_cut():
            while eng.current_step < SNAPSHOT_EVERY:
                eng.step()

        served(ops, kernels, eng, to_cut)
        states = {r.state for r in eng.scheduler.running}
        if states != {RequestState.DECODING} or eng.scheduler.waiting:
            raise AssertionError(f"the cut is not inside decode: {states}")
        cut_step, cut_path = list_snapshots(snaps)[-1]
        t0 = time.perf_counter()
        saved = save(eng, os.path.join(tmp, "timed", "cut.atpsnap"))
        save_s = time.perf_counter() - t0
        restored_out: dict[str, list[int]] = {}
        t0 = time.perf_counter()
        restored = restore(cut_path, model, on_finish=lambda r: restored_out
                           .__setitem__(r.request_id, list(r.output_tokens)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if state_fingerprint(restored) != state_fingerprint(eng):
            raise AssertionError("restored fingerprint differs")
        served(ops, kernels, restored, lambda: restored.drain(max_steps=500))
        if restored_out != uninterrupted:
            raise AssertionError("the restored engine's streams differ "
                                 "from the uninterrupted run's")
        del restored
        emit(phase="durability", snapshot_step=cut_step,
             snapshot_bytes=saved["nbytes"], save_s=save_s,
             restore_s=restore_s, fingerprint_equal=True,
             restored_streams_equal=True)

        # (3) the process dies between snapshots: the journal holds the
        # tail; warm recovery, then every request drained
        served(ops, kernels, eng, lambda: [eng.step()
                                           for _ in range(CRASH_AFTER)])
        live = [(r.request_id, r.prompt, r.sampling)
                for r in (*eng.scheduler.waiting, *eng.scheduler.running)]
        eng.journal.close()
        del eng
        paths = {}
        for path in ("warm", "cold"):
            outs: dict[str, list[int]] = {}
            first: dict[str, float] = {}
            t0 = time.perf_counter()

            def on_token(req, token, first=first, t0=t0):
                first.setdefault(req.request_id, time.perf_counter() - t0)

            def on_finish(req, outs=outs):
                outs[req.request_id] = list(req.output_tokens)

            if path == "warm":
                rec, info = recover_engine(model, snaps, on_token=on_token,
                                           on_finish=on_finish)
                torch.cuda.synchronize()
                recover_s = time.perf_counter() - t0
            else:
                # (4) the cold path: every live request resumed with its
                # streamed tokens into a fresh engine
                rec = ServingEngine(model, config, on_token=on_token,
                                    on_finish=on_finish)
                for rid, prompt, sampling in live:
                    rec.resume_request(prompt, sampling, request_id=rid,
                                       output_tokens=streamed[rid])
            with watched(model) as (_, bad):
                served(ops, kernels, rec,
                       lambda: rec.drain(max_steps=500))
            health = rec.health()
            if (sorted(outs) != sorted(rid for rid, _, _ in live)
                    or any(len(o) != 32 for o in outs.values())
                    or bad.item() or rec.nonfinite_events
                    or health["free_pages"] + health["cached_pages"]
                    != config.num_pages):
                raise AssertionError(
                    f"{path} recovery: {len(outs)} of {len(live)} "
                    f"finished, {bad.item()} non-finite logits, health "
                    f"{health}")
            paths[path] = dict(
                next_token_s=first,
                equal_token_share=equal_share(outs, uninterrupted))
            del rec
    emit(phase="durability", crash_step=cut_step + CRASH_AFTER,
         recover_s=recover_s, journal_events=info["journal_events"],
         recovered_from_step=info["snapshot_step"],
         warm_next_token_s=paths["warm"]["next_token_s"],
         cold_next_token_s=paths["cold"]["next_token_s"],
         warm_equal_token_share=paths["warm"]["equal_token_share"],
         cold_equal_token_share=paths["cold"]["equal_token_share"],
         seconds=time.perf_counter() - t_phase)


def phase_durability_reference() -> None:
    """Phase 6's small f32 model on the card against the same weights on
    the CPU, async loop: a crash between snapshots, then warm recovery;
    the greedy streams equal the uninterrupted run's on each side and
    are equal card against CPU."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        SnapshotManager,
        recover_engine,
        replay,
        synthetic_trace,
    )
    from attention_tpu_torch.engine.sim import sampling_of
    from attention_tpu_torch.models import TinyDecoder, init_params

    trace = synthetic_trace(6, vocab=SMALL_MODEL["vocab"], seed=SEED,
                            prompt_len_min=4, prompt_len_max=300,
                            max_tokens=12)
    config = EngineConfig(num_pages=32, max_seq_len=512, prefill_chunk=64,
                          async_steps=True)
    cpu = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL_MODEL)
    cpu.load_state_dict(init_params(cpu, SEED))
    gpu = TinyDecoder(dtype=torch.float32, device="cuda", **SMALL_MODEL)
    gpu.load_state_dict(cpu.state_dict())
    sides = []
    for side, m in (("cpu", cpu), ("cuda", gpu)):
        _, want = replay(ServingEngine(m, config), trace)
        outs: dict[str, list[int]] = {}

        def on_finish(req, outs=outs):
            outs[req.request_id] = list(req.output_tokens)

        with tempfile.TemporaryDirectory() as d:
            eng = ServingEngine(m, config, on_finish=on_finish)
            SnapshotManager(eng, d, every=4, keep=2)
            for e in trace:
                eng.add_request(e["prompt"], sampling_of(e),
                                request_id=e["id"])
            for _ in range(6):
                eng.step()
            eng.journal.close()
            rec, info = recover_engine(m, d, on_finish=on_finish)
            rec.drain(max_steps=500)
        if outs != want or not info["journal_events"]:
            raise AssertionError(f"{side}: recovered streams differ from "
                                 f"the uninterrupted run's ({info})")
        sides.append(outs)
    if sides[0] != sides[1]:
        raise AssertionError("recovered streams differ card against CPU")
    emit(phase="reference", recovered_streams_equal=True,
         journal_events=info["journal_events"])


def tp_prompts(vocab: int, equal_rows: int = 512):
    """Phase 5f (b)'s prompts: 8 equal prompts of ``equal_rows`` tokens,
    the serving trace's 8 prompts right-padded with their lengths, and
    one prompt of 512 tokens for speculative decoding."""
    equal = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, vocab, (8, equal_rows))).cuda()
    ragged, lens = trace_prompts(vocab)
    spec = torch.as_tensor(np.random.default_rng(SEED + 9).integers(
        0, vocab, (1, 512))).cuda()
    return equal, ragged, lens, spec


def tp_runs(model, draft, band: dict, equal_rows: int = 512) -> dict:
    """{run: (call, the kernels it launches and how often, None where
    the count depends on the acceptance)} of phase 5f (b): ``model``
    (single-device or tp) and its windowed clone, ``draft`` the
    speculative draft."""
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.models.speculative import generate_speculative

    equal, ragged, lens, spec = tp_prompts(model.vocab, equal_rows)
    windowed = model.clone(**band)
    d, s = model.depth, TP_STEPS
    return {
        "generate": (lambda: gen.generate(model, equal, steps=s),
                     {"flash_fwd": d, "decode": s * d}),
        "generate_paged": (lambda: gen.generate_paged(
            model, ragged, lens, steps=s)[0],
            {"flash_fwd": d, "paged_decode": s * d}),
        "generate_int8": (lambda: gen.generate(model, equal, steps=s,
                                               int8_cache=True),
                          {"flash_fwd": d, "quant_decode": s * d}),
        "rolling": (lambda: gen.generate(windowed, equal, steps=s,
                                         rolling_cache=True),
                    {"flash_fwd": d, "decode": s * d}),
        "beam": (lambda: gen.generate_beam(model, equal, steps=s,
                                           beams=TP_BEAMS),
                 {"flash_fwd": d, "decode": (s - 1) * d}),
        "speculative": (lambda: generate_speculative(
            model, draft, spec, steps=TP_SPEC_STEPS, gamma=SPEC_GAMMA),
            None),
    }


def tp_models(dtype, model_kw: dict, mesh=None):
    """The served model and its depth-1 draft (seed 1) at ``model_kw``,
    weights from `init_params` on the card; tensor-parallel on ``mesh``
    when given."""
    from attention_tpu_torch.models import TinyDecoder, init_params

    out = []
    for kw, seed in ((model_kw, SEED), (dict(model_kw, depth=1), SEED + 1)):
        m = TinyDecoder(dtype=dtype, device="cuda", **kw)
        m.load_state_dict(init_params(m, seed))
        out.append(m if mesh is None else m.clone(tp_axis="tp", mesh=mesh))
    return out


def tp_engine_runs(model, trace, mesh_shards: int) -> dict:
    """Phase 5f (c)'s engine runs of ``model`` at `SERVE_ENGINE`: {(step
    mode, temperature): (streams, summary, model calls, launches)}."""
    from attention_tpu_torch import ops
    from attention_tpu_torch.engine import EngineConfig, ServingEngine, \
        replay

    out = {}
    for mode in ("ragged", "two_call"):
        for temperature in (0.0, SERVE_TEMPERATURE):
            eng = ServingEngine(model, EngineConfig(**dict(
                SERVE_ENGINE, step_mode=mode, mesh_shards=mesh_shards)))
            ops.reset_launch_counts()
            summary, streams = replay(eng, [dict(e, temperature=temperature)
                                            for e in trace], max_steps=500)
            torch.cuda.synchronize()
            calls = sum(bool(m.decode_tokens) + bool(m.prefill_tokens)
                        if mode == "two_call"
                        else bool(m.decode_tokens or m.prefill_tokens)
                        for m in eng.metrics.steps)
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            out[mode, temperature] = (streams, summary, calls, launches,
                                      eng.nonfinite_events)
    return out


def tp_single_device(model) -> dict:
    """The single-device side of phase 5f, on the card before the world
    starts: (b)'s tokens and first-step logits and (c)'s streams and
    step times, for the serving model and the small f32 model."""
    from attention_tpu_torch.models import decode as gen

    ref = {}
    draft = tp_models(torch.bfloat16, SERVE_MODEL)[1]
    for key, m, d, band, rows in (
            ("serve", model, draft, SERVE_BAND, 512),
            ("small", *tp_models(torch.float32, SMALL_MODEL), SMALL_BAND,
             TP_SMALL_ROWS)):
        runs = tp_runs(m, d, band, rows)
        ref[key] = dict(
            tokens={name: call().cpu() for name, (call, _) in runs.items()},
            first_logits=gen.prefill(m, tp_prompts(m.vocab, rows)[0],
                                     rows + 128)[0].float().cpu(),
            engines={k: (v[0], v[1]["median_step_ms"])
                     for k, v in tp_engine_runs(
                         m, serving_trace(m.vocab), 0).items()})
        del runs, d
    return ref


def tp_ragged_inputs(gen, pages_per_slot: int):
    """(q, the step before its append, k_new, v_new) of phase 5f (a)'s
    ragged step: 8 decode slots whose lengths after the append are
    `DECODE_LENS` (an empty one read as 1) and one 256-token prefill
    slot ending at 1024, every real token appended at its slot's next
    position (`ragged_step`'s pools and tables)."""
    spans = [(1, max(n, 1)) for n in DECODE_LENS] + [(256, 1024)]
    q, post = ragged_step(gen, spans, pages_per_slot=pages_per_slot)
    q_lens = post.cu_q_lens[1:] - post.cu_q_lens[:-1]
    real = int(q_lens.sum())
    slots = torch.repeat_interleave(
        torch.arange(len(q_lens), device="cuda"), q_lens.long())
    start = (post.cu_q_lens[:-1] - (post.kv_lens - q_lens)).long()
    pos = torch.arange(real, device="cuda") - start[slots]
    token_slot = post.token_slot.clone()
    token_pos = post.token_pos.clone()
    token_slot[:real], token_pos[:real] = slots.int(), pos.int()
    pre = post._replace(kv_lens=post.kv_lens - q_lens, token_pos=token_pos,
                        token_slot=token_slot)
    shape = (1, post.k_pool.shape[1], q.shape[2], q.shape[3])
    k_new, v_new = (torch.randn(shape, generator=gen, device="cuda").to(
        q.dtype) for _ in "kv")
    return q, pre, k_new, v_new


def tp_sharded_ops(rank, say, launches, failures) -> None:
    """Phase 5f (a): each public serving function on the world at the
    serving geometry, held against the single-device call on the same
    inputs (the max abs difference and whether the bits are equal
    printed) and against the kernel's plain version under `mismatch`;
    the kernel launched once a call on every rank; the same bits on
    every rank."""
    import torch.distributed as dist

    from attention_tpu_torch import ops
    from attention_tpu_torch.ops.decode import flash_decode, \
        flash_decode_plain
    from attention_tpu_torch.ops.flash import flash_attention, \
        flash_attention_plain
    from attention_tpu_torch.ops.paged import PagePool, \
        paged_flash_decode, paged_flash_decode_plain, paged_from_dense
    from attention_tpu_torch.ops.quant import flash_decode_quantized, \
        quant_decode_plain, quantize_kv
    from attention_tpu_torch.ops.ragged_paged import \
        ragged_paged_append, ragged_paged_attention, \
        ragged_paged_attention_plain
    from attention_tpu_torch.parallel import serving
    from attention_tpu_torch.parallel.mesh import default_mesh

    tp, sp = default_mesh("tp"), default_mesh("sp")
    h, hkv, n, d = 32, 4, 4096, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    b = len(DECODE_LENS)
    q, k, v = randn(b, h, d), randn(b, hkv, n, d), randn(b, hkv, n, d)
    int8 = quantize_kv(k, v)
    paged = paged_from_dense(k, v, lens, PagePool(b * n // 128),
                             num_pages=b * n // 128, page_size=128,
                             total_pages_per_seq=n // 128)
    rq, pre, k_new, v_new = tp_ragged_inputs(gen, n // 128)

    def appended():
        step = pre._replace(k_pool=pre.k_pool.clone(),
                            v_pool=pre.v_pool.clone())
        return ragged_paged_append(step, k_new, v_new)

    post = appended()
    pq, pk, pv = randn(1, h, 2048, d), randn(1, hkv, 2048, d), \
        randn(1, hkv, 2048, d)
    cases = {
        # name: (kernel, sharded call, single-device call, plain call)
        "cache_sharded_b8_4096": (
            "flash_fwd",
            lambda: serving.cache_sharded_decode(q, k, v, n, mesh=sp),
            lambda: flash_decode(q, k, v, n),
            lambda: flash_decode_plain(q, k, v, n)),
        "cache_sharded_b8_3000": (
            "flash_fwd",
            lambda: serving.cache_sharded_decode(q, k, v, 3000, mesh=sp),
            lambda: flash_decode(q, k, v, 3000),
            lambda: flash_decode_plain(q, k, v, 3000)),
        "decode": ("decode",
                   lambda: serving.head_sharded_decode(q, k, v, lens,
                                                       mesh=tp),
                   lambda: flash_decode(q, k, v, lens),
                   lambda: flash_decode_plain(q, k, v, lens)),
        "decode_int8": ("quant_decode",
                        lambda: serving.head_sharded_decode_quantized(
                            q, int8, lens, mesh=tp),
                        lambda: flash_decode_quantized(q, int8, lens),
                        lambda: quant_decode_plain(q, int8, lens)),
        "decode_paged": ("paged_decode",
                         lambda: serving.head_sharded_decode_paged(
                             q, paged, mesh=tp),
                         lambda: paged_flash_decode(q, paged),
                         lambda: paged_flash_decode_plain(q, paged)),
        # the sharded step appends to copies of the pools, the single
        # device's and the plain version read the same append's pools
        "ragged_step": ("ragged_paged",
                        lambda: serving.head_sharded_ragged_step(
                            rq, pre._replace(k_pool=pre.k_pool.clone(),
                                             v_pool=pre.v_pool.clone()),
                            k_new, v_new, mesh=tp)[0],
                        lambda: ragged_paged_attention(rq, post),
                        lambda: ragged_paged_attention_plain(rq, post)),
        "prefill_2048": ("flash_fwd",
                         lambda: serving.head_sharded_prefill(
                             pq, pk, pv, mesh=tp, causal=True),
                         lambda: flash_attention(pq, pk, pv, causal=True),
                         lambda: flash_attention_plain(pq, pk, pv,
                                                       causal=True)),
    }
    for name, (kernel, sharded, single, plain) in cases.items():
        ops.reset_launch_counts()
        got = sharded()
        torch.cuda.synchronize()
        counted = {kn: c for kn, c in ops.launch_counts().items() if c}
        one, want = single(), plain()
        torch.cuda.synchronize()
        err, ratio = held(got, want)
        diff = (got.float() - one.float()).abs().nan_to_num().max().item()
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, got.float().sum().item())
        if counted != {kernel: 1}:
            failures.append(f"{name}: launches {counted}")
        if len(set(digests)) != 1:
            failures.append(f"{name}: ranks differ {digests}")
        launches[kernel] = launches.get(kernel, 0) + counted.get(kernel, 0)
        say(part="ops", case=name, kernel=kernel, launches=counted,
            max_abs_err=err, share_of_limit=ratio,
            vs_single_device_max_abs=diff,
            same_bits_as_single_device=bool(torch.equal(got, one)),
            single_share_of_limit=mismatch_ratio(one, want))
        del got, one, want


def mismatch_ratio(got, want) -> float:
    from attention_tpu_torch.ops.reference import mismatch

    return mismatch(got, want)[1]


def tp_generate(rank, say, launches, failures, tp, draft, ref, band,
                rows, exact) -> None:
    """Phase 5f (b) on one model: each run's launches exact on every
    rank, the first-step logits against the single device's, the share
    of tokens equal to the single device's stream (all of them where
    ``exact``), every rank's tokens equal to rank 0's."""
    import torch.distributed as dist

    from attention_tpu_torch import ops
    from attention_tpu_torch.models import decode as gen

    prompt = tp_prompts(tp.vocab, rows)[0]
    first = gen.prefill(tp, prompt, rows + 128)[0].float().cpu()
    err = (first - ref["first_logits"]).abs().max().item()
    ratio = mismatch_ratio(first.to(torch.bfloat16),
                           ref["first_logits"].to(torch.bfloat16))
    if not ratio <= 1.0 or (exact and err > TP_F32_LOGITS_TOL):
        failures.append(f"first-step logits {err} ({ratio} x the limit)")
    say(part="generate", model=str(tp.dtype), first_logits_max_abs=err,
        first_logits_share_of_bf16_limit=ratio)
    for name, (call, want) in tp_runs(tp, draft, band, rows).items():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {k: c for k, c in ops.launch_counts().items() if c}
        if want is not None and counted != want:
            failures.append(f"{name}: launches {counted}, want {want}")
        if want is None and set(counted) != {"flash_fwd", "decode"}:
            failures.append(f"{name}: launches {counted}")
        for kn, c in counted.items():
            launches[kn] = launches.get(kn, 0) + c
        toks = toks.cpu()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, toks)
        if any(not torch.equal(t, toks) for t in every):
            failures.append(f"{name}: ranks' tokens differ")
        want_toks = ref["tokens"][name]
        share = (toks == want_toks).float().mean().item()
        if exact and share != 1.0:
            failures.append(f"{name}: {share} of the tokens equal")
        say(part="generate", model=str(tp.dtype), run=name,
            launches=counted, wall_s=wall, equal_token_share=share,
            ranks_equal=True)


def tp_engine(rank, say, launches, failures, tp_model, ref, shards,
              exact) -> dict:
    """Phase 5f (c) on one model: the mesh engine's four runs, launches
    exact (one kernel launch a layer a model call), every request
    finished, every logit finite, every rank's streams equal to rank
    0's, the share equal to the single device's (all where ``exact``),
    the median step ms beside the single engine's.  Returns the greedy
    ragged streams."""
    import torch.distributed as dist

    runs = tp_engine_runs(tp_model, serving_trace(tp_model.vocab), shards)
    for (mode, temperature), (streams, summary, calls, counted,
                              nonfinite) in runs.items():
        kernel = "ragged_paged" if mode == "ragged" else "paged_decode"
        if counted != {kernel: calls * tp_model.depth} or nonfinite:
            failures.append(f"{mode}/{temperature}: launches {counted} "
                            f"for {calls} calls, {nonfinite} non-finite")
        if not all(len(t) == 32 for t in streams.values()):
            failures.append(f"{mode}/{temperature}: unfinished")
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, streams)
        if any(s != streams for s in every):
            failures.append(f"{mode}/{temperature}: ranks' streams differ")
        want, single_ms = ref["engines"][mode, temperature]
        share = equal_share(streams, want)
        if exact and share != 1.0:
            failures.append(f"{mode}/{temperature}: {share} equal")
        launches[kernel] = launches.get(kernel, 0) + counted.get(kernel, 0)
        say(part="engine", model=str(tp_model.dtype), step_mode=mode,
            temperature=temperature, mesh_shards=shards,
            steps=summary["num_steps"], launches=counted,
            median_step_ms=summary["median_step_ms"],
            single_device_median_step_ms=single_ms,
            mean_host_overhead_ms=summary["mean_host_overhead_ms"],
            equal_token_share_vs_single_device=share, ranks_equal=True)
    return runs["ragged", 0.0][0]


def tp_gather_share(rank, say, tp_model) -> None:
    """One more greedy ragged run of the mesh engine with the mesh's
    collectives timed (the card synchronised around each): the
    all-gather's share of the run's wall time; each rank's pool bytes
    and peak memory."""
    import torch.distributed as dist

    from attention_tpu_torch.engine import EngineConfig, ServingEngine, \
        replay

    eng = ServingEngine(tp_model, EngineConfig(**dict(
        SERVE_ENGINE, mesh_shards=TP_WORLD)))
    eng.mesh.timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary, _ = replay(eng, serving_trace(tp_model.vocab), max_steps=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gather_s = eng.mesh.timings.get("all_gather", 0.0)
    eng.mesh.timings = None
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in (*eng._k_pools, *eng._v_pools))
    rec = [None] * dist.get_world_size()
    dist.all_gather_object(rec, dict(
        rank=rank, pool_bytes=pool_bytes,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30))
    say(part="gather_share", wall_s=wall, all_gather_s=gather_s,
        all_gather_share=gather_s / wall,
        median_step_ms_timed=summary["median_step_ms"],
        pool_shape_per_rank=list(eng._k_pools[0].shape), ranks=rec)


def tp_snapshot(rank, say, launches, failures, tp_model, greedy,
                tmp: str) -> None:
    """Phase 5f (d): a mesh engine cut inside decode, saved (every rank
    calls `save`; rank 0 writes ``pools.0..3``) and restored on the
    world: the fingerprints equal, the restored and the live engine
    drained to the uninterrupted mesh run's streams; one shard's section
    flipped is a typed refusal naming it."""
    import torch.distributed as dist

    from attention_tpu_torch import ops
    from attention_tpu_torch.engine import EngineConfig, RequestState, \
        ServingEngine, SnapshotCorruptError, state_fingerprint
    from attention_tpu_torch.engine.sim import sampling_of
    from attention_tpu_torch.engine.snapshot import inspect, restore, save

    config = EngineConfig(**dict(SERVE_ENGINE, mesh_shards=TP_WORLD))
    outs = {}
    eng = ServingEngine(tp_model, config, on_finish=lambda r: outs
                        .__setitem__(r.request_id, list(r.output_tokens)))
    for e in serving_trace(tp_model.vocab):
        eng.add_request(e["prompt"], sampling_of(e), request_id=e["id"])
    ops.reset_launch_counts()
    while eng.current_step < SNAPSHOT_EVERY:
        eng.step()
    if {r.state for r in eng.scheduler.running} != {RequestState.DECODING}:
        failures.append("the cut is not inside decode")
    path = os.path.join(tmp, "mesh.atpsnap")
    t0 = time.perf_counter()
    saved = save(eng, path)
    save_s = time.perf_counter() - t0
    info = inspect(path)
    back = {}
    t0 = time.perf_counter()
    restored = restore(path, tp_model, on_finish=lambda r: back
                       .__setitem__(r.request_id, list(r.output_tokens)))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_print = state_fingerprint(restored) == state_fingerprint(eng)
    for e in (restored, eng):
        e.drain(max_steps=500)
    torch.cuda.synchronize()
    counted = {k: c for k, c in ops.launch_counts().items() if c}
    launches["ragged_paged"] = launches.get("ragged_paged", 0) + \
        counted.get("ragged_paged", 0)
    if not (same_print and back == greedy and outs == greedy):
        failures.append(f"snapshot: fingerprints equal {same_print}, "
                        f"restored equal {back == greedy}, live equal "
                        f"{outs == greedy}")
    bad = os.path.join(tmp, "bad.atpsnap")
    if rank == 0:
        blob = bytearray(open(path, "rb").read())
        nl = blob.find(b"\n")
        off = nl + 1
        for s in json.loads(blob[:nl])["sections"]:
            if s["name"] == "pools.2":
                blob[off + s["nbytes"] // 2] ^= 0xFF
                break
            off += s["nbytes"]
        with open(bad, "wb") as f:
            f.write(bytes(blob))
    dist.barrier()
    refusal = None
    try:
        restore(bad, tp_model)
    except SnapshotCorruptError as e:
        refusal = str(e)
    if not refusal or "pools.2" not in refusal:
        failures.append(f"a flipped shard section restored: {refusal}")
    say(part="snapshot", snapshot_step=SNAPSHOT_EVERY, shards=info["shards"],
        sections=[s["name"] for s in info["sections"]],
        snapshot_bytes=saved["nbytes"], save_s=save_s, restore_s=restore_s,
        fingerprint_equal=same_print, drained_streams_equal=True,
        corrupt_shard_refusal=refusal, launches=counted)


def tp_rank(rank: int, world: int, init_file: str, ref_file: str,
            out_file: str, tmp: str) -> None:
    """One rank of phase 5f; rank 0 prints the lines and writes its
    launches to ``out_file``.  Every part runs to its end; the rank
    fails after them if a check failed."""
    import torch.distributed as dist

    from attention_tpu_torch.parallel.serving import serving_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)

    def say(**record):
        if rank == 0:
            emit(phase="tp_serving", **record)

    try:
        refs = torch.load(ref_file, weights_only=False)
        launches, failures, seconds = {}, [], {}
        t0 = time.perf_counter()
        tp_sharded_ops(rank, say, launches, failures)
        seconds["ops"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = serving_mesh(world)
        tp, draft = tp_models(torch.bfloat16, SERVE_MODEL, mesh)
        tp_generate(rank, say, launches, failures, tp, draft, refs["serve"],
                    SERVE_BAND, 512, exact=False)
        del draft
        seconds["generate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        greedy = tp_engine(rank, say, launches, failures, tp, refs["serve"],
                           world, exact=False)
        tp_gather_share(rank, say, tp)
        seconds["engine"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_snapshot(rank, say, launches, failures, tp, greedy, tmp)
        seconds["snapshot"] = time.perf_counter() - t0
        del tp
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        small, small_draft = tp_models(torch.float32, SMALL_MODEL,
                                       serving_mesh(TP_SMALL_SHARDS))
        tp_generate(rank, say, launches, failures, small, small_draft,
                    refs["small"], SMALL_BAND, TP_SMALL_ROWS, exact=True)
        tp_engine(rank, say, launches, failures, small, refs["small"],
                  TP_SMALL_SHARDS, exact=True)
        seconds["small_f32"] = time.perf_counter() - t0
        say(seconds=seconds, peak_gib=torch.cuda.max_memory_allocated()
            / 2**30)
        if failures:
            raise AssertionError(f"rank {rank}: {failures}")
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump(dict(launches=launches), f)
    finally:
        dist.destroy_process_group()


def phase_tp_serving(kernels, model) -> None:
    """Spawn phase 5f's gloo world on the card after the single-device
    side has run; a failed rank fails the phase."""
    import shutil

    import torch.multiprocessing as mp

    from attention_tpu_torch.ops._native import BUILD_DIR

    t0 = time.perf_counter()
    ref = tp_single_device(model)
    t_single = time.perf_counter() - t0
    init = os.path.join(BUILD_DIR, f"tp-{os.getpid()}.init")
    out = os.path.join(BUILD_DIR, f"tp-{os.getpid()}.json")
    ref_file = os.path.join(BUILD_DIR, f"tp-{os.getpid()}.pt")
    for stale in (init, out):
        if os.path.exists(stale):
            os.remove(stale)
    torch.save(ref, ref_file)
    tmp = tempfile.mkdtemp(prefix="tp-snap-")
    try:
        mp.spawn(tp_rank, nprocs=TP_WORLD,
                 args=(TP_WORLD, init, ref_file, out, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.remove(ref_file)
    with open(out) as f:
        rec = json.load(f)
    for kn, c in rec["launches"].items():
        kernels[kn]["launches"] += c
    emit(phase="tp_serving", seconds=time.perf_counter() - t0,
         single_device_seconds=t_single, rank0_launches=rec["launches"])


def bwd_work(h, hkv, m, n, d, pairs, item, factor, outs):
    """(bytes, operations) of one backward call: Qs, K, V and dO read
    once in the input dtype, lse and delta once in fp32, ``outs`` (the
    gradients it writes: "q" for dQ, "kv" for dK and dV) written once in
    the input dtype; ``factor``·d operations per visible (row, key) pair
    per q head."""
    nbytes = (2 * h * m * d + 2 * hkv * n * d) * item + 2 * h * m * 4
    nbytes += (h * m * d * ("q" in outs) + 2 * hkv * n * d * ("kv" in outs)) \
        * item
    return nbytes, float(factor) * d * h * pairs


def phase_backward(kernels) -> None:
    """The backward kernels at the serving geometry as a training call (b
    = 1, 32 q / 4 kv heads, m = n = 4096, d 128, causal, bf16), with and
    without softcap 50, and at the training phase's layer call (b = 4, m
    = n = 2048, softcap 50, q/k/v/dO strided as the attention layer hands
    them over): the training forward's partials against their plain
    version, then the fused kernel and the dQ + dK/dV pair against
    `flash_backward_plain` under `reference.grad_mismatch`.  A second
    call gives the same bits, except the fused dQ, whose fp32 atomics add
    in another order each run: it must agree with the first run within
    `grad_mismatch`'s limit (one bf16 ulp plus the fp32 reordering).  A
    dropped last key tile in dK and a 2% scale error in dQ must fail.
    The serving cases are timed: each kernel alone, `flash_backward` end
    to end on each path, the plain version, SDPA's backward."""
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash import (
        flash_attention_partials,
        flash_attention_partials_plain,
    )
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl
    from attention_tpu_torch.ops.reference import grad_mismatch

    h, hkv, d = 32, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    # serving: contiguous (1, heads, 4096, d); the layer: (b, s, heads, d)
    # projections viewed as (b, heads, s, d), dO as autograd returns it;
    # head dim 64; the edges: m and n not multiples of 128, kv_valid < n,
    # and keys shifted past the first 37 rows (rows that see no key)
    serving = (randn(1, h, 4096, d), randn(1, hkv, 4096, d),
               randn(1, hkv, 4096, d), randn(1, h, 4096, d))
    b, s = TRAIN_BATCH[0], TRAIN_BATCH[1] - 1
    layer = tuple(randn(b, s, n, d).transpose(1, 2) for n in (h, hkv, hkv, h))
    d64 = (randn(2, 16, 2048, 64), randn(2, 2, 2048, 64),
           randn(2, 2, 2048, 64), randn(2, 16, 2048, 64))
    edge = (randn(2, 8, 1000, d), randn(2, 2, 1003, d), randn(2, 2, 1003, d),
            randn(2, 8, 1000, d))
    offsets = dict(q_offset=3, kv_offset=40, kv_valid=900)
    names = ("dq", "dk", "dv")

    def held_grads(got, want):
        out = [grad_mismatch(g, w) for g, w in zip(got, want)]
        if not all(ratio <= 1.0 for _, ratio in out):
            raise AssertionError(f"backward off its plain version: {out}")
        return out

    for case, (q, k, v, dout), extra in (
            ("serving_causal", serving, {}),
            ("serving_causal_softcap", serving, dict(softcap=50.0)),
            ("train_layer_causal_softcap", layer, dict(softcap=50.0)),
            ("d64_causal", d64, {}),
            ("edge_causal_offsets", edge, offsets),
            ("edge_causal_offsets_softcap", edge,
             dict(offsets, softcap=50.0))):
        kw = {"scale": q.shape[-1] ** -0.5, "causal": True,
              "softcap": None, **extra}
        valid = kw.get("kv_valid", k.shape[-2])
        # the training forward: partials, held normalized (bf16) and the
        # row stats (fp32, relative 1e-5: same arithmetic, other order;
        # a row that sees no key has max -inf and sum 0 on both sides)
        part = flash_attention_partials(q, k, v, **kw)
        plain = flash_attention_partials_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        norm = [(o / l_.clamp(min=1e-30)[..., None]).to(torch.bfloat16)
                for o, _, l_ in (part, plain)]
        live = plain[1].isfinite()
        if not torch.equal(part[1].isfinite(), live):
            raise AssertionError("partials' empty rows differ")
        stats_rel = [((a - b)[live].abs().max() / b[live].abs().max()).item()
                     for a, b in zip(part[1:], plain[1:])]
        p_err, p_ratio = held(*norm)
        if not max(stats_rel) <= 1e-5:
            raise AssertionError(f"partials' row stats off: {stats_rel}")
        kernels["flash_fwd"]["max_abs_err"] = max(
            kernels["flash_fwd"]["max_abs_err"], p_err)
        emit(phase="backward", kernel="flash_fwd", case=case + "_partials",
             **flash_plan(q, k, v, kw.get("kv_valid")), max_abs_err=p_err,
             share_of_limit=p_ratio, row_stats_rel_err=stats_rel)

        out, lse = _flash_fwd_impl(q, k, v, **kw)
        want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
        faults = {
            "dk_dropped_last_key_tile": grad_mismatch(
                flash_bwd.flash_backward_plain(
                    q, k, v, out, lse, dout,
                    **dict(kw, kv_valid=valid - KEY_TILE))[1], want[1])[1],
            "dq_scale_off_2pct": grad_mismatch(
                flash_bwd.flash_backward_plain(
                    q, k, v, out, lse, dout,
                    **dict(kw, scale=1.02 * kw["scale"]))[0], want[0])[1]}
        if not all(ratio > 1.0 for ratio in faults.values()):
            raise AssertionError(f"the check passes a planted fault: "
                                 f"{faults}")
        # the kernels' bodies and cuts of the call: every case here is
        # bf16 at d 64 or 128, so "wgmma" on both paths
        plan = flash_bwd.bwd_launch_plan(
            q, k, v, out, lse, dout, causal=True,
            **{x: kw[x] for x in ("q_offset", "kv_offset", "kv_valid")
               if x in kw})
        pair_plan = plan.pop("pair")
        if plan["body"] != "wgmma" or pair_plan["body"] != "wgmma":
            raise AssertionError(f"{case}: the fused kernel runs {plan}, "
                                 f"the pair {pair_plan}")
        for path in ("fused", "pair"):
            flash_bwd._FORCE_TWO_KERNEL = path == "pair"
            got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
            again = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
            flash_bwd._FORCE_TWO_KERNEL = False
            torch.cuda.synchronize()
            errs = held_grads(got, want)
            run_to_run = None
            if path == "fused":
                same_bits(got[1:], again[1:])
                run_to_run = grad_mismatch(again[0], got[0])
                if not run_to_run[1] <= 1.0:
                    raise AssertionError(f"fused dQ run to run: {run_to_run}")
            else:
                same_bits(got, again)
            for kernel, idx in ((flash_bwd.FUSED, (0, 1, 2)),) \
                    if path == "fused" else ((flash_bwd.DQ, (0,)),
                                             (flash_bwd.DKV, (1, 2))):
                kernels[kernel]["max_abs_err"] = max(
                    kernels[kernel]["max_abs_err"],
                    *(errs[i][0] for i in idx))
            emit(phase="backward", path=path, case=case,
                 **(dict(fused_plan=plan) if path == "fused"
                    else dict(pair_plan=pair_plan)),
                 max_abs_err=dict(zip(names, (e for e, _ in errs))),
                 share_of_limit=dict(zip(names, (r for _, r in errs))),
                 fused_dq_run_to_run=run_to_run,
                 planted_faults_share_of_limit=faults)
        if case.startswith("serving"):
            backward_times(kernels, case, (q, k, v, out, lse, dout), kw)


def window_bwd_case(kernels, case, args, kw) -> dict:
    """One windowed backward case: the fused kernel and the pair against
    `flash_backward_plain` over the band and sinks under
    `reference.grad_mismatch`, the same bits on a second call (the fused
    dQ, whose tiles add in no fixed order, within the limit of the
    first), bf16 at d 64/128 on "wgmma" and the rest on "fma"; the
    kernels run with a band one key tile (64 rows) longer, and with the
    sink patch left out, must fail the check.  Returns the launch plan."""
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.reference import grad_mismatch

    q, k, v, out, lse, dout = args
    offsets = {x: kw[x] for x in ("q_offset", "kv_valid") if x in kw}
    plan = flash_bwd.bwd_launch_plan(*args, causal=True,
                                     window=kw["window"], **offsets)
    pair_plan = plan.pop("pair")
    body = "wgmma" if (q.dtype == torch.bfloat16
                       and q.shape[-1] in (64, 128)) else "fma"
    if plan["body"] != body or pair_plan["body"] != body:
        raise AssertionError(f"{case}: the fused kernel runs {plan}, the "
                             f"pair {pair_plan}; want {body}")
    want = flash_bwd.flash_backward_plain(*args, **kw)

    def share(got):
        return max(grad_mismatch(g, w)[1] for g, w in zip(got, want))

    for path in ("fused", "pair"):
        flash_bwd._FORCE_TWO_KERNEL = path == "pair"
        try:
            got = flash_bwd.flash_backward(*args, **kw)
            again = flash_bwd.flash_backward(*args, **kw)
            faults = {}
            if kw["window"] is not None:
                faults["band_one_tile_longer"] = share(
                    flash_bwd.flash_backward(
                        *args, **dict(kw, window=kw["window"] + KEY_TILE)))
            if kw.get("sinks"):
                faults["sink_patch_left_out"] = share(
                    flash_bwd.flash_backward(*args, **dict(kw, sinks=None)))
        finally:
            flash_bwd._FORCE_TWO_KERNEL = False
        torch.cuda.synchronize()
        errs = [grad_mismatch(g, w) for g, w in zip(got, want)]
        if not all(ratio <= 1.0 for _, ratio in errs):
            raise AssertionError(f"{case} {path}: off its plain version: "
                                 f"{errs}")
        if not all(ratio > 1.0 for ratio in faults.values()):
            raise AssertionError(f"{case} {path}: the check passes a planted "
                                 f"fault: {faults}")
        run_to_run = None
        if path == "fused":
            same_bits(got[1:], again[1:])
            run_to_run = grad_mismatch(again[0], got[0])
            if not run_to_run[1] <= 1.0:
                raise AssertionError(f"{case}: fused dQ run to run: "
                                     f"{run_to_run}")
        else:
            same_bits(got, again)
        for kernel, idx in ((flash_bwd.FUSED, (0, 1, 2)),) \
                if path == "fused" else ((flash_bwd.DQ, (0,)),
                                         (flash_bwd.DKV, (1, 2))):
            kernels[kernel]["max_abs_err"] = max(
                kernels[kernel]["max_abs_err"], *(errs[i][0] for i in idx))
        emit(phase="backward", path=path, case=case,
             window=kw["window"], sinks=kw.get("sinks"),
             softcap=kw.get("softcap"),
             **(dict(fused_plan=plan) if path == "fused"
                else dict(pair_plan=pair_plan)),
             max_abs_err=dict(zip(("dq", "dk", "dv"), (e for e, _ in errs))),
             share_of_limit=dict(zip(("dq", "dk", "dv"),
                                     (r for _, r in errs))),
             fused_dq_run_to_run=run_to_run,
             planted_faults_share_of_limit=faults)
    return plan


def phase_window_backward(kernels) -> None:
    """Phase 2b's windowed cases.  The three backward kernels at the
    windowed flash geometry (`WINDOW_FLASH`: 32 q / 4 kv heads, 8192
    rows, d 128, causal, bf16) for each of `WINDOW_BWD_BANDS`, held by
    `window_bwd_case` and timed: each kernel alone on the staged operands
    (device ms by `torch.profiler`, CUDA-event ms), `flash_backward` end
    to end on the fused path (with the sink patch), the sink patch
    alone, the plain version, and SDPA's backward with the band as a
    boolean mask (``is_causal`` without a window; none under softcap);
    bounds from the band's pairs (sinks included).  The band must shrink
    each kernel's card time: window 4096 at or under the causal call's,
    window 1024 under half of it.  Then the f32 FMA bodies (window 100
    and 5 sinks, dk != dv, q_offset 133) and the bf16 edges (m 1000, n
    1003, kv_valid 900, window 200 and 3 sinks, q_offset 37), untimed."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl
    from attention_tpu_torch.ops.reference import attention_mask

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    h, hkv, m, d = WINDOW_FLASH
    q, k, v, dout = (torch.randn((1, heads, m, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for heads in (h, hkv, hkv, h))
    cases = {kernel: kernels[kernel].setdefault("window_cases", {})
             for kernel in (flash_bwd.FUSED, flash_bwd.DQ, flash_bwd.DKV)}
    for case, window, sinks, softcap in WINDOW_BWD_BANDS:
        kw = dict(scale=d ** -0.5, causal=True, softcap=softcap,
                  window=window, sinks=sinks)
        out, lse = _flash_fwd_impl(q, k, v, **kw)
        args = (q, k, v, out, lse, dout)
        plan = window_bwd_case(kernels, case, args, kw)
        staged = flash_bwd._Staged(*args, scale=kw["scale"], causal=True,
                                   softcap=softcap, q_offset=0, kv_offset=0,
                                   kv_valid=m, window=window)
        fused, pair = staged.fused_buffers(), staged.pair_buffers()
        launches = {
            flash_bwd.FUSED: lambda: staged.fused(**fused),
            flash_bwd.DQ: lambda: staged.pair(flash_bwd.DQ, dq=pair["dq"]),
            flash_bwd.DKV: lambda: staged.pair(
                flash_bwd.DKV, dk=pair["dk"], dvo=pair["dvo"])}
        pairs = band_tiles(m, window, sinks)[2]
        plain_ms = time_ms(lambda: flash_bwd.flash_backward_plain(
            *args, **kw), calls=1, reps=3)
        extra = dict(flash_backward_device_ms=device_ms(
            lambda: flash_bwd.flash_backward(*args, **kw)))
        if sinks:
            extra["sink_patch_device_ms"] = device_ms(
                lambda: flash_bwd.sink_patch(
                    q, k, v, out, lse, dout, scale=kw["scale"],
                    window=window, sinks=sinks, softcap=softcap))
        library_ms = library_device_ms = None
        if softcap is None:
            kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
            mask = None if window is None else attention_mask(
                m, m, causal=True, window=window, sinks=sinks,
                device="cuda")
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, kx, vx))
            o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                               is_causal=mask is None)

            def sdpa():
                return torch.autograd.grad(o, (qq, kk, vv), dout,
                                           retain_graph=True)

            library_ms, library_device_ms = time_ms(sdpa), device_ms(sdpa)
            del kx, vx, mask, qq, kk, vv, o
        for kernel, factor, outs in ((flash_bwd.FUSED, 10, "qkv"),
                                     (flash_bwd.DQ, 6, "q"),
                                     (flash_bwd.DKV, 8, "kv")):
            b_ms, b_by = bound_ms(*bwd_work(h, hkv, m, m, d, pairs, 2,
                                            factor, outs), torch.bfloat16)
            rec = dict(ms=time_ms(launches[kernel]),
                       device_ms=device_ms(launches[kernel]),
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms if kernel == flash_bwd.FUSED
                       else None,
                       library_device_ms=library_device_ms
                       if kernel == flash_bwd.FUSED else None)
            cases[kernel][case] = rec
            emit(phase="backward", kernel=kernel, case=case,
                 shape=list(WINDOW_FLASH), window=window, sinks=sinks,
                 softcap=softcap, kept_pairs=h * pairs,
                 tflop_s=factor * d * h * pairs / rec["device_ms"] / 1e9,
                 **(extra if kernel == flash_bwd.FUSED else {}),
                 **({"plan": plan} if kernel == flash_bwd.FUSED else {}),
                 **rec)
        del staged, fused, pair, out, lse, args
    for kernel, by_case in cases.items():
        full = by_case["causal"]["device_ms"]
        w4096 = by_case["window4096_sinks4"]["device_ms"]
        w1024 = by_case["window1024"]["device_ms"]
        emit(phase="backward", kernel=kernel,
             window4096_over_causal=w4096 / full,
             window1024_over_causal=w1024 / full)
        if not (w4096 <= full and w1024 < 0.5 * full):
            raise AssertionError(f"{kernel}: the band does not shrink the "
                                 f"work: {w4096}, {w1024} against {full} ms")
    del q, k, v, dout

    # the FMA bodies: f32, dk != dv, a cached prefill's offset; the edges
    f32 = [torch.randn(s, generator=gen, device="cuda")
           for s in ((1, 4, 200, 64), (1, 2, 333, 64), (1, 2, 333, 96))]
    edge = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in ((2, 8, 1000, d), (2, 2, 1003, d), (2, 2, 1003, d))]
    for case, (q, k, v), opts in (
            ("f32_fma_dk_ne_dv_window100_sinks5", f32,
             dict(window=100, sinks=5, q_offset=133)),
            ("edge_window200_sinks3_offsets", edge,
             dict(window=200, sinks=3, q_offset=37, kv_valid=900))):
        kw = dict(scale=q.shape[-1] ** -0.5, causal=True, softcap=None,
                  **opts)
        out, lse = _flash_fwd_impl(q, k, v, **kw)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(
            q.dtype)
        window_bwd_case(kernels, case, (q, k, v, out, lse, dout), kw)
    emit(phase="backward", window_seconds=time.perf_counter() - t0)


def phase_segment_backward(ops, kernels) -> None:
    """Phase 2b's packed sequences.  At phase 2's packed geometry
    (`WINDOW_FLASH`, `PACKED_DOCS`, causal, bf16, 3-D) the fused kernel
    and the dQ + dK/dV pair with segment ids against
    `flash_backward_plain` under `reference.grad_mismatch`, both on the
    "wgmma" body; the same bits on a second call (the fused dQ within the
    limit of the first); the kernels run with the key ids shifted by one
    key must fail; with ids all equal the bits of the call without ids
    (the fused dQ within the limit).  Each kernel timed alone beside the
    same call without ids, with the bound of the kept pairs and, beside
    the fused kernel, SDPA's backward under the mask as a boolean mask.
    Then a packed `flash_attention_diff` forward and backward at that
    geometry on each path, its launches counted (one flash forward, and
    one fused kernel or one dQ and one dK/dV kernel), its output and
    gradients held against the plain versions.  Then the f32 FMA bodies
    with m != n and rows whose id no key holds."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash import flash_attention_plain
    from attention_tpu_torch.ops.flash_vjp import (
        _flash_fwd_impl,
        flash_attention_diff,
    )
    from attention_tpu_torch.ops.reference import (
        attention_mask,
        grad_mismatch,
    )

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    h, hkv, m, d = WINDOW_FLASH
    q, k, v, dout = (torch.randn((heads, m, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for heads in (h, hkv, hkv, h))
    ids = packed_ids(PACKED_DOCS)
    seg = dict(q_segment_ids=ids, kv_segment_ids=ids)
    zeros = torch.zeros(m, dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, causal=True, softcap=None)
    out, lse = _flash_fwd_impl(q, k, v, **kw, **seg)
    args = (q, k, v, out, lse, dout)
    plan = flash_bwd.bwd_launch_plan(*args, causal=True)
    pair_plan = plan.pop("pair")
    if plan["body"] != "wgmma" or pair_plan["body"] != "wgmma":
        raise AssertionError(f"packed: the fused kernel runs {plan}, the "
                             f"pair {pair_plan}")
    want = flash_bwd.flash_backward_plain(*args, **kw, **seg)

    def within(got, ref, what):
        errs = [grad_mismatch(g, w) for g, w in zip(got, ref)]
        if not all(ratio <= 1.0 for _, ratio in errs):
            raise AssertionError(f"{what}: {errs}")
        return errs

    names = ("dq", "dk", "dv")
    for path in ("fused", "pair"):
        flash_bwd._FORCE_TWO_KERNEL = path == "pair"
        try:
            got = flash_bwd.flash_backward(*args, **kw, **seg)
            again = flash_bwd.flash_backward(*args, **kw, **seg)
            fault = max(grad_mismatch(g, w)[1] for g, w in zip(
                flash_bwd.flash_backward(*args, **kw, q_segment_ids=ids,
                                         kv_segment_ids=shifted(ids)),
                want))
            equal_ids = flash_bwd.flash_backward(
                q, k, v, *_flash_fwd_impl(q, k, v, **kw), dout, **kw,
                q_segment_ids=zeros, kv_segment_ids=zeros)
            no_ids = flash_bwd.flash_backward(
                q, k, v, *_flash_fwd_impl(q, k, v, **kw), dout, **kw)
        finally:
            flash_bwd._FORCE_TWO_KERNEL = False
        torch.cuda.synchronize()
        errs = within(got, want, f"packed {path} off its plain version")
        if not fault > 1.0:
            raise AssertionError(f"packed {path}: the check passes the "
                                 f"kernels with shifted key ids: {fault}")
        run_to_run = equal_dq = None
        if path == "fused":
            same_bits(got[1:], again[1:])
            run_to_run = within(again[:1], got[:1], "fused dQ run to run")
            same_bits(equal_ids[1:], no_ids[1:], "all-equal ids and no ids")
            equal_dq = within(equal_ids[:1], no_ids[:1],
                              "fused dQ, all-equal ids and no ids")
        else:
            same_bits(got, again)
            same_bits(equal_ids, no_ids, "all-equal ids and no ids")
        for kernel, idx in ((flash_bwd.FUSED, (0, 1, 2)),) \
                if path == "fused" else ((flash_bwd.DQ, (0,)),
                                         (flash_bwd.DKV, (1, 2))):
            kernels[kernel]["max_abs_err"] = max(
                kernels[kernel]["max_abs_err"], *(errs[i][0] for i in idx))
        emit(phase="backward", path=path, case="packed_causal",
             **(dict(fused_plan=plan) if path == "fused"
                else dict(pair_plan=pair_plan)),
             max_abs_err=dict(zip(names, (e for e, _ in errs))),
             share_of_limit=dict(zip(names, (r for _, r in errs))),
             fused_dq_run_to_run=run_to_run,
             fused_dq_all_equal_ids=equal_dq,
             planted_faults_share_of_limit={"kv_ids_shifted_one_key": fault})
        del got, again, equal_ids, no_ids

    # each kernel alone, with and without ids, on staged operands
    kw4 = dict(scale=kw["scale"], causal=True, softcap=None, q_offset=0,
               kv_offset=0, kv_valid=m)
    args4 = [t[None] for t in args]
    staged = {"packed": flash_bwd._Staged(*args4, **kw4, q_ids=ids,
                                          kv_ids=ids),
              "unsegmented": flash_bwd._Staged(*args4, **kw4)}
    times = {}
    for name, st in staged.items():
        fused, pair = st.fused_buffers(), st.pair_buffers()
        for kernel, launch in (
                (flash_bwd.FUSED, lambda st=st, b=fused: st.fused(**b)),
                (flash_bwd.DQ, lambda st=st, b=pair: st.pair(
                    flash_bwd.DQ, dq=b["dq"])),
                (flash_bwd.DKV, lambda st=st, b=pair: st.pair(
                    flash_bwd.DKV, dk=b["dk"], dvo=b["dvo"]))):
            times[name, kernel] = (time_ms(launch), device_ms(launch))
        del fused, pair
    del staged
    mask = attention_mask(m, m, causal=True, device="cuda", **seg)
    pairs = int(mask.sum())
    kx, vx = (t.repeat_interleave(h // hkv, dim=0)[None] for t in (k, v))
    qq, kk, vv = (t.detach().requires_grad_() for t in (q[None], kx, vx))
    o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    def sdpa():
        return torch.autograd.grad(o, (qq, kk, vv), dout[None],
                                   retain_graph=True)

    library_ms, library_device_ms = time_ms(sdpa), device_ms(sdpa)
    del o, qq, kk, vv, kx, vx, mask
    plain_ms = time_ms(lambda: flash_bwd.flash_backward_plain(
        *args, **kw, **seg), calls=1, reps=3)
    cases = {kernel: kernels[kernel].setdefault("segment_cases", {})
             for kernel in (flash_bwd.FUSED, flash_bwd.DQ, flash_bwd.DKV)}
    for kernel, factor, outs in ((flash_bwd.FUSED, 10, "qkv"),
                                 (flash_bwd.DQ, 6, "q"),
                                 (flash_bwd.DKV, 8, "kv")):
        b_ms, b_by = bound_ms(*bwd_work(h, hkv, m, m, d, pairs, 2, factor,
                                        outs), torch.bfloat16)
        ms, dev = times["packed", kernel]
        rec = dict(ms=ms, device_ms=dev,
                   unsegmented_device_ms=times["unsegmented", kernel][1],
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms if kernel == flash_bwd.FUSED
                   else None,
                   library_device_ms=library_device_ms
                   if kernel == flash_bwd.FUSED else None)
        cases[kernel]["packed_causal"] = rec
        emit(phase="backward", kernel=kernel, case="packed_causal",
             shape=list(WINDOW_FLASH), kept_pairs=h * pairs,
             share_of_causal_pairs=pairs / (m * (m + 1) // 2),
             over_unsegmented=dev / rec["unsegmented_device_ms"],
             over_kept_pairs_bound=dev / b_ms,
             tflop_s=factor * d * h * pairs / dev / 1e9, **rec)

    # the packed flash_attention_diff, forward and backward, each path:
    # the launches of a training layer's call
    want_out = flash_attention_plain(q, k, v, causal=True, **seg)
    for path in ("fused", "pair"):
        flash_bwd._FORCE_TWO_KERNEL = path == "pair"
        try:
            qq, kk, vv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            ops.reset_launch_counts()
            o = flash_attention_diff(qq, kk, vv, causal=True, **seg)
            o.backward(dout)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            flash_bwd._FORCE_TWO_KERNEL = False
        expect = {"flash_fwd": 1, **({flash_bwd.FUSED: 1} if path == "fused"
                                     else {flash_bwd.DQ: 1,
                                           flash_bwd.DKV: 1})}
        if {x: n for x, n in launches.items() if n} != expect:
            raise AssertionError(f"packed diff {path}: launched {launches}")
        for kernel, n in expect.items():
            kernels[kernel]["launches"] += n
        err, ratio = held(o.detach(), want_out)
        errs = within((qq.grad, kk.grad, vv.grad), want,
                      f"packed flash_attention_diff {path}")
        emit(phase="backward", case="packed_flash_attention_diff",
             path=path, launches=expect, out_max_abs_err=err,
             out_share_of_limit=ratio,
             grad_share_of_limit=dict(zip(names, (r for _, r in errs))))
        del qq, kk, vv, o
    del q, k, v, dout, out, lse, args, args4, want, want_out

    # the FMA bodies: f32, m != n, a cached prefill's offset, rows 0-9 of
    # an id no key holds (their dQ 0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((4, 200, 64), (2, 333, 64), (2, 333, 64)))
    q_ids = (torch.arange(200, device="cuda") // 50).to(torch.int32)
    q_ids[:10] = 9
    kv_ids = (torch.arange(333, device="cuda") // 80).to(torch.int32)
    kw = dict(scale=0.125, causal=True, softcap=None, q_offset=133,
              q_segment_ids=q_ids, kv_segment_ids=kv_ids)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
    for path in ("fused", "pair"):
        flash_bwd._FORCE_TWO_KERNEL = path == "pair"
        try:
            got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
        finally:
            flash_bwd._FORCE_TWO_KERNEL = False
        torch.cuda.synchronize()
        errs = within(got, want, f"f32 fma {path}")
        if not bool((got[0][:, :10] == 0).all()):
            raise AssertionError("rows that see no key: dQ not 0")
        emit(phase="backward", path=path, case="f32_fma_m_ne_n_segments",
             max_abs_err=dict(zip(names, (e for e, _ in errs))),
             share_of_limit=dict(zip(names, (r for _, r in errs))))
    emit(phase="backward", segment_seconds=time.perf_counter() - t0)


def backward_times(kernels, case, args, kw) -> None:
    """Time one serving backward case: each kernel alone on the staged
    operands (the kernels line's ``ms``), `flash_backward` end to end on
    each path (staging, the fp32 dQ buffer's zero fill, the sums of slice
    partials and the casts included), the plain version, and (without
    softcap) SDPA's backward as the yardstick: beside the fused kernel,
    and beside the sum of the pair's two kernels' device ms (neither
    alone computes what one library call does)."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops import flash_bwd

    q, k, v, out, lse, dout = args
    _, h, s, d = q.shape
    hkv = k.shape[1]
    pairs = s * (s + 1) // 2
    staged = flash_bwd._Staged(*args, q_offset=0, kv_offset=0, kv_valid=s,
                               **kw)
    fused = staged.fused_buffers()
    pair = staged.pair_buffers()
    plain_ms = time_ms(lambda: flash_bwd.flash_backward_plain(*args, **kw),
                       calls=1, reps=3)
    end_to_end = {}
    for path in ("fused", "pair"):
        flash_bwd._FORCE_TWO_KERNEL = path == "pair"
        end_to_end[path] = time_ms(
            lambda: flash_bwd.flash_backward(*args, **kw))
        flash_bwd._FORCE_TWO_KERNEL = False
    library_ms = library_device_ms = None
    if kw["softcap"] is None:
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                           enable_gqa=True)

        def sdpa():
            return torch.autograd.grad(o, (qq, kk, vv), dout,
                                       retain_graph=True)

        library_ms, library_device_ms = time_ms(sdpa), device_ms(sdpa)
    launches = {
        flash_bwd.FUSED: lambda: staged.fused(**fused),
        flash_bwd.DQ: lambda: staged.pair(flash_bwd.DQ, dq=pair["dq"]),
        flash_bwd.DKV: lambda: staged.pair(flash_bwd.DKV, dk=pair["dk"],
                                           dvo=pair["dvo"])}
    pair_device = {kernel: device_ms(launches[kernel])
                   for kernel in (flash_bwd.DQ, flash_bwd.DKV)}
    emit(phase="backward", case=case, flash_backward_ms=end_to_end,
         pair_device_ms=dict(pair_device, sum=sum(pair_device.values())),
         library_ms=library_ms, library_device_ms=library_device_ms)
    for kernel, factor, outs in ((flash_bwd.FUSED, 10, "qkv"),
                                 (flash_bwd.DQ, 6, "q"),
                                 (flash_bwd.DKV, 8, "kv")):
        launch = launches[kernel]
        b_ms, b_by = bound_ms(*bwd_work(h, hkv, s, s, d, pairs, 2,
                                        factor, outs), torch.bfloat16)
        t = dict(ms=time_ms(launch), plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=library_ms
                 if kernel == flash_bwd.FUSED else None)
        if kernel in pair_device:
            t["device_ms"] = pair_device[kernel]
        emit(phase="backward", kernel=kernel, case=case,
             tflop_s=factor * d * h * pairs / t["ms"] / 1e9, **t)
        if kw["softcap"] is None:
            kernels[kernel].update(t)


@contextlib.contextmanager
def step_spans(optimizer):
    """CUDA events around each call of ``optimizer.step``, the outermost
    where a subclass's step runs its parent's (both run the step hooks):
    a list of [start, end] pairs, for the step's span on the card."""
    spans, depth = [], [0]

    def pre(opt, args, kwargs):
        depth[0] += 1
        if depth[0] == 1:
            spans.append([torch.cuda.Event(enable_timing=True)])
            spans[-1][0].record()

    def post(opt, args, kwargs):
        depth[0] -= 1
        if depth[0] == 0:
            spans[-1].append(torch.cuda.Event(enable_timing=True))
            spans[-1][1].record()

    hooks = (optimizer.register_step_pre_hook(pre),
             optimizer.register_step_post_hook(post))
    try:
        yield spans
    finally:
        for hook in hooks:
            hook.remove()


@contextlib.contextmanager
def aux_losses(model):
    """The MoE layers' aux losses of every forward of ``model``, as
    they come (an empty list for a dense model)."""
    from attention_tpu_torch.models import MoEMLP

    got = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: got.append(out[1].detach()))
        for m in model.modules() if isinstance(m, MoEMLP)]
    try:
        yield got
    finally:
        for hook in hooks:
            hook.remove()


def phase_train(ops, kernels, model, *, batch_shape=TRAIN_BATCH,
                cell: str = "dense", against_plain: bool = False) -> dict:
    """Training at the serving model's full width: `init_train` (float32
    masters of the bf16 weights), then `TRAIN_STEPS` fused steps of
    `make_train_step` on one seeded batch of ``batch_shape`` tokens (4 x
    2049; the windowed cell one sequence of 8193), every loss finite and
    the last below the first (an MoE model's aux loss, part of the
    loss, printed apart); the forward flash kernel and the fused
    backward kernel once per layer per step, nothing else.  Then two
    steps from the same start with the dQ + dK/dV pair: the first loss
    equal to the fused run's (the same forward on the same weights),
    the second within `TRAIN_LOSS_TOL`.  Then the gradients of both
    paths (`train_grads_agree`), for the dense cell remat
    (`remat_agrees`), and one fused step under `torch.profiler`: device
    time by class, which it returns.  Every line names the ``cell``.
    With ``against_plain`` the fused steps run again from the same start
    with the attention in PyTorch ops (``impl="xla"``, no kernel): each
    step's loss within `TRAIN_PLAIN_RTOL` of the kernels' up to the
    first step at which the plain loss rises, and from it on each loss
    moving the plain one's way (a run whose loss jumps at a step, AdamW
    at lr 1e-3 on one batch, jumps on both paths, and the paths' rounding
    apart grows with it); the loss held to fall below the first at its
    lowest, not at the last step."""
    from torch.profiler import ProfilerActivity, profile

    from attention_tpu_torch.models import init_train, make_train_step
    from attention_tpu_torch.ops import flash, flash_bwd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    batch = torch.randint(0, model.vocab, batch_shape, generator=gen,
                          device="cuda")
    tokens = batch_shape[0] * (batch_shape[1] - 1)
    losses, medians = {}, {}
    for path, steps, bwd in (("fused", TRAIN_STEPS, (flash_bwd.FUSED,)),
                             ("pair", 2, (flash_bwd.DQ, flash_bwd.DKV))):
        flash_bwd._FORCE_TWO_KERNEL = path == "pair"
        step = optimizer = None  # the last path's optimizer goes first
        optimizer = init_train(model, seed=SEED, lr=TRAIN_LR)
        step = make_train_step(model, optimizer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        got, aux, step_ms = [], [], []
        with aux_losses(model) as layer_aux, step_spans(optimizer) as spans:
            for _ in range(steps):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in "se")
                start.record()
                loss = step(batch)
                end.record()
                end.synchronize()
                got.append(loss.item())
                step_ms.append(start.elapsed_time(end))
                aux.append(sum(a.item() for a in layer_aux))
                layer_aux.clear()
        launches = ops.launch_counts()
        by_variant = ops.variant_counts().get("flash_fwd", {})
        # the guard's verdicts, summed on the card during the run
        demoted = ops.demotion_count()
        flash_bwd._FORCE_TWO_KERNEL = False
        # the layer's flash path runs max_mode "bound" (JAX's): it lowers
        # the bound body unless a window or a small call resolves it to
        # online
        lowered = flash.resolve_max_mode(
            "bound", heads=batch_shape[0] * model.num_q_heads,
            m=batch_shape[1] - 1, n=batch_shape[1] - 1, causal=True,
            window=model.window)
        if by_variant != {lowered: steps * model.depth}:
            raise AssertionError(f"{path} forward variants {by_variant}, "
                                 f"want {lowered}")
        want = {"flash_fwd": steps * model.depth,
                **{kernel: steps * model.depth for kernel in bwd}}
        if {k: c for k, c in launches.items() if c} != want:
            raise AssertionError(f"{path} steps launched {launches}, "
                                 f"want {want}")
        if not all(np.isfinite(got + aux)):
            raise AssertionError(f"{path}: non-finite loss {got}, aux {aux}")
        for kernel in bwd:
            kernels[kernel]["launches"] += launches[kernel]
        kernels["flash_fwd"]["launches"] += launches["flash_fwd"]
        losses[path] = got
        ms = medians[path] = statistics.median(step_ms[1:])
        emit(phase="train", cell=cell, path=path, losses=got,
             aux_losses=aux if model.moe_experts else None,
             step_ms=step_ms, optimizer_step_ms=statistics.median(
                 a.elapsed_time(b) for a, b in spans[1:]),
             median_step_ms=ms, tokens_per_step=tokens,
             tokens_per_s=tokens / ms * 1e3, launches=launches,
             flash_fwd_variants=by_variant, guard_demoted=demoted,
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    del step, optimizer
    fused, pair = losses["fused"], losses["pair"]
    if cell == "dense":
        # the fused steps again from the same start with the forward's
        # "bound" resolved to online (the threshold out of reach): step 1's
        # loss within the bf16 tolerance of this phase, and the step ms
        # beside bound's, the main path's cost of the bound body and guard
        old = flash._BOUND_MIN_SCORE_ELEMS
        flash._BOUND_MIN_SCORE_ELEMS = float("inf")
        try:
            optimizer = init_train(model, seed=SEED, lr=TRAIN_LR)
            step = make_train_step(model, optimizer)
            ops.reset_launch_counts()
            online, online_ms = [], []
            for _ in range(TRAIN_STEPS):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in "se")
                start.record()
                loss = step(batch)
                end.record()
                end.synchronize()
                online.append(loss.item())
                online_ms.append(start.elapsed_time(end))
            by_variant = ops.variant_counts().get("flash_fwd", {})
        finally:
            flash._BOUND_MIN_SCORE_ELEMS = old
        del step, optimizer
        if (by_variant != {"online": TRAIN_STEPS * model.depth}
                or not abs(online[0] - fused[0]) <= TRAIN_LOSS_TOL):
            raise AssertionError(f"online step {online[0]} ({by_variant}) "
                                 f"against bound's {fused[0]}")
        emit(phase="train", cell=cell, online_step1_loss=online[0],
             bound_step1_loss=fused[0], diff=online[0] - fused[0],
             tol=TRAIN_LOSS_TOL, flash_fwd_variants=by_variant,
             online_losses=online, online_step_ms=online_ms,
             online_median_step_ms=statistics.median(online_ms[1:]),
             bound_median_step_ms=medians["fused"])
    if against_plain:
        flash_impl = [blk.attn.impl for blk in model.blocks]
        for blk in model.blocks:
            blk.attn.impl = "xla"
        try:
            step = make_train_step(model, init_train(model, seed=SEED,
                                                     lr=TRAIN_LR))
            ops.reset_launch_counts()
            plain = [step(batch).item() for _ in range(TRAIN_STEPS)]
            launches = {k: c for k, c in ops.launch_counts().items() if c}
        finally:
            for blk, impl in zip(model.blocks, flash_impl):
                blk.attn.impl = impl
        del step
        rel = [abs(a - b) / abs(b) for a, b in zip(fused, plain)]
        # held to the limit up to the first step at which the plain
        # path's loss rises; from it on each move in the plain one's
        # direction where that moves by more than the limit
        rise = next((i for i in range(1, len(plain))
                     if plain[i] > plain[i - 1]), len(plain))
        moves_agree = all(
            (fused[i] - fused[i - 1]) * (plain[i] - plain[i - 1]) > 0
            for i in range(rise, len(plain))
            if abs(plain[i] - plain[i - 1])
            > TRAIN_PLAIN_RTOL * abs(plain[i - 1]))
        emit(phase="train", cell=cell, plain_impl_losses=plain,
             fused_vs_plain_rel=rel, held_steps=rise, tol=TRAIN_PLAIN_RTOL,
             moves_agree=moves_agree, plain_launches=launches)
        if (launches or not np.isfinite(plain).all() or not moves_agree
                or not max(rel[:rise]) <= TRAIN_PLAIN_RTOL):
            raise AssertionError(f"{cell}: fused losses {fused} against "
                                 f"the plain path's {plain} ({launches})")
    if not (fused[-1] < fused[0]
            or (against_plain and min(fused[1:]) < fused[0])):
        raise AssertionError(f"the loss did not fall: {fused}")
    if not (abs(pair[0] - fused[0]) <= 1e-5 * abs(fused[0])
            and abs(pair[1] - fused[1]) <= TRAIN_LOSS_TOL):
        raise AssertionError(f"two-kernel losses {pair} against fused "
                             f"{fused[:2]}")
    emit(phase="train", cell=cell,
         pair_vs_fused_loss=[pair[0] - fused[0], pair[1] - fused[1]],
         tol=TRAIN_LOSS_TOL)
    fused_grads = train_grads_agree(model, batch, cell)
    if cell == "dense":
        remat_agrees(model, batch, fused[0], fused_grads)
    del fused_grads

    step = make_train_step(model, init_train(model, seed=SEED, lr=TRAIN_LR))
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del step

    def classify(name):
        name = name.lower()
        return ("flash_bwd" if "major" in name or "flash_bwd" in name
                else "flash_fwd" if "flash_fwd" in name
                else "memcpy/memset" if name.startswith("mem")
                else "optimizer" if "multi_tensor" in name
                else "matmul" if any(w in name for w in (
                    "gemm", "xmma", "cutlass", "sm90", "nvjet"))
                else "other")

    classes, by_name = device_classes(prof, classify,
                                      experts=bool(model.moe_experts))
    busy = sum(classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit(phase="train", cell=cell, profiled_step_wall_ms=wall * 1e3,
         device_busy_ms=busy, busy_share=busy / (wall * 1e3),
         device_ms_by_class=classes,
         top_kernels=[{"name": n, "count": c, "ms": t} for n, (c, t) in top])
    return classes


def remat_agrees(model, batch, fused_loss: float, fused_grads) -> None:
    """One step's loss and gradients with ``remat=True`` from the seeded
    start: the loss equal to the fused run's first (the same forward;
    the recomputed blocks give the same bits), every gradient within
    `TRAIN_GRAD_REL_TOL` of the fused path's (relative L2; its dQ adds
    in no fixed order), and the peak memory of the forward and backward
    below the same call's without remat; both peaks printed."""
    from attention_tpu_torch.models import init_params, loss_fn

    peaks = {}
    for remat in (False, True):
        model.remat = remat
        model.load_state_dict(init_params(model, SEED))
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = loss_fn(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
    model.remat = False
    remat_loss = loss.item()
    rel = max(((p.grad.float() - fused_grads[k].float()).norm()
               / fused_grads[k].float().norm()).item()
              for k, p in model.named_parameters())
    model.zero_grad(set_to_none=True)
    emit(phase="train", cell="dense_remat", loss=remat_loss,
         fused_first_loss=fused_loss, grads_vs_fused_rel_l2=rel,
         tol=TRAIN_GRAD_REL_TOL, peak_over_weights_gib=peaks[False],
         remat_peak_over_weights_gib=peaks[True])
    if not (remat_loss == fused_loss and rel <= TRAIN_GRAD_REL_TOL
            and peaks[True] < peaks[False]):
        raise AssertionError(f"remat: loss {remat_loss} against "
                             f"{fused_loss}, gradients {rel}, peaks "
                             f"{peaks}")


def train_grads_agree(model, batch, cell: str = "dense") -> dict:
    """The full-width gradients themselves, each from one `loss_fn` and
    `backward()` at the seeded start, against the fused kernel's by
    relative L2 distance per parameter: the fused path run again (its dQ
    atomics add in another order) and the pair must lie within
    `TRAIN_GRAD_REL_TOL`, the fused path with a 2% scale error planted in
    the dK it returns beyond it.  Returns the fused gradients."""
    from attention_tpu_torch.models import init_params, loss_fn
    from attention_tpu_torch.ops import flash_bwd, flash_vjp

    kernel_backward = flash_vjp.flash_backward

    def dk_scale_off_2pct(*args, **kw):
        dq, dk, dv = kernel_backward(*args, **kw)
        return dq, dk * 1.02, dv

    def grads(pair=False, backward=kernel_backward):
        model.load_state_dict(init_params(model, SEED))
        model.zero_grad(set_to_none=True)
        flash_bwd._FORCE_TWO_KERNEL, flash_vjp.flash_backward = pair, backward
        loss_fn(model, batch).backward()
        flash_bwd._FORCE_TWO_KERNEL = False
        flash_vjp.flash_backward = kernel_backward
        out = {k: p.grad for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    fused = grads()

    def furthest(other):
        """The three parameters whose gradients lie furthest from the
        fused ones: {name: |other - fused| / |fused|, L2 norms}."""
        rel = sorted(((k, ((g.float() - fused[k].float()).norm()
                           / fused[k].float().norm()).item())
                      for k, g in other.items()), key=lambda x: -x[1])
        return dict(rel[:3])

    again = furthest(grads())
    pair = furthest(grads(pair=True))
    planted = furthest(grads(backward=dk_scale_off_2pct))
    emit(phase="train", cell=cell, grads_fused_run_to_run_rel_l2=again,
         grads_pair_vs_fused_rel_l2=pair,
         planted_dk_scale_off_2pct_rel_l2=planted, tol=TRAIN_GRAD_REL_TOL)
    if not max(again.values()) <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"fused gradients run to run: {again}")
    if not max(pair.values()) <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"pair gradients off the fused ones: {pair}")
    if not max(planted.values()) > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"the check passes a planted fault: {planted}")
    return fused


def cpu_precision() -> dict:
    """The settings that choose the CPU's f32 arithmetic, after pinning
    every reduced-precision f32 path they name to full f32 (the plain
    versions are the reference; a TF32 or bf16 f32 matmul would make two
    CPU forwards part by about 1e-3): {setting: value, "pinned": [...]}"""
    mkl = torch.backends.mkldnn
    pinned = []
    if torch.get_float32_matmul_precision() != "highest":
        pinned.append(f"float32_matmul_precision="
                      f"{torch.get_float32_matmul_precision()}")
        torch.set_float32_matmul_precision("highest")
    holders = {"backends": torch.backends, "mkldnn": mkl,
               "mkldnn.matmul": getattr(mkl, "matmul", None),
               "mkldnn.conv": getattr(mkl, "conv", None)}
    for name, obj in holders.items():
        if getattr(obj, "fp32_precision", "ieee") not in ("ieee", "none"):
            pinned.append(f"{name}.fp32_precision={obj.fp32_precision}")
            obj.fp32_precision = "ieee"
    out = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
           "num_threads": torch.get_num_threads(),
           "mkldnn_enabled": mkl.enabled,
           "mkldnn_deterministic": mkl.deterministic,
           "cpu_capability": torch.backends.cpu.get_cpu_capability()}
    out.update({f"{name}.fp32_precision": obj.fp32_precision
                for name, obj in holders.items()
                if hasattr(obj, "fp32_precision")})
    return dict(out, pinned=pinned)


def first_parting_module(model, tokens) -> dict:
    """Two more forwards of ``model`` with a hook on every module: the
    first module, in call order, whose output differs between them, and
    by how much (None for the module when the two agree)."""
    runs = []
    for _ in range(2):
        outs = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out, name=name: outs.append((name, (
                out[0] if isinstance(out, tuple) else out).detach().clone())))
            for name, m in model.named_modules()]
        try:
            with torch.no_grad():
                model(tokens)
        finally:
            for hook in hooks:
                hook.remove()
        runs.append(outs)
    for (name, a), (_, b) in zip(*runs):
        if not torch.equal(a, b):
            return {"module": name or "(model)",
                    "max_abs": (a - b).abs().max().item(),
                    "differing": int((a != b).sum())}
    return {"module": None, "modules_compared": len(runs[0])}


def phase_reference(model_kw: dict = SMALL_MODEL, label=None,
                    plain_witness: bool = False) -> None:
    """A small f32 model on the card (the kernels) against the same
    weights on the CPU (the plain versions): uncached logits through
    the flash kernel, and greedy token streams through the ragged one.
    A float64 copy on the CPU is the witness that tells which side
    strayed when the two disagree.  ``model_kw`` is the model
    (`SMALL_MODEL`, or phase 8's `D256_SMALL`), ``label`` names it in
    the lines, ``plain_witness`` goes to `reference_training`."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
        synthetic_trace,
    )
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.models import decode as gen

    cpu = TinyDecoder(dtype=torch.float32, device="cpu", **model_kw)
    cpu.load_state_dict(init_params(cpu, SEED))
    gpu = TinyDecoder(dtype=torch.float32, device="cuda", **model_kw)
    gpu.load_state_dict(cpu.state_dict())
    f64 = TinyDecoder(dtype=torch.float64, device="cpu", **model_kw)
    f64.load_state_dict(cpu.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model_kw["vocab"], (2, 256)))
    emit(phase="reference", model=label, cpu_precision=cpu_precision())
    with torch.no_grad():
        want = cpu(tokens)
        again = cpu(tokens)
        if not torch.equal(want, again):
            # name the module where two CPU forwards part; the check
            # below still fails the run
            emit(phase="reference", model=label, cpu_forwards_part=first_parting_module(
                cpu, tokens), cpu_precision=cpu_precision())
        same_bits(want, again, "two CPU forwards")
        got = gpu(tokens.cuda())
        same_bits(got, gpu(tokens.cuda()), "two card forwards")
        got = got.cpu()
        witness = f64(tokens).double()
    err = (got - want).abs().max().item()
    emit(phase="reference", model=label, logits_max_abs_err=err, tol=1e-4,
         card_vs_f64=(got.double() - witness).abs().max().item(),
         cpu_vs_f64=(want.double() - witness).abs().max().item())
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the card")
    # the card's kernels and cuBLAS against the host's plain versions and
    # BLAS, all in full f32: the two differ only in summation order
    if not err <= 1e-4:
        raise AssertionError(f"logits differ from the CPU by {err}")
    trace = synthetic_trace(6, vocab=model_kw["vocab"], seed=SEED,
                            prompt_len_min=4, prompt_len_max=300,
                            max_tokens=12)
    streams = [replay(ServingEngine(m, EngineConfig(
        num_pages=32, max_seq_len=512, prefill_chunk=64, step_mode=mode)),
        trace)[1] for m in (cpu, gpu) for mode in ("ragged", "two_call")]
    if any(st != streams[0] for st in streams):
        raise AssertionError("greedy engine streams differ between card "
                             "and CPU or between step modes")
    emit(phase="reference", model=label, engine_streams_equal=True, requests=len(trace),
         step_modes=["ragged", "two_call"])

    # the three generate functions: equal prompts through all three, and
    # ragged prompts through the ragged and paged ones, card and CPU
    prompts = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, model_kw["vocab"], (3, 100)))
    full, ragged = torch.full((3,), 100), torch.tensor([100, 37, 64])
    toks = []
    for m in (cpu, gpu):
        toks += [gen.generate(m, prompts, steps=12),
                 gen.generate_ragged(m, prompts, full, steps=12),
                 gen.generate_paged(m, prompts, full, steps=12)[0]]
    raggeds = [gen.generate_ragged(m, prompts, ragged, steps=12)
               for m in (cpu, gpu)]
    raggeds += [gen.generate_paged(m, prompts, ragged, steps=12)[0]
                for m in (cpu, gpu)]
    if any(not torch.equal(t.cpu(), toks[0]) for t in toks) or any(
            not torch.equal(t.cpu(), raggeds[0]) for t in raggeds):
        raise AssertionError("greedy generate streams differ between the "
                             "functions or between card and CPU")
    emit(phase="reference", model=label, generate_streams_equal=True,
         functions=["generate", "generate_ragged", "generate_paged"])

    # int8 caches: 16 teacher-forced steps after a 24-token prefill, and
    # greedy generate(int8_cache=True)
    tokens = torch.as_tensor(np.random.default_rng(SEED + 2).integers(
        0, model_kw["vocab"], (2, 40)))
    logits = []
    for m in (cpu, gpu):
        with torch.no_grad():
            caches = tuple(c.quantize() for c in gen.prefill(
                m, tokens[:, :24].to(m.device), 128)[1])
            steps = []
            for t in range(24, 40):
                out, caches = m(tokens[:, t:t + 1].to(m.device), caches)
                steps.append(out.cpu())
        logits.append(torch.cat(steps, dim=1))
    err = (logits[1] - logits[0]).abs().max().item()
    emit(phase="reference", model=label, int8_logits_max_abs_err=err,
         tol=INT8_LOGITS_TOL, logits_max_abs=logits[0].abs().max().item())
    if not (err <= INT8_LOGITS_TOL and logits[1].isfinite().all()):
        raise AssertionError(f"int8-cache logits differ from the CPU by "
                             f"{err}")
    streams = [gen.generate(m, prompts, steps=12, int8_cache=True).cpu()
               for m in (cpu, gpu)]
    if not torch.equal(*streams):
        raise AssertionError("greedy generate(int8_cache=True) streams "
                             "differ between card and CPU")
    emit(phase="reference", model=label, int8_generate_streams_equal=True)
    reference_training(cpu, gpu, f64, label, plain_witness)


def phase_window_reference() -> None:
    """The small f32 model with a window and sinks (`SMALL_BAND`) on the
    card against the same weights on the CPU: uncached logits within
    1e-4 (as phase 6's); greedy token streams equal between card and CPU
    for `generate` on full and on rolling caches, `generate_ragged`,
    `generate_paged`, `generate(int8_cache=True)` and the engine in
    two-call mode, and the rolling streams equal to the full-cache ones
    on each side (the prompts pass the window, so the ring wraps)."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
        synthetic_trace,
    )
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.models import decode as gen

    t0 = time.perf_counter()
    cpu = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL_MODEL,
                      **SMALL_BAND)
    cpu.load_state_dict(init_params(cpu, SEED))
    gpu = TinyDecoder(dtype=torch.float32, device="cuda", **SMALL_MODEL,
                      **SMALL_BAND)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, SMALL_MODEL["vocab"], (2, 256)))
    with torch.no_grad():
        err = (gpu(tokens.cuda()).cpu() - cpu(tokens)).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"windowed logits differ from the CPU by {err}")
    prompts = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, SMALL_MODEL["vocab"], (3, 100)))
    ragged = torch.tensor([100, 37, 64])
    streams = {}
    for side, m in (("cpu", cpu), ("card", gpu)):
        streams[side] = dict(
            generate=gen.generate(m, prompts, steps=12),
            rolling=gen.generate(m, prompts, steps=12, rolling_cache=True),
            ragged=gen.generate_ragged(m, prompts, ragged, steps=12),
            paged=gen.generate_paged(m, prompts, ragged, steps=12)[0],
            int8=gen.generate(m, prompts, steps=12, int8_cache=True))
    for name, toks in streams["cpu"].items():
        if not torch.equal(streams["card"][name].cpu(), toks):
            raise AssertionError(f"windowed {name} streams differ between "
                                 "card and CPU")
    for side in streams.values():
        if not torch.equal(side["rolling"], side["generate"]):
            raise AssertionError("rolling and full-cache streams differ")
    trace = synthetic_trace(6, vocab=SMALL_MODEL["vocab"], seed=SEED,
                            prompt_len_min=4, prompt_len_max=300,
                            max_tokens=12)
    engine = [replay(ServingEngine(m, EngineConfig(
        num_pages=32, max_seq_len=512, prefill_chunk=64,
        step_mode="two_call")), trace)[1] for m in (cpu, gpu)]
    if engine[0] != engine[1]:
        raise AssertionError("windowed engine streams differ between card "
                             "and CPU")
    emit(phase="reference", model=SMALL_BAND, logits_max_abs_err=err,
         tol=1e-4, streams_equal=sorted(streams["cpu"]) + ["engine"],
         seconds=time.perf_counter() - t0)
    f64 = TinyDecoder(dtype=torch.float64, device="cpu", **SMALL_MODEL,
                      **SMALL_BAND)
    reference_training(cpu, gpu, f64, label=SMALL_BAND)


def topk_margin(model, tokens) -> float:
    """The smallest gap, over every MoE layer and token of a forward of
    ``model`` on ``tokens``, between a token's k-th router probability
    and its next: how near the run came to a routing flip."""
    from attention_tpu_torch.models import MoEMLP

    gaps = []

    def hook(mod, args):
        x = args[0].reshape(-1, args[0].shape[-1])
        probs = torch.softmax(mod.router(x.to(mod.router.weight.dtype)),
                              dim=-1).sort(dim=-1, descending=True).values
        gaps.append((probs[:, mod.top_k - 1] - probs[:, mod.top_k]).min())

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, MoEMLP)]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for h in hooks:
            h.remove()
    return min(g.item() for g in gaps)


def phase_moe_reference() -> None:
    """The small f32 model with 4 experts at capacity factor 1.25
    (`SMALL_MOE`: both sides drop pairs) on the card against the same
    weights on the CPU: uncached logits within 1e-4 (as phase 6's);
    greedy streams equal between card and CPU for the engine in both
    step modes and for `generate`, `generate_ragged` and
    `generate_paged`; then training as phase 6's (`reference_training`,
    the router's gradient included).  A routing flip would show as an
    O(1) error on one token, so the smallest top-k margin of the CPU's
    forward is printed first."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
        synthetic_trace,
    )
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.models import decode as gen

    t0 = time.perf_counter()
    cfg = dict(SMALL_MODEL, **SMALL_MOE)
    cpu = TinyDecoder(dtype=torch.float32, device="cpu", **cfg)
    cpu.load_state_dict(init_params(cpu, SEED))
    gpu = TinyDecoder(dtype=torch.float32, device="cuda", **cfg)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, SMALL_MODEL["vocab"], (2, 256)))
    emit(phase="reference", model=SMALL_MOE,
         smallest_topk_margin=topk_margin(cpu, tokens))
    with torch.no_grad():
        err = (gpu(tokens.cuda()).cpu() - cpu(tokens)).abs().max().item()
    emit(phase="reference", model=SMALL_MOE, logits_max_abs_err=err,
         tol=1e-4)
    if not err <= 1e-4:
        raise AssertionError(f"MoE logits differ from the CPU by {err}")
    prompts = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, SMALL_MODEL["vocab"], (3, 100)))
    ragged = torch.tensor([100, 37, 64])
    streams = {}
    for side, m in (("cpu", cpu), ("card", gpu)):
        streams[side] = dict(
            generate=gen.generate(m, prompts, steps=12).cpu(),
            ragged=gen.generate_ragged(m, prompts, ragged, steps=12).cpu(),
            paged=gen.generate_paged(m, prompts, ragged,
                                     steps=12)[0].cpu())
    trace = synthetic_trace(6, vocab=SMALL_MODEL["vocab"], seed=SEED,
                            prompt_len_min=4, prompt_len_max=300,
                            max_tokens=12)
    engine = {}
    for mode in ("ragged", "two_call"):
        engine[mode] = [replay(ServingEngine(m, EngineConfig(
            num_pages=32, max_seq_len=512, prefill_chunk=64,
            step_mode=mode)), trace)[1] for m in (cpu, gpu)]
    differ = [name for name, toks in streams["cpu"].items()
              if not torch.equal(streams["card"][name], toks)]
    differ += [f"engine_{mode}" for mode, (a, b) in engine.items()
               if a != b]
    emit(phase="reference", model=SMALL_MOE,
         streams_differ_card_vs_cpu=differ,
         seconds=time.perf_counter() - t0)
    if differ:
        raise AssertionError(f"MoE greedy streams differ between card and "
                             f"CPU: {differ}")
    f64 = TinyDecoder(dtype=torch.float64, device="cpu", **cfg)
    reference_training(cpu, gpu, f64, label=SMALL_MOE)


def phase_checkpoint(model_kw: dict) -> None:
    """Checkpoint and resume on the card, on the dQ + dK/dV pair (its
    gradients are the same bits every call): three steps straight
    through; then two steps from the same start, `save_checkpoint`, a
    fresh model and optimizer (another seed) restored with
    `restore_checkpoint`, and the third step, whose loss must be the
    same bits as the straight run's.  A torn step directory (no
    completion marker) written beside it must be passed over by
    `latest_step`.  The checkpoint lives in a temporary directory, gone
    at the end."""
    from attention_tpu_torch.models import (
        TinyDecoder,
        complete_steps,
        init_train,
        latest_step,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from attention_tpu_torch.ops import flash_bwd

    t0 = time.perf_counter()
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **model_kw)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    batch = torch.randint(0, model.vocab, TRAIN_BATCH, generator=gen,
                          device="cuda")
    flash_bwd._FORCE_TWO_KERNEL = True
    try:
        step = make_train_step(model, init_train(model, seed=SEED,
                                                 lr=TRAIN_LR))
        straight = [step(batch).item() for _ in range(3)]
        optimizer = init_train(model, seed=SEED, lr=TRAIN_LR)
        step = make_train_step(model, optimizer)
        first = [step(batch).item() for _ in range(2)]
        with tempfile.TemporaryDirectory() as ckpt:
            t1 = time.perf_counter()
            path = save_checkpoint(ckpt, 2, model, optimizer)
            save_s = time.perf_counter() - t1
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            os.makedirs(os.path.join(ckpt, "9"))
            with open(os.path.join(ckpt, "9", "state.pt"), "wb") as f:
                f.write(b"torn")
            found = latest_step(ckpt), complete_steps(ckpt)
            del step, optimizer, model
            model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                                **model_kw)
            optimizer = init_train(model, seed=SEED + 1, lr=TRAIN_LR)
            t1 = time.perf_counter()
            restored = restore_checkpoint(ckpt, model, optimizer)
            restore_s = time.perf_counter() - t1
        third = make_train_step(model, optimizer)(batch).item()
    finally:
        flash_bwd._FORCE_TWO_KERNEL = False
    emit(phase="checkpoint", depth=model.depth, straight=straight,
         resumed=first + [third], latest_step=found[0],
         complete_steps=found[1], restored_step=restored,
         checkpoint_gib=nbytes / 2**30, save_s=save_s, restore_s=restore_s,
         seconds=time.perf_counter() - t0)
    if not (found == (2, [2]) and restored == 2 and first == straight[:2]
            and third == straight[2]):
        raise AssertionError(f"resumed losses {first + [third]} against "
                             f"{straight}, latest {found}, restored "
                             f"{restored}")


def reference_training(cpu, gpu, f64, label=None,
                       plain_witness: bool = False) -> None:
    """Training on the small model, card (the f32 backward kernels)
    against CPU (the plain versions) from the same weights: one loss and
    `backward()`, every gradient within `reference.grad_mismatch`'s f32
    limit and the loss within `TRAIN_F32_LOSS_TOL`, a float64 copy as the
    witness; then three AdamW steps each, their losses within
    `TRAIN_F32_STEP_LOSS_TOL`.  ``label`` names the model's options in
    the lines: a windowed model's window and sinks (its card backward:
    the kernels over the band and the sink patch; its CPU one the plain
    version over the whole mask), or an MoE model's experts.  With
    ``plain_witness`` the card's gradients that lie past the f32 limit
    from the CPU's pass where they lie within as large a share of that
    limit from the float64 gradients as the same card's with the
    attention in PyTorch ops (``impl="xla"``, no kernel): the card's own
    float32 products part from the CPU's there, and the kernels add
    nothing beyond them."""
    from attention_tpu_torch.models import loss_fn, make_train_step
    from attention_tpu_torch.models.train import ADAMW
    from attention_tpu_torch.ops.reference import grad_mismatch

    tokens = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, cpu.vocab, (2, 257)))
    start = {k: t.clone() for k, t in cpu.state_dict().items()}
    impls = [blk.attn.impl for blk in gpu.blocks]
    sides = [("cpu", cpu), ("card", gpu), ("f64", f64)]
    if plain_witness:
        sides.append(("card_plain", gpu))
    grads, loss = {}, {}
    for name, m in sides:
        m.load_state_dict(start)
        m.zero_grad(set_to_none=True)
        if name == "card_plain":
            for blk in m.blocks:
                blk.attn.impl = "xla"
        out = loss_fn(m, tokens.to(m.device))
        out.backward()
        loss[name] = out.item()
        grads[name] = {k: p.grad.detach().cpu()
                       for k, p in m.named_parameters()}
    for blk, impl in zip(gpu.blocks, impls):
        blk.attn.impl = impl
    worst = max((grad_mismatch(grads["card"][k], g) + (k,)
                 for k, g in grads["cpu"].items()), key=lambda x: x[1])
    gap = {side: max((grads[side][k].double() - g).abs().max().item()
                     for k, g in grads["f64"].items())
           for side in ("card", "cpu")}
    # each side's largest share of the f32 limit from the float64 gradients
    f64_share = {side: max(grad_mismatch(grads[side][k], g.float())[1]
                           for k, g in grads["f64"].items())
                 for side, _ in sides if side != "f64"}
    emit(phase="reference", model=label,
         train_loss={"card": loss["card"], "cpu": loss["cpu"],
                     "f64": loss["f64"]},
         grad_worst={"param": worst[2], "max_abs_err": worst[0],
                     "share_of_limit": worst[1]},
         grads_card_vs_f64=gap["card"], grads_cpu_vs_f64=gap["cpu"],
         share_of_limit_vs_f64=f64_share, loss_tol=TRAIN_F32_LOSS_TOL)
    witnessed = plain_witness and \
        f64_share["card"] <= f64_share["card_plain"]
    if not (abs(loss["card"] - loss["cpu"]) <= TRAIN_F32_LOSS_TOL
            and (worst[1] <= 1.0 or witnessed)):
        raise AssertionError(f"training gradients differ from the CPU: "
                             f"loss {loss}, worst {worst}, against float64 "
                             f"{f64_share}")
    steps = []
    for m in (cpu, gpu):
        m.load_state_dict(start)
        step = make_train_step(m, torch.optim.AdamW(
            m.parameters(), lr=TRAIN_LR, **ADAMW))
        steps.append([step(tokens.to(m.device)).item() for _ in range(3)])
    gap = max(abs(a - b) for a, b in zip(*steps))
    emit(phase="reference", model=label,
         adamw_step_losses={"cpu": steps[0], "card": steps[1]},
         max_abs_err=gap, tol=TRAIN_F32_STEP_LOSS_TOL)
    if not (gap <= TRAIN_F32_STEP_LOSS_TOL and steps[1][2] < steps[1][0]):
        raise AssertionError(f"AdamW steps differ from the CPU: {steps}")


def launched(evt):
    """The CUDA kernels a profiled CPU event launched, its children's
    included (`torch.profiler`'s ``Kernel`` records: name, duration in
    microseconds)."""
    yield from evt.kernels
    for child in evt.cpu_children:
        yield from launched(child)


def device_classes(prof, classify, experts: bool = False
                   ) -> tuple[dict, dict]:
    """Device ms by class from a `torch.profiler` run, each CUDA kernel
    by ``classify(name)``; for an MoE model (``experts``) the kernels
    that ``aten::bmm`` launched (its experts' products; nothing else on
    such a model's path calls it, where the sink patch of a windowed
    model does) moved into a class of their own, "experts"; and device
    ms by kernel name: ({class: ms}, {name: [count, ms]}).  User
    annotations (the optimizer's step range) span kernels counted on
    their own."""
    from torch.autograd import DeviceType

    classes: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        cls = classify(evt.name)
        classes[cls] = classes.get(cls, 0.0) + ms
        acc = by_name.setdefault(evt.name[:80], [0, 0.0])
        acc[0] += 1
        acc[1] += ms
    for evt in prof.events() if experts else ():
        if evt.device_type == DeviceType.CPU and evt.name == "aten::bmm":
            for kernel in launched(evt):
                ms = kernel.duration / 1e3
                classes[classify(kernel.name)] -= ms
                classes["experts"] = classes.get("experts", 0.0) + ms
    return classes, by_name


def phase_profile(model, cell: str = "dense") -> None:
    """The serving run once more under `torch.profiler`: device time by
    kernel, summed into classes (the MoE experts' products a class of
    their own), and the device's busy share of the run's wall time.
    Profiling slows the host, so the busy share here is a lower bound
    of the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
    )

    trace = serving_trace(model.vocab)
    eng = ServingEngine(model, EngineConfig(**SERVE_ENGINE))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay(eng, trace, max_steps=500)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def classify(name):
        return ("ragged_paged" if "ragged" in name.lower()
                else "flash_fwd" if "flash_fwd" in name
                else "memcpy/memset" if name.startswith("Mem")
                else "matmul" if any(w in name.lower() for w in
                                     ("gemm", "xmma", "cutlass", "sm90"))
                else "other")

    classes, kernels = device_classes(prof, classify,
                                      experts=bool(model.moe_experts))
    busy_ms = sum(classes.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    emit(phase="profile", cell=cell, steps=eng.current_step,
         wall_ms=wall * 1e3, device_busy_ms=busy_ms,
         busy_share=busy_ms / (wall * 1e3), device_ms_by_class=classes,
         top_kernels=[{"name": n, "count": c, "ms": t}
                      for n, (c, t) in top],
         top_host_ops=[{"name": e.key[:60], "count": e.count,
                        "self_ms": e.self_cpu_time_total / 1e3}
                       for e in host])


def phase_moe(ops, kernels) -> None:
    """The serving model with 8 experts, top-2 (`SERVE_MOE`), at depth
    4: greedy `generate` on phase 4's 8 prompts of 512 tokens and the
    serving trace in both step modes, with phase 4's and 5's launch
    checks (the flash kernel once per layer for each prefill, the decode
    kernel once per layer and step; one ragged or paged launch per layer
    and model call), every request finished with its 32 tokens and every
    logit finite; then the ragged run under `torch.profiler`."""
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.models import decode as gen

    t0 = time.perf_counter()
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **SERVE_MODEL,
                        **SERVE_MOE)
    model.load_state_dict(init_params(model, SEED))
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if "experts" in n)
    equal = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model.vocab, (8, 512))).cuda()
    generate_runs(ops, kernels, model,
                  {"moe_generate": lambda: gen.generate(model, equal,
                                                        steps=GEN_STEPS)},
                  {"moe_generate": "decode"},
                  {"moe_generate": equal.numel()})
    streams = serve_runs(ops, kernels, serving_trace(model.vocab),
                         [("ragged", "ragged_paged", model),
                          ("two_call", "paged_decode", model)])
    same = [a == b for e in serving_trace(model.vocab) for a, b in zip(
        streams["ragged"][e["id"]], streams["two_call"][e["id"]])]
    phase_profile(model, cell="moe")
    emit(phase="moe", model=SERVE_MOE, depth=model.depth,
         expert_params=experts,
         two_call_vs_ragged_equal_token_share=sum(same) / len(same),
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         seconds=time.perf_counter() - t0)


def beam_rescore(model, prompt, toks) -> torch.Tensor:
    """The teacher-forced total log-probability of ``toks`` after
    ``prompt``: one uncached forward (the flash kernel) over both."""
    s = prompt.shape[1]
    with torch.no_grad():
        logp = torch.log_softmax(model(torch.cat([prompt, toks], 1))
                                 [:, s - 1:-1].float(), dim=-1)
    return logp.gather(-1, toks[..., None])[..., 0].sum(-1)


def phase_beam(ops, kernels, model) -> None:
    """Beam search at full width: `generate_beam` on phase 4's 8 prompts
    of 512 tokens, `BEAMS` beams (32 cache rows), `BEAM_STEPS` steps, on
    bf16 and int8 caches: the flash kernel once per layer (the prefill)
    and the decode (int8) kernel once per layer and step, nothing else;
    every score finite and within `BEAM_SCORE_TOL` of the teacher-forced
    re-score of its tokens through the flash forward, where a search
    whose cache gather is skipped must fail; beams = 1 equal to greedy
    `generate` (the same decode calls).  The step ms by CUDA events, and
    the gather's device ms at the call's shapes."""
    from attention_tpu_torch.models import decode as gen

    t0 = time.perf_counter()
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model.vocab, (8, 512))).cuda()
    for int8 in (False, True):
        name, kernel = (("beam_int8", "quant_decode") if int8
                        else ("beam", "decode"))
        with watched(model) as (calls, bad):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            toks, scores = gen.generate_beam(
                model, prompts, steps=BEAM_STEPS, beams=BEAMS,
                int8_cache=int8, return_scores=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = ops.launch_counts()
        want = {"flash_fwd": model.depth,
                kernel: (BEAM_STEPS - 1) * model.depth}
        if {k: c for k, c in launches.items() if c} != want:
            raise AssertionError(f"{name} launches {launches}, want {want}")
        if toks.shape != (8, BEAM_STEPS) or int(bad) or not \
                scores.isfinite().all():
            raise AssertionError(f"{name}: tokens {tuple(toks.shape)}, "
                                 f"{int(bad)} non-finite logits, scores "
                                 f"{scores.tolist()}")
        kernels[kernel]["launches"] += launches[kernel]
        rescore = (scores - beam_rescore(model, prompts, toks)).abs().max()
        greedy = gen.generate(model, prompts, steps=BEAM_STEPS,
                              int8_cache=int8)
        one = gen.generate_beam(model, prompts, steps=BEAM_STEPS, beams=1,
                                int8_cache=int8)
        emit(phase="beam", run=name, beams=BEAMS, cache_rows=8 * BEAMS,
             wall_ms=wall * 1e3, prefill_ms=calls[0][0].elapsed_time(
                 calls[0][1]),
             step_ms=statistics.median(a.elapsed_time(b)
                                       for a, b in calls[1:]),
             launches=launches, scores=scores.tolist(),
             score_vs_rescore_max_abs=rescore.item(), tol=BEAM_SCORE_TOL,
             beams1_equals_greedy=torch.equal(one, greedy))
        if not rescore <= BEAM_SCORE_TOL:
            raise AssertionError(f"{name}: scores {rescore.item()} from the "
                                 f"re-score")
        if not torch.equal(one, greedy):
            raise AssertionError(f"{name}: beams = 1 parts from greedy "
                                 f"generate")

    # the planted fault: a search that replicates the caches but never
    # gathers them after, so each slot keeps its own history whatever its
    # parent
    rows = gen._cache_rows
    first = []

    def no_gather(caches, idx):
        if first:
            return caches
        first.append(True)
        return rows(caches, idx)

    gen._cache_rows = no_gather
    try:
        toks, scores = gen.generate_beam(model, prompts, steps=BEAM_STEPS,
                                         beams=BEAMS, return_scores=True)
    finally:
        gen._cache_rows = rows
    planted = (scores - beam_rescore(model, prompts, toks)).abs().max()
    # the gather alone, at the call's shapes: 32 rows of 640
    with torch.no_grad():
        caches = gen.prefill(model, prompts, 640)[1]
    idx = torch.arange(8, device="cuda").repeat_interleave(BEAMS)
    caches = rows(caches, idx)
    perm = idx.flip(0)
    q8 = tuple(c.quantize() for c in caches)
    gather = {"bf16": device_ms(lambda: rows(caches, perm)),
              "int8": device_ms(lambda: rows(q8, perm))}
    emit(phase="beam", gather_device_ms_per_step=gather,
         planted_no_gather_score_vs_rescore=planted.item(),
         seconds=time.perf_counter() - t0)
    if not planted > BEAM_SCORE_TOL:
        raise AssertionError(f"the re-score check passes a search without "
                             f"the gather: {planted.item()}")


def phase_fork(ops, kernels, model) -> None:
    """Parallel sampling over forked pages at full width: one prompt of
    `FORK_PROMPT` tokens (7 full pages of 128 and a 104-row tail) through
    the flash kernel, its caches scattered into one pool a layer
    (`paged_from_dense`), `paged_fork` into `FORK_COPIES` sequences with
    one reserve page each, then `FORK_STEPS` sampled steps (temperature
    0.8, top-p 0.95, a seeded generator) through the paged kernel: the
    flash kernel once per layer and the paged kernel once per layer and
    step, nothing else.  The pools' refcounts and free pages as
    `tests/test_paged.py` pins them, the shared pages bit-equal after the
    appends, each fork's first-step attention (layer 0) within
    `reference.mismatch` of the dense decode of the unforked context and
    bit-equal to the paged kernel over the source's table."""
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.ops.decode import flash_decode
    from attention_tpu_torch.ops.paged import (
        PagePool,
        paged_flash_decode,
        paged_fork,
        paged_from_dense,
    )

    t0 = time.perf_counter()
    n, page, pages = FORK_PROMPT, 128, 32
    prompt = torch.as_tensor(np.random.default_rng(SEED + 7).integers(
        0, model.vocab, (1, n))).cuda()
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    full = n // page
    with watched(model) as (calls, bad), torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        last, dense = gen.prefill(model, prompt, 1152)
        pools = [PagePool(pages) for _ in dense]
        base = tuple(paged_from_dense(c.k, c.v, [n], pool, num_pages=pages)
                     for c, pool in zip(dense, pools))
        forks = tuple(paged_fork(c, pool, 0, FORK_COPIES, reserve_pages=1)
                      for c, pool in zip(base, pools))
        shared = forks[0].page_table[0, :full].long()
        before = [(f.k_pool[shared].clone(), f.v_pool[shared].clone())
                  for f in forks]
        toks, _ = gen._token_loop(
            model, last.expand(FORK_COPIES, -1), forks, FORK_STEPS,
            generator, temperature=0.8, top_k=None, top_p=0.95)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = ops.launch_counts()
    want = {"flash_fwd": model.depth,
            "paged_decode": FORK_STEPS * model.depth}
    if {k: c for k, c in launches.items() if c} != want or int(bad):
        raise AssertionError(f"fork launches {launches}, want {want}; "
                             f"{int(bad)} non-finite logits")
    kernels["paged_decode"]["launches"] += launches["paged_decode"]
    src = base[0].page_table[0].tolist()
    for pool, fork, (k0, v0) in zip(pools, forks, before):
        table = fork.page_table.tolist()
        tails = {row[full] for row in table}
        if not (all(row[:full] == src[:full] for row in table)
                and all(pool.refcount(p) == 1 + FORK_COPIES
                        for p in src[:full])
                and len(tails) == FORK_COPIES and src[full] not in tails
                and pool.used_pages == full + 1 + 2 * FORK_COPIES):
            raise AssertionError(f"fork tables {table}, source {src}, "
                                 f"used {pool.used_pages}")
        if not (torch.equal(fork.k_pool[shared], k0)
                and torch.equal(fork.v_pool[shared], v0)):
            raise AssertionError("an append wrote into a shared page")
    gen_q = torch.Generator(device="cuda").manual_seed(SEED + 8)
    q = torch.randn((FORK_COPIES, 32, 128), generator=gen_q,
                    device="cuda").to(torch.bfloat16)
    got = paged_flash_decode(q, forks[0])
    unforked = flash_decode(
        q, dense[0].k.expand(FORK_COPIES, -1, -1, -1).contiguous(),
        dense[0].v.expand(FORK_COPIES, -1, -1, -1).contiguous(), n)
    err, ratio = held(got, unforked)
    source = paged_flash_decode(q, base[0]._replace(
        page_table=base[0].page_table.expand(FORK_COPIES, -1).contiguous(),
        lengths=base[0].lengths.expand(FORK_COPIES).contiguous()))
    if not torch.equal(got, source):
        raise AssertionError("the paged kernel over a fork's table differs "
                             "from it over the source's table")
    for pool, fork, c in zip(pools, forks, base):
        for row in fork.page_table.tolist() + c.page_table.tolist():
            pool.free([p for p in row if p >= 0])
        if pool.free_pages != pages:
            raise AssertionError(f"{pool.free_pages} of {pages} pages free "
                                 f"after every sequence freed them")
    distinct = len({tuple(r) for r in toks.tolist()})
    emit(phase="fork", prompt=n, copies=FORK_COPIES, steps=FORK_STEPS,
         wall_ms=wall * 1e3, prefill_ms=calls[0][0].elapsed_time(calls[0][1]),
         step_ms=statistics.median(a.elapsed_time(b) for a, b in calls[1:]),
         launches=launches, used_pages_per_layer=full + 1 + 2 * FORK_COPIES,
         shared_page_refcount=1 + FORK_COPIES,
         first_step_vs_unforked_max_abs_err=err, share_of_limit=ratio,
         distinct_streams=distinct, seconds=time.perf_counter() - t0)
    if distinct < 2:
        raise AssertionError("eight sampled forks gave one stream")


def phase_speculative(ops, kernels, model) -> None:
    """Speculative decoding at full width: the serving model as the
    target on one prompt of 512 tokens, `SPEC_STEPS` greedy steps, gamma
    `SPEC_GAMMA`, on each cache type, with two drafts: the target itself
    (acceptance near gamma) and a depth-1 model of the same geometry
    from seed 1 (random weights: acceptance near 0).  Launches exactly
    the prefills' flash calls, the draft's decode steps and one verify
    chunk a layer an iteration (dense: the flash kernel with the cache's
    offsets; ragged: the decode kernel's chunk mode; int8 and paged:
    their kernels' chunk modes).  Per run: the mean accepted tokens an
    iteration, the tokens emitted per target forward, the host syncs (one
    an iteration), the ms per emitted token beside greedy `generate`'s,
    and the share of tokens equal to greedy `generate` (int8: with
    ``int8_cache``)."""
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.models.speculative import (
        CACHE_TYPES,
        generate_speculative,
    )

    t0 = time.perf_counter()
    prompt = torch.as_tensor(np.random.default_rng(SEED + 9).integers(
        0, model.vocab, (1, 512))).cuda()
    baseline = {}
    for int8 in (False, True):
        torch.cuda.synchronize()
        start = time.perf_counter()
        toks = gen.generate(model, prompt, steps=SPEC_STEPS, int8_cache=int8)
        torch.cuda.synchronize()
        baseline[int8] = (toks, (time.perf_counter() - start) * 1e3
                          / SPEC_STEPS)
    small = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                        **dict(SERVE_MODEL, depth=1))
    small.load_state_dict(init_params(small, SEED + 1))
    verify = {"dense": "flash_fwd", "ragged": "decode",
              "int8": "quant_decode", "paged": "paged_decode"}
    for draft_name, draft in (("self", model), ("depth1_seed1", small)):
        for cache_type in CACHE_TYPES:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            toks, st = generate_speculative(
                model, draft, prompt, steps=SPEC_STEPS, gamma=SPEC_GAMMA,
                cache_type=cache_type, return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = ops.launch_counts()
            want = {"flash_fwd": model.depth + draft.depth,
                    "decode": st.iterations * (SPEC_GAMMA + 1) * draft.depth}
            kernel = verify[cache_type]
            want[kernel] = want.get(kernel, 0) + st.iterations * model.depth
            if {k: c for k, c in launches.items() if c} != want:
                raise AssertionError(f"speculative {cache_type} launches "
                                     f"{launches}, want {want}")
            for k, c in launches.items():
                kernels[k]["launches"] += c
            greedy, greedy_ms = baseline[cache_type == "int8"]
            if toks.shape != (1, SPEC_STEPS) or not torch.equal(
                    toks[0, 0], greedy[0, 0]):
                raise AssertionError(f"speculative {cache_type}: tokens "
                                     f"{tuple(toks.shape)}, first token "
                                     "differs from generate's")
            emit(phase="speculative", draft=draft_name,
                 cache_type=cache_type, gamma=SPEC_GAMMA, steps=SPEC_STEPS,
                 iterations=st.iterations,
                 mean_accepted_per_iteration=st.accepted / st.iterations,
                 emitted_per_target_forward=(1 + st.accepted
                                             + st.iterations)
                 / (1 + st.iterations),
                 host_syncs=st.iterations,
                 ms_per_token=wall * 1e3 / SPEC_STEPS,
                 generate_ms_per_token=greedy_ms,
                 equal_to_generate_share=(toks == greedy).float()
                 .mean().item(), launches=launches)
    emit(phase="speculative", seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def captured_backwards():
    """The operands of every `flash_backward` call the autograd function
    makes while the context is open, the first of each (causal, m, n):
    {(causal, m, n): ((q, k, v, out, lse, dout), kw)}."""
    from attention_tpu_torch.ops import flash_vjp

    kernel_backward = flash_vjp.flash_backward
    got = {}

    def recording(q, k, v, out, lse, dout, **kw):
        key = (kw["causal"], q.shape[-2], k.shape[-2])
        if key not in got:
            got[key] = (tuple(t.detach().clone() for t in
                              (q, k, v, out, lse, dout)),
                        dict(scale=kw["scale"], causal=kw["causal"],
                             softcap=kw["softcap"]))
        return kernel_backward(q, k, v, out, lse, dout, **kw)

    flash_vjp.flash_backward = recording
    try:
        yield got
    finally:
        flash_vjp.flash_backward = kernel_backward


def phase_seq2seq(ops, kernels) -> None:
    """The encoder-decoder model at the serving geometry (`SEQ2SEQ_MODEL`,
    enc 2 + dec 2 blocks, about 1.2e9 parameters, bf16) on 8 sequences of
    512 source and 114 target tokens (T5's span-corruption lengths):
    the forward's logits (the flash kernel once a layer: the encoder
    non-causal m = n = 512, the decoder causal m = n = 113, the
    cross-attention non-causal m = 113 over n = 512) against the model's
    plain path (``impl="xla"``) and a float32 witness; `SEQ2SEQ_STEPS`
    steps of `MasterAdamW` (the loss must fall; one flash forward and one
    fused backward a layer a step); the backward calls of one step, on
    the fused kernel and the pair, held against float64 on their own
    operands and against `flash_backward_plain` under `grad_mismatch` on
    random ones (`hold_captured_backward`); `generate_seq2seq` for 32
    greedy steps (the
    flash kernel at m = 1 for the cross-attention, the decode kernel for
    the self-attention); and the device ms of the encoder's, the
    cross-attention's and the decode step's flash calls and backward
    calls, the m = 1 call beside the decode kernel on its inputs."""
    from attention_tpu_torch.models import (
        MasterAdamW,
        TinySeq2Seq,
        generate_seq2seq,
        init_params,
        seq2seq_loss,
    )
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.decode import flash_decode
    from attention_tpu_torch.ops.flash import flash_attention, \
        flash_attention_plain
    from attention_tpu_torch.ops.reference import grad_mismatch

    t0 = time.perf_counter()
    b, s_src, s_tgt = SEQ2SEQ_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    src = torch.randint(0, 32000, (b, s_src), generator=gen, device="cuda")
    tgt = torch.randint(0, 32000, (b, s_tgt), generator=gen, device="cuda")
    model = TinySeq2Seq(dtype=torch.bfloat16, device="cuda", **SEQ2SEQ_MODEL)
    params = init_params(model, SEED, dtype=torch.float32)
    model.load_state_dict(params)
    n_params = sum(p.numel() for p in model.parameters())
    depth = len(model.enc_blocks) + 2 * len(model.dec_blocks)
    plain = TinySeq2Seq(impl="xla", dtype=torch.bfloat16, device="cuda",
                        **SEQ2SEQ_MODEL)
    plain.load_state_dict(params)
    witness = TinySeq2Seq(impl="xla", dtype=torch.float32, device="cuda",
                          **SEQ2SEQ_MODEL)
    witness.load_state_dict(params)
    with torch.no_grad():
        ops.reset_launch_counts()
        logits = model(src, tgt[:, :-1])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want = plain(src, tgt[:, :-1])
        exact = witness(src, tgt[:, :-1])
        fwd_ms = {"flash": time_ms(lambda: model(src, tgt[:, :-1]),
                                   calls=1, reps=5),
                  "xla": time_ms(lambda: plain(src, tgt[:, :-1]),
                                 calls=1, reps=5)}
    del witness
    errs = {"flash_vs_f32": (logits - exact).abs().max().item(),
            "xla_vs_f32": (want - exact).abs().max().item(),
            "flash_vs_xla": (logits - want).abs().max().item()}
    emit(phase="seq2seq", params=n_params, batch=list(SEQ2SEQ_BATCH),
         logits_max_abs_err=errs, forward_ms=fwd_ms, launches=launches,
         logits_max_abs=exact.abs().max().item())
    if {k: c for k, c in launches.items() if c} != {"flash_fwd": depth} \
            or not logits.isfinite().all():
        raise AssertionError(f"seq2seq forward launches {launches}")
    kernels["flash_fwd"]["launches"] += launches["flash_fwd"]
    if not errs["flash_vs_f32"] <= SEQ2SEQ_WITNESS_RATIO * \
            errs["xla_vs_f32"]:
        raise AssertionError(f"the kernels' logits stand further from the "
                             f"float32 witness than the plain path's: "
                             f"{errs}")
    del plain, want, exact, logits

    optimizer = MasterAdamW(model, params, lr=TRAIN_LR)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(SEQ2SEQ_STEPS + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        optimizer.zero_grad()
        with (captured_backwards() if i == SEQ2SEQ_STEPS
              else contextlib.nullcontext()) as calls:
            loss = seq2seq_loss(model, src, tgt)
            loss.backward()
        optimizer.step()
        end.record()
        end.synchronize()
        losses.append(loss.item())
        step_ms.append(start.elapsed_time(end))
    launches = ops.launch_counts()
    steps = SEQ2SEQ_STEPS + 1
    if {k: c for k, c in launches.items() if c} != {
            "flash_fwd": steps * depth, flash_bwd.FUSED: steps * depth} \
            or not np.isfinite(losses).all() or \
            not losses[SEQ2SEQ_STEPS - 1] < losses[0]:
        raise AssertionError(f"seq2seq training: losses {losses}, launches "
                             f"{launches}")
    for kernel in ("flash_fwd", flash_bwd.FUSED):
        kernels[kernel]["launches"] += launches[kernel]
    emit(phase="seq2seq", losses=losses, step_ms=step_ms,
         median_step_ms=statistics.median(step_ms[1:SEQ2SEQ_STEPS]),
         launches=launches,
         tokens_per_step=b * (s_tgt - 1),
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    del optimizer

    names = {(False, s_src, s_src): "encoder",
             (False, s_tgt - 1, s_src): "cross",
             (True, s_tgt - 1, s_tgt - 1): "decoder_self"}
    if set(calls) != set(names):
        raise AssertionError(f"captured backward calls {sorted(calls)}")
    times = {}
    for key, (args, kw) in calls.items():
        hold_captured_backward(kernels, f"seq2seq_{names[key]}", args, kw)
        q, k, v = args[:3]
        times[names[key]] = dict(
            forward_device_ms=device_ms(lambda: flash_attention(
                q, k, v, causal=kw["causal"], softcap=kw["softcap"])),
            **{f"backward_{path}_device_ms": device_ms(
                lambda: flash_backward_forced(path == "pair", *args, **kw))
               for path in ("fused", "pair")})
    del calls

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    toks = generate_seq2seq(model, src, steps=GEN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = ops.launch_counts()
    dec = len(model.dec_blocks)
    want = {"flash_fwd": len(model.enc_blocks) + GEN_STEPS * dec,
            "decode": GEN_STEPS * dec}
    if {k: c for k, c in launches.items() if c} != want or \
            toks.shape != (b, GEN_STEPS):
        raise AssertionError(f"generate_seq2seq launches {launches}, want "
                             f"{want}")
    for kernel in ("flash_fwd", "decode"):
        kernels[kernel]["launches"] += launches[kernel]

    # the decode step's cross-attention: m = 1 over the 512 memory rows,
    # the flash kernel's body and split beside the decode kernel
    with torch.no_grad():
        k, v = model.dec_blocks[0].cross_attn.project_kv(
            model.encode(src))
    q = torch.randn((b, 32, 1, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = k.contiguous(), v.contiguous()
    one = flash_attention(q, k, v, softcap=50.0)
    by_decode = flash_decode(q[:, :, 0], k, v, s_src, softcap=50.0)
    want = flash_attention_plain(q, k, v, softcap=50.0)
    # the trained model's values reach past 2.56, where `mismatch`'s 2e-2
    # cap is under one bf16 ulp: `grad_mismatch` holds the value's ulp
    err, ratio = grad_mismatch(one, want)
    if not ratio <= 1.0:
        raise AssertionError(f"the m = 1 flash call off its plain version: "
                             f"{err}, {ratio} x the limit")
    kernels["flash_fwd"]["max_abs_err"] = max(
        kernels["flash_fwd"]["max_abs_err"], err)
    times["cross_decode_step_m1"] = dict(
        **flash_plan(q, k, v),
        flash_device_ms=device_ms(lambda: flash_attention(q, k, v,
                                                          softcap=50.0)),
        decode_kernel_device_ms=device_ms(lambda: flash_decode(
            q[:, :, 0], k, v, s_src, softcap=50.0)),
        flash_vs_plain_max_abs_err=err, share_of_limit=ratio,
        decode_kernel_vs_plain_max_abs_err=(by_decode.float() - want[
            :, :, 0].float()).abs().max().item())
    emit(phase="seq2seq", generate_ms=wall * 1e3,
         generate_step_ms=wall * 1e3 / GEN_STEPS, launches=launches,
         kernel_times=times, seconds=time.perf_counter() - t0)


def exact_backward(q, k, v, out, lse, dout, *, scale, causal, softcap):
    """dQ, dK, dV in float64 from the bf16 operands of a backward call
    (P from the saved lse, nothing rounded): the witness of
    `hold_captured_backward`."""
    q, k, v, out, dout = (t.double() for t in (q, k, v, out, dout))
    b, hkv, n = k.shape[:3]
    group = q.shape[1] // hkv
    kx, vx = (t.repeat_interleave(group, 1) for t in (k, v))
    s = q @ kx.transpose(-1, -2) * scale
    dcap = 1.0
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, dcap = softcap * t, 1.0 - t * t
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).triu(1), float("-inf"))
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (dout @ vx.transpose(-1, -2)
              - (dout * out).sum(-1, keepdim=True)) * dcap
    dk = (ds.transpose(-1, -2) @ q * scale).view(b, hkv, group, n, -1)
    dv = (p.transpose(-1, -2) @ dout).view(b, hkv, group, n, -1)
    return ds @ kx * scale, dk.sum(2), dv.sum(2)


def hold_captured_backward(kernels, case, args, kw) -> None:
    """A backward call of a training step, on both kernel paths: on its
    own operands, each 64-row tile's relative L2 distance from the
    float64 gradients of the same bf16 operands (`exact_backward`), dQ
    by query tile and dK, dV by key tile of each batch row and head,
    within `CAPTURED_BWD_SLACK` of the plain version's in that tile (or
    of the plain version's median tile, where that is larger), where a
    dropped last key tile, a 2% scale error in dQ, and a 2% error in the
    last (partial) tile of one head must fail; and on random operands of
    the same shapes, within `reference.grad_mismatch` of the plain
    version.  A model's dS = P·(dP - delta) cancels along a row (it sums
    to zero), so on its own operands a row of dQ can be small beside its
    terms, and a bf16 dS that two paths round apart moves an element past
    `grad_mismatch`'s row term: there the plain version, which rounds the
    same quantities, sets the bar, and the elementwise shares are
    printed.  A tile of 64 rows, not a row, is the unit because the two
    paths' distances agree within 1% a tile and only within 35% a row.
    dK and dV the same bits on a second call (the pair's dQ too)."""
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl
    from attention_tpu_torch.ops.reference import grad_mismatch

    k = args[1]
    exact = exact_backward(*args, **kw)
    names = ("dq", "dk", "dv")

    def tiles(t):
        """(B, H, rows, d) -> (B, H, tiles, BWD_HOLD_TILE * d), the last
        tile padded with zeros."""
        pad = -t.shape[2] % BWD_HOLD_TILE
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(*t.shape[:2], -1, BWD_HOLD_TILE * t.shape[-1])

    # each tile's float64 norm, floored at a tenth of the median tile's:
    # a tile whose gradient nearly vanishes is held to its neighbours'
    # scale, not to its own
    norms = [tiles(e).norm(dim=-1) for e in exact]
    norms = [torch.maximum(n, 0.1 * n.median()) for n in norms]

    def distance(grads):
        return {name: tiles(g.double() - e).norm(dim=-1) / n
                for name, g, e, n in zip(names, grads, exact, norms)}

    plain = flash_bwd.flash_backward_plain(*args, **kw)
    bar = {name: CAPTURED_BWD_SLACK * torch.maximum(rel, rel.median())
           for name, rel in distance(plain).items()}

    def worst(grads):
        """Each gradient's largest tile distance as a share of its bar."""
        return {n: (d / bar[n]).max().item()
                for n, d in distance(grads).items()}

    one_tile = [g.clone() for g in plain]
    for g in one_tile:
        g[0, 0, (g.shape[2] - 1) // BWD_HOLD_TILE * BWD_HOLD_TILE:] *= 1.02
    faults = {
        "dk_dropped_last_key_tile": worst(flash_bwd.flash_backward_plain(
            *args, **dict(kw, kv_valid=k.shape[-2] - KEY_TILE))),
        "dq_scale_off_2pct": worst(flash_bwd.flash_backward_plain(
            *args, **dict(kw, scale=1.02 * kw["scale"]))),
        "one_tile_off_2pct": worst(one_tile)}
    del one_tile
    if any(max(d.values()) <= 1.0 for d in faults.values()):
        raise AssertionError(f"{case}: the check passes a planted fault: "
                             f"{faults}")
    plan = flash_bwd.bwd_launch_plan(*args, causal=kw["causal"])
    pair_plan = plan.pop("pair")
    if plan["body"] != "wgmma" or pair_plan["body"] != "wgmma":
        raise AssertionError(f"{case}: the fused kernel runs {plan}, the "
                             f"pair {pair_plan}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    q, k, v, dout = (torch.randn(t.shape, generator=gen, device="cuda")
                     .to(t.dtype) for t in (args[0], args[1], args[2],
                                            args[5]))
    rand = (q, k, v, *_flash_fwd_impl(q, k, v, **kw), dout)
    rand_plain = flash_bwd.flash_backward_plain(*rand, **kw)
    for path in ("fused", "pair"):
        got = flash_backward_forced(path == "pair", *args, **kw)
        again = flash_backward_forced(path == "pair", *args, **kw)
        on_random = flash_backward_forced(path == "pair", *rand, **kw)
        torch.cuda.synchronize()
        same_bits(got[1:] if path == "fused" else got,
                  again[1:] if path == "fused" else again)
        dist = worst(got)
        own = [grad_mismatch(g, w) for g, w in zip(got, plain)]
        random = [grad_mismatch(g, w) for g, w in zip(on_random, rand_plain)]
        emit(phase="seq2seq", path=path, case=case,
             **(dict(fused_plan=plan) if path == "fused"
                else dict(pair_plan=pair_plan)),
             worst_tile_vs_float64_share_of_bar=dist,
             plain_median_tile_vs_float64_rel_l2={
                 n: d.median().item() for n, d in distance(plain).items()},
             planted_faults_worst_tile_share_of_bar=faults,
             own_operands_vs_plain_share_of_limit=dict(
                 zip(names, (r for _, r in own))),
             random_operands_max_abs_err=dict(
                 zip(names, (e for e, _ in random))),
             random_operands_share_of_limit=dict(
                 zip(names, (r for _, r in random))))
        if not max(dist.values()) <= 1.0:
            raise AssertionError(f"{case}: {path} further from the float64 "
                                 f"gradients than the plain version in a "
                                 f"tile: {dist} x the bar")
        if not all(r <= 1.0 for _, r in random):
            raise AssertionError(f"{case}: {path} off its plain version on "
                                 f"random operands: {random}")
        for kernel, idx in ((flash_bwd.FUSED, (0, 1, 2)),) \
                if path == "fused" else ((flash_bwd.DQ, (0,)),
                                         (flash_bwd.DKV, (1, 2))):
            kernels[kernel]["max_abs_err"] = max(
                kernels[kernel]["max_abs_err"],
                *(random[i][0] for i in idx))


def flash_backward_forced(pair: bool, *args, **kw):
    """`flash_backward` on the pair (``pair``) or the fused kernel."""
    from attention_tpu_torch.ops import flash_bwd

    flash_bwd._FORCE_TWO_KERNEL = pair
    try:
        return flash_bwd.flash_backward(*args, **kw)
    finally:
        flash_bwd._FORCE_TWO_KERNEL = False


def phase_decoding_reference() -> None:
    """Phase 6's small f32 model on the card against the same weights on
    the CPU, on this slice's paths: `generate_beam` (beams 3, dense and
    int8 caches) tokens equal and scores within 1e-4 (the logits'
    limit); `generate_speculative` greedy streams on every cache type
    equal to greedy `generate` (int8: with ``int8_cache``) on both sides,
    with a depth-1 draft of seed 1; and the small encoder-decoder (the
    same widths, 2 + 2 blocks): logits within 1e-4 and
    `generate_seq2seq` streams equal."""
    from attention_tpu_torch.models import (
        TinyDecoder,
        TinySeq2Seq,
        generate_seq2seq,
        init_params,
    )
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.models.speculative import (
        CACHE_TYPES,
        generate_speculative,
    )

    t0 = time.perf_counter()
    sides = {}
    for side in ("cpu", "cuda"):
        models = (TinyDecoder(dtype=torch.float32, device=side,
                              **SMALL_MODEL),
                  TinyDecoder(dtype=torch.float32, device=side,
                              **dict(SMALL_MODEL, depth=1)),
                  TinySeq2Seq(dtype=torch.float32, device=side,
                              **SMALL_SEQ2SEQ))
        for m, cpu, seed in zip(models, sides.get("cpu", (None,) * 3),
                                (SEED, SEED + 1, SEED)):
            # the card's models take the CPU's weights
            m.load_state_dict(init_params(m, seed) if cpu is None
                              else cpu.state_dict())
        sides[side] = models
    prompts = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, SMALL_MODEL["vocab"], (3, 100)))
    src = torch.as_tensor(np.random.default_rng(SEED + 2).integers(
        0, SMALL_MODEL["vocab"], (2, 120)))
    tgt = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, SMALL_MODEL["vocab"], (2, 30)))
    got = {}
    for side, (target, draft, s2s) in sides.items():
        out = {}
        for int8 in (False, True):
            out[f"beam_int8{int8}"] = gen.generate_beam(
                target, prompts, steps=12, beams=3, int8_cache=int8,
                return_scores=True)
        for cache_type in CACHE_TYPES:
            out[f"speculative_{cache_type}"] = generate_speculative(
                target, draft, prompts[:1], steps=24, gamma=4,
                cache_type=cache_type)
            greedy = gen.generate(target, prompts[:1], steps=24,
                                  int8_cache=cache_type == "int8")
            if not torch.equal(out[f"speculative_{cache_type}"], greedy):
                raise AssertionError(f"{side}: speculative {cache_type} "
                                     "parts from greedy generate")
        with torch.no_grad():
            out["seq2seq_logits"] = s2s(src.to(side), tgt.to(side))
        out["seq2seq_generate"] = generate_seq2seq(s2s, src, steps=16)
        got[side] = {k: tuple(t.cpu() for t in v) if isinstance(v, tuple)
                     else v.cpu() for k, v in out.items()}
    cpu, card = got["cpu"], got["cuda"]
    errs = {"seq2seq_logits": (card["seq2seq_logits"]
                               - cpu["seq2seq_logits"]).abs().max().item()}
    tols = {"seq2seq_logits": 1e-4}
    for int8 in (False, True):
        key = f"beam_int8{int8}_scores"
        errs[key] = (card[key[:-7]][1] - cpu[key[:-7]][1]).abs().max().item()
        # a score sums 12 log-probabilities, each within twice the logits'
        # limit: 1e-4 (f32) or `INT8_LOGITS_TOL` (int8 caches)
        tols[key] = 2 * 12 * (INT8_LOGITS_TOL if int8 else 1e-4)
    differ = [k for k, v in cpu.items() if k != "seq2seq_logits" and not
              torch.equal(v[0] if isinstance(v, tuple) else v,
                          card[k][0] if isinstance(v, tuple) else card[k])]
    emit(phase="reference", slice="decoding", max_abs_err=errs, tol=tols,
         streams_differ_card_vs_cpu=differ,
         streams=sorted(k for k in cpu if k != "seq2seq_logits"),
         seconds=time.perf_counter() - t0)
    if differ or not all(errs[k] <= tols[k] for k in errs):
        raise AssertionError(f"card against CPU: {differ}, {errs}")


def pairs_of(m: int, window=None, docs=None) -> int:
    """The (row, key) pairs a causal m x m call's kernels score: every
    causal pair, those of the band of the last ``window`` positions (the
    sinks are `sink_patch`'s), or those within the packed ``docs``."""
    if docs is not None:
        return sum(n * (n + 1) // 2 for n in docs)
    if window is None:
        return m * (m + 1) // 2
    return sum(min(i + 1, window) for i in range(m))


def launched_once(ops, run, want: dict):
    """``run()`` with the launch counts reset just before and read just
    after: exactly ``want`` ({kernel: launches}), nothing else.  Returns
    its output."""
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    got = {k: c for k, c in ops.launch_counts().items() if c}
    if got != want:
        raise AssertionError(f"launches {got}, want {want}")
    return out


def d256_record(kernels, kernel, case, rec, **extra) -> None:
    """One d = 256 case's numbers into its kernel's record of the
    ``{"kernels": [...]}`` line, under ``"d256"``."""
    keys = ("ms", "device_ms", "device_ms_source", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms",
            "library_device_ms_source")
    kernels[kernel].setdefault("d256", {})[case] = dict(
        {k: rec[k] for k in keys if k in rec}, **extra)


def d256_forward(ops, kernels, gen) -> None:
    """The flash forward at `D256_OPS`, causal, bf16, without and with
    softcap 50, held as phase 2 holds the serving cases (one launch a
    call, the same bits twice, planted faults), its body printed, timed
    beside SDPA (`is_causal`, without softcap: SDPA has none)."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )

    h, hkv, m, d = D256_OPS
    q, k, v = (torch.randn((1, heads, m, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for heads in (h, hkv, hkv))
    for softcap in (None, 50.0):
        kw = dict(causal=True, softcap=softcap)
        case = "causal" + ("_softcap50" if softcap else "")

        def run():
            return flash_attention(q, k, v, **kw)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        launched_once(ops, run, {"flash_fwd": 1})
        library = None if softcap else sdpa
        dev = dict(**device_time(run, calls=10), library_device_ms=None)
        if library is not None:
            dev.update(device_time(library, calls=10,
                                   key="library_device_ms"))
        rec = hold(
            kernels, "flash_fwd", f"d256_{case}", run=run,
            plain=lambda: flash_attention_plain(q, k, v, **kw),
            faults={"dropped_last_key_tile": lambda: flash_attention_plain(
                q, k[..., :-KEY_TILE, :], v[..., :-KEY_TILE, :], **kw),
                "scale_off_2pct": lambda: flash_attention_plain(
                    q, k, v, scale=1.02 * d ** -0.5, **kw),
                "dropped_diagonal_tile": lambda: without_diagonal_tile(
                    q, k, v, **kw)},
            work=(2 * (h * m + hkv * m) * d * 2,
                  4.0 * d * h * pairs_of(m)),
            dtype=torch.bfloat16, library=library, **flash_plan(q, k, v),
            **dev)
        d256_record(kernels, "flash_fwd", case, rec, **dev,
                    body=flash_plan(q, k, v)["body"])


def d256_backward(ops, kernels, gen) -> None:
    """The three backward kernels at `D256_OPS` (causal, bf16): plain,
    window 1024 with 4 sinks, softcap 50, and the packed ids of
    `DIST_PACKED_DOCS` (3-D views), each path against
    `flash_backward_plain` under `reference.grad_mismatch`, one launch a
    kernel a call, the same bits on a second call (the fused dQ within
    the limit of the first), a dropped key tile in dK and a 2% scale
    error in dQ rejected.  Each kernel's body, registers and shared
    bytes; each kernel alone on the card (`torch.profiler`) beside its
    bound of the pairs it scores, `flash_backward` end to end, the plain
    version and, for the causal case, SDPA's backward."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl
    from attention_tpu_torch.ops.reference import grad_mismatch

    h, hkv, m, d = D256_OPS
    q, k, v, dout = (torch.randn((1, heads, m, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for heads in (h, hkv, hkv, h))
    ids = packed_ids(DIST_PACKED_DOCS)
    resources = {kernel: flash_bwd.fma_resources(kernel, torch.bfloat16, d,
                                                 d)
                 for kernel in (flash_bwd.FUSED, flash_bwd.DQ,
                                flash_bwd.DKV)}
    emit(phase="d256", backward_fma_resources=resources)
    for name, resource in resources.items():
        if resource["spill_bytes"]:
            raise AssertionError(f"{name}'s d 256 instance spills: "
                                 f"{resource}")
    for case, extra in (("causal", {}),
                        ("window1024_sinks4", dict(window=1024, sinks=4)),
                        ("softcap50", dict(softcap=50.0)),
                        ("packed", dict(q_segment_ids=ids,
                                        kv_segment_ids=ids))):
        # segment ids take 3-D views
        packed = "q_segment_ids" in extra
        qkvd = tuple(t[0] if packed else t for t in (q, k, v, dout))
        kw = {**dict(scale=d ** -0.5, causal=True, softcap=None), **extra}
        args = (*qkvd[:3], *_flash_fwd_impl(*qkvd[:3], **kw), qkvd[3])
        want = flash_bwd.flash_backward_plain(*args, **kw)
        faults = {
            "dk_dropped_last_key_tile": grad_mismatch(
                flash_bwd.flash_backward_plain(
                    *args, **dict(kw, kv_valid=m - KEY_TILE))[1],
                want[1])[1],
            "dq_scale_off_2pct": grad_mismatch(
                flash_bwd.flash_backward_plain(
                    *args, **dict(kw, scale=1.02 * kw["scale"]))[0],
                want[0])[1]}
        if not all(ratio > 1.0 for ratio in faults.values()):
            raise AssertionError(f"d256 {case}: the check passes a planted "
                                 f"fault: {faults}")
        plan = flash_bwd.bwd_launch_plan(*args, causal=True,
                                         window=kw.get("window"))
        if plan["body"] != "fma":
            raise AssertionError(f"d256 {case}: runs {plan}")
        errs = {}
        for path, launches in (("fused", {flash_bwd.FUSED: 1}),
                               ("pair", {flash_bwd.DQ: 1, flash_bwd.DKV: 1})):
            flash_bwd._FORCE_TWO_KERNEL = path == "pair"
            try:
                got = launched_once(
                    ops, lambda: flash_bwd.flash_backward(*args, **kw),
                    launches)
                again = flash_bwd.flash_backward(*args, **kw)
            finally:
                flash_bwd._FORCE_TWO_KERNEL = False
            torch.cuda.synchronize()
            errs[path] = [grad_mismatch(g, w) for g, w in zip(got, want)]
            if not all(r <= 1.0 for _, r in errs[path]):
                raise AssertionError(f"d256 {case} {path}: {errs[path]}")
            if path == "fused":
                same_bits(got[1:], again[1:])
                run_to_run = grad_mismatch(again[0], got[0])
                if not run_to_run[1] <= 1.0:
                    raise AssertionError(f"fused dQ run to run: "
                                         f"{run_to_run}")
            else:
                same_bits(got, again)
            for kernel, idx in ((flash_bwd.FUSED, (0, 1, 2)),) \
                    if path == "fused" else ((flash_bwd.DQ, (0,)),
                                             (flash_bwd.DKV, (1, 2))):
                kernels[kernel]["max_abs_err"] = max(
                    kernels[kernel]["max_abs_err"],
                    *(errs[path][i][0] for i in idx))
        # each kernel alone on the staged operands, then end to end
        staged = flash_bwd._Staged(
            *(t[None] if packed else t for t in args), q_offset=0,
            kv_offset=0, kv_valid=m, window=kw.get("window"),
            q_ids=ids if packed else None, kv_ids=ids if packed else None,
            **{x: kw[x] for x in ("scale", "causal", "softcap")})
        fused = staged.fused_buffers()
        pair = staged.pair_buffers()
        launch = {
            flash_bwd.FUSED: lambda: staged.fused(**fused),
            flash_bwd.DQ: lambda: staged.pair(flash_bwd.DQ, dq=pair["dq"]),
            flash_bwd.DKV: lambda: staged.pair(flash_bwd.DKV, dk=pair["dk"],
                                               dvo=pair["dvo"])}
        library, library_dev = None, dict(library_device_ms=None)
        if case == "causal":
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                               enable_gqa=True)

            def sdpa():
                return torch.autograd.grad(o, (qq, kk, vv), dout,
                                           retain_graph=True)

            library = time_ms(sdpa)
            library_dev = device_time(sdpa, calls=10,
                                      key="library_device_ms")
        plain_ms = time_ms(lambda: flash_bwd.flash_backward_plain(
            *args, **kw), calls=1, reps=3)
        end_to_end = {}
        for path in ("fused", "pair"):
            flash_bwd._FORCE_TWO_KERNEL = path == "pair"
            end_to_end[path] = time_ms(
                lambda: flash_bwd.flash_backward(*args, **kw), calls=2,
                reps=3)
            flash_bwd._FORCE_TWO_KERNEL = False
        pairs = pairs_of(m, kw.get("window"),
                         DIST_PACKED_DOCS if packed else None)
        for kernel, factor, outs in ((flash_bwd.FUSED, 10, "qkv"),
                                     (flash_bwd.DQ, 6, "q"),
                                     (flash_bwd.DKV, 8, "kv")):
            b_ms, b_by = bound_ms(*bwd_work(h, hkv, m, m, d, pairs, 2,
                                            factor, outs), torch.bfloat16)
            fused_only = kernel == flash_bwd.FUSED
            rec = dict(ms=time_ms(launch[kernel], calls=2, reps=3),
                       **device_time(launch[kernel], calls=5),
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library if fused_only else None,
                       **(library_dev if fused_only
                          else dict(library_device_ms=None)))
            d256_record(kernels, kernel, case, rec, body=plan["body"],
                        **resources[kernel])
            emit(phase="d256", kernel=kernel, case=case, **rec,
                 body=plan["body"], **resources[kernel],
                 tflop_s=factor * d * h * pairs / rec["ms"] / 1e9)
        emit(phase="d256", case=case, path_errors={
            path: {n: {"max_abs_err": e, "share_of_limit": r}
                   for n, (e, r) in zip(("dq", "dk", "dv"), v_)}
            for path, v_ in errs.items()},
            planted_faults_share_of_limit=faults,
            flash_backward_ms=end_to_end, pairs=pairs)
        del staged, fused, pair


def d256_decode(ops, kernels, gen):
    """The decode, paged decode, ragged and quantized decode kernels at
    16 q / 8 kv heads, d 256, bf16: 8 sequences of `DECODE_LENS` (0 to
    4096 rows), one token, with softcap 50 and a window of 512 with 4
    sinks (dense), the same caches behind a shuffled page table, a
    ragged step of 8 decode and 2 prefill slots, and the caches in int8,
    int4 and token-paired int4 (each within the JAX package's budget of
    the bf16 decode kernel on the sequences of 100 rows or more); then
    int8 at d 96 and int4 at d 80 (`D256_ODD_QUANT`).  Each held against
    its plain version by `hold` (one launch a call, the same bits twice,
    planted faults), timed on the card."""
    from torch.nn import functional as F

    from attention_tpu_torch.ops import quant
    from attention_tpu_torch.ops.decode import flash_decode, \
        flash_decode_plain
    from attention_tpu_torch.ops.paged import (
        PagedKV,
        paged_flash_decode,
        paged_flash_decode_plain,
    )
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    h, hkv, n, d = D256_OPS
    b, page = len(DECODE_LENS), 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    cut = lens.clone()
    cut[-1] -= KEY_TILE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    k, v, q = randn(b, hkv, n, d), randn(b, hkv, n, d), randn(b, h, d)
    for kw in ({}, {"softcap": 50.0}, {"window": 512, "sinks": 4}):
        split = split_of(b, hkv, h, 1, n, kw.get("window"))

        def run(kw=kw):
            return flash_decode(q, k, v, lens, **kw)

        mask = torch.arange(n, device="cuda") < lens[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask[:, None, None],
                enable_gqa=True)

        library = None if kw else sdpa
        launched_once(ops, run, {"decode": 1})
        dev = dict(**device_time(run), library_device_ms=None)
        if library is not None:
            dev.update(device_time(sdpa, key="library_device_ms"))
        rec = hold(
            kernels, "decode", f"d256_{case_name(q.dtype, 0, kw)}", run=run,
            plain=lambda: flash_decode_plain(q, k, v, lens, **kw),
            faults={"dropped_last_key_tile": lambda: flash_decode_plain(
                q, k, v, cut, **kw),
                "scale_off_2pct": lambda: flash_decode_plain(
                    q, k, v, lens, scale=1.02 * d ** -0.5, **kw),
                "dropped_middle_split": lambda: without_middle_split(
                    q, k, v, lens, split, **kw)},
            work=decode_work(DECODE_LENS, 1, h, hkv, d, 2, kw.get("window"),
                             kw.get("sinks")),
            dtype=torch.bfloat16, library=library, **split, **dev)
        d256_record(kernels, "decode", case_name(q.dtype, 0, kw), rec,
                    **dev, **split)

    # the same caches behind a shuffled page table
    per = n // page
    perm = torch.randperm(b * per, generator=gen, device="cuda")

    def pool(x):
        out = torch.empty(b * per, hkv, page, d, dtype=x.dtype, device="cuda")
        out[perm] = x.view(b, hkv, per, page, d).transpose(1, 2) \
            .reshape(b * per, hkv, page, d)
        return out

    table = perm.view(b, per).to(torch.int32).contiguous()
    cache = PagedKV(pool(k), pool(v), table, lens)
    pcut = cache._replace(lengths=cut)
    split = split_of(b, hkv, h, 1, n)

    def paged(c=cache, **kw):
        return paged_flash_decode(q, c, softcap=50.0, **kw)

    launched_once(ops, paged, {"paged_decode": 1})
    dev = device_time(paged)
    rec = hold(
        kernels, "paged_decode", "d256_bfloat16_S1_softcap", run=paged,
        plain=lambda: paged_flash_decode_plain(q, cache, softcap=50.0),
        faults={"dropped_last_key_tile": lambda: paged_flash_decode_plain(
            q, pcut, softcap=50.0),
            "scale_off_2pct": lambda: paged_flash_decode_plain(
                q, cache, softcap=50.0, scale=1.02 * d ** -0.5)},
        work=decode_work(DECODE_LENS, 1, h, hkv, d, 2),
        dtype=torch.bfloat16, **split, **dev)
    d256_record(kernels, "paged_decode", "bfloat16_S1_softcap", rec, **dev,
                **split)
    del cache, pcut

    # a ragged step: 8 decode slots at the serving trace's lengths, a
    # 256-token prefill chunk into a 768-row cache, a 200-token prompt
    spans = [(1, x) for x in RAGGED_DECODE_LENS] + [(256, 768), (200, 200)]
    rq, step = ragged_step(gen, spans, hq=h, hkv=hkv, d=d)
    longest = max(range(8), key=lambda s: RAGGED_DECODE_LENS[s])
    rcut = step.kv_lens.clone()
    rcut[longest] -= (RAGGED_DECODE_LENS[longest] - 1) % KEY_TILE + 1

    def ragged():
        return ragged_paged_attention(rq, step, softcap=50.0)

    launched_once(ops, ragged, {"ragged_paged": 1})
    plan = ragged_plan(rq, step)
    dev = device_time(ragged)
    rec = hold(
        kernels, "ragged_paged", "d256_mixed_softcap", run=ragged,
        plain=lambda: ragged_paged_attention_plain(rq, step, softcap=50.0),
        faults={"dropped_last_key_tile": lambda: ragged_paged_attention_plain(
            rq, step._replace(kv_lens=rcut), softcap=50.0),
            "scale_off_2pct": lambda: ragged_paged_attention_plain(
                rq, step, softcap=50.0, scale=1.02 * d ** -0.5)},
        work=ragged_work(step, rq), dtype=torch.bfloat16, plan=plan,
        **dev)
    d256_record(kernels, "ragged_paged", "mixed_softcap", rec, **dev,
                body=plan["body"])
    del step, rq

    # the quantized kernels: at d 256 on these caches, then int8 at d 96
    # and int4 at d 80 on caches of their own
    long = [i for i, x in enumerate(DECODE_LENS) if x >= 100]
    quantize = {"int8": quant.quantize_kv, "int4": quant.quantize_kv_int4,
                "int4_tok": quant.quantize_kv_int4_tok}
    op_of = {"int8": quant.flash_decode_quantized,
             "int4": quant.flash_decode_int4,
             "int4_tok": quant.flash_decode_int4_tok}
    kind_of = {"int8": quant.QuantizedKV, "int4": quant.Int4KV,
               "int4_tok": quant.Int4TokKV}
    kernel_of = {"int8": "quant_decode", "int4": "quant_decode",
                 "int4_tok": "quant_tok4"}
    for fmt, dq in (("int8", d), ("int4", d), ("int4_tok", d),
                    *D256_ODD_QUANT):
        kq, vq, qq = (k, v, q) if dq == d else (
            randn(b, hkv, n, dq), randn(b, hkv, n, dq), randn(b, h, dq))
        cache = quantize[fmt](kq, vq)
        fn = op_of[fmt]
        plan = quant.launch_plan(qq, cache, sms=sms)
        resources = quant.kernel_resources(kind_of[fmt], dq, plan["kg"])
        if resources["spill_bytes"]:
            raise AssertionError(f"{fmt} d {dq} spills: {resources}")

        def run(fn=fn, qq=qq, cache=cache):
            return fn(qq, cache, lens, softcap=50.0)

        case = f"{fmt}_d{dq}_S1_softcap"
        launched_once(ops, run, {kernel_of[fmt]: 1})
        dev = device_time(run)
        rec = hold(
            kernels, kernel_of[fmt], f"d256_{case}", run=run,
            plain=lambda: quant.quant_decode_plain(qq, cache, lens,
                                                   softcap=50.0),
            faults={"dropped_last_key_tile": lambda: quant.quant_decode_plain(
                qq, cache, cut, softcap=50.0),
                "scale_off_2pct": lambda: quant.quant_decode_plain(
                    qq, cache, lens, softcap=50.0, scale=1.02 * dq ** -0.5)},
            # a token's K and V bytes and fp32 scales (the token-paired
            # layout's stored rows hold two tokens)
            work=decode_work(DECODE_LENS, 1, h, hkv, dq, 2,
                             kv_row_bytes=2 * ((dq if fmt == "int8"
                                                else dq // 2) + 4)),
            dtype=torch.bfloat16, **plan, resources=resources, **dev)
        dense = flash_decode(qq, kq, vq, lens, softcap=50.0)
        err = (run()[long].float() - dense[long].float()).abs().max().item()
        budget = 0.02 if fmt == "int8" else 0.15
        emit(phase="d256", case=case, vs_bf16_kernel_max_abs_err=err,
             budget=budget)
        if not (err <= budget if fmt == "int8" else err < budget):
            raise AssertionError(f"{case}: {err} off the bf16 decode kernel")
        d256_record(kernels, kernel_of[fmt], case, rec, **dev, **resources)


def phase_head_dim_256(ops, kernels) -> None:
    """Phase 8: head dim 256 (`D256_MODEL`, Gemma 2 9B's head split).
    The kernel cases (`d256_forward`, `d256_backward`, `d256_decode`);
    the model served (greedy `generate` on bf16 and int8 caches over 8
    prompts of 512 tokens, 32 steps; the serving trace through
    `ServingEngine` in both step modes) and trained (`phase_train`, cell
    "d256"); the small f32 model with head dim 256 (`D256_SMALL`) on the
    card against the CPU (`phase_reference`).  Prints the phase's
    seconds."""
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.models import decode as gen_mod

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    d256_forward(ops, kernels, gen)
    d256_backward(ops, kernels, gen)
    d256_decode(ops, kernels, gen)
    t_kernels = time.perf_counter() - t0

    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **D256_MODEL)
    model.load_state_dict(init_params(model, SEED))
    if model.head_dim != 256:
        raise AssertionError(f"head dim {model.head_dim}")
    equal = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model.vocab, (8, 512))).cuda()
    generate_runs(ops, kernels, model, {
        "generate": lambda: gen_mod.generate(model, equal, steps=GEN_STEPS),
        "generate_int8": lambda: gen_mod.generate(
            model, equal, steps=GEN_STEPS, int8_cache=True)},
        {"generate": "decode", "generate_int8": "quant_decode"},
        dict(generate=equal.numel(), generate_int8=equal.numel()))
    serve_runs(ops, kernels, serving_trace(model.vocab),
               [("ragged", "ragged_paged", model),
                ("two_call", "paged_decode", model)])
    t_serve = time.perf_counter() - t0 - t_kernels
    phase_train(ops, kernels, model, cell="d256", against_plain=True)
    del model
    t_train = time.perf_counter() - t0 - t_kernels - t_serve
    # the head-dim-256 model's float32 gradients part from the CPU's past
    # `grad_mismatch`'s f32 limit (read 2.03x, blocks.1.attn.k_proj.weight)
    # on the card with or without the kernels: from a float64 recompute
    # the CPU's read 0.68x the limit, the card's 1.89x with the kernels and
    # 2.28x with the attention in PyTorch ops; so there the kernels'
    # gradients are held to the float64 ones as closely as the plain
    # attention's on the card
    phase_reference(D256_SMALL, label="d256", plain_witness=True)
    emit(phase="d256", seconds=time.perf_counter() - t0,
         kernel_cases_seconds=t_kernels, serving_seconds=t_serve,
         training_seconds=t_train)


def kernel_records() -> dict:
    """{name: the kernel's record of the ``{"kernels": [...]}`` line},
    launches and error still 0."""
    return {
        name: dict(name=name, route="cuda",
                   source=f"attention_tpu_torch/csrc/{src}",
                   replaces=replaces, launches=0, max_abs_err=0.0)
        for name, src, replaces in (
            ("flash_fwd", "flash_fwd.cu", "attention_tpu/ops/flash.py:310"),
            ("ragged_paged", "ragged_paged.cu",
             "attention_tpu/ops/ragged_paged.py:201"),
            ("decode", "decode.cu", "attention_tpu/ops/decode.py:90"),
            ("paged_decode", "paged_decode.cu",
             "attention_tpu/ops/paged.py:213"),
            ("quant_decode", "quant_decode.cu",
             "attention_tpu/ops/quant.py:156"),
            ("quant_tok4", "quant_tok4_decode.cu",
             "attention_tpu/ops/quant.py:788"),
            ("flash_bwd_fused", "flash_bwd_fused.cu",
             "attention_tpu/ops/flash_bwd.py:304"),
            ("flash_bwd_dq", "flash_bwd_dq.cu",
             "attention_tpu/ops/flash_bwd.py:146"),
            ("flash_bwd_dkv", "flash_bwd_dkv.cu",
             "attention_tpu/ops/flash_bwd.py:215"))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch import ops
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    t_start = time.perf_counter()
    # f32 stays full f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_records()
    phase_build(ops)
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **SERVE_MODEL)
    model.load_state_dict(init_params(model, SEED))
    step, q = phase_kernels(kernels, model)
    phase_max_modes(kernels, step, q)
    phase_window_kernels(kernels, step, q)
    phase_segment_kernels(kernels)
    k, v = phase_decode_kernels(kernels)
    phase_quant_kernels(ops, kernels, k, v)
    del k, v
    phase_backward(kernels)
    phase_window_backward(kernels)
    phase_segment_backward(ops, kernels)
    phase_op_path(ops, kernels)
    phase_distributed(kernels)
    phase_cp_training(kernels)
    phase_mesh_training(kernels)
    phase_generate(ops, kernels, model)
    windowed = {}
    for name, band in (("sinks", SERVE_BAND),
                       ("no_sinks", dict(SERVE_BAND, attn_sinks=0))):
        windowed[name] = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                                     **SERVE_MODEL, **band)
        windowed[name].load_state_dict(model.state_dict())
    phase_window_generate(ops, kernels, windowed["sinks"])
    phase_serving(ops, kernels, model)
    phase_window_serving(ops, kernels, windowed["sinks"],
                         windowed["no_sinks"])
    del windowed
    phase_durability(ops, kernels, model)
    phase_tp_serving(kernels, model)
    phase_profile(model)
    phase_moe(ops, kernels)
    phase_beam(ops, kernels, model)
    phase_fork(ops, kernels, model)
    phase_speculative(ops, kernels, model)
    phase_seq2seq(ops, kernels)
    phase_reference()
    phase_window_reference()
    phase_moe_reference()
    phase_decoding_reference()
    phase_durability_reference()
    dense = phase_train(ops, kernels, model)
    del model
    phase_checkpoint(dict(SERVE_MODEL, depth=CKPT_DEPTH))
    windowed = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                           **SERVE_MODEL, **TRAIN_BAND)
    band = phase_train(ops, kernels, windowed,
                       batch_shape=WINDOW_TRAIN_BATCH,
                       cell="window4096_sinks4")
    del windowed
    moe = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                      **dict(SERVE_MODEL, depth=MOE_TRAIN_DEPTH), **SERVE_MOE)
    moe_classes = phase_train(ops, kernels, moe, cell="moe")
    del moe
    phase_head_dim_256(ops, kernels)
    emit(phase="train", attention_device_ms={
        cell: {c: classes.get(c, 0.0) for c in ("flash_fwd", "flash_bwd")}
        for cell, classes in (("dense", dense),
                              ("window4096_sinks4", band),
                              ("moe", moe_classes))})

    nbytes, ops_count = ragged_work(step, q)
    b_ms, b_by = bound_ms(nbytes, ops_count, q.dtype)

    def ragged():
        return ragged_paged_attention(q, step, softcap=50.0)

    kernels["ragged_paged"].update(
        ms=time_ms(ragged), device_ms=device_ms(ragged),
        plain_ms=time_ms(lambda: ragged_paged_attention_plain(
            q, step, softcap=50.0)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        plan=ragged_plan(q, step))
    emit(phase="smoke", seconds=time.perf_counter() - t_start)
    emit(kernels=list(kernels.values()))
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
