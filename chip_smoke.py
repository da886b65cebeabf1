#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build    — compile the CUDA kernels (``src/repro_torch/kernels/csrc``,
              one nvcc per source, all at once) into ``build/kernels/``.
2. kernels  — each hand-written kernel against its plain PyTorch version on
              the card, in bf16, at the main path's shapes (ragged lengths
              1 and mb*bs, a scratch-block row, S = 1023, verify offsets
              past the table's reach) and at the examples' (2 rows over 64
              positions and 16-token admissions, smollm-360m's and
              gemma-2b's heads), within the elementwise tolerances
              of tests/test_kernels.py and, for attention, a per-row
              relative error norm (``ROW_REL_TOL``); the verify kernel
              bitwise equal to the paged decode kernel per query, the
              dense decode kernel bitwise equal to the paged one on the
              same rows; then each kernel's time beside the plain
              version's, a PyTorch library call's where one computes the
              same function, and the least time the card could take.
3. serve    — ``serve_direct`` on full-width smollm-360m (random weights
              from seed 0), 8 slots, max_len 1024, block 16: 16 requests,
              prompts of 24-900 tokens, a budget of 64 new tokens each.
              A prompt longer than 512 tokens is admitted at the 1023
              bucket (max_len - 1), leaving room for one decode step: with
              seed 0 that is 7 of the 16 (prompts of 588-812 tokens), which
              finish with 2 tokens (admission + 1 step); the other 9 finish
              with 65.  Every request finishes with that count
              (``expected_tokens``), one device->host copy per step, no
              leaked block, and every kernel of the path was launched.
              The decode step is the engine's captured CUDA graph (a
              replay a step; the launch counts add what each replay
              launches), as in every spec="off" run below; so is every
              other function the reference compiles: the one-shot
              admission of each bucket (target and draft), the chunk
              function of each chunk length, the draft chain and the
              verify step.  Every one-device serve run on the card
              reports which of them it replayed (``decode_graph``,
              ``spec_graph``, ``prefill_graph``, ``draft_prefill_graph``,
              ``chunk_graph``) and the memory its captures hold
              (``graph_pool_bytes``), gated by ``graph_gate``; its
              ``*_eager`` counterpart (``step_graph=False``) replays none,
              and its streams, acceptance and launches (net of the
              graphs' warm-up steps) are the graphed run's.  The script
              prints its wall time (``total``) before the result lines.
   serve_eager — the same trace on the eager step: every stream bitwise
              equal to serve's, and the same launches once the graph's
              warm-up steps are taken off serve's; both runs' tokens/s,
              TTFT and ITL side by side (``graph_vs_eager``).
4. spec     — the same trace with ``spec="draft", spec_k=4``, twice: the
              target drafting for itself, and a cold 2-layer draft from
              seed 1 (acceptance near 0: every step rejects).  The same
              gates, the verify kernel launched, self-draft acceptance
              above 0.5; whether each stream equals the serve phase's is
              reported (the projections run at other row counts, where
              cuBLAS may round differently).  Each runs its spec pair as
              graphs and again eagerly (``spec_self_eager``,
              ``spec_cold_eager``): streams, acceptance and steps equal.
5. dense    — the same trace with ``kv="dense"``: the same gates, the
              dense decode kernel launched, every stream equal to the
              serve phase's (the dense kernel is the paged one's body).
   chunked_serve — the same trace with ``prefill="chunked"``, 128-token
              chunks (prefix sharing off): the gates of phase 3, exactly
              the chunks the trace's buckets need, no flash launch (the
              chunk attends in plain PyTorch, as the reference does), and
              the last request, admitted while others decode, bitwise
              equal to its run in an idle chunked engine; TTFT and ITL
              beside serve's (``chunked_vs_oneshot``).
   chunked_logits — full smollm-360m, ``prefill_chunk`` chained over
              128-token chunks into a fresh state against the one-shot
              prefill, last-position logits at buckets 64, 512 and 1023,
              within LOGIT_TOL; the same chain replayed through one CUDA
              graph per chunk length (slot and offset as device scalars)
              bitwise the eager chain.
6. model    — the same model teacher-forced for 8 paged decode steps with
              the kernels and with the plain path; logits compared.  Then
              one verify forward of [pending, 4 forced tokens] against the
              5 sequential decode steps it replaces.
7. moe_serve — the serve trace on full-width granite-moe-3b-a800m (random
              weights from seed 0; 40 experts, top 8): admission prefill
              runs the MoE FFN through the grouped-matmul kernel (3
              launches a layer), decode the dense-gated MoE.  The gates of
              phase 3, and the grouped-matmul, flash, paged decode and
              RMSNorm kernels each launched.  Then ``chunked_moe``: 4
              requests of at most 120 tokens in 32-token chunks, the
              gates of chunked_serve (the chunk path runs the dense-gated
              MoE, so no grouped-matmul launch).
8. moe_model — granite teacher-forced as in phase 6 (kernels, moe "gmm",
              against the plain path, moe "einsum"); logits compared, and
              how often the router's top-k expert sets of the two runs
              agree (token x layer) reported.
9. mamba_serve — the serve trace on full-width mamba2-370m (random weights
              from seed 0; 48 attention-free Mamba-2 layers), which the
              engine serves on the dense layout (per-row SSM state):
              every admission prefill runs each layer's SSD scan through
              the SSD-scan kernel (48 launches an admission), decode the
              O(1) recurrent update.  The gates of phase 3, the SSD-scan
              and RMSNorm kernels launched, the scan 48 times per
              admission.  Then ``chunked_mamba`` as chunked_moe (each
              chunk token through 48 ``ssm_decode``s; no scan launch).
   pilot_serve — the pilot system on the card (``serve_via_pilots``):
              ``ClusterSim()`` on "cuda", one slice, one pilot
              (max_payloads 3) that late-binds two full-width serve images
              in turn, smollm-360m then mamba2-370m, each of shape
              ``custom:1024x8`` with the kernel flags, answering serve's
              and mamba_serve's trace; task 1 hints task 2's image, so the
              pilot prefetches (builds and warms) it while smollm serves.
              Gates: both payloads exit 0; every request finishes with its
              expected tokens, one device->host copy per step, no leaked
              block; each payload's streams bitwise equal to its direct
              phase's (serve, mamba_serve); the second bind a cache hit
              and one prefetch; flash, paged decode and RMSNorm launched by
              payload 1's engine and the SSD scan 48 times per admission by
              payload 2's (each engine counts its own launches, made under
              the device lock; the prefetch's warm-up is counted apart);
              ``torch.cuda.memory_allocated()`` back within 64 MiB of its
              value before the first bind once the pilot has drained
              (cuBLAS workspaces released on both sides).  Reported: each
              payload's bind seconds, whether it was cached, tokens/s, TTFT
              p50, ITL p99 and max, and for each image a bare
              ``PayloadExecutor``'s pull of it unprefetched, its warm-up
              and a warm rebind.
   fleet_serve — fleet serve on the card (``serve_fleet``): 3 pilots,
              each late-binding the ``custom:1024x8`` smollm-360m image
              with the kernel flags, lease serve's 16 requests from one
              ``FleetDispatcher`` pool at a lease TTL of 3 s (one card:
              3 engines taking turns at the device lock).  Gates: every
              request completed once, nothing replayed or duplicated, no
              lease lost by a live server (in every fleet run),
              each stream bitwise serve's; on every server one
              device->host copy a step, the captured step, no leaked
              block; flash, paged decode and RMSNorm launched; memory
              back within ``PILOT_MEMORY_SLACK``.  Reported: wall,
              goodput, TTFT p50/p99, the servers that completed work,
              each server's tokens/s, ITL p99 and max against the TTL.
   fleet_requeue — the same run with the pilot holding the most leases
              killed once 4 requests have settled: exactly one failed
              pilot, at least one replay, each stream bitwise
              fleet_serve's and serve's, the survivors' gates as above.
   fleet_spec — 2 self-drafting pilots (``draft="self"``, eager spec
              pair), one killed as in fleet_requeue: each stream bitwise
              serve's (spec-off), the verify kernel launched, mean
              acceptance above 0.5; acceptance and tokens per step
              reported.
   fleet_autoscale — ``serve_fleet_schedule`` under the
              ``FleetAutoscaler`` (scale-to-zero allowed, at most 3
              pilots, from 1) on ``make_bursty_schedule`` over 24
              requests of serve's shape, 2 bursts of 2 s, 4 s apart:
              drained, every request completed once with its expected
              tokens (serve's 16 bitwise serve's), no flap, scaled to
              zero, memory back within the slack; the decisions,
              pilot-seconds, TTFT p50/p99 and replays reported.
   fleet_join — a pilot joins a 1-server fleet as the autoscaler joins
              one (prefetch, scale_up, submit_servers) once the first of
              64 requests of serve's shape has completed, so the joiner's
              weights, engine, capture and warm-ups take the device lock
              while the live server serves.  Gates: the live server held
              leases at the join and renewed them after the joiner
              announced, with requests still open; 2 pilots, both served;
              no replay, no lost lease; streams as expected (serve's 16
              bitwise); memory back within the slack.  Reported: the
              join's length and the live server's longest gap between
              renewals across it, against the TTL.
   disagg_serve — ``serve_disagg`` on full-width smollm-360m: one
              prefill-role pilot and one decode-role pilot (each its own
              image: the role is part of the key) answer serve's trace, 8
              slots a server, a 3 s lease TTL; each finished prefill
              exports its prompt blocks as a KV handoff (one device buffer,
              one host pull) that becomes a lease in the decode pool,
              where the decode server imports it in place and decodes on
              its captured step.  Gates: drained, every rid once, streams
              bitwise serve's, 16 exports and 16 imports, no leaked block
              on either side, memory back within the slack; the prefill
              server launched flash and no paged decode, the decode server
              paged decode and no flash.  Reported: goodput, TTFT (at the
              export) and resume (at the import) p50/p99, handoff bytes
              mean/max, export and import ms p50/max.
   disagg_requeue — the same with 2 + 2 pilots, one prefill pilot killed
              once 2 prefills have settled and one decode pilot once 4
              streams have: each stage lost exactly one pilot, every rid
              completed once, streams bitwise serve's, the decode replays
              (>= 1) imported the handoff again and prefilled nothing
              again (the prefill pool saw each rid once).
   serve_wave — serve's trace direct with ``admission="wave"``: the gates
              of phase 3, streams bitwise serve's, its tokens/s beside
              serve's.
   train    — ``train_direct`` (launch/train.py) on full-width
              smollm-360m (random f32 weights from seed 0), batch 8, seq
              512, 30 steps on the synthetic data, ``OptimConfig`` as
              train_direct builds it, the step a CUDA graph captured at
              the first call and replayed from the second
              (``step_graph``): every loss finite, the mean of the last 5
              below the mean of the first 5, and no kernel launched (the
              train path is the plain one, as the reference's).
              Reported: ``step_graph``, the first call's seconds
              (``capture_s``), ms per step (median of the steps after the
              first), tokens/s, ``max_memory_allocated``,
              ``graph_pool_bytes`` and the model-FLOP share of 989 TFLOP/s
              (6·N·tokens plus the attention term, its formula printed).
   train_eager — the same run with ``step_graph=False`` (the eager twin):
              the same gates and reports.  ``train_graph_vs_eager``:
              at every step the graphed loss within ``RESUME_LOSS_TOL``
              of the twin's, and the memory gate: the graphed run's
              ``max_memory_allocated`` at most the twin's + (the twin's
              − the state's bytes: f32 parameters, gradients and two
              moments) + ``PILOT_MEMORY_SLACK``, i.e. a graph adds at most
              one eager working set.
   train_graph_parity — decides that a replay is right, for
              full-width smollm-360m (8 x 512), mamba2-370m (4 x 512) and
              granite-moe-3b-a800m cut to 2 layers (8 x 512): from a start
              state S, two eager steps (S -> S1 -> S2); a graphed state's
              first call from S (step 0 and the capture), then S1 restored
              into it in place (``load_train_state``) and one replay; the
              eager step from S1 run a second time for its own spread.
              The replay's loss is bitwise the eager step's wherever the
              two eager runs agree bitwise (else within their gap); its
              grad norm, every updated parameter and both moments no
              farther from the first eager run than the second is, plus
              f32 rounding (``GRAPH_PARITY_ATOL``).
   train_parity — one train step of full-width smollm-360m cut to 2
              layers, batch 2, seq 128, from the same seeded f32 weights
              on the card and on the CPU (the port's plain path, which
              tests/test_torch_train.py holds to JAX): loss, grad norm,
              every gradient leaf and every updated parameter within
              ``TRAIN_PARITY_TOL``.
   train_mamba — 5 steps of full-width mamba2-370m, batch 4, seq 512, the
              plain SSD scan under autograd, graphed: finite losses, no
              kernel launched; train's reports.  ``train_mamba_eager``,
              its eager twin, and ``train_mamba_graph_vs_eager``, train's
              twin and memory gates.
   pilot_train — ``train_via_pilots`` on the card: full-width
              smollm-360m, a ``custom:512x8`` train image, 40 steps,
              checkpoints every 10 steps into a directory under
              ``build/``; once step 10's checkpoint is on disk the node
              fails, and a replacement pilot resumes the task after the
              lease expires.  Gates: exit 0, ``resumed_from`` the last
              checkpoint the killed payload wrote, the resumed run's steps
              ``40 - resumed_from``, a finite last loss within
              ``RESUME_LOSS_TOL`` of an uninterrupted run of the same image
              (whether it is bitwise is reported: the embedding's backward
              accumulates with atomics on the card), no kernel launched,
              and ``memory_allocated`` back within ``PILOT_MEMORY_SLACK``
              of its value before the bind.  Every payload's step replays
              its state's graph: the killed payload, the resumed one and
              the uninterrupted run each report ``step_graph`` true.
   gemma_serve, starcoder_serve — serve's trace on full-width gemma-2b
              (MQA at head width 256, GeGLU, tied) and starcoder2-3b
              (LayerNorm, plain-gelu MLP), random weights from seed 0,
              paged, graphed: the gates of phase 3, flash and paged decode
              launched, RMSNorm launched on gemma and not on starcoder2
              (its LayerNorm takes no kernel).
   swa_serve — mixtral-8x7b at full width and 8 of its 32 layers (the
              whole model does not fit one 80 GB card), window 4096, on
              its dense rolling rings of 4096 slots a row: 8 slots,
              max_len 8192, 8 requests of 64 new tokens with prompts of
              ``SWA_PROMPTS`` tokens (two admitted at the 8191 bucket,
              whose prefill write rolls the ring; three at 4096, whose
              decode crosses the window).  The gates of phase 3, no
              speculation and no paging, flash (with the window) once a
              layer per admission, the grouped matmul, dense decode and
              RMSNorm launched, paged decode not; then the same trace on
              the eager step (``swa_serve_eager``): streams bitwise the
              graph's, launches equal once its warm-up is taken off.
   chunked_swa — 2 mixtral requests (5000 and 3000 tokens) admitted in
              512-token chunks on the rolling rings: the gates, the exact
              chunk count, no flash or grouped-matmul launch; then their
              chained chunk logits against the one-shot prefill within
              LOGIT_TOL (at an MoE capacity that drops nothing; against
              the config's own capacity reported).
   pilot_gemma — the paper's pair (examples/late_binding_serve.py): one
              pilot binds full-width smollm-360m, then gemma-2b,
              prefetched, with pilot_serve's gates (streams bitwise serve's
              and gemma_serve's).
   mla_serve — serve's trace on minicpm3-4b (multi-head latent attention)
              at full width and all 62 layers, random weights from seed 0,
              paged latent pools, graphed: the gates of phase 3, flash
              (V padded, Dh 96 on the 128 instance, G = 1) once a layer per
              admission and RMSNorm launched; no decode, verify, grouped
              matmul or scan kernel (MLA's decode is the absorbed latent
              score in plain PyTorch, as the reference's).  Then
              ``mla_serve_eager`` (streams bitwise, launches equal once the
              graph's warm-up is taken off), ``mla_dense`` (dense latent
              rings, streams bitwise mla_serve's) and ``mla_spec``
              (self-draft, spec_k 4, the trace's first 8 requests:
              acceptance above 0.5, flash twice a
              layer per admission with the draft's prefill, no verify
              kernel; whether each stream equals mla_serve's reported),
              each run's numbers beside ``serve``'s (``mla_summary``).
   chunked_mla — the same trace in 128-token chunks with chunked_serve's
              gates (no flash launch), then chained chunk logits against
              the one-shot prefill at buckets 64, 512 and 1023 within
              LOGIT_TOL (``chunked_mla_logits``: absorbed against expanded
              attention).
   pilot_mla — one pilot binds full-width smollm-360m, then minicpm3-4b,
              prefetched, with pilot_serve's gates.
   disagg_mla — disagg_serve's gates on full-width minicpm3-4b (all 62
              layers, paged latent pools), 1 + 1 pilots, the trace's
              first 8 requests (``DISAGG_MLA_REQUESTS``, reduced as
              mla_spec is): streams bitwise mla_serve's for those rids;
              flash 62 times per admission on the prefill server, RMSNorm
              and no attention kernel on the decode server (MLA decode is
              plain).
   mla_train_parity — train_parity on full-width minicpm3-4b cut to 2
              layers, launching no kernel.
   hybrid_serve — serve's trace on jamba-v0.1-52b at full width and 8 of
              its 32 layers (one period: 7 Mamba-2 SSM slots and 1
              attention slot, MoE on every other; all 32 layers do not fit
              one card), random weights from seed 0, paged and graphed,
              asking for speculation: the gates of phase 3, the SSM
              reason recorded and speculation off, no prefix cache, flash
              once per admission (the attention slot), the SSD scan 7
              times and the grouped matmul 12 times (16 experts, top 2),
              paged decode and RMSNorm launched, no verify.  Then
              ``hybrid_serve_eager`` and ``hybrid_dense`` (the dense decode
              kernel): streams bitwise hybrid_serve's, eager launches the
              graph's once its warm-up is taken off (``hybrid_summary``).
   chunked_hybrid — 4 jamba requests of 130-300 tokens in 128-token
              chunks with chunked_serve's gates (no flash, scan or grouped
              matmul launch: the chunk path is plain, as the reference's).
   vlm_serve — serve's trace on full llava-next-mistral-7b, text only as
              the reference's engine serves it, paged and graphed, and on
              the eager step (``vlm_serve_eager``): the gates of phase 3,
              flash once a layer per admission, paged decode and RMSNorm,
              streams bitwise, launches equal once the warm-up is taken
              off.
   encdec_model — whisper-small at full width and depth: 8 rows of 1500
              stub frames and a 4-token prompt through ``encdec_prefill``
              (flash at ``causal=0`` in the encoder and in the
              cross-attention, S != T), a dense state of max_len 448 built
              from its caches, 124 greedy decode steps (dense decode at
              G = 1); the plain path teacher-forced with the kernel path's
              tokens: logits at the prefill and every step within
              LOGIT_TOL; the encoder's, the prefill's and a step's ms and
              the decode tokens/s reported.
   encdec_train_parity — train_parity on whisper-small cut to 2 encoder
              and 2 decoder layers, with a ``frontend`` batch of frames,
              launching no kernel.
   pilot_families — one pilot binds whisper's "prefill" image, then its
              "decode" image, then llava's "serve" image, prefetched: all
              exit 0, the serve payload's streams bitwise vlm_serve's, its
              bind a cache hit, memory back within 64 MiB.
   tp_serve — tensor-parallel serving: a (1, 2) mesh whose two ranks
              share the card (``TP_DEVICES``), against a one-device engine
              on the same card (``*_single``): full-width starcoder2-3b, 30
              layers, serve's trace plus 6 requests sharing a 40-token
              prompt (2 full blocks: prefix hits, refcounts), graphed.
              Gates: streams bitwise, one device->host copy a step, no
              leaked block, per-rank KV bytes at most ``TP_KV_SHARE`` of
              the total, prefix hits, paged decode and flash launched
              twice as often as one device's, at half its heads (each
              call's shapes recorded).  ``tp_gemm_diagnostic``: each
              column leaf at full width split in two, whether each rank's
              product is bitwise the whole product's columns at M = 8,
              1023 and every row count the engine takes, and the leaves
              the engine kept whole on the lead device.
   tp_spec  — the same arch self-drafting (spec_k 3), the trace's first 8
              requests, eager: tp_serve's gates, verify per rank too.
   tp_mla   — minicpm3-4b, 62 layers, the trace's first 8 requests,
              graphed: the gates, flash per rank at 20 heads, RMSNorm once
              (on the lead device), no decode kernel; its diagnostic.
   tp_pilot — one pilot holding a slice of the mesh late-binds a (1, 2)
              starcoder2-3b serve image and answers serve's trace: exit
              0, streams bitwise tp_serve's one-device run's, the mesh in
              its telemetry, the gates, memory back within 64 MiB.
   tp_rank_kernels — before any mesh engine, the kernels a rank runs at
              a rank's shapes: the grouped matmul on each half of up's
              columns at granite's (40,256,1536)x(40,1536,256) and jamba's
              (16,160,4096)x(16,4096,7168) buckets, flash at granite's
              1023-token admission and paged decode at its 8 slots, each
              at 12 of 24 heads (4 of 8 kv heads): the two halves bitwise
              the whole call, each against its plain version, timed
              beside its bound and its library call.
   tp_moe   — granite-moe-3b-a800m, 32 layers, the trace's first 8
              requests, graphed: tp_serve's gates at 12 of 24 heads,
              RMSNorm as often as one device's, the grouped matmul 5/3 of
              one device's (up and gate once a rank, down once on the
              lead; a leaf kept whole once), its diagnostic with the
              grouped kernel's and torch.matmul's per-rank exactness.
   tp_ssm   — mamba2-370m, 48 layers, the first 8 requests: streams
              bitwise, the SSD scan and RMSNorm as often as one device's
              (SSM leaves and state replicate), no attention kernel; the
              state bytes per rank.
   tp_hybrid — jamba-v0.1-52b at full width, 8 of 32 layers (reduced, as
              hybrid_serve), the first 8 requests, the one-device engine
              freed first: flash and paged decode per rank at 16 of 32
              heads, the grouped matmul 5/3 on the MoE layers, the SSD
              scan as often as one device's.
   tp_disagg — starcoder2-3b, prefill role and decode role, (1, 2) ->
              (1, 2), (1, 2) -> one device, one device -> (1, 2): streams
              bitwise tp_serve's unified one-device run's, every export's
              wire bytes the one-device export's bit for bit, one host
              pull an export, flash per rank in the mesh prefill role and
              paged decode per rank in the mesh decode role, the decode
              engines graphed, no leaked block; export and import p50.
   tp_data  — granite on a (2, 2) mesh of four ranks on the card, the first
              8 requests: streams bitwise tp_moe's one-device run's, the
              parameter and KV pool bytes on each of the four devices
              those `run_serve_cell(mesh_shape=(2, 2), whole=...)`
              predicts (``dryrun_serve_data``), per-device KV share at
              most ``TP_KV_SHARE``; each data row computing its slice of
              the experts in decode where the slices are bitwise.
              Every tp phase prints tokens/s, ITL p50 and per-rank KV bytes
              of both runs beside nvidia-smi's name and power limit.
   dryrun_serve_tp — the dry run's serve accounting
              (``launch/dryrun.py: run_serve_cell`` at the engine's bf16
              layout) against tp_serve's mesh engine: its parameter and
              KV pool bytes per model rank equal the prediction, the
              column leaves it keeps whole on the lead device predicted
              as held (``whole_leaves``; the reference's convention, which
              splits them, printed beside); the rise of
              ``memory_allocated`` over the build beside the prediction.
   dryrun_serve — the same for a one-device engine of serve's smollm-360m
              configuration (8 slots, max_len 1024), built for it.
   dryrun_step — one eager decode step of that engine's model with the
              kernels, its 8 slots prefilled with serve's prompts,
              counted under ``launch/op_cost.py: step_cost`` on the card:
              FLOPs, fused bytes and the kernel launches (counted zero),
              then timed (median of 10 after warm-up) beside its roofline
              bound from ``launch/hw.py``.  Gates: counts positive, paged
              decode and RMSNorm launched, the measured time at or above
              the bound.
   dryrun_cli — ``python -m repro_torch.launch.dryrun --arch mamba2-370m
              --shape decode_32k`` in a subprocess: exit 0, its record
              (``results/dryrun_torch/pod16x16/``) with positive compute
              and memory terms and a boolean ``fits_hbm``.
   example_* — the paper's five examples (``examples/torch/``), each
              ``main`` called in-process at full width on the card, after
              the training phases: ``fixed_sequence`` (one decode image
              through a bare pod), ``late_binding_serve`` (smollm-360m,
              then gemma-2b, engines on 2 slots, the second image
              prefetched), ``quickstart`` (10 direct train steps, then
              three payloads through one pilot), ``dynamic_pilot`` (three
              payloads of three models through one pilot; then 200 train
              steps checkpointed every 10, the node killed once one is on
              disk, the payload resumed by a replacement pilot; that half
              at 8 of 32 layers, the example's own ``FAIL_LAYERS``) and
              ``elastic_train`` (four train payloads across a fleet
              scaled 2 -> 1 -> 3).  Gates: ``main`` returns 0 and prints
              its OK line last; every payload exits 0; the resumed
              payload's ``resumed_from`` is the killed payload's last
              checkpoint; the plans equal ``plan_remesh``'s; no engine
              leaks a block; each image bound again is a cache hit; the
              kernels of ``EXAMPLES`` launched and no other; memory back
              within 64 MiB; every train step graphed (the quickstart's
              direct steps, the dynamic pilot's resumed payload and the
              elastic fleet's payloads report ``step_graph``).  Each
              prints its lines, wall seconds, cold and cached bind ms,
              tokens/s, train ms a step (graphed), checkpoint seconds and
              launches.
10. mamba_model — first each of mamba2-370m's 48 mixers on a 1023-token
              admission (the kernel path's own activations), its output
              with the SSD-scan kernel against the same mixer on the
              scan's plain version (``mamba_layers``); then the model
              teacher-forced as in phase 6 on its dense layout, the
              kernels (ssm and norm "pallas") against the plain path (ssm
              "chunked", norm "jnp"): the first 12 layers gated by
              LOGIT_TOL, all 48 reported beside the plain path's own move
              when only the RMSNorm kernel is swapped in.
11. arch_models — teacher-forced logits as in phase 6, kernels against
              the plain path within LOGIT_TOL: full-width gemma-2b and
              starcoder2-3b at full depth, paged; mixtral-8x7b at 8 layers
              on its rings, prompts of 4090 and 6000 tokens (its rolling
              prefill, then decodes past the window), moe "gmm" against
              "einsum", with the routers' top-k agreement.
12. mla_model — minicpm3-4b teacher-forced as in phase 6 at full width
              and depth (``MLA_GATED_LAYERS``), paged, within LOGIT_TOL; on
              a miss the errors at 31, 16 and 8 layers are reported first.
13. hybrid_model — jamba (8 layers) teacher-forced as in phase 6, every
              kernel against the plain path within LOGIT_TOL, with the
              routers' top-k agreement; then each of its SSM mixers on a
              1023-token admission against its plain scan
              (``hybrid_layers``, as ``mamba_layers``).
14. vlm_model — llava (32 layers): a prefill of 576 stub patch
              embeddings and 447 text tokens, then 8 teacher-forced decode
              steps, the kernel path against the plain path within
              LOGIT_TOL.

The kernels phase also checks every kernel at granite's shapes (24 heads,
8 KV heads, d_model 1536); flash prefill at head widths 128 and 256 (MQA,
as gemma), at S = 1, 65 and B = 2, and at the smoke widths its wrapper
pads; RMSNorm at D = 1024, 2048, 4096, R = 1 and with a residual; the
decode entries at lengths on the edges of the decode body's sequence
splits (1, W - 1, W, W + 1, the capacity) and verify staircases that cross
a split, each also bitwise (dense == paged, verify == decode) at smollm's
and granite's head counts; the grouped matmul at every capacity bucket
(C = 256, 136, 72, 40, 24) for up/gate and down, ragged group sizes with
empty groups and NaN tail rows, and D = F = 96; and the SSD scan at
mamba2-370m's admission buckets (S = 1023 with chunk 256, and S = 32, 64,
128, 512), S = 257 (a one-row last chunk), two rows at S = 1023, a padded
S = 100, grouped B/C (G = 2) and f32 inputs; at each admission bucket
also with one and with two heads a CTA in its last phase (each checked,
both timed); and the device kernels one call launches, counted under
``torch.profiler``.

Every kernel (and its library call, where one computes the same
function) is timed twice at the main path's shapes: ``ms`` back to back
from the host, as the serve path calls it, and ``device_ms`` from
replaying a CUDA graph of 50 captured calls, which leaves the host's
launch path out; flash also at the S = 512 and 128 admission buckets, the
decode entries also at profile_serve.py's ~200 positions a row.  The
flash, grouped-matmul and SSD-scan entries record their instance, nvcc's
register and spill report and the tensor-core instructions in their SASS
(a build without ``HGMMA`` fails; for the SSD scan, without ``HGMMA`` or
``HMMA``).  One 1023-token admission prefill of full-width mamba2-370m
(48 SSD-scan launches) is timed too (``mamba_admission``).  At the new
archs' shapes (``arch_kernel_shapes``, each kernel entry's
``arch_shapes``): flash at gemma-2b's and starcoder2-3b's 1023-token and
mixtral-8x7b's 8191-token admission (window 4096), with the Dh = 256
instance's ptxas report; paged decode at gemma's G = 8, Dh = 256 and
starcoder2's G = 12; dense decode over mixtral's 4096-slot rings; the
grouped matmul at mixtral's experts (C = 2560); RMSNorm at D = 2048 and
4096; minicpm3-4b's flash admission (G = 1, Dh 96, run on the 128
instance: ``instance``) and RMSNorm at D = 2560; jamba's and llava's flash
admission (1,1023,32/8,128), whisper's non-causal flash over 1500 frames
(its encoder, S = T, and its cross-attention, S = 4), paged decode at
G = 4, Dh 128, dense decode at G = 1 over a 448-slot cache, jamba's
experts (16, C = 160), its SSD scan (state 16, 128 heads) and RMSNorm at
(1023, 4096); and a rank's shapes on the (1, 2) mesh: flash at
starcoder2-3b's (1,1023,12/1,128) and minicpm3-4b's (1,1023,20/20,96),
paged decode at (8,12,128) over (513,16,1,128), and paged verify at
(8,4,12,128) beside the whole model's (8,4,24,128): each against its plain
version and timed as above.

``python3 chip_smoke.py --times-of OTHER/src`` builds another checkout's
kernels and prints the same main-shape times of rows 2 and 4-7 and of the
mamba2-370m admission for them, with flash prefill's times, registers and
SASS as a control (a parent commit, timed in the same call as this one),
and nothing else.

Lines of JSON report each phase; the line before the last is nvidia-smi's
name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# flop/s, f32 non-tensor flop/s; `load_peaks` sets them from
# repro_torch.launch.hw, the constants the dry run's roofline reads
HBM_BPS = BF16_FLOPS = F32_FLOPS = None

ATTN_TOL = dict(rtol=5e-2, atol=2e-2)     # tests/test_kernels.py:54
NORM_TOL = dict(rtol=5e-2, atol=5e-2)     # tests/test_kernels.py:193
GMM_TOL = dict(rtol=5e-2, atol=5e-2)      # tests/test_kernels.py:166
SSD_TOL = {torch.bfloat16: dict(rtol=6e-2, atol=6e-2),   # tests/test_kernels.py:140
           torch.float32: dict(rtol=1e-3, atol=1e-3)}
# One SSM mixer's bf16 output, kernel scan vs plain scan on the same input:
# that of tests/test_torch_ssm.py (one bf16 ulp at |y| in [1, 2) is 7.8e-3).
MIXER_TOL = dict(rtol=1e-2, atol=1e-2)
# At S = 1023 or cache_len ~1000 an attention output is ~N(0, 1/n), about
# 0.03-0.07, so the elementwise bound above is half a typical value.  Each
# output row (one query head, Dh values) is also held to
# ||got - want|| / ||want|| below 2e-2: dropping the last 16 positions of
# the 1024-position row of the paged case moves it by ~0.2, while the f32
# and bf16 versions of that case differ by ~2e-3.
ROW_REL_TOL = 2e-2
# Teacher-forced logits, kernels vs plain path, full width: 32 (smollm,
# granite) or 48 (mamba2) layers of bf16 activations rounded at the same
# points but summed in other orders (scalar-FMA kernels vs cuBLAS/einsum);
# logits are bf16 products of magnitude up to ~4, where one bf16 ulp is
# 1.6e-2.
LOGIT_TOL = dict(rtol=5e-2, atol=1e-1)
# mamba2-370m's random-weight stack compounds a rounding difference with
# depth: on the card, with every mixer within MIXER_TOL of its plain scan,
# the kernel path's logits over all 48 layers leave LOGIT_TOL of the plain
# path's, and swapping only the RMSNorm kernel into the plain path moves
# them by most of it (`mamba_model_full_depth` reports both).  The
# teacher-forced logits are held to LOGIT_TOL over the first 12 layers.
MAMBA_GATED_LAYERS = 12

SERVE = dict(n_requests=16, slots=8, max_len=1024, seed=0,
             prompt_len=(24, 900), max_new_tokens=64)
# chunked admission: serve's trace in 128-token chunks; granite's and
# mamba2's short traces in 32-token chunks (mamba2's chunk runs every
# token through 48 `ssm_decode`s).  Prefix sharing is off in these runs:
# a prefix hit starts a job mid-prompt, so the chunk count would no longer
# follow from the trace's buckets alone, and the isolation check compares
# with an idle engine, which has nothing to hit.
CHUNK = 128
SHORT = dict(n_requests=4, slots=8, max_len=1024, seed=0,
             prompt_len=(16, 120), max_new_tokens=32)
SHORT_CHUNK = 32
DENSE_ARCH = "smollm-360m"
MOE_ARCH = "granite-moe-3b-a800m"
SSM_ARCH = "mamba2-370m"
GEMMA_ARCH = "gemma-2b"
CODE_ARCH = "starcoder2-3b"
SWA_ARCH = "mixtral-8x7b"
# mixtral-8x7b at full width and 8 of its 32 layers: ~11.9 B parameters,
# ~24 GB in bf16 (all 32 layers, ~94 GB, do not fit one 80 GB card)
SWA_LAYERS = 8
# swa_serve: 8 slots, max_len 8192, 8 requests of 64 new tokens.  Prompts
# of 5000 and 7000 tokens are admitted at the 8191 bucket (max_len - 1),
# so their prefill write rolls the 4096-slot ring (and they decode one
# step); 4060, 4090 and 3000 at the 4096 bucket, so their decode crosses
# the window from position 4096 on; 1500, 600 and 200 decode in rings not
# yet full.  chunked_swa: 5000 and 3000 in 512-token chunks (the first
# rolls the ring during its chunks, the second's decode crosses it).
SWA = dict(n_requests=8, slots=8, max_len=8192, seed=0, prompt_len=None,
           max_new_tokens=64)
SWA_PROMPTS = (5000, 4060, 200, 7000, 3000, 1500, 4090, 600)
SWA_CHUNK = 512
SWA_CHUNKED_PROMPTS = (5000, 3000)
# the new archs' kernel shapes (arch_kernel_shapes): flash at each one's
# longest admission (S, H, K, Dh, window); paged decode at gemma's G = 8,
# Dh = 256 and starcoder2's G = 12 ((H, K, Dh), PAGED_MAIN's rows); dense
# decode over mixtral's rings (B, T, H, K, Dh, lengths); mixtral's experts
# at the 8191 bucket's capacity (E, C, {name: (D, F)}); RMSNorm (R, D)
ARCH_FLASH = {"gemma_S1023 (1,1023,8/1,256)": (1023, 8, 1, 256, None),
              "starcoder2_S1023 (1,1023,24/2,128)": (1023, 24, 2, 128, None),
              "mixtral_S8191_w4096 (1,8191,32/8,128)":
                  (8191, 32, 8, 128, 4096),
              "minicpm3_S1023 (1,1023,40/40,96)": (1023, 40, 40, 96, None),
              # a rank's heads on tp_serve's and tp_mla's (1, 2) meshes
              "starcoder2_rank_S1023 (1,1023,12/1,128)":
                  (1023, 12, 1, 128, None),
              "minicpm3_rank_S1023 (1,1023,20/20,96)":
                  (1023, 20, 20, 96, None)}
ARCH_PAGED = {"gemma (8,8,256), pools (513,16,1,256)": (8, 1, 256),
              "starcoder2 (8,24,128), pools (513,16,2,128)": (24, 2, 128),
              "jamba_llava (8,32,128), pools (513,16,8,128), G = 4":
                  (32, 8, 128),
              "starcoder2_rank (8,12,128), pools (513,16,1,128), G = 12":
                  (12, 1, 128)}
# paged verify (H, K, Dh) at VERIFY_MAIN's rows with tp_spec's S = 4: a
# rank's heads of starcoder2-3b on the (1, 2) mesh, and the whole model's
ARCH_VERIFY = {"starcoder2_rank (8,4,12,128), pools (513,16,1,128)":
               (12, 1, 128),
               "starcoder2 (8,4,24,128), pools (513,16,2,128)":
               (24, 2, 128)}
ARCH_DENSE = ("mixtral q (8,32,128), rings (8,4096,8,128)",
              (8, 4096, 32, 8, 128, [4096, 1, 4095, 2048, 4096, 129, 4000,
                                     64]))
ARCH_GMM = (8, 2560, {"mixtral_up (8,2560,4096)x(8,4096,14336)":
                      (4096, 14336),
                      "mixtral_down (8,2560,14336)x(8,14336,4096)":
                      (14336, 4096)})
ARCH_NORM = {"gemma_decode (8,2048)": (8, 2048),
             "gemma_prefill (1023,2048)": (1023, 2048),
             "mixtral_decode (8,4096)": (8, 4096),
             "mixtral_prefill (8191,4096)": (8191, 4096),
             "minicpm3_decode (8,2560)": (8, 2560),
             "minicpm3_prefill (1023,2560)": (1023, 2560),
             "jamba_llava_prefill (1023,4096)": (1023, 4096)}
# minicpm3-4b (MLA) at full width and all 62 layers (~4.26 B parameters,
# ~8.5 GB in bf16): serve's trace on every serve path.  Its teacher-forced
# logits are gated over MLA_GATED_LAYERS layers (all of them); if they
# miss LOGIT_TOL there, the error at fewer layers is reported too.
MLA_ARCH = "minicpm3-4b"
MLA_GATED_LAYERS = 62
MLA_DEPTHS = (31, 16, 8)
# mla_spec (graphed) and mla_spec_eager run all of serve's 16 requests:
# the eager draft-and-verify step takes ~1 s at 62 layers (the 16 took
# 30 s of the phases' time), which had cut mla_spec to the first 8
MLA_SPEC_REQUESTS = 16
# the last families: jamba-v0.1-52b (hybrid: seven Mamba-2 SSM slots and
# one attention slot a group of 8, MoE on every other slot, 16 experts top
# 2) at full width and one period, 8 of its 32 layers (13.27 B parameters,
# 26.5 GB in bf16; all 32 layers are 102.9 GB and do not fit one card);
# llava-next-mistral-7b (the VLM stub: 576 patch embeddings) and
# whisper-small (the encoder-decoder over 1500 stub frames) at full width
# and depth
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_LAYERS = 8
# chunked_hybrid: 4 requests of 130-300 tokens in 128-token chunks (each
# chunk token runs the 7 SSM slots' decode step: chunks are long on SSM
# stacks, as chunked_mamba's)
HYBRID_CHUNKED = dict(n_requests=4, slots=8, max_len=1024, seed=0,
                      prompt_len=(130, 300), max_new_tokens=32)
VLM_ARCH = "llava-next-mistral-7b"
VLM_TEXT = 447            # text tokens after the 576 patches: 1023 positions
ENCDEC_ARCH = "whisper-small"
ENCDEC = dict(batch=8, prompt=4, max_len=448, steps=124)
# their kernel shapes (arch_kernel_shapes): flash (B, S, T, H, K, Dh,
# causal) at jamba's and llava's 1023-position admission, whisper's
# encoder (S = T = 1500, non-causal) and its cross-attention (a 4-token
# prompt over 1500 frames); paged decode at G = 4, Dh 128; dense decode at
# G = 1 over whisper's 448-slot cache; jamba's experts at the 1023
# bucket's capacity (C = 160); the SSD scan at state 16 over 128 heads
FAMILY_FLASH = {
    "jamba_llava_S1023 (1,1023,32/8,128)": (1, 1023, 1023, 32, 8, 128, True),
    "whisper_encoder (8,1500,12/12,64) non-causal":
        (8, 1500, 1500, 12, 12, 64, False),
    "whisper_cross (8,4,12/12,64) over (8,1500,12,64) non-causal":
        (8, 4, 1500, 12, 12, 64, False)}
FAMILY_DENSE = ("whisper q (8,12,64), cache (8,448,12,64), G = 1",
                (8, 448, 12, 12, 64, [5, 128, 66, 6, 100, 30, 127, 64]))
FAMILY_GMM = (16, 160, {"jamba_up (16,160,4096)x(16,4096,14336)":
                        (4096, 14336),
                        "jamba_down (16,160,14336)x(16,14336,4096)":
                        (14336, 4096)})
FAMILY_SSD = {"jamba_S1023 (1,1023,128,64), B/C (1,1023,1,16)":
              (1, 1023, 128, 64, 1, 16, 256)}
# the pilot's cleanup (§3.6 of the paper) on the card: memory back within
# this of its value before the first bind
PILOT_MEMORY_SLACK = 64 << 20
# tensor-parallel serving: a (1, 2) mesh whose two ranks share the card;
# per-rank KV bytes at most this share of the total; tp_serve's churn
# (the reference battery's: requests sharing a 40-token prompt); tp_spec
# and tp_mla take the whole trace, as mla_spec does (tp_spec_eager, the
# eager one-device spec run, on the same requests)
TP_DEVICES = ("cuda:0", "cuda:0")
TP_KV_SHARE = 0.6
TP_CHURN = 6
TP_SPEC_REQUESTS = 16
TP_MLA_REQUESTS = 16
# tp_moe, tp_ssm, tp_hybrid and tp_data: the trace's first 8 requests;
# tp_data's (2, 2) mesh puts its four ranks on the card
TP_FAMILY_REQUESTS = 8
TP_DATA_DEVICES = ("cuda:0",) * 4
# tp_rank_kernels: (E, C, D, F) of the whole up call, a rank takes F/2
TP_RANK_GMM = {"granite_rank (40,256,1536)x(40,1536,256)": (40, 256, 1536,
                                                            512),
               "jamba_rank (16,160,4096)x(16,4096,7168)": (16, 160, 4096,
                                                           14336)}
# fleet serve: serve's trace over 3 pilots of 8 slots each, leasing from
# one pool.  A server renews its leases once a tick, and its first tick
# waits for the other servers' first ticks at the device lock.  With the
# eager admissions and spec pair the second of 2 self-drafting servers
# waited 0.9-1.1 s and lost leases at the reference's 0.5 s TTL; with
# them graphed no profile_fleet.py run loses one at 0.5 s or 1 s, but a
# live server waits 1.38 s for a joiner's warm-up, whose
# warm_admission captures the admission graphs (fleet_join; PERF.md
# §6).  The TTL is 3 s, and no run may lose a lease; a dead server's
# requests come back after it.  fleet_requeue kills the pilot
# holding the most leases once 4 requests have settled; fleet_autoscale
# serves a 24-request trace of serve's shape in 2 bursts of 2 s, 4 s
# apart, under the autoscaler, from 1 pilot, at most 3
FLEET_PILOTS = 3
FLEET_TTL = 3.0
FLEET_FAIL_AT = 4
AUTOSCALE = dict(n_requests=24, bursts=2, burst_s=2.0, gap_s=4.0,
                 initial_pilots=1, max_pilots=3)
# fleet_join: a pilot joins beside a serving one once the first of 64
# requests of serve's shape (serve's 16 first) has completed; alone, the
# server takes several joins' worth of time over them
JOIN_REQUESTS = 64
# disaggregated serve: serve's trace through 1 prefill + 1 decode pilot
# (disagg_serve) and 2 + 2 with one pilot of each stage killed
# (disagg_requeue, after 2 settled prefills and 4 settled streams), at
# fleet serve's TTL; minicpm3-4b's run takes the whole trace, as mla_spec
# does
DISAGG_FAIL_PREFILL_AT = 2
DISAGG_FAIL_DECODE_AT = 4
DISAGG_MLA_REQUESTS = 16
# training: full-width smollm-360m (train, pilot_train) and mamba2-370m
TRAIN = dict(batch=8, seq=512, steps=30)
TRAIN_MAMBA = dict(batch=4, seq=512, steps=5)
PILOT_TRAIN = dict(batch=8, seq=512, steps=40, ckpt_every=10)
# One train step, card against CPU from the same f32 state: the loss and
# grad norm as tests/test_torch_train.py holds the CPU to JAX (bf16
# products summed in other orders); each gradient leaf's relative error
# norm; each updated parameter (1) within f32 rounding of the CPU's AdamW
# applied to the card's own gradients (``param_rtol``, ``param_atol``), and
# (2) within 2·lr (+ ``param_atol``) of the CPU's step: AdamW's first step
# moves an element by lr·(m̂/(√v̂+ε) + wd·p) with |m̂/(√v̂+ε)| <= 1, and
# where a gradient's sign differs between the two devices (tiny entries,
# such as the tied embedding's rows of tokens absent from the batch) it
# moves the other way.
TRAIN_PARITY_TOL = dict(loss_abs=2e-3, grad_norm_rtol=2e-2, grad_rel=5e-2,
                        param_rtol=1e-5, param_atol=1e-6)
# The resumed run's last loss against an uninterrupted run's: the card's
# runs are not bitwise reproducible (atomic accumulation in the embedding
# and MoE backward), and the difference grows over 40 steps; a resume that
# lost or swapped the optimizer state moves the loss far more.
RESUME_LOSS_TOL = 2e-2
# The graphed train step against its eager twin: the same tolerance at
# every step, on the same ground (the card's backward is not bitwise
# reproducible).  A replay from a restored state (train_graph_parity):
# each leaf no farther from the first eager run than the second is, plus
# f32 rounding; batch x seq of each arch (granite at 2 of its 32 layers).
GRAPH_PARITY_ATOL = 1e-6
GRAPH_PARITY = {DENSE_ARCH: (TRAIN["batch"], TRAIN["seq"], None),
                SSM_ARCH: (TRAIN_MAMBA["batch"], TRAIN_MAMBA["seq"], None),
                MOE_ARCH: (TRAIN["batch"], TRAIN["seq"], 2)}


def say(obj):
    print(json.dumps(obj), flush=True)


def check_close(name, got, want, tol, row_rel=None):
    """Max abs error; raises if any element is outside atol + rtol*|want|,
    or, with ``row_rel``, if any last-axis row has a relative error norm
    above it."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"{tol}, max abs err {float(err.max())}")
    if row_rel is not None:
        rel = float((err.norm(dim=-1)
                     / want.norm(dim=-1).clamp_min(1e-30)).max())
        if rel > row_rel:
            raise AssertionError(f"{name}: row relative error norm {rel} "
                                 f"> {row_rel}")
    return float(err.max())


def time_ms(fn, n=50, warm=3):
    """Mean device time of ``fn`` over ``n`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bf16(rng, shape, dev, scale=1.0):
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)
            .to(dev, torch.bfloat16))


def bf16_on(gen, shape, dev, scale=1.0):
    """`bf16` drawn on the card from ``gen`` (a generator on ``dev``): the
    experts' weights of the new archs are ~10^9 values, which numpy would
    draw on the host for a minute."""
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


# --------------------------------------------------------------------------
# phase 2: kernels
# --------------------------------------------------------------------------

def paged_inputs(rng, dev, B, H, K, Dh, bs, mb, lens, scratch_row=None,
                 S=None):
    """Pools with NaN in every row no valid position reads: the kernel must
    skip them, as free slots decode over stale scratch rows.  ``lens`` are
    cache lengths, or with ``S`` the offsets of S verify queries (q is then
    (B, S, H, Dh) and row b reads min(lens[b] + S, mb*bs) positions)."""
    nb = B * mb + 1
    q = bf16(rng, (B, H, Dh) if S is None else (B, S, H, Dh), dev)
    kp = bf16(rng, (nb, bs, K, Dh), dev)
    vp = bf16(rng, (nb, bs, K, Dh), dev)
    perm = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(np.int32)
    if scratch_row is not None:
        perm[scratch_row] = 0
    lens = np.asarray(lens, np.int32)
    reach = lens if S is None else np.minimum(lens + S, mb * bs)
    read = np.zeros((nb, bs), bool)
    for b in range(B):
        p = np.arange(reach[b])
        read[perm[b, p // bs], p % bs] = True
    unread = torch.from_numpy(~read).to(dev)
    kp[unread] = float("nan")
    vp[unread] = float("nan")
    return (q, kp, vp, torch.from_numpy(perm).to(dev),
            torch.from_numpy(lens).to(dev))


# The main path's decode shapes (smollm-360m, 8 slots, max_len 1024, block
# 16): lengths 1 and mb*bs, a free slot (row 2) over the scratch block; the
# verify offsets reach past the table at 1022 and 1023.
PAGED_MAIN = dict(B=8, H=15, K=5, Dh=64, bs=16, mb=64,
                  lens=[1, 1024, 37, 500, 17, 16, 333, 900], scratch_row=2)
VERIFY_MAIN = dict(B=8, S=5, H=15, K=5, Dh=64, bs=16, mb=64,
                   lens=[1, 1022, 37, 500, 17, 16, 333, 1023], scratch_row=2)
# profile_serve.py's engine step: 8 live slots of ~200 positions
PROFILE_LENS = [200, 203, 206, 209, 212, 215, 218, 221]
E_GRANITE = 40


def dense_inputs(rng, dev, B, T, H, K, Dh, lens):
    """Dense rings with NaN in every position past a row's length."""
    q = bf16(rng, (B, H, Dh), dev)
    kc, vc = bf16(rng, (B, T, K, Dh), dev), bf16(rng, (B, T, K, Dh), dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    past = torch.arange(T, device=dev)[None] >= ln[:, None]
    kc[past] = float("nan")
    vc[past] = float("nan")
    return q, kc, vc, ln


def gmm_buckets(rng, dev, C, D, F):
    """granite's capacity buckets (E_GRANITE experts of C rows) and expert
    weights."""
    return (bf16(rng, (E_GRANITE, C, D), dev),
            bf16(rng, (E_GRANITE, D, F), dev, scale=D ** -0.5))


def ssd_inputs(rng, dev, b, S, H, P, G, N, dtype):
    def n(shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(dev)
    return (n((b, S, H, P)).to(dtype), F.softplus(n((b, S, H))),
            -torch.exp(n((H,), 0.5)), n((b, S, G, N), 0.3).to(dtype),
            n((b, S, G, N), 0.3).to(dtype))


def main_shape_times(rng, dev):
    """``ms`` (back-to-back eager calls) and ``device_ms`` (a CUDA graph of
    50 calls) of the kernels of rows 2 and 4-7 at their main-path shapes
    (the decode entries also at profile_serve.py's ~200 positions a row),
    and one mamba2-370m admission, through the public entry points only:
    ``--times-of`` runs this on another checkout's package, so that a
    parent's kernels and these are timed by the same code in one call."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.grouped_matmul.ops import bucket_matmul
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_verify_attention)
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    def both(fn, n=50):
        return {"ms": time_ms(fn, n=n), "device_ms": graph_ms(fn)}
    out = {}
    # flash prefill (row 1, untouched here) at the 1023 bucket: the control
    # that a parent and this tree build the same flash kernel
    fq = bf16(rng, (1, 1023, 15, 64), dev)
    fk, fv = bf16(rng, (1, 1023, 5, 64), dev), bf16(rng, (1, 1023, 5, 64), dev)
    out["flash_attention"] = both(lambda: flash_attention(fq, fk, fv), n=20)
    for tag, lens in (("", None), ("_len200", PROFILE_LENS)):
        c = dict(PAGED_MAIN, lens=lens or PAGED_MAIN["lens"])
        args = paged_inputs(rng, dev, **c)
        out["paged_decode_attention" + tag] = both(
            lambda: paged_decode_attention(*args))
        c = dict(VERIFY_MAIN, lens=lens or VERIFY_MAIN["lens"])
        vargs = paged_inputs(rng, dev, **c)
        out["paged_verify_attention" + tag] = both(
            lambda: paged_verify_attention(*vargs))
        dargs = dense_inputs(rng, dev, 8, 1024, 15, 5, 64,
                             lens or PAGED_MAIN["lens"])
        out["decode_attention" + tag] = both(lambda: decode_attention(*dargs))
    for tag, (D, F_) in (("", (1536, 512)), ("_down", (512, 1536))):
        b, w = gmm_buckets(rng, dev, 256, D, F_)
        out["grouped_matmul" + tag] = both(lambda: bucket_matmul(b, w), n=20)
    sargs = ssd_inputs(rng, dev, 1, 1023, 32, 64, 1, 128, torch.bfloat16)
    out["ssd_scan"] = both(lambda: ssd_scan(*sargs, chunk=256), n=20)
    out["mamba_admission"] = mamba_admission_ms(dev)
    return out


def mamba_admission_ms(dev, reps=5):
    """One 1023-token admission prefill of full-width mamba2-370m (the
    bundle's ``prefill``, 48 layers, the SSD-scan and RMSNorm kernels;
    random weights from seed 0): CUDA events around each eager call, after
    a warm-up; and one call's device-busy time under ``torch.profiler``
    (the union of its kernels' spans).  The SSD scan runs 48 times in
    each."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.profile_serve import _busy_ms
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config(SSM_ARCH), ssm_impl="pallas",
                              norm_impl="pallas")
    bundle = build_model(cfg)
    params = bundle.init(0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, 1023)).astype(np.int32)).to(dev)

    def admit():
        return bundle.prefill(params, {"tokens": tokens})
    ms = time_ms(admit, n=reps, warm=2)
    busy = _busy_ms(device_events(admit))
    # the same admission as a CUDA graph, as the engine replays it (built
    # here with torch alone: ``--times-of`` runs this on a parent's
    # package): its wall time per replay beside its device time
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = admit()[0].clone()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = admit()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want), "graphed admission != eager"
    g_ms = time_ms(graph.replay, n=reps, warm=2)
    g_busy = _busy_ms(device_events(graph.replay))
    del params, graph, out
    torch.cuda.empty_cache()
    return {"ms": ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / ms), "tokens": 1023,
            "layers": cfg.num_layers,
            "graph": {"ms": g_ms, "device_busy_ms": g_busy,
                      "device_idle_share": max(0.0, 1.0 - g_busy / g_ms),
                      "logits_bitwise_eager": True}}


def decode_split():
    """The decode body's split width at the main path's capacity (1024
    positions in blocks of 16), where the edge cases sit."""
    from repro_torch.kernels.decode_attention.ops import split_plan
    return split_plan(1024, 16)[0]


def check_paged(rng, dev, times):
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    W = decode_split()
    cases = {
        "main": PAGED_MAIN,
        # granite-moe-3b-a800m decode: 24 heads / 8 kv heads
        "granite": dict(PAGED_MAIN, H=24, K=8),
        # lengths at the edges of the sequence splits
        "split_edges": dict(PAGED_MAIN, lens=[1, W - 1, W, W + 1, 2 * W + 1,
                                              1024, 1023, 3 * W]),
        "granite_split_edges": dict(PAGED_MAIN, H=24, K=8,
                                    lens=[W + 1, W - 1, 1, W, 1024, 2 * W,
                                          1023, 5 * W - 1]),
        "smoke": dict(B=3, H=3, K=1, Dh=20, bs=16, mb=4, lens=[1, 64, 19],
                      scratch_row=2),
        # late_binding_serve's engines (2 slots, max_len 64): an 8-token
        # prompt's admission, then 6 steps
        "example_smollm": dict(B=2, H=15, K=5, Dh=64, bs=16, mb=4,
                               lens=[9, 14]),
        "example_gemma": dict(B=2, H=8, K=1, Dh=256, bs=16, mb=4,
                              lens=[14, 9]),
    }
    errs = {}
    for name, c in cases.items():
        args = paged_inputs(rng, dev, **c)
        got = paged_decode_attention(*args)
        errs[name] = check_close(f"paged/{name}", got,
                                 paged_decode_attention_plain(*args), ATTN_TOL,
                                 ROW_REL_TOL)
    args = paged_inputs(rng, dev, **PAGED_MAIN)
    c = PAGED_MAIN
    live = sum(c["lens"])
    blocks_read = sum(-(-n // c["bs"]) for n in c["lens"])
    nbytes = (live * c["K"] * c["Dh"] * 2 * 2            # K and V rows read
              + 2 * c["B"] * c["H"] * c["Dh"] * 2          # q in, out
              + blocks_read * 4 + c["B"] * 4)              # table, lengths
    flops = 4 * live * c["H"] * c["Dh"]
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:75",
        "shape": "q (8,15,64) bf16, pools (513,16,5,64), tables (8,64), "
                 f"lens {c['lens']}",
        "split_width": W,
        "max_abs_err": errs["main"], "max_abs_err_by_case": errs,
        **times["paged_decode_attention"],
        "len200": times["paged_decode_attention_len200"],
        "plain_ms": time_ms(lambda: paged_decode_attention_plain(*args)),
        "library_ms": None,
        **bound(nbytes, flops, BF16_FLOPS),
    }


def check_verify(rng, dev, times):
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_verify_attention,
        paged_verify_attention_plain)
    W = decode_split()
    cases = {
        "main": VERIFY_MAIN,
        "granite": dict(VERIFY_MAIN, H=24, K=8),
        # staircases whose frontiers cross a split, and the clamped rows
        "split_crossing": dict(VERIFY_MAIN, lens=[W - 3, W - 1, 2 * W - 2,
                                                  1022, 1023, 0, W, 3 * W - 4]),
        "granite_split_crossing": dict(VERIFY_MAIN, H=24, K=8,
                                       lens=[W - 5, 1023, W - 1, 2 * W - 3,
                                             1022, W + 2, 4 * W - 1, 0]),
        "smoke": dict(B=3, S=5, H=3, K=1, Dh=20, bs=16, mb=4,
                      lens=[1, 62, 19], scratch_row=2),
    }
    errs = {}
    for name, c in cases.items():
        args = paged_inputs(rng, dev, **c)
        got = paged_verify_attention(*args)
        errs[name] = check_close(f"verify/{name}", got,
                                 paged_verify_attention_plain(*args),
                                 ATTN_TOL, ROW_REL_TOL)
        q, kp, vp, tables, off = args
        T = c["mb"] * c["bs"]
        for s in range(c["S"]):
            one = paged_decode_attention(q[:, s].contiguous(), kp, vp, tables,
                                         torch.clamp(off + s + 1, max=T))
            if not torch.equal(got[:, s], one):
                raise AssertionError(f"verify/{name}: query {s} is not "
                                     "bitwise the paged decode kernel's")
    c = VERIFY_MAIN
    args = paged_inputs(rng, dev, **c)
    T = c["mb"] * c["bs"]
    off = np.asarray(c["lens"])
    reach = np.minimum(off + c["S"], T)
    qlen = sum(int(min(o + s + 1, T)) for o in off for s in range(c["S"]))
    nbytes = (int(reach.sum()) * c["K"] * c["Dh"] * 2 * 2     # K, V rows
              + 2 * c["B"] * c["S"] * c["H"] * c["Dh"] * 2     # q in, out
              + int((-(-reach // c["bs"])).sum()) * 4 + c["B"] * 4)
    flops = 4 * c["H"] * c["Dh"] * qlen
    return {
        "name": "paged_verify_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_verify.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:179",
        "shape": "q (8,5,15,64) bf16, pools (513,16,5,64), tables (8,64), "
                 f"q_off {c['lens']}",
        "split_width": W,
        "max_abs_err": errs["main"], "max_abs_err_by_case": errs,
        "bitwise_vs_paged_decode": True,
        **times["paged_verify_attention"],
        "len200": times["paged_verify_attention_len200"],
        "plain_ms": time_ms(lambda: paged_verify_attention_plain(*args)),
        "library_ms": None,
        **bound(nbytes, flops, BF16_FLOPS),
    }


def check_dense(rng, dev, times):
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    W = decode_split()
    cases = {   # name: (B, T, H, K, Dh, lens); dense rings of max_len 1024
        "main": (8, 1024, 15, 5, 64, PAGED_MAIN["lens"]),
        "granite": (8, 1024, 24, 8, 64, PAGED_MAIN["lens"]),
        "split_edges": (8, 1024, 15, 5, 64,
                        [1, W - 1, W, W + 1, 2 * W + 1, 1024, 1023, 3 * W]),
        "granite_split_edges": (8, 1024, 24, 8, 64,
                                [W + 1, W - 1, 1, W, 1024, 2 * W, 1023,
                                 5 * W - 1]),
        "smoke": (3, 64, 3, 1, 20, [1, 64, 19]),
        # the examples' decode images (shape "smoke": 2 rows, T 64) at
        # full width: the payloads' 3-4 steps from an empty cache, and
        # fuller rings
        "example_smollm": (2, 64, 15, 5, 64, [4, 1]),
        "example_smollm_ring": (2, 64, 15, 5, 64, [64, 37]),
        "example_gemma": (2, 64, 8, 1, 256, [4, 1]),
        "example_gemma_ring": (2, 64, 8, 1, 256, [37, 64]),
    }
    errs = {}
    for name, (B, T, H, K, Dh, lens) in cases.items():
        q, kc, vc, ln = dense_inputs(rng, dev, B, T, H, K, Dh, lens)
        got = decode_attention(q, kc, vc, ln)
        errs[name] = check_close(f"dense/{name}", got,
                                 decode_attention_plain(q, kc, vc, ln),
                                 ATTN_TOL, ROW_REL_TOL)
        bs = 16                                 # the same rows, paged
        mb, nb = T // bs, B * T // bs + 1
        tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
            B, mb).astype(np.int32)).to(dev)
        pools = []
        for cache in (kc, vc):
            pool = torch.zeros((nb, bs, K, Dh), dtype=torch.bfloat16,
                               device=dev)
            pool[tables.reshape(-1).long()] = cache.reshape(B * mb, bs, K, Dh)
            pools.append(pool)
        if not torch.equal(got, paged_decode_attention(q, *pools, tables, ln)):
            raise AssertionError(f"dense/{name}: not bitwise the paged "
                                 "decode kernel on the same rows")
    B, T, H, K, Dh, lens = cases["main"]
    q, kc, vc, ln = dense_inputs(rng, dev, B, T, H, K, Dh, lens)
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None] < ln[:, None])[:, None, None]
    live = sum(lens)
    nbytes = (live * K * Dh * 2 * 2 + 2 * B * H * Dh * 2 + B * 4)
    flops = 4 * live * H * Dh

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:73",
        "shape": f"q (8,15,64) bf16, caches (8,1024,5,64), lens {lens}",
        "split_width": W,
        "max_abs_err": errs["main"], "max_abs_err_by_case": errs,
        "bitwise_vs_paged_decode": True,
        **times["decode_attention"],
        "len200": times["decode_attention_len200"],
        "plain_ms": time_ms(lambda: decode_attention_plain(q, kc, vc, ln)),
        "library_ms": time_ms(sdpa),
        "library_device_ms": graph_ms(sdpa),
        **bound(nbytes, flops, BF16_FLOPS),
    }


def graph_ms(fn, n=50, reps=5):
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times, timed with CUDA events.  The
    host's launch path is out of it; a capture that fails fails the phase."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    return ms


def sass_counts(lib, ops=("HGMMA", "HMMA", "FFMA")):
    """How often each SASS opcode occurs in a built kernel library
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def kernel_name(mangled):
    """``flash_prefill_kernel<64,false>`` from its mangled name (the
    templates of this repo's kernels: ints, bools, float and bf16)."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        n, ident = int(m.group(1)), m.group(2)
        if len(ident) >= n and ident[:n].endswith("kernel"):
            args = re.match(r"I(.*?E)E", ident[n:])
            if args is None:
                return ident[:n]
            a = re.sub(r"Li(\d+)E", r"\1,", args.group(1))
            a = a.replace("Lb0E", "false,").replace("Lb1E", "true,")
            a = re.sub(r"^f", "float,", a.replace("13__nv_bfloat16", "bf16,"))
            return f"{ident[:n]}<{a.rstrip(',E')}>"
    return mangled


def ptxas_report(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    ``-Xptxas -v`` output (empty when the library was already built)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", ln)):
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name]["registers"] = int(m.group(1))
    return out


def flash_work(B, S, H, K, Dh):
    """Bytes (q, k, v read once, out written once) and causal-pair flops."""
    return (2 * (2 * B * S * H * Dh + 2 * B * S * K * Dh),
            4 * Dh * H * B * S * (S + 1) // 2)


def check_flash(rng, dev, ptxas):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    cases = {   # name: (B, S, T, H, K, Dh, causal, window, q_offset)
        "main_S1023": (1, 1023, 1023, 15, 5, 64, True, None, 0),
        "granite_S1023": (1, 1023, 1023, 24, 8, 64, True, None, 0),
        "S16": (1, 16, 16, 15, 5, 64, True, None, 0),
        "S100": (1, 100, 100, 15, 5, 64, True, None, 0),
        "S1": (1, 1, 1, 15, 5, 64, True, None, 0),
        "S65": (1, 65, 65, 15, 5, 64, True, None, 0),
        "B2_S300": (2, 300, 300, 15, 5, 64, True, None, 0),
        "granite_B2_S300": (2, 300, 300, 24, 8, 64, True, None, 0),
        "Dh128": (1, 300, 300, 16, 4, 128, True, None, 0),
        "Dh256_mqa": (1, 200, 200, 8, 1, 256, True, None, 0),
        "window_offset": (2, 48, 112, 4, 2, 32, True, 40, 64),
        "noncausal_T100": (1, 48, 100, 6, 2, 32, False, None, 0),
        "smoke": (1, 37, 37, 3, 1, 20, True, None, 0),
        # late_binding_serve's gemma-2b admission: an 8-token prompt at
        # the 16 bucket (smollm-360m's is "S16")
        "gemma_S16": (1, 16, 16, 8, 1, 256, True, None, 0),
    }
    errs = {}
    for name, (B, S, T, H, K, Dh, causal, window, off) in cases.items():
        q, k, v = (bf16(rng, (B, S, H, Dh), dev), bf16(rng, (B, T, K, Dh), dev),
                   bf16(rng, (B, T, K, Dh), dev))
        kw = dict(causal=causal, window=window, q_offset=off)
        errs[name] = check_close(f"flash/{name}", flash_attention(q, k, v, **kw),
                                 flash_attention_plain(q, k, v, **kw), ATTN_TOL,
                                 ROW_REL_TOL)
    sass = sass_counts(_build._target("flash_prefill"))
    if sass is not None and sass["HGMMA"] == 0:
        raise AssertionError(f"flash: no wgmma (HGMMA) in the SASS: {sass}")

    def timed(B, S, H, K, Dh):
        q, k, v = (bf16(rng, (B, S, H, Dh), dev), bf16(rng, (B, S, K, Dh), dev),
                   bf16(rng, (B, S, K, Dh), dev))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        nbytes, flops = flash_work(B, S, H, K, Dh)
        return {
            "ms": time_ms(lambda: flash_attention(q, k, v), n=20),
            "device_ms": graph_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), n=20),
            "library_ms": time_ms(sdpa, n=20),
            "library_device_ms": graph_ms(sdpa),
            **bound(nbytes, flops, BF16_FLOPS),
        }
    main = timed(1, 1023, 15, 5, 64)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        "instance": "wgmma + TMA (m64n64k16; 64-row query tile; two "
                    "consumer warpgroups over alternate 64-key tiles; TMA "
                    "ring of 4 K/V tiles)",
        "ptxas": ptxas.get("flash_prefill", {}),
        "sass": sass,
        "shape": "q (1,1023,15,64), k/v (1,1023,5,64) bf16, causal",
        "max_abs_err": errs["main_S1023"],
        "max_abs_err_granite": errs["granite_S1023"],
        "max_abs_err_by_case": errs,
        "max_abs_err_all_cases": max(errs.values()),
        **main,
        "buckets": {"granite_S1023 (1,1023,24/8,64)": timed(1, 1023, 24, 8, 64),
                    "S512 (1,512,15/5,64)": timed(1, 512, 15, 5, 64),
                    "S128 (1,128,15/5,64)": timed(1, 128, 15, 5, 64)},
    }


def check_rmsnorm(rng, dev, ptxas):
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused, rmsnorm_plain
    errs = {}
    for name, shape, with_res in (("decode_R8", (8, 960), False),
                                  ("decode_R8_residual", (8, 960), True),
                                  ("R1", (1, 960), False),
                                  ("prefill_R1023_residual", (1023, 960), True),
                                  ("granite_decode_R8", (8, 1536), False),
                                  ("granite_prefill_R1023", (1, 1023, 1536),
                                   False),
                                  ("mamba_decode_R8", (8, 1024), False),
                                  ("D2048_R8_residual", (8, 2048), True),
                                  ("D4096_R8", (8, 4096), False),
                                  ("D4096_R1023_residual", (1023, 4096), True),
                                  ("smoke", (3, 37, 60), False)):
        x = bf16(rng, shape, dev)
        r = bf16(rng, shape, dev) if with_res else None
        sc = (torch.from_numpy(rng.normal(size=shape[-1:]).astype(np.float32))
              .to(dev) * 0.1)
        errs[name] = max(
            check_close(f"rmsnorm/{name}/{i}", got, want, NORM_TOL)
            for i, (got, want) in enumerate(zip(rmsnorm_fused(x, sc, r),
                                                rmsnorm_plain(x, sc, r))))
    R, D = 8, 960
    x = bf16(rng, (R, D), dev)
    sc = torch.from_numpy(rng.normal(size=(D,)).astype(np.float32)).to(dev) * 0.1
    w = (1.0 + sc).to(torch.bfloat16)
    nbytes = R * D * 2 + D * 4 + 2 * R * D * 2          # x, scale, 2 outputs
    flops = 5 * R * D
    return {
        "name": "rmsnorm_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:33",
        "ptxas": ptxas.get("rmsnorm", {}),
        "shape": "x (8,960) bf16 (decode), scale (960,) f32",
        "max_abs_err": errs["decode_R8"],
        "max_abs_err_granite": max(errs["granite_decode_R8"],
                                   errs["granite_prefill_R1023"]),
        "max_abs_err_by_case": errs,
        "max_abs_err_all_cases": max(errs.values()),
        "ms": time_ms(lambda: rmsnorm_fused(x, sc)),
        "device_ms": graph_ms(lambda: rmsnorm_fused(x, sc)),
        "plain_ms": time_ms(lambda: rmsnorm_plain(x, sc)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)),
        "library_device_ms": graph_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)),
        **bound(nbytes, flops, F32_FLOPS),
    }


def check_grouped_matmul(rng, dev, times, ptxas):
    from repro_torch.kernels import _build
    from repro_torch.kernels.grouped_matmul.ops import (
        bucket_matmul, grouped_matmul, grouped_matmul_plain)
    E = E_GRANITE
    errs = {}
    # granite's capacity buckets, one launch per product: up/gate and down
    # at every admission bucket (C = 256 at 1023 tokens, then 136, 72, 40,
    # 24), none a multiple of the tile height but 256
    for C in (256, 136, 72, 40, 24):
        for part, (D, F_) in (("up", (1536, 512)), ("down", (512, 1536))):
            b, w = gmm_buckets(rng, dev, C, D, F_)
            want = grouped_matmul_plain(b.reshape(E * C, D), w, [C] * E)
            errs[f"{part}_C{C}"] = check_close(
                f"gmm/{part}_C{C}", bucket_matmul(b, w),
                want.reshape(E, C, F_), GMM_TOL)
    # ragged sizes with empty groups, and tail rows owned by no group
    # (NaN there: the kernel writes them as 0 without reading them); D = F
    # = 96 leaves TMA's zero fill to the ragged K step and column tile
    for name, (Eg, D, F_, sizes, tail) in (
            ("empty_group", (3, 96, 96, [0, 64, 32], 32)),
            ("ragged_40", (E, 1536, 512,
                           [0 if g % 13 == 3 else int(s) for g, s in
                            enumerate(rng.integers(1, 300, size=E))], 100)),
            ("ragged_40_down", (E, 512, 1536,
                                [0 if g % 7 == 2 else int(s) for g, s in
                                 enumerate(rng.integers(1, 200, size=E))],
                                131))):
        n = sum(sizes)
        x = bf16(rng, (n + tail, D), dev)
        x[n:] = float("nan")
        w = bf16(rng, (Eg, D, F_), dev, scale=D ** -0.5)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        got = grouped_matmul(x, w, gs)
        if got[n:].any():
            raise AssertionError(f"gmm/{name}: tail rows are not 0")
        errs[name] = check_close(f"gmm/{name}", got,
                                 grouped_matmul_plain(x, w, gs), GMM_TOL)
    sass = sass_counts(_build._target("grouped_matmul"))
    if sass is not None and sass["HGMMA"] == 0:
        raise AssertionError(f"gmm: no wgmma (HGMMA) in the SASS: {sass}")

    def timed(C, D, F_, tag):
        b, w = gmm_buckets(rng, dev, C, D, F_)
        T = E * C
        nbytes = T * D * 2 + E * D * F_ * 2 + T * F_ * 4   # x, w; y f32 out

        def bmm_f32():
            return torch.bmm(b, w, out_dtype=torch.float32)
        return {
            **times["grouped_matmul" + tag],
            "plain_ms": time_ms(lambda: grouped_matmul_plain(
                b.reshape(T, D), w, [C] * E), n=5),
            "library_ms": time_ms(bmm_f32, n=20),
            "library_device_ms": graph_ms(bmm_f32),
            "library_bf16_out_ms": time_ms(lambda: torch.bmm(b, w), n=20),
            "library_bf16_out_device_ms": graph_ms(lambda: torch.bmm(b, w)),
            **bound(nbytes, 2 * T * D * F_, BF16_FLOPS),
        }
    down = timed(256, 512, 1536, "_down")
    return {
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul/kernel.py:34",
        "instance": "wgmma + TMA (m64n128k16; 128 x 128 tiles of one group; "
                    "two consumer warpgroups; persistent CTAs, two an SM "
                    "with a TMA ring of 3 64-deep K steps, or one an SM "
                    "with 4 where that fills the last round of tiles "
                    "better)",
        "ptxas": ptxas.get("grouped_matmul", {}),
        "sass": sass,
        "shape": "buckets (40,256,1536) bf16 x w (40,1536,512) bf16 -> f32 "
                 "(up/gate, 1023-token admission); library: torch.bmm with "
                 "out_dtype f32 (library_bf16_out: bf16 out)",
        "max_abs_err": errs["up_C256"],
        "max_abs_err_by_case": errs,
        "max_abs_err_all_cases": max(errs.values()),
        **timed(256, 1536, 512, ""),
        "down": {"shape": "(40,256,512) x (40,512,1536)", **down},
    }


def ssd_work(b, S, H, P, G, N, Q, itemsize):
    """Bytes (each input read once, each output written once; the kernel's
    workspace is not counted), the function's operations (per chunk of q
    steps: C.B^T over the causal q(q+1)/2 pairs once per group, and per
    head its product with x dt, the carry-in C.state and the state update;
    an FMA counts 2), and the tensor-core operations the bf16 instance's
    precision needs (C.B^T one pass, every other product two: its f32
    operand split into bf16 hi + lo)."""
    nbytes = (2 * b * S * H * P * itemsize + b * S * H * 4 + H * 4
              + 2 * b * S * G * N * itemsize + b * H * N * P * 4)
    cb = per_head = 0
    for t0 in range(0, S, Q):
        q = min(Q, S - t0)
        pairs = q * (q + 1) // 2
        cb += 2 * pairs * N * G
        per_head += H * (2 * pairs * P + 4 * q * N * P)
    return nbytes, b * (cb + per_head), b * (cb + 2 * per_head)


def check_ssd_scan(rng, dev, times, ptxas):
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ops import (
        KERNEL_CHUNK, chunk_for, ssd_scan, ssd_scan_plain)

    bf = torch.bfloat16
    cases = {   # name: (b, S, H, P, G, N, chunk, dtype)
        # mamba2-370m's admissions: 32 heads of 64, state 128, chunk 256;
        # S = 1023 runs 4 chunks, the last with 255 steps; S <= 256 one
        # chunk of S (chunks 32, 64, 128)
        "main_S1023": (1, 1023, 32, 64, 1, 128, 256, bf),
        "S512": (1, 512, 32, 64, 1, 128, 256, bf),
        "S128": (1, 128, 32, 64, 1, 128, 256, bf),
        "S64": (1, 64, 32, 64, 1, 128, 256, bf),
        "S32": (1, 32, 32, 64, 1, 128, 256, bf),
        "S257_one_row_last_chunk": (1, 257, 32, 64, 1, 128, 256, bf),
        "b2_S1023": (2, 1023, 32, 64, 1, 128, 256, bf),
        "padded_S100": (1, 100, 32, 64, 1, 128, 32, bf),
        "G2_S1023": (1, 1023, 32, 64, 2, 128, 256, bf),
        "G2_ref": (1, 192, 8, 32, 2, 64, 64, bf),
        "f32_S1023": (1, 1023, 32, 64, 1, 128, 256, torch.float32),
        "f32_padded_ref": (1, 100, 4, 32, 1, 64, 32, torch.float32),
    }
    errs = {}
    for name, (b, S, H, P, G, N, Q, dtype) in cases.items():
        args = ssd_inputs(rng, dev, b, S, H, P, G, N, dtype)
        y, st = ssd_scan(*args, chunk=Q)
        torch.cuda.synchronize()
        if y.dtype != dtype or st.dtype != torch.float32:
            raise AssertionError(f"ssd/{name}: y {y.dtype}, state {st.dtype}")
        yw, sw = ssd_scan_plain(*args, chunk=Q)
        errs[name] = max(check_close(f"ssd/{name}/y", y, yw, SSD_TOL[dtype]),
                         check_close(f"ssd/{name}/state", st, sw,
                                     SSD_TOL[dtype]))
    sass = sass_counts(_build._target("ssd_scan"))
    if sass is not None and sass["HGMMA"] + sass["HMMA"] == 0:
        raise AssertionError(f"ssd: no tensor-core instruction (HGMMA, HMMA) "
                             f"in the SASS: {sass}")
    b, S, H, P, G, N, Q, dtype = cases["main_S1023"]
    args = ssd_inputs(rng, dev, b, S, H, P, G, N, dtype)
    # the work of the chunking the kernel runs (at most KERNEL_CHUNK); the
    # f32-FMA bound of the earlier scalar kernel, on the model's chunk
    nbytes, flops, tc_flops = ssd_work(b, S, H, P, G, N,
                                       min(chunk_for(S, Q), KERNEL_CHUNK), 2)
    _, model_flops, _ = ssd_work(b, S, H, P, G, N, chunk_for(S, Q), 2)
    f32 = bound(nbytes, model_flops, F32_FLOPS)
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:83",
        "instance": "C.B^T and M.x on wgmma m64n64k16 (HGMMA), the chunk "
                    "states and the carry-in on mma.sync m16n8k16 (HMMA), "
                    "bf16 -> f32, f32 operands split into bf16 hi + lo; a "
                    "device launch for each phase: chunk states, state "
                    "passing, y per (1 or 2 heads, chunk, 64-row q tile)",
        **device_kernels(lambda: ssd_scan(*args, chunk=Q)),
        "ptxas": ptxas.get("ssd_scan", {}),
        "sass": sass,
        "shape": "x (1,1023,32,64) bf16, dt (1,1023,32) f32, B/C "
                 "(1,1023,1,128) bf16, chunk 256 -> y bf16, state "
                 "(1,32,128,64) f32",
        "max_abs_err": errs["main_S1023"],
        "max_abs_err_all_cases": max(errs.values()),
        "max_abs_err_by_case": errs,
        **times["ssd_scan"],
        # the design's choice of its own chunk (ops.KERNEL_CHUNK) against
        # running it on the model's chunk of 256
        "device_ms_on_model_chunk": graph_ms(
            lambda: ops._launch(*args, Q, Q=chunk_for(S, Q))),
        "heads_per_cta": ssd_heads_per_cta(rng, dev),
        "plain_ms": time_ms(lambda: ssd_scan_plain(*args, chunk=Q), n=5),
        "library_ms": None,
        # the bound on the tensor cores at the passes the precision needs;
        # the f32-FMA bound of the earlier scalar kernel beside it
        **bound(nbytes, tc_flops, BF16_FLOPS),
        "function_flops": flops,
        "model_chunk_flops": model_flops,
        "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"],
    }


def device_events(fn):
    """The device events (kernels, copies) of one call of ``fn`` under
    ``torch.profiler``, traced after a warm-up step: a profile without one
    missed the first kernels of the call on the H100."""
    cuda = torch.autograd.DeviceType.CUDA
    got = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: got.extend(
                e for e in p.events() if e.device_type == cuda)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return got


def device_kernels(fn):
    """The device kernels that one call of ``fn`` launches, by name."""
    names = [e.name.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void ") for e in device_events(fn)]
    return {"device_launches_per_call": len(names), "device_kernels": names}


def ssd_heads_per_cta(rng, dev):
    """The SSD scan's last phase with one and with two heads of a group a
    CTA (two share each C.B^T tile), at mamba2-370m's admission buckets:
    each against the plain version, whether the two agree bitwise (the
    same operations in the same order), and ``device_ms`` of each."""
    from repro_torch.kernels.ssd_scan import ops
    out = {}
    for S in (1023, 512, 128, 64, 32):
        args = ssd_inputs(rng, dev, 1, S, 32, 64, 1, 128, torch.bfloat16)
        want = ops.ssd_scan_plain(*args, chunk=256)
        got = {}
        for h in (1, 2):
            got[h] = ops._launch(*args, 256, heads=h)
            for part, g, w in zip(("y", "state"), got[h], want):
                check_close(f"ssd/heads{h}_S{S}/{part}", g, w,
                            SSD_TOL[torch.bfloat16])
        out[f"S{S}"] = {
            "bitwise_equal": all(map(torch.equal, got[1], got[2])),
            **{f"device_ms_{h}": graph_ms(
                lambda h=h: ops._launch(*args, 256, heads=h))
               for h in (1, 2)}}
    return out


def load_peaks():
    global HBM_BPS, BF16_FLOPS, F32_FLOPS
    from repro_torch.launch import hw
    HBM_BPS, BF16_FLOPS, F32_FLOPS = hw.HBM_BW, hw.PEAK_FLOPS, hw.F32_FLOPS


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --------------------------------------------------------------------------
# phases 3-4: serve and model check
# --------------------------------------------------------------------------

def serve_trace(arch, load=SERVE):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_trace
    return make_trace(get_config(arch).vocab_size, load["n_requests"],
                      max_len=load["max_len"], seed=load["seed"],
                      prompt_len=load["prompt_len"],
                      max_new_tokens=load["max_new_tokens"])


def serve_run(phase, wrappers, arch=DENSE_ARCH, load=SERVE, cfg=None,
              trace=None, **kw):
    """One ``serve_direct`` run of the trace ``load`` on ``arch`` (or of
    ``trace`` on ``cfg``) with every launch count set to 0 just before it
    and read just after; the gates every run must pass."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import expected_tokens, serve_direct
    cfg = cfg or get_config(arch)
    trace = trace or serve_trace(arch, load)
    for w in wrappers:
        w.launches = 0
    stats = serve_direct(cfg, device="cuda", trace=trace, **load, **kw)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    want = {e["rid"]: expected_tokens(e, load["max_len"]) for e in trace}
    out = {k: stats[k] for k in (
        "completed", "decode_steps", "tokens_decoded", "d2h_transfers",
        "wall_s", "tok_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
        "itl_p50_s", "itl_p99_s", "slot_utilization", "kv",
        "kv_pool_bytes", "block_leaks", "spec", "spec_k",
        "spec_fallback_reason", "acceptance_rate", "tokens_per_step",
        "draft_overhead_s", "step_graph", "graph_warm_launches", "prefill",
        "prefill_chunks", "run_peak_bytes", *GRAPH_KEYS)}
    out["launches"] = launches
    out["prompt_lens"] = [len(e["prompt"]) for e in trace]
    out["tokens_per_request"] = [stats["tokens_per_request"][e["rid"]]
                                 for e in trace]
    say({"phase": phase, "arch": cfg.name, **out})
    assert stats["completed"] == load["n_requests"], stats["completed"]
    assert stats["tokens_per_request"] == want, (stats["tokens_per_request"], want)
    assert stats["d2h_transfers"] == stats["decode_steps"] > 0
    assert stats["block_leaks"] == 0
    graph_gate(phase, stats)
    return stats, launches


# which of an engine's functions ran as replayed CUDA graphs, and the
# memory their captures hold (`ServeEngine._stats`)
GRAPH_KEYS = ("decode_graph", "spec_graph", "prefill_graph",
              "draft_prefill_graph", "chunk_graph", "graph_pool_bytes")


def graph_gate(phase, st):
    """A one-device unified engine's graphs: with ``step_graph`` on, every
    function the reference compiles that this run called was a graph (the
    decode step or the spec pair, the one-shot admission of each bucket it
    admitted at, target and draft, or the chunk function of each chunk
    length); with it off, none was."""
    if not st["step_graph"]:
        assert not any(st[k] for k in GRAPH_KEYS), (phase, st)
        return
    spec = st["spec"] == "draft"
    assert st["spec_graph"] == spec, (phase, st["spec_graph"])
    assert st["decode_graph"] == (not spec), phase
    chunked = st["prefill"] == "chunked"
    assert bool(st["chunk_graph"]) == chunked, (phase, st["chunk_graph"])
    assert bool(st["prefill_graph"]) != chunked, (phase, st["prefill_graph"])
    assert bool(st["draft_prefill_graph"]) == spec, (
        phase, st["draft_prefill_graph"])
    assert st["graph_pool_bytes"] > 0, (phase, st["graph_pool_bytes"])


# The bound on what a graphed engine's captures hold, stated before its
# first chip run: each pool (the admission graphs' one, the decode step's,
# the draft chain's and the verify step's) holds at most one working set
# of the eager engine, i.e. the most its eager twin allocated above its
# built engine in the same run (`serve_direct`'s ``run_peak_bytes``: the
# one-shot admission of the largest bucket, its prefill cache included,
# which the smaller buckets' graphs share), and GRAPH_POOL_ROUNDING more
# for the allocator's segments.
GRAPH_POOL_ROUNDING = 64 << 20


def graph_memory_gate(phase, graphed, eager):
    """``graphed``'s ``graph_pool_bytes`` within the bound above, reckoned
    from ``eager``'s ``run_peak_bytes``; prints both."""
    pools = (1 + graphed["decode_graph"] + 2 * graphed["spec_graph"])
    bound = pools * (eager["run_peak_bytes"] + GRAPH_POOL_ROUNDING)
    held = graphed["graph_pool_bytes"]
    say({"phase": f"{phase}_graph_memory", "graph_pool_bytes": held,
         "eager_run_peak_bytes": eager["run_peak_bytes"],
         "graphed_run_peak_bytes": graphed["run_peak_bytes"],
         "pools": pools, "bound": bound, "share_of_bound": held / bound})
    assert 0 < held <= bound, (phase, held, bound)


def net_launches(stats, launches):
    """A graphed run's launches less its graphs' throwaway warm-up steps
    (the decode step's, the spec pair's)."""
    warm = stats["graph_warm_launches"]
    return {w: n - warm.get(w, 0) for w, n in launches.items()}


def serve_phase(wrappers):
    """The paged, spec="off" serve path of the dense model, its decode step
    a replayed CUDA graph: the flash, paged decode and RMSNorm kernels are
    launched."""
    stats, launches = serve_run("serve", wrappers)
    assert stats["step_graph"], "serve ran the eager step"
    for w in ("paged_decode_attention", "flash_attention", "rmsnorm_fused"):
        assert launches[w] > 0, launches
    return stats, launches


def serve_eager_phase(wrappers, graphed, graphed_launches):
    """serve's trace on the eager step: every stream bitwise equal to the
    graphed run's, and the same launches once the graph's warm-up steps
    (run before its capture) are taken off the graphed run's count."""
    stats, launches = serve_run("serve_eager", wrappers, step_graph=False)
    assert not stats["step_graph"]
    differ = [rid for rid, t in graphed["streams"].items()
              if stats["streams"][rid] != t]
    assert not differ, f"eager streams differ from the graph's: {differ}"
    warm = graphed["graph_warm_launches"]
    replayed = {w: n - warm.get(w, 0) for w, n in graphed_launches.items()}
    assert replayed == launches, (replayed, launches)
    graph_memory_gate("serve", graphed, stats)
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "ttft_p99_s", "wall_s", "decode_steps")
    say({"phase": "graph_vs_eager", "arch": DENSE_ARCH,
         "streams_equal": len(graphed["streams"]) - len(differ),
         "of": len(graphed["streams"]), "launches_equal": True,
         "graph": {k: graphed[k] for k in keys},
         "eager": {k: stats[k] for k in keys}})
    return launches


def idle_stream(arch, entry, cfg=None, **kw):
    """The tokens of one trace request admitted into an idle engine built
    as ``serve_direct`` builds it (seed 0, ``SERVE``'s slots and max_len),
    on ``arch``'s config or on ``cfg``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Request
    eng = build_engine(cfg or get_config(arch), SERVE["slots"],
                       SERVE["max_len"], seed=SERVE["seed"], device="cuda",
                       **kw)
    eng.submit(Request(rid=entry["rid"],
                       prompt=np.asarray(entry["prompt"], np.int32),
                       max_new_tokens=int(entry["max_new_tokens"])))
    eng.run()
    return eng.done[entry["rid"]].tokens


def chunked_run(phase, wrappers, arch, load, chunk, launched, unlaunched,
                cfg=None):
    """A chunked-admission serve run, graphed decode, prefix sharing off:
    the gates of every run, exactly the chunks the trace's buckets need,
    the kernels in ``launched`` launched and those in ``unlaunched`` (the
    one-shot admission's) not, and the last request, admitted while the
    others decode, bitwise equal to its run in an idle chunked engine.
    ``cfg`` (default ``arch``'s) is the model served."""
    from repro_torch.serving.engine import admit_length
    kw = dict(prefill="chunked", prefill_chunk=chunk, prefix_sharing=False)
    stats, launches = serve_run(phase, wrappers, arch=arch, load=load,
                                cfg=cfg, trace=serve_trace(arch, load), **kw)
    assert stats["step_graph"] and stats["prefill"] == "chunked"
    trace = serve_trace(arch, load)
    want = sum(-(-admit_length(len(e["prompt"]), load["max_len"]) // chunk)
               for e in trace)
    assert stats["prefill_chunks"] == want, (stats["prefill_chunks"], want)
    for w in launched:
        assert launches[w] > 0, launches
    for w in unlaunched:
        assert launches[w] == 0, launches
    last = trace[-1]
    alone = idle_stream(arch, last, cfg=cfg, **kw)
    assert alone == stats["streams"][last["rid"]], (alone, last["rid"])
    say({"phase": f"{phase}_isolation", "arch": arch, "rid": last["rid"],
         "prompt_len": len(last["prompt"]), "tokens": len(alone),
         "bitwise_equal_idle_engine": True,
         "prefill_chunks": stats["prefill_chunks"], "expected": want})
    return stats, launches


def chunked_serve_phase(wrappers, oneshot):
    """serve's trace admitted in 128-token chunks; TTFT and ITL beside the
    one-shot (graphed) run's."""
    stats, launches = chunked_run(
        "chunked_serve", wrappers, DENSE_ARCH, SERVE, CHUNK,
        ("paged_decode_attention", "rmsnorm_fused"), ("flash_attention",))
    keys = ("tok_per_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
            "itl_p99_s", "wall_s", "decode_steps")
    say({"phase": "chunked_vs_oneshot", "arch": DENSE_ARCH, "chunk": CHUNK,
         "chunked": {k: stats[k] for k in keys},
         "oneshot": {k: oneshot[k] for k in keys}})
    return launches


def chunked_logits_phase(dev, arch=DENSE_ARCH, phase="chunked_logits"):
    """Full ``arch`` (smollm-360m) on the kernels: ``prefill_chunk``
    chained over 128-token chunks into a fresh paged state against the
    one-shot ``prefill``, last-position logits, prompts at buckets 64, 512,
    1023."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model, init_decode_state
    from repro_torch.serving.engine import admit_length
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                              norm_impl="pallas")
    bundle = build_model(cfg)
    params = bundle.init(0, device=dev)
    max_len = 1024
    rng = np.random.default_rng(2)
    chunked, oneshot, buckets = [], [], []
    for n in (50, 300, 700):
        plen = admit_length(n, max_len)
        padded = np.zeros((1, plen), np.int32)
        padded[0, -n:] = rng.integers(0, cfg.vocab_size, size=n)
        toks = torch.from_numpy(padded).to(dev)
        logits, _ = bundle.prefill(params, {"tokens": toks})
        oneshot.append(logits[:, -1])
        state = init_decode_state(cfg, 1, max_len, device=dev)
        row = torch.arange(1, max_len // 16 + 1, dtype=torch.int32,
                           device=dev)
        off = 0
        while off < plen:
            C = min(CHUNK - off % CHUNK, plen - off)
            logits, _ = bundle.prefill_chunk(params, state,
                                             toks[:, off:off + C], row, 0, off)
            off += C
        chunked.append(logits)
        buckets.append(plen)
        g = graphed_chunks(bundle, params, cfg, toks, row, plen, max_len, dev)
        assert torch.equal(g, logits), f"{phase}: graphed chunks != eager"
    got, want = torch.cat(chunked).float(), torch.cat(oneshot).float()
    del params, state
    torch.cuda.empty_cache()
    err = check_close(phase, got, want, LOGIT_TOL)
    say({"phase": phase, "arch": cfg.name, "buckets": buckets,
         "chunk": CHUNK, "max_abs_err": err, "tol": LOGIT_TOL,
         "graphed_bitwise_eager": len(buckets),
         "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()),
         "max_abs_logit": float(want.abs().max())})


def graphed_chunks(bundle, params, cfg, toks, row, plen, max_len, dev):
    """The chunk chain of ``toks`` (1, plen) into a fresh one-row paged
    state through CUDA graphs, one per chunk length (the engine's
    `CallGraph`s: tokens, table row, slot and offset copied into static
    buffers, the last two 0-d int32 on the card), each captured at offset
    0 before the chain (its warm-up writes the prompt's own first rows,
    which the chain's first chunk writes again) and replayed for every
    chunk.  Returns the last chunk's logits."""
    from repro_torch.models.api import init_decode_state
    from repro_torch.serving.graph import CallGraph
    state = init_decode_state(cfg, 1, max_len, device=dev)
    sizes, off = [], 0
    while off < plen:
        sizes.append(min(CHUNK - off % CHUNK, plen - off))
        off += sizes[-1]

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    def chunk(t, r, s, o):
        return bundle.prefill_chunk(params, state, t, r, s, o)[0]
    graphs = {C: CallGraph.first_call(chunk, (toks[:, :C], row, i32(0),
                                              i32(0)), dev)[0]
              for C in sorted(set(sizes))}
    off = 0
    for C in sizes:
        logits = graphs[C](toks[:, off:off + C], row, i32(0), i32(off))
        off += C
    out = logits.clone()
    del graphs, state
    return out


def mamba_serve_phase(wrappers):
    """The serve path of the Mamba-2 model, on the dense layout: every
    admission runs the SSD-scan kernel once per layer, every step the
    RMSNorm kernel; no attention kernel runs.  Returns its stats and
    launches."""
    from repro_torch.configs.base import get_config
    stats, launches = serve_run("mamba_serve", wrappers, arch=SSM_ARCH)
    assert stats["kv"] == "dense" and stats["spec"] == "off", stats["kv"]
    assert stats["step_graph"], "mamba_serve ran the eager step"
    layers = get_config(SSM_ARCH).num_layers
    assert launches["ssd_scan"] == layers * SERVE["n_requests"], launches
    assert launches["rmsnorm_fused"] > 0, launches
    for w in ("flash_attention", "paged_decode_attention", "decode_attention"):
        assert launches[w] == 0, launches
    return stats, launches


def allocated_bytes():
    """``torch.cuda.memory_allocated()`` once garbage is collected and
    cuBLAS's per-(handle, stream) workspaces are released: the tensors
    that are still alive.  A thread's first GEMM on a stream allocates a
    workspace that outlives the thread; it is no payload's state."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def pilot_run(wrappers, archs, direct):
    """Two full-width serve images, ``archs``, late-bound in turn by one
    pilot on the card (`serve_via_pilots`; the second prefetched while the
    first serves), each answering serve's trace: the gates of every pilot
    run (both exit 0, full token counts, one device->host copy a step, no
    leaked block, the captured step, streams bitwise their direct run's
    ``direct`` {arch: {rid: tokens}}, the second bind a prefetched cache
    hit, memory back within ``PILOT_MEMORY_SLACK``).  Returns the run,
    its wall seconds, each payload engine's launches by arch, the report
    rows, the prefetch warm-up's launches and the memory readings."""
    from repro_torch.core.images import PayloadImage
    from repro_torch.launch.serve import (
        KERNEL_FLAGS, expected_tokens, serve_via_pilots)
    traces = [serve_trace(a) for a in archs]
    shape = f"custom:{SERVE['max_len']}x{SERVE['slots']}"
    mem_before = allocated_bytes()
    raw_before = torch.cuda.memory_allocated()
    for w in wrappers:
        w.launches = 0
    t0 = time.monotonic()
    out = serve_via_pilots(archs, slots=SERVE["slots"],
                           max_len=SERVE["max_len"], n_steps=100_000,
                           device="cuda", traces=traces)
    wall = time.monotonic() - t0
    sim, pilot = out["sim"], out["pilot"]
    # the prefetch is done once its event is set (a cached image's is)
    img2 = PayloadImage(archs[1], shape, "serve", smoke=False,
                        flags=KERNEL_FLAGS)
    assert sim.registry.prefetch(img2, "cuda").wait(300.0)
    torch.cuda.synchronize()
    total = {w.__name__: w.launches for w in wrappers}
    raw_after = torch.cuda.memory_allocated()
    mem_after = allocated_bytes()
    launches, report = {}, []
    for arch, trace, p in zip(archs, traces, out["payloads"]):
        assert p["exitcode"] == 0, (arch, p["exitcode"], p["error"])
        sv, eng = p["serve"], p["engine"]
        n = {w.__name__: eng["launches"].get(w.__name__, 0)
             for w in wrappers}
        launches[arch] = n
        got = {int(rid): t for rid, t in p["tokens"].items()}
        want = {e["rid"]: expected_tokens(e, SERVE["max_len"])
                for e in trace}
        assert sv["completed"] == len(trace), (arch, sv["completed"])
        assert {rid: len(t) for rid, t in got.items()} == want, arch
        assert sv["d2h_transfers"] == sv["decode_steps"] > 0, arch
        assert eng["block_leaks"] == 0, (arch, eng["block_leaks"])
        assert eng["step_graph"], f"{arch}: the payload ran the eager step"
        differ = [rid for rid, t in direct[arch].items() if got[rid] != t]
        assert not differ, f"{arch}: streams differ from direct: {differ}"
        report.append({
            "arch": arch, "exitcode": p["exitcode"],
            "bind_seconds": p["bind_seconds"],
            "bind_cached": p["bind_cached"], "tok_per_s": sv["tok_per_s"],
            "ttft_p50_s": sv["ttft_p50_s"], "itl_p99_s": eng["itl_p99_s"],
            "itl_max_s": eng["itl_max_s"],
            "decode_steps": sv["decode_steps"],
            "streams_equal_direct": len(direct[arch]), "launches": n})
    warm = {w: total[w] - sum(n[w] for n in launches.values())
            for w in total}
    for w in ("flash_attention", "paged_decode_attention", "rmsnorm_fused"):
        assert launches[archs[0]][w] > 0, launches[archs[0]]
    assert pilot.history[1]["bind_cached"] is True, pilot.history[1]
    assert out["registry"]["prefetches"] == 1, out["registry"]
    assert pilot.history[0].get("prefetch_started") is True
    assert min(warm.values()) >= 0, warm
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    memory = {"before": mem_before, "after": mem_after,
              "raw_before": raw_before, "raw_after": raw_after,
              "slack": PILOT_MEMORY_SLACK}
    return out, wall, launches, report, warm, memory


def pilot_report(phase, out, wall, report, warm, memory, **extra):
    pilot = out["pilot"]
    say({"phase": phase, "wall_s": wall, "payloads": report,
         "history": [{k: h.get(k) for k in ("task_id", "exitcode",
                                            "bind_seconds", "bind_cached",
                                            "prefetch_started")}
                     for h in pilot.history],
         "registry": out["registry"], "repo": out["repo"],
         "prefetch_warm_launches": warm, "memory_allocated": memory,
         **extra})


def pilot_serve_phase(wrappers, direct):
    """smollm-360m, then mamba2-370m, late-bound in turn by one pilot on
    the card (`pilot_run`): the SSD scan 48 times per admission on the
    second; then a bare executor's pull and rebind of each image.  Returns
    each payload engine's launches by arch."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.arena import SharedArena
    from repro_torch.core.images import ExecutableRegistry, PayloadImage
    from repro_torch.core.latebind import PayloadExecutor, PodPatchCapability
    from repro_torch.core.proctable import ProcessTable
    from repro_torch.launch.serve import KERNEL_FLAGS
    archs = [DENSE_ARCH, SSM_ARCH]
    shape = f"custom:{SERVE['max_len']}x{SERVE['slots']}"
    out, wall, launches, report, warm, memory = pilot_run(wrappers, archs,
                                                          direct)
    p2 = launches[SSM_ARCH]
    layers = get_config(SSM_ARCH).num_layers
    assert p2["ssd_scan"] == layers * SERVE["n_requests"], p2
    assert p2["flash_attention"] == p2["paged_decode_attention"] == 0, p2

    # a bare executor, for each image: the pull no prefetch staged, its
    # warm-up (what a prefetch runs under the device lock), and a warm
    # rebind (a cache hit)
    ex = PayloadExecutor("pod-bare", SharedArena(), ProcessTable(),
                         ExecutableRegistry(), device="cuda")
    cap = PodPatchCapability("pod-bare")
    bare = {}
    for arch in archs:
        img = PayloadImage(arch, shape, "serve", smoke=False,
                           flags=KERNEL_FLAGS)
        exe = ex.patch_image(cap, img)
        cold = (ex.last_bind_seconds, ex.last_bind_cached)
        t1 = time.monotonic()
        exe.warm()
        warm_s = time.monotonic() - t1
        ex.patch_image(cap, img)
        assert not cold[1] and ex.last_bind_cached, (arch, cold)
        bare[arch] = {"cold_pull_s": cold[0], "warm_s": warm_s,
                      "rebind_s": ex.last_bind_seconds}
    ex.close()
    ex.arena.destroy()
    pilot_report("pilot_serve", out, wall, report, warm, memory,
                 bare_executor=bare)
    return launches


# --------------------------------------------------------------------------
# disaggregated serve
# --------------------------------------------------------------------------

def disagg_run(phase, wrappers, direct, arch, n_pilots, trace, expect,
               **kw):
    """One ``serve_disagg`` run of ``trace`` on full-width ``arch``, 8
    slots a server, ``n_pilots`` pilots in each role, with every launch
    count set to 0 just before it and read just after; the gates every
    disaggregated run passes (drained, each rid once in each pool, tokens
    bitwise ``direct``'s, the graceful servers' gates: exit 0, their
    role, no leaked block, the prefill servers with no decode step, the
    decode servers graphed with one device->host copy a step, and each
    server's own launches as ``expect`` {role: (launched, unlaunched)}
    says; memory back within the slack).  Returns the run and its
    launches."""
    from repro_torch.launch.serve import serve_disagg
    mem_before = allocated_bytes()
    _zero(wrappers)
    out = serve_disagg(arch, len(trace), prefill_pilots=n_pilots,
                       decode_pilots=n_pilots, slots=SERVE["slots"],
                       max_len=SERVE["max_len"], lease_ttl=FLEET_TTL,
                       trace=trace, device="cuda", **kw)
    torch.cuda.synchronize()
    launches = _launches(wrappers)
    mem_after = allocated_bytes()
    rows = {}
    for role, servers in out["servers"].items():
        rows[role] = []
        for s in servers:
            sv, eng = s["serve"], s["engine"]
            if not sv.get("fleet"):
                continue                       # killed: reports nothing
            assert s["exitcode"] == 0, (role, s["exitcode"], s["error"])
            assert sv["role"] == role, (role, sv["role"])
            assert sv["fleet"]["leaked_blocks"] == 0 == eng["block_leaks"]
            n = {w.__name__: eng["launches"].get(w.__name__, 0)
                 for w in wrappers}
            # a prefill server's admissions are graphs (no decode step);
            # a decode server's step is (no prefill)
            assert eng["step_graph"], f"{phase}: eager {role} server"
            if role == "prefill":
                assert sv["decode_steps"] == 0 and not eng["decode_graph"]
                assert eng["prefill_graph"], eng
                assert sv["prefills_exported"] == sv["fleet"]["completed_here"]
            else:
                assert eng["decode_graph"] and not eng["prefill_graph"], eng
                assert sv["d2h_transfers"] == sv["decode_steps"] > 0, sv
            launched, unlaunched = expect[role]
            assert all(n[w] > 0 for w in launched), (phase, role, n)
            assert all(n[w] == 0 for w in unlaunched), (phase, role, n)
            rows[role].append({
                "server": sv["fleet"]["server_id"],
                "fetched": sv["fleet"]["fetched"],
                "completed_here": sv["fleet"]["completed_here"],
                "prefills_exported": sv["prefills_exported"],
                "handoffs_imported": sv["handoffs_imported"],
                "decode_steps": sv["decode_steps"],
                "tok_per_s": sv["tok_per_s"],
                "itl_p99_s": eng["itl_p99_s"], "itl_max_s": eng["itl_max_s"],
                "launches": n})
        assert rows[role], (phase, role, out["servers"][role])
    keys = ("drained", "wall_s", "goodput_tok_per_s", "ttft_p50_s",
            "ttft_p99_s", "resume_p50_s", "resume_p99_s", "failed_pilots",
            "pilot_seconds", "leaked_blocks", "prefills_exported",
            "handoffs_imported", "handoff_bytes_mean", "handoff_bytes_max",
            "export_ms_p50", "export_ms_max", "import_ms_p50",
            "import_ms_max", "stats")
    say({"phase": phase, "arch": arch, "pilots_per_role": n_pilots,
         "requests": len(trace), "lease_ttl": FLEET_TTL,
         **{k: out[k] for k in keys}, "servers": rows, "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    n = len(trace)
    assert out["drained"], f"{phase}: not drained"
    assert sorted(out["results"]) == sorted(e["rid"] for e in trace)
    for role in ("prefill", "decode"):
        assert out["stats"][role]["completed"] == n, out["stats"][role]
        assert out["stats"][role]["duplicates"] == 0, out["stats"][role]
    assert out["leaked_blocks"] == 0
    _same_streams(phase, out["results"],
                  {e["rid"]: direct[e["rid"]] for e in trace})
    for w in expect["prefill"][0] + expect["decode"][0]:
        assert launches[w] > 0, (phase, launches)
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        phase, mem_before, mem_after)
    return out, launches


# each role's server launches the first and never the second
DISAGG_SMOLLM = {"prefill": (("flash_attention", "rmsnorm_fused"),
                             ("paged_decode_attention",)),
                 "decode": (("paged_decode_attention", "rmsnorm_fused"),
                            ("flash_attention",))}


def disagg_serve_phase(wrappers, direct):
    """1 prefill + 1 decode pilot on full-width smollm-360m answer serve's
    trace: every prompt exported once and imported once."""
    out, launches = disagg_run("disagg_serve", wrappers, direct, DENSE_ARCH,
                               1, serve_trace(DENSE_ARCH), DISAGG_SMOLLM)
    n = SERVE["n_requests"]
    assert out["prefills_exported"] == out["handoffs_imported"] == n, out
    assert not any(out["failed_pilots"].values()), out["failed_pilots"]
    return launches


def disagg_requeue_phase(wrappers, direct):
    """2 + 2 pilots, one of each stage killed: prompts of the dead prefill
    pilot replay from the prompt, streams of the dead decode pilot from
    their handoff; the prefill pool sees each rid once (no re-prefill of
    a decode replay), the decode pool replays at least one."""
    out, launches = disagg_run(
        "disagg_requeue", wrappers, direct, DENSE_ARCH, 2,
        serve_trace(DENSE_ARCH), DISAGG_SMOLLM,
        fail_prefill_at=DISAGG_FAIL_PREFILL_AT,
        fail_decode_at=DISAGG_FAIL_DECODE_AT)
    for role in ("prefill", "decode"):
        assert len(out["failed_pilots"][role]) == 1, out["failed_pilots"]
    assert out["stats"]["prefill"]["requests"] == SERVE["n_requests"]
    assert out["stats"]["decode"]["replays"] >= 1, out["stats"]["decode"]
    return launches


def disagg_mla_phase(wrappers, mla_streams):
    """1 + 1 pilots on full-width minicpm3-4b over the trace's first
    ``DISAGG_MLA_REQUESTS``: flash once a layer per admission on the
    prefill server, RMSNorm on both, no attention kernel on the decode
    server (MLA decode is plain); streams bitwise mla_serve's."""
    from repro_torch.configs.base import get_config
    trace = serve_trace(MLA_ARCH)[:DISAGG_MLA_REQUESTS]
    expect = {"prefill": (("flash_attention",), MLA_UNLAUNCHED),
              "decode": (("rmsnorm_fused",),
                         ("flash_attention",) + MLA_UNLAUNCHED)}
    out, launches = disagg_run("disagg_mla", wrappers, mla_streams, MLA_ARCH,
                               1, trace, expect)
    layers = get_config(MLA_ARCH).num_layers
    (pf,) = out["servers"]["prefill"]
    flash = pf["engine"]["launches"].get("flash_attention", 0)
    assert flash == layers * DISAGG_MLA_REQUESTS, flash
    for w in MLA_UNLAUNCHED:
        assert launches[w] == 0, ("disagg_mla", launches)
    assert out["prefills_exported"] == out["handoffs_imported"] == len(trace)
    torch.cuda.empty_cache()
    return launches


def serve_wave_phase(wrappers, serve):
    """serve's trace direct with wave admission: streams bitwise serve's;
    tokens/s beside serve's."""
    stats, launches = serve_run("serve_wave", wrappers, admission="wave")
    _same_streams("serve_wave", stats["streams"], serve["streams"])
    keys = ("tok_per_s", "ttft_p50_s", "ttft_p99_s", "wall_s",
            "decode_steps", "slot_utilization")
    say({"phase": "wave_vs_continuous", "arch": DENSE_ARCH,
         "streams_equal": len(serve["streams"]),
         "wave": {k: stats[k] for k in keys},
         "continuous": {k: serve[k] for k in keys}})
    return launches


# --------------------------------------------------------------------------
# fleet serve
# --------------------------------------------------------------------------

def fleet_servers(out):
    """Each server that ended gracefully (a killed one reports nothing):
    exit 0, one device->host copy a step, the captured step (or the eager
    spec pair), no leaked block.  Returns their report rows."""
    rows = []
    for s in out["servers"]:
        sv, eng = s["serve"], s["engine"]
        if not sv.get("fleet"):
            continue
        assert s["exitcode"] == 0, (s["exitcode"], s["error"])
        assert sv["d2h_transfers"] == sv["decode_steps"], sv
        assert sv["fleet"]["leaked_blocks"] == 0 == eng["block_leaks"], sv
        # every function the reference compiles is a graph: the decode
        # step or the spec pair, and each admission bucket (warm_admission
        # captured them all before the first lease)
        assert eng["step_graph"] and eng["prefill_graph"], eng
        assert eng["spec_graph"] == (sv["spec"] == "draft") \
            != eng["decode_graph"], eng
        rows.append({"server": sv["fleet"]["server_id"],
                     "fetched": sv["fleet"]["fetched"],
                     "completed_here": sv["fleet"]["completed_here"],
                     "decode_steps": sv["decode_steps"],
                     "tok_per_s": sv["tok_per_s"],
                     "itl_p50_s": eng["itl_p50_s"],
                     "itl_p99_s": eng["itl_p99_s"],
                     "itl_max_s": eng["itl_max_s"],
                     "acceptance_rate": sv["acceptance_rate"],
                     "prefix_hit_rate": sv["prefix_hit_rate"],
                     "graph_pool_bytes": eng["graph_pool_bytes"],
                     "launches": eng["launches"]})
    assert rows, out["servers"]
    return rows


def fleet_run(phase, wrappers, direct, n_pilots, **kw):
    """One ``serve_fleet`` run of serve's trace on full-width smollm-360m,
    8 slots a server, the kernel flags, with every launch count set to 0
    just before it and read just after: the gates every fleet run passes
    (drained, each rid completed once, tokens bitwise the direct serve
    phase's ``direct``, every kernel of the path launched, the graceful
    servers' gates, memory back within ``PILOT_MEMORY_SLACK``).  Returns
    the run and its launches."""
    from repro_torch.launch.serve import serve_fleet
    mem_before = allocated_bytes()
    _zero(wrappers)
    out = serve_fleet(DENSE_ARCH, SERVE["n_requests"], n_pilots,
                      slots=SERVE["slots"], max_len=SERVE["max_len"],
                      lease_ttl=FLEET_TTL,
                      trace=serve_trace(DENSE_ARCH, SERVE), device="cuda",
                      **kw)
    torch.cuda.synchronize()
    launches = _launches(wrappers)
    mem_after = allocated_bytes()
    rows = fleet_servers(out)
    keys = ("drained", "wall_s", "goodput_tok_per_s", "ttft_p50_s",
            "ttft_p99_s", "completed", "failed", "replays", "duplicates",
            "lost_leases", "distinct_servers", "failed_pilots",
            "pilot_seconds", "spec_servers", "acceptance_rate",
            "tokens_per_step", "leaked_blocks")
    say({"phase": phase, "arch": DENSE_ARCH, "pilots": n_pilots,
         "lease_ttl": FLEET_TTL, **{k: out[k] for k in keys},
         "servers": rows,
         "itl_max_s_of_ttl": max(r["itl_max_s"] or 0 for r in rows)
         / FLEET_TTL,
         "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    n = SERVE["n_requests"]
    assert out["drained"] and out["completed"] == n, out["completed"]
    assert sorted(out["results"]) == list(range(n)), sorted(out["results"])
    assert out["lost_leases"] == 0, f"{phase}: a live server lost leases"
    differ = [rid for rid, t in direct.items() if out["results"][rid] != t]
    assert not differ, f"{phase}: streams differ from serve's: {differ}"
    for w in ("flash_attention", "paged_decode_attention", "rmsnorm_fused"):
        assert launches[w] > 0, (phase, launches)
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        phase, mem_before, mem_after)
    return out, launches


def fleet_serve_phase(wrappers, direct):
    """3 pilots on the card lease serve's 16 requests from one pool, no
    failure: nothing replayed, nothing duplicated, each stream bitwise
    the direct run's, every server on its captured step."""
    out, launches = fleet_run("fleet_serve", wrappers, direct, FLEET_PILOTS)
    assert out["replays"] == 0 and out["duplicates"] == 0, out["replays"]
    assert len(out["servers"]) == FLEET_PILOTS, out["servers"]
    return out, launches


def fleet_requeue_phase(wrappers, direct, plain):
    """fleet_serve with the pilot holding the most leases killed once 4
    requests have settled: its requests come back to the pool and replay
    on the survivors, bitwise fleet_serve's and the direct run's."""
    out, launches = fleet_run("fleet_requeue", wrappers, direct,
                              FLEET_PILOTS, fail_at=FLEET_FAIL_AT)
    assert len(out["failed_pilots"]) == 1, out["failed_pilots"]
    assert out["replays"] >= 1, out["replays"]
    assert out["results"] == plain["results"]
    return launches


def fleet_spec_phase(wrappers, direct, eager_acceptance):
    """2 self-drafting pilots, their spec pairs graphed, one killed: the
    survivor replays the dead server's requests; every stream is the
    direct (spec-off) run's, which the eager spec run's equal, the verify
    kernel is launched and self-draft acceptance is above 0.5 (printed
    beside the eager ``spec_self_eager``'s: the replays draft again, so
    the two need not be equal)."""
    out, launches = fleet_run("fleet_spec", wrappers, direct, 2,
                              draft="self", fail_at=FLEET_FAIL_AT)
    say({"phase": "fleet_spec_acceptance",
         "fleet": out["acceptance_rate"],
         "spec_self_eager": eager_acceptance, "replays": out["replays"]})
    assert len(out["failed_pilots"]) == 1, out["failed_pilots"]
    assert out["replays"] >= 1, out["replays"]
    assert out["spec_servers"] >= 1, out["servers"]
    assert out["acceptance_rate"] > 0.5, out["acceptance_rate"]
    assert launches["paged_verify_attention"] > 0, launches
    return launches


def fleet_autoscale_phase(wrappers, direct):
    """``serve_fleet_schedule`` under the autoscaler (scale-to-zero
    allowed, at most 3 pilots, from 1) on a bursty schedule of 24
    requests of serve's shape: drained, every request completed once with
    its expected tokens (the first 16, serve's own, bitwise the direct
    run's), no flap, scaled to zero, memory back within the slack."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.autoscaler import AutoscalePolicy
    from repro_torch.launch.serve import (
        expected_tokens, make_bursty_schedule, make_trace,
        serve_fleet_schedule)
    a = AUTOSCALE
    trace = make_trace(get_config(DENSE_ARCH).vocab_size, a["n_requests"],
                       max_len=SERVE["max_len"], seed=SERVE["seed"],
                       prompt_len=SERVE["prompt_len"],
                       max_new_tokens=SERVE["max_new_tokens"])
    schedule = make_bursty_schedule(trace, bursts=a["bursts"],
                                    burst_s=a["burst_s"], gap_s=a["gap_s"])
    policy = AutoscalePolicy(min_pilots=0, max_pilots=a["max_pilots"],
                             slots_per_pilot=SERVE["slots"])
    mem_before = allocated_bytes()
    _zero(wrappers)
    out = serve_fleet_schedule(DENSE_ARCH, schedule, slots=SERVE["slots"],
                               max_len=SERVE["max_len"], policy=policy,
                               initial_pilots=a["initial_pilots"],
                               lease_ttl=FLEET_TTL, device="cuda")
    torch.cuda.synchronize()
    launches = _launches(wrappers)
    mem_after = allocated_bytes()
    t0 = out["t_start"]
    say({"phase": "fleet_autoscale", "arch": DENSE_ARCH, **a,
         "lease_ttl": FLEET_TTL,
         "arrivals_s": [round(t, 3) for t, _ in schedule],
         "policy": dataclasses.asdict(policy),
         **{k: out[k] for k in ("drained", "wall_s", "scaled_to_zero",
                                "scale_to_zero_s", "ttft_p50_s",
                                "ttft_p99_s", "pilot_seconds", "completed",
                                "failed", "replays", "duplicates",
                                "lost_leases", "distinct_servers",
                                "autoscale")},
         "decisions": [{**d, "t": d["t"] - t0} for d in out["decisions"]],
         "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    n = a["n_requests"]
    assert out["drained"] and out["completed"] == n, out["completed"]
    assert out["failed"] == 0 and out["duplicates"] == 0, out
    assert out["lost_leases"] == 0, "a live server lost leases"
    assert sorted(out["results"]) == list(range(n))
    assert {rid: len(t) for rid, t in out["results"].items()} == \
        {e["rid"]: expected_tokens(e, SERVE["max_len"]) for e in trace}
    differ = [rid for rid, t in direct.items() if out["results"][rid] != t]
    assert not differ, f"fleet_autoscale: streams differ: {differ}"
    assert out["autoscale"]["flaps"] == 0, out["autoscale"]
    assert out["scaled_to_zero"], out["autoscale"]
    for w in ("flash_attention", "paged_decode_attention", "rmsnorm_fused"):
        assert launches[w] > 0, launches
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    return launches


def fleet_join_phase(wrappers, direct):
    """A pilot joins a fleet whose one server is serving: the join the
    autoscaler makes (prefetch, ``scale_up``, ``submit_servers``), mid-way
    through a 64-request trace of serve's shape.  The joiner's weights,
    engine, graph capture and warm-ups hold the device lock while the live
    server ticks between them.  Gates: the live server held leases when
    the join began and renewed them after the joiner announced, with work
    still queued; 2 pilots live, both served; nothing replayed, no lease
    lost; each stream as expected (serve's 16 bitwise serve's); the
    graceful servers' gates; memory back within the slack.  Reported: the
    join's length, the live server's renewals in it and its longest gap
    between renewals across it, against the TTL."""
    from repro_torch.core.cluster import ClusterSim
    from repro_torch.core.pilot import PilotConfig
    from repro_torch.launch.profile_fleet import _LeaseGaps
    from repro_torch.launch.serve import (
        _fleet_image, _server_rows, expected_tokens)
    from repro_torch.serving.dispatch import FleetDispatcher
    load = dict(SERVE, n_requests=JOIN_REQUESTS)
    n = load["n_requests"]
    trace = serve_trace(DENSE_ARCH, load)
    img = _fleet_image(DENSE_ARCH, SERVE["max_len"], SERVE["slots"], False)
    spec = {"slots": SERVE["slots"], "max_len": SERVE["max_len"]}
    mem_before = allocated_bytes()
    _zero(wrappers)
    with _LeaseGaps() as gaps:
        sim = ClusterSim(device="cuda")
        pool = FleetDispatcher(lease_ttl=FLEET_TTL)
        fleet = sim.spawn_fleet(1, PilotConfig(max_payloads=2,
                                               idle_grace=0.3))
        try:
            tids = fleet.submit_servers(img, pool.name, n=1, spec=spec)
            assert pool.wait_servers(1, timeout=300.0), "no live server"
            (live,) = pool.servers
            t0 = time.monotonic()
            pool.submit_trace(trace)
            pool.seal()
            assert pool.wait_completed(1, timeout=300.0)
            held = len(pool.lease_holders().get(live, ()))
            t_up = time.monotonic()
            sim.registry.prefetch(img, fleet.mesh)
            fleet.scale_up(1)
            tids += fleet.submit_servers(img, pool.name, n=1, spec=spec)
            pilots = fleet.size()
            assert pool.wait_servers(2, timeout=120.0), "no joiner"
            (joiner,) = pool.servers - {live}
            open_at_join = n - pool.stats()["completed"]
            ok = pool.wait_all(timeout=600.0)
            wall = time.monotonic() - t0
        finally:
            pool.close()
            fleet.drain_all()
            fleet.join_all(30.0)
            fleet.reap()
    torch.cuda.synchronize()
    launches = _launches(wrappers)
    mem_after = allocated_bytes()
    t_ann = gaps.announced[joiner]
    renews = gaps.renew_times.get(live, [])
    across = [b - a for a, b in zip(renews, renews[1:])
              if b > t_up and a < t_ann]
    stats = pool.stats()
    out = {"servers": _server_rows(sim, tids), "results": pool.results()}
    rows = fleet_servers(out)
    say({"phase": "fleet_join", "arch": DENSE_ARCH, "requests": n,
         "lease_ttl": FLEET_TTL, "drained": ok, "wall_s": wall,
         "pilots_live": pilots, "live_leases_at_join": held,
         "join_s": t_ann - t_up, "open_at_join": open_at_join,
         "live_renewals_in_join": sum(t_up <= t <= t_ann for t in renews),
         "live_renew_gap_max_s": max(across, default=None),
         "live_lease_gaps": gaps.by_server.get(live),
         **{k: stats[k] for k in ("completed", "failed", "replays",
                                  "duplicates", "lost_leases",
                                  "distinct_servers")},
         "servers": rows, "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    assert ok and stats["completed"] == n, stats
    assert sorted(out["results"]) == list(range(n))
    assert stats["replays"] == 0 == stats["duplicates"], stats
    assert stats["lost_leases"] == 0, "the live server lost leases"
    assert pilots == 2 and stats["distinct_servers"] == 2, stats
    # the join overlapped serving: the live server held leases when it
    # began and renewed them after the joiner announced, with work queued
    assert held > 0 and open_at_join > 0, (held, open_at_join)
    assert renews and renews[-1] > t_ann, "no renewal after the join"
    assert {rid: len(t) for rid, t in out["results"].items()} == \
        {e["rid"]: expected_tokens(e, SERVE["max_len"]) for e in trace}
    differ = [rid for rid, t in direct.items() if out["results"][rid] != t]
    assert not differ, f"fleet_join: streams differ from serve's: {differ}"
    for w in ("flash_attention", "paged_decode_attention", "rmsnorm_fused"):
        assert launches[w] > 0, launches
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    return launches


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _launches(wrappers):
    return {w.__name__: w.launches for w in wrappers}


def _zero(wrappers):
    for w in wrappers:
        w.launches = 0


def train_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one train step (PaLM's count: 6 per parameter per
    token for the products forward and backward, plus 12·L·H·Dh·S per token
    for the attention scores and values; remat's recompute not counted)."""
    tokens = batch * seq
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq * tokens
    return 6 * n_params * tokens + attn


def train_run(phase, wrappers, arch, load, step_graph):
    """``train_direct`` of full-width ``arch`` at ``load`` on the card,
    graphed or eager; every launch count set to 0 just before it.  Gates:
    ``step_graph`` as asked, every loss finite, no kernel launched.
    Returns the printed record and the launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import train_direct
    cfg = get_config(arch)
    _zero(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = train_direct(cfg, load["steps"], load["batch"], load["seq"],
                       device="cuda", step_graph=step_graph)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launches(wrappers)
    losses = out["losses"]
    step_s = float(np.median(out["step_seconds"][1:]))
    flops = train_flops(cfg, out["n_params"], load["batch"], load["seq"])
    rec = {"phase": phase, "arch": cfg.name, **load,
           "step_graph": out["step_graph"], "wall_s": wall,
           "capture_s": out["capture_s"], "ms_per_step": step_s * 1e3,
           "step_ms": [t * 1e3 for t in out["step_seconds"]],
           "tokens_per_s": load["batch"] * load["seq"] / step_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "graph_pool_bytes": out["graph_pool_bytes"],
           # f32 parameters, gradients and the two AdamW moments
           "state_bytes": 4 * 4 * out["n_params"],
           "n_params": out["n_params"], "model_flops_per_step": flops,
           "flops_formula": "6*N*tokens + 12*L*H*Dh*S*tokens",
           "mfu_of_989_tflops": flops / step_s / BF16_FLOPS,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "launches": launches}
    say(rec)
    assert out["step_graph"] is step_graph, out["step_graph"]
    assert np.isfinite(losses).all(), losses
    assert not any(launches.values()), launches
    return rec, launches


def train_twin_gate(phase, graphed, eager):
    """The graphed run against its eager twin: at every step the loss
    within ``RESUME_LOSS_TOL``; the graphed peak at most the twin's +
    (the twin's - the state's bytes) + ``PILOT_MEMORY_SLACK``."""
    diffs = [abs(a - b) for a, b in zip(graphed["losses"], eager["losses"],
                                        strict=True)]
    peak, twin = graphed["max_memory_allocated"], eager["max_memory_allocated"]
    working = twin - graphed["state_bytes"]
    limit = twin + working + PILOT_MEMORY_SLACK
    say({"phase": phase, "arch": graphed["arch"], "tol": RESUME_LOSS_TOL,
         "max_loss_abs_diff": max(diffs), "loss_abs_diff": diffs,
         "bitwise_steps": sum(d == 0 for d in diffs),
         "ms_per_step": [graphed["ms_per_step"], eager["ms_per_step"]],
         "speedup": eager["ms_per_step"] / graphed["ms_per_step"],
         "tokens_per_s": [graphed["tokens_per_s"], eager["tokens_per_s"]],
         "mfu_of_989_tflops": [graphed["mfu_of_989_tflops"],
                               eager["mfu_of_989_tflops"]],
         "capture_s": [graphed["capture_s"], eager["capture_s"]],
         "graph_pool_bytes": graphed["graph_pool_bytes"],
         "memory_gate": {"graphed_peak": peak, "eager_peak": twin,
                         "state_bytes": graphed["state_bytes"],
                         "eager_working_set": working, "limit": limit,
                         "added_share_of_working_set": (peak - twin)
                         / working}})
    assert max(diffs) <= RESUME_LOSS_TOL, diffs
    assert peak <= limit, (peak, limit)


def train_phase(wrappers):
    """``train_direct`` at full width on the card, graphed (``train``)
    and its eager twin (``train_eager``); returns both runs' launches."""
    graphed, launches = train_run("train", wrappers, DENSE_ARCH, TRAIN, True)
    eager, eager_launches = train_run("train_eager", wrappers, DENSE_ARCH,
                                      TRAIN, False)
    for rec in (graphed, eager):
        losses = rec["losses"]
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    train_twin_gate("train_graph_vs_eager", graphed, eager)
    return launches, eager_launches


def _train_leaves(state):
    from repro_torch import tree
    from repro_torch.launch.steps import state_tree
    return [t.detach() for t in tree.leaves(state_tree(state))]


def _spread(xs, ys):
    """Per leaf, the largest absolute difference (f32)."""
    return [float((x.float() - y.float()).abs().max())
            for x, y in zip(xs, ys, strict=True)]


def train_graph_parity_phase(arch):
    """``train_graph_parity`` (phase list) for ``arch`` at full width
    (cut to ``GRAPH_PARITY``'s layers where it names some)."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
    from repro_torch.launch.steps import (
        GRAPH_KEY, init_train_state, load_train_state, make_train_step,
        state_tree)
    from repro_torch.optim.adamw import OptimConfig
    batch, seq, layers = GRAPH_PARITY[arch]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    oc = OptimConfig(total_steps=TRAIN["steps"],
                     warmup_steps=max(TRAIN["steps"] // 20, 5))
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq, batch))
    b0, b1 = (to_device(data.batch_at(i), "cuda") for i in (0, 1))

    def restore(state, snap):
        load_train_state(state, tree.unflatten(state_tree(state), snap))

    def metrics(m):
        return {k: float(v) for k, v in m.items()}
    t0 = time.monotonic()
    state = init_train_state(cfg, 0, "cuda")                   # S
    eager = make_train_step(cfg, oc, step_graph=False)
    eager(state, b0)
    s1 = [t.clone() for t in _train_leaves(state)]             # S1
    _, m = eager(state, b1)
    a = metrics(m)
    first = [t.clone() for t in _train_leaves(state)]
    restore(state, s1)
    _, m = eager(state, b1)
    b = metrics(m)
    spread = _spread(first, _train_leaves(state))
    del state, eager
    state = init_train_state(cfg, 0, "cuda")                   # S again
    graphed = make_train_step(cfg, oc)
    t1 = time.monotonic()
    graphed(state, b0)                      # step 0, then the capture
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t1
    assert GRAPH_KEY in state
    restore(state, s1)                      # in place, after the capture
    _, m = graphed(state, b1)               # the replay
    got = metrics(m)
    err = _spread(first, _train_leaves(state))
    del state, graphed, s1, first
    bad = [i for i, (e, sp) in enumerate(zip(err, spread))
           if e > sp + GRAPH_PARITY_ATOL]
    say({"phase": "train_graph_parity", "arch": cfg.name,
         "layers": cfg.num_layers, "batch": batch, "seq": seq,
         "loss": [got["loss"], a["loss"], b["loss"]],
         "grad_norm": [got["grad_norm"], a["grad_norm"], b["grad_norm"]],
         "eager_loss_bitwise": a["loss"] == b["loss"],
         "replay_loss_bitwise": got["loss"] == a["loss"],
         "leaves": len(err), "max_leaf_err": max(err),
         "max_eager_spread": max(spread),
         "bitwise_leaves": sum(e == 0 for e in err),
         "eager_bitwise_leaves": sum(sp == 0 for sp in spread),
         "leaves_past_spread": bad, "atol": GRAPH_PARITY_ATOL,
         "capture_s": capture_s, "seconds": time.monotonic() - t0})
    if a["loss"] == b["loss"]:
        assert got["loss"] == a["loss"], (got, a)
    else:
        assert abs(got["loss"] - a["loss"]) <= abs(a["loss"] - b["loss"])
    assert abs(got["grad_norm"] - a["grad_norm"]) <= (
        abs(a["grad_norm"] - b["grad_norm"]) + 1e-6 * a["grad_norm"]), (
        got, a, b)
    assert got["lr"] == a["lr"], (got, a)
    assert not bad, [(i, err[i], spread[i]) for i in bad]


def train_parity_phase(arch=DENSE_ARCH, phase="train_parity",
                       wrappers=None):
    """One train step of full-width ``arch`` (smollm-360m) cut to 2 layers
    (an encoder-decoder's encoder too) on the card and on the CPU from the
    same f32 state, held to ``TRAIN_PARITY_TOL``; with ``wrappers``, no
    kernel launched by it.  A VLM's or an audio arch's batch carries the
    frontend's stub embeddings (normal x 0.02, seed 0), which
    ``bundle.loss`` prepends or encodes."""
    from repro_torch import tree
    from repro_torch.bridge import train_state_from_numpy, train_state_to_numpy
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim.adamw import OptimConfig, adamw_update
    from repro_torch.models.api import _has_frontend
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=2,
                              encoder_layers=min(cfg.encoder_layers, 2))
    steps = TRAIN["steps"]
    oc = OptimConfig(total_steps=steps, warmup_steps=max(steps // 20, 5))
    cpu = init_train_state(cfg, 0, "cpu")
    start = train_state_to_numpy(cpu)
    gpu = train_state_from_numpy(start, cfg, "cuda")
    batch = SyntheticLM(SyntheticConfig(cfg.vocab_size, 128, 2)).batch_at(0)
    frontend = None
    if _has_frontend(cfg):
        frontend = torch.from_numpy((np.random.default_rng(0).normal(
            size=(2, cfg.frontend_tokens, cfg.d_model)) * 0.02)
            .astype(np.float32))

    def on(dev):
        b = to_device(batch, dev)
        if frontend is not None:
            b["frontend"] = frontend.to(dev)
        return b
    step = make_train_step(cfg, oc)
    if wrappers is not None:
        _zero(wrappers)
    t0 = time.monotonic()
    _, mg = step(gpu, on("cuda"))
    torch.cuda.synchronize()
    t1 = time.monotonic()
    launches = _launches(wrappers) if wrappers is not None else None
    _, mc = step(cpu, on("cpu"))
    t2 = time.monotonic()
    lr = float(mc["lr"])
    tol = TRAIN_PARITY_TOL
    # the CPU's AdamW on the card's gradients, from the start state
    redo = train_state_from_numpy(start, cfg, "cpu")
    card_grads = [p.grad.float().cpu()
                  for p in tree.leaves(gpu["params"].live())]
    live = redo["params"].live()
    adamw_update(live, tree.unflatten(live, card_grads), redo["opt"], oc)
    grad_rel, param_err, adamw_err, flipped, n = [], 0.0, 0.0, 0, 0
    for pg, pc, pr, p0, g in zip(tree.leaves(gpu["params"].live()),
                                 tree.leaves(cpu["params"].live()),
                                 tree.leaves(live),
                                 tree.leaves(start["params"]), card_grads):
        c = pc.grad
        assert torch.isfinite(g).all()
        grad_rel.append(float((g - c).norm() / c.norm().clamp_min(1e-30)))
        new_g, new_c, new_r = pg.detach().cpu(), pc.detach(), pr.detach()
        param_err = max(param_err, float((new_g - new_c).abs().max()))
        bad = (new_g - new_r).abs() > (tol["param_atol"]
                                       + tol["param_rtol"] * new_r.abs())
        assert not bool(bad.any()), "card AdamW differs from the CPU's"
        adamw_err = max(adamw_err, float((new_g - new_r).abs().max()))
        p0 = torch.from_numpy(p0)
        flipped += int(((new_g - p0).sign() != (new_c - p0).sign()).sum())
        n += p0.numel()
    extra = {} if launches is None else {"launches": launches}
    say({"phase": phase, "arch": cfg.name, "layers": 2,
         "encoder_layers": cfg.encoder_layers,
         "frontend_tokens": 0 if frontend is None else cfg.frontend_tokens,
         "batch": 2, "seq": 128,
         "loss": [float(mg["loss"]), float(mc["loss"])],
         "grad_norm": [float(mg["grad_norm"]), float(mc["grad_norm"])],
         "lr": lr, "max_grad_rel": max(grad_rel),
         "max_param_abs_err": param_err,
         "param_bound": 2 * lr + tol["param_atol"],
         "max_abs_err_vs_cpu_adamw_of_card_grads": adamw_err,
         "update_sign_differs_share": flipped / n,
         "card_step_s": t1 - t0, "cpu_step_s": t2 - t1, "tol": tol,
         **extra})
    assert not any((launches or {}).values()), launches
    assert abs(float(mg["loss"]) - float(mc["loss"])) < tol["loss_abs"]
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) \
        < tol["grad_norm_rtol"] * float(mc["grad_norm"])
    assert max(grad_rel) < tol["grad_rel"], grad_rel
    assert param_err <= 2 * lr + tol["param_atol"], (param_err, lr)


def train_mamba_phase(wrappers):
    """A few full-width mamba2-370m steps on the plain SSD scan, graphed
    (``train_mamba``) and eager (``train_mamba_eager``); returns both
    runs' launches."""
    graphed, launches = train_run("train_mamba", wrappers, SSM_ARCH,
                                  TRAIN_MAMBA, True)
    eager, eager_launches = train_run("train_mamba_eager", wrappers,
                                      SSM_ARCH, TRAIN_MAMBA, False)
    train_twin_gate("train_mamba_graph_vs_eager", graphed, eager)
    return launches, eager_launches


def pilot_train_phase(wrappers):
    """A full-width train payload through pilots: checkpoint, node failure
    after the first checkpoint, resume by a replacement pilot; then the
    same image uninterrupted.  Returns the launches of both runs."""
    import tempfile
    from repro_torch.core.images import PayloadImage
    from repro_torch.data.synthetic import to_device
    from repro_torch.launch.steps import GRAPH_KEY
    from repro_torch.launch.train import train_via_pilots
    n = PILOT_TRAIN["steps"]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="pilot_train_ck_", dir=build)
    mem_before = allocated_bytes()
    _zero(wrappers)
    t0 = time.monotonic()
    try:
        with timed_checkpoints() as ckpt_s:
            out = train_via_pilots(
                DENSE_ARCH, False, n, ckpt=ckpt, seq=PILOT_TRAIN["seq"],
                batch=PILOT_TRAIN["batch"], device="cuda",
                ckpt_every=PILOT_TRAIN["ckpt_every"],
                fail_after_ckpt=PILOT_TRAIN["ckpt_every"])
        wall = time.monotonic() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt).rglob("*")
                         if f.is_file())
        disk_free = shutil.disk_usage(ckpt).free
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    res, fail = out["result"], out["failure"]
    assert res is not None, out["repo"]
    tel = res.telemetry
    assert res.exitcode == 0, (res.exitcode, tel.get("error"))
    assert res.pilot_id != fail["pilot"], (res.pilot_id, fail)
    assert fail["ckpt_step"] >= PILOT_TRAIN["ckpt_every"], fail
    assert tel["resumed_from"] == fail["ckpt_step"], (tel, fail)
    assert tel["steps"] == n - tel["resumed_from"], tel
    assert np.isfinite(tel["last_loss"]), tel
    # the same image, uninterrupted (the registry's cached pull)
    img = PayloadImage(DENSE_ARCH, f"custom:{PILOT_TRAIN['seq']}x"
                       f"{PILOT_TRAIN['batch']}", "train", smoke=False)
    exe = out["sim"].registry.pull(img, "cuda")
    assert exe.cached
    state, data = exe.make_inputs(0)
    t1 = time.monotonic()
    for i in range(n):
        state, m = exe.fn(state, to_device(data.batch_at(i), exe.device))
        whole = float(m["loss"])
    whole_s = time.monotonic() - t1
    launches = _launches(wrappers)
    whole_graph = GRAPH_KEY in state
    del state, m, exe
    out.clear()
    mem_after = allocated_bytes()
    say({"phase": "pilot_train", "arch": DENSE_ARCH, **PILOT_TRAIN,
         "wall_s": wall, "failure": fail, "exitcode": res.exitcode,
         "step_graph": {"killed": fail["step_graph"],
                        "resumed": tel.get("step_graph"),
                        "uninterrupted": whole_graph},
         "pilot": res.pilot_id, "resumed_from": tel["resumed_from"],
         "steps_after_resume": tel["steps"],
         "first_loss_after_resume": tel["first_loss"],
         "last_loss": tel["last_loss"], "uninterrupted_last_loss": whole,
         "bitwise_equal": tel["last_loss"] == whole,
         "abs_diff": abs(tel["last_loss"] - whole), "tol": RESUME_LOSS_TOL,
         "step_ms_last16": [t * 1e3 for t in tel["step_times"]],
         "uninterrupted_s": whole_s, "ckpt_bytes_at_end": ckpt_bytes,
         "checkpoint_s": ckpt_s,
         "disk_free": disk_free, "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    assert abs(tel["last_loss"] - whole) <= RESUME_LOSS_TOL, (
        tel["last_loss"], whole)
    assert fail["step_graph"] is True and tel["step_graph"] is True, (
        fail, tel.get("step_graph"))
    assert whole_graph
    assert not any(launches.values()), launches
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    return launches


# --------------------------------------------------------------------------
# the paper's examples (examples/torch/), each in-process at full width
# --------------------------------------------------------------------------

_DECODE_ONLY = ("decode_attention", "rmsnorm_fused")
def load_example(name):
    """``examples/torch/<name>.py`` as a module (nothing runs at import)."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def timed_checkpoints():
    """While entered, time each checkpoint's device->host snapshot and
    its write (``repro_torch.ckpt.checkpoint.snapshot`` and ``save``, as
    the train payload calls them); yields the seconds of each call."""
    from repro_torch.ckpt import checkpoint as ck
    seconds = {"snapshot": [], "save": []}
    orig = {k: getattr(ck, k) for k in seconds}

    def timed(k):
        def run(*args, **kw):
            t0 = time.monotonic()
            try:
                return orig[k](*args, **kw)
            finally:
                seconds[k].append(time.monotonic() - t0)
        return run

    for k in seconds:
        setattr(ck, k, timed(k))
    try:
        yield seconds
    finally:
        for k, f in orig.items():
            setattr(ck, k, f)


def payload_rows(repo, history):
    """Each payload of a pilot's ``history``: its image, exit code, bind
    ms (cold or cached), whether its steps replayed a CUDA graph and its
    last 16 steps' ms from its result's telemetry and, for a decode
    payload, its rows' tokens/s."""
    out = []
    for h in history:
        img = h["image"]
        res = repo.result(h["task_id"])
        tel = res.telemetry if res is not None else {}
        step_ms = [t * 1e3 for t in tel.get("step_times", [])]
        row = {"arch": img.arch, "mode": img.mode,
               "exitcode": h.get("exitcode"),
               "bind_ms": h["bind_seconds"] * 1e3,
               "bind_cached": h["bind_cached"], "steps": tel.get("steps"),
               "step_graph": tel.get("step_graph"), "step_ms": step_ms}
        if img.mode == "decode" and step_ms:
            row["tok_per_s"] = (img.shape_spec().global_batch * len(step_ms)
                                / (sum(step_ms) / 1e3))
        out.append(row)
    return out


def _fixed_sequence_gates(rec):
    ex = rec["exit"]
    tel = ex["telemetry"]
    assert ex["exitcode"] == 0 and tel["steps"] == 3, ex
    # the decode image's step replayed the payload state's graph
    assert tel["step_graph"], tel
    assert rec["bind"][1] is False, rec["bind"]
    step_ms = [t * 1e3 for t in tel["step_times"]]
    rows = rec["images"][0].shape_spec().global_batch
    return {"exitcode": ex["exitcode"], "cold_bind_ms": rec["bind"][0] * 1e3,
            "step_ms": step_ms, "step_graph": tel["step_graph"],
            "tok_per_s": rows * len(step_ms) / (sum(step_ms) / 1e3)}


def _late_binding_serve_gates(rec):
    rows = []
    for n, r in enumerate(rec["runs"]):
        st = r["stats"]
        assert st["completed"] == 4, (r["arch"], st["completed"])
        # the admission's token and a budget of 6 (max_len 64)
        assert all(len(t) == 7 for t in r["tokens"].values()), r["tokens"]
        assert st["d2h_transfers"] == st["decode_steps"] > 0, st
        assert st["step_graph"], f"{r['arch']}: the eager step ran"
        assert r["block_leaks"] == 0, (r["arch"], r["block_leaks"])
        assert r["bind_cached"] is (n > 0), (r["arch"], r["bind_cached"])
        rows.append({"arch": r["arch"], "bind_ms": r["bind_ms"],
                     "bind_cached": r["bind_cached"],
                     "tok_per_s": st["tok_per_s"],
                     "itl_p50_s": st["itl_p50_s"],
                     "slot_utilization": st["slot_utilization"],
                     "block_leaks": r["block_leaks"],
                     "launches": st["launches"]})
    return {"serves": rows}


def _quickstart_gates(rec):
    assert all(np.isfinite(rec["losses"])), rec["losses"]
    rows = payload_rows(rec["sim"].repo, rec["pilot"].history)
    assert [(r["arch"], r["mode"]) for r in rows] == [
        (i.arch, i.mode) for i in rec["images"]], rows
    assert all(r["exitcode"] == 0 for r in rows), rows
    stats = rec["sim"].repo.stats()
    assert stats["done"] == 3 and stats["failed"] == 0, stats
    assert rec["step_graph"] is True, rec["step_graph"]
    assert all(r["step_graph"] is True for r in rows if r["mode"] == "train")
    return {"direct_train_ms": [t * 1e3 for t in rec["step_s"]],
            "direct_train_ms_after_capture": float(
                np.median(rec["step_s"][1:])) * 1e3,
            "direct_step_graph": rec["step_graph"],
            "direct_losses": rec["losses"], "payloads": rows, "repo": stats}


def _dynamic_pilot_gates(rec):
    rows = payload_rows(rec["sim"].repo, rec["pilot"].history)
    assert [(r["arch"], r["mode"]) for r in rows] == [
        (i.arch, i.mode) for i in rec["images"]], rows
    assert all(r["exitcode"] == 0 for r in rows), rows
    res, p1, p2 = rec["result"], rec["p1"], rec["p2"]
    tel = res.telemetry
    assert p1.state == "failed", p1.state
    assert res.exitcode == 0 and res.pilot_id == p2.pilot_id, (
        res.exitcode, res.pilot_id, tel.get("error"))
    assert rec["killed_at"] is not None and rec["killed_at"] >= 10
    assert tel["resumed_from"] == rec["killed_at"], (tel, rec["killed_at"])
    assert tel["steps"] == 200 - tel["resumed_from"], tel
    assert tel["step_graph"] is True, tel
    assert p2.history[0]["bind_cached"] is True, p2.history[0]
    return {"payloads": rows, "killed_at": rec["killed_at"],
            "resumed_from": tel["resumed_from"], "steps_run": tel["steps"],
            "resumed_bind_ms": p2.history[0]["bind_seconds"] * 1e3,
            "resumed_step_ms_last16": [t * 1e3 for t in tel["step_times"]],
            "resumed_last_loss": tel["last_loss"],
            "resumed_step_graph": tel["step_graph"],
            "fail_image_flags": list(rec["train"].flags)}


def _elastic_train_gates(rec):
    from repro_torch.runtime.elastic import plan_remesh
    plans, want, old = [], [], None
    for n_live, got in zip((2, 1, 3), rec["plans"]):
        w = plan_remesh(old, n_live, 16, 256)
        old = w.new_mesh
        plans.append((got.new_mesh.shape, got.new_per_data, got.actions))
        want.append((w.new_mesh.shape, w.new_per_data, w.actions))
    assert plans == want, (plans, want)
    repo = rec["sim"].repo
    exits = [repo.result(t).exitcode for t in rec["tids"]]
    assert exits == [0] * 4, exits
    graphed = [repo.result(t).telemetry.get("step_graph")
               for t in rec["tids"]]
    assert graphed == [True] * 4, graphed
    train_ms = [t * 1e3 for tid in rec["tids"]
                for t in repo.result(tid).telemetry["step_times"]]
    return {"plans": [{"mesh": list(p[0]), "per_slice_batch": p[1],
                       "actions": list(p[2])} for p in plans],
            "exitcodes": exits, "step_graph": graphed, "train_ms": train_ms,
            "registry": dict(rec["registry"].stats)}


# example -> its last line, the kernels its run must launch, and its own
# gates.  No other kernel may launch: no example speculates or serves an
# MoE, mamba2's decode image steps its recurrence in plain PyTorch, a
# decode image's payload neither prefills nor pages, and a train payload
# runs the plain paths.  late_binding_serve's engines admit through flash
# and decode paged; its prefetch warms gemma-2b's decode image by one
# dense step.
EXAMPLES = {
    "fixed_sequence": ("fixed-sequence PoC OK", _DECODE_ONLY,
                       _fixed_sequence_gates),
    "late_binding_serve": ("late-binding serve OK",
                           ("flash_attention", "paged_decode_attention",
                            "decode_attention", "rmsnorm_fused"),
                           _late_binding_serve_gates),
    "quickstart": ("quickstart OK", _DECODE_ONLY, _quickstart_gates),
    "dynamic_pilot": ("dynamic PoC OK", _DECODE_ONLY, _dynamic_pilot_gates),
    "elastic_train": ("elastic demo OK", (), _elastic_train_gates),
}


def example_phase(wrappers, name):
    """``examples/torch/<name>.py``'s ``main`` in-process on the card at
    full width, with every launch count set to 0 just before it and read
    just after.  Gates: it returns 0 and ends with its OK line; its own
    gates (every payload exits 0; the resumed payload's ``resumed_from``
    is the killed payload's last checkpoint; the plans are
    ``plan_remesh``'s; no engine leaks a block); each image bound again
    is a cache hit; the kernels of ``EXAMPLES`` launched and no other;
    memory back within ``PILOT_MEMORY_SLACK`` once its objects are gone.
    Prints its lines, wall seconds, cold and cached bind ms, serve
    tokens/s, train ms a step, checkpoint seconds and launches; returns
    the launches."""
    ok_line, launched, gates = EXAMPLES[name]
    mod = load_example(name)
    mem_before = allocated_bytes()
    rec, out = {}, io.StringIO()
    _zero(wrappers)
    t0 = time.monotonic()
    with timed_checkpoints() as ckpt_s, contextlib.redirect_stdout(out):
        rc = mod.main([], record=rec)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = _launches(wrappers)
    lines = out.getvalue().splitlines()
    assert rc == 0 and lines and lines[-1] == ok_line, (rc, lines[-3:])
    report = gates(rec)
    cached = []
    for img in rec["images"]:
        t1 = time.monotonic()
        exe = rec["registry"].pull(img, rec["device"])
        cached.append({"image": f"{img.arch}/{img.mode}",
                       "cached_bind_ms": (time.monotonic() - t1) * 1e3})
        assert exe.cached, img
    rec.clear()
    mem_after = allocated_bytes()
    say({"phase": f"example_{name}", "wall_s": wall,
         "lines": lines, **report, "rebind": cached,
         "checkpoint_s": ckpt_s, "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    for w in launched:
        assert launches[w] > 0, (name, w, launches)
    for w in set(launches) - set(launched):
        assert launches[w] == 0, (name, w, launches)
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    return launches


def moe_serve_phase(wrappers):
    """The paged serve path of the MoE model: its admissions run the
    grouped-matmul kernel beside the attention and RMSNorm kernels."""
    stats, launches = serve_run("moe_serve", wrappers, arch=MOE_ARCH)
    assert stats["step_graph"], "moe_serve ran the eager step"
    for w in ("grouped_matmul", "flash_attention", "paged_decode_attention",
              "rmsnorm_fused"):
        assert launches[w] > 0, launches
    return launches


def spec_phase(wrappers, off_streams):
    """Draft-and-verify on the paged path: self-draft and a cold draft,
    each with its draft chain and verify step replayed as CUDA graphs
    (``spec_self``, ``spec_cold``) and eagerly (``*_eager``): streams,
    acceptance and steps equal, launches equal once the graphs' warm-up
    steps are taken off.  Returns ({run: launches}, spec_self_eager's
    acceptance)."""
    from repro_torch.configs.base import get_config
    cold = dataclasses.replace(get_config(DENSE_ARCH), num_layers=2)
    runs, stats = {}, {}
    for phase, kw in (("spec_self", {}),
                      ("spec_self_eager", dict(step_graph=False)),
                      ("spec_cold", dict(draft_cfg=cold, draft_seed=1)),
                      ("spec_cold_eager", dict(draft_cfg=cold, draft_seed=1,
                                               step_graph=False))):
        st, launches = serve_run(phase, wrappers, spec="draft", spec_k=4,
                                 **kw)
        assert st["spec"] == "draft", st["spec_fallback_reason"]
        assert st["spec_graph"] == (not phase.endswith("_eager")), phase
        for w in ("paged_verify_attention", "paged_decode_attention",
                  "flash_attention", "rmsnorm_fused"):
            assert launches[w] > 0, (phase, launches)
        if phase.startswith("spec_self"):
            assert st["acceptance_rate"] > 0.5, st["acceptance_rate"]
            assert st["tokens_per_step"] > 1, st["tokens_per_step"]
        same = {rid: st["streams"][rid] == t
                for rid, t in off_streams.items()}
        say({"phase": phase, "streams_equal_spec_off": sum(same.values()),
             "of": len(same),
             "differ": [rid for rid, ok in same.items() if not ok]})
        runs[phase], stats[phase] = launches, st
    for phase in ("spec_self", "spec_cold"):
        spec_vs_eager(phase, stats[phase], runs[phase],
                      stats[phase + "_eager"], runs[phase + "_eager"])
    return runs, stats["spec_self_eager"]["acceptance_rate"]


def spec_vs_eager(phase, graphed, g_launches, eager, e_launches):
    """A graphed spec run against its eager run on the same requests:
    streams bitwise, the same acceptance and steps, launches equal net of
    the graphs' warm-up steps; both runs' times printed."""
    _same_streams(phase, eager["streams"], graphed["streams"])
    assert graphed["acceptance_rate"] == eager["acceptance_rate"], phase
    assert graphed["decode_steps"] == eager["decode_steps"], phase
    replayed = net_launches(graphed, g_launches)
    assert replayed == e_launches, (phase, replayed, e_launches)
    graph_memory_gate(phase, graphed, eager)
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "ttft_p99_s", "wall_s", "decode_steps", "acceptance_rate",
            "tokens_per_step", "draft_overhead_s")
    say({"phase": f"{phase}_graph_vs_eager",
         "streams_equal": len(graphed["streams"]),
         "acceptance_equal": True, "launches_equal": True,
         "graph": {k: graphed[k] for k in keys},
         "eager": {k: eager[k] for k in keys}})


def dense_phase(wrappers, paged_streams):
    """The dense-KV ablation: token streams equal to the paged serve's."""
    stats, launches = serve_run("dense", wrappers, kv="dense")
    assert stats["kv"] == "dense" and stats["step_graph"]
    assert launches["decode_attention"] > 0, launches
    assert launches["paged_decode_attention"] == 0, launches
    differ = [rid for rid, t in paged_streams.items()
              if stats["streams"][rid] != t]
    assert not differ, f"dense streams differ from paged: {differ}"
    return launches


def prefilled_state(bundle, params, cfg, prompts, dev, kv="paged",
                    max_len=1024):
    """A ``kv`` decode state of len(prompts) slots, each slot prefilled
    with its prompt (paged: max_len / 16 blocks per slot).  Returns the
    state and each prefill's last logits."""
    from repro_torch.models.api import init_decode_state
    from repro_torch.serving.engine import (
        _install_slot, _install_slot_paged, admit_length)
    state = init_decode_state(cfg, len(prompts), max_len, kv=kv, device=dev)
    mb = max_len // 16
    logits_all = []
    for slot, prompt in enumerate(prompts):
        plen = admit_length(len(prompt), max_len)
        padded = np.zeros((plen,), np.int32)
        padded[-len(prompt):] = prompt
        logits, cache = bundle.prefill(
            params, {"tokens": torch.from_numpy(padded[None]).to(dev)})
        logits_all.append(logits[:, -1])
        if kv == "dense":
            _install_slot(state, cache, slot, plen, 0)
            continue
        row = list(range(1 + slot * mb, 1 + (slot + 1) * mb))
        _install_slot_paged(state, cache, slot, plen, 0, row, 0, 16)
    return state, logits_all


def teacher_forced(arch, kern, plain, dev, kv="paged", layers=None,
                   prompt_lens=(300, 700), max_len=1024, pin_routes=False):
    """``arch`` (its first ``layers`` layers, all by default) teacher-forced
    with the kernels (``kern``) and with the plain path (``plain``) from
    the same weights: prefill of prompts of ``prompt_lens`` tokens (by
    default 300 and 700: buckets 512 and 1023), then 8 decode steps of
    forced tokens on a ``kv`` state of ``max_len``.  Returns each run's
    logits, the weights, the rng, and each run's router top-k expert sets
    (sorted, one tensor per MoE call; empty for a dense arch).  With
    ``pin_routes`` the plain run's routers take the kernel run's expert
    choices, call by call (their weights from the plain run's own
    probabilities): the two runs then differ by the kernels' numerics
    alone, not by a near-tie that one run's rounding flips."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import build_model
    base = get_config(arch)
    if layers is not None:
        base = dataclasses.replace(base, num_layers=layers)
    kern = dataclasses.replace(base, **kern)
    plain = dataclasses.replace(base, **plain)
    params = build_model(kern).init(0, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    forced = rng.integers(0, base.vocab_size,
                          size=(8, len(prompts))).astype(np.int32)
    top_k = moe.top_k
    runs, routes, chosen = {}, {}, []
    for name, cfg in (("kernels", kern), ("plain", plain)):
        routes[name] = []
        pinned = iter(chosen) if pin_routes and name == "plain" else None

        def recording(probs, k, seen=routes[name], pinned=pinned,
                      record=name == "kernels"):
            if pinned is None:
                wts, idx = top_k(probs, k)
            else:
                idx = next(pinned)
                wts = torch.gather(probs, -1, idx)
                wts = wts / torch.clamp(wts.sum(dim=-1, keepdim=True),
                                        min=1e-9)
            if record:
                chosen.append(idx)
            seen.append(idx.sort(dim=-1).values.cpu())
            return wts, idx
        moe.top_k = recording
        try:
            bundle = build_model(cfg)
            state, logits_all = prefilled_state(bundle, params, cfg, prompts,
                                                dev, kv, max_len)
            for t in range(8):
                state["token"] = torch.from_numpy(forced[t][:, None]).to(dev)
                logits, state = bundle.decode(params, state)
                logits_all.append(logits[:, 0])
        finally:
            moe.top_k = top_k
        runs[name] = torch.cat(logits_all).float()
    return runs, params, rng, routes


def compare_logits(phase, arch, runs, **extra):
    err = check_close(f"{phase}/logits", runs["kernels"], runs["plain"],
                      LOGIT_TOL)
    agree = float((runs["kernels"].argmax(-1) == runs["plain"].argmax(-1))
                  .float().mean())
    say({"phase": phase, "arch": arch, "rows": runs["kernels"].shape[0],
         "max_abs_err": err, "tol": LOGIT_TOL, "argmax_agreement": agree,
         "max_abs_logit": float(runs["plain"].abs().max()), **extra})


def model_phase(dev):
    """Teacher-force full-width smollm-360m: kernels vs the plain path; then
    one verify forward against the sequential decode steps it replaces."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    base = get_config(DENSE_ARCH)
    on = dict(attn_impl="pallas", norm_impl="pallas")
    runs, params, rng, _ = teacher_forced(
        DENSE_ARCH, on, dict(attn_impl="chunked", norm_impl="jnp"), dev)
    compare_logits("model", base.name, runs)
    kern = dataclasses.replace(base, **on)

    # verify: prompts whose buckets (512) leave room for the 5 positions
    bundle = build_model(kern)
    prompts = [rng.integers(0, base.vocab_size, size=n).astype(np.int32)
               for n in (300, 450)]
    state, pre = prefilled_state(bundle, params, kern, prompts, dev)
    pending = torch.stack(pre).argmax(-1).to(torch.int32)        # (2, 1)
    tokens = torch.cat([pending, torch.from_numpy(rng.integers(
        0, base.vocab_size, size=(2, 4)).astype(np.int32)).to(dev)], dim=1)
    snap = {**state, "cache": [{k: v.clone() for k, v in leaf.items()}
                               for leaf in state["cache"]]}
    vlogits, _ = bundle.verify(params, tokens, snap)
    steps = []
    for s in range(tokens.shape[1]):
        state["token"] = tokens[:, s:s + 1].contiguous()
        logits, state = bundle.decode(params, state)
        steps.append(logits[:, 0])
    seq = torch.stack(steps, dim=1)
    verr = check_close("model/verify", vlogits, seq, LOGIT_TOL)
    say({"phase": "model_verify", "arch": base.name,
         "positions": list(vlogits.shape[:2]), "max_abs_err": verr,
         "tol": LOGIT_TOL, "bitwise": bool(torch.equal(vlogits, seq)),
         "argmax_agreement": float((vlogits.argmax(-1) == seq.argmax(-1))
                                   .float().mean())})


def moe_model_phase(dev):
    """Teacher-force full-width granite-moe-3b-a800m: the kernels (moe
    "gmm") vs the plain path (moe "einsum"), and how often the two runs'
    routers chose the same top-k expert set for a token in a layer."""
    runs, _, _, routes = teacher_forced(
        MOE_ARCH, dict(attn_impl="pallas", norm_impl="pallas", moe_impl="gmm"),
        dict(attn_impl="chunked", norm_impl="jnp", moe_impl="einsum"), dev)
    same = total = 0
    for a, b in zip(routes["kernels"], routes["plain"]):
        eq = (a == b).all(dim=-1)
        same += int(eq.sum())
        total += eq.numel()
    assert len(routes["kernels"]) == len(routes["plain"]) > 0
    compare_logits("moe_model", MOE_ARCH, runs,
                   topk_set_agreement=same / total, routed_rows=total,
                   router_calls=len(routes["kernels"]))


def mamba_layers_check(dev):
    """Every mixer of full-width mamba2-370m on a 1023-token admission, on
    the kernel path's own activations: the mixer with the SSD-scan kernel
    against the same mixer with the scan's plain version (the same bf16
    rounding of y), out within MIXER_TOL and ROW_REL_TOL, the state within
    the f32 scan tolerance.  Layer by layer the comparison is not
    compounded through the stack."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import ssm
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import apply_norm, embed_lookup
    cfg = dataclasses.replace(get_config(SSM_ARCH), ssm_impl="pallas",
                              norm_impl="pallas")
    params = build_model(cfg).init(0, device=dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 1023))
                              .astype(np.int32)).to(dev)
    x = embed_lookup(tokens, params.embed)
    kernel = ops.ssd_scan
    errs, rels, state_errs = [], [], []
    for g in range(params.n_groups):
        p = params.group(g)[0]
        h = apply_norm(x, p["mixer_norm"], cfg)
        out, cache = ssm.ssm_forward_with_cache(h, p["mixer"], cfg)
        ops.ssd_scan = ops.ssd_scan_plain
        try:
            want, wcache = ssm.ssm_forward_with_cache(h, p["mixer"], cfg)
        finally:
            ops.ssd_scan = kernel
        errs.append(check_close(f"mamba_layers/{g}/out", out, want, MIXER_TOL,
                                ROW_REL_TOL))
        err = (out.float() - want.float()).norm(dim=-1)
        rels.append(float((err / want.float().norm(dim=-1)
                           .clamp_min(1e-30)).max()))
        state_errs.append(check_close(f"mamba_layers/{g}/state",
                                      cache["ssd"], wcache["ssd"],
                                      SSD_TOL[torch.float32]))
        x = x + out
    say({"phase": "mamba_layers", "arch": SSM_ARCH, "layers": len(errs),
         "tokens": 1023, "max_abs_err": max(errs), "tol": MIXER_TOL,
         "max_row_rel_err": max(rels), "row_rel_tol": ROW_REL_TOL,
         "state_max_abs_err": max(state_errs),
         "max_abs_out": float(want.float().abs().max())})


def mamba_model_phase(dev):
    """mamba2-370m on its dense layout: each mixer at full depth
    (`mamba_layers_check`); the first ``MAMBA_GATED_LAYERS`` layers
    teacher-forced, the SSD-scan and RMSNorm kernels against the plain path
    (ssm "chunked", norm "jnp") within LOGIT_TOL; and all 48 layers
    teacher-forced the same way, reported beside the plain path's own
    spread when only the RMSNorm kernel changes."""
    from repro_torch.configs.base import get_config
    mamba_layers_check(dev)
    kern = dict(ssm_impl="pallas", norm_impl="pallas")
    plain = dict(ssm_impl="chunked", norm_impl="jnp")
    runs, _, _, _ = teacher_forced(SSM_ARCH, kern, plain, dev, kv="dense",
                                   layers=MAMBA_GATED_LAYERS)
    compare_logits("mamba_model", SSM_ARCH, runs, layers=MAMBA_GATED_LAYERS)
    full, _, _, _ = teacher_forced(SSM_ARCH, kern, plain, dev, kv="dense")
    spread, _, _, _ = teacher_forced(
        SSM_ARCH, dict(ssm_impl="chunked", norm_impl="pallas"), plain, dev,
        kv="dense")

    def gap(runs):
        a, b = runs["kernels"], runs["plain"]
        err = (a - b).abs()
        return {"max_abs_err": float(err.max()),
                "outside_logit_tol": int((err > LOGIT_TOL["atol"]
                                          + LOGIT_TOL["rtol"] * b.abs())
                                         .sum()),
                "argmax_agreement": float((a.argmax(-1) == b.argmax(-1))
                                          .float().mean())}
    if not (torch.isfinite(full["kernels"]).all()
            and torch.isfinite(full["plain"]).all()):
        raise AssertionError("mamba_model_full_depth: non-finite logits")
    say({"phase": "mamba_model_full_depth", "arch": SSM_ARCH,
         "layers": get_config(SSM_ARCH).num_layers,
         "elements": full["plain"].numel(),
         "kernels_vs_plain": gap(full),
         "plain_with_rmsnorm_kernel_vs_plain": gap(spread),
         "max_abs_logit": float(full["plain"].abs().max())})



# --------------------------------------------------------------------------
# gemma-2b, starcoder2-3b and mixtral-8x7b (sliding-window attention)
# --------------------------------------------------------------------------

def swa_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(SWA_ARCH), num_layers=SWA_LAYERS)


def swa_trace(vocab, prompt_lens):
    """Requests of ``prompt_lens`` random tokens (seed 0), 64 new tokens
    each, request i visible at tick i."""
    rng = np.random.default_rng(SWA["seed"])
    return [{"rid": i, "prompt": rng.integers(0, vocab, size=n).tolist(),
             "max_new_tokens": SWA["max_new_tokens"], "at_step": i}
            for i, n in enumerate(prompt_lens)]


def no_drops(cfg):
    """``cfg`` with an MoE capacity of every token (capacity factor E/k):
    the one-shot prefill's capacity dispatch drops no assignment, as the
    chunk path's dense-gated MoE never does (the reference's two paths;
    with drops they compute different functions)."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def dense_arch_serve_phase(wrappers, phase, arch):
    """serve's trace on full-width ``arch`` (gemma-2b, starcoder2-3b):
    paged, graphed; flash and paged decode launched, RMSNorm launched
    where the arch has it (starcoder2's LayerNorm launches none)."""
    from repro_torch.configs.base import get_config
    stats, launches = serve_run(phase, wrappers, arch=arch)
    assert stats["kv"] == "paged" and stats["step_graph"], phase
    for w in ("flash_attention", "paged_decode_attention"):
        assert launches[w] > 0, (phase, launches)
    norms = launches["rmsnorm_fused"]
    assert (norms > 0) == (get_config(arch).norm == "rmsnorm"), launches
    for w in ("decode_attention", "grouped_matmul", "ssd_scan",
              "paged_verify_attention"):
        assert launches[w] == 0, (phase, launches)
    return stats, launches


def swa_serve_phase(wrappers):
    """mixtral-8x7b (8 layers, full width) on its 4096-slot rolling rings:
    the trace of ``SWA_PROMPTS`` graphed (``swa_serve``) and eager
    (``swa_serve_eager``).  Gates: those of every run, the dense layout
    and no speculation, flash once a layer per admission, the grouped
    matmul, dense decode and RMSNorm launched, paged decode not; the two
    runs' streams bitwise equal and their launches equal once the graph's
    warm-up steps are taken off.  Returns both runs' launches."""
    cfg = swa_config()
    trace = swa_trace(cfg.vocab_size, SWA_PROMPTS)
    runs = {}
    for phase, kw in (("swa_serve", {}),
                      ("swa_serve_eager", dict(step_graph=False))):
        stats, launches = serve_run(phase, wrappers, load=SWA, cfg=cfg,
                                    trace=trace, **kw)
        assert stats["kv"] == "dense" and stats["spec"] == "off", stats["kv"]
        assert stats["step_graph"] == (phase == "swa_serve"), phase
        assert launches["flash_attention"] == cfg.num_layers * len(trace)
        for w in ("grouped_matmul", "decode_attention", "rmsnorm_fused"):
            assert launches[w] > 0, (phase, launches)
        assert launches["paged_decode_attention"] == 0, launches
        runs[phase] = (stats, launches)
    (graphed, g_launches), (eager, e_launches) = runs.values()
    differ = [rid for rid, t in graphed["streams"].items()
              if eager["streams"][rid] != t]
    assert not differ, f"swa: eager streams differ from the graph's: {differ}"
    warm = graphed["graph_warm_launches"]
    replayed = {w: n - warm.get(w, 0) for w, n in g_launches.items()}
    assert replayed == e_launches, (replayed, e_launches)
    graph_memory_gate("swa_serve", graphed, eager)
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "ttft_p99_s", "wall_s", "decode_steps")
    say({"phase": "swa_graph_vs_eager", "arch": cfg.name,
         "layers": cfg.num_layers, "reduced": "8 of 32 layers",
         "streams_equal": len(graphed["streams"]),
         "of": len(graphed["streams"]), "launches_equal": True,
         "graph": {k: graphed[k] for k in keys},
         "eager": {k: eager[k] for k in keys}})
    return g_launches, e_launches


def chunked_swa_phase(wrappers, dev):
    """``SWA_CHUNKED_PROMPTS`` on mixtral (8 layers) admitted in 512-token
    chunks on the rolling rings: the gates of every run, exactly the chunks
    the buckets need, no flash or grouped-matmul launch (the chunk attends
    in plain PyTorch and runs the dense-gated MoE, as the reference's),
    dense decode launched.  Then the same prompts' chained chunk logits
    into a fresh state against the one-shot prefill's, within LOGIT_TOL, at
    an MoE capacity that drops nothing; against the config's own capacity
    (which drops over-full experts' assignments) reported.  Returns the
    run's launches."""
    from repro_torch.launch.serve import _on_kernels
    from repro_torch.models.api import build_model, init_decode_state
    from repro_torch.serving.engine import admit_length
    cfg = swa_config()
    trace = swa_trace(cfg.vocab_size, SWA_CHUNKED_PROMPTS)
    load = dict(SWA, n_requests=len(trace))
    stats, launches = serve_run("chunked_swa", wrappers, load=load, cfg=cfg,
                                trace=trace, prefill="chunked",
                                prefill_chunk=SWA_CHUNK)
    assert stats["step_graph"] and stats["prefill"] == "chunked"
    buckets = [admit_length(n, SWA["max_len"]) for n in SWA_CHUNKED_PROMPTS]
    want = sum(-(-b // SWA_CHUNK) for b in buckets)
    assert stats["prefill_chunks"] == want, (stats["prefill_chunks"], want)
    for w in ("flash_attention", "grouped_matmul", "paged_decode_attention"):
        assert launches[w] == 0, launches
    assert launches["decode_attention"] > 0, launches

    kern = _on_kernels(cfg)
    bundle, full = build_model(kern), build_model(no_drops(kern))
    params = bundle.init(0, device=dev)
    chained, oneshot, dropping = [], [], []
    for e, plen in zip(trace, buckets):
        padded = np.zeros((1, plen), np.int32)
        padded[0, -len(e["prompt"]):] = e["prompt"]
        toks = torch.from_numpy(padded).to(dev)
        oneshot.append(full.prefill(params, {"tokens": toks})[0][:, -1])
        dropping.append(bundle.prefill(params, {"tokens": toks})[0][:, -1])
        state = init_decode_state(kern, 1, SWA["max_len"], kv="dense",
                                  device=dev)
        row = torch.zeros((1,), dtype=torch.int32, device=dev)
        off = 0
        while off < plen:
            C = min(SWA_CHUNK - off % SWA_CHUNK, plen - off)
            logits, _ = bundle.prefill_chunk(params, state,
                                             toks[:, off:off + C], row, 0, off)
            off += C
        chained.append(logits)
        del state
    got, want_l = torch.cat(chained).float(), torch.cat(oneshot).float()
    drop = torch.cat(dropping).float()
    err = check_close("chunked_swa/logits", got, want_l, LOGIT_TOL)
    say({"phase": "chunked_swa_logits", "arch": kern.name,
         "layers": kern.num_layers, "buckets": buckets, "chunk": SWA_CHUNK,
         "window": kern.sliding_window, "max_abs_err": err, "tol": LOGIT_TOL,
         "argmax_agreement": float((got.argmax(-1) == want_l.argmax(-1))
                                   .float().mean()),
         "max_abs_logit": float(want_l.abs().max()),
         "capacity_factor": no_drops(kern).moe.capacity_factor,
         "vs_own_capacity": {
             "capacity_factor": kern.moe.capacity_factor,
             "max_abs_err": float((got - drop).abs().max()),
             "argmax_agreement": float((got.argmax(-1) == drop.argmax(-1))
                                       .float().mean())}})
    del params
    torch.cuda.empty_cache()
    return launches


def pilot_gemma_phase(wrappers, direct):
    """The paper's pair (examples/late_binding_serve.py): one pilot binds
    full-width smollm-360m, then gemma-2b, prefetched (`pilot_run`'s
    gates); gemma's engine launched flash, paged decode and RMSNorm.
    Returns each payload engine's launches by arch."""
    out, wall, launches, report, warm, memory = pilot_run(
        wrappers, [DENSE_ARCH, GEMMA_ARCH], direct)
    p2 = launches[GEMMA_ARCH]
    for w in ("flash_attention", "paged_decode_attention", "rmsnorm_fused"):
        assert p2[w] > 0, p2
    assert p2["decode_attention"] == p2["grouped_matmul"] == 0, p2
    pilot_report("pilot_gemma", out, wall, report, warm, memory)
    return launches


def arch_models_phase(dev):
    """Teacher-forced logits of the kernel path against the plain path
    (LOGIT_TOL), as ``model``: full-width gemma-2b and starcoder2-3b at
    full depth, paged; mixtral-8x7b at full width and 8 layers on its
    dense rings, prompts of 4090 and 6000 tokens at max_len 16384 (buckets
    4096 and 8192: the second's prefill rolls the ring, and every decode
    step is past the window), the kernels (moe "gmm") against the plain
    path (moe "einsum"), with the routers' top-k agreement."""
    on = dict(attn_impl="pallas", norm_impl="pallas")
    off = dict(attn_impl="chunked", norm_impl="jnp")
    for arch in (GEMMA_ARCH, CODE_ARCH):
        runs, params, _, _ = teacher_forced(arch, on, off, dev)
        del params
        compare_logits("arch_models", arch, runs)
        torch.cuda.empty_cache()
    runs, params, _, routes = teacher_forced(
        SWA_ARCH, dict(on, moe_impl="gmm"), dict(off, moe_impl="einsum"),
        dev, kv="dense", layers=SWA_LAYERS, prompt_lens=(4090, 6000),
        max_len=16384)
    del params
    same = total = 0
    for a, b in zip(routes["kernels"], routes["plain"]):
        eq = (a == b).all(dim=-1)
        same += int(eq.sum())
        total += eq.numel()
    compare_logits("arch_models", SWA_ARCH, runs, layers=SWA_LAYERS,
                   reduced="8 of 32 layers", window_crossing=True,
                   topk_set_agreement=same / total, routed_rows=total)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# minicpm3-4b: multi-head latent attention (MLA)
# --------------------------------------------------------------------------

# the kernels no MLA serve path launches: MLA decode, verify and chunks
# score the latent in plain PyTorch (the reference has no kernel for them)
MLA_UNLAUNCHED = ("paged_decode_attention", "paged_verify_attention",
                  "decode_attention", "grouped_matmul", "ssd_scan")


def _same_streams(phase, got, want):
    differ = [rid for rid, t in want.items() if got[rid] != t]
    assert not differ, f"{phase}: streams differ: {differ}"


def mla_serve_phases(wrappers, serve):
    """serve's trace on full-width, full-depth minicpm3-4b: paged and
    graphed (``mla_serve``), on the eager step (``mla_serve_eager``), dense
    (``mla_dense``) and self-drafting (``mla_spec``, its spec pair graphed,
    and ``mla_spec_eager``, the trace's first ``MLA_SPEC_REQUESTS``: streams,
    acceptance and launches net of warm-up equal).  Gates: those of
    every run; flash once a layer per admission (twice with the draft's
    prefill) and RMSNorm launched, no other kernel; eager and dense
    streams bitwise mla_serve's, eager launches equal to the graph's once
    its warm-up steps are taken off; self-draft acceptance above 0.5, no
    verify kernel.  Reported: whether each spec stream equals mla_serve's,
    and mla_serve beside smollm's ``serve``.  Returns (mla_serve's stats,
    {run: launches})."""
    from repro_torch.configs.base import get_config
    layers = get_config(MLA_ARCH).num_layers
    trace = serve_trace(MLA_ARCH)
    spec_load = dict(SERVE, n_requests=MLA_SPEC_REQUESTS)
    runs, stats = {}, {}
    for phase, kw in (("mla_serve", {}),
                      ("mla_serve_eager", dict(step_graph=False)),
                      ("mla_dense", dict(kv="dense")),
                      ("mla_spec", dict(spec="draft", spec_k=4,
                                        load=spec_load,
                                        trace=trace[:MLA_SPEC_REQUESTS])),
                      ("mla_spec_eager", dict(spec="draft", spec_k=4,
                                              load=spec_load,
                                              trace=trace[:MLA_SPEC_REQUESTS],
                                              step_graph=False))):
        st, launches = serve_run(phase, wrappers, arch=MLA_ARCH, **kw)
        assert st["kv"] == ("dense" if phase == "mla_dense" else "paged")
        assert st["step_graph"] == (not phase.endswith("_eager")), phase
        prefills = 2 if phase.startswith("mla_spec") else 1
        assert launches["flash_attention"] == \
            prefills * layers * st["completed"], launches
        assert launches["rmsnorm_fused"] > 0, launches
        for w in MLA_UNLAUNCHED:
            assert launches[w] == 0, (phase, launches)
        runs[phase], stats[phase] = launches, st
    graphed = stats["mla_serve"]
    eager, dense, spec = (stats[p] for p in ("mla_serve_eager", "mla_dense",
                                             "mla_spec"))
    spec_vs_eager("mla_spec", spec, runs["mla_spec"],
                  stats["mla_spec_eager"], runs["mla_spec_eager"])
    _same_streams("mla_serve_eager", eager["streams"], graphed["streams"])
    _same_streams("mla_dense", dense["streams"], graphed["streams"])
    warm = graphed["graph_warm_launches"]
    replayed = {w: c - warm.get(w, 0) for w, c in runs["mla_serve"].items()}
    assert replayed == runs["mla_serve_eager"], (replayed,
                                                 runs["mla_serve_eager"])
    graph_memory_gate("mla_serve", graphed, eager)
    assert spec["spec"] == "draft", spec["spec_fallback_reason"]
    assert spec["acceptance_rate"] > 0.5, spec["acceptance_rate"]
    same = {rid: graphed["streams"][rid] == t
            for rid, t in spec["streams"].items()}
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "ttft_p99_s", "wall_s", "decode_steps")
    say({"phase": "mla_summary", "arch": MLA_ARCH, "layers": layers,
         "eager_streams_equal": len(graphed["streams"]),
         "dense_streams_equal": len(graphed["streams"]),
         "launches_equal": True,
         "spec_streams_equal_spec_off": sum(same.values()), "of": len(same),
         "spec_differ": [rid for rid, ok in same.items() if not ok],
         "spec_acceptance": spec["acceptance_rate"],
         "spec_tokens_per_step": spec["tokens_per_step"],
         "mla_serve": {k: graphed[k] for k in keys},
         "mla_serve_eager": {k: eager[k] for k in keys},
         "mla_dense": {k: dense[k] for k in keys},
         "mla_spec": {k: spec[k] for k in keys},
         "mla_spec_eager": {k: stats["mla_spec_eager"][k] for k in keys},
         "serve_smollm": {k: serve[k] for k in keys}})
    torch.cuda.empty_cache()
    return graphed, runs


def pilot_mla_phase(wrappers, direct):
    """One pilot binds full-width smollm-360m, then minicpm3-4b, prefetched
    (`pilot_run`'s gates: streams bitwise serve's and mla_serve's);
    minicpm3's engine launched flash and RMSNorm and no other kernel.
    Returns each payload engine's launches by arch."""
    out, wall, launches, report, warm, memory = pilot_run(
        wrappers, [DENSE_ARCH, MLA_ARCH], direct)
    p2 = launches[MLA_ARCH]
    for w in ("flash_attention", "rmsnorm_fused"):
        assert p2[w] > 0, p2
    for w in MLA_UNLAUNCHED:
        assert p2[w] == 0, p2
    pilot_report("pilot_mla", out, wall, report, warm, memory)
    return launches


def mla_model_phase(dev):
    """minicpm3-4b teacher-forced as in phase 6 (kernels against the plain
    path, paged), its first ``MLA_GATED_LAYERS`` layers (all 62) gated by
    LOGIT_TOL; when they miss it, the errors at ``MLA_DEPTHS`` layers are
    reported first."""
    on = dict(attn_impl="pallas", norm_impl="pallas")
    off = dict(attn_impl="chunked", norm_impl="jnp")
    runs, params, _, _ = teacher_forced(MLA_ARCH, on, off, dev,
                                        layers=MLA_GATED_LAYERS)
    del params
    torch.cuda.empty_cache()
    if not torch.allclose(runs["kernels"], runs["plain"], **LOGIT_TOL):
        depths = {MLA_GATED_LAYERS: runs}
        for n in MLA_DEPTHS:
            depths[n], params, _, _ = teacher_forced(MLA_ARCH, on, off, dev,
                                                     layers=n)
            del params
            torch.cuda.empty_cache()
        say({"phase": "mla_model_by_depth", "arch": MLA_ARCH, "tol": LOGIT_TOL,
             "max_abs_err": {n: float((r["kernels"] - r["plain"]).abs().max())
                             for n, r in depths.items()},
             "within_tol": {n: bool(torch.allclose(r["kernels"], r["plain"],
                                                   **LOGIT_TOL))
                            for n, r in depths.items()}})
    compare_logits("mla_model", MLA_ARCH, runs, layers=MLA_GATED_LAYERS)


# --------------------------------------------------------------------------
# the last families: hybrid jamba, the llava VLM stub, whisper enc-dec
# --------------------------------------------------------------------------

def hybrid_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(HYBRID_ARCH),
                               num_layers=HYBRID_LAYERS)


def hybrid_serve_phases(wrappers):
    """serve's trace on jamba (8 layers, full width): paged and graphed,
    asking for speculation (``hybrid_serve``: the engine records the SSM
    reason and serves with it off), on the eager step
    (``hybrid_serve_eager``) and on the dense layout (``hybrid_dense``).
    Gates: those of every run; no prefix cache and no speculation; flash
    once a layer per admission on the attention slot, the SSD scan once on
    each of the 7 SSM slots, the grouped matmul 3 times on each of the 4
    MoE slots, RMSNorm and the decode kernel of the layout launched, no
    verify; the three runs' streams bitwise equal, the eager launches the
    graph's once its warm-up is taken off.  Returns (hybrid_serve's stats,
    {run: launches})."""
    from repro_torch.models.transformer import layer_slots
    cfg = hybrid_config()
    slots = layer_slots(cfg)
    groups = cfg.num_layers // len(slots)
    per = {m: groups * sum(s["mixer"] == m for s in slots)
           for m in ("attn", "ssm")}
    moe_layers = groups * sum(s["ffn"] == "moe" for s in slots)
    trace = serve_trace(HYBRID_ARCH)
    runs, stats = {}, {}
    for phase, kw in (("hybrid_serve", dict(spec="draft")),
                      ("hybrid_serve_eager", dict(step_graph=False)),
                      ("hybrid_dense", dict(kv="dense"))):
        st, launches = serve_run(phase, wrappers, cfg=cfg, trace=trace, **kw)
        dense = phase == "hybrid_dense"
        assert st["kv"] == ("dense" if dense else "paged"), st["kv"]
        assert st["step_graph"] == (phase != "hybrid_serve_eager"), phase
        assert st["spec"] == "off", st["spec"]
        n = st["completed"]
        assert launches["flash_attention"] == per["attn"] * n, launches
        assert launches["ssd_scan"] == per["ssm"] * n, launches
        assert launches["grouped_matmul"] == 3 * moe_layers * n, launches
        decode = "decode_attention" if dense else "paged_decode_attention"
        other = "paged_decode_attention" if dense else "decode_attention"
        assert launches[decode] > 0 and launches["rmsnorm_fused"] > 0
        assert launches[other] == launches["paged_verify_attention"] == 0
        runs[phase], stats[phase] = launches, st
    graphed = stats["hybrid_serve"]
    assert "SSM state rows" in graphed["spec_fallback_reason"], graphed
    for phase in ("hybrid_serve_eager", "hybrid_dense"):
        _same_streams(phase, stats[phase]["streams"], graphed["streams"])
    warm = graphed["graph_warm_launches"]
    replayed = {w: c - warm.get(w, 0) for w, c in runs["hybrid_serve"].items()}
    assert replayed == runs["hybrid_serve_eager"], (
        replayed, runs["hybrid_serve_eager"])
    graph_memory_gate("hybrid_serve", graphed, stats["hybrid_serve_eager"])
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "ttft_p99_s", "wall_s", "decode_steps")
    say({"phase": "hybrid_summary", "arch": cfg.name,
         "layers": cfg.num_layers, "reduced": "8 of 32 layers",
         "attention_layers": per["attn"], "ssm_layers": per["ssm"],
         "moe_layers": moe_layers,
         "spec_fallback_reason": graphed["spec_fallback_reason"],
         "eager_streams_equal": len(graphed["streams"]),
         "dense_streams_equal": len(graphed["streams"]),
         "launches_equal": True,
         **{p: {k: st[k] for k in keys} for p, st in stats.items()}})
    torch.cuda.empty_cache()
    return graphed, runs


def hybrid_layers_check(dev, cfg, params):
    """Each SSM mixer of jamba (8 layers) on a 1023-token admission, on the
    kernel path's own activations (every layer of the stack run through):
    the mixer with the SSD-scan kernel against the same mixer on the
    scan's plain version, within MIXER_TOL and ROW_REL_TOL, the state
    within the f32 scan tolerance, as ``mamba_layers``."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm, embed_lookup, rope_table
    from repro_torch.models.transformer import _ffn, layer_slots
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 1023))
                              .astype(np.int32)).to(dev)
    x = embed_lookup(tokens, params.embed)
    rope = rope_table(torch.arange(1023, device=dev), cfg.head_dim,
                      cfg.rope_theta)
    kernel = ops.ssd_scan
    errs, rels, state_errs = [], [], []
    for g in range(params.n_groups):
        for slot, p in zip(layer_slots(cfg), params.group(g)):
            h = apply_norm(x, p["mixer_norm"], cfg)
            if slot["mixer"] == "attn":
                out = attn.attention_forward(h, p["mixer"], cfg,
                                             rope_cos=rope[0],
                                             rope_sin=rope[1])
            else:
                out, cache = ssm.ssm_forward_with_cache(h, p["mixer"], cfg)
                ops.ssd_scan = ops.ssd_scan_plain
                try:
                    want, wcache = ssm.ssm_forward_with_cache(h, p["mixer"],
                                                              cfg)
                finally:
                    ops.ssd_scan = kernel
                name = f"hybrid_layers/{len(errs)}"
                errs.append(check_close(f"{name}/out", out, want, MIXER_TOL,
                                        ROW_REL_TOL))
                err = (out.float() - want.float()).norm(dim=-1)
                rels.append(float((err / want.float().norm(dim=-1)
                                   .clamp_min(1e-30)).max()))
                state_errs.append(check_close(
                    f"{name}/state", cache["ssd"], wcache["ssd"],
                    SSD_TOL[torch.float32]))
            x = _ffn(x + out, p, cfg, slot, torch.bfloat16, prefill=True)
    say({"phase": "hybrid_layers", "arch": cfg.name, "ssm_layers": len(errs),
         "tokens": 1023, "max_abs_err": max(errs), "tol": MIXER_TOL,
         "max_row_rel_err": max(rels), "row_rel_tol": ROW_REL_TOL,
         "state_max_abs_err": max(state_errs)})


def hybrid_model_phase(dev):
    """jamba (8 layers, full width) teacher-forced as in phase 6 on its
    paged layout, every kernel (attention, norm, ssm "pallas", moe "gmm")
    against the plain path, the plain run's routers pinned to the kernel
    run's expert choices (`teacher_forced`'s ``pin_routes``): within
    LOGIT_TOL.  With free routers, a near-tie that the two runs' rounding
    breaks apart moves a token to another of 16 experts, and the same
    comparison is reported with how often the top-2 sets agree; then each
    SSM mixer against its plain scan (`hybrid_layers_check`)."""
    on = dict(attn_impl="pallas", norm_impl="pallas", ssm_impl="pallas",
              moe_impl="gmm")
    off = dict(attn_impl="chunked", norm_impl="jnp", ssm_impl="chunked",
               moe_impl="einsum")

    def agreement(routes):
        same = total = 0
        for a, b in zip(routes["kernels"], routes["plain"]):
            eq = (a == b).all(dim=-1)
            same += int(eq.sum())
            total += eq.numel()
        return same / total, total
    free, params, _, routes = teacher_forced(HYBRID_ARCH, on, off, dev,
                                             layers=HYBRID_LAYERS)
    del params
    torch.cuda.empty_cache()
    err = (free["kernels"] - free["plain"]).abs()
    free_agree, routed = agreement(routes)
    runs, params, _, routes = teacher_forced(HYBRID_ARCH, on, off, dev,
                                             layers=HYBRID_LAYERS,
                                             pin_routes=True)
    assert agreement(routes)[0] == 1.0
    compare_logits(
        "hybrid_model", HYBRID_ARCH, runs, layers=HYBRID_LAYERS,
        reduced="8 of 32 layers", routes="pinned to the kernel run's",
        free_routes={
            "max_abs_err": float(err.max()),
            "row_max_abs_err": err.max(dim=-1).values.tolist(),
            "outside_logit_tol": int((err > LOGIT_TOL["atol"]
                                      + LOGIT_TOL["rtol"]
                                      * free["plain"].abs()).sum()),
            "argmax_agreement": float((free["kernels"].argmax(-1)
                                       == free["plain"].argmax(-1))
                                      .float().mean()),
            "topk_set_agreement": free_agree, "routed_rows": routed})
    hybrid_layers_check(dev, dataclasses.replace(hybrid_config(), **on),
                        params)
    del params
    torch.cuda.empty_cache()


def vlm_serve_phases(wrappers):
    """serve's trace on full llava-next-mistral-7b, text only as the
    reference's engine serves it: paged and graphed (``vlm_serve``) and on
    the eager step (``vlm_serve_eager``).  Gates: those of every run;
    flash once a layer per admission, paged decode and RMSNorm launched,
    no other kernel; streams bitwise equal, launches equal once the
    graph's warm-up is taken off.  Returns (vlm_serve's stats, {run:
    launches})."""
    from repro_torch.configs.base import get_config
    layers = get_config(VLM_ARCH).num_layers
    runs, stats = {}, {}
    for phase, kw in (("vlm_serve", {}),
                      ("vlm_serve_eager", dict(step_graph=False))):
        st, launches = serve_run(phase, wrappers, arch=VLM_ARCH, **kw)
        assert st["kv"] == "paged" and st["spec"] == "off", st["kv"]
        assert st["step_graph"] == (phase == "vlm_serve"), phase
        assert launches["flash_attention"] == layers * st["completed"]
        for w in ("paged_decode_attention", "rmsnorm_fused"):
            assert launches[w] > 0, (phase, launches)
        for w in ("decode_attention", "paged_verify_attention",
                  "grouped_matmul", "ssd_scan"):
            assert launches[w] == 0, (phase, launches)
        runs[phase], stats[phase] = launches, st
    graphed, eager = stats["vlm_serve"], stats["vlm_serve_eager"]
    _same_streams("vlm_serve_eager", eager["streams"], graphed["streams"])
    warm = graphed["graph_warm_launches"]
    replayed = {w: c - warm.get(w, 0) for w, c in runs["vlm_serve"].items()}
    assert replayed == runs["vlm_serve_eager"], (replayed,
                                                 runs["vlm_serve_eager"])
    graph_memory_gate("vlm_serve", graphed, eager)
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "ttft_p99_s", "wall_s", "decode_steps")
    say({"phase": "vlm_graph_vs_eager", "arch": VLM_ARCH, "layers": layers,
         "streams_equal": len(graphed["streams"]),
         "of": len(graphed["streams"]), "launches_equal": True,
         "graph": {k: graphed[k] for k in keys},
         "eager": {k: eager[k] for k in keys}})
    torch.cuda.empty_cache()
    return graphed, runs


def vlm_model_phase(dev):
    """llava (all 32 layers, full width), two rows: each a prefill of 576
    stub patch embeddings (normal x 0.02) and 447 text tokens (the 1023
    positions of the longest admission) installed into a paged state of
    max_len 2048, then 8 teacher-forced decode steps; the kernel path
    against the plain path within LOGIT_TOL, flash once a layer per
    prefill on the kernel path and never on the plain one."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.api import build_model, init_decode_state
    from repro_torch.serving.engine import _install_slot_paged
    base = get_config(VLM_ARCH)
    on = dataclasses.replace(base, attn_impl="pallas", norm_impl="pallas")
    off = dataclasses.replace(base, attn_impl="chunked", norm_impl="jnp")
    params = build_model(on).init(0, device=dev)
    rng = np.random.default_rng(3)
    B, F_, steps = 2, base.frontend_tokens, 8
    max_len = 2048
    mb = max_len // 16
    text = rng.integers(0, base.vocab_size,
                        size=(B, VLM_TEXT)).astype(np.int32)
    patches = (torch.from_numpy(rng.normal(size=(B, F_, base.d_model))
                                .astype(np.float32)) * 0.02).to(
        dev, torch.bfloat16)
    forced = rng.integers(0, base.vocab_size,
                          size=(steps, B)).astype(np.int32)
    runs, launches = {}, {}
    for name, cfg in (("kernels", on), ("plain", off)):
        bundle = build_model(cfg)
        before = flash_attention.launches
        state = init_decode_state(cfg, B, max_len, device=dev)
        out = []
        for b in range(B):
            logits, cache = bundle.prefill(params, {
                "tokens": torch.from_numpy(text[b:b + 1]).to(dev),
                "frontend": patches[b:b + 1]})
            assert cache[0]["k"].shape[2] == F_ + VLM_TEXT
            out.append(logits[:, -1])
            row = list(range(1 + b * mb, 1 + (b + 1) * mb))
            _install_slot_paged(state, cache, b, F_ + VLM_TEXT, 0, row, 0, 16)
        for t in range(steps):
            state["token"] = torch.from_numpy(forced[t][:, None]).to(dev)
            logits, state = bundle.decode(params, state)
            out.append(logits[:, 0])
        runs[name] = torch.cat(out).float()
        launches[name] = flash_attention.launches - before
        del state, cache
    del params
    torch.cuda.empty_cache()
    assert launches["kernels"] == B * base.num_layers, launches
    assert launches["plain"] == 0, launches
    compare_logits("vlm_model", VLM_ARCH, runs, layers=base.num_layers,
                   frontend_tokens=F_, text_tokens=VLM_TEXT,
                   decode_steps=steps, flash_launches=launches["kernels"])


def encdec_state(cfg, cache, dev):
    """A dense decode state of ``ENCDEC['max_len']`` from an
    ``encdec_prefill``'s caches: the self K/V into the first rows, the
    cross K/V whole, every row at the prompt's end."""
    from repro_torch.models.api import init_decode_state
    state = init_decode_state(cfg, ENCDEC["batch"], ENCDEC["max_len"],
                              kv="dense", device=dev)
    S = cache["self"]["k"].shape[2]
    for k in ("k", "v"):
        state["cache"]["self"][k][:, :, :S] = cache["self"][k]
        state["cache"]["cross"][k].copy_(cache["cross"][k])
    state["pos"][:] = S
    return state


def encdec_model_phase(wrappers, dev):
    """whisper-small at full width and depth: 8 rows of 1500 stub frames
    (normal x 0.02, seed 0) and a 4-token prompt through
    ``encdec_prefill`` (the encoder and the decoder's cross-attention on
    flash at ``causal=0``), then a dense state of max_len 448 built from
    its caches and 124 greedy decode steps (the self-attention on the
    dense decode kernel at G = 1; the cross-attention plain, as the
    reference's).  The plain path (attention "chunked") is then
    teacher-forced with the kernel path's tokens: logits at the prefill
    and at every step within LOGIT_TOL.  Launches of the kernel path's
    run are counted (flash 2 a decoder layer and 1 an encoder layer;
    dense decode a layer a step).  Reported: the encoder's, the prefill's
    and a decode step's ms and the decode tokens/s.  Returns the
    launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    base = get_config(ENCDEC_ARCH)
    on = dataclasses.replace(base, attn_impl="pallas", norm_impl="pallas")
    off = dataclasses.replace(base, attn_impl="chunked", norm_impl="jnp")
    params = build_model(on).init(0, device=dev)
    rng = np.random.default_rng(4)
    B, S, steps = ENCDEC["batch"], ENCDEC["prompt"], ENCDEC["steps"]
    frames = (torch.from_numpy(rng.normal(
        size=(B, base.frontend_tokens, base.d_model)).astype(np.float32))
        * 0.02).to(dev, torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(
        0, base.vocab_size, size=(B, S)).astype(np.int32)).to(dev)
    batch = {"tokens": prompt, "frontend": frames}
    runs, tokens = {}, []
    for name, cfg in (("kernels", on), ("plain", off)):
        bundle = build_model(cfg)
        if name == "kernels":
            _zero(wrappers)
        logits, cache = bundle.prefill(params, batch)
        state = encdec_state(cfg, cache, dev)
        out = [logits[:, -1]]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for t in range(steps):
            if name == "kernels":
                state["token"] = out[-1].argmax(-1, keepdim=True).to(
                    torch.int32)
                tokens.append(state["token"])
            else:
                state["token"] = tokens[t]
            logits, state = bundle.decode(params, state)
            out.append(logits[:, 0])
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
        if name == "kernels":
            launches = _launches(wrappers)
            step_ms = time_ms(lambda: bundle.decode(params, state), n=10)
            encode_ms = time_ms(lambda: encdec.encode(params, cfg, frames),
                                n=5)
            prefill_ms = time_ms(lambda: bundle.prefill(params, batch), n=5)
            kern_s = decode_s
        runs[name] = torch.stack(out, dim=1).float()       # (B, steps+1, V)
        del state, cache
    del params
    torch.cuda.empty_cache()
    enc, dec = base.encoder_layers, base.num_layers
    assert launches["flash_attention"] == enc + 2 * dec, launches
    assert launches["decode_attention"] == dec * steps, launches
    for w in ("paged_decode_attention", "paged_verify_attention",
              "rmsnorm_fused", "grouped_matmul", "ssd_scan"):
        assert launches[w] == 0, launches
    at_prefill = check_close("encdec_model/prefill", runs["kernels"][:, 0],
                             runs["plain"][:, 0], LOGIT_TOL)
    compare_logits("encdec_model", ENCDEC_ARCH,
                   {k: v.reshape(-1, v.shape[-1]) for k, v in runs.items()},
                   encoder_layers=enc, decoder_layers=dec, batch=B,
                   frames=base.frontend_tokens, prompt=S, decode_steps=steps,
                   max_len=ENCDEC["max_len"],
                   prefill_max_abs_err=at_prefill,
                   encode_ms=encode_ms, prefill_ms=prefill_ms,
                   decode_step_ms=step_ms,
                   decode_tok_per_s=B * steps / kern_s, launches=launches)
    return launches


def pilot_families_phase(wrappers, vlm_streams):
    """One pilot on the card binds whisper-small's "prefill" image (8 rows
    of 1500 frames, a 4-token prompt), then its "decode" image (a dense
    state of max_len 448, 16 steps), then llava's "serve" image, which it
    prefetched while the decode payload ran.  Gates: all three exit 0;
    the serve payload's streams bitwise ``vlm_serve``'s, with the gates of
    every serve run; its bind a prefetched cache hit; memory back within
    ``PILOT_MEMORY_SLACK`` after the drain.  Reported: each bind's
    seconds.  Returns each payload engine's launches (the serve payload's
    engine)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.cluster import ClusterSim
    from repro_torch.core.images import PayloadImage
    from repro_torch.core.pilot import PilotConfig
    from repro_torch.launch.serve import KERNEL_FLAGS, expected_tokens
    trace = serve_trace(VLM_ARCH)
    images = [
        PayloadImage(ENCDEC_ARCH, f"custom:{ENCDEC['prompt']}x"
                     f"{ENCDEC['batch']}", "prefill", smoke=False,
                     flags=KERNEL_FLAGS),
        PayloadImage(ENCDEC_ARCH, f"custom:{ENCDEC['max_len']}x"
                     f"{ENCDEC['batch']}", "decode", smoke=False,
                     flags=KERNEL_FLAGS),
        PayloadImage(VLM_ARCH, f"custom:{SERVE['max_len']}x{SERVE['slots']}",
                     "serve", smoke=False, flags=KERNEL_FLAGS)]
    specs = [({}, 1), ({}, 16),
             ({"trace": trace, "max_len": SERVE["max_len"],
               "slots": SERVE["slots"]}, 100_000)]
    mem_before = allocated_bytes()
    _zero(wrappers)
    t0 = time.monotonic()
    sim = ClusterSim(device="cuda")
    tids = [sim.repo.submit(img, n_steps=n, payload_spec=spec,
                            prefetch_hint=images[i + 1]
                            if i + 1 < len(images) else None)
            for i, (img, (spec, n)) in enumerate(zip(images, specs))]
    (sl,) = sim.provision(1)
    pilot = sim.spawn_pilot(sl, PilotConfig(max_payloads=4, idle_grace=2.0))
    drained = sim.run_until_drained(timeout=600.0)
    sim.join_all(timeout=30.0)
    wall = time.monotonic() - t0
    assert drained, sim.repo.stats()
    assert sim.registry.prefetch(images[2], "cuda").wait(300.0)
    torch.cuda.synchronize()
    total = _launches(wrappers)
    report = []
    for i, (tid, img) in enumerate(zip(tids, images)):
        r = sim.repo.result(tid)
        h = pilot.history[i]
        tel = r.telemetry
        assert r.exitcode == 0, (img.arch, img.mode, tel.get("error"))
        report.append({"arch": img.arch, "mode": img.mode,
                       "bind_seconds": h.get("bind_seconds"),
                       "bind_cached": h.get("bind_cached"),
                       "prefetch_started": h.get("prefetch_started"),
                       "steps": tel.get("steps"),
                       "step_times": tel.get("step_times"),
                       "step_graph": tel.get("step_graph")})
    # the decode image's steps replayed its payload state's graph
    assert report[1]["step_graph"] is True, report[1]
    serve_tel = sim.repo.result(tids[2]).telemetry
    sv, eng = serve_tel["serve"], serve_tel["engine"]
    got = {int(rid): t for rid, t in serve_tel["tokens"].items()}
    want = {e["rid"]: expected_tokens(e, SERVE["max_len"]) for e in trace}
    assert {rid: len(t) for rid, t in got.items()} == want
    assert sv["d2h_transfers"] == sv["decode_steps"] > 0
    assert eng["block_leaks"] == 0 and eng["step_graph"]
    assert eng["decode_graph"] and eng["prefill_graph"], eng
    _same_streams("pilot_families", got, vlm_streams)
    assert pilot.history[2]["bind_cached"] is True, pilot.history[2]
    launches = {w.__name__: eng["launches"].get(w.__name__, 0)
                for w in wrappers}
    layers = get_config(VLM_ARCH).num_layers
    assert launches["flash_attention"] == layers * len(trace), launches
    del sim, pilot
    mem_after = allocated_bytes()
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    say({"phase": "pilot_families", "wall_s": wall, "payloads": report,
         "serve": {k: sv[k] for k in ("tok_per_s", "ttft_p50_s",
                                      "decode_steps", "completed")},
         "itl_p99_s": eng["itl_p99_s"],
         "streams_equal_vlm_serve": len(got),
         "engine_launches": launches, "all_launches": total,
         "memory_allocated": {"before": mem_before, "after": mem_after,
                              "slack": PILOT_MEMORY_SLACK}})
    return launches


# --------------------------------------------------------------------------
# tensor-parallel serving: a (1, 2) mesh of two ranks on the one card
# --------------------------------------------------------------------------

class _ShapeRecorder:
    """Stands in a kernel wrapper's module attribute: records the shapes
    of the first ``n`` arguments under ``name``, then calls the wrapper.
    ``launches`` reads and writes the wrapper's own count (the wrapper
    adds to it through its module-level name)."""

    def __init__(self, wrapper, name, n, seen):
        self.wrapper, self.name, self.n, self.seen = wrapper, name, n, seen

    def __call__(self, *a, **k):
        self.seen.setdefault(self.name, set()).add(
            " ".join(str(tuple(t.shape)) for t in a[:self.n]))
        return self.wrapper(*a, **k)

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, n):
        self.wrapper.launches = n


def kernel_shapes():
    """A context in which each attention and norm kernel wrapper records
    the shapes it is called with, by wrapper name (q's and the pools' or
    k's; x's for RMSNorm).  The model code imports the wrappers at each
    call, so the module attributes are what it calls; the launch counts
    stay the wrappers' own.  Graph replays run no Python: a graphed step's
    shapes are those of its capture and warm-up steps."""
    import contextlib
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops

    @contextlib.contextmanager
    def record():
        seen = {}
        patched = []
        for mod, name, n in ((pops, "paged_decode_attention", 2),
                             (pops, "paged_verify_attention", 2),
                             (fops, "flash_attention", 2),
                             (dops, "decode_attention", 2),
                             (rops, "rmsnorm_fused", 1)):
            orig = getattr(mod, name)
            setattr(mod, name, _ShapeRecorder(orig, name, n, seen))
            patched.append((mod, name, orig))
        try:
            yield seen
        finally:
            for mod, name, orig in patched:
                setattr(mod, name, orig)
    return record()


def tp_churn(vocab):
    """The reference battery's churn: TP_CHURN requests sharing one
    40-token prompt (two full 16-token blocks), 4 new tokens each."""
    base = (np.arange(40) % (vocab - 2) + 2).astype(np.int32)
    return [{"rid": 1000 + i, "prompt": base.tolist(), "max_new_tokens": 4}
            for i in range(TP_CHURN)]


def tp_run(phase, wrappers, arch, mesh, trace, load=SERVE, churn=False,
           cfg=None, **kw):
    """``serve_direct``'s engine (`build_engine`, weights from seed 0) of
    ``arch`` (or ``cfg``) on ``mesh`` (None: one device) answering
    ``trace``, then the churn when asked, with every launch count set to 0
    just before and read just after (and right after the build:
    ``build_launches``, the construction's own, its column checks
    included) and each kernel's call shapes recorded.  Gates: every
    request's full token count, one device->host copy a step, no leaked
    block.  Returns a record: streams, launches, shapes, stats, the bytes
    on each device of the mesh, the placement of an MoE slot's up/gate."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engine, expected_tokens
    from repro_torch.runtime import sharding
    from repro_torch.serving.engine import Request
    cfg = cfg or get_config(arch)
    extra = tp_churn(cfg.vocab_size) if churn else []
    for w in wrappers:
        w.launches = 0
    with kernel_shapes() as shapes:
        before = torch.cuda.memory_allocated()
        eng = build_engine(cfg, load["slots"], load["max_len"],
                           seed=load["seed"], device="cuda", mesh=mesh, **kw)
        torch.cuda.synchronize()
        built_bytes = torch.cuda.memory_allocated() - before
        build_launches = {w.__name__: w.launches for w in wrappers}
        stats = eng.run_trace(trace)
        for e in extra:
            eng.submit(Request(rid=e["rid"],
                               prompt=np.asarray(e["prompt"], np.int32),
                               max_new_tokens=e["max_new_tokens"]))
        eng.run()
        torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    streams = {rid: list(r.tokens) for rid, r in sorted(eng.done.items())}
    want = {e["rid"]: expected_tokens(e, load["max_len"])
            for e in list(trace) + extra}
    assert {rid: len(t) for rid, t in streams.items()} == want, phase
    assert eng.d2h_transfers == eng.steps > 0, phase
    leaks = eng.block_leaks()
    assert leaks == 0, (phase, leaks)
    kvb = eng.kv_pool_bytes()
    held = eng.device_bytes()
    pools = held["kv_pool"][0]
    moe = next((sl["ffn"] for sl in eng.params.group(0)
                if "router" in sl.get("ffn", {})), {})
    rec = {"phase": phase, "arch": arch, "streams": streams,
           "launches": launches, "build_launches": build_launches,
           "device_bytes": held,
           # the KV pools' share on the lead device (None: no pool)
           "pool_share": pools[0] / sum(pools) if sum(pools) else None,
           "moe_placement": {k: type(v).__name__ for k, v in moe.items()
                             if k in ("up", "gate")},
           "expert_rows": getattr(eng.params, "expert_rows", 1),
           "shapes": {k: sorted(v) for k, v in shapes.items()},
           "steps": eng.steps, "d2h_transfers": eng.d2h_transfers,
           "prefix_hit_tokens": eng.prefix_hit_tokens,
           "kv_share": kvb["kv_pool_bytes_per_device"] / kvb["kv_pool_bytes"],
           **kvb, **{k: stats[k] for k in (
               "tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
               "decode_steps", "step_graph", "spec", "acceptance_rate",
               "mesh_shape", "mesh_devices", "mesh_whole_leaves",
               "graph_warm_launches", *GRAPH_KEYS)}}
    rec["engine"] = eng
    rec["built_bytes"] = built_bytes
    return rec


def engine_rows(load=SERVE, spec_k=4, cfg=None):
    """The row counts a one-shot engine of ``load`` multiplies its column
    leaves by (`ServeEngine`'s own list): 1 (the admission's logits), the
    slots (a step), slots x (spec_k + 1) (a verify burst), every bucket,
    and an MoE ``cfg``'s capacity at every bucket."""
    from repro_torch.models import moe
    from repro_torch.serving.engine import admit_buckets
    buckets = admit_buckets(load["max_len"])
    caps = ({moe._capacity(cfg, b) for b in buckets}
            if cfg is not None and cfg.moe is not None else set())
    return sorted({1, load["slots"], load["slots"] * (spec_k + 1),
                   *buckets, *caps})


def gemm_diagnostic(params, mesh, rows):
    """Each column-parallel leaf of ``params`` at full width (the embedding
    where it is the tied head), split in two as the mesh splits it: whether each rank's product ``x @ W[:, r]`` is
    bitwise ``(x @ W)[:, r]`` at M = 8, at M = 1023 and at every row count
    the engine takes (``rows``), by (leaf, shape)."""
    from repro_torch.runtime import sharding
    out = {}
    tree = params.tree()
    dims = sharding.serve_param_shardings(tree, mesh)

    def visit(path, t):
        dim = sharding._get(dims, path)
        name = sharding._leaf_name(path)
        key = f"{name} {tuple(t.shape)}"
        if dim is None or key in out or (name == "embed" and "head" in tree):
            return                  # an untied embedding is only looked up
        parts = [c.contiguous() for c in torch.chunk(t, 2, dim)]
        out[key] = {"M=8": sharding.slices_exact(name, t, parts, (8,)),
                    "M=1023": sharding.slices_exact(name, t, parts, (1023,)),
                    "engine_rows": sharding.slices_exact(name, t, parts,
                                                         rows)}
        if name in ("up", "gate") and t.dim() == 4:
            # an MoE leaf: each product the engine runs on its own
            for label, fn in (("grouped_matmul", sharding._bucket_product),
                              ("torch.matmul", sharding._decode_product)):
                out[key][label] = product_exact(fn, t[0],
                                                [p[0] for p in parts], rows)
    sharding.map_with_path(visit, tree)
    return out


def product_exact(fn, w, parts, rows):
    """Whether ``fn(x, part)`` on each column part of ``w`` (E, D, F) is
    bitwise ``fn(x, w)``'s columns, for a random bf16 x (1, M, D) at every
    M in ``rows``."""
    gen = torch.Generator(device=w.device)
    gen.manual_seed(0)
    for m in rows:
        x = torch.randn((1, m, w.shape[1]), generator=gen,
                        device=w.device).to(w.dtype)
        full, lo = fn(x, w), 0
        for p in parts:
            n = p.shape[-1]
            if not torch.equal(fn(x, p), full[..., lo:lo + n]):
                return False
            lo += n
    return True


def tp_compare(phase, single, sharded, per_rank, replicated, heads,
               smi, mesh_shape=(1, 2)):
    """The gates of a tensor-parallel phase against its single-device run
    on the same card: streams bitwise, the KV pools' bytes on each device
    at most ``TP_KV_SHARE`` of theirs in total (where there are pools: an
    SSM slot's state replicates), each kernel in ``per_rank`` launched
    twice as often (once a rank) at per-rank shapes (``heads``: {kernel:
    (single-device heads, per-rank heads)} at q's third-from-last dim) and
    each in ``replicated`` as often (the lead device's).  Prints both
    runs' tokens/s, ITL p50 and per-rank KV bytes."""
    differ = [rid for rid, t in single["streams"].items()
              if sharded["streams"].get(rid) != t]
    assert not differ, f"{phase}: streams differ: {differ}"
    if sharded["pool_share"] is not None:
        assert sharded["pool_share"] <= TP_KV_SHARE, sharded["pool_share"]
    assert sharded["mesh_shape"] == mesh_shape, sharded["mesh_shape"]
    for w in per_rank:
        n1, n2 = single["launches"][w], sharded["launches"][w]
        assert n1 > 0 and n2 == 2 * n1, (phase, w, n1, n2)
    for w in replicated:
        assert sharded["launches"][w] == single["launches"][w] > 0, (
            phase, w)
    for w, (h1, h2) in heads.items():
        for run, h in ((single, h1), (sharded, h2)):
            got = {int(s.split(")")[0].split(",")[-2]) for s in
                   run["shapes"][w]}
            assert got == {h}, (phase, w, run["phase"], run["shapes"][w])
    keys = ("tok_per_s", "itl_p50_s", "itl_p99_s", "ttft_p50_s",
            "decode_steps", "kv_pool_bytes", "kv_pool_bytes_per_device",
            "kv_share", "pool_share", "step_graph", "acceptance_rate",
            "launches", "build_launches", "shapes", "mesh_whole_leaves",
            "prefix_hit_tokens", "device_bytes", "moe_placement",
            "expert_rows")
    say({"phase": phase, "arch": sharded["arch"],
         "mesh": "x".join(map(str, mesh_shape)) + " ranks on cuda:0",
         "streams_equal": len(single["streams"]), "card": smi,
         "sharded": {k: sharded[k] for k in keys},
         "single": {k: single[k] for k in keys}})


def smi_line():
    """nvidia-smi's name and power limit of the card, one line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def tp_gmm_gate(phase, single, sharded):
    """The grouped matmul's launches in a mesh run's serving (its build's
    column checks taken off): per MoE layer and admission, ``down`` once
    on the lead device and ``up``/``gate`` once a model rank (once on the
    lead when the engine kept the leaf whole), against the one-device
    run's three."""
    w = "grouped_matmul"
    msz = sharded["mesh_shape"][1]
    per = 1 + sum(1 if kind == "Whole" else msz
                  for kind in sharded["moe_placement"].values())
    n1 = single["launches"][w] - single["build_launches"][w]
    n2 = sharded["launches"][w] - sharded["build_launches"][w]
    assert n1 > 0 and n1 % 3 == 0, (phase, n1)
    assert n2 == n1 // 3 * per, (phase, n1, n2, per,
                                 sharded["moe_placement"])
    return {"single": n1, "sharded": n2, "per_layer_admission": per,
            "build_checks": sharded["build_launches"][w]}


def tp_phases(wrappers):
    """tp_serve, tp_spec, tp_mla, tp_pilot, tp_moe, tp_ssm, tp_hybrid,
    tp_disagg and tp_data (module docstring).  Returns {run: launches}
    and {run: {kernel: shapes}}."""
    from repro_torch.configs.base import get_config
    from repro_torch.runtime.mesh import serve_mesh
    smi = smi_line()
    mesh = serve_mesh((1, 2), TP_DEVICES)
    runs, shapes, seconds = {}, {}, {}

    def keep(name, rec):
        runs[name] = rec["launches"]
        shapes[name] = rec["shapes"]
        eng = rec.pop("engine")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # tp_serve: starcoder2-3b, serve's trace + the churn, graphed
    t0 = time.monotonic()
    trace = serve_trace(CODE_ARCH)
    single = tp_run("tp_serve_single", wrappers, CODE_ARCH, None, trace,
                    churn=True)
    diag = gemm_diagnostic(single["engine"].params, mesh, engine_rows())
    keep("tp_serve_single", single)
    sharded = tp_run("tp_serve", wrappers, CODE_ARCH, mesh, trace,
                     churn=True)
    dryrun_serve_check("dryrun_serve_tp", sharded["engine"], CODE_ARCH,
                       SERVE, (1, 2), sharded["built_bytes"], smi)
    keep("tp_serve", sharded)
    say({"phase": "tp_gemm_diagnostic", "arch": CODE_ARCH, "leaves": diag,
         "differ": sorted(k for k, v in diag.items()
                          if not all(v.values())),
         "kept_whole_by_engine": sharded["mesh_whole_leaves"], "card": smi})
    assert sharded["step_graph"] and single["step_graph"]
    assert sharded["prefix_hit_tokens"] > 0, sharded["prefix_hit_tokens"]
    cfg = get_config(CODE_ARCH)
    h, k = cfg.num_heads, cfg.num_kv_heads
    tp_compare("tp_serve", single, sharded,
               ("paged_decode_attention", "flash_attention"), (),
               {"paged_decode_attention": (h, h // 2),
                "flash_attention": (h, h // 2)}, smi)
    for w in ("paged_verify_attention", "decode_attention", "rmsnorm_fused",
              "grouped_matmul", "ssd_scan"):
        assert sharded["launches"][w] == 0, (w, sharded["launches"])
    serve_streams = {rid: single["streams"][rid] for rid in
                     (e["rid"] for e in trace)}
    seconds["tp_serve"] = time.monotonic() - t0

    # tp_spec: the same arch self-drafting, spec_k 3, the first 8 requests
    t0 = time.monotonic()
    load = dict(SERVE, n_requests=TP_SPEC_REQUESTS)
    spec = dict(spec="draft", spec_k=3)
    single = tp_run("tp_spec_single", wrappers, CODE_ARCH, None,
                    trace[:TP_SPEC_REQUESTS], load=load, **spec)
    keep("tp_spec_single", single)
    sharded = tp_run("tp_spec", wrappers, CODE_ARCH, mesh,
                     trace[:TP_SPEC_REQUESTS], load=load, **spec)
    keep("tp_spec", sharded)
    assert sharded["spec"] == "draft", sharded["spec"]
    assert sharded["spec_graph"] and single["spec_graph"]
    tp_compare("tp_spec", single, sharded,
               ("paged_decode_attention", "paged_verify_attention",
                "flash_attention"), (),
               {"paged_verify_attention": (h, h // 2)}, smi)
    # the one-device spec run on the eager spec pair, the same requests:
    # streams, acceptance, steps and launches (net of warm-up) the graphed
    # one-device run's
    eager = tp_run("tp_spec_eager", wrappers, CODE_ARCH, None,
                   trace[:TP_SPEC_REQUESTS], load=load, step_graph=False,
                   **spec)
    keep("tp_spec_eager", eager)
    assert not eager["spec_graph"]
    _same_streams("tp_spec_eager", eager["streams"], single["streams"])
    assert eager["acceptance_rate"] == single["acceptance_rate"]
    assert eager["decode_steps"] == single["decode_steps"]
    assert net_launches(single, single["launches"]) == eager["launches"]
    say({"phase": "tp_spec_graph_vs_eager", "arch": CODE_ARCH,
         "streams_equal": len(eager["streams"]), "acceptance_equal": True,
         "launches_equal": True, "card": smi,
         **{r["phase"]: {k: r[k] for k in ("tok_per_s", "itl_p50_s",
                                           "itl_p99_s", "ttft_p50_s",
                                           "decode_steps",
                                           "acceptance_rate")}
            for r in (single, eager)}})
    seconds["tp_spec"] = time.monotonic() - t0

    # tp_mla: minicpm3-4b, 62 layers, the first 8 requests, graphed
    t0 = time.monotonic()
    mla_trace = serve_trace(MLA_ARCH)[:TP_MLA_REQUESTS]
    load = dict(SERVE, n_requests=TP_MLA_REQUESTS)
    single = tp_run("tp_mla_single", wrappers, MLA_ARCH, None, mla_trace,
                    load=load)
    mla_diag = gemm_diagnostic(single["engine"].params, mesh, engine_rows())
    keep("tp_mla_single", single)
    sharded = tp_run("tp_mla", wrappers, MLA_ARCH, mesh, mla_trace,
                     load=load)
    keep("tp_mla", sharded)
    say({"phase": "tp_gemm_diagnostic", "arch": MLA_ARCH,
         "leaves": mla_diag,
         "differ": sorted(k for k, v in mla_diag.items()
                          if not all(v.values())),
         "kept_whole_by_engine": sharded["mesh_whole_leaves"], "card": smi})
    assert sharded["step_graph"]
    mh = get_config(MLA_ARCH).num_heads
    tp_compare("tp_mla", single, sharded, ("flash_attention",),
               ("rmsnorm_fused",), {"flash_attention": (mh, mh // 2)}, smi)
    for w in MLA_UNLAUNCHED:
        assert sharded["launches"][w] == 0, (w, sharded["launches"])
    seconds["tp_mla"] = time.monotonic() - t0

    t0 = time.monotonic()
    runs["tp_pilot"] = tp_pilot_phase(wrappers, mesh, trace, serve_streams,
                                      smi)
    seconds["tp_pilot"] = time.monotonic() - t0

    # tp_moe: granite-moe-3b-a800m, 32 layers, the first 8 requests
    t0 = time.monotonic()
    load = dict(SERVE, n_requests=TP_FAMILY_REQUESTS)
    moe_cfg = get_config(MOE_ARCH)
    moe_trace = serve_trace(MOE_ARCH)[:TP_FAMILY_REQUESTS]
    moe_single = tp_run("tp_moe_single", wrappers, MOE_ARCH, None,
                        moe_trace, load=load)
    moe_diag = gemm_diagnostic(moe_single["engine"].params, mesh,
                               engine_rows(load, cfg=moe_cfg))
    keep("tp_moe_single", moe_single)
    sharded = tp_run("tp_moe", wrappers, MOE_ARCH, mesh, moe_trace,
                     load=load)
    keep("tp_moe", sharded)
    say({"phase": "tp_gemm_diagnostic", "arch": MOE_ARCH,
         "leaves": moe_diag,
         "differ": sorted(k for k, v in moe_diag.items()
                          if not all(v.values())),
         "kept_whole_by_engine": sharded["mesh_whole_leaves"], "card": smi})
    assert sharded["step_graph"] and moe_single["step_graph"]
    h = moe_cfg.num_heads
    tp_compare("tp_moe", moe_single, sharded,
               ("paged_decode_attention", "flash_attention"),
               ("rmsnorm_fused",),
               {"paged_decode_attention": (h, h // 2),
                "flash_attention": (h, h // 2)}, smi)
    say({"phase": "tp_moe_grouped_matmul",
         **tp_gmm_gate("tp_moe", moe_single, sharded), "card": smi})
    for w in ("paged_verify_attention", "decode_attention", "ssd_scan"):
        assert sharded["launches"][w] == 0, (w, sharded["launches"])
    seconds["tp_moe"] = time.monotonic() - t0

    # tp_ssm: mamba2-370m, 48 layers, the first 8 requests
    t0 = time.monotonic()
    ssm_trace = serve_trace(SSM_ARCH)[:TP_FAMILY_REQUESTS]
    single = tp_run("tp_ssm_single", wrappers, SSM_ARCH, None, ssm_trace,
                    load=load)
    keep("tp_ssm_single", single)
    sharded = tp_run("tp_ssm", wrappers, SSM_ARCH, mesh, ssm_trace,
                     load=load)
    keep("tp_ssm", sharded)
    tp_compare("tp_ssm", single, sharded, (), ("ssd_scan", "rmsnorm_fused"),
               {}, smi)
    for w in ("flash_attention", "paged_decode_attention",
              "paged_verify_attention", "decode_attention",
              "grouped_matmul"):
        assert sharded["launches"][w] == 0, (w, sharded["launches"])
    say({"phase": "tp_ssm_state", "arch": SSM_ARCH,
         "state_bytes_by_device": sharded["device_bytes"]["state"],
         "params_bytes_by_device": sharded["device_bytes"]["params"],
         "kept_whole_by_engine": sharded["mesh_whole_leaves"], "card": smi})
    seconds["tp_ssm"] = time.monotonic() - t0

    # tp_hybrid: jamba at full width, 8 of 32 layers, the first 8
    # requests; the one-device engine is freed before the mesh one is made
    t0 = time.monotonic()
    hcfg = hybrid_config()
    h_trace = serve_trace(HYBRID_ARCH)[:TP_FAMILY_REQUESTS]
    single = tp_run("tp_hybrid_single", wrappers, HYBRID_ARCH, None,
                    h_trace, load=load, cfg=hcfg)
    keep("tp_hybrid_single", single)
    sharded = tp_run("tp_hybrid", wrappers, HYBRID_ARCH, mesh, h_trace,
                     load=load, cfg=hcfg)
    keep("tp_hybrid", sharded)
    h = hcfg.num_heads
    tp_compare("tp_hybrid", single, sharded,
               ("paged_decode_attention", "flash_attention"),
               ("ssd_scan", "rmsnorm_fused"),
               {"paged_decode_attention": (h, h // 2),
                "flash_attention": (h, h // 2)}, smi)
    say({"phase": "tp_hybrid_grouped_matmul", "reduced": "8 of 32 layers",
         **tp_gmm_gate("tp_hybrid", single, sharded),
         "kept_whole_by_engine": sharded["mesh_whole_leaves"], "card": smi})
    seconds["tp_hybrid"] = time.monotonic() - t0

    t0 = time.monotonic()
    runs.update(tp_disagg_phase(wrappers, mesh, trace, serve_streams, smi))
    seconds["tp_disagg"] = time.monotonic() - t0

    # tp_data: granite on a (2, 2) mesh of four ranks on the card
    t0 = time.monotonic()
    mesh4 = serve_mesh((2, 2), TP_DATA_DEVICES)
    sharded = tp_run("tp_data", wrappers, MOE_ARCH, mesh4, moe_trace,
                     load=load)
    dryrun_serve_check("dryrun_serve_data", sharded["engine"], MOE_ARCH,
                       load, (2, 2), sharded["built_bytes"], smi)
    keep("tp_data", sharded)
    h = moe_cfg.num_heads
    tp_compare("tp_data", moe_single, sharded,
               ("paged_decode_attention", "flash_attention"),
               ("rmsnorm_fused",),
               {"paged_decode_attention": (h, h // 2),
                "flash_attention": (h, h // 2)}, smi, mesh_shape=(2, 2))
    say({"phase": "tp_data_grouped_matmul",
         **tp_gmm_gate("tp_data", moe_single, sharded),
         "expert_rows": sharded["expert_rows"], "card": smi})
    seconds["tp_data"] = time.monotonic() - t0
    say({"phase": "tp_all", "seconds": seconds,
         "total_seconds": sum(seconds.values())})
    return runs, shapes


def tp_disagg_phase(wrappers, mesh, trace, unified, smi):
    """starcoder2-3b's split roles on the mesh and on one device: a
    prefill-role engine of each answers serve's trace and exports every
    request's handoff (one host pull each, counted), then decode-role
    engines resume them in the pairings (1, 2) -> (1, 2), (1, 2) -> one
    device and one device -> (1, 2).  Gates: every stream bitwise
    ``unified`` (tp_serve's unified one-device run), the mesh export's
    wire buffers the one-device export's bit for bit, flash per rank in
    the mesh prefill role (twice the one-device count) and no decode
    kernel there, paged decode per rank in the mesh decode role and no
    flash there, the decode engines graphed, no leaked block.  Prints
    each side's export and import ms (p50).  Returns {run: launches}."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Request
    cfg = get_config(CODE_ARCH)
    kw = dict(seed=SERVE["seed"], device="cuda")
    runs, rec = {}, {}

    def counted(fn):
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {w.__name__: w.launches for w in wrappers}

    def export(m):
        eng = build_engine(cfg, SERVE["slots"], SERVE["max_len"],
                           role="prefill", mesh=m, **kw)
        for e in trace:
            eng.submit(Request(rid=e["rid"],
                               prompt=np.asarray(e["prompt"], np.int32),
                               max_new_tokens=e["max_new_tokens"]))
        real, pulls = torch.Tensor.cpu, []

        def counting(self, *a, **k):
            pulls.append(tuple(self.shape))
            return real(self, *a, **k)
        torch.Tensor.cpu = counting
        try:
            stats = eng.run()
        finally:
            torch.Tensor.cpu = real
        assert len(pulls) == len(trace), ("tp_disagg", len(pulls))
        assert eng.block_leaks() == 0
        return {rid: r.handoff for rid, r in eng.done.items()}, stats

    def resume(m, handoffs):
        eng = build_engine(cfg, SERVE["slots"], SERVE["max_len"],
                           role="decode", mesh=m, **kw)
        for e in trace:
            eng.submit(Request(rid=e["rid"],
                               prompt=np.asarray(e["prompt"], np.int32),
                               max_new_tokens=e["max_new_tokens"],
                               handoff=handoffs[e["rid"]]))
        stats = eng.run()
        assert stats["step_graph"], "tp_disagg: the decode role ran eagerly"
        assert eng.block_leaks() == 0
        assert eng.d2h_transfers == eng.steps > 0
        streams = {rid: list(r.tokens) for rid, r in eng.done.items()}
        return streams, stats

    (one_h, one_st), one_l = counted(lambda: export(None))
    (mesh_h, mesh_st), mesh_l = counted(lambda: export(mesh))
    gc.collect()
    torch.cuda.empty_cache()
    runs["tp_disagg_prefill_single"], runs["tp_disagg_prefill"] = (one_l,
                                                                  mesh_l)
    for rid, h in mesh_h.items():
        h1 = one_h[rid]
        assert h.nbytes == h1.nbytes, (rid, h.nbytes, h1.nbytes)
        for a, b in zip(h.blocks, h1.blocks):
            assert all(np.array_equal(a[k], b[k]) for k in b), rid
    assert one_l["flash_attention"] > 0
    assert mesh_l["flash_attention"] == 2 * one_l["flash_attention"], (
        one_l, mesh_l)
    for w in ("paged_decode_attention", "paged_verify_attention"):
        assert mesh_l[w] == one_l[w] == 0, (w, mesh_l)
    p50 = lambda v: float(np.median(v)) if v else None  # noqa: E731
    rec["export_ms_p50"] = {"single": p50(one_st["handoff_export_ms"]),
                            "mesh": p50(mesh_st["handoff_export_ms"])}
    rec["handoff_bytes_total"] = int(sum(one_st["handoff_bytes"]))
    rec["import_ms_p50"] = {}
    decode = {}
    for name, m, handoffs in (("mesh_to_mesh", mesh, mesh_h),
                              ("mesh_to_one", None, mesh_h),
                              ("one_to_mesh", mesh, one_h)):
        (streams, st), launches = counted(lambda: resume(m, handoffs))
        gc.collect()
        torch.cuda.empty_cache()
        differ = [rid for rid, t in unified.items() if streams.get(rid) != t]
        assert not differ, f"tp_disagg {name}: streams differ: {differ}"
        assert launches["flash_attention"] == 0, (name, launches)
        decode[name] = launches
        runs[f"tp_disagg_{name}"] = launches
        rec["import_ms_p50"][name] = p50(st["handoff_import_ms"])
        rec[f"{name}_tok_per_s"] = st["tok_per_s"]
    n1 = decode["mesh_to_one"]["paged_decode_attention"]
    for name in ("mesh_to_mesh", "one_to_mesh"):
        n2 = decode[name]["paged_decode_attention"]
        assert n1 > 0 and n2 == 2 * n1, (name, n1, n2)
    say({"phase": "tp_disagg", "arch": CODE_ARCH, "mesh": "1x2 ranks on "
         "cuda:0", "streams_equal_unified": len(unified),
         "exports_bitwise_single": len(mesh_h), "host_pulls_per_export": 1,
         **rec, "launches": runs, "card": smi})
    return runs


def tp_rank_kernels(rng, dev):
    """Each kernel a tensor-parallel rank runs, at a rank's shapes, before
    any mesh engine is made: the grouped matmul on each half of up's
    columns (``TP_RANK_GMM``), flash at granite's 1023-token admission and
    paged decode at its 8 slots, at 12 of its 24 heads (4 of 8 kv heads).
    Gates: the two halves' outputs bitwise the whole call's, each rank's
    output within the tolerance of its plain version.  Each rank's call
    timed as its kernel's entry is (``ms`` back to back, ``device_ms``
    from a graph of 50 calls) beside its plain version, its bound and its
    library call.  Returns {kernel: {case: record}}."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.grouped_matmul.ops import (
        bucket_matmul, grouped_matmul_plain)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    smi = smi_line()
    out = {"grouped_matmul": {}, "flash_attention": {},
           "paged_decode_attention": {}}
    for name, (E, C, D, F_) in TP_RANK_GMM.items():
        b = bf16(rng, (E, C, D), dev)
        w = bf16(rng, (E, D, F_), dev, scale=D ** -0.5)
        halves = [c.contiguous() for c in torch.chunk(w, 2, dim=-1)]
        whole = bucket_matmul(b, w)
        got = [bucket_matmul(b, h) for h in halves]
        exact = torch.equal(torch.cat(got, dim=-1), whole)
        assert exact, f"tp_rank_kernels {name}: halves differ from the whole"
        h, T, Fh = halves[0], E * C, F_ // 2
        err = check_close(f"tp_gmm/{name}", got[0], grouped_matmul_plain(
            b.reshape(T, D), h, [C] * E).reshape(E, C, Fh), GMM_TOL)

        def bmm_f32(b=b, h=h):
            return torch.bmm(b, h, out_dtype=torch.float32)
        out["grouped_matmul"][name] = {
            "halves_bitwise_whole": exact, "max_abs_err": err,
            "ms": time_ms(lambda: bucket_matmul(b, h), n=20),
            "device_ms": graph_ms(lambda: bucket_matmul(b, h)),
            "whole_call_device_ms": graph_ms(lambda: bucket_matmul(b, w)),
            "plain_ms": time_ms(lambda: grouped_matmul_plain(
                b.reshape(T, D), h, [C] * E), n=3),
            "library_ms": time_ms(bmm_f32, n=20),
            "library_device_ms": graph_ms(bmm_f32),
            **bound(T * D * 2 + E * D * Fh * 2 + T * Fh * 4,
                    2 * T * D * Fh, BF16_FLOPS), "card": smi}
        del b, w, halves, whole, got
    H, K, Dh, S = 24, 8, 64, 1023
    q, k, v = _attn_case(rng, dev, 1, S, H, K, Dh)
    whole = flash_attention(q, k, v)
    ranks = [(q[:, :, r * H // 2:(r + 1) * H // 2].contiguous(),
              k[:, :, r * K // 2:(r + 1) * K // 2].contiguous(),
              v[:, :, r * K // 2:(r + 1) * K // 2].contiguous())
             for r in range(2)]
    got = [flash_attention(*a) for a in ranks]
    assert torch.equal(torch.cat(got, dim=2), whole), "tp_rank flash"
    rq, rk, rv = ranks[0]
    qt, kt, vt = (t.transpose(1, 2) for t in ranks[0])

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    nbytes, flops = flash_work(1, S, H // 2, K // 2, Dh)
    out["flash_attention"]["granite_rank (1,1023,12/4,64)"] = {
        "ranks_bitwise_whole": True,
        "max_abs_err": check_close("tp_flash/granite_rank", got[0],
                                   flash_attention_plain(rq, rk, rv),
                                   ATTN_TOL, ROW_REL_TOL),
        "ms": time_ms(lambda: flash_attention(rq, rk, rv), n=20),
        "device_ms": graph_ms(lambda: flash_attention(rq, rk, rv)),
        "plain_ms": time_ms(lambda: flash_attention_plain(rq, rk, rv), n=20),
        "library_ms": time_ms(sdpa, n=20), "library_device_ms": graph_ms(sdpa),
        **bound(nbytes, flops, BF16_FLOPS), "card": smi}
    c = dict(PAGED_MAIN, H=H, K=K)
    q, kp, vp, tables, lens = paged_inputs(rng, dev, **c)
    whole = paged_decode_attention(q, kp, vp, tables, lens)
    ranks = [(q[:, r * H // 2:(r + 1) * H // 2].contiguous(),
              kp[:, :, r * K // 2:(r + 1) * K // 2].contiguous(),
              vp[:, :, r * K // 2:(r + 1) * K // 2].contiguous(), tables, lens)
             for r in range(2)]
    got = [paged_decode_attention(*a) for a in ranks]
    assert torch.equal(torch.cat(got, dim=1), whole), "tp_rank paged"
    live = sum(c["lens"])
    blocks_read = sum(-(-n // c["bs"]) for n in c["lens"])
    nbytes = (live * K // 2 * Dh * 2 * 2 + 2 * c["B"] * H // 2 * Dh * 2
              + blocks_read * 4 + c["B"] * 4)
    out["paged_decode_attention"]["granite_rank (8,12/4,64)"] = {
        "ranks_bitwise_whole": True,
        "max_abs_err": check_close(
            "tp_paged/granite_rank", got[0],
            paged_decode_attention_plain(*ranks[0]), ATTN_TOL, ROW_REL_TOL),
        "ms": time_ms(lambda: paged_decode_attention(*ranks[0])),
        "device_ms": graph_ms(lambda: paged_decode_attention(*ranks[0])),
        "plain_ms": time_ms(lambda: paged_decode_attention_plain(*ranks[0])),
        "library_ms": None,
        **bound(nbytes, 4 * live * H // 2 * Dh, BF16_FLOPS), "card": smi}
    say({"phase": "tp_rank_kernels", **out})
    return out


def tp_pilot_phase(wrappers, mesh, trace, direct, smi):
    """One pilot holding a slice of the (1, 2) mesh late-binds the
    full-width starcoder2-3b serve image of that mesh shape and answers
    serve's trace: exit 0, streams bitwise tp_serve's single-device run's,
    the mesh's shape and devices in its telemetry, per-rank KV bytes at
    most ``TP_KV_SHARE`` of the total, one device->host copy a step, no
    leaked block, the captured step, paged decode and flash launched by
    its engine, memory back within ``PILOT_MEMORY_SLACK``."""
    from repro_torch.core.cluster import ClusterSim
    from repro_torch.core.images import PayloadImage
    from repro_torch.core.pilot import PilotConfig
    from repro_torch.launch.serve import KERNEL_FLAGS
    mem_before = allocated_bytes()
    sim = ClusterSim(device="cuda")
    img = PayloadImage(CODE_ARCH, f"custom:{SERVE['max_len']}x"
                       f"{SERVE['slots']}", "serve", smoke=False,
                       flags=KERNEL_FLAGS, mesh_shape=(1, 2))
    for w in wrappers:
        w.launches = 0
    t0 = time.monotonic()
    tid = sim.repo.submit(img, n_steps=100_000, payload_spec={
        "trace": trace, "max_len": SERVE["max_len"],
        "slots": SERVE["slots"]})
    (s,) = sim.provision(1, mesh=mesh)
    pilot = sim.spawn_pilot(s, PilotConfig(max_payloads=2, idle_grace=1.0))
    assert sim.run_until_drained(timeout=600.0)
    sim.join_all(timeout=60.0)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    r = sim.repo.result(tid)
    tel = r.telemetry
    assert r.exitcode == 0, (r.exitcode, tel.get("error"))
    sv, eng = tel["serve"], tel["engine"]
    got = {int(rid): t for rid, t in tel["tokens"].items()}
    differ = [rid for rid, t in direct.items() if got.get(rid) != t]
    assert not differ, f"tp_pilot: streams differ from tp_serve's: {differ}"
    assert sv["mesh_shape"] == (1, 2) and sv["mesh_devices"] == 2, sv
    share = sv["kv_pool_bytes_per_device"] / sv["kv_pool_bytes"]
    assert share <= TP_KV_SHARE, share
    assert sv["d2h_transfers"] == sv["decode_steps"] > 0
    assert eng["block_leaks"] == 0 and eng["step_graph"]
    launches = {w.__name__: eng["launches"].get(w.__name__, 0)
                for w in wrappers}
    for w in ("paged_decode_attention", "flash_attention"):
        assert launches[w] > 0, launches
    bind = pilot.history[0].get("bind_seconds")
    del sim, pilot, r, tel
    mem_after = allocated_bytes()
    assert abs(mem_after - mem_before) <= PILOT_MEMORY_SLACK, (
        mem_before, mem_after)
    say({"phase": "tp_pilot", "arch": CODE_ARCH, "wall_s": wall,
         "bind_seconds": bind,
         "tok_per_s": sv["tok_per_s"], "itl_p50_s": eng["itl_p50_s"],
         "kv_pool_bytes": sv["kv_pool_bytes"],
         "kv_pool_bytes_per_device": sv["kv_pool_bytes_per_device"],
         "streams_equal_tp_serve_single": len(direct), "launches": launches,
         "memory_allocated": {"before": mem_before, "after": mem_after},
         "card": smi})
    return launches


# --------------------------------------------------------------------------
# the dry run held against the card
# --------------------------------------------------------------------------

KV_LEAVES = frozenset({"kp", "vp", "ckvp", "kropep", "k", "v", "ckv",
                       "krope"})
DRYRUN_STEP_REPS = 10


def dryrun_serve_check(phase, eng, arch, load, mesh_shape, built_bytes, smi):
    """`run_serve_cell`'s prediction for the engine ``eng`` (``arch`` on
    ``load``'s slots and max_len, a ``mesh_shape`` mesh) against the
    tensors it holds: its parameter and KV pool bytes, in total, per
    model rank and on each device of the mesh (every data row), equal.  A column leaf the engine keeps whole on the lead
    device (`sharding.Whole`) is predicted as held (``whole``); the
    reference's convention, which splits it, is printed beside.  So is
    the rise of ``torch.cuda.memory_allocated()`` over the build, with its
    gap to the predicted params + state."""
    from repro_torch.launch.dryrun import run_serve_cell
    from repro_torch.runtime.sharding import rank_bytes as held_bytes
    msz = mesh_shape[1]
    whole = tuple(getattr(eng.params, "whole_leaves", ()))
    kw = dict(mesh_shape=mesh_shape, slots=load["slots"],
              max_len=load["max_len"], param_dtype=torch.bfloat16)
    pred = run_serve_cell(arch, whole=whole, **kw)
    ref_conv = run_serve_cell(arch, **kw)
    held = {"params": held_bytes(eng.params.tree(), msz),
            "state": held_bytes(eng.state, msz),
            "kv_pool": held_bytes(eng.state["cache"], msz, KV_LEAVES)}
    predicted_total = pred["params_bytes"] + pred["state_bytes"]
    by_device = eng.device_bytes()
    all_devices = sum(map(sum, pred["params_bytes_by_device"]
                          + pred["state_bytes_by_device"]))
    say({"phase": phase, "arch": arch, "mesh_shape": list(mesh_shape),
         "slots": load["slots"], "max_len": load["max_len"],
         "whole_leaves": pred["whole_leaves"],
         **{f"{k}_bytes_per_rank": {"predicted": pred[f"{k}_bytes_per_rank"],
                                    "held": held[k]}
            for k in held},
         "params_bytes_per_device_reference_convention":
             ref_conv["params_bytes_per_device"],
         "kept_whole_bytes": (pred["params_bytes_per_device"]
                              - ref_conv["params_bytes_per_device"]),
         **{f"{k}_bytes_by_device": {
             "predicted": pred[f"{k}_bytes_by_device"], "held": by_device[k]}
            for k in held},
         "predicted_params_plus_state": predicted_total,
         "predicted_on_all_devices": all_devices,
         "memory_allocated_rise_over_build": built_bytes,
         "build_gap_bytes": built_bytes - all_devices,
         "decode_memory_s": pred["decode_memory_s"], "card": smi})
    for k in ("params", "kv_pool"):
        assert pred[f"{k}_bytes_per_rank"] == held[k], (phase, k, pred, held)
        assert pred[f"{k}_bytes"] == sum(held[k]), (phase, k)
        assert pred[f"{k}_bytes_by_device"] == by_device[k], (
            phase, k, pred[f"{k}_bytes_by_device"], by_device[k])


def dryrun_step_phase(eng, smi):
    """One eager decode step of the engine's model (its kernel flags) over
    its slots, each prefilled with one of serve's prompts, counted under
    `op_cost.step_cost` on the card; then timed (median of
    DRYRUN_STEP_REPS after warm-up) beside its roofline bound from
    `repro_torch.launch.hw`.  Gates: counts positive, the paged decode and
    RMSNorm kernels launched, the measured time at or above the bound
    (under it, a count would be wrong).  The same step captured as the
    decode image captures it (`make_serve_step`'s default on the card) is
    timed too (``graphed_step_s``, its logits bitwise the eager step's).
    Returns the kernel launches of the counted step."""
    from repro_torch.launch import hw
    from repro_torch.launch.op_cost import step_cost
    from repro_torch.launch.steps import make_serve_step
    dev = eng.device
    trace = serve_trace(DENSE_ARCH)[:SERVE["slots"]]
    prompts = [np.asarray(e["prompt"], np.int32) for e in trace]
    state, _ = prefilled_state(eng.bundle, eng.params, eng.cfg, prompts, dev,
                               max_len=SERVE["max_len"])
    step = make_serve_step(eng.cfg, step_graph=False)
    for _ in range(3):
        step(eng.params, state)
    torch.cuda.synchronize()
    _, cost = step_cost(step, eng.params, state)
    torch.cuda.synchronize()
    times = []
    for _ in range(DRYRUN_STEP_REPS):
        t0 = time.perf_counter()
        step(eng.params, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    # the graphed step on a copy of the state, from the same position
    twin = {**state, "token": state["token"].clone(),
            "pos": state["pos"].clone(),
            "cache": [{k: v.clone() for k, v in leaf.items()}
                      for leaf in state["cache"]]}
    graphed = make_serve_step(eng.cfg)
    for _ in range(2):        # the capture's warm-up, then a replay
        want, _ = step(eng.params, state)
        got, _ = graphed(eng.params, twin)
        assert torch.equal(got, want), "dryrun_step: graphed != eager"
    g_times = []
    for _ in range(DRYRUN_STEP_REPS):
        t0 = time.perf_counter()
        graphed(eng.params, twin)
        torch.cuda.synchronize()
        g_times.append(time.perf_counter() - t0)
    del twin
    compute_s = cost.flops / hw.PEAK_FLOPS
    memory_s = cost.bytes_fused / hw.HBM_BW
    roofline_s = max(compute_s, memory_s)
    say({"phase": "dryrun_step", "arch": DENSE_ARCH, "slots": SERVE["slots"],
         "prompt_lens": [len(p) for p in prompts],
         "flops": cost.flops, "bytes_fused": cost.bytes_fused,
         "bytes_unfused": cost.bytes, "transcendentals": cost.transcendentals,
         "contraction_flops": cost.contraction_flops,
         "kernel_launches": cost.kernel_launches,
         "aten_ops": sum(cost.op_counts.values()),
         "compute_s": compute_s, "memory_s": memory_s,
         "roofline_step_s": roofline_s, "measured_step_s": step_s,
         "measured_step_s_all": times,
         "graphed_step_s": float(np.median(g_times)),
         "graphed_step_s_all": g_times,
         "roofline_fraction_of_measured": roofline_s / step_s,
         "note": "kernel launches count zero FLOPs and bytes (the "
                 "reference's custom-call convention)", "card": smi})
    assert cost.flops > 0 and cost.bytes_fused > 0, cost
    for w in ("paged_decode_attention", "rmsnorm_fused"):
        assert cost.kernel_launches.get(w, 0) > 0, cost.kernel_launches
    assert step_s >= roofline_s, (step_s, roofline_s)
    return cost.kernel_launches


def dryrun_cli_phase(smi):
    """``python -m repro_torch.launch.dryrun --arch mamba2-370m --shape
    decode_32k`` in a subprocess (the reference's own slow test's cell):
    exit 0 and a record with positive compute and memory terms and a
    boolean fit."""
    path = (ROOT / "results" / "dryrun_torch" / "pod16x16"
            / f"{SSM_ARCH}__decode_32k.json")
    path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", SSM_ARCH, "--shape", "decode_32k"],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(ROOT), env=env)
    seconds = time.monotonic() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(path.read_text())
    t = rec["roofline"]
    say({"phase": "dryrun_cli", "cell": f"{SSM_ARCH} x decode_32k",
         "seconds": seconds, "record": str(path.relative_to(ROOT)),
         "roofline": t, "memory": rec["memory"], "fits_hbm": rec["fits_hbm"],
         "flops_per_device": rec["hlo_cost"]["flops"],
         "bytes_fused_per_device": rec["hlo_cost"]["bytes_fused"],
         "run_seconds": rec["run_seconds"], "card": smi})
    assert t["compute_s"] > 0 and t["memory_s"] > 0, t
    assert isinstance(rec["fits_hbm"], bool), rec["fits_hbm"]


def dryrun_phases(smi):
    """dryrun_serve (serve's smollm-360m engine against `run_serve_cell`),
    dryrun_step on that engine, and dryrun_cli.  Returns the counted
    step's kernel launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engine
    seconds = {}
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = build_engine(get_config(DENSE_ARCH), SERVE["slots"],
                       SERVE["max_len"], seed=SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    dryrun_serve_check("dryrun_serve", eng, DENSE_ARCH, SERVE, (1, 1),
                       torch.cuda.memory_allocated() - before, smi)
    seconds["dryrun_serve"] = time.monotonic() - t0
    t0 = time.monotonic()
    launches = dryrun_step_phase(eng, smi)
    seconds["dryrun_step"] = time.monotonic() - t0
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dryrun_cli_phase(smi)
    seconds["dryrun_cli"] = time.monotonic() - t0
    say({"phase": "dryrun_all", "seconds": seconds,
         "total_seconds": sum(seconds.values())})
    return launches


def _attn_case(rng, dev, B, S, H, K, Dh):
    return (bf16(rng, (B, S, H, Dh), dev), bf16(rng, (B, S, K, Dh), dev),
            bf16(rng, (B, S, K, Dh), dev))


def _flash_plain_by_head(q, k, v, **kw):
    """`flash_attention_plain`, one KV head (and its query heads) at a
    time: the same function in a fraction of the memory at S = 8191."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    K = k.shape[2]
    G = q.shape[2] // K
    return torch.cat([flash_attention_plain(
        q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1], **kw)
        for h in range(K)], dim=2)


def arch_kernel_shapes(rng, dev, ptxas):
    """Each kernel on the new archs' main paths at their shapes: held to
    its plain version (the kernel phase's tolerances) and timed as the
    kernels line times it (``ms``, ``device_ms``, plain, one library call
    where one computes the same function, the bound).  Returns {kernel
    name: {shape name: entry}}."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, head_width)
    from repro_torch.kernels.grouped_matmul.ops import (
        bucket_matmul, grouped_matmul_plain)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused, rmsnorm_plain
    out = {"flash_attention": {}, "paged_decode_attention": {},
           "paged_verify_attention": {}, "decode_attention": {},
           "grouped_matmul": {}, "rmsnorm_fused": {}, "ssd_scan": {}}

    # flash prefill at each arch's longest admission
    flash = out["flash_attention"]
    for name, (S, H, K, Dh, window) in ARCH_FLASH.items():
        q, k, v = _attn_case(rng, dev, 1, S, H, K, Dh)
        kw = dict(window=window)
        err = check_close(f"flash/{name}", flash_attention(q, k, v, **kw),
                          _flash_plain_by_head(q, k, v, **kw), ATTN_TOL,
                          ROW_REL_TOL)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device=dev)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            if mask is None:
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        pairs = sum(min(i + 1, window or S) for i in range(S))
        nbytes = 2 * (2 * S * H * Dh + 2 * S * K * Dh)
        width = head_width(Dh)
        if width != Dh:
            # the kernel alone on inputs already padded to its instance:
            # the same work, without the wrapper's pads and output slice
            qp, kp, vp = (F.pad(t, (0, width - Dh)) for t in (q, k, v))
            instance_ms = graph_ms(
                lambda: flash_attention(qp, kp, vp, **kw), n=10)
            del qp, kp, vp
        flash[name] = {
            "instance": width, "max_abs_err": err,
            "ms": time_ms(lambda: flash_attention(q, k, v, **kw), n=10),
            "device_ms": graph_ms(lambda: flash_attention(q, k, v, **kw),
                                  n=10),
            "plain_ms": time_ms(lambda: _flash_plain_by_head(q, k, v, **kw),
                                n=2, warm=1),
            "library_ms": time_ms(sdpa, n=10),
            "library_device_ms": graph_ms(sdpa, n=10),
            **bound(nbytes, 4 * Dh * H * pairs, BF16_FLOPS)}
        if width != Dh:
            flash[name]["device_ms_on_padded_inputs"] = instance_ms
        del q, k, v, qt, kt, vt, mask
    flash["ptxas_Dh256"] = {k: v for k, v in ptxas.get("flash_prefill",
                                                       {}).items()
                            if "256" in k}

    # the last families' flash: jamba's and llava's admission (causal),
    # whisper's encoder and cross-attention (non-causal, T = 1500 frames)
    for name, (B, S, T, H, K, Dh, causal) in FAMILY_FLASH.items():
        q = bf16(rng, (B, S, H, Dh), dev)
        k, v = bf16(rng, (B, T, K, Dh), dev), bf16(rng, (B, T, K, Dh), dev)
        kw = dict(causal=causal)
        err = check_close(f"flash/{name}", flash_attention(q, k, v, **kw),
                          _flash_plain_by_head(q, k, v, **kw), ATTN_TOL,
                          ROW_REL_TOL)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        pairs = S * (S + 1) // 2 if causal else S * T
        flash[name] = {
            "causal": causal, "instance": head_width(Dh), "max_abs_err": err,
            "ms": time_ms(lambda: flash_attention(q, k, v, **kw), n=10),
            "device_ms": graph_ms(lambda: flash_attention(q, k, v, **kw),
                                  n=10),
            "plain_ms": time_ms(lambda: _flash_plain_by_head(q, k, v, **kw),
                                n=2, warm=1),
            "library_ms": time_ms(sdpa, n=10),
            "library_device_ms": graph_ms(sdpa, n=10),
            **bound(2 * (2 * B * S * H * Dh + 2 * B * T * K * Dh),
                    4 * Dh * H * B * pairs, BF16_FLOPS)}
        del q, k, v, qt, kt, vt

    # paged decode at gemma's (G = 8, Dh 256) and starcoder2's (G = 12)
    for name, (H, K, Dh) in ARCH_PAGED.items():
        c = dict(PAGED_MAIN, H=H, K=K, Dh=Dh)
        args = paged_inputs(rng, dev, **c)
        err = check_close(f"paged/{name}", paged_decode_attention(*args),
                          paged_decode_attention_plain(*args), ATTN_TOL,
                          ROW_REL_TOL)
        live = sum(c["lens"])
        nbytes = (live * K * Dh * 2 * 2 + 2 * c["B"] * H * Dh * 2
                  + sum(-(-n // c["bs"]) for n in c["lens"]) * 4
                  + c["B"] * 4)
        out["paged_decode_attention"][name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: paged_decode_attention(*args)),
            "device_ms": graph_ms(lambda: paged_decode_attention(*args)),
            "plain_ms": time_ms(lambda: paged_decode_attention_plain(*args)),
            "library_ms": None,
            **bound(nbytes, 4 * live * H * Dh, BF16_FLOPS)}

    # paged verify at a rank's heads of tp_spec and at the whole model's
    for name, (H, K, Dh) in ARCH_VERIFY.items():
        c = dict(VERIFY_MAIN, S=4, H=H, K=K, Dh=Dh)
        args = paged_inputs(rng, dev, **c)
        err = check_close(f"verify/{name}", paged_verify_attention(*args),
                          paged_verify_attention_plain(*args), ATTN_TOL,
                          ROW_REL_TOL)
        T = c["mb"] * c["bs"]
        off = np.asarray(c["lens"])
        reach = np.minimum(off + c["S"], T)
        qlen = sum(int(min(o + s + 1, T)) for o in off
                   for s in range(c["S"]))
        nbytes = (int(reach.sum()) * K * Dh * 2 * 2
                  + 2 * c["B"] * c["S"] * H * Dh * 2
                  + int((-(-reach // c["bs"])).sum()) * 4 + c["B"] * 4)
        out["paged_verify_attention"][name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: paged_verify_attention(*args)),
            "device_ms": graph_ms(lambda: paged_verify_attention(*args)),
            "plain_ms": time_ms(lambda: paged_verify_attention_plain(*args)),
            "library_ms": None,
            **bound(nbytes, 4 * H * Dh * qlen, BF16_FLOPS)}

    # dense decode over mixtral's 4096-slot rings, and at G = 1 over
    # whisper's 448-slot decoder cache
    for name, (B, T, H, K, Dh, lens) in (ARCH_DENSE, FAMILY_DENSE):
        q, kc, vc, ln = dense_inputs(rng, dev, B, T, H, K, Dh, lens)
        err = check_close(f"dense/{name}", decode_attention(q, kc, vc, ln),
                          decode_attention_plain(q, kc, vc, ln), ATTN_TOL,
                          ROW_REL_TOL)
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        mask = (torch.arange(T, device=dev)[None]
                < ln[:, None])[:, None, None]

        def sdpa_ring(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        live = sum(lens)
        out["decode_attention"][name] = {
            "lens": lens, "max_abs_err": err,
            "ms": time_ms(lambda: decode_attention(q, kc, vc, ln)),
            "device_ms": graph_ms(lambda: decode_attention(q, kc, vc, ln)),
            "plain_ms": time_ms(
                lambda: decode_attention_plain(q, kc, vc, ln)),
            "library_ms": time_ms(sdpa_ring),
            "library_device_ms": graph_ms(sdpa_ring),
            **bound(live * K * Dh * 2 * 2 + 2 * B * H * Dh * 2 + B * 4,
                    4 * live * H * Dh, BF16_FLOPS)}
        del q, kc, vc, qt, kt, vt

    # mixtral's experts at its 8191-token admission's capacity (C = 2560);
    # jamba's at its 1023-token admission's (C = 160)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    for E, C, products in (ARCH_GMM, FAMILY_GMM):
        for name, (D, F_) in products.items():
            b = bf16_on(gen, (E, C, D), dev)
            w = bf16_on(gen, (E, D, F_), dev, scale=D ** -0.5)
            err = check_close(f"gmm/{name}", bucket_matmul(b, w),
                              grouped_matmul_plain(
                                  b.reshape(E * C, D), w,
                                  [C] * E).reshape(E, C, F_),
                              GMM_TOL)

            def bmm_f32(b=b, w=w):
                return torch.bmm(b, w, out_dtype=torch.float32)
            out["grouped_matmul"][name] = {
                "max_abs_err": err,
                "ms": time_ms(lambda: bucket_matmul(b, w), n=10),
                "device_ms": graph_ms(lambda: bucket_matmul(b, w), n=10),
                "plain_ms": time_ms(lambda: grouped_matmul_plain(
                    b.reshape(E * C, D), w, [C] * E), n=2, warm=1),
                "library_ms": time_ms(bmm_f32, n=10),
                "library_device_ms": graph_ms(bmm_f32, n=10),
                **bound(E * C * D * 2 + E * D * F_ * 2 + E * C * F_ * 4,
                        2 * E * C * D * F_, BF16_FLOPS)}
            del b, w

    # the SSD scan at jamba's admission: state 16, 128 heads of 64, one
    # group of B/C shared by every head
    from repro_torch.kernels.ssd_scan.ops import (
        KERNEL_CHUNK, chunk_for, ssd_scan, ssd_scan_plain)
    for name, (b, S, H, P, G, N, Q) in FAMILY_SSD.items():
        args = ssd_inputs(rng, dev, b, S, H, P, G, N, torch.bfloat16)
        y, st = ssd_scan(*args, chunk=Q)
        yw, sw = ssd_scan_plain(*args, chunk=Q)
        tol = SSD_TOL[torch.bfloat16]
        err = max(check_close(f"ssd/{name}/y", y, yw, tol),
                  check_close(f"ssd/{name}/state", st, sw, tol))
        nbytes, flops, tc_flops = ssd_work(
            b, S, H, P, G, N, min(chunk_for(S, Q), KERNEL_CHUNK), 2)
        out["ssd_scan"][name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: ssd_scan(*args, chunk=Q), n=10),
            "device_ms": graph_ms(lambda: ssd_scan(*args, chunk=Q), n=10),
            "plain_ms": time_ms(lambda: ssd_scan_plain(*args, chunk=Q), n=3,
                                warm=1),
            "library_ms": None,
            **bound(nbytes, tc_flops, BF16_FLOPS),
            "function_flops": flops}
        del args, y, st, yw, sw

    # RMSNorm at gemma's (2048) and mixtral's (4096) widths, decode rows
    for name, (R, D) in ARCH_NORM.items():
        x = bf16(rng, (R, D), dev)
        sc = (torch.from_numpy(rng.normal(size=(D,)).astype(np.float32))
              .to(dev) * 0.1)
        wt = (1.0 + sc).to(torch.bfloat16)
        err = check_close(f"rmsnorm/{name}", rmsnorm_fused(x, sc)[0],
                          rmsnorm_plain(x, sc)[0], NORM_TOL)
        out["rmsnorm_fused"][name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: rmsnorm_fused(x, sc)),
            "device_ms": graph_ms(lambda: rmsnorm_fused(x, sc)),
            "plain_ms": time_ms(lambda: rmsnorm_plain(x, sc)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (D,), wt, 1e-5)),
            "library_device_ms": graph_ms(
                lambda: F.rms_norm(x, (D,), wt, 1e-5)),
            **bound(R * D * 2 + D * 4 + 2 * R * D * 2, 5 * R * D,
                    F32_FLOPS)}
    torch.cuda.empty_cache()
    return out


def times_of(src):
    """Build and time another checkout's kernels (``--times-of SRC``, SRC
    its ``src`` directory) with `main_shape_times`: one JSON line."""
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import _build
    logs = _build.build_all()
    say({"phase": "times_of", "src": str(src),
         "flash_ptxas": ptxas_report(logs["flash_prefill"]),
         "flash_sass": sass_counts(_build._target("flash_prefill")),
         "ssd_sass": sass_counts(_build._target("ssd_scan")),
         "times": main_shape_times(np.random.default_rng(0),
                                   torch.device("cuda"))})
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    if len(argv) == 2 and argv[0] == "--times-of":
        return times_of(argv[1])
    if argv:
        print("usage: chip_smoke.py [--times-of SRC]", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    load_peaks()
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_verify_attention)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    t_start = time.monotonic()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0)})

    t0 = time.monotonic()
    logs = _build.build_all()
    ptxas = {name: ptxas_report(log) for name, log in logs.items()}
    say({"phase": "build", "seconds": time.monotonic() - t0, "ptxas": ptxas})

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    times = main_shape_times(rng, dev)
    say({"phase": "mamba_admission", "arch": SSM_ARCH,
         **times["mamba_admission"],
         "ssd_scan_device_ms_x48": 48 * times["ssd_scan"]["device_ms"]})
    kernels = [check_paged(rng, dev, times), check_flash(rng, dev, ptxas),
               check_rmsnorm(rng, dev, ptxas), check_verify(rng, dev, times),
               check_dense(rng, dev, times),
               check_grouped_matmul(rng, dev, times, ptxas),
               check_ssd_scan(rng, dev, times, ptxas)]
    say({"phase": "kernels", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    shapes = arch_kernel_shapes(rng, dev, ptxas)
    for k in kernels:
        if k["name"] in shapes:
            k["arch_shapes"] = shapes[k["name"]]
    say({"phase": "arch_kernel_shapes", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    rank = tp_rank_kernels(rng, dev)
    for k in kernels:
        if k["name"] in rank:
            k["tp_rank_shapes"] = rank[k["name"]]
    say({"phase": "tp_rank_kernels_all", "seconds": time.monotonic() - t0})
    wrappers = [paged_decode_attention, flash_attention, rmsnorm_fused,
                paged_verify_attention, decode_attention, grouped_matmul,
                ssd_scan]
    t0 = time.monotonic()
    serve, runs = serve_phase(wrappers)
    streams = serve["streams"]
    spec_runs, spec_acceptance = spec_phase(wrappers, streams)
    runs = {"serve": runs,
            "serve_eager": serve_eager_phase(wrappers, serve, runs),
            **spec_runs, "dense": dense_phase(wrappers, streams)}
    say({"phase": "serve_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    runs["chunked_serve"] = chunked_serve_phase(wrappers, serve)
    chunked_logits_phase(dev)
    say({"phase": "chunked_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    runs["moe_serve"] = moe_serve_phase(wrappers)
    _, runs["chunked_moe"] = chunked_run(
        "chunked_moe", wrappers, MOE_ARCH, SHORT, SHORT_CHUNK,
        ("paged_decode_attention", "rmsnorm_fused"),
        ("flash_attention", "grouped_matmul"))
    say({"phase": "moe_serve_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    mamba, runs["mamba_serve"] = mamba_serve_phase(wrappers)
    _, runs["chunked_mamba"] = chunked_run(
        "chunked_mamba", wrappers, SSM_ARCH, SHORT, SHORT_CHUNK,
        ("rmsnorm_fused",), ("ssd_scan", "flash_attention", "decode_attention",
         "paged_decode_attention"))
    say({"phase": "mamba_serve_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    pilot = pilot_serve_phase(wrappers, {DENSE_ARCH: streams,
                                         SSM_ARCH: mamba["streams"]})
    runs["pilot_smollm"] = pilot[DENSE_ARCH]
    runs["pilot_mamba2"] = pilot[SSM_ARCH]
    say({"phase": "pilot_serve_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    fleet, runs["fleet_serve"] = fleet_serve_phase(wrappers, streams)
    runs["fleet_requeue"] = fleet_requeue_phase(wrappers, streams, fleet)
    runs["fleet_spec"] = fleet_spec_phase(wrappers, streams, spec_acceptance)
    runs["fleet_autoscale"] = fleet_autoscale_phase(wrappers, streams)
    runs["fleet_join"] = fleet_join_phase(wrappers, streams)
    say({"phase": "fleet_all", "seconds": time.monotonic() - t0})
    disagg_seconds = {}
    t0 = time.monotonic()
    runs["disagg_serve"] = disagg_serve_phase(wrappers, streams)
    disagg_seconds["disagg_serve"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["disagg_requeue"] = disagg_requeue_phase(wrappers, streams)
    disagg_seconds["disagg_requeue"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["serve_wave"] = serve_wave_phase(wrappers, serve)
    disagg_seconds["serve_wave"] = time.monotonic() - t0
    arch_seconds = {}
    t0 = time.monotonic()
    gemma, runs["gemma_serve"] = dense_arch_serve_phase(
        wrappers, "gemma_serve", GEMMA_ARCH)
    arch_seconds["gemma_serve"] = time.monotonic() - t0
    t0 = time.monotonic()
    _, runs["starcoder_serve"] = dense_arch_serve_phase(
        wrappers, "starcoder_serve", CODE_ARCH)
    arch_seconds["starcoder_serve"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["swa_serve"], runs["swa_serve_eager"] = swa_serve_phase(wrappers)
    arch_seconds["swa_serve"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["chunked_swa"] = chunked_swa_phase(wrappers, dev)
    arch_seconds["chunked_swa"] = time.monotonic() - t0
    t0 = time.monotonic()
    pilot = pilot_gemma_phase(wrappers, {DENSE_ARCH: streams,
                                         GEMMA_ARCH: gemma["streams"]})
    runs["pilot_gemma_smollm"] = pilot[DENSE_ARCH]
    runs["pilot_gemma"] = pilot[GEMMA_ARCH]
    arch_seconds["pilot_gemma"] = time.monotonic() - t0
    say({"phase": "arch_serve_all", "seconds": arch_seconds,
         "total_seconds": sum(arch_seconds.values())})
    mla_seconds = {}
    t0 = time.monotonic()
    mla, mla_runs = mla_serve_phases(wrappers, serve)
    runs.update(mla_runs)
    mla_seconds["mla_serve_phases"] = time.monotonic() - t0
    t0 = time.monotonic()
    _, runs["chunked_mla"] = chunked_run(
        "chunked_mla", wrappers, MLA_ARCH, SERVE, CHUNK, ("rmsnorm_fused",),
        ("flash_attention",) + MLA_UNLAUNCHED)
    chunked_logits_phase(dev, MLA_ARCH, "chunked_mla_logits")
    mla_seconds["chunked_mla"] = time.monotonic() - t0
    t0 = time.monotonic()
    pilot = pilot_mla_phase(wrappers, {DENSE_ARCH: streams,
                                       MLA_ARCH: mla["streams"]})
    runs["pilot_mla_smollm"] = pilot[DENSE_ARCH]
    runs["pilot_mla"] = pilot[MLA_ARCH]
    mla_seconds["pilot_mla"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["disagg_mla"] = disagg_mla_phase(wrappers, mla["streams"])
    disagg_seconds["disagg_mla"] = time.monotonic() - t0
    say({"phase": "disagg_all", "seconds": disagg_seconds,
         "total_seconds": sum(disagg_seconds.values())})
    t0 = time.monotonic()
    train_parity_phase(MLA_ARCH, "mla_train_parity", wrappers)
    mla_seconds["mla_train_parity"] = time.monotonic() - t0
    say({"phase": "mla_serve_all", "seconds": mla_seconds,
         "total_seconds": sum(mla_seconds.values())})
    fam_seconds = {}
    t0 = time.monotonic()
    _, hybrid_runs = hybrid_serve_phases(wrappers)
    runs.update(hybrid_runs)
    fam_seconds["hybrid_serve_phases"] = time.monotonic() - t0
    t0 = time.monotonic()
    _, runs["chunked_hybrid"] = chunked_run(
        "chunked_hybrid", wrappers, HYBRID_ARCH, HYBRID_CHUNKED, CHUNK,
        ("paged_decode_attention", "rmsnorm_fused"),
        ("flash_attention", "ssd_scan", "grouped_matmul"),
        cfg=hybrid_config())
    fam_seconds["chunked_hybrid"] = time.monotonic() - t0
    t0 = time.monotonic()
    vlm, vlm_runs = vlm_serve_phases(wrappers)
    runs.update(vlm_runs)
    fam_seconds["vlm_serve_phases"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["encdec_model"] = encdec_model_phase(wrappers, dev)
    fam_seconds["encdec_model"] = time.monotonic() - t0
    t0 = time.monotonic()
    train_parity_phase(ENCDEC_ARCH, "encdec_train_parity", wrappers)
    fam_seconds["encdec_train_parity"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["pilot_llava"] = pilot_families_phase(wrappers, vlm["streams"])
    fam_seconds["pilot_families"] = time.monotonic() - t0
    say({"phase": "family_serve_all", "seconds": fam_seconds,
         "total_seconds": sum(fam_seconds.values())})
    tp_runs, tp_shapes = tp_phases(wrappers)
    runs.update(tp_runs)
    smi = smi_line()
    counted = dryrun_phases(smi)
    runs["dryrun_step"] = {w.__name__: counted.get(w.__name__, 0)
                           for w in wrappers}
    train_seconds = {}
    t0 = time.monotonic()
    runs["train"], runs["train_eager"] = train_phase(wrappers)
    train_seconds["train"] = time.monotonic() - t0
    t0 = time.monotonic()
    train_parity_phase()
    train_seconds["train_parity"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["train_mamba"], runs["train_mamba_eager"] = train_mamba_phase(
        wrappers)
    train_seconds["train_mamba"] = time.monotonic() - t0
    for arch in GRAPH_PARITY:
        t0 = time.monotonic()
        train_graph_parity_phase(arch)
        train_seconds[f"train_graph_parity_{arch}"] = time.monotonic() - t0
    t0 = time.monotonic()
    runs["pilot_train"] = pilot_train_phase(wrappers)
    train_seconds["pilot_train"] = time.monotonic() - t0
    say({"phase": "train_all", "seconds": train_seconds,
         "total_seconds": sum(train_seconds.values())})
    ex_seconds = {}
    for name in EXAMPLES:
        t0 = time.monotonic()
        runs[f"example_{name}"] = example_phase(wrappers, name)
        ex_seconds[f"example_{name}"] = time.monotonic() - t0
    say({"phase": "examples_all", "seconds": ex_seconds,
         "total_seconds": sum(ex_seconds.values())})
    # a kernel's launches: the runs of the path that carries it
    paths = {"paged_verify_attention": ("spec_self", "spec_cold"),
             "decode_attention": ("dense",),
             "grouped_matmul": ("moe_serve",),
             "ssd_scan": ("mamba_serve",)}
    for k, w in zip(kernels, wrappers):
        name = w.__name__
        k["launches"] = sum(runs[r][name] for r in paths.get(name, ("serve",)))
        k["launches_by_run"] = {r: n[name] for r, n in runs.items()}
        # the tensor-parallel runs' call shapes: each rank's q (and pools
        # or k), the single-device runs' beside them
        k["shapes_by_run"] = {r: sh[name] for r, sh in tp_shapes.items()
                              if name in sh}
    t0 = time.monotonic()
    model_phase(dev)
    say({"phase": "model_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    moe_model_phase(dev)
    say({"phase": "moe_model_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    mamba_model_phase(dev)
    say({"phase": "mamba_model_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    arch_models_phase(dev)
    say({"phase": "arch_models_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    mla_model_phase(dev)
    say({"phase": "mla_model_all", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()
    hybrid_model_phase(dev)
    vlm_model_phase(dev)
    say({"phase": "family_model_all", "seconds": time.monotonic() - t0})
    say({"phase": "total", "seconds": time.monotonic() - t_start})
    say({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
