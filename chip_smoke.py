#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  — compile every CUDA kernel from csrc/, one nvcc per source,
              all started together.
  2. kernel — hold each kernel against its plain PyTorch version on the
              card: the forward (O and lse) by the route fwd_route picks,
              the whole-block kernel (bf16, S and Sk up to 128, each case
              run twice and bitwise alike), the streamed one (bf16, S or
              Sk above 128: 128 query rows a block, 128-key tiles by TMA
              through a two-stage ring, each case twice and bitwise
              alike), the f32 one (f32 at head dims up to 64: split-TF32
              wgmma on TMA-loaded tiles, 64 query rows a block, each case
              twice and bitwise alike) or the tiled one (f32 at head dims
              65 to 128); the backward (dQ, dK, dV) by the route bwd_route
              picks (the same predicate), the fused kernel (bf16, S and Sk
              up to 128: delta, dQ, dK and dV in one launch), the
              streamed pair (bf16 above 128: the dQ kernel with delta
              inside, then the dK/dV kernel; each case twice and bitwise
              alike), the f32 route (the f32 dQ kernel on split-TF32
              wgmma, which takes delta itself and writes it, then the f32
              dK/dV kernel on that delta; each case twice and bitwise
              alike, the dQ kernel's dQ and delta also alone against its
              plain version, twice and bitwise alike) or the split dK/dV
              and dQ kernels (f32 at head dims 65 to 128); and the
              dropout kernel (mask and output); over BERT-base shapes in
              f32 and bf16 with a key-padding bias, ragged S/Sk (200 x 77,
              and 100 x 77 in bf16), causal, a dead row, dropout 0.1 (the
              last three also at S = Sk = 256 in bf16, on the split
              kernels), head dims 8 to 128 (40 and 96 zero-padded to the
              next instance; in bf16 at 96 x 80 on the fused kernel and at
              200 x 144 on the streamed ones), S = Sk = 1, on the streamed
              kernels ragged 200 x 300 and 77 x 300, causal 200 x 300 and
              300 x 200, dropout 0.3, D = 128 causal with dropout, on the
              f32 kernels S = Sk = 1, dropout 0.3 and causal at 200 x 300
              and 300 x 200, and the
              S = 512 lane's shape (batch 64, H = 12, no bias),
              B·H above 65535, the bench lane's shape (batch 256,
              bf16, no bias) and transformer_big's (H = 16: the bf16
              step's causal self-attention with the bias and dropout 0.3
              at B = 48, S = 64 on the whole-block forward and the fused
              backward; greedy decode's f32 cross-attention, S = 80 over
              Sk = 64, and causal self-attention, 80 x 80, on the f32
              forward; bf16 at S = Sk = 256 with the bias on the streamed
              kernels, ROADMAP B3, each also timed, with the S = 512
              lane's shape, beside the old route, the tiled forward and
              the split backward, on the same inputs, held to the plain
              versions too; a streamed kernel slower than the old route
              fails, and an f32 kernel slower than it at batch 32); time
              each kernel, its plain version and one
              PyTorch library call as a yardstick
              (scaled_dot_product_attention, and its backward): the
              forward at the served shape (batch 8), the trained one
              (batch 32, also with dropout 0.1, and bf16 with dropout
              0.1) and the lane's, a whole-block or f32 time beside the
              tiled kernel's on the same inputs; the f32 dK/dV kernel
              (beside the split dK/dV kernel on the same inputs) and the
              f32 dQ kernel (beside bwd_delta with the split dQ kernel on
              the same inputs; slower than them at batch 32 fails) at
              batch 8 and 32 in f32 (also with dropout 0.1), the fused
              kernel at batch 32 in bf16 with the bias and
              at the lane's shape, beside the split route's whole
              backward on the same inputs; each beside its bound (the
              whole backward's: q, k, v, O, dO and lse read, dQ, dK and
              dV written once) and what sets it; the whole backward of
              SDPA and of the port timed alike, as (forward + backward)
              minus the forward, each captured in a CUDA graph, and
              bwd_delta alone in f32; the dropout kernel at the step's
              shape beside torch.native_dropout; a kernel timed faster
              than its bound fails. Then the
              attention op's route: at D = 96 the kernels (the forward
              once, the backward once: the tiled forward, dK/dV and dQ
              in f32 (D = 96 pads to 128, above the f32 kernels'
              instances), the whole-block forward and the fused kernel in
              bf16; against the plain versions); a
              bias the kernels do not take, the einsum path with the flash
              kernels' dropout mask; D = 192 and f16, which have no kernel
              instance, raise and launch nothing; a NaN in the bias, at
              one key or at every key of a batch, makes that batch's O
              NaN on the f32, tiled, whole-block and streamed forwards,
              as in the plain version. Every launch gate below
              counts (tiled forward, dK/dV, dQ, fused backward, dropout,
              whole forward, streamed forward, streamed dQ, streamed
              dK/dV, f32 forward, f32 dK/dV, f32 dQ) kernels; a tuple
              written below with six entries has the three streamed and
              the three f32 zeros after them, one with nine the three f32
              zeros.
  3. serve  — build the BERT-base encoder (12 layers, hidden 768, 12
              heads, ffn 3072, vocab 30522) with the port, initialise it
              on the card from a seed, and serve requests of batch 1, 8
              and 32 at S=128 through fluid.Executor(CUDAPlace(0)).run with
              random padding, back to back for a fixed window per batch
              size, on the compiled path: per batch size an eager warm-up,
              a CUDA-graph capture, then one graph replay per request.
              Checks: every run compiled; finite outputs; exactly 12
              forward launches per request (through the wrapper in a
              warm-up or a capture, recorded in the graph for a replay,
              and counted by name in a profiler trace of one replay); a
              weight replaced by the caller is copied into the graph's
              tensor before the next replay; replayed outputs against the
              interpreter (the oracle) on the card; one request against
              the port on the CPU. Reports latency p50/p99 over every
              request of the window and sequences/s as all the sequences
              over all the time spent in Executor.run, and the
              interpreter's latency over a shorter window.
  4. train  — build the BERT-base masked-LM pretraining step with the port
              (build_bert_pretrain_program: dropout 0.1, input mask, Adam
              lr 1e-4), run its startup on the card and train at batch 32,
              S=128, 15 % of positions masked, compiled: 3 warm-up steps
              (eager, capture, replay), then a fixed window of replayed
              steps, then 10 steps on one repeated batch. Checks: every
              step compiled, a finite loss every step, exact kernel
              launches per step (12 forward + 12 forward re-run by the
              generic grad on the f32 forward, 12 f32 dK/dV, 12 f32 dQ,
              one dropout launch per dropout op: (0, 0, 0, 0, 37, 0, 0,
              0, 0, 24, 12, 12); for
              replays as recorded in the graph and in a
              profiler trace, which must hold device events), dropout
              masks that
              differ from step to step under replay, the loss falling on
              the repeated batch; at batch 2 with dropout 0 one step on
              the card against the port on the CPU from the same weights
              (loss and the grads of the word embedding, layer 0's Q
              weight and the MLM head); the backward of the step's index
              ops (gather_grad, lookup_table_v2's grad) 20 times on the
              same inputs, bitwise alike; at batch 2 with dropout 0.1 three
              steps compiled (eager, capture, replay) against interpreted
              and interpreted again: masks equal, parameters bitwise
              equal. Reports step time p50/p90/p99, samples/s,
              peak device memory (less what earlier phases left
              allocated), capture time, and the interpreter's step time
              and peak memory.
  5. window — Executor.run(n_steps=4) on BERT-base at batch 2, dropout
              0.1: a window of 4 distinct batches against 4 single
              compiled runs and 4 interpreted runs, fetches and parameters
              bitwise; the window's kernel launches as its graph recorded
              them and a profiler trace of one more replay counts them; a
              window of the same feeds stacked (compiled) or the final
              step's (interpreted).
  6. lane   — bench.py's two lanes through paddle_tpu_torch.bench (the
              port's ``python3 -m paddle_tpu_torch.bench``): BERT-base in
              bf16 at batch 256 (OOM ladder 256/128/64/32), dropout 0, 20
              steps as one window after a warm one, and the MNIST MLP at
              batch 256, 60 steps; each prints its JSON line. Checks: a
              finite loss, the compiled path, a timed window of replays
              only, and (0, 0, 0, 12, 0, 24) kernels (bf16 at S = 128:
              the whole-block forward and the fused backward) in a
              profiler trace of one replayed BERT
              step. Then
              each lane's window again with FLAGS_feed_device_cache on
              and off in turn (every feed a cache hit when on).
  7. remat  — the bert lane again with PADDLE_TPU_BENCH_RECOMPUTE=1
              (per-layer checkpoints, the remat schedule in the graph),
              its JSON line printed. Checks: the plan engaged with no
              fallback warning, a timed window of replays only, (0, 0,
              0, 12, 0, 24) kernels a step from the graph and a trace, peak
              memory below the plain lane's of this run, the last loss
              within 2e-5 relative of the plain lane's.
  8. amp    — build_bert_pretrain_program(use_amp=True): bf16 products,
              f32 master weights, dropout 0.1, input mask, Adam, at batch
              32 compiled as the train phase runs it (step p50/p90,
              samples/s, peak memory beside the train phase's). Checks:
              the kernels a step (wrappers, graph, trace) that the route
              of the attention's dtype, read from the program, gives
              ((0, 0, 0, 0, 37, 0, 0, 0, 0, 24, 12, 12): its Q, K, V
              stay f32), a
              falling loss on a repeated batch, and 3 steps at batch 2
              compiled against interpreted bitwise, with f32 Q/K/V.
  9. guard  — the numeric fault guard: the TPU package's dynamic loss
              scaling program with an inf at step 2 gives the scales
              [8, 16, 8, 8, 16, 16] compiled (the bad step a replay), and
              with an empty white list compiled against interpreted
              bitwise; FLAGS_nan_inf_action=skip on BERT-base at batch 2
              leaves every parameter and Adam slot bitwise at its
              pre-step value when a replay is fed an inf; then the train
              phase's step with FLAGS_check_nan_inf off and on (skip),
              alternated, p50 of each.
 10. resnet — with torch's default cuDNN flags restored (TF32 allowed):
              the conv op's f32 forward and grad at a ResNet-50 shape
              bitwise what they give with TF32 off, and within 1e-5 of a
              float64 conv; bench.py's resnet lane through
              paddle_tpu_torch.bench (ResNet-50, 224x224, bf16
              convolutions, batch 64 with the OOM ladder 64/32/16,
              Momentum(0.1, 0.9), 10 steps as one window after a warm
              one), its JSON line printed. Checks: a finite loss, the
              compiled path, a timed window of replays only, no flash or
              dropout kernel in a step (wrappers, graph, a trace of one
              replay); the lane again with cuDNN free to pick
              non-deterministic algorithms, then pinned again (the cost
              of the pin); the loss falling over 10 steps on a repeated
              batch of 16 at lr 0.01; at batch 4, 3 steps compiled
              against interpreted and interpreted against itself, every
              persistable bitwise; one f32 step at batch 2 on the card
              against the CPU (loss, and the grads of the stem, a middle
              and the last conv and the classifier in relative L2); the
              LeNet conv net of models/mnist.py at batch 64: one step
              against the CPU, then 4 more compiled.
 11. transformer — transformer_big (models/transformer.py) uncut: 6 + 6
              layers, d_model 1024, d_inner 4096, 16 heads, vocab 37000,
              label smoothing 0.1. Training in bf16 products
              (FLAGS_use_bf16_matmul), dropout 0.3, Noam decay (warm-up
              4000), Adam, batch 48 x 64 source and target tokens, random
              ids and ragged masks from RandomState(0): 3 warm-up steps,
              20 timed, 8 on one repeated batch. Checks: every step
              compiled with (0, 0, 0, 18, 42, 36) launches (wrappers,
              graph, a trace of one replay), the fetched LR equal to
              Noam's formula at rtol 1e-6 every step, the loss falling;
              at 1 + 1 layers, 3 bf16 steps compiled (eager, capture,
              replay) against interpreted, losses, LRs and persistables
              bitwise; one f32 step at 1 + 1 layers (the f32 forward and
              the f32 route's backward) on the card against the CPU port, loss
              and three grads. Greedy decode in f32 at dropout 0, batch
              8, 64 source tokens, 80 positions: 79 runs of one compiled
              program, each argmax written into the fed target array in
              place, each run (0, 0, 0, 0, 0, 0, 0, 0, 0, 18, 0, 0)
              launches (the f32 forward) and one upload
              (the mutated array; the other feeds cache hits); then the
              CPU port runs once from the card's weights on the card's
              tokens (teacher forcing): the card's logits at every
              position hold to the CPU's within 1e-3 of the largest.
              Then bench's transformer lane (``python3 -m
              paddle_tpu_torch.bench transformer``), its JSON line
              printed, (0, 0, 0, 6, 0, 12) kernels a step. Reports step
              p50/p90, tokens/s, MFU and peak memory of the training
              step, p50/p99 ms and tokens/s of a decode step.
 12. lane512 — bench.py's bert lane at BERT's phase-2 pretraining length,
              as ``PADDLE_TPU_BENCH_SEQ=512 PADDLE_TPU_BENCH_BATCH=64
              python3 -m paddle_tpu_torch.bench bert`` runs it (bf16,
              batch 64 pinned: 32768 tokens a step, as the S = 128 lane;
              dropout 0, 20 steps as one window after a warm one), its
              JSON line printed. Checks: a finite loss, the compiled path,
              a timed window of replays only, and (0, 0, 0, 0, 0, 0, 24,
              12, 12, 0, 0, 0) kernels a step (the streamed forward, dQ
              and dK/dV)
              through the wrappers, in the graph and in a profiler trace
              of one replay. Reports step time, samples/s, MFU and peak
              memory.
 13. wide_deep — Wide&Deep CTR training (models/wide_deep.py) at
              bench.py's widths uncut: 13 dense features, 26 slots of 1e6
              ids, embeddings of 16, hidden 400-400-400, Adam lr 1e-3,
              batch 4096 from ctr_reader, with the streaming AUC in the
              program, so the block runs segmented: the forward as one
              CUDA graph, the auc op as an eager island, the backward and
              Adam as a second graph. 5 steps segmented (eager, capture,
              3 replays) and 5 interpreted from the same startup values
              and batches: loss, AUC and every persistable (parameters, Adam
              moments and beta powers, the AUC histograms) bitwise; 10
              more steps: the loss falls and the AUC ends above 0.5. At
              1e4 ids a slot, 3 steps on the card against the port on the
              CPU (loss at LOSS_TOL, three grads at GRAD_TOL, the AUC
              within 1e-3, the histograms' totals equal). Then bench's
              wide_deep lane (``python3 -m paddle_tpu_torch.bench
              wide_deep``), its JSON line printed, and 20 more steps, each
              synchronized. Checks: every run segmented, 2 graphs captured
              a key, then 2 replays and 1 island dispatch a run,
              ``compiled_metric`` true, and no kernel of KERNELS through
              the wrappers, in the graphs or in a profiler trace of one
              step. Reports step p50/p90, samples/s and peak memory.
 14. predictor — save, load and serve through paddle_tpu_torch.inference
              (fluid.io.save_inference_model, the ProgramDesc codec,
              create_predictor(Config(dir)) with the pass pipeline of
              fluid.ir.INFERENCE_PASSES), on the card, the saved
              directories in a temporary directory deleted at the end.
              (a) the BERT-base pretraining program (dropout 0, input
              mask) after one Adam step, saved with the encoder output
              and the MLM logits as targets: after the passes 73 fc, 1
              fused_embedding_eltwise_layernorm, 12 fused_attention_qkv,
              24 layer_norm and 12 gelu, every persistable on the card;
              requests of batch 1, 8 and 32 (warm-up, then a window),
              each compiled, finite, with exactly (0, ..., 0, 12, 0, 0)
              launches (wrappers, graph, a trace of one replay); outputs
              against exe.run(main.clone(for_test=True),
              use_prune=True) on the training scope within rtol 1e-5,
              atol 1e-6, and whether bitwise; predictor.clone()
              allocates nothing on the card, shares the scope and
              answers bitwise alike. (b) a reference-style BERT at full
              width, its attention decomposed as a reference-serialized
              program carries it (fc, reshape2, transpose2, scale,
              matmul, + the [B, 1, 1, S] key-padding bias, softmax,
              matmul, transpose2, reshape2), saved and loaded:
              multihead_matmul_fuse_pass_v2 fuses all 12 subgraphs, each
              request launches the f32 forward 12 times, and with
              switch_ir_optim(False) none; fused against unfused within
              1e-4 at 12 layers and 1e-5 at 1 layer (rtol and atol).
              (c) ResNet-50 (224x224, 1000 classes) saved with the
              logits that feed softmax and the softmax: 53
              conv2d_fusion, 49 relu, 16 elementwise_add, 1 fc, 2
              pool2d, 1 flatten2, 1 softmax; batch-8 requests launch
              none of the twelve kernels; logits and softmax against the
              clone for test within rtol 1e-4, atol 1e-5 of the largest
              (the elementwise bound is reported too). Reports p50, p99
              and sequences/s of each window.
 15. resume — fault-tolerant training with the checkpoint plane
              (fluid.io.save_checkpoint and load_checkpoint,
              Executor.set_auto_checkpoint, resume_from, the guard's
              HealthMonitor) and the DataLoader: BERT-base at full width,
              f32, dropout 0.1, input mask, Adam, batch 32, S = 128 (the
              train phase's step), 16 distinct batches from a seed fed by
              DataLoader.from_generator, checkpoints in a temporary
              directory deleted at the end. (a) The oracle: 12 steps,
              unbroken. (b) A victim checkpointing every 4 steps of the
              scope's counter (the startup counts one), dropped (executor,
              scope, loader) 2 steps past its last checkpoint without a
              save; a fresh executor, scope and loader run the startup,
              resume_from() and go on to step 12. (c) The same fed by
              DataLoader.window(4) with the default prefetch, one
              run(n_steps=4) a window, checkpointing every 8 steps (a
              window crosses a boundary of 4 every time), dropped one
              window past it. (d) FLAGS_check_nan_inf with
              FLAGS_nan_inf_action=rollback, FLAGS_nan_inf_tolerance=2,
              a checkpoint every 2 steps, the input mask NaN once at steps
              5 (one key) and 6 (every key): the monitor restores the
              last checkpoint and the
              loader's position, the loop rewinds and replays. (e) Wide&
              Deep with its auc island, segmented, its tables cut to 1e5
              ids a slot (bench.py: 1e6), killed and resumed as (b).
              Checks: every BERT run compiled with (0, 0, 0, 0, 37, 0, 0,
              0, 0, 24, 12, 12) launches (a window's as its graph recorded
              them); the losses after each resume, the rollback's replay
              and the victims' own equal to the oracle's bitwise, and
              every persistable at the end; rollbacks 1 and trips 2, and
              after the restore replays only, no capture; Wide&Deep's
              losses, AUCs and persistables (the auc state among them)
              bitwise, every run segmented, no kernel of KERNELS. Reports
              the checkpoint's bytes, the seconds to save, validate and
              load it, and the step p50 and mean with and without
              auto-checkpointing every 4 steps.
 16. control_flow — control flow and the LR schedules (fluid.layers'
              While, while_loop, cond, Switch, the tensor arrays and
              every schedule). (a) The train phase's step (BERT-base f32,
              dropout 0.1, input mask, Adam, batch 32, S = 128) under
              BERT's schedule, linear_lr_warmup(polynomial_decay(1e-4,
              12, 0.0, 1.0), 4, 0.0, 1e-4), built from models/bert.py's
              pieces with Adam(learning_rate=lr): 12 steps compiled and
              12 interpreted in lock step from one start, then one
              Executor.run(n_steps=4) over steps 2-5 from the start.
              Checks: the step compiles whole (its Switch's two
              conditionals inside the graph), each compiled run one
              replay after the warm-up and the capture, 0 islands, (0,
              0, 0, 0, 37, 0, 0, 0, 0, 24, 12, 12) launches (wrappers and
              graph); loss, LR and every persistable
              (@LR_DECAY_COUNTER@ and the LR var among them) bitwise the
              interpreter's after every step; the LR-0 step leaves the
              parameters bitwise and moves Adam's moments; the window's
              losses, LRs and state bitwise the single runs'; the LRs
              equal the CPU port's at rtol 1e-6, atol 1e-6 x the peak.
              (b) while_loop (an int64 counter, less_than) over one
              BERT-base encoder layer (hidden 768, 12 heads, ffn 3072,
              f32, input mask), its parameters made once, 12 iterations
              at batch 8: the block segmented, the loop's body one CUDA
              graph replayed each iteration; at dropout 0 each run 12
              f32 forwards (wrappers, the body's graph x iterations, a
              trace of one run) and bitwise the interpreter's; at
              dropout 0.1 (36 dropout launches more) bitwise the
              interpreter's too. (c) A cond of two pure branches inside
              the step's graph; a cond with a dropout in its untaken
              branch segmented (the conditionals islands) with the taken
              branch exact; a while that writes a tensor array, joined
              after it; a dropout in a while body drawing a new mask each
              iteration; a Switch case assigning a numpy constant
              (captured: the plan binds the constant on the card); each
              against the interpreter bitwise; piecewise_decay and
              cosine_decay on the card against the CPU port. Reports (a)'s
              step p50 beside the train phase's f32 p50, and (b)'s run
              p50 beside a straight line of 12 layers in one graph (the
              same work), with the cost of an iteration beyond its body.
 17. optimizers — the optimizer stack (fluid.optimizer's Lamb,
              LarsMomentum, Adagrad, Adamax, DecayedAdagrad, Adadelta,
              RMSProp, Ftrl, Dpsgd, DGCMomentum, GradientMergeOptimizer and
              LookaheadOptimizer, fluid.clip, L1Decay, fluid.gradients).
              (a) The train phase's step (BERT-base f32, dropout 0.1,
              input mask, batch 32, S = 128) under Lamb with BERT's
              schedule, linear_lr_warmup(polynomial_decay(1e-3, 40, 0.0,
              1.0), 4, 0.0, 1e-3), weight decay 0.01 on every weight but
              the LayerNorm scales and biases and every bias, and
              GradientClipByGlobalNorm(1.0): 6 steps compiled and 6
              interpreted in lock step from one start, 10 on one repeated
              batch, 20 replays timed alternating with 20 of Adam's step
              under the same schedule. Checks: the step compiles whole,
              (0, 0, 0, 0, 37, 0, 0, 0, 0, 24, 12, 12) launches
              (wrappers, graph, a trace of one replay); loss, LR, the
              pre-clip global norm, the clip's scale and every persistable
              (LAMB's moments and beta powers among them) bitwise the
              interpreter's after every step; at step 1 the global norm
              within 1e-5 of float64 over the interpreter's 199 grads; the
              scale clip / max(norm, clip) exactly in f32, and the clip
              engaged (a norm above 1.0 in some step; else 3 more steps at
              a clip_norm of half step 0's norm, each scale below 1); the
              loss falling; one step at batch 2, dropout 0, on the card
              against the CPU port (the loss, three grads, the global
              norm). (b) GradientMergeOptimizer(Adam(1e-4), k_steps=4,
              avg=True) on the same step at dropout 0, micro-batch 8: 8
              micro-steps compiled and interpreted in lock step, each (0,
              0, 0, 0, 0, 0, 0, 0, 0, 24, 12, 12) launches (the update and
              the accumulators' reset in a conditional inside the graph).
              Checks: bitwise the interpreter's after every micro-step;
              the parameters bitwise unchanged after micro-steps 1-3;
              after micro-step 4, against one Adam step at batch 32 on
              the same 32 rows: the merged, averaged grads (Adam's first
              moment) each within 1e-3 of its largest magnitude (of the
              largest grad, where a grad is rounding noise: the K
              projections' biases); every parameter within 3e-5, those
              with a noise grad within 2·lr (a sign flip of Adam's first
              step), at most 1e-3 of the elements beyond 1e-7, which are
              sorted by cause (a grad near Adam's ε, one ulp). Every
              interpreted run's launches are counted and held to the
              compiled run's. (c) On the MLP of the TPU
              package's optimizer tests: each optimizer above, Dpsgd at
              sigma 0 and 1, Lookahead, GradientMerge at k = 1, the three
              clips, a per-parameter clip through
              set_gradient_clip(param_list=), L1Decay and fluid.gradients,
              4 runs each compiled (eager, capture, replays), bitwise the
              interpreter's and within rtol 1e-5, atol 1e-6 of the CPU
              port; dpsgd's noise on the card (2^20 elements) by its mean
              and standard deviation. Reports (a)'s step p50 and p90
              beside Adam's, timed alternating with it, and the train
              phase's f32 p50, and (b)'s micro-step p50
              beside a plain Adam step's at batch 8, with the peak memory
              of each.
 18. lod    — LoD sequences and the Dataset path. (a) The book's
              understand_sentiment conv net (models/book_extra.py: vocab
              5147, emb 32, two sequence_conv (tanh) + sequence_pool
              ("sqrt") branches of 32 filters, fc, Adagrad 5e-2) on 50
              ragged batches of 32 reviews drawn as the synthetic IMDB
              reader draws them, compiled, every batch a new LoD and so a
              new plan run eagerly: the first 8 steps and 5 runs of one
              fixed-LoD batch (eager, capture, 3 replays) compiled and
              interpreted in lock step, fetches and persistables bitwise;
              every loss within rtol 1e-4, atol 1e-5 of the CPU port's on
              the same batches; the loss falling; device memory after the
              last 40 ragged steps within 1 MiB of after 10 (a plan that
              never captured is evicted). Reports the p50 of a new-LoD
              step and of a replayed one, the plans cached, the LoD
              constants one holds, and device memory before and after.
              (b) Wide&Deep at the lane's widths (26 slots of 1e6 ids,
              hidden 400 x 3, Adam, batch 4096, AUC) from 8 batches
              written as slot files (4 files), loaded by an
              InMemoryDataset on 4 parser threads and local_shuffle(seed):
              every slot and the label LoD [0, 1, ..., 4096];
              two passes of train_from_dataset (segmented around the auc
              island, captured and replayed) and of it with window_size=4
              (LoD batches step by step) print the losses and AUCs of the
              same batches fed dense through Executor.run in the same
              order and leave every persistable bitwise theirs. Reports
              parse seconds and samples/s from the dataset against the
              Executor.run loop, of the second pass (all replays) and the
              first.
              (c) Each sequence op, sequence_mask and cos_sim, forward and
              generic grad, on the card against the CPU port (rtol 1e-5,
              atol 1e-6) over a LoD with an empty sequence, and 4
              recommender steps (sequence_pool("sum") over two LoD slots,
              cos_sim) against the CPU port. Every run of the phase,
              interpreted ones included, launches none of the twelve
              kernels: through the wrappers and in every graph.
 19. compiler — the v1.7 training-script front end. (a) ResNet-50 at
              full width (models/resnet.py: 1000 classes, 224x224, f32,
              Momentum 0.01, batch 64), the eval clone taken before the
              optimizer as PaddleCV's script takes it: 3 steps each by
              Executor.run, by CompiledProgram(main).with_data_parallel(
              loss_name) and with a BuildStrategy with fuse_bn_act_ops
              and fuse_elewise_add_act_ops, from one start, every fetch
              bitwise alike (nothing fuses in the train program); the
              eval clone compiled with share_vars_from the trained
              program and the fuse strategy over 4 batches, its fused-op
              census and the train program's equal to the TPU package's
              passes' (CP_RESNET_CENSUS, tests/test_torch_compiler.py),
              the fused program segmented around its 33 stateful
              fused_batch_norm_act islands, its logits against the
              unfused eval program's (bitwise or within rtol 1e-4, atol
              1e-5, printed), fluid.metrics.Accuracy's eval() equal to
              the sample-weighted mean of the fetched batch accuracies,
              and under ExecutionStrategy(allow_mixed_compilation=False)
              interpreted and bitwise alike. (b) The train phase's
              BERT-base f32 step (dropout 0.1, input mask, batch 32): 3
              steps by Executor.run, through
              CompiledProgram.with_data_parallel(loss_name) with
              ExecutionStrategy(), with allow_mixed_compilation=False
              (the block has no island: it compiles whole, as in the TPU
              package) and interpreted, from the same parameters: losses
              and every persistable bitwise alike, (0, 0, 0, 0, 37, 0, 0,
              0, 0, 24, 12, 12) launches a run (wrappers, graph, a trace
              of one replay). (c) bench.py's longctx lane (causal bf16
              attention, B = 1, H = 12, S = Sk = 8192, D = 64): the
              streamed forward, dQ and dK/dV kernels against their plain
              versions, each twice and bitwise alike (limits per output,
              LONGCTX_TOL, each shown to fail a plain version with one
              tile of the causal grid left out), each timed beside its bound, its plain version and
              SDPA (is_causal; the backward as fwd+bwd minus fwd), the
              port's and SDPA's fwd+bwd graph-replayed; then the lane
              through paddle_tpu_torch.bench (its JSON line printed): (0,
              0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0) launches a step through
              the wrappers, and in a trace of a replay of the step's
              graph. (d) bench.py's mnist_realdata loader (64
              batches of 64) with use_multiprocess=True beside the thread
              prefetch: batches bitwise the generator's, the losses of
              two passes bitwise alike (a batch a run, and window(8)),
              samples/s of each pass, cold and warm, no segment of this process left in /dev/shm. (e)
              fluid.install_check.run_check() on the card.
 20. models — the op library's first model batch, each at its published
              widths with random weights from a seed, through
              Executor.run compiled: 10 steps on one fixed batch (eager,
              capture, replays), the first 3 in lock step with the
              interpreter (fetches and every persistable bitwise), every
              run's launches gated (wrappers, graph, a trace of one
              replay), the loss falling, step p50 and peak memory; then
              2 steps on the card against the CPU port from the same
              start: each step's loss at LOSS_TOL relative (the second
              of a conv net or after Adam or Adagrad at KINK_L2_TOL of
              the loss's move), the first step's grads of every
              parameter at GRAD_TOL of its largest (conv nets:
              KINK_L2_TOL in relative L2). (a) SE-ResNeXt-50 32x4d
              (models/se_resnext.py: 224x224, 1000 classes, batch 32,
              f32, Nesterov Momentum 0.0125, the classifier's dropout
              0.5: the dropout kernel (0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0)
              a step), against the CPU at batch 2 with the same dropout
              mask. (b) The book's VGG16 (book_extra.build_vgg_cifar
              depth "16": 32x32, batch 128, Adam 1e-3), the CPU at batch
              2. (c) The PTB LSTM LM, large (vocab 10,000, hidden 1,500,
              2 layers, 35 steps, batch 20, init scale 0.04, global-norm
              clip 10, SGD 1.0, no dropout): last_h and last_c finite;
              on one repeated batch SGD 1.0 overshoots, and the loss
              rises and falls again within the 10 steps, as the TPU
              package's does (tests/test_torch_models_a7.py), so all 10
              losses are held to the CPU port's at LOSS_TOL, and the loss
              must fall below the first.
              (d) The book's N-gram LM (dict 2048, emb 32, hidden 256,
              window 4, SGD 1e-3) and the skip-gram model (dict 2048, emb
              32, Adagrad 0.1) under nce (5 negatives, the same draws on
              the card and the CPU) and hsigmoid, batch 100. (e) The
              book's SRL tagger (word dict 44,068, 59 tags, emb 32,
              hidden 512, linear_chain_crf and crf_decoding, SGD 1e-2)
              over 64 sentences of 10-60 words: crf_decoding's path on
              the card equal to the CPU port's. Then AMP on ResNet-50
              (decorate(), batch 64, Momentum 0.01) beside the same
              program in f32: step p50 of each and of phase 10's bf16
              lane. None of (b)-(e) or AMP launches a counted kernel.
 21. rnn    — the recurrences, each model at its source's widths with
              random weights from a seed, f32, through Executor.run
              compiled (segmented around the islands where the program
              holds stateful ops), every run's launches gated (none of
              the twelve kernels), the first runs bitwise the
              interpreter's. (a) The book's stacked-LSTM sentiment net
              (chapter 6 stacked_lstm_net: dict 5,147, emb 128, HID_DIM
              512, 3 dynamic_lstm alternating is_reverse, max pools, 2
              classes, Adagrad 0.002, batch 128 reviews): 10 steps on one
              batch as phase 20 runs them (loss falling, step p50, peak
              memory), 10 ragged batches (each a new LoD, eager, the
              plans and the card's memory bounded), 2 steps against the
              CPU port at batch 8; saved and served by AnalysisPredictor
              (census RNN_SENT_CENSUS: fc_lstm_fuse_pass leaves it
              unfused, as the TPU package's passes do), request p50,
              outputs against Executor.run. (b) The book's chapter 8
              translator as v1.7 wrote it (dicts 30,000, word_dim =
              hidden = decoder 512, a bidirectional GRUCell encoder under
              layers.rnn, the additive-attention GRUCell decoder, 50
              tokens, batch 64, softmax_with_cross_entropy masked by the
              padding, Adam 1e-3): 10 steps, the CPU port at batch 2;
              BeamSearchDecoder (beam 4, bos 0, eos 1) through
              dynamic_decode for 64 steps over the tiled encoder: decode
              p50, each step's top-k against the CPU port's at batch 2
              (equal but near-ties within 1e-5 relative, counted). (c)
              The legacy LoD path at (b)'s widths: the encoder (fc
              without bias into dynamic_gru, 64 sources of 10-50 tokens)
              served with fusion_gru (census LG_ENC_CENSUS); fusion_lstm
              served at (a)'s widths (RNN_FUSED_CENSUS); the DynamicRNN
              scorer (gru_unit, need_reorder memory, static_input) over
              64 ragged references, segmented (its while in the
              interpreter, a step's batch the rank table's prefix), the
              CPU port at batch 2; the contrib TrainingDecoder (StaticRNN,
              gru_unit) 10 steps and the CPU port at batch 2; the contrib
              BeamSearchDecoder's step program run from the host 32
              steps at beam 4 and beam_search_decode, the CPU port at
              batch 2 from the card's beam state.

 22. vision — the vision and loss op batch, each program at its
              source's widths with random weights from a seed, f32,
              through Executor.run compiled (CRNN-CTC segmented around
              its islands), every run's launches gated, the first 3
              steps of 10 on one fixed batch in lock step with the
              interpreter (fetches and persistables bitwise), a trace of
              one step, each program's losses falling; then card vs CPU
              over 2 steps from one start (``_md_card_vs_cpu``: conv
              nets' grads in relative L2 within KINK_L2_TOL). (a)
              CycleGAN (Zhu et al. 2017 appendix 7.2: 256x256, batch 1,
              ResNet-9-block generators with reflection padding,
              instance_norm and conv2d_transpose u-layers, 70x70
              PatchGAN discriminators, LSGAN losses, cycle L1 x 10, Adam
              2e-4 / beta1 0.5): a step is three runs (the generators',
              then each discriminator's on the generators' fakes), the
              card vs the CPU at 64x64. (b) DeepLabv3+ (Chen et al.
              2018: aligned Xception-65 at output stride 16, ASPP at
              rates 6, 12, 18 with image pooling, dropout 0.1, the
              decoder; Cityscapes shapes: 19 classes, 769x769 crops,
              batch 4, labels in 16x16 blocks with a tenth ignored (255);
              Momentum 0.9 under polynomial_decay, L2Decay 4e-5): the
              dropout kernel (0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0) a
              step, and against its plain version at the step's shape
              ([4, 256, 49, 49]); the eval clone's mean_iou at batch 4
              timed, and equal on the card and the CPU at 129x129; the
              card vs the CPU at 129x129, batch 2, with one middle-flow
              block, step 1 from one start (grads and the update), step 2
              from the card's state (at random weights the net is
              chaotic: DL_CHECK_MIDDLE). (c) CRNN-CTC (PaddleCV ocr_recognition
              crnn_ctc_model: 1x48x512, four conv groups of 16-128, a 2x2
              pool after each, im2sequence, fc 3x200 into dynamic_gru
              forward and reverse, 95 classes and the blank, warpctc
              norm_by_times, Momentum 1e-3; batch 32, labels of 3-12):
              segmented (warpctc reads its Label on the host; ctc_align
              and edit_distance are islands), its segments and islands
              counted; the greedy decode and edit distance timed; the
              card vs the CPU at batch 8 with the decoded ids and
              distances equal. (d) Every op type of the batch
              (``_vs_battery``) on the card against the CPU port, forward
              and generic grad; every layer in one program
              (``vision_layers_program``) 3 runs bitwise the
              interpreter's; a frozen-BN program (conv2d + affine_channel)
              served by AnalysisPredictor after
              conv_affine_channel_fuse_pass against its unfused
              Executor.run. The path's launches are those of the three
              programs' training, the eval and the decode, counted from
              zero; the checks' launches are counted apart.
 23. det    — the detection batch, each program at its source's widths
              with random weights from a seed, f32, synthetic images and
              ground truth from a seed (COCO-like: 1-20 boxes an image;
              VOC-like: 1-6), 10 steps on one fixed batch, the first 3 in
              lock step with the interpreter (fetches and persistables
              bitwise), a trace of one step, each loss falling; the eval
              programs timed (3 runs, then DET_EVAL_RUNS). (a) YOLOv3
              (PaddleDetection configs/yolov3_darknet.yml, release/0.2;
              Redmon & Farhadi 2018): DarkNet-53, 608x608, batch 8, 80
              classes, 50 boxes at most, the nine anchors and three
              masks, Momentum 0.9 with L2Decay 5e-4 at 1e-3 (the warm-up
              cut); yolov3_loss is pure, so a step is one CUDA-graph
              replay; the eval program (yolo_box a head, multiclass_nms:
              score 0.01, top 1000, keep 100, NMS 0.45, no background)
              timed with the NMS island's share, saved and served by
              AnalysisPredictor at batch 1. (b) MobileNet-SSD (PaddleCV
              ssd/mobilenet_ssd.py, models 1.7; PaddleDetection
              ssd_mobilenet_v1_voc.yml): 300x300, batch 32, 21 classes,
              multi_box_head over the 19 ... 1 maps (1917 priors),
              ssd_loss as the TPU package builds it, RMSProp 1e-3 with
              L2Decay 5e-5; segmented (bipartite_match and target_assign
              are islands); the eval program (detection_output,
              detection_map 11point) timed. (c) Faster R-CNN R50-FPN
              (PaddleDetection faster_rcnn_r50_fpn_1x.yml): one image,
              800x1333 padded to 800x1344 (batch 1 is forced: the
              reference's collect_fpn_proposals merges a batch into one
              sequence), frozen BN as affine_channel (the residual
              branches' last scale 0.25: random weights), stem and res2
              frozen, FPN P2-P6 of 256, anchors 32-512, rpn_target_assign
              (256, 0.7 / 0.3), generate_proposals a level (2000 /
              2000), collect, generate_proposal_labels (512, 0.25 at
              0.5), distribute (level 4 at 224), roi_align 7x7 (ratio
              2), two fc of 1024, 81 classes, Momentum 0.9 with L2Decay
              1e-4 at 0.02 / 16; the samplers' seeds pinned; segmented,
              each step's proposals new LoDs (a new plan where they
              change: the steps' kinds and times reported); the eval
              program (box_decoder_and_assign, box_clip, multiclass_nms)
              timed. Then, counted apart, card vs CPU at small sizes
              (YOLO_CHECK, SSD_CHECK, FRCN_CHECK: ``_md_card_vs_cpu``
              under an ``IslandTape``: each CPU island takes the card's
              inputs and must give the card's outputs exactly, the CPU
              goes on from them, the selections that parted on the CPU's
              own inputs counted; losses, step 1's grads by the conv
              nets' rule, the eval programs' outputs), and (d) the 44 op
              types (``_det_battery``) on the card against the CPU port,
              the host ops' outputs exactly. Twelve kernels: 0 launches,
              wrappers, graphs and traces.

Output: the card's name and power limit first, results as lines of text,
then one JSON line {"kernels": [...]} (per kernel, ``launches`` and
``launches_by_path``: what the main path ran on the card, replays
included; ``wrapper_calls_by_path``: the wrappers' counts, warm-ups and
captures only) and, last, the JSON result line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is missing or any phase fails. ``--profile`` adds torch.profiler
passes over one request of each batch size (of the serve phase and of
the predictor's BERT-base) and over one step of the train, lane, remat,
AMP, resnet, transformer, lane512 and wide_deep phases (and one decode
run): device time by kernel name,
and the device's idle share against the same work's unprofiled wall
time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

SEED = 20261016
S = 128
SERVE_BATCHES = (1, 8, 32)
WINDOW_S = 5.0                # seconds served per batch size, after warm-up
WARMUP = 3                    # requests per batch size before the window
POOL = 16                     # distinct requests per batch size, cycled
F32_TOL = 1e-4                # kernel vs plain, f32: sums in other orders
BF16_TOL = 2e-2               # kernel vs plain, bf16 operands
SLICE_TOL = 1e-3              # GPU vs CPU through 12 f32 encoder layers
TRAIN_BATCH = 32
TRAIN_WARMUP = 3              # steps before the window
TRAIN_WINDOW = 100            # steps timed: p90 has 10 beyond it
FALL_STEPS = 10               # steps on one repeated batch
TRAIN_LR = 1e-4               # bench.py's BERT-base lane
TRAIN_DROPOUT = 0.1           # BERT's pretraining hidden/attention dropout
MLM_FRAC = 0.15               # masked positions per batch (bench.py)
CHECK_BATCH = 2               # card vs CPU step
LOSS_TOL = 1e-4               # card vs CPU loss, relative: f32 sums in
GRAD_TOL = 1e-3               # other orders; grads: of each max |grad|,
                              # after 12 layers forward and back
INTERP_WINDOW_S = 2.0         # seconds served per batch size, interpreted
INTERP_STEPS = 8              # interpreted training steps (2 warm-up)
TRACE_GUARD_S = 0.05          # host sleep between a traced window's edges
                              # and the kernels it counts
TRACE_PAD = 256               # small kernels a trace's recorded cycle runs
                              # before the kernels it counts: late in a
                              # whole run a trace has lost the first 1 to 7
                              # device records of that cycle (ROADMAP C2)
TRACES = []                   # the device kernel names each trace held
GRAPH_TOL = 1e-6              # graph replay vs interpreted on the card,
                              # relative: the same kernels in the same
                              # order, so expected bit for bit
GRAPH_BATCH = 2               # compiled vs interpreted training steps
GRAPH_STEPS = 3               # eager warm-up, capture, replay
LANE_BATCH = 256              # bench.py's BERT lane (bf16, no bias)
WMT_HEADS = 16                # transformer_big: 16 heads of D = 64
WMT_BATCH = 48                # the transformer phase's bf16 step: 48 x 64
WMT_LEN = 64                  # = 3072 source and 3072 target tokens, about
#                               a GPU's share of the paper's ~25k-token
#                               batches over 8 GPUs (Vaswani et al. 2017)
WMT_DROPOUT = 0.3             # transformer_big's dropout
WMT_DECODE_BATCH = 8          # greedy decode: 8 sentences of 64 source
WMT_DECODE_OUT = 80           # tokens, 80 target positions
# transformer_big's attention shapes, by name: (B, S, Sk, dtype,
# dropout, key-padding bias, causal); the kernel phases check and time
# each (the backward those with a backward on a path or in ROADMAP B3)
TRANSFORMER_FWD_CASES = {
    "train self-attention": (WMT_BATCH, WMT_LEN, WMT_LEN, "bf16",
                             WMT_DROPOUT, True, True),
    "decode cross-attention": (WMT_DECODE_BATCH, WMT_DECODE_OUT, WMT_LEN,
                               "f32", 0.0, True, False),
    "decode self-attention": (WMT_DECODE_BATCH, WMT_DECODE_OUT,
                              WMT_DECODE_OUT, "f32", 0.0, False, True),
    "B3 S=256": (WMT_BATCH, 256, 256, "bf16", 0.0, True, False),
}
BIG_BH = (5462, 12)           # B·H = 65544, above gridDim.y's 65535
WINDOW_K = 4                  # steps of phase_window's windows
REMAT_LOSS_RTOL = 2e-5        # remat lane vs plain lane, last loss: the
                              # reference's remat tolerance
                              # (tests/test_models.py:172)
AMP_WINDOW = 50               # AMP training steps timed
GUARD_WINDOW = 30             # f32 steps timed in each guard block
GUARD_BLOCKS = 2              # guard off/on pairs, alternated
RESNET_GRAPH_BATCH = 4       # ResNet-50 compiled vs interpreted, 224x224
RESNET_CHECK_BATCH = 2       # ResNet-50 card vs CPU, f32
RESNET_FALL_BATCH = 16       # ResNet-50 on one repeated batch
RESNET_FALL_LR = 0.01        # where its loss falls (the lane's 0.1 rings:
                             # tests/test_models.py:12-20)
RESNET_FALL_STEPS = 10
KINK_L2_TOL = 5e-2           # conv-net grads, card vs CPU, relative L2:
                             # f32 rounding moves ReLU and max-pool kinks
                             # (an input near 0, a near-tied window), and
                             # the 0/1 grad on either side moves with them;
                             # ResNet-50's conv grads at batch 2 differ by
                             # up to 0.8 % in L2 (13 % in one channel's
                             # max) between two CPU runs that differ only
                             # in their thread count, by 2.8 % between an
                             # H100 and the CPU
LENET_BATCH = 64             # the conv net of models/mnist.py
LENET_STEPS = 5
# every launch gate below counts these kernels, in this order: (tiled
# forward, dK/dV, dQ, fused backward, dropout, whole forward, streamed
# forward, streamed dQ, streamed dK/dV, f32 forward, f32 dK/dV, f32 dQ);
# no name of DEVICE_KERNELS is a substring of another (a trace counts by
# substring)
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_kv",
           "flash_attention_bwd_q", "flash_attention_bwd_fused",
           "dropout_fwd", "flash_attention_fwd_whole",
           "flash_attention_fwd_streamed", "flash_attention_bwd_dq_streamed",
           "flash_attention_bwd_dkdv_streamed", "flash_attention_fwd_f32",
           "flash_attention_bwd_dkdv_f32", "flash_attention_bwd_dq_f32")
DEVICE_KERNELS = ("flash_fwd_kernel", "flash_bwd_kv_kernel",
                  "flash_bwd_q_kernel", "flash_bwd_fused_kernel",
                  "dropout_fwd_kernel", "flash_fwd_whole_kernel",
                  "flash_fwd_streamed_kernel", "flash_bwd_dq_streamed_kernel",
                  "flash_bwd_dkdv_streamed_kernel", "flash_fwd_f32_kernel",
                  "flash_bwd_dkdv_f32_kernel", "flash_bwd_dq_f32_kernel")
GATE_NAMES = ("(tiled forward, dK/dV, dQ, fused backward, dropout, whole "
              "forward, streamed forward, streamed dQ, streamed dK/dV, f32 "
              "forward, f32 dK/dV, f32 dQ)")
NO_KERNELS = (0,) * len(KERNELS)
LANE_STEP_WANT = (0, 0, 0, 12, 0, 24, 0, 0, 0, 0, 0, 0)  # bench's bert lane
                                                      # step, plain or
                                                      # remat: bf16, the
                                                      # whole-block forward
                                                      # and the fused
                                                      # backward, no dropout
TRAIN_STEP_WANT = (0, 0, 0, 0, 37, 0, 0, 0, 0, 24, 12, 12)  # the f32
                                                             # BERT-base
                                                             # pretraining
                                                             # step (train,
                                                             # window, guard,
                                                             # AMP): the f32
                                                             # forward, dK/dV
                                                             # and dQ,
                                                             # dropout 0.1
LANE512_STEP_WANT = (0, 0, 0, 0, 0, 0, 24, 12, 12, 0, 0, 0)  # the bert lane at
                                                          # S = 512: bf16,
                                                          # the streamed
                                                          # kernels, no
                                                          # dropout
LANE512_SEQ = 512             # BERT's phase-2 pretraining length
LANE512_BATCH = 64            # pinned: 32768 tokens a step, the S = 128
                              # lane's; no OOM attempts
LANE512_HEADS = 12
DROPOUT_TOL = 1e-6            # dropout kernel vs plain, relative: the same
                              # f32 product, so expected bit for bit
DROPOUT_SETS = 4              # input sets cycled when timing dropout: 4 x
                              # 28 MB exceeds the 50 MB L2
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (published)
# FLOP/s of the card's fastest route to each dtype's product (H100 SXM,
# dense, published): an f32-accurate product as split TF32, three TF32
# products for each at 495 TFLOP/s (faster than the CUDA cores' 67);
# bf16 on the tensor cores at 989
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12,
            # integer ops on the CUDA cores: half the published 67 TFLOP/s
            # of f32 outside the tensor cores (Hopper issues 64 INT32 and
            # 128 FP32 lanes per SM and clock)
            "int32": 67e12 / 2}


def _log(*a):
    print(*a, flush=True)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters=50, warmup=5, graph=True) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` back-to-back calls, after ``warmup`` calls. With ``graph``
    the calls are captured into one CUDA graph and the graph is replayed,
    so the time is the device's alone: the host's dispatch of each call
    (Python, ctypes, PyTorch's dispatcher) is not in it. The warm-up then
    runs on a side stream, as torch.cuda.graphs asks of a capture that
    runs autograd's backward. Without, the calls are issued from Python
    one by one, and a call whose host cost exceeds its device time is
    timed by the host."""
    import torch
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
        run()  # the first replay uploads the graph
    else:
        for _ in range(warmup):
            fn()

        def run():
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flop, nbytes, dtype):
    """(ms, what bounds it): the least time the card could take for
    ``flop`` FLOP of ``dtype`` products moving ``nbytes`` bytes."""
    t_ops = flop / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fwd_bound(B, H, S, Sk, D, dtype, bias=True, causal=False):
    """(bound_ms, bound_by, flop, bytes) of the forward with a key-padding
    bias (or without, ``bias`` False): 4·B·H·S·Sk·D FLOP, or with
    ``causal`` (S = Sk) 4·B·H·D over the S·(S+1)/2 pairs it keeps; q, k, v
    and the bias read once, o and lse written once."""
    elt = 4 if dtype == "float32" else 2
    pairs = S * (S + 1) // 2 if causal else S * Sk
    flop = 4 * B * H * pairs * D
    nbytes = (2 * B * H * S * D + 2 * B * H * Sk * D) * elt \
        + B * Sk * 4 * bias + B * H * S * 4
    return (*bound(flop, nbytes, dtype), flop, nbytes)


def _check_bound(name, ms, bound_ms):
    if ms < bound_ms:
        raise AssertionError(f"{name} timed at {ms:.4f} ms, under its bound "
                             f"{bound_ms:.4f} ms: the timing or the bound "
                             "is wrong")


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------
# a kernel instance's mangled name: <length>flash_..._kernel I <T> Li<D> E
_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '\w*?\d(flash_[a-z0-9_]+_kernel|"
    r"dropout_fwd_kernel)I(f|13__nv_bfloat16)?(?:Li(\d+))?E")


def ptxas_report(text):
    """[(kernel, dtype, head dim, registers, spill stores B, spill loads
    B)] of each kernel instance in ``nvcc -Xptxas -v`` output."""
    out, cur, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            # an instance without a type parameter is bf16 (the fused
            # and streamed kernels take nothing else) or, by its name,
            # f32
            f32 = m.group(2) == "f" or "_f32_" in m.group(1)
            cur = (m.group(1), "f32" if f32 else "bf16",
                   int(m.group(3) or 0))
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((*cur, int(m.group(1)), *spill))
            cur = None
    return out


def phase_build():
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.ops.cuda import build, dropout as dk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    sources = (fa.KERNEL_SOURCE, fa.FWD_WHOLE_SOURCE, fa.BWD_KERNEL_SOURCE,
               fa.BWD_FUSED_SOURCE, fa.FWD_STREAMED_SOURCE,
               fa.BWD_STREAMED_SOURCE, fa.FWD_F32_SOURCE,
               fa.BWD_DKDV_F32_SOURCE, fa.BWD_DQ_F32_SOURCE, dk.KERNEL_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for src in sources:
        build.load(src)
    _log(f"[build] {', '.join(sources)}: {time.perf_counter() - t0:.1f} s "
         "(nvcc -gencode arch=compute_90a,code=sm_90a, in parallel)")
    for src in sources:
        text = build.build_log.get(src, {}).get("ptxas", "")
        for kern, dt, d, regs, st, ld in ptxas_report(text):
            _log(f"[build] ptxas {kern} {dt}" + (f" D={d}" if d else "") +
                 f": {regs} registers, "
                 f"spill stores {st} B, spill loads {ld} B")


# --------------------------------------------------------------------------
# 2. kernel
# --------------------------------------------------------------------------
def _qkv(B, H, Sq, Sk, D, dtype, gen):
    import torch
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, H, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, H, Sk, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


def _padding_bias(B, Sk, gen, neg=-1e9):
    import torch
    lens = torch.randint(Sk // 4, Sk + 1, (B,), generator=gen, device="cuda")
    keep = torch.arange(Sk, device="cuda")[None, :] < lens[:, None]
    return torch.where(keep, 0.0, neg).float()


def _sdpa_mask(bias, sq, sk, causal, dtype):
    """The additive mask SDPA takes for the port's key-padding ``bias``
    [B, Sk] and ``causal`` (SDPA takes no causal flag beside a mask), or
    None."""
    import torch
    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    if causal:
        above = torch.ones(sq, sk, dtype=torch.bool, device="cuda").triu(1)
        mask = (torch.zeros((), dtype=dtype, device="cuda") if mask is None
                else mask).masked_fill(above, float("-inf"))
    return mask


def _check(name, got, want, tol):
    import torch
    o, lse = got
    ro, rlse = want
    err_o = (o.float() - ro.float()).abs().max().item()
    err_l = (lse - rlse).abs().max().item()
    ok = (torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol)
          and torch.allclose(lse, rlse, rtol=tol, atol=tol))
    _log(f"[kernel] {name}: max|dO| {err_o:.3e} max|dlse| {err_l:.3e} "
         f"tol {tol:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{name}")
    return max(err_o, err_l)


def phase_kernel():
    """The forward kernels against the plain version on the card, each
    case by the route fwd_route picks: the whole-block kernel (bf16, S and
    Sk up to 128), the streamed one (bf16 above 128), the f32 one (f32 at
    head dims up to 64; all three run every case twice, bitwise alike) or
    the tiled one (f32 at head dims 65 to 128). Then each forward timed
    at the served shape (batch 8, f32 and bf16, bias), the trained one
    (batch 32, f32 without and with dropout 0.1, bf16 with dropout 0.1),
    the bench lane's (batch 256, bf16, no bias), transformer_big's (greedy
    decode's f32 80 x 64 and causal 80 x 80 among them) and the S = 512
    lane's, beside its bound, its plain version and SDPA; a whole-block,
    streamed or f32 timing also beside the tiled kernel on the same inputs
    (the old route, held to the plain version where it is the streamed or
    the f32 one's; a streamed kernel, and the f32 one at batch 32, slower
    than it fails). → {kernel name: its heading row, with "timings" (every
    shape timed) and "max_abs_err_by_dtype"}: the f32 kernel's heading row
    is the f32 train step's (batch 32, dropout 0.1), and so is the tiled
    kernel's (its old-route timing there), the whole-block one's the
    lane's, the streamed one's the S = 512 lane's."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sm = 0.125
    f32, bf16 = torch.float32, torch.bfloat16
    tiled, whole = "flash_attention_fwd", "flash_attention_fwd_whole"
    streamed, f32k = "flash_attention_fwd_streamed", "flash_attention_fwd_f32"
    kern_of = {"tiled": tiled, "whole": whole, "streamed": streamed,
               "f32": f32k}
    fn_of = {tiled: fa.flash_attention_fwd_tiled_cuda,
             whole: fa.flash_attention_fwd_whole_cuda,
             streamed: fa.flash_attention_fwd_streamed_cuda,
             f32k: fa.flash_attention_fwd_f32_cuda}
    by_name = {"f32": f32, "bf16": bf16}
    errs = {}  # (kernel, dtype or tag) -> max |kernel - plain| over cases

    def both(name, q, k, v, scale, tol, causal=False, rate=0.0, seed=None,
             bias=None, tag=None):
        args = (q, k, v, scale, causal, rate, seed, bias)
        route = fa.fwd_route(q.shape, k.shape, q.dtype)
        got = fa.flash_attention_cuda(*args)
        want = fa.flash_attention_reference(*args)
        torch.cuda.synchronize()
        err = _check(f"{name} {str(q.dtype)[6:]} ({route})", got, want, tol)
        if route != "tiled":
            again = fa.flash_attention_cuda(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"the {route} forward's rerun "
                                     f"differs: {name}")
        key = (kern_of[route], tag or q.dtype)
        errs[key] = max(errs.get(key, 0.0), err)
        return got

    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    B, H, D = 8, 12, 64
    # the served shape (batch 8) and the trained one with dropout (batch
    # 32), key-padding bias
    for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q, k, v = _qkv(B, H, S, S, D, dt, gen)
        both(f"bert B={B} H={H} S={S} D={D} bias", q, k, v, sm, tol,
             bias=_padding_bias(B, S, gen))
        q, k, v = _qkv(TRAIN_BATCH, H, S, S, D, dt, gen)
        both(f"bert B={TRAIN_BATCH} H={H} S={S} D={D} bias dropout 0.1", q,
             k, v, sm, tol, rate=0.1, seed=seed,
             bias=_padding_bias(TRAIN_BATCH, S, gen))
    # ragged, causal, dead row, dropout: f32 beyond 128 (the f32 kernel),
    # bf16 on both sides of 128 (whole, streamed)
    for dt, tol, sq, sk in ((f32, F32_TOL, 200, 77), (bf16, BF16_TOL, 200, 77),
                            (bf16, BF16_TOL, 100, 77),
                            (bf16, BF16_TOL, 200, 300),
                            (bf16, BF16_TOL, 77, 300)):
        q, k, v = _qkv(2, 3, sq, sk, 64, dt, gen)
        both(f"ragged S={sq} Sk={sk} bias", q, k, v, sm, tol,
             bias=_padding_bias(2, sk, gen))
    # the streamed kernel: causal with S != Sk (keys past every row's
    # diagonal; rows past every key), dropout 0.3 over ragged tiles, D = 128
    for sq, sk in ((200, 300), (300, 200)):
        q, k, v = _qkv(2, 3, sq, sk, 64, bf16, gen)
        both(f"causal S={sq} Sk={sk} bias", q, k, v, sm, BF16_TOL,
             causal=True, bias=_padding_bias(2, sk, gen))
        both(f"dropout 0.3 S={sq} Sk={sk} bias", q, k, v, sm, BF16_TOL,
             rate=0.3, seed=seed, bias=_padding_bias(2, sk, gen))
    q, k, v = _qkv(2, 3, 300, 300, 128, bf16, gen)
    both("D=128 causal dropout 0.1 S=Sk=300 bias", q, k, v, 128 ** -0.5,
         BF16_TOL, causal=True, rate=0.1, seed=seed,
         bias=_padding_bias(2, 300, gen))
    # the f32 kernel: dropout 0.3 over ragged 64-key tiles, causal with S
    # != Sk, S = Sk = 1
    for sq, sk in ((200, 300), (300, 200)):
        q, k, v = _qkv(2, 3, sq, sk, 64, f32, gen)
        both(f"dropout 0.3 S={sq} Sk={sk} bias", q, k, v, sm, F32_TOL,
             rate=0.3, seed=seed, bias=_padding_bias(2, sk, gen))
        both(f"causal S={sq} Sk={sk} bias", q, k, v, sm, F32_TOL,
             causal=True, bias=_padding_bias(2, sk, gen))
    q, k, v = _qkv(3, 2, 1, 1, 64, f32, gen)
    both("S=Sk=1", q, k, v, sm, F32_TOL)
    for dt, tol, n in ((f32, F32_TOL, 200), (bf16, BF16_TOL, S)):
        q, k, v = _qkv(2, 3, n, n, 64, dt, gen)
        both(f"causal S=Sk={n}", q, k, v, sm, tol, causal=True)
    for dt, tol, n in ((f32, F32_TOL, 256), (bf16, BF16_TOL, 256),
                       (bf16, BF16_TOL, S)):
        q, k, v = _qkv(2, 3, n, n, 64, dt, gen)
        dead = torch.zeros(2, n, device="cuda")
        dead[0] = -1e30
        got = both(f"dead row S=Sk={n} (bias -1e30 on every key of batch 0)",
                   q, k, v, sm, tol, bias=dead)
        if not (got[0][0].eq(0).all() and got[1][:3].eq(1e30).all()):
            raise AssertionError("dead rows must write O = 0 and lse = +1e30")
        both(f"dropout 0.1 seed 1234 causal bias S=Sk={n}", q, k, v, sm, tol,
             causal=True, rate=0.1, seed=seed, bias=_padding_bias(2, n, gen))
    q, k, v = _qkv(3, 2, 1, 1, 64, bf16, gen)
    both("S=Sk=1", q, k, v, sm, BF16_TOL)
    # head dims off the kernels' instances (40, 96) run zero-padded
    for d in (8, 16, 32, 40, 64, 96, 128):
        q, k, v = _qkv(2, 2, 96, 80, d, f32, gen)
        both(f"head dim {d} S=96 Sk=80 bias", q, k, v, d ** -0.5, F32_TOL,
             bias=_padding_bias(2, 80, gen))
        q, k, v = (t.to(bf16) for t in (q, k, v))
        both(f"head dim {d} S=96 Sk=80", q, k, v, d ** -0.5, BF16_TOL)
        q, k, v = _qkv(2, 2, 200, 144, d, bf16, gen)
        both(f"head dim {d} S=200 Sk=144 bias", q, k, v, d ** -0.5, BF16_TOL,
             bias=_padding_bias(2, 144, gen))
    # B·H above 65535, gridDim.y's limit: one linear grid takes it
    for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q, k, v = _qkv(BIG_BH[0], BIG_BH[1], 16, 16, 64, dt, gen)
        both(f"B*H = {BIG_BH[0] * BIG_BH[1]} S=Sk=16 bias dropout 0.1", q, k,
             v, sm, tol, rate=0.1, seed=seed,
             bias=_padding_bias(BIG_BH[0], 16, gen))
    del q, k, v
    # the bench lane's shape, and the S = 512 lane's
    q, k, v = _qkv(LANE_BATCH, H, S, S, D, bf16, gen)
    both(f"bench lane B={LANE_BATCH} H={H} S={S} D={D} no bias", q, k, v, sm,
         BF16_TOL, tag="lane")
    del q, k, v
    q, k, v = _qkv(LANE512_BATCH, LANE512_HEADS, LANE512_SEQ, LANE512_SEQ, D,
                   bf16, gen)
    both(f"S=512 lane B={LANE512_BATCH} H={LANE512_HEADS} S={LANE512_SEQ} "
         f"D={D} no bias", q, k, v, sm, BF16_TOL)
    del q, k, v
    # transformer_big's shapes (H = 16, D = 64): the bf16 training step's
    # causal self-attention with the bias and attention dropout (whole);
    # greedy decode's f32 cross-attention (S = 80 over Sk = 64) and causal
    # self-attention (the f32 kernel); bf16 at S = Sk = 256 (streamed)
    for name, (bs, sq, sk, dt, rate, with_bias, causal) in \
            TRANSFORMER_FWD_CASES.items():
        q, k, v = _qkv(bs, WMT_HEADS, sq, sk, D, by_name[dt], gen)
        both(f"transformer {name} B={bs} H={WMT_HEADS} S={sq} Sk={sk}", q,
             k, v, sm, F32_TOL if dt == "f32" else BF16_TOL, causal=causal,
             rate=rate, seed=seed,
             bias=_padding_bias(bs, sk, gen) if with_bias else None)
        del q, k, v
    if not {(tiled, f32), (whole, bf16), (streamed, bf16),
            (f32k, f32)} <= set(errs):
        raise AssertionError(f"forward cases by kernel and dtype: "
                             f"{sorted(map(str, errs))}")

    # time the served shape (batch 8, f32 and bf16), the trained one
    # (batch 32: f32, also with dropout 0.1; bf16 with dropout 0.1), the
    # bench lane's (batch 256, bf16, no bias), transformer_big's and the
    # S = 512 lane's, SDPA beside each, the tiled kernel (the old route,
    # held to the plain version too) beside the whole-block, the streamed
    # and the f32 ones; a streamed kernel must beat it, and the f32 one at
    # batch 32
    timings = {tiled: [], whole: [], streamed: [], f32k: []}
    heads = {}
    for bs, hh, sq, sk, dt, rate, with_bias, causal in (
            (B, H, S, S, f32, 0.0, True, False),
            (B, H, S, S, bf16, 0.0, True, False),
            (TRAIN_BATCH, H, S, S, f32, 0.0, True, False),
            (TRAIN_BATCH, H, S, S, f32, 0.1, True, False),
            (TRAIN_BATCH, H, S, S, bf16, 0.1, True, False),
            (LANE_BATCH, H, S, S, bf16, 0.0, False, False),
            *((bs, WMT_HEADS, sq, sk, by_name[dt], rate, with_bias, causal)
              for bs, sq, sk, dt, rate, with_bias, causal
              in TRANSFORMER_FWD_CASES.values()),
            (LANE512_BATCH, LANE512_HEADS, LANE512_SEQ, LANE512_SEQ, bf16,
             0.0, False, False)):
        q, k, v = _qkv(bs, hh, sq, sk, D, dt, gen)
        bias = _padding_bias(bs, sk, gen) if with_bias else None
        mask = _sdpa_mask(bias, sq, sk, causal, dt)
        args = (q, k, v, sm, causal, rate, seed, bias)
        kern = kern_of[fa.fwd_route(q.shape, k.shape, dt)]
        fn = fn_of[kern]
        ms = _cuda_ms(lambda: fn(*args))
        eager_ms = _cuda_ms(lambda: fn(*args), graph=False)
        tiled_ms = (_cuda_ms(lambda: fa.flash_attention_fwd_tiled_cuda(*args))
                    if kern != tiled else ms)
        old_tag = "old route" if dt == bf16 else "old route f32"
        if kern in (streamed, f32k):
            old = _check(f"old route (tiled) {str(dt)[6:]} B={bs} H={hh} "
                         f"S={sq} Sk={sk}",
                         fa.flash_attention_fwd_tiled_cuda(*args),
                         fa.flash_attention_reference(*args),
                         BF16_TOL if dt == bf16 else F32_TOL)
            errs[(tiled, old_tag)] = max(errs.get((tiled, old_tag), 0.0),
                                         old)
        # the plain version's dropout mask reads the seed on the host,
        # which a graph cannot capture: with dropout it is timed eagerly
        plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(*args),
                            graph=not rate)
        lib_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, scale=sm))
        name = str(dt).replace("torch.", "")
        bound_ms, bound_by, ops, nbytes = fwd_bound(bs, hh, sq, sk, D, name,
                                                    with_bias, causal)
        what = f"{name} B={bs} H={hh} S={sq}" + (
            f" Sk={sk}" if sk != sq else "") + f" D={D}" + (
            " causal" if causal else "") + (
            " bias" if with_bias else " no bias") + (
            f" dropout {rate}" if rate else "")
        beside = (f"; the tiled kernel on the same inputs {tiled_ms:.4f} ms, "
                  f"{kern[len(tiled) + 1:]}/tiled {ms / tiled_ms:.3f}"
                  if kern != tiled else "")
        _log(f"[kernel] time {kern} {what}: kernel {ms:.4f} ms (issued one "
             f"by one from Python {eager_ms:.4f} ms), plain {plain_ms:.4f} "
             f"ms, sdpa {lib_ms:.4f} ms ({ms / lib_ms:.3f}x SDPA), bound "
             f"{bound_ms:.4f} ms ({bound_by}: {ops} FLOP, {nbytes} B), "
             f"{bound_ms / ms:.1%} of it{beside}")
        _check_bound(f"{kern} {what}", ms, bound_ms)
        if (kern == streamed or (kern == f32k and bs == TRAIN_BATCH)) \
                and ms >= tiled_ms:
            raise AssertionError(f"the {kern[len(tiled) + 1:]} forward at "
                                 f"{what} takes {ms:.4f} ms, the old route "
                                 f"{tiled_ms:.4f}")
        row = dict(shape=what, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=errs[(kern, "lane" if bs == LANE_BATCH
                                     else dt)])
        if kern != tiled:
            row["tiled_ms"] = tiled_ms
        timings[kern].append(row)
        if kern == f32k:
            # the old route on the same inputs: the tiled kernel's row
            old_row = dict(row, ms=tiled_ms, eager_ms=None,
                           max_abs_err=errs[(tiled, old_tag)])
            del old_row["tiled_ms"]
            timings[tiled].append(old_row)
            if rate and hh == H:  # the f32 train step's rows
                heads[f32k], heads[tiled] = row, old_row
        elif hh == H and not with_bias:
            heads[kern] = row  # the lane's row, the S = 512 lane's
        del q, k, v
    return {kern: dict(heads[kern], timings=ts, max_abs_err_by_dtype={
        str(tag).replace("torch.", ""): e
        for (kn, tag), e in errs.items() if kn == kern})
        for kern, ts in timings.items()}


def _check_bwd(name, got, want, tol, names=("dQ", "dK", "dV")):
    """Each of ``got`` against ``want`` (the grads ``names``) within
    ``tol`` → the max |difference| of each; fails the run if one is off."""
    import torch
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    ok = all(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
             for g, w in zip(got, want))
    _log(f"[kernel] bwd {name}: "
         + " ".join(f"max|d {n}| {e:.3e}" for n, e in zip(names, errs))
         + f" tol {tol:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"backward kernels disagree with their plain "
                             f"version: {name}")
    return errs


def _bwd_bound(B, H, S, Sk, D, flop_units, n_out, dtype="float32",
               bias=True, causal=False):
    """(bound_ms, bound_by, flop, bytes) of a backward function doing
    ``flop_units``·B·H·S·Sk·D FLOP of ``dtype`` products (with ``causal``,
    S = Sk, over the S·(S+1)/2 pairs it keeps), reading the bias (if
    ``bias``) once. ``n_out`` "q" (dQ) or "kv" (dK and dV): a split
    kernel, which reads q, k, v, dO, lse and delta once and writes its
    outputs once (the streamed dK/dV kernel alike: lse and delta come in
    one buffer); "q_streamed": the streamed dQ kernel, which reads q, k,
    v, O, dO and lse and writes dQ, lse and delta; "q_f32": the f32 dQ
    kernel, which reads q, k, v, O, dO and lse and writes dQ and delta;
    "qkv": the whole
    backward, the function SDPA's backward computes, which reads its
    inputs q, k, v, O, dO and lse once and writes dQ, dK and dV once."""
    elt = 4 if dtype == "float32" else 2
    pairs = S * (S + 1) // 2 if causal else S * Sk
    flop = flop_units * B * H * pairs * D
    q_b, kv_b = B * H * S * D * elt, B * H * Sk * D * elt
    rows = B * H * S * 4  # lse or delta, f32
    nbytes = B * Sk * 4 * bias + {
        "q": 2 * q_b + 2 * kv_b + 2 * rows + q_b,
        "kv": 2 * q_b + 2 * kv_b + 2 * rows + 2 * kv_b,
        "q_streamed": 3 * q_b + 2 * kv_b + rows + q_b + 2 * rows,
        "q_f32": 3 * q_b + 2 * kv_b + rows + q_b + rows,
        "qkv": 3 * q_b + 2 * kv_b + rows + q_b + 2 * kv_b}[n_out]
    return (*bound(flop, nbytes, dtype), flop, nbytes)


def _bwd_yardstick(q, k, v, do, bias, sm, rate, seed, causal=False):
    """The whole backward (dQ, dK and dV) of SDPA and of the port, each
    timed on the device as (forward + backward) minus the forward alone,
    both captured into CUDA graphs (SDPA's dropout RNG captures too): →
    (sdpa_ms, port_ms). The port's backward is flash_attention_bwd_cuda:
    the fused kernel, the streamed pair, the f32 dQ (delta inside) and
    dK/dV kernels, or bwd_delta and the split kernels, as bwd_route
    picks."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask = _sdpa_mask(bias, q.shape[2], k.shape[2], causal, q.dtype)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              dropout_p=rate, scale=sm)

    def port():
        return fa.flash_attention_cuda(q, k, v, sm, causal, rate, seed,
                                       bias)

    def port_fwd_bwd():
        o, lse = port()
        return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, sm, causal,
                                           rate, seed, bias)
    sdpa_ms = _cuda_ms(lambda: torch.autograd.grad(
        sdpa(), (qs, ks, vs), do)) - _cuda_ms(sdpa)
    return sdpa_ms, _cuda_ms(port_fwd_bwd) - _cuda_ms(port)


def phase_kernel_bwd():
    """The backward kernels against the plain backward, on the forward
    kernel's O and lse: each case runs the route bwd_route picks, the
    fused kernel (bf16, S and Sk up to 128), the streamed dQ and dK/dV
    kernels (bf16 above 128), the f32 route (f32 at head dims up to 64:
    the f32 dQ kernel, which writes delta, then the f32 dK/dV kernel; the
    dQ kernel's dQ and delta also alone against the plain version) or the
    split dK/dV and dQ kernels (f32 at head dims 65 to 128). The fused,
    streamed and f32 routes run every case twice and must give bitwise
    equal results. Then, at the served shape (B=8, H=12, S=128, D=64, f32,
    bias), the training shape (B=32) in f32 without and with dropout 0.1
    and in bf16, at the bench lane's (batch 256, bf16, no bias),
    transformer_big's step, B3's (S = 256) and the S = 512 lane's, each
    kernel of the shape's route timed beside its bound and plain version,
    and the graph-timed whole backward of SDPA and of the port; in bf16
    also the split route's whole backward (bwd_delta, dK/dV, dQ) on the
    same inputs (the old route beside the streamed pair, held to the plain
    version and beaten by it); in f32 the split route's dK/dV kernel, and
    bwd_delta with its dQ kernel, on the same inputs (the old route beside
    the f32 kernels, held to the plain version, and at batch 32 beaten by
    them), and bwd_delta alone."""
    import torch
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    sm = 0.125
    errs = {}  # (kernel, dtype or tag) -> max |kernel - plain| over cases

    def both(name, q, k, v, scale, tol, causal=False, rate=0.0, seed=None,
             bias=None, tag=None):
        o, lse = fa.flash_attention_cuda(q, k, v, scale, causal, rate, seed,
                                         bias)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        args = (q, k, v, o, lse, do, scale, causal, rate, seed, bias)
        route = fa.bwd_route(q.shape, k.shape, q.dtype)
        got = fa.flash_attention_bwd_cuda(*args)
        want = fa.flash_attention_bwd_reference(*args)
        torch.cuda.synchronize()
        e_q, e_k, e_v = _check_bwd(f"{name} ({route})", got, want, tol)
        if route != "split":
            again = fa.flash_attention_bwd_cuda(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"the {route} backward's rerun "
                                     f"differs: {name}")
        if route == "f32":
            # the f32 dQ kernel alone: its dQ and the delta it writes (what
            # the f32 dK/dV kernel reads), against the plain version, and
            # its rerun bitwise
            dq1 = fa.flash_attention_bwd_dq_f32_cuda(*args)
            dq2 = fa.flash_attention_bwd_dq_f32_cuda(*args)
            e_q = max(e_q, *_check_bwd(
                f"{name} (the f32 dQ kernel alone)", dq1,
                fa.flash_attention_bwd_dq_f32_reference(*args), tol,
                ("dQ", "delta")))
            if not all(torch.equal(a, b) for a, b in zip(dq1, dq2)):
                raise AssertionError(f"the f32 dQ kernel's rerun differs: "
                                     f"{name}")
        if route == "fused":
            found = (("flash_attention_bwd_fused", max(e_q, e_k, e_v)),)
        elif route == "streamed":
            found = (("flash_attention_bwd_dq_streamed", e_q),
                     ("flash_attention_bwd_dkdv_streamed", max(e_k, e_v)))
        elif route == "f32":
            found = (("flash_attention_bwd_dq_f32", e_q),
                     ("flash_attention_bwd_dkdv_f32", max(e_k, e_v)))
        else:
            found = (("flash_attention_bwd_q", e_q),
                     ("flash_attention_bwd_kv", max(e_k, e_v)))
        for kern, e in found:
            key = (kern, tag or q.dtype)
            errs[key] = max(errs.get(key, 0.0), e)
        return got

    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    B, H, D = TRAIN_BATCH, 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q, k, v = _qkv(B, H, S, S, D, dt, gen)
        both(f"bert B={B} H={H} S={S} D={D} {dt} bias dropout 0.1", q, k, v,
             sm, tol, rate=0.1, seed=seed, bias=_padding_bias(B, S, gen))
    for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q, k, v = _qkv(2, 3, 200, 77, 64, dt, gen)
        both(f"ragged S=200 Sk=77 bias {dt}", q, k, v, sm, tol,
             bias=_padding_bias(2, 77, gen))
    q, k, v = _qkv(2, 3, 200, 200, 64, f32, gen)
    both("causal ragged S=Sk=200", q, k, v, sm, F32_TOL, causal=True)
    for dt, tol, n in ((f32, F32_TOL, 256), (bf16, BF16_TOL, S),
                       (bf16, BF16_TOL, 256)):
        q, k, v = _qkv(2, 3, n, n, 64, dt, gen)
        dead = torch.zeros(2, n, device="cuda")
        dead[0] = -1e30
        dq, dk, dv = both(f"dead row S=Sk={n} {dt} (bias -1e30 on every "
                          "key of batch 0)", q, k, v, sm, tol, bias=dead)
        if not (dq[0].eq(0).all() and dk[0].eq(0).all()
                and dv[0].eq(0).all()):
            raise AssertionError("dead rows must give zero dQ, dK and dV")
        both(f"dropout 0.1 seed 1234 causal bias S=Sk={n} {dt}", q, k, v,
             sm, tol, causal=True, rate=0.1, seed=seed,
             bias=_padding_bias(2, n, gen))
    q, k, v = _qkv(2, 3, 100, 77, 64, bf16, gen)
    both("ragged S=100 Sk=77 bias dropout 0.1 bf16", q, k, v, sm, BF16_TOL,
         rate=0.1, seed=seed, bias=_padding_bias(2, 77, gen))
    # the streamed kernels: ragged 200 x 300 and 77 x 300, causal with S !=
    # Sk (keys no row reaches get dK = dV = 0), dropout 0.3, D = 128
    for sq, sk in ((200, 300), (77, 300), (300, 200)):
        q, k, v = _qkv(2, 3, sq, sk, 64, bf16, gen)
        both(f"ragged S={sq} Sk={sk} bias bf16", q, k, v, sm, BF16_TOL,
             bias=_padding_bias(2, sk, gen))
        both(f"causal S={sq} Sk={sk} bias bf16", q, k, v, sm, BF16_TOL,
             causal=True, bias=_padding_bias(2, sk, gen))
        both(f"dropout 0.3 S={sq} Sk={sk} bias bf16", q, k, v, sm, BF16_TOL,
             rate=0.3, seed=seed, bias=_padding_bias(2, sk, gen))
    q, k, v = _qkv(2, 3, 300, 300, 128, bf16, gen)
    both("D=128 causal dropout 0.1 S=Sk=300 bias bf16", q, k, v,
         128 ** -0.5, BF16_TOL, causal=True, rate=0.1, seed=seed,
         bias=_padding_bias(2, 300, gen))
    q, k, v = _qkv(3, 2, 1, 1, 64, bf16, gen)
    both("S=Sk=1 bf16", q, k, v, sm, BF16_TOL)
    # the f32 route: S = Sk = 1, dropout 0.3 and causal with S != Sk over
    # ragged stages and key tiles
    q, k, v = _qkv(3, 2, 1, 1, 64, f32, gen)
    both("S=Sk=1 f32", q, k, v, sm, F32_TOL)
    for sq, sk in ((200, 300), (300, 200)):
        q, k, v = _qkv(2, 3, sq, sk, 64, f32, gen)
        both(f"dropout 0.3 S={sq} Sk={sk} bias f32", q, k, v, sm, F32_TOL,
             rate=0.3, seed=seed, bias=_padding_bias(2, sk, gen))
        both(f"causal S={sq} Sk={sk} bias f32", q, k, v, sm, F32_TOL,
             causal=True, bias=_padding_bias(2, sk, gen))
    for d in (8, 16, 32, 40, 96, 128):
        q, k, v = _qkv(2, 2, 96, 80, d, f32, gen)
        both(f"head dim {d}", q, k, v, d ** -0.5, F32_TOL,
             bias=_padding_bias(2, 80, gen))
        q, k, v = (t.to(bf16) for t in (q, k, v))
        both(f"head dim {d} bf16", q, k, v, d ** -0.5, BF16_TOL)
        q, k, v = _qkv(2, 2, 200, 144, d, bf16, gen)
        both(f"head dim {d} S=200 Sk=144 bias bf16", q, k, v, d ** -0.5,
             BF16_TOL, bias=_padding_bias(2, 144, gen))
    for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q, k, v = _qkv(BIG_BH[0], BIG_BH[1], 16, 16, 64, dt, gen)
        both(f"B*H = {BIG_BH[0] * BIG_BH[1]} S=Sk=16 bias dropout 0.1 {dt}",
             q, k, v, sm, tol, rate=0.1, seed=seed,
             bias=_padding_bias(BIG_BH[0], 16, gen))
    q, k, v = _qkv(LANE_BATCH, H, S, S, D, bf16, gen)
    both(f"bench lane B={LANE_BATCH} H={H} S={S} D={D} bf16 no bias", q, k,
         v, sm, BF16_TOL, tag="lane")
    del q, k, v
    q, k, v = _qkv(LANE512_BATCH, LANE512_HEADS, LANE512_SEQ, LANE512_SEQ, D,
                   bf16, gen)
    both(f"S=512 lane B={LANE512_BATCH} H={LANE512_HEADS} S={LANE512_SEQ} "
         f"D={D} bf16 no bias", q, k, v, sm, BF16_TOL)
    del q, k, v
    # transformer_big's bf16 training step (fused) and bf16 at S = 256
    # (split, ROADMAP B3)
    for name in ("train self-attention", "B3 S=256"):
        bs, sq, sk, _, rate, with_bias, causal = TRANSFORMER_FWD_CASES[name]
        q, k, v = _qkv(bs, WMT_HEADS, sq, sk, D, bf16, gen)
        both(f"transformer {name} B={bs} H={WMT_HEADS} S={sq} Sk={sk}", q,
             k, v, sm, BF16_TOL, causal=causal, rate=rate, seed=seed,
             bias=_padding_bias(bs, sk, gen) if with_bias else None)
        del q, k, v
    # every kernel ran (the split ones in f32 at head dims above 64: bf16
    # beyond S, Sk = 128 takes the streamed kernels; the split dK/dV
    # kernel's instances are held to the plain version in the timing rows
    # below too, as the old route)
    ran = {(kern, tag) for kern, tag in errs}
    for kern, dt in (("flash_attention_bwd_q", f32),
                     ("flash_attention_bwd_kv", f32),
                     ("flash_attention_bwd_dkdv_f32", f32),
                     ("flash_attention_bwd_dq_f32", f32),
                     ("flash_attention_bwd_fused", bf16),
                     ("flash_attention_bwd_dq_streamed", bf16),
                     ("flash_attention_bwd_dkdv_streamed", bf16)):
        if (kern, dt) not in ran:
            raise AssertionError(f"{kern}: no case in {dt}")

    # time at the training shape: B=32, H=12, S=128, D=64, bias; f32
    # without and with dropout 0.1 (as the training step runs them), bf16;
    # at the bench lane's: B=256, bf16, no bias; at transformer_big's bf16
    # step (B=48, H=16, S=64, causal, bias, dropout 0.3); bf16 at S = 256
    # (ROADMAP B3) and the S = 512 lane's (B=64, no bias) on the streamed
    # kernels, beside the old split route on the same inputs
    split = (("flash_attention_bwd_kv", fa.flash_attention_bwd_kv_cuda,
              fa.flash_attention_bwd_kv_reference, 8, "kv"),
             ("flash_attention_bwd_q", fa.flash_attention_bwd_q_cuda,
              fa.flash_attention_bwd_q_reference, 6, "q"))
    rows, timings = {}, {}
    b3_batch, b3_len = TRANSFORMER_FWD_CASES["B3 S=256"][:2]
    for bs, hh, n, dt, rate, with_bias, causal in (
            (SERVE_BATCHES[1], H, S, f32, 0.0, True, False),
            (B, H, S, f32, 0.0, True, False), (B, H, S, f32, 0.1, True, False),
            (B, H, S, bf16, 0.0, True, False),
            (LANE_BATCH, H, S, bf16, 0.0, False, False),
            (WMT_BATCH, WMT_HEADS, WMT_LEN, bf16, WMT_DROPOUT, True, True),
            (b3_batch, WMT_HEADS, b3_len, bf16, 0.0, True, False),
            (LANE512_BATCH, LANE512_HEADS, LANE512_SEQ, bf16, 0.0, False,
             False)):
        q, k, v = _qkv(bs, hh, n, n, D, dt, gen)
        bias = _padding_bias(bs, n, gen) if with_bias else None
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        o, lse = fa.flash_attention_cuda(q, k, v, sm, causal, rate, seed,
                                         bias)
        name_dt = str(dt).replace("torch.", "")
        what = f"{name_dt} B={bs} H={hh} S={n} D={D}" + (
            " causal" if causal else "") + (
            " bias" if with_bias else " no bias") + (
            f" dropout {rate}" if rate else "")
        route = fa.bwd_route(q.shape, k.shape, dt)
        err_tag = "lane" if bs == LANE_BATCH else dt
        lib_ms, port_ms = _bwd_yardstick(q, k, v, do, bias, sm, rate, seed,
                                         causal)
        # the plain version's dropout mask reads the seed on the host,
        # which a graph cannot capture: with dropout it is timed eagerly
        plain_iters = 50 if bs <= B else 10
        bnd, by, flop, nbytes = _bwd_bound(bs, hh, n, n, D, 10, "qkv",
                                           name_dt, with_bias, causal)
        if route == "fused":
            bwd_args = (q, k, v, o, lse, do, sm, causal, rate, seed, bias)
            ms = _cuda_ms(lambda: fa.flash_attention_bwd_fused_cuda(
                *bwd_args))
            eager_ms = _cuda_ms(lambda: fa.flash_attention_bwd_fused_cuda(
                *bwd_args), graph=False)
            plain = _cuda_ms(lambda: fa.flash_attention_bwd_reference(
                *bwd_args), graph=not rate, iters=plain_iters)
            split_ms = _cuda_ms(lambda: fa.flash_attention_bwd_split_cuda(
                *bwd_args))
            _log(f"[kernel] time flash_attention_bwd_fused {what}: kernel "
                 f"{ms:.4f} ms (issued one by one from Python "
                 f"{eager_ms:.4f} ms), plain {plain:.4f} ms, SDPA backward "
                 f"(dQ, dK, dV together, graph-timed) {lib_ms:.4f} ms, "
                 f"{ms / lib_ms:.3f}x SDPA; bound {bnd:.4f} ms ({by}: {flop} "
                 f"FLOP, {nbytes} B = q, k, v, O, dO, lse read and dQ, dK, "
                 f"dV written once), {bnd / ms:.1%} of it; the split route "
                 f"on the same inputs (bwd_delta, dK/dV, dQ; graph-timed) "
                 f"{split_ms:.4f} ms")
            _check_bound(f"flash_attention_bwd_fused {what}", ms, bnd)
            row = dict(shape=what, ms=ms, eager_ms=eager_ms, plain_ms=plain,
                       library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                       split_route_ms=split_ms,
                       max_abs_err=errs[("flash_attention_bwd_fused",
                                         err_tag)])
            timings.setdefault("flash_attention_bwd_fused", []).append(row)
            if not with_bias:  # the lane's row heads the kernel's entry
                rows["flash_attention_bwd_fused"] = row
            alone = f"the fused kernel alone {ms:.4f} ms"
        elif route == "streamed":
            bwd_args = (q, k, v, o, lse, do, sm, causal, rate, seed, bias)
            tail = (sm, causal, rate, seed, bias)
            delta = fa.bwd_delta(o, do)
            stats = fa.flash_attention_bwd_dq_streamed_cuda(
                q, k, v, o, lse, do, *tail)[1]
            pair_ms = _cuda_ms(lambda: fa.flash_attention_bwd_streamed_cuda(
                *bwd_args))
            split_ms = _cuda_ms(lambda: fa.flash_attention_bwd_split_cuda(
                *bwd_args))
            # the old route's bf16 instances, held to the plain version
            old = _check_bwd(f"old route (split) {what}",
                             fa.flash_attention_bwd_split_cuda(*bwd_args),
                             fa.flash_attention_bwd_reference(*bwd_args),
                             BF16_TOL)
            for kern, e in (("flash_attention_bwd_q", old[0]),
                            ("flash_attention_bwd_kv", max(old[1:]))):
                errs[(kern, "old route")] = max(
                    errs.get((kern, "old route"), 0.0), e)
            if pair_ms >= split_ms:
                raise AssertionError(f"the streamed backward at {what} "
                                     f"takes {pair_ms:.4f} ms, the old "
                                     f"route {split_ms:.4f}")
            parts = (
                ("flash_attention_bwd_dq_streamed",
                 lambda: fa.flash_attention_bwd_dq_streamed_cuda(
                     q, k, v, o, lse, do, *tail),
                 lambda: fa.flash_attention_bwd_q_reference(
                     q, k, v, do, lse, fa.bwd_delta(o, do), *tail),
                 6, "q_streamed"),
                ("flash_attention_bwd_dkdv_streamed",
                 lambda: fa.flash_attention_bwd_dkdv_streamed_cuda(
                     q, k, v, do, stats, *tail),
                 lambda: fa.flash_attention_bwd_kv_reference(
                     q, k, v, do, lse, delta, *tail),
                 8, "kv"))
            for name, cuda_fn, plain_fn, units, outs in parts:
                ms = _cuda_ms(cuda_fn)
                eager_ms = _cuda_ms(cuda_fn, graph=False)
                plain = _cuda_ms(plain_fn, graph=not rate,
                                 iters=plain_iters)
                kbnd, kby, kflop, kbytes = _bwd_bound(
                    bs, hh, n, n, D, units, outs, name_dt, with_bias, causal)
                _log(f"[kernel] time {name} {what}: kernel {ms:.4f} ms "
                     f"(issued one by one from Python {eager_ms:.4f} ms), "
                     f"plain {plain:.4f} ms, SDPA backward (dQ, dK, dV "
                     f"together, graph-timed) {lib_ms:.4f} ms, bound "
                     f"{kbnd:.4f} ms ({kby}: {kflop} FLOP, {kbytes} B), "
                     f"{kbnd / ms:.1%} of it")
                _check_bound(f"{name} {what}", ms, kbnd)
                row = dict(shape=what, ms=ms, eager_ms=eager_ms,
                           plain_ms=plain, library_ms=lib_ms, bound_ms=kbnd,
                           bound_by=kby, max_abs_err=errs[(name, dt)],
                           pair_ms=pair_ms, split_route_ms=split_ms)
                timings.setdefault(name, []).append(row)
                if not with_bias:  # the S = 512 lane's row heads it
                    rows[name] = row
            alone = (f"the streamed pair alone {pair_ms:.4f} ms (the dQ "
                     f"kernel with delta, then dK/dV: 14·B·H·S·Sk·D FLOP "
                     f"executed, recomputing QK^T and dO·V^T in each; "
                     f"whole bound {bnd:.4f} ms, {bnd / pair_ms:.1%} of "
                     f"it); the old route on the same inputs (bwd_delta, "
                     f"dK/dV, dQ; graph-timed) {split_ms:.4f} ms, "
                     f"streamed/split {pair_ms / split_ms:.3f}")
            del delta, stats
        else:
            # the f32 route: the f32 dQ kernel (delta inside), then the f32
            # dK/dV kernel; the old route's kernels (the split route's:
            # bwd_delta with its dQ kernel, its dK/dV kernel) timed beside
            # them on the same inputs and held to the plain version
            kv_old, q_old = "flash_attention_bwd_kv", "flash_attention_bwd_q"
            delta = fa.bwd_delta(o, do)
            tail = (sm, causal, rate, seed, bias)
            args = (q, k, v, do, lse, delta, *tail)
            bwd_args = (q, k, v, o, lse, do, *tail)
            delta_ms = _cuda_ms(lambda: fa.bwd_delta(o, do))
            old_dq_ms = _cuda_ms(lambda: fa.flash_attention_bwd_q_cuda(
                q, k, v, do, lse, fa.bwd_delta(o, do), *tail))
            split_ms = _cuda_ms(lambda: fa.flash_attention_bwd_split_cuda(
                *bwd_args))
            old = _check_bwd(f"old route (split) {what}",
                             fa.flash_attention_bwd_split_cuda(*bwd_args),
                             fa.flash_attention_bwd_reference(*bwd_args),
                             F32_TOL)
            for kern, e in ((q_old, old[0]), (kv_old, max(old[1:]))):
                errs[(kern, "old route f32")] = max(
                    errs.get((kern, "old route f32"), 0.0), e)
            kern_ms, times = 0.0, {}
            for name, cuda_fn, plain_fn, units, outs, kargs in (
                    ("flash_attention_bwd_dq_f32",
                     fa.flash_attention_bwd_dq_f32_cuda,
                     fa.flash_attention_bwd_dq_f32_reference, 6, "q_f32",
                     bwd_args),
                    ("flash_attention_bwd_dkdv_f32",
                     fa.flash_attention_bwd_dkdv_f32_cuda,
                     fa.flash_attention_bwd_kv_reference, 8, "kv", args),
                    *((n, c, p, u, out, args) for n, c, p, u, out in split)):
                ms = _cuda_ms(lambda: cuda_fn(*kargs))
                eager_ms = _cuda_ms(lambda: cuda_fn(*kargs), graph=False)
                plain = _cuda_ms(lambda: plain_fn(*kargs), graph=not rate,
                                 iters=plain_iters)
                kbnd, kby, kflop, kbytes = _bwd_bound(
                    bs, hh, n, n, D, units, outs, name_dt, with_bias, causal)
                _log(f"[kernel] time {name} {what}"
                     + (" (old route)" if name in (kv_old, q_old) else "") +
                     f": kernel {ms:.4f} ms (issued one by one from Python "
                     f"{eager_ms:.4f} ms), plain {plain:.4f} ms, SDPA "
                     f"backward (dQ, dK, dV together, graph-timed) "
                     f"{lib_ms:.4f} ms, bound {kbnd:.4f} ms ({kby}: {kflop} "
                     f"FLOP, {kbytes} B), {kbnd / ms:.1%} of it")
                _check_bound(f"{name} {what}", ms, kbnd)
                times[name] = ms
                if name not in (kv_old, q_old):
                    kern_ms += ms
                row = dict(shape=what, ms=ms, eager_ms=eager_ms,
                           plain_ms=plain, library_ms=lib_ms, bound_ms=kbnd,
                           bound_by=kby, max_abs_err=errs[
                               (name, "old route f32"
                                if name in (kv_old, q_old) else dt)])
                timings.setdefault(name, []).append(row)
                if rate and bs == B:  # the f32 train step's row heads it
                    rows[name] = row
            dkdv_ms, dq_ms = times["flash_attention_bwd_dkdv_f32"], \
                times["flash_attention_bwd_dq_f32"]
            timings["flash_attention_bwd_dkdv_f32"][-1].update(
                old_route_ms=times[kv_old], split_route_ms=split_ms)
            timings["flash_attention_bwd_dq_f32"][-1].update(
                old_route_ms=old_dq_ms, delta_ms=delta_ms,
                split_route_ms=split_ms)
            _log(f"[kernel] time flash_attention_bwd_dq_f32 {what}: the f32 "
                 f"dQ kernel (delta inside) {dq_ms:.4f} ms; the old route on "
                 f"the same inputs, bwd_delta + the split route's dQ kernel "
                 f"(graph-timed together) {old_dq_ms:.4f} ms (bwd_delta "
                 f"alone {delta_ms:.4f} ms, the dQ kernel alone "
                 f"{times[q_old]:.4f} ms), f32/old {dq_ms / old_dq_ms:.3f}")
            if bs == B and dkdv_ms >= times[kv_old]:
                raise AssertionError(f"the f32 dK/dV kernel at {what} takes "
                                     f"{dkdv_ms:.4f} ms, the old route "
                                     f"{times[kv_old]:.4f}")
            if bs == B and dq_ms >= old_dq_ms:
                raise AssertionError(f"the f32 dQ kernel at {what} takes "
                                     f"{dq_ms:.4f} ms, the old route "
                                     f"(bwd_delta + dQ) {old_dq_ms:.4f}")
            alone = (f"the f32 route's two kernels alone {kern_ms:.4f} ms "
                     f"(the f32 dQ kernel with delta, then the f32 dK/dV "
                     f"kernel: they execute 14·B·H·S·Sk·D FLOP, recomputing "
                     f"QK^T and dO·V^T in each); the old route's dK/dV "
                     f"kernel on the same inputs {times[kv_old]:.4f} ms, "
                     f"f32/old {dkdv_ms / times[kv_old]:.3f}; the split "
                     f"route's whole backward (bwd_delta, dK/dV, dQ; "
                     f"graph-timed) {split_ms:.4f} ms")
            del delta, args, bwd_args
        _log(f"[kernel] time whole backward {what}, graph-timed as (forward "
             f"+ backward) - forward: the port ({route} route) "
             f"{port_ms:.4f} ms, SDPA {lib_ms:.4f} ms; {alone}; bound "
             f"{bnd:.4f} ms ({by}: {flop} FLOP = 10·B·H·S·Sk·D, {nbytes} B)")
        _check_bound(f"the port's whole backward {what}", port_ms, bnd)
        del q, k, v, do, o, lse
    for name, ts in timings.items():
        rows[name] = dict(rows[name], timings=ts, max_abs_err_by_dtype={
            str(tag).replace("torch.", ""): e
            for (kern, tag), e in errs.items() if kern == name})
    return rows


def _op_attention(q, k, v, heads, bias, rate, key, do):
    """fused_attention_qkv's kernel on the card on q, k, v [B, S, heads·D]
    and its backward by autograd against ``do`` → (route the op took, out,
    dq, dk, dv, GATE_NAMES kernel launches)."""
    import torch
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.ops.registry import OPS
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    B, Sq, hd = q.shape
    route = attention_ops.attention_route(
        (B, heads, Sq, hd // heads), (B, heads, k.shape[1], hd // heads),
        None if bias is None else tuple(bias.shape))
    before = _launch_counts()
    o = OPS.get("fused_attention_qkv").kernel(
        {"Q": [qs], "K": [ks], "V": [vs], "Bias": [bias]},
        {"num_heads": heads, "dropout_rate": rate, "causal": False,
         "_rng": lambda: key})["Out"][0]
    grads = torch.autograd.grad(o, (qs, ks, vs), do)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(_launch_counts(), before))
    return (route, o.detach(), *grads, launched)


def _plain_attention(q, k, v, heads, bias, rate, seed, do):
    """The same attention by the flash kernels' plain versions on the
    card (they take any head dim) → (out, dq, dk, dv)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def split(t):
        B, S_, hd = t.shape
        return t.reshape(B, S_, heads, hd // heads).permute(0, 2, 1, 3) \
            .contiguous()

    def merge(t):
        B, H, S_, d = t.shape
        return t.permute(0, 2, 1, 3).reshape(B, S_, H * d)
    qh, kh, vh, doh = (split(t) for t in (q, k, v, do))
    sm = (q.shape[-1] // heads) ** -0.5
    kp = None if bias is None else \
        bias.expand(q.shape[0], 1, 1, -1).reshape(q.shape[0], -1)
    o, lse = fa.flash_attention_reference(qh, kh, vh, sm, False, rate, seed,
                                          kp)
    grads = fa.flash_attention_bwd_reference(qh, kh, vh, o, lse, doh, sm,
                                             False, rate, seed, kp)
    return (merge(o), *(merge(g) for g in grads))


def phase_attention_routes():
    """The attention ops' route on the card (ROADMAP C1): at hidden 768
    with 8 heads (D = 96, which the kernels run zero-padded to 128) the
    op launches the forward once and its backward once, the tiled forward
    and the dK/dV and dQ kernels in f32 (128 is above the f32 kernels'
    instances), the whole-block forward and the fused kernel in bf16 (S =
    128), and agrees
    with the plain versions; a bias the kernels do not
    take ([1, 1, 1, Sk]) takes the einsum path, launches no kernel, and
    its dropout mask is the flash kernels' (its output and grads agree
    with the plain flash version at the same seed); a head dim above 128
    (D = 192) and an f16 operand, which have no kernel instance, raise
    and launch nothing."""
    import torch
    from paddle_tpu_torch.ops import rng
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    key = torch.tensor([987654321], dtype=torch.int64, device="cuda")
    seed = rng.attention_seed(key)
    for hidden, heads, dt, rate, bias_kind, want_route, want in (
            (768, 8, torch.float32, 0.0, "key-padding", "flash",
             (1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
            (768, 8, torch.bfloat16, 0.0, "key-padding", "flash",
             (0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0)),
            (768, 8, torch.float32, 0.1, "key-padding", "flash",
             (1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
            (768, 8, torch.bfloat16, 0.1, "key-padding", "flash",
             (0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0)),
            (768, 12, torch.float32, 0.1, "[1,1,1,Sk]", "einsum",
             NO_KERNELS)):
        q, k, v, do = (torch.randn(2, S, hidden, generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        bias = _padding_bias(2, S, gen)[:, None, None, :]
        if bias_kind != "key-padding":
            bias = bias[:1]
        route, *got, launched = _op_attention(q, k, v, heads, bias, rate,
                                              key, do)
        want_vals = _plain_attention(q, k, v, heads, bias, rate, seed, do)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want_vals)]
        ok = route == want_route and launched == want and all(
            torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
            for g, w in zip(got, want_vals))
        _log(f"[route] fused_attention_qkv hidden {hidden} heads {heads} "
             f"(D={hidden // heads}) {str(dt)[6:]} {bias_kind} bias dropout "
             f"{rate}: route {route}, launches {GATE_NAMES} "
             f"{launched}, against the plain flash version max|d| out "
             f"{errs[0]:.3e} dQ {errs[1]:.3e} dK {errs[2]:.3e} dV "
             f"{errs[3]:.3e} tol {tol:g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention route at D={hidden // heads} "
                                 f"{bias_kind} bias: want {want_route} "
                                 f"with {want} launches")
    for hidden, heads, dt, err in ((384, 2, torch.float32, ValueError),
                                   (768, 12, torch.float16, TypeError)):
        q = torch.randn(2, S, hidden, generator=gen, device="cuda").to(dt)
        bias = _padding_bias(2, S, gen)[:, None, None, :]
        before = _launch_counts()
        try:
            _op_attention(q, q, q, heads, bias, 0.1, key, q)
        except err as e:
            raised = str(e)
        else:
            raised = None
        launched = tuple(a - b for a, b in zip(_launch_counts(), before))
        ok = raised is not None and launched == NO_KERNELS
        _log(f"[route] fused_attention_qkv D={hidden // heads} "
             f"{str(dt)[6:]}: no kernel instance, raised "
             f"{err.__name__}: {raised}; launches {launched} -> "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention at D={hidden // heads} "
                                 f"{dt}: want {err.__name__}, no launch")
    _nan_bias_routes(gen)


def _nan_bias_routes(gen):
    """A NaN in the key-padding bias (an input mask gone bad) reaches O on
    every forward route as in the plain version and the TPU kernels
    (jnp.maximum keeps a NaN where fmaxf drops it): one key's NaN makes
    its batch's rows NaN, and so does every key's (no row of it is dead);
    the other batch agrees with the plain version within the route's
    tolerance."""
    import torch
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    for dt, sq, d, want_route in ((torch.float32, S, 64, "f32"),
                                  (torch.float32, S, 96, "tiled"),
                                  (torch.bfloat16, S, 64, "whole"),
                                  (torch.bfloat16, 2 * S, 64, "streamed")):
        q, k, v = (torch.randn(2, 4, sq, d, generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for where in ("one key", "every key"):
            bias = _padding_bias(2, sq, gen)
            if where == "one key":
                bias[0, 3] = float("nan")
            else:
                bias[0] = float("nan")
            route = fa.fwd_route(q.shape, k.shape, dt)
            o, _ = fa.flash_attention_fwd(q, k, v, d ** -0.5, False, 0.0,
                                          None, bias)
            ro, _ = fa.flash_attention_reference(q, k, v, d ** -0.5, False,
                                                 0.0, None, bias)
            nan_o = torch.isnan(o.float())
            ok = route == want_route \
                and torch.equal(nan_o, torch.isnan(ro.float())) \
                and bool(nan_o[0].all()) and not bool(nan_o[1].any()) \
                and torch.allclose(o[1].float(), ro[1].float(), rtol=tol,
                                   atol=tol)
            _log(f"[route] NaN in the bias at {where} of batch 0, "
                 f"{str(dt)[6:]} S = Sk = {sq} D = {d}: route {route}, "
                 f"O NaN in {int(nan_o[0].sum())} of {nan_o[0].numel()} "
                 f"values of batch 0 and {int(nan_o[1].sum())} of batch 1, "
                 f"as the plain version -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the {route} forward drops a NaN "
                                     f"in the bias ({where})")


def _dropout_agrees(dk, x, key, rate, up, what, tag="[kernel]"):
    """The dropout kernel (module ``dk``) against its plain version on
    ``x``: the masks equal and the output within DROPOUT_TOL of its
    largest, or it fails. → max|d out|."""
    import torch
    o, m = dk.dropout_cuda(x, key, rate, up)
    ro, rm = dk.dropout_reference(x, key, rate, up)
    if x.is_cuda:
        torch.cuda.synchronize()
    e = (o.float() - ro.float()).abs().max().item()
    scale = ro.float().abs().max().item()
    ok = torch.equal(m, rm) and e <= DROPOUT_TOL * scale
    _log(f"{tag} dropout {what} {tuple(x.shape)}: masks "
         f"{'equal' if torch.equal(m, rm) else 'DIFFER'}, kept "
         f"{m.float().mean().item():.4f}, max|d out| {e:.3e} of max "
         f"{scale:.3e} (tol {DROPOUT_TOL:g} relative) -> "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dropout kernel disagrees with its plain "
                             f"version: {what}")
    return e


def phase_kernel_dropout():
    """The dropout kernel against its plain version on the card: the mask
    exactly and the output within DROPOUT_TOL, at the training step's
    shape ([32, 128, 768] f32, rate 0.1, both implementations), in bf16,
    at a size that is no multiple of 4 and on a misaligned view; then
    timed at the training shape beside its plain version, the library's
    dropout and its bound, cycling DROPOUT_SETS input sets so that the
    inputs come from HBM, as they would after the step's other ops."""
    import torch
    from paddle_tpu_torch.ops.cuda import dropout as dk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shape = (TRAIN_BATCH, S, 768)
    rate = TRAIN_DROPOUT
    err = 0.0
    cases = [("f32 upscale_in_train", shape, torch.float32, True, None),
             ("f32 downgrade_in_infer", shape, torch.float32, False, None),
             ("bf16 upscale_in_train", shape, torch.bfloat16, True, None),
             ("f32 n=4099", (4099,), torch.float32, True, None),
             ("f32 view at offset 1", (4097,), torch.float32, True, 1)]
    for i, (what, shp, dt, up, offset) in enumerate(cases):
        x = torch.randn(shp, generator=gen, device="cuda").to(dt)
        if offset:
            x = x[offset:]
        key = torch.tensor([0xC0FFEE + 7919 * i], dtype=torch.int64,
                           device="cuda")
        e = _dropout_agrees(dk, x, key, rate, up, what)
        if dt == torch.float32 and offset is None:
            err = max(err, e)
    xs = [torch.randn(shape, generator=gen, device="cuda")
          for _ in range(DROPOUT_SETS)]
    key = torch.tensor([99], dtype=torch.int64, device="cuda")
    turn = [0]

    def cycled(fn):
        def call():
            turn[0] += 1
            return fn(xs[turn[0] % DROPOUT_SETS])
        return call
    ms = _cuda_ms(cycled(lambda x: dk.dropout_cuda(x, key, rate, True)))
    plain_ms = _cuda_ms(cycled(
        lambda x: dk.dropout_reference(x, key, rate, True)))
    lib_ms = _cuda_ms(cycled(lambda x: torch.native_dropout(x, rate, True)))
    n = xs[0].numel()
    # x read once, out (f32) and the mask (uint8) written once, the key
    # read; the hash's 11 integer operations, the compare and the select
    # per element, and the product by 1 / (1 - rate)
    nbytes = n * (4 + 4 + 1) + 8
    bnd, by = bound(13 * n, nbytes, "int32")
    _log(f"[kernel] time dropout f32 {shape} rate {rate}: kernel {ms:.4f} "
         f"ms, plain {plain_ms:.4f} ms, torch.native_dropout (philox: the "
         f"same distribution, other bits) {lib_ms:.4f} ms, bound "
         f"{bnd:.4f} ms ({by}: {nbytes} B, {13 * n} integer operations)")
    _check_bound("dropout", ms, bnd)
    return dict(shape=f"float32 {list(shape)} rate {rate} upscale_in_train",
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


# --------------------------------------------------------------------------
# 3. slice
# --------------------------------------------------------------------------
def _build_encoder(cfg):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data("src_ids", [S], dtype="int64")
        pos = fluid.data("pos_ids", [S], dtype="int64")
        sent = fluid.data("sent_ids", [S], dtype="int64")
        mask = fluid.data("input_mask", [S], dtype="float32")
        bias = bert.padding_attn_bias(mask)
        x = bert.bert_embedding(src, pos, sent, cfg)
        enc = bert.encoder(x, cfg["layers"], cfg["hidden"], cfg["heads"],
                           cfg["ffn"], attn_bias=bias)
    startup.random_seed = SEED
    return main, startup, enc


def _request(rng, bs, cfg):
    import numpy as np
    lens = rng.randint(S // 4, S + 1, size=bs)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    return {"src_ids": rng.randint(0, cfg["vocab_size"], (bs, S)),
            "pos_ids": np.tile(np.arange(S), (bs, 1)),
            "sent_ids": rng.randint(0, cfg["type_vocab"], (bs, S)),
            "input_mask": mask}


def _gate_run(exe, delta, want, what):
    """One Executor.run on the compiled path against the exact kernel
    launches ``want`` (GATE_NAMES) of one request or step. An
    eager run launches them through the wrappers; a capture launches them
    through the wrappers into the graph, which must record exactly
    ``want``; a replay calls no wrapper and launches what its graph
    recorded. → how the run executed: "eager", "capture" or "replay"."""
    if exe._last_run_mode != "compiled":
        raise AssertionError(f"{what} ran {exe._last_run_mode}, "
                             "want compiled")
    cb = exe._last_block
    graph = tuple(cb.graph_launches.get(k, 0) for k in KERNELS)
    if cb.last_exec == "replay":
        ok = not any(delta) and graph == want
    elif cb.last_exec == "capture":
        ok = delta == want and graph == want
    else:
        ok = delta == want
    if not ok:
        raise AssertionError(
            f"{what} ({cb.last_exec}): launches through the wrappers "
            f"{delta}, recorded in the graph {graph}; want {want} a run")
    return cb.last_exec


def _device_kernel_counts(fn, names=DEVICE_KERNELS, guard_s=None,
                          timing=None, warm=None):
    """The kernels of ``names`` the card ran during ``fn()``, counted by
    name in a torch.profiler trace. A trace that holds no device event at
    all fails: the gate would rest on the launches recorded at capture
    alone. The trace has a warm-up cycle first, which runs one small
    kernel while tracing starts up: a trace that begins with ``fn()`` can
    lose the first kernels ``fn()`` launches (seen on the card: a training
    step's first seven). The profiler keeps only device events inside its
    recorded window, which it stamps on the host's clock, and the card's
    timestamps, moved to that clock, can sit a little off it: ``fn()``
    starts ``guard_s`` (TRACE_GUARD_S) after the window opens, and the
    window closes ``guard_s`` after ``fn()``'s last kernel has finished
    (tools/trace_window_check.py measures both ways). Late in a whole run
    a trace has also lost the first 1 to 7 device records of its recorded
    cycle (ROADMAP C2, cause not found), so that cycle runs TRACE_PAD
    small kernels, none of ``names``, before ``fn()``. ``fn()`` runs
    once, in the one recorded cycle. ``timing``, a dict, receives where the
    trace's device events sit on the host's clock (``_trace_timing``).
    ``warm``: what the warm-up cycle runs instead of the small kernel. A
    CUDA graph's first replay inside a profiler session can go
    unrecorded in a process that ran earlier sessions (ROADMAP C2, PR 18:
    the loop's first body replay, 36 of 40 traces): pass ``fn`` to replay
    the graphs once before the recorded cycle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    guard_s = TRACE_GUARD_S if guard_s is None else guard_s
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if warm is None:
            torch.ones(1, device="cuda").add_(1)
        else:
            warm()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(guard_s)
        for _ in range(TRACE_PAD):
            pad.add_(1)
        fn()
        torch.cuda.synchronize()
        time.sleep(guard_s)
        prof.step()
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    TRACES.append(len(evts))
    if not evts:
        raise AssertionError("the profiler recorded no device event on the "
                             "card: the replay's kernels cannot be counted")
    if timing is not None:
        timing.update(_trace_timing(prof.events(), names))
    return tuple(sum(e.count for e in evts if name in e.key)
                 for name in names)


def _trace_timing(events, names):
    """Where a trace's device events sit on the host's clock, in ms: from
    the recorded window's start (its first host event) to the first
    device event (``head``), from the last device event to the window's
    end (``tail``), and the largest lag from a ``cudaGraphLaunch`` on the
    host to the first kernel of ``names`` after it on the card
    (``lag``): a lag far above a launch's microseconds says the card's
    timestamps sit off the host's clock (ROADMAP C2)."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not host or not dev:
        return {}
    start = min(e.time_range.start for e in host)
    end = max(e.time_range.end for e in host)
    launches = sorted(e.time_range.start for e in host
                      if e.name == "cudaGraphLaunch")
    kern = sorted(e.time_range.start for e in dev
                  if any(n in e.name for n in names))
    lags = []
    for a in launches:
        after = [k for k in kern if k >= a]
        if after:
            lags.append(after[0] - a)
    return {"head": (min(e.time_range.start for e in dev) - start) / 1e3,
            "tail": (end - max(e.time_range.end for e in dev)) / 1e3,
            "lag": max(lags) / 1e3 if lags else None,
            "launches": len(launches), "kernels": len(kern)}


def _check_trace(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what}: the card ran {counts} {GATE_NAMES} "
                             f"kernels, want {want}")
    _log(f"[graph] {what}: the trace of one replay holds {counts} "
         f"{GATE_NAMES} kernels, as recorded")


def _agree(what, got, ref):
    """Graph replay against the interpreter on the card: bitwise, or
    within GRAPH_TOL of the reference's largest magnitude."""
    import numpy as np
    same = np.array_equal(got, ref)
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    ok = same or err <= GRAPH_TOL * scale
    _log(f"[graph] {what}, compiled (graph replay) vs interpreted: " +
         ("bitwise equal" if same else
          f"max|d| {err:.3e} of max {scale:.3e}") +
         f" (tol {GRAPH_TOL:g} relative) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the graph replay disagrees with the "
                             "interpreter")
    return same


def _latency_line(prefix, bs, times):
    import numpy as np
    ms = np.asarray(times) * 1e3
    _log(f"{prefix} {bs:2d}: {len(times)} requests in "
         f"{ms.sum() / 1e3:.3f} s of Executor.run, "
         f"{bs * len(times) / (ms.sum() / 1e3):.1f} sequences/s, "
         f"latency p50 {np.percentile(ms, 50):.3f} ms "
         f"p99 {np.percentile(ms, 99):.3f} ms "
         f"max {ms.max():.3f} ms")


def phase_slice(profile=False):
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    L = cfg["layers"]
    # f32 at D = 64: the f32 forward
    want = tuple(L if k == "flash_attention_fwd_f32" else 0 for k in KERNELS)
    main, startup, enc = _build_encoder(cfg)
    n_attn = sum(op.type == "fused_attention_qkv"
                 for op in main.global_block().ops)
    if n_attn != L:
        raise AssertionError(f"{n_attn} attention ops, want {L}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(v.name).value().array.numel()
                   for v in params)
    _log(f"[slice] BERT-base encoder: {len(main.global_block().ops)} ops, "
         f"{n_params} parameters, startup on the card "
         f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(SEED)
    pools = {bs: [_request(rng, bs, cfg) for _ in range(POOL)]
             for bs in SERVE_BATCHES}
    runs = collections.Counter()

    def request(feed, what):
        before = _launch_counts()
        t = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[enc], scope=scope)
        dt = time.perf_counter() - t
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        runs[_gate_run(exe, delta, want, what)] += 1
        if out.shape != (feed["src_ids"].shape[0], S, cfg["hidden"]) \
                or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out.shape} "
                                 f"finite={np.isfinite(out).all()}")
        return out, dt

    first, replayed = None, {}
    _reset_launch_counts()
    for bs in SERVE_BATCHES:
        pool = pools[bs]
        for i in range(WARMUP):
            request(pool[i], f"batch-{bs} warm-up request {i}")
        times, served = [], 0.0
        while served < WINDOW_S:
            feed = pool[len(times) % POOL]
            out, dt = request(feed, f"a batch-{bs} request")
            times.append(dt)
            served += dt
            replayed.setdefault(bs, (feed, out))
            if first is None:
                first = (feed, out)
        _latency_line("[slice] batch", bs, times)
    mid = SERVE_BATCHES[len(SERVE_BATCHES) // 2]
    _check_trace(_device_kernel_counts(
        lambda: request(pools[mid][1], "a traced request")), want,
        f"batch-{mid} request")
    # a caller replaces a weight: the next replay must read the new one
    w_var = scope.find_var("word_embedding")
    w = w_var.value().array
    orig = w.clone()
    w_var.set_value(fluid.LoDTensor(w * 0.5))
    new_out, _ = request(pools[mid][2], "a request after a weight was "
                         "replaced")
    if exe._last_block.last_exec != "replay" \
            or scope.find_var("word_embedding").value().array is not w \
            or not torch.equal(w, orig * 0.5):
        raise AssertionError("a replaced weight was not copied into the "
                             "graph's tensor before the replay")
    launches = _launch_counts()
    n_runs = sum(runs.values())
    if launches != tuple((runs["eager"] + runs["capture"]) * x
                         for x in want):
        raise AssertionError(f"launches {launches} over runs {dict(runs)}")
    st = exe.graph_stats()
    _log(f"[slice] {n_runs} requests, compiled: {runs['eager']} eager "
         f"warm-ups, {runs['capture']} captures ({st['capture_s']:.2f} s "
         f"in all), {runs['replay']} replays; launches through the "
         f"wrappers (warm-ups and captures) {GATE_NAMES} {launches}, "
         f"{n_runs * L} forwards run on the card (= {L} per request)")

    # the interpreter on the same weights: replays against the eager plan,
    # and its own latency in this run
    iexe, iscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    for v in params:
        iscope.var(v.name).set_value(fluid.LoDTensor(
            scope.find_var(v.name).value().array))
    fluid.core.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        def interp(feed):
            t = time.perf_counter()
            out, = iexe.run(main, feed=feed, fetch_list=[enc], scope=iscope)
            dt = time.perf_counter() - t
            if iexe._last_run_mode != "interpreted":
                raise AssertionError("the oracle did not run interpreted")
            return out, dt
        _agree(f"batch-{mid} request, word embedding replaced",
               new_out, interp(pools[mid][2])[0])
        w.copy_(orig)
        for bs in SERVE_BATCHES:
            _agree(f"batch-{bs} request", replayed[bs][1],
                   interp(replayed[bs][0])[0])
        # the interpreter's latency, each window followed by a compiled
        # one of the same length: host-bound latency drifts within a run
        for bs in SERVE_BATCHES:
            for mode, label, fn in (
                    ("interpreted", "interpreted", interp),
                    ("compiled", "compiled again,",
                     lambda f: request(f, "a request"))):
                fluid.core.set_flag("FLAGS_executor_mode", mode)
                for i in range(2):
                    fn(pools[bs][i])
                times = []
                while sum(times) < INTERP_WINDOW_S:
                    times.append(fn(pools[bs][len(times) % POOL])[1])
                _latency_line(f"[slice] {label} batch", bs, times)
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    del iexe, iscope

    # the first request again, by the port on the CPU with the same weights
    cpu_scope = fluid.Scope()
    for v in params:
        cpu_scope.var(v.name).set_value(fluid.LoDTensor(
            scope.find_var(v.name).value().array.cpu()))
    cpu_out, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=first[0], fetch_list=[enc], scope=cpu_scope)
    err = float(np.abs(cpu_out - first[1]).max())
    ok = np.allclose(first[1], cpu_out, rtol=SLICE_TOL, atol=SLICE_TOL)
    _log(f"[slice] batch-1 request, card vs CPU: max|d| {err:.3e} "
         f"tol {SLICE_TOL:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("served output disagrees with the CPU run")
    if profile:
        for bs in SERVE_BATCHES:
            _profile(exe, main, enc, scope, pools[bs][0], bs)
    exe.close()
    return {"wrapper": launches, "executed": tuple(n_runs * w for w in want),
            "runs": dict(runs)}


def _profile(exe, main, enc, scope, feed, bs):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[enc], scope=scope)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    walls = [run() for _ in range(20)][5:]
    wall = float(np.median(walls)) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = run() * 1e3
    # device-side events only (kernels, copies): one stream, so their
    # self times add up to the time the device was busy. The idle share is
    # taken against the unprofiled wall of the same request (median of
    # 15), since the profiler slows the host side.
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    _log(f"[profile] batch {bs}: wall {wall:.3f} ms unprofiled (median of "
         f"15), {prof_wall:.3f} ms under the profiler; device busy "
         f"{busy:.3f} ms, idle {100 - 100 * busy / wall:.1f}% of the "
         f"unprofiled wall")
    for e in sorted(evts, key=lambda e: -e.self_device_time_total)[:10]:
        _log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:4d}  {e.key[:90]}")


# --------------------------------------------------------------------------
# 4. train
# --------------------------------------------------------------------------
def _train_batch(rng, bs, cfg):
    """A pretraining batch as bench.py's BERT lane makes it, with random
    padding lengths: 15 % of the B·S positions masked, at random."""
    import numpy as np
    lens = rng.randint(S // 4, S + 1, size=bs)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    n_mask = max(1, int(bs * S * MLM_FRAC))
    return {"src_ids": rng.randint(0, cfg["vocab_size"], (bs, S)),
            "pos_ids": np.tile(np.arange(S), (bs, 1)),
            "sent_ids": rng.randint(0, cfg["type_vocab"], (bs, S)),
            "mask_pos": rng.randint(0, bs * S, (n_mask, 1)),
            "mask_label": rng.randint(0, cfg["vocab_size"], (n_mask, 1)),
            "input_mask": mask}


def _pretrain_program(cfg, dropout, **options):
    """The pretraining step with the input mask; ``options`` go to
    build_bert_pretrain_program (use_amp)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    with fluid.unique_name.guard():
        main, startup, _, (loss,) = bert.build_bert_pretrain_program(
            cfg, seq_len=S, dropout=dropout, lr=TRAIN_LR,
            use_input_mask=True, **options)
    startup.random_seed = main.random_seed = SEED
    return main, startup, loss


def _launch_counts():
    from paddle_tpu_torch.ops.cuda import dropout as dk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    return (fa.launch_count, fa.bwd_kv_launch_count, fa.bwd_q_launch_count,
            fa.bwd_fused_launch_count, dk.launch_count,
            fa.fwd_whole_launch_count, fa.fwd_streamed_launch_count,
            fa.bwd_dq_streamed_launch_count,
            fa.bwd_dkdv_streamed_launch_count, fa.fwd_f32_launch_count,
            fa.bwd_dkdv_f32_launch_count, fa.bwd_dq_f32_launch_count)


def _reset_launch_counts():
    from paddle_tpu_torch.ops.cuda import dropout as dk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    fa.launch_count = fa.bwd_kv_launch_count = fa.bwd_q_launch_count = 0
    fa.bwd_fused_launch_count = dk.launch_count = 0
    fa.fwd_whole_launch_count = fa.fwd_streamed_launch_count = 0
    fa.bwd_dq_streamed_launch_count = fa.bwd_dkdv_streamed_launch_count = 0
    fa.fwd_f32_launch_count = fa.bwd_dkdv_f32_launch_count = 0
    fa.bwd_dq_f32_launch_count = 0


def _attention_route(main):
    """The backward route (``bwd_route``: "fused", "f32", ...) that the
    attention ops of ``main`` take on the card, read from the program: the
    shape and dtype of each op's Q and K inputs. (The AMP step's, whose
    dtype its rewrite decides; the other paths' routes are constants.)"""
    from paddle_tpu_torch.fluid import core
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    block = main.global_block()
    routes = set()
    for op in block.ops:
        if op.type != "fused_attention_qkv":
            continue
        heads = op.attr("num_heads")
        q, k = (block.var(op.input(n)[0]) for n in ("Q", "K"))
        dt = core.dtype_to_torch(q.dtype)
        routes.add(fa.bwd_route(
            (1, heads, q.shape[1], q.shape[2] // heads),
            (1, heads, k.shape[1], k.shape[2] // heads), dt))
    if len(routes) != 1:
        raise AssertionError(f"attention backward routes {routes}: want "
                             "one for every attention op")
    return routes.pop()


def _step_want(ops, route, forwards=None):
    """GATE_NAMES launches of one training step: each attention op
    launches the forward once and its grad re-runs it under autograd (the
    generic grad; ``forwards`` overrides the count), whose backward
    launches the dK/dV and the dQ kernel once each on the split route, the
    fused kernel once, the streamed dQ and dK/dV kernels once each, or the
    f32 dQ and dK/dV kernels once each on the f32 route; each
    dropout op launches the dropout kernel once (its grad is a mask
    product: no re-draw). The forward is the tiled kernel on the split
    route, the whole-block one on the fused route, the streamed one on the
    streamed route and the f32 one on the f32 route: ``bwd_route`` maps
    ``fwd_route``'s answer."""
    L = sum(op.type == "fused_attention_qkv" for op in ops)
    fwd = 2 * L if forwards is None else forwards
    drop = _dropout_ops(ops)
    return {"split": (fwd, L, L, 0, drop, 0, 0, 0, 0, 0, 0, 0),
            "fused": (0, 0, 0, L, drop, fwd, 0, 0, 0, 0, 0, 0),
            "streamed": (0, 0, 0, 0, drop, 0, fwd, L, L, 0, 0, 0),
            "f32": (0, 0, 0, 0, drop, 0, 0, 0, 0, fwd, L, L)}[route]


def _dropout_ops(ops):
    """Dropout ops that draw in a training step (each launches the
    dropout kernel once)."""
    return sum(op.type == "dropout" and not op.attr("is_test")
               for op in ops)


def phase_train(profile=False):
    import collections
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    L = cfg["layers"]
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    ops = main.global_block().ops
    n_fwd = sum(op.type == "fused_attention_qkv" for op in ops)
    n_grad = sum(op.type == "fused_attention_qkv_grad" for op in ops)
    if n_fwd != L or n_grad != L:
        raise AssertionError(f"{n_fwd} attention ops and {n_grad} grads, "
                             f"want {L} each")
    want = _step_want(ops, _attention_route(main))
    if want != TRAIN_STEP_WANT:
        raise AssertionError(f"the training step: want {want} launches, "
                             f"not {TRAIN_STEP_WANT}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    # what earlier phases of this process left allocated (the cuBLAS
    # workspace of each stream they used) is not the step's memory
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(p.name).value().array.numel()
                   for p in params)
    _log(f"[train] BERT-base pretraining step: {len(ops)} ops, "
         f"{len(params)} parameters ({n_params} values), dropout "
         f"{TRAIN_DROPOUT}, Adam lr {TRAIN_LR}; startup on the card "
         f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(SEED + 2)
    pool = [_train_batch(rng, TRAIN_BATCH, cfg) for _ in range(POOL)]
    mask = [op for op in ops if op.type == "dropout"][0].output("Mask")[0]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    runs = collections.Counter()

    def step(feed, fetch=(loss,)):
        before = _launch_counts()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=list(fetch), scope=scope)
        dt = time.perf_counter() - t
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        runs[_gate_run(exe, delta, want, "a training step")] += 1
        value = float(out[0].reshape(-1)[0])
        if not np.isfinite(value):
            raise AssertionError(f"non-finite loss {value}")
        return value, dt, out

    for i in range(TRAIN_WARMUP):
        step(pool[i])
    times, losses = [], []
    for i in range(TRAIN_WINDOW):
        value, dt, _ = step(pool[(TRAIN_WARMUP + i) % POOL])
        times.append(dt)
        losses.append(value)
    fall = [step(pool[0])[0] for _ in range(FALL_STEPS)]
    peak = torch.cuda.max_memory_allocated() - before
    _check_trace(_device_kernel_counts(lambda: step(pool[1])), want,
                 "training step")
    # the fetch list is part of the key: a graph of its own, whose
    # replays (steps 3 and 4) must draw new masks
    masks = [step(pool[2 + i], (loss, mask))[2][1] for i in range(4)]
    if exe._last_block.stats != dict(exe._last_block.stats, eager=1,
                                     captures=1, replays=3):
        raise AssertionError(f"mask runs: {exe._last_block.stats}")
    for i in range(1, 4):
        for j in range(i):
            if np.array_equal(masks[i], masks[j]):
                raise AssertionError(f"steps {j} and {i} drew the same "
                                     "dropout mask")
    keep = [float(m.mean()) for m in masks]
    if not all(abs(k - (1 - TRAIN_DROPOUT)) < 0.01 for k in keep):
        raise AssertionError(f"kept fractions {keep}")
    _log(f"[graph] dropout masks of 4 steps (eager, capture, 2 replays) "
         f"all differ; kept fractions " + " ".join(f"{k:.4f}" for k in keep))
    launches = _launch_counts()
    n_runs = sum(runs.values())
    if launches != tuple((runs["eager"] + runs["capture"]) * w
                         for w in want):
        raise AssertionError(f"launches {launches} over runs {dict(runs)}")
    st = exe.graph_stats()
    ms = np.asarray(times) * 1e3
    _log(f"[train] batch {TRAIN_BATCH}: {TRAIN_WINDOW} steps in "
         f"{ms.sum() / 1e3:.3f} s of Executor.run, "
         f"{TRAIN_BATCH * TRAIN_WINDOW / (ms.sum() / 1e3):.2f} samples/s, "
         f"step p50 {np.percentile(ms, 50):.3f} ms p90 "
         f"{np.percentile(ms, 90):.3f} ms p99 {np.percentile(ms, 99):.3f} "
         f"ms max {ms.max():.3f} ms (n={len(ms)}); losses "
         f"{losses[0]:.4f} .. {losses[-1]:.4f}")
    _log(f"[train] peak device memory {peak / 2**30:.3f} GiB "
         f"(max_memory_allocated over warm-up, window and repeated steps, "
         f"less the {before / 2**30:.3f} GiB allocated before the phase)")
    _log(f"[train] {n_runs} steps, compiled: {runs['eager']} eager "
         f"warm-ups, {runs['capture']} captures ({st['capture_s']:.2f} s in "
         f"all), {runs['replay']} replays; launches through the wrappers "
         f"(warm-ups and captures) {launches}; run on the card "
         f"{tuple(n_runs * w for w in want)} (= {want} per step)")
    _log(f"[train] repeated batch, {FALL_STEPS} steps: " +
         " ".join(f"{x:.4f}" for x in fall))
    if not (fall[-1] < fall[0] and np.mean(fall[-3:]) < np.mean(fall[:3])):
        raise AssertionError("the loss does not fall on a repeated batch")
    if profile:
        _profile_step(exe, main, loss, scope, pool[1])
    exe.close()
    del exe, scope
    _interpreted_train(main, startup, loss, pool)
    _check_train_against_cpu(cfg)
    _check_graph_against_interpreter(cfg)
    return {"wrapper": launches,
            "executed": tuple(n_runs * w for w in want), "runs": dict(runs),
            "p50_ms": float(np.percentile(ms, 50)),
            "samples_s": TRAIN_BATCH * TRAIN_WINDOW / (ms.sum() / 1e3),
            "peak_gib": peak / 2**30}



def _interpreted_train(main, startup, loss, pool):
    """The oracle's step time and memory in this run, for comparison."""
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fluid.core.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        times = []
        for i in range(INTERP_STEPS):
            t = time.perf_counter()
            out, = exe.run(main, feed=pool[i % POOL], fetch_list=[loss],
                           scope=scope)
            times.append(time.perf_counter() - t)
            if exe._last_run_mode != "interpreted" \
                    or not np.isfinite(out).all():
                raise AssertionError("the interpreted step failed")
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    peak = torch.cuda.max_memory_allocated() - before
    ms = np.asarray(times[2:]) * 1e3
    _log(f"[train] interpreted batch {TRAIN_BATCH}: step p50 "
         f"{np.percentile(ms, 50):.3f} ms max {ms.max():.3f} ms "
         f"(n={len(ms)}, after 2 warm-ups); peak device memory "
         f"{peak / 2**30:.3f} GiB")


def _index_grad_repeats(cfg, repeats=20):
    """The backward of the step's index ops at its shapes (batch 2, 32 and
    256, S = 128, hidden 768), each run ``repeats`` times on the same
    inputs on the card; prints how many repeats differ from the first.
    Autograd's grad of ``index_select`` (``index_add_``, atomics) is
    shown beside the registered ``gather_grad`` that replaces it; the
    latter, and lookup_table_v2's generic grad (autograd's ``w[ids]``
    backward) for the word, position and sentence tables, must not
    differ (ROADMAP C2)."""
    import torch
    from paddle_tpu_torch.ops.registry import OPS, run_generic_grad
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    hidden = cfg["hidden"]
    drift = []

    def count(name, fn, gated):
        ref = fn()
        n = sum(not torch.equal(ref, fn()) for _ in range(repeats))
        _log(f"[C2] {name}: {n}/{repeats} repeats differ from the first"
             + ("" if gated else " (replaced)"))
        if gated and n:
            drift.append(name)

    for B in (2, 32, 256):
        n_mask = int(B * S * MLM_FRAC)
        idx = torch.randint(0, B * S, (n_mask, 1), generator=gen,
                            device="cuda")
        go = torch.randn(n_mask, hidden, generator=gen, device="cuda")
        x = torch.randn(B * S, hidden, generator=gen, device="cuda",
                        requires_grad=True)
        count(f"gather B={B}: autograd index_select backward",
              lambda: torch.autograd.grad(x.index_select(0, idx[:, 0]), x,
                                          go)[0], False)
        count(f"gather B={B}: gather_grad",
              lambda: OPS.get("gather_grad").kernel(
                  {"X": [x], "Index": [idx], "Out@GRAD": [go]},
                  {})["X@GRAD"][0], True)
        for table, V, ids in (
                ("word", cfg["vocab_size"],
                 torch.randint(0, cfg["vocab_size"], (B, S), generator=gen,
                               device="cuda")),
                ("pos", cfg["max_len"],
                 torch.arange(S, device="cuda").repeat(B, 1)),
                ("sent", cfg["type_vocab"],
                 torch.zeros(B, S, dtype=torch.long, device="cuda"))):
            w = torch.randn(V, hidden, generator=gen, device="cuda")
            gl = torch.randn(B, S, hidden, generator=gen, device="cuda")
            count(f"lookup_table_v2 {table} B={B}: generic grad",
                  lambda: run_generic_grad(
                      "lookup_table_v2",
                      {"W": [w], "Ids": [ids], "Out@GRAD": [gl]},
                      dict(OPS.get("lookup_table_v2").attr_defaults),
                      ["W@GRAD"], ["W", "Ids"])["W@GRAD"][0], True)
    if drift:
        raise AssertionError(f"index grads not reproducible: {drift}")


def _check_graph_against_interpreter(cfg):
    """GRAPH_STEPS steps at batch GRAPH_BATCH, dropout 0.1, on the card:
    compiled (eager warm-up, capture, replay) against interpreted, and
    interpreted again, each from its own startup run. The startup weights
    and the first dropout mask of each step agree exactly, the losses
    bitwise or within GRAPH_TOL, and the parameters after the steps
    bitwise: compiled against interpreted, and the two interpreted runs
    (ROADMAP C2, the gate that step windows rest on)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    _index_grad_repeats(cfg)
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    rng = np.random.RandomState(SEED + 4)
    feeds = [_train_batch(rng, GRAPH_BATCH, cfg) for _ in range(GRAPH_STEPS)]
    params = main.global_block().all_parameters()
    got, scopes, init = {}, {}, {}
    try:
        # the interpreter twice: how far two eager runs of the step drift
        # apart on their own
        for mode in ("compiled", "interpreted", "interpreted again"):
            fluid.core.set_flag("FLAGS_executor_mode", mode.split()[0])
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            scopes[mode] = scope
            init[mode] = [scope.find_var(p.name).value().array.clone()
                          for p in params]
            got[mode] = []
            for f in feeds:
                got[mode].append(exe.run(main, feed=f,
                                         fetch_list=[loss, mask],
                                         scope=scope))
                got[mode][-1].append(exe._last_run_mode + (
                    ":" + exe._last_block.last_exec
                    if mode == "compiled" else ""))
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    for p, a, b in zip(params, init["compiled"], init["interpreted"]):
        if not torch.equal(a, b):
            raise AssertionError(f"the two startup runs differ: {p.name}")
    # C2: two interpreted runs of the step are bitwise equal
    _bitwise(f"the interpreter against itself, {GRAPH_STEPS} steps: losses",
             [r[0] for r in got["interpreted"]],
             [r[0] for r in got["interpreted again"]])
    _bitwise(f"the interpreter against itself after {GRAPH_STEPS} steps: "
             f"{len(params)} parameters",
             _params(scopes["interpreted"], params),
             _params(scopes["interpreted again"], params))
    kinds = [r[2] for r in got["compiled"]]
    if kinds != ["compiled:eager", "compiled:capture", "compiled:replay"]:
        raise AssertionError(f"compiled runs {kinds}")
    for i, (c, r) in enumerate(zip(got["compiled"], got["interpreted"])):
        _agree(f"training step {i} ({kinds[i]}) loss {float(c[0][0]):.7f}, "
               f"batch {GRAPH_BATCH} dropout {TRAIN_DROPOUT}", c[0], r[0])
        if not np.array_equal(c[1], r[1]):
            raise AssertionError(f"step {i}: dropout masks differ")
    _log("[graph] dropout masks equal at each step")
    _bitwise(f"compiled against interpreted after {GRAPH_STEPS} steps: "
             f"{len(params)} parameters", _params(scopes["compiled"], params),
             _params(scopes["interpreted"], params))



def _card_and_cpu_step(main, startup, fetch, feed):
    """One step of ``main`` on the card and by the port on the CPU, both
    from the card's startup values → (card fetches, CPU fetches, (card
    executor, scope), (CPU executor, scope))."""
    from paddle_tpu_torch import fluid
    gpu_scope, cpu_scope = fluid.Scope(), fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=gpu_scope)
    for v in main.global_block().vars.values():
        if v.persistable:
            cpu_scope.var(v.name).set_value(fluid.LoDTensor(
                gpu_scope.find_var(v.name).value().array.cpu()))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    return gpu, cpu, (exe, gpu_scope), (cpu_exe, cpu_scope)


def _check_train_against_cpu(cfg):
    """One step at batch 2, dropout 0, on the card and by the port on the
    CPU from the same weights: the loss and three grads. Post-Adam
    parameters are not compared: Adam's m/(√v+ε) turns rounding noise on
    a near-zero grad into a step of ±lr."""
    import numpy as np
    main, startup, loss = _pretrain_program(cfg, 0.0)
    muls = [op for op in main.global_block().ops if op.type == "mul"]
    names = ["word_embedding", muls[0].input("Y")[0],
             muls[-1].input("Y")[0]]  # layer 0's Q weight, the MLM head
    fetch = [loss] + [n + "@GRAD" for n in names]
    feed = _train_batch(np.random.RandomState(SEED + 3), CHECK_BATCH, cfg)
    gpu, cpu, _, _ = _card_and_cpu_step(main, startup, fetch, feed)
    _loss_and_grads_agree(f"[train] batch {CHECK_BATCH} dropout 0", names,
                          gpu, cpu)


def _loss_and_grads_agree(what, names, gpu, cpu):
    """A step's fetches on the card against the CPU's: the loss within
    LOSS_TOL relative, each grad of ``names`` within GRAD_TOL of its
    largest magnitude; logged under ``what``, else a failure."""
    import numpy as np
    tag = what.split()[0]
    ok = abs(float(gpu[0][0]) - float(cpu[0][0])) \
        <= LOSS_TOL * abs(float(cpu[0][0]))
    _log(f"{what}, card vs CPU: loss {float(gpu[0][0]):.6f} vs "
         f"{float(cpu[0][0]):.6f} (tol {LOSS_TOL:g} relative)")
    for name, g, c in zip(names, gpu[1:], cpu[1:]):
        scale = float(np.abs(c).max())
        err = float(np.abs(g - c).max())
        ok = ok and err <= GRAD_TOL * scale
        _log(f"{tag}   {name}@GRAD {tuple(c.shape)}: max|d| {err:.3e}, "
             f"max|grad| {scale:.3e} (tol {GRAD_TOL:g} of it)")
    if not ok:
        raise AssertionError(f"{what}: the step on the card disagrees with "
                             "the CPU run")


def _profile_step(exe, main, loss, scope, feed,
                  what=f"train step batch {TRAIN_BATCH}", fetch=None):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch or [loss], scope=scope)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    wall = float(np.median([run() for _ in range(7)][2:])) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = run() * 1e3
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    _log(f"[profile] {what}: wall {wall:.3f} ms "
         f"unprofiled (median of 5), {prof_wall:.3f} ms under the profiler; "
         f"device busy {busy:.3f} ms, idle {100 - 100 * busy / wall:.1f}% "
         f"of the unprofiled wall; {sum(e.count for e in evts)} device "
         "events")
    top = sorted(evts, key=lambda e: -e.self_device_time_total)
    for e in top[:15]:
        _log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:5d}  {e.key[:90]}")
    attn = [e for e in top if "flash_" in e.key]
    for e in attn:
        if e not in top[:15]:
            _log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                 f"x{e.count:5d}  {e.key[:90]}")
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    _log(f"[profile] attention kernels {attn_ms:.3f} ms of the step's "
         f"{busy:.3f} ms device time ({100 * attn_ms / busy:.1f}%)")
    drop = [e for e in top if "dropout_fwd_kernel" in e.key]
    drop_ms = sum(e.self_device_time_total for e in drop) / 1e3
    _log(f"[profile] dropout kernel {drop_ms:.3f} ms for "
         f"{sum(e.count for e in drop)} launches "
         f"({100 * drop_ms / busy:.2f}% of the step's device time)")
    return busy, top


def _feed_cache_ab(lane, pairs, what):
    """The lane's window again, FLAGS_feed_device_cache on and off in
    turn (on, off, on, ...), each window timed as the lane times it (to
    its last loss on the host). With the cache on every feed must be a
    cache hit; with it off each window copies the feed to the card. →
    (median seconds on, median seconds off)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid import core
    exe, steps = lane.exe, lane.res["steps"]
    cb = exe._last_block
    times = {True: [], False: []}
    hits = {True: 0, False: 0}
    uploads = {True: 0, False: 0}
    try:
        for i in range(2 * pairs):
            on = i % 2 == 0
            core.set_flag("FLAGS_feed_device_cache", on)
            before = dict(exe.feed_stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(lane.main, feed=lane.feed,
                          fetch_list=lane.fetches, scope=lane.scope,
                          return_numpy=False, n_steps=steps)
            float(out[0].numpy().ravel()[-1])
            times[on].append(time.perf_counter() - t0)
            if exe._last_block is not cb or cb.last_exec != "replay":
                raise AssertionError(f"{what}: the feed-cache window was "
                                     "not a replay of the lane's graph")
            hits[on] += exe.feed_stats["cache_hits"] - before["cache_hits"]
            uploads[on] += exe.feed_stats["uploads"] - before["uploads"]
    finally:
        core.set_flag("FLAGS_feed_device_cache", True)
    n_feeds = len(lane.feed)
    nbytes = sum(np.asarray(a).nbytes for a in lane.feed.values())
    med = {on: float(np.median(t)) for on, t in times.items()}
    ok = hits[True] == pairs * n_feeds and uploads[True] == 0 \
        and hits[False] == uploads[False] == 0
    _log(f"[lane] {what} feed cache, {pairs} pairs of {steps}-step windows "
         f"alternated: on {med[True] * 1e3:.3f} ms a window (min "
         f"{min(times[True]) * 1e3:.3f}, {hits[True]} hits, "
         f"{uploads[True]} uploads), off {med[False] * 1e3:.3f} ms (min "
         f"{min(times[False]) * 1e3:.3f}; each window copies {n_feeds} "
         f"feeds, {nbytes} bytes, to the card) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: feed cache on {hits[True]} hits "
                             f"{uploads[True]} uploads over {pairs} windows "
                             f"of {n_feeds} feeds")
    return med[True], med[False]


@contextlib.contextmanager
def _lane_flags():
    """FLAGS_use_bf16_matmul on, as the bench lanes run: the ops read it,
    and it is part of the compiled cache key, so a run of a lane's
    program reuses the lane's graph only with it."""
    from paddle_tpu_torch.fluid import core
    core.set_flag("FLAGS_use_bf16_matmul", True)
    try:
        yield
    finally:
        core.set_flag("FLAGS_use_bf16_matmul", False)


def _gate_lane(lane, wrapper, want, what):
    """A bench lane's gates: a finite loss, the compiled path, a timed
    window of replays only, ``want`` (GATE_NAMES) launches a step
    through the wrappers (``wrapper``: warm-ups and
    captures) and in the graph, and in a profiler trace of one more
    replay. → the compiled block's runs before the trace."""
    import numpy as np
    res, exe = lane.res, lane.exe
    cb = exe._last_block
    runs = dict(cb.stats)
    if not (np.isfinite(res["loss"]) and res["executor_mode"] == "compiled"
            and res["timed_window"] == {"eager": 0, "captures": 0,
                                        "replays": res["steps"]}):
        raise AssertionError(f"{what}: {res}")
    if wrapper != tuple((runs["eager"] + runs["captures"]) * w
                        for w in want) \
            or tuple(cb.graph_launches.get(k, 0) for k in KERNELS) != want:
        raise AssertionError(f"{what} launches {wrapper} through the "
                             f"wrappers over {runs}, {cb.graph_launches} in "
                             f"the graph; want {want} a step")

    def one_step():
        exe.run(lane.main, feed=lane.feed, fetch_list=lane.fetches,
                scope=lane.scope)
        if exe._last_block is not cb or cb.last_exec != "replay":
            raise AssertionError(f"the traced {what} step was not a replay "
                                 "of the lane's graph")
    with _lane_flags():
        _check_trace(_device_kernel_counts(one_step), want,
                     f"{what} bf16 batch {res['batch']} step")
    return runs


def phase_lane(profile=False):
    """bench.py's lanes on the port, through ``paddle_tpu_torch.bench``
    (what ``python3 -m paddle_tpu_torch.bench bert|mnist`` runs): the
    BERT-base pretraining step in bf16 at batch 256 (or the largest rung
    of the OOM ladder that fits), then the MNIST MLP. Gates: a finite loss,
    the compiled path, a timed window of graph replays only, and the
    kernels of one replayed bf16 step counted by name in a profiler trace.
    Each lane's JSON line is printed as the entry point prints it. Then
    each lane's window runs with the feed cache on and off in turn."""
    import numpy as np
    from paddle_tpu_torch import bench
    _reset_launch_counts()
    lane = bench.run_bert_base()
    wrapper = _launch_counts()
    res = lane.res
    print(json.dumps(res), flush=True)
    ops = lane.main.global_block().ops
    L = sum(op.type == "fused_attention_qkv" for op in ops)
    want = _step_want(ops, "fused")
    if want != LANE_STEP_WANT or L != 12:
        raise AssertionError(f"bert lane: {L} attention ops, want {want} "
                             "launches a step")
    runs = _gate_lane(lane, wrapper, want, "bench lane")
    executed = tuple((runs["eager"] + runs["replays"]) * w for w in want)
    with _lane_flags():
        if profile:
            _profile_step(lane.exe, lane.main, lane.fetches[0], lane.scope,
                          lane.feed, f"bench lane bf16 batch {res['batch']}")
        _log(f"[lane] bert: batch {res['batch']}, {res['value']} "
             f"samples/s, {res['step_ms']} ms a step, peak "
             f"{res['peak_memory_gib']} GiB, mfu_vs_h100_bf16_peak "
             f"{res['mfu_vs_h100_bf16_peak']}; {runs['eager']} eager, "
             f"{runs['captures']} capture, {runs['replays']} replays before "
             f"the trace; kernels run {executed}")
        _feed_cache_ab(lane, 2, f"bert batch {res['batch']}")
    lane.close()
    del lane
    lane = bench.run_mnist_mlp()
    mres = lane.res
    print(json.dumps(mres), flush=True)
    if not (np.isfinite(mres["loss"]) and mres["executor_mode"] == "compiled"
            and mres["timed_window"] == {"eager": 0, "captures": 0,
                                         "replays": mres["steps"]}):
        raise AssertionError(f"mnist lane: {mres}")
    _log(f"[lane] mnist: batch {mres['batch']}, {mres['value']} samples/s, "
         f"{mres['step_ms']} ms a step")
    _feed_cache_ab(lane, 10, f"mnist batch {mres['batch']}")
    lane.close()
    return {"wrapper": wrapper, "executed": executed, "bert": res,
            "mnist": mres}


def _params(scope, params):
    return [scope.find_var(p.name).value().array.clone() for p in params]


def _bitwise(what, a, b, tag="[window]"):
    """Two lists of tensors or arrays equal bit for bit, or fail."""
    import numpy as np
    import torch

    def host(x):
        return x.cpu().double() if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.asarray(x, dtype=np.float64))
    same = [torch.equal(host(x), host(y)) for x, y in zip(a, b)]
    diff = max((float((host(x) - host(y)).abs().max())
                for x, y, ok in zip(a, b, same) if not ok), default=0.0)
    _log(f"{tag} {what}: " + ("bitwise equal" if all(same) else
                                 f"{same.count(False)} of {len(same)} "
                                 f"differ, max|d| {diff:.3e}") +
         f" -> {'ok' if all(same) else 'FAIL'}")
    if not all(same):
        raise AssertionError(f"{what}: not bitwise equal")


def phase_window():
    """Executor.run(n_steps=k) on the card: BERT-base at full width and
    depth, batch 2, dropout 0.1, input mask. A window of WINDOW_K distinct
    batches gives fetches and parameters bitwise equal to WINDOW_K single
    compiled runs and to WINDOW_K interpreted runs, each from its own
    startup run; a window of the same feeds gives its fetches stacked
    [k, 1] on the compiled path and the final step's [1] interpreted."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    params = main.global_block().all_parameters()
    rng = np.random.RandomState(SEED + 6)
    batches = [_train_batch(rng, GRAPH_BATCH, cfg) for _ in range(WINDOW_K)]
    stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
    got = {}
    _reset_launch_counts()
    try:
        for how in ("window", "single", "interpreted"):
            fluid.core.set_flag("FLAGS_executor_mode", "interpreted"
                                if how == "interpreted" else "compiled")
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            if how == "window":
                losses, = exe.run(main, feed=stacked, fetch_list=[loss],
                                  scope=scope, n_steps=WINDOW_K)
                cb = exe._last_block
                runs = dict(cb.stats)
                if exe._last_run_mode != "compiled" or runs != dict(
                        runs, eager=1, captures=1, replays=WINDOW_K - 1):
                    raise AssertionError(f"window ran {exe._last_run_mode} "
                                         f"{runs}")
                if losses.shape != (WINDOW_K, 1):
                    raise AssertionError(f"window fetch {losses.shape}")
                wrapper = _launch_counts()
            else:
                losses = np.stack([exe.run(main, feed=b, fetch_list=[loss],
                                           scope=scope)[0] for b in batches])
            got[how] = (losses, _params(scope, params))
            if how == "window":
                # one more step, a replay of the window's graph, traced
                def one_step():
                    exe.run(main, feed=batches[0], fetch_list=[loss],
                            scope=scope)
                    if exe._last_block is not cb \
                            or cb.last_exec != "replay":
                        raise AssertionError("the traced step was not a "
                                             "replay of the window's graph")
                traced = _device_kernel_counts(one_step)
            exe.close()
        # a window of the same feeds: stacked compiled, final interpreted
        shapes = {}
        for mode in ("compiled", "interpreted"):
            fluid.core.set_flag("FLAGS_executor_mode", mode)
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            out, = exe.run(main, feed=batches[0], fetch_list=[loss],
                           scope=scope, n_steps=2)
            shapes[mode] = out.shape
            exe.close()
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    _log(f"[window] k={WINDOW_K} batch {GRAPH_BATCH} dropout "
         f"{TRAIN_DROPOUT}: window losses " +
         " ".join(f"{x:.6f}" for x in got["window"][0].ravel()))
    for other in ("single", "interpreted"):
        _bitwise(f"window of {WINDOW_K} vs {WINDOW_K} {other} runs: losses",
                 [got["window"][0]], [got[other][0]])
        _bitwise(f"window of {WINDOW_K} vs {WINDOW_K} {other} runs: "
                 f"{len(params)} parameters", got["window"][1],
                 got[other][1])
    if shapes != {"compiled": (2, 1), "interpreted": (1,)}:
        raise AssertionError(f"same-feed windows gave {shapes}")
    _log(f"[window] same feeds, n_steps=2: compiled fetch "
         f"{shapes['compiled']} (stacked), interpreted {shapes['interpreted']}"
         " (the final step's) -> ok")
    want = _step_want(main.global_block().ops, _attention_route(main))
    if want != TRAIN_STEP_WANT:
        raise AssertionError(f"window: want {want} launches a step, not "
                             f"{TRAIN_STEP_WANT}")
    # the window's eager step and capture went through the wrappers, its
    # replays ran what the graph recorded
    graph = tuple(cb.graph_launches.get(k, 0) for k in KERNELS)
    if wrapper != tuple((runs["eager"] + runs["captures"]) * w
                        for w in want) or graph != want:
        raise AssertionError(f"window launches {wrapper} through the "
                             f"wrappers over {runs}, {graph} in the graph; "
                             f"want {want} a step")
    _check_trace(traced, want, f"window graph batch {GRAPH_BATCH} step")
    executed = tuple((runs["eager"] + runs["replays"]) * g for g in graph)
    _log(f"[window] {runs['eager']} eager, {runs['captures']} capture, "
         f"{runs['replays']} replays in the window; kernels run {executed}")
    return {"wrapper": wrapper, "executed": executed}


# --------------------------------------------------------------------------
# 7. remat, 8. amp, 9. guard
# --------------------------------------------------------------------------
def _persistables(scope, program):
    """Every initialized persistable of ``program`` (parameters, Adam's
    moments and beta powers, the learning rate), cloned."""
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = sv.value().array.clone()
    return out


def _train_steps(exe, main, loss, scope, feeds, want, runs, what,
                 book=None, outs=None, segmented=False):
    """One compiled Executor.run a feed, each gated on its kernel
    launches (``_gate_run``) and booked in ``book`` when one is given →
    (seconds of each run, losses). ``loss`` is the fetch, or a list of
    fetches that starts with it; ``outs``, a list, receives each run's
    fetches. With ``segmented`` a run of a block split around islands
    is taken too, gated on no launch (``want`` is then NO_KERNELS) and
    counted as "segmented"."""
    import numpy as np
    fetch = list(loss) if isinstance(loss, (list, tuple)) else [loss]
    times, losses = [], []
    for feed in feeds:
        before = _launch_counts()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        times.append(time.perf_counter() - t)
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        if segmented and exe._last_run_mode == "segmented":
            if want != NO_KERNELS or delta != NO_KERNELS:
                raise AssertionError(f"{what} (segmented): launches "
                                     f"through the wrappers {delta}, want "
                                     f"{want}")
            runs["segmented"] += 1
        else:
            runs[_gate_run(exe, delta, want, what)] += 1
        if book is not None:
            book.add(want)
        if outs is not None:
            outs.append(out)
        losses.append(float(out[0].reshape(-1)[0]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{what}: non-finite loss {losses[-1]}")
    return times, losses


def _remat_want(main, plan):
    """GATE_NAMES launches of one remat step (bf16 operands, as the lane
    runs it): each attention op's forward once, again in its segment's
    span (autograd's forward) or, outside the segments, in its generic
    grad; then its backward once."""
    ops = main.global_block().ops
    L = sum(op.type == "fused_attention_qkv" for op in ops)
    in_segments = sum(op.type == "fused_attention_qkv"
                      for seg in plan.segments for op in seg.ops)
    in_spans = {id(op) for span in plan.spans if span for op in span}
    outside = sum(op.type == "fused_attention_qkv_grad" and id(op)
                  not in in_spans for op in ops)
    return _step_want(ops, "fused", forwards=L + in_segments + outside)


def phase_remat(plain, profile=False):
    """bench.py's bert lane with PADDLE_TPU_BENCH_RECOMPUTE=1, through
    paddle_tpu_torch.bench as the lane phase ran it without: per-layer
    checkpoints, the remat schedule in the lane's graph. Gates: the plan
    engaged with no fallback warning, the timed window all replays, the
    kernels of one step from the graph and from a trace of one replay,
    peak memory below the plain lane's (``plain``, its JSON line from this
    run) and the last loss of the window within REMAT_LOSS_RTOL of the
    plain lane's."""
    import warnings
    from paddle_tpu_torch import bench
    _reset_launch_counts()
    os.environ["PADDLE_TPU_BENCH_RECOMPUTE"] = "1"
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            lane = bench.run_bert_base()
    finally:
        del os.environ["PADDLE_TPU_BENCH_RECOMPUTE"]
    wrapper = _launch_counts()
    res = lane.res
    print(json.dumps(res), flush=True)
    fallback = [str(w.message) for w in rec
                if "not lowerable" in str(w.message)]
    plan = lane.exe._last_block._remat_plan
    if fallback or plan is None or res["recompute"] is not True:
        raise AssertionError(f"remat lane: the plan did not engage: "
                             f"{fallback or res}")
    want = _remat_want(lane.main, plan)
    if want != LANE_STEP_WANT:
        raise AssertionError(f"remat lane: want {want} launches a step")
    runs = _gate_lane(lane, wrapper, want, "remat lane")
    # the traced replay ran one step more
    executed = tuple((runs["eager"] + runs["replays"] + 1) * w
                     for w in want)
    if profile:
        with _lane_flags():
            _profile_step(lane.exe, lane.main, lane.fetches[0], lane.scope,
                          lane.feed, f"remat lane bf16 batch {res['batch']}")
    rel = abs(res["loss"] - plain["loss"]) / abs(plain["loss"])
    _log(f"[remat] bert lane, PADDLE_TPU_BENCH_RECOMPUTE=1: "
         f"{len(plan.segments)} segments; batch {res['batch']}, "
         f"{res['value']} samples/s, {res['step_ms']} ms a step, peak "
         f"{res['peak_memory_gib']} GiB, mfu_vs_h100_bf16_peak "
         f"{res['mfu_vs_h100_bf16_peak']}; the plain lane of this run: "
         f"batch {plain['batch']}, {plain['value']} samples/s, "
         f"{plain['step_ms']} ms, peak {plain['peak_memory_gib']} GiB; step "
         f"time x{res['step_ms'] / plain['step_ms']:.3f}, peak "
         f"x{res['peak_memory_gib'] / plain['peak_memory_gib']:.3f}; "
         f"kernels a step {want} (graph and trace), run {executed}")
    _log(f"[remat] last loss of the window {res['loss']!r} against the "
         f"plain lane's {plain['loss']!r}: {rel:.3e} relative (tol "
         f"{REMAT_LOSS_RTOL:g}) -> {'ok' if rel <= REMAT_LOSS_RTOL else 'FAIL'}")
    if res["batch"] != plain["batch"] \
            or res["peak_memory_gib"] >= plain["peak_memory_gib"]:
        raise AssertionError("remat lane: peak memory not below the plain "
                             "lane's at the same batch")
    if rel > REMAT_LOSS_RTOL:
        raise AssertionError("remat lane: loss disagrees with the plain "
                             "lane's")
    lane.close()
    return {"wrapper": wrapper, "executed": executed, "bert": res}


def _amp_against_interpreter(cfg):
    """GRAPH_STEPS steps of the AMP step at batch GRAPH_BATCH, dropout
    0.1, compiled (eager, capture, replay) and interpreted, each from its
    own startup run: losses and parameters bitwise. The attention's Q, K
    and V, read from the interpreter's scope, are f32."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT,
                                            use_amp=True)
    rng = np.random.RandomState(SEED + 8)
    feeds = [_train_batch(rng, GRAPH_BATCH, cfg) for _ in range(GRAPH_STEPS)]
    params = main.global_block().all_parameters()
    got, kinds = {}, []
    try:
        for mode in ("compiled", "interpreted"):
            fluid.core.set_flag("FLAGS_executor_mode", mode)
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            losses = []
            for f in feeds:
                losses.append(exe.run(main, feed=f, fetch_list=[loss],
                                      scope=scope)[0])
                if mode == "compiled":
                    kinds.append(exe._last_block.last_exec)
            got[mode] = (losses, _params(scope, params))
            if mode == "interpreted":
                qkv = {str(scope.find_var(op.input(s)[0]).value().array
                           .dtype) for op in main.global_block().ops
                       if op.type == "fused_attention_qkv"
                       for s in ("Q", "K", "V")}
                if qkv != {"torch.float32"}:
                    raise AssertionError(f"AMP attention inputs {qkv}")
            exe.close()
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    if kinds != ["eager", "capture", "replay"]:
        raise AssertionError(f"AMP compiled runs {kinds}")
    _log(f"[amp] batch {GRAPH_BATCH} dropout {TRAIN_DROPOUT}: losses " +
         " ".join(f"{float(x[0]):.6f}" for x in got["compiled"][0]) +
         "; the attention's Q, K, V are f32 (bf16 products plus f32 biases)")
    _bitwise(f"AMP, {GRAPH_STEPS} steps compiled (eager, capture, replay) "
             "vs interpreted: losses", got["compiled"][0],
             got["interpreted"][0])
    _bitwise(f"AMP, compiled vs interpreted after {GRAPH_STEPS} steps: "
             f"{len(params)} parameters", got["compiled"][1],
             got["interpreted"][1])


def phase_amp(f32, profile=False):
    """BERT-base pretraining with use_amp=True (bf16 products through
    contrib.mixed_precision, f32 master weights), dropout 0.1, input
    mask, Adam, compiled, at TRAIN_BATCH: warm-up, a window of AMP_WINDOW
    steps timed, FALL_STEPS on one repeated batch. Gates: the kernels of
    every step (through the wrappers, in the graph, in a trace of one
    replay), a finite loss, the loss falling on the repeated batch, and 3
    steps compiled against interpreted bitwise. ``f32``: the train
    phase's figures of this run, printed beside."""
    import collections
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT,
                                            use_amp=True)
    ops = main.global_block().ops
    # the route follows the dtype the AMP rewrite leaves the attention's
    # operands in
    route = _attention_route(main)
    want = _step_want(ops, route)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 7)
    pool = [_train_batch(rng, TRAIN_BATCH, cfg) for _ in range(POOL)]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    runs = collections.Counter()
    what = "an AMP training step"
    _train_steps(exe, main, loss, scope, pool[:TRAIN_WARMUP], want, runs,
                 what)
    times, losses = _train_steps(
        exe, main, loss, scope,
        [pool[(TRAIN_WARMUP + i) % POOL] for i in range(AMP_WINDOW)], want,
        runs, what)
    fall = _train_steps(exe, main, loss, scope, [pool[0]] * FALL_STEPS,
                        want, runs, what)[1]
    peak = torch.cuda.max_memory_allocated() - before
    _check_trace(_device_kernel_counts(lambda: _train_steps(
        exe, main, loss, scope, [pool[1]], want, runs, what)), want,
        "AMP training step")
    launches = _launch_counts()
    n_runs = sum(runs.values())
    if launches != tuple((runs["eager"] + runs["capture"]) * w
                         for w in want):
        raise AssertionError(f"AMP launches {launches} over {dict(runs)}")
    ms = np.asarray(times) * 1e3
    n_cast = sum(op.type == "cast" for op in ops)
    _log(f"[amp] BERT-base use_amp=True: {len(ops)} ops ({n_cast} casts to "
         f"bf16), batch {TRAIN_BATCH}, dropout {TRAIN_DROPOUT}: "
         f"{AMP_WINDOW} steps, step p50 {np.percentile(ms, 50):.3f} ms p90 "
         f"{np.percentile(ms, 90):.3f} ms, "
         f"{TRAIN_BATCH * AMP_WINDOW / (ms.sum() / 1e3):.2f} samples/s, "
         f"peak {peak / 2**30:.3f} GiB; the f32 train phase of this run: "
         f"p50 {f32['p50_ms']:.3f} ms, {f32['samples_s']:.2f} samples/s, "
         f"peak {f32['peak_gib']:.3f} GiB; losses {losses[0]:.4f} .. "
         f"{losses[-1]:.4f}")
    _log(f"[amp] {n_runs} steps: {dict(runs)}; attention backward route "
         f"{route} (read from the program); kernels a step {want} "
         f"(graph and trace), through the wrappers {launches}")
    _log(f"[amp] repeated batch, {FALL_STEPS} steps: " +
         " ".join(f"{x:.4f}" for x in fall))
    if not (fall[-1] < fall[0] and np.mean(fall[-3:]) < np.mean(fall[:3])):
        raise AssertionError("AMP: the loss does not fall on a repeated "
                             "batch")
    if profile:
        _profile_step(exe, main, loss, scope, pool[1],
                      f"AMP train step batch {TRAIN_BATCH}")
    exe.close()
    del exe, scope
    _amp_against_interpreter(cfg)
    return {"wrapper": launches,
            "executed": tuple(n_runs * w for w in want)}


def _dyn_scale_run(mode, white_list=None):
    """The TPU package's dynamic-scaling program (tests/test_quant_amp.py
    :91: MLP, SGD 0.1, scale 8, x2 every 2 clean steps, x0.5 every bad
    one) on the card, 6 steps with x[0, 0] = inf at step 2 → (losses,
    scales, how each compiled step ran)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        AutoMixedPrecisionLists, decorate)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", shape=[8], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        lists = AutoMixedPrecisionLists()
        if white_list is not None:
            lists.white_list = set(white_list)
        opt = decorate(fluid.optimizer.SGD(0.1), amp_lists=lists,
                       init_loss_scaling=8.0, incr_every_n_steps=2,
                       decr_every_n_nan_or_inf=1, incr_ratio=2.0,
                       decr_ratio=0.5, use_fp16=True)
        opt.minimize(loss)
    rng = np.random.RandomState(0)
    X = rng.rand(16, 8).astype("float32")
    Y = rng.randint(0, 4, (16, 1)).astype("int64")
    Xbad = X.copy()
    Xbad[0, 0] = np.inf
    losses, scales, kinds = [], [], []
    fluid.core.set_flag("FLAGS_executor_mode", mode)
    try:
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        for i in range(6):
            (lv,) = exe.run(main, feed={"x": Xbad if i == 2 else X, "y": Y},
                            fetch_list=[loss], scope=scope)
            losses.append(float(lv.reshape(-1)[0]))
            scales.append(float(scope.find_var(opt._loss_scaling_var.name)
                                .value().array.item()))
            kinds.append(exe._last_block.last_exec if mode == "compiled"
                         else exe._last_run_mode)
        exe.close()
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    return losses, scales, kinds


def _skip_replay(cfg):
    """``skip`` on BERT-base at batch GRAPH_BATCH, dropout 0.1: clean
    steps (eager, capture, replay), then a replay fed an inf in the input
    mask, then a clean replay. The poisoned step's loss is NaN and its
    health False; every parameter and Adam slot is bitwise its pre-step
    value; the next step is finite and healthy. Then a window of 4 with
    its third step poisoned: health [True, True, False, True]."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    rng = np.random.RandomState(SEED + 9)
    feeds = [_train_batch(rng, GRAPH_BATCH, cfg) for _ in range(4)]
    bad = dict(feeds[3], input_mask=feeds[3]["input_mask"].copy())
    bad["input_mask"][0, 0] = np.inf
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    for f in feeds[:3]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    before = _persistables(scope, main)
    (lv,) = exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    cb = exe._last_block
    health = bool(exe._last_health)
    after = _persistables(scope, main)
    (lv2,) = exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    health2 = bool(exe._last_health)
    ok = (cb.last_exec == "replay" and cb._guard_action == "skip"
          and np.isnan(lv).all() and not health
          and np.isfinite(lv2).all() and health2)
    # a window of the same graph's replays, its third step poisoned: each
    # step carries its own health and only that step is discarded
    window = [feeds[0], feeds[1], bad, feeds[2]]
    (wl,) = exe.run(main, feed={n: np.stack([f[n] for f in window])
                                for n in bad}, fetch_list=[loss],
                    scope=scope, n_steps=len(window))
    flags = exe._last_health.tolist()
    wl = wl.ravel()
    ok = ok and exe._last_block is cb and flags == [True, True, False, True] \
        and np.isnan(wl[2]) and np.isfinite(wl[[0, 1, 3]]).all()
    _log(f"[guard] skip, a window of {len(window)} replays with step 2 fed "
         f"an inf: health {flags}, losses "
         + " ".join(f"{x:.6f}" for x in wl))
    same = [torch.equal(before[n], after[n]) for n in before]
    n_slots = sum("moment" in n or "pow_acc" in n for n in before)
    _log(f"[guard] skip, BERT-base batch {GRAPH_BATCH}: a replay fed an inf "
         f"gives loss {float(lv[0])} and health {health}; "
         f"{same.count(True)} of {len(same)} persistables ({n_slots} Adam "
         "slots) bitwise at their pre-step values; the next replay loss "
         f"{float(lv2[0]):.6f}, health {health2} -> "
         f"{'ok' if ok and all(same) else 'FAIL'}")
    exe.close()
    if not (ok and all(same)):
        raise AssertionError("skip did not discard the poisoned replay")


def phase_guard():
    """The numeric fault guard on the card. The dynamic-scaling program
    with an inf at step 2: the scale trajectory [8, 16, 8, 8, 16, 16]
    compiled (the bad step a replay), and with an empty white list
    compiled against interpreted bitwise. ``skip`` on BERT-base discards
    a poisoned replay (``_skip_replay``). Then the cost of
    FLAGS_check_nan_inf with skip on the train phase's step (f32, batch
    TRAIN_BATCH, dropout 0.1): GUARD_WINDOW steps with the guard off and
    on, alternated GUARD_BLOCKS times, each block after its own warm-up
    steps, every step gated on its kernels."""
    import collections
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    traj = [8.0, 16.0, 8.0, 8.0, 16.0, 16.0]
    losses, scales, kinds = _dyn_scale_run("compiled")
    ok = (scales == traj and np.isnan(losses[2])
          and np.isfinite(losses[:2] + losses[3:]).all()
          and kinds == ["eager", "capture"] + ["replay"] * 4)
    _log(f"[guard] dynamic loss scaling, inf at step 2, compiled "
         f"({', '.join(kinds)}): scales {scales}, losses "
         + " ".join(f"{x:.6f}" for x in losses)
         + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dynamic scaling on the card: {scales}")
    lc, sc, _ = _dyn_scale_run("compiled", white_list=())
    li, si, _ = _dyn_scale_run("interpreted", white_list=())
    same = sc == si == traj and np.array_equal(np.asarray(lc),
                                               np.asarray(li), equal_nan=True)
    _log(f"[guard] empty white list: compiled scales {sc}, interpreted "
         f"{si}; losses compiled against interpreted "
         f"{'bitwise equal' if same else 'DIFFER'} -> "
         f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("dynamic scaling: compiled and interpreted "
                             "differ")
    cfg = bert.bert_base_config()
    flags = ("FLAGS_check_nan_inf", "FLAGS_nan_inf_action")
    fluid.core.set_flag("FLAGS_nan_inf_action", "skip")
    try:
        fluid.core.set_flag("FLAGS_check_nan_inf", True)
        _skip_replay(cfg)
        main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
        want = _step_want(main.global_block().ops, _attention_route(main))
        if want != TRAIN_STEP_WANT:
            raise AssertionError(f"guard: want {want} launches a step, not "
                                 f"{TRAIN_STEP_WANT}")
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(SEED + 2)
        pool = [_train_batch(rng, TRAIN_BATCH, cfg) for _ in range(POOL)]
        _reset_launch_counts()
        runs = collections.Counter()
        times = {False: [], True: []}
        for i in range(2 * GUARD_BLOCKS):
            on = i % 2 == 1
            fluid.core.set_flag("FLAGS_check_nan_inf", on)
            what = f"a training step, guard {'on' if on else 'off'}"
            _train_steps(exe, main, loss, scope, pool[:TRAIN_WARMUP], want,
                         runs, what)
            if exe._last_block._guard_active != on:
                raise AssertionError(f"{what} ran a block built for the "
                                     "other setting")
            times[on] += _train_steps(
                exe, main, loss, scope,
                [pool[(TRAIN_WARMUP + j) % POOL] for j in
                 range(GUARD_WINDOW)], want, runs, what)[0]
        launches = _launch_counts()
        exe.close()
    finally:
        fluid.core.set_flag("FLAGS_check_nan_inf", False)
        fluid.core.set_flag("FLAGS_nan_inf_action", "raise")
    if launches != tuple((runs["eager"] + runs["capture"]) * w
                         for w in want):
        raise AssertionError(f"guard launches {launches} over {dict(runs)}")
    p50 = {on: float(np.percentile(np.asarray(t) * 1e3, 50))
           for on, t in times.items()}
    _log(f"[guard] FLAGS_check_nan_inf with skip, f32 step batch "
         f"{TRAIN_BATCH} dropout {TRAIN_DROPOUT}: p50 off {p50[False]:.3f} "
         f"ms, on {p50[True]:.3f} ms "
         f"({100 * (p50[True] / p50[False] - 1):+.2f} %), {GUARD_BLOCKS} "
         f"blocks of {GUARD_WINDOW} steps each, alternated; {dict(runs)}; "
         f"flags {flags} restored")
    n_runs = sum(runs.values())
    return {"wrapper": launches,
            "executed": tuple(n_runs * w for w in want)}


# --------------------------------------------------------------------------
# 10. resnet
# --------------------------------------------------------------------------
CONV_F32_TOL = 1e-5          # the conv op's f32 result against float64,
                             # relative to the largest magnitude: f32 sums
                             # (TF32 operands sit near 1e-3)
# substrings of the names of cuDNN's and cuBLAS's kernels (convolutions,
# their layout transforms, the classifier's GEMM)
_CONV_KERNEL_KEYS = ("conv", "xmma", "cudnn", "cutlass", "dgrad", "wgrad",
                     "fprop", "implicit", "gemm")


def _resnet_program(**kw):
    """ResNet-50 at bench.py's widths (1000 classes, 224×224), seeded;
    ``kw`` goes to build_resnet_train_program (lr)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet
    with fluid.unique_name.guard():
        main, startup, _, fetches = resnet.build_resnet_train_program(
            depth=50, class_dim=1000, image_size=224, **kw)
    startup.random_seed = main.random_seed = SEED
    return main, startup, fetches


def _image_batch(rng, bs):
    return {"image": rng.rand(bs, 3, 224, 224).astype("float32"),
            "label": rng.randint(0, 1000, (bs, 1)).astype("int64")}


def _cudnn_free():
    """The conv op's cuDNN flags with deterministic algorithms off: what
    the op would run without its determinism pin."""
    import torch
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=False, allow_tf32=False)


def _conv_pin_check():
    """With torch's default cuDNN flags (allow_tf32 True) the conv op's
    f32 forward and generic grad at a ResNet-50 shape equal bitwise what
    they give with TF32 off process-wide, and the forward lies within
    CONV_F32_TOL of a float64 conv; F.conv2d under the same defaults is
    printed beside it."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.registry import OPS, run_generic_grad
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the check needs torch's default cuDNN flags")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randn(32, 64, 56, 56, generator=gen, device="cuda")
    w = torch.randn(64, 64, 3, 3, generator=gen, device="cuda") * 0.05
    g = torch.randn(32, 64, 56, 56, generator=gen, device="cuda")
    attrs = dict(OPS.get("conv2d").attr_defaults, paddings=[1, 1])

    def op():
        o = OPS.get("conv2d").kernel({"Input": [x], "Filter": [w]},
                                     attrs)["Output"][0]
        gr = run_generic_grad("conv2d", {"Input": [x], "Filter": [w],
                                         "Output@GRAD": [g]}, attrs,
                              ["Input@GRAD", "Filter@GRAD"],
                              ["Input", "Filter"])
        return [o, gr["Input@GRAD"][0], gr["Filter@GRAD"][0]]
    default = op()
    torch.backends.cudnn.allow_tf32 = False
    try:
        off = op()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    what = "conv2d f32 [32, 64, 56, 56] * [64, 64, 3, 3]"
    _bitwise(f"{what}, forward, Input and Filter grads: torch's default "
             "cuDNN flags (allow_tf32 True) against TF32 off process-wide",
             default, off, tag="[resnet]")
    ref = F.conv2d(x.double(), w.double(), padding=1)
    scale = float(ref.abs().max())
    err = float((default[0].double() - ref).abs().max()) / scale
    err_lib = float((F.conv2d(x, w, padding=1).double() - ref).abs().max()
                    ) / scale
    ok = err <= CONV_F32_TOL
    _log(f"[resnet] {what} against float64: the op {err:.3e}, F.conv2d "
         f"under torch's defaults {err_lib:.3e} of max|out| {scale:.3e} "
         f"(tol {CONV_F32_TOL:g} for the op) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the conv op is not f32-accurate under torch's "
                             "default cuDNN flags")


def _resnet_kernel_shares(busy, top):
    conv = [e for e in top
            if any(k in e.key.lower() for k in _CONV_KERNEL_KEYS)]
    conv_ms = sum(e.self_device_time_total for e in conv) / 1e3
    _log(f"[profile] cuDNN/cuBLAS kernels (convolutions, their layout "
         f"transforms, the classifier's GEMM) {conv_ms:.3f} ms "
         f"({100 * conv_ms / busy:.1f}%) in {sum(e.count for e in conv)} "
         f"launches; everything else (elementwise passes, reductions, "
         f"copies, casts) {busy - conv_ms:.3f} ms "
         f"({100 - 100 * conv_ms / busy:.1f}%)")


def _op_type_shares(lane, what):
    """Device time of ``lane``'s step by op type: each op of its compiled
    plan (a forward op, or the grad op that re-runs a forward under
    autograd and differentiates it) captured into a CUDA graph of its own
    and replayed (``_cuda_ms``), in the plan's order over the outputs of
    the ops before it, from the lane's state and feeds; summed by op
    type. The sum stands beside the whole step's replay. Run it under
    the lane's flags (``_lane_flags``): the ops read them."""
    import collections
    import torch
    from paddle_tpu_torch.fluid import executor as ex
    cb = lane.exe._last_block
    if cb._remat_plan is not None or len(cb._units) != len(cb.ops):
        raise AssertionError("the op-type profile takes a plan of plain ops")
    env = dict(cb._read_state(lane.scope))
    env.update((n, torch.as_tensor(v).to(cb.device))
               for n, v in lane.feed.items())
    by_type = collections.Counter()
    cb._keys.begin(ex._step_counter(lane.scope, cb.device))
    try:
        for op, u in zip(cb.ops, cb._units):
            by_type[op.type] += _cuda_ms(lambda: u.run(env), iters=5,
                                         warmup=1)
            for n in u.frees:
                env.pop(n, None)
    finally:
        cb._keys.end()
    total = sum(by_type.values())
    _log(f"[profile] {what}, each op's kernels replayed in a graph of its "
         f"own: {total:.3f} ms in all ({len(cb.ops)} ops), by op type:")
    for t, ms in by_type.most_common(16):
        _log(f"[profile]   {ms:9.3f} ms ({100 * ms / total:5.1f}%)  {t}")
    bn = by_type["batch_norm"] + by_type["batch_norm_grad"]
    _log(f"[profile] {what}: batch_norm and its grad {bn:.3f} ms "
         f"({100 * bn / total:.1f}%)")


def _deterministic_cost(pinned):
    """The lane at the batch it landed on, again with cuDNN free to pick
    non-deterministic algorithms, then pinned again: step times side by
    side (the op keeps the pin: ROADMAP C2)."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import nn_ops
    pin = nn_ops._cudnn_pinned
    ms = {True: [pinned["step_ms"]], False: []}
    for det in (False, True):
        nn_ops._cudnn_pinned = pin if det else _cudnn_free
        try:
            r = bench.bench_resnet50(batch=pinned["batch"])
        finally:
            nn_ops._cudnn_pinned = pin
        if r["batch"] != pinned["batch"] or not r["timed_window"][
                "replays"] == r["steps"]:
            raise AssertionError(f"resnet lane rerun: {r}")
        ms[det].append(r["step_ms"])
    _log(f"[resnet] cuDNN deterministic algorithms: lane step "
         f"{' / '.join(f'{t:.3f}' for t in ms[True])} ms pinned (the lane, "
         f"then the last run), {ms[False][0]:.3f} ms free (run between "
         f"them), batch {pinned['batch']}: "
         f"{100 * (ms[True][0] + ms[True][1]) / 2 / ms[False][0] - 100:+.2f}"
         " % for the pin")
    return ms


def _resnet_falls():
    """RESNET_FALL_STEPS compiled steps of the lane's program at lr
    RESNET_FALL_LR on one repeated batch: the loss falls."""
    import collections
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, fetches = _resnet_program(lr=RESNET_FALL_LR)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _image_batch(np.random.RandomState(SEED + 21), RESNET_FALL_BATCH)
    runs = collections.Counter()
    with _lane_flags():
        _, fall = _train_steps(exe, main, fetches[0], scope,
                               [feed] * RESNET_FALL_STEPS, NO_KERNELS,
                               runs, "a ResNet-50 step")
    exe.close()
    ok = fall[-1] < fall[0] and np.mean(fall[-3:]) < np.mean(fall[:3])
    _log(f"[resnet] repeated batch {RESNET_FALL_BATCH}, bf16, Momentum("
         f"{RESNET_FALL_LR}, 0.9), {RESNET_FALL_STEPS} steps ({dict(runs)}): "
         + " ".join(f"{x:.4f}" for x in fall)
         + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ResNet-50 loss does not fall on a "
                             "repeated batch")


def _resnet_runs(main, startup, fetches, feeds, mode):
    """``feeds`` as one step each on the card, from a startup run, in
    FLAGS_executor_mode ``mode`` → (fetches a step, how each ran, the
    persistables after the startup run, and after the steps)."""
    from paddle_tpu_torch import fluid
    fluid.core.set_flag("FLAGS_executor_mode", mode)
    try:
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        init = _persistables(scope, main)
        got, kinds = [], []
        for f in feeds:
            got.append(exe.run(main, feed=f, fetch_list=fetches,
                               scope=scope))
            kinds.append(exe._last_run_mode + (
                ":" + exe._last_block.last_exec
                if exe._last_run_mode == "compiled" else ""))
        exe.close()
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    return got, kinds, init, _persistables(scope, main)


def _resnet_bitwise():
    """GRAPH_STEPS steps of the lane's program (bf16 convolutions) at
    batch RESNET_GRAPH_BATCH, 224×224: compiled (eager, capture, replay)
    against interpreted, and interpreted against itself, each from its
    own startup run; the fetches and every persistable (parameters,
    velocities, moving statistics) bitwise. Then, not gated, two
    interpreted runs with cuDNN free to pick non-deterministic
    algorithms."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import nn_ops
    main, startup, fetches = _resnet_program()
    rng = np.random.RandomState(SEED + 22)
    feeds = [_image_batch(rng, RESNET_GRAPH_BATCH)
             for _ in range(GRAPH_STEPS)]
    with _lane_flags():
        runs = {m: _resnet_runs(main, startup, fetches, feeds, m.split()[0])
                for m in ("compiled", "interpreted", "interpreted again")}
        pin = nn_ops._cudnn_pinned
        nn_ops._cudnn_pinned = _cudnn_free
        try:
            free = [_resnet_runs(main, startup, fetches, feeds,
                                 "interpreted") for _ in range(2)]
        finally:
            nn_ops._cudnn_pinned = pin
    kinds = runs["compiled"][1]
    if kinds != ["compiled:eager", "compiled:capture", "compiled:replay"]:
        raise AssertionError(f"compiled runs {kinds}")
    names = sorted(runs["compiled"][3])
    what = (f"ResNet-50 bf16 batch {RESNET_GRAPH_BATCH}, {GRAPH_STEPS} "
            "steps")
    for m in ("interpreted", "interpreted again"):
        if any(not torch.equal(runs["compiled"][2][n], runs[m][2][n])
               for n in names):
            raise AssertionError("the startup runs differ")
    for a, b in (("interpreted", "interpreted again"),
                 ("compiled", "interpreted")):
        _bitwise(f"{what}, {a} against {b}: losses and accuracies",
                 [x for r in runs[a][0] for x in r],
                 [x for r in runs[b][0] for x in r], tag="[resnet]")
        _bitwise(f"{what}, {a} against {b}: {len(names)} persistables "
                 "(parameters, velocities, moving statistics)",
                 [runs[a][3][n] for n in names],
                 [runs[b][3][n] for n in names], tag="[resnet]")
    differ = sum(not torch.equal(free[0][3][n], free[1][3][n])
                 for n in names)
    _log(f"[resnet] {what}, cuDNN free to pick non-deterministic "
         f"algorithms, interpreted against itself: "
         f"{differ} of {len(names)} persistables differ (not gated: the "
         "op pins deterministic algorithms)")


def _card_against_cpu(main, startup, fetch, feed, what):
    """``_card_and_cpu_step`` of a conv net: the loss (first fetch) gated
    at LOSS_TOL relative, each grad at KINK_L2_TOL in relative L2 (its
    largest difference printed beside it). → ((card executor, scope),
    (CPU executor, scope)) for further steps."""
    import numpy as np
    gpu, cpu, card, host = _card_and_cpu_step(main, startup, fetch, feed)
    ok = abs(float(gpu[0][0]) - float(cpu[0][0])) \
        <= LOSS_TOL * abs(float(cpu[0][0]))
    _log(f"[resnet] {what}, card vs CPU: loss {float(gpu[0][0]):.6f} vs "
         f"{float(cpu[0][0]):.6f} (tol {LOSS_TOL:g} relative)")
    for name, g, c in zip(fetch[1:], gpu[1:], cpu[1:]):
        rel = float(np.linalg.norm(g - c) / np.linalg.norm(c))
        ok = ok and rel <= KINK_L2_TOL
        _log(f"[resnet]   {name} {tuple(c.shape)}: relative L2 {rel:.3e} "
             f"(tol {KINK_L2_TOL:g}); max|d| {np.abs(g - c).max():.3e} of "
             f"max|grad| {np.abs(c).max():.3e}")
    if not ok:
        raise AssertionError(f"{what}: the card disagrees with the CPU")
    return card, host


def _resnet_against_cpu():
    """ResNet-50 in f32 (FLAGS_use_bf16_matmul off) at batch
    RESNET_CHECK_BATCH, 224×224: one step's loss and the grads of the
    stem conv, a middle conv, the last conv and the classifier."""
    import numpy as np
    main, startup, fetches = _resnet_program()
    ops = main.global_block().ops
    convs = [op.input("Filter")[0] for op in ops if op.type == "conv2d"]
    fc = [op.input("Y")[0] for op in ops if op.type == "mul"]
    fetch = [fetches[0]] + [n + "@GRAD" for n in
                            (convs[0], convs[len(convs) // 2], convs[-1],
                             fc[-1])]
    feed = _image_batch(np.random.RandomState(SEED + 23), RESNET_CHECK_BATCH)
    _card_against_cpu(main, startup, fetch, feed,
                      f"ResNet-50 f32 batch {RESNET_CHECK_BATCH}")


def _lenet_on_the_card():
    """models/mnist.py's conv net (conv, relu, max pool, batch norm, conv,
    relu, max pool, fc softmax; Adam 0.01) at batch LENET_BATCH: the first
    step's loss and every grad against the CPU, then the rest of
    LENET_STEPS steps on one batch, compiled (the later fetch list makes
    an eager run, a capture and replays), each on the card and the CPU."""
    import collections
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import mnist
    with fluid.unique_name.guard():
        main, startup, _, loss, _ = mnist.build_mnist_program(net="conv")
    startup.random_seed = main.random_seed = SEED
    rng = np.random.RandomState(SEED + 24)
    feed = {"img": rng.rand(LENET_BATCH, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (LENET_BATCH, 1)).astype("int64")}
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
             if p.trainable]
    (exe, scope), (cpu_exe, cpu_scope) = _card_against_cpu(
        main, startup, [loss.name] + grads, feed,
        f"LeNet conv net batch {LENET_BATCH}")
    runs = collections.Counter()
    _, card = _train_steps(exe, main, loss, scope,
                           [feed] * (LENET_STEPS - 1), NO_KERNELS, runs,
                           "a LeNet step")
    exe.close()
    cpu = [float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                             scope=cpu_scope)[0][0])
           for _ in range(LENET_STEPS - 1)]
    d = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    ok = runs == {"eager": 1, "capture": 1, "replay": LENET_STEPS - 3} \
        and card[-1] < card[0]
    _log(f"[resnet] LeNet steps 2-{LENET_STEPS} on one batch, compiled "
         f"({dict(runs)}): card " + " ".join(f"{x:.6f}" for x in card)
         + ", CPU " + " ".join(f"{x:.6f}" for x in cpu)
         + f" (max relative difference {d:.2e}, not gated: Adam's m/(√v+ε) "
         f"turns rounding noise on a near-zero grad into ±lr) -> "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("LeNet on the card: the steps did not replay "
                             "or the loss did not fall")


def phase_resnet(profile=False):
    """bench.py's resnet lane on the port through paddle_tpu_torch.bench
    (ResNet-50, bf16 convolutions, batch 64 or the ladder's next rung,
    224×224, Momentum(0.1, 0.9)), with torch's default cuDNN flags
    restored for the whole phase (TF32 allowed): the conv op must pin full
    f32 itself (``_conv_pin_check``). Gates: the conv pin; the lane's
    finite loss, compiled path and timed window of replays only; no flash
    or dropout kernel in a step (wrappers, graph, a trace of one replay);
    a falling loss on a repeated batch; compiled against interpreted and
    interpreted against itself bitwise; card against CPU in f32; LeNet on
    the card against the CPU. Also the cost of cuDNN's deterministic
    algorithms, and with ``profile`` the lane step's device time by
    kernel and idle share."""
    import torch
    from paddle_tpu_torch import bench
    want = NO_KERNELS
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    try:
        _conv_pin_check()
        _reset_launch_counts()
        lane = bench.run_resnet50()
        wrapper = _launch_counts()
        res = lane.res
        print(json.dumps(res), flush=True)
        n_conv = sum(op.type == "conv2d"
                     for op in lane.main.global_block().ops)
        if n_conv != 53:
            raise AssertionError(f"resnet lane: {n_conv} conv2d ops")
        runs = _gate_lane(lane, wrapper, want, "resnet lane")
        _log(f"[resnet] lane: batch {res['batch']} (OOM ladder 64/32/16), "
             f"image {res['image_size']}, {res['value']} samples/s, "
             f"{res['step_ms']} ms a step, peak {res['peak_memory_gib']} "
             f"GiB, mfu_vs_h100_bf16_peak {res['mfu_vs_h100_bf16_peak']}, "
             f"last loss {res['loss']:.4f}; {runs['eager']} eager, "
             f"{runs['captures']} capture, {runs['replays']} replays")
        if profile:
            with _lane_flags():
                _resnet_kernel_shares(*_profile_step(
                    lane.exe, lane.main, lane.fetches[0], lane.scope,
                    lane.feed, f"resnet lane bf16 batch {res['batch']}"))
                _op_type_shares(lane,
                                f"resnet lane bf16 batch {res['batch']}")
        lane.close()
        del lane
        _deterministic_cost(res)
        _resnet_falls()
        _resnet_bitwise()
        _resnet_against_cpu()
        _lenet_on_the_card()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    if _launch_counts() != want:
        raise AssertionError(f"the resnet phase launched {_launch_counts()} "
                             "flash or dropout kernels")
    return {"wrapper": wrapper, "executed": want, "lane": res}


# --------------------------------------------------------------------------
# 11. transformer
# --------------------------------------------------------------------------
# transformer_big's bf16 step: 18 attention ops (6 encoder, 6 + 6
# decoder) on the fused route, each forward run twice (the generic grad
# re-runs it), 42 dropout ops
WMT_STEP_WANT = (0, 0, 0, 18, 42, 36, 0, 0, 0, 0, 0, 0)
# a decode run: the 18 forwards, f32 (the f32 forward)
WMT_DECODE_WANT = (0, 0, 0, 0, 0, 0, 0, 0, 0, 18, 0, 0)
# bench's transformer lane, 2 + 2 layers
WMT_LANE_WANT = (0, 0, 0, 6, 0, 12, 0, 0, 0, 0, 0, 0)
WMT_WARMUP = 3                # steps before the timed ones
WMT_STEPS = 20                # bf16 steps timed
WMT_FALL_STEPS = 8            # steps on one repeated batch
WMT_NOAM_WARMUP = 4000        # transformer_big's Noam warm-up
WMT_LR_RTOL = 1e-6            # the Noam LR against its formula in float64
WMT_CHECK_BATCH = 4           # f32 card vs CPU at 1 + 1 layers
WMT_GRAPH_BATCH = 8           # bf16 compiled vs interpreted at 1 + 1 layers
WMT_LOGIT_TOL = 1e-3          # decode logits, card vs CPU, of max |logit|


def _wmt_cfg(**kw):
    """transformer_big_config(), uncut unless ``kw`` says otherwise."""
    from paddle_tpu_torch.models import transformer
    cfg = transformer.transformer_big_config()
    cfg.update(kw)
    return cfg


def _wmt_train_program(cfg, batch=None):
    """build_wmt_train_program at WMT_LEN, Noam decay (lr None), the
    phase's seed → (main, startup, loss, the Adam ops' LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer
    with fluid.unique_name.guard():
        main, startup, _, loss = transformer.build_wmt_train_program(
            cfg, src_len=WMT_LEN, trg_len=WMT_LEN, lr=None,
            warmup_steps=WMT_NOAM_WARMUP)
    startup.random_seed = main.random_seed = SEED
    lr = [op for op in main.global_block().ops
          if op.type == "adam"][0].input("LearningRate")[0]
    return main, startup, loss, lr


def _ragged_mask(rng, bs, n):
    """[bs, n] 1/0 keep-mask: every other row padded at its end."""
    import numpy as np
    m = np.ones((bs, n), "float32")
    for i in range(0, bs, 2):
        m[i, rng.randint(n // 2, n):] = 0.0
    return m


def _wmt_batch(rng, bs, cfg):
    """Random ids from ``rng`` and ragged masks (labels at padding
    positions are masked out of the loss)."""
    return {"src_ids": rng.randint(0, cfg["src_vocab"],
                                   (bs, WMT_LEN)).astype("int64"),
            "src_mask": _ragged_mask(rng, bs, WMT_LEN),
            "trg_ids": rng.randint(0, cfg["trg_vocab"],
                                   (bs, WMT_LEN)).astype("int64"),
            "trg_mask": _ragged_mask(rng, bs, WMT_LEN),
            "labels": rng.randint(0, cfg["trg_vocab"],
                                  (bs, WMT_LEN, 1)).astype("int64")}


def _noam(step, d_model):
    """Noam decay at ``step`` (from 1), in float64."""
    return d_model ** -0.5 * min(step ** -0.5,
                                 step * WMT_NOAM_WARMUP ** -1.5)


def _wmt_train_bf16(profile):
    """transformer_big's training step in bf16 products at B = 48, S = 64,
    dropout 0.3, Noam: gated launches each step, the LR against Noam's
    formula, a trace of one replay, the loss falling on a repeated batch.
    → (launches through the wrappers, launches run on the card)."""
    import collections
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import bench, fluid
    cfg = _wmt_cfg()
    main, startup, loss, lr = _wmt_train_program(cfg)
    ops = main.global_block().ops
    want = _step_want(ops, "fused")
    if want != WMT_STEP_WANT:
        raise AssertionError(f"transformer step: want {want} launches, not "
                             f"{WMT_STEP_WANT}")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(p.name).value().array.numel()
                   for p in params)
    _log(f"[transformer] transformer_big training step: {cfg['enc_layers']} "
         f"+ {cfg['dec_layers']} layers, d_model {cfg['d_model']}, d_inner "
         f"{cfg['d_inner']}, {cfg['heads']} heads, vocab {cfg['trg_vocab']}, "
         f"label smoothing {cfg['label_smooth']}, dropout {cfg['dropout']}, "
         f"Noam (warm-up {WMT_NOAM_WARMUP}), Adam; {len(ops)} ops, "
         f"{len(params)} parameters ({n_params} values); batch {WMT_BATCH} x "
         f"{WMT_LEN} source and target tokens, bf16 products")
    rng = np.random.RandomState(0)
    pool = [_wmt_batch(rng, WMT_BATCH, cfg) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    runs = collections.Counter()
    lrs = []

    def step(feed):
        b = _launch_counts()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
        dt = time.perf_counter() - t
        delta = tuple(x - y for x, y in zip(_launch_counts(), b))
        runs[_gate_run(exe, delta, want, "a transformer step")] += 1
        value = float(out[0].reshape(-1)[0])
        if not np.isfinite(value):
            raise AssertionError(f"non-finite loss {value}")
        lrs.append(float(out[1].reshape(-1)[0]))
        return value, dt

    with _lane_flags():
        for i in range(WMT_WARMUP):
            step(pool[i % len(pool)])
        times = [step(pool[i % len(pool)])[1] for i in range(WMT_STEPS)]
        fall = [step(pool[0])[0] for _ in range(WMT_FALL_STEPS)]
        peak = torch.cuda.max_memory_allocated() - before
        wrapper = _launch_counts()
        _check_trace(_device_kernel_counts(lambda: step(pool[1])), want,
                     f"transformer bf16 batch {WMT_BATCH} step")
        if profile:
            _profile_step(exe, main, loss, scope, pool[1],
                          f"transformer bf16 batch {WMT_BATCH} step")
    want_lr = [_noam(i + 1, cfg["d_model"]) for i in range(len(lrs))]
    lr_err = max(abs(a - b) / b for a, b in zip(lrs, want_lr))
    _log(f"[transformer] Noam LR over {len(lrs)} runs: {lrs[0]:.6e} .. "
         f"{lrs[-1]:.6e}, max relative error {lr_err:.2e} against "
         f"d^-0.5 min(t^-0.5, t w^-1.5) (tol {WMT_LR_RTOL:g})")
    if lr_err > WMT_LR_RTOL:
        raise AssertionError("the LR does not follow Noam decay")
    ms = np.asarray(times) * 1e3
    p50 = float(np.percentile(ms, 50))
    tokens = 2 * WMT_BATCH * WMT_LEN
    mfu = bench.transformer_flops_per_step(cfg, WMT_BATCH, WMT_LEN, WMT_LEN) \
        / (p50 / 1e3) / bench.H100_BF16_PEAK_FLOPS
    _log(f"[transformer] bf16 batch {WMT_BATCH}: {WMT_STEPS} steps, step "
         f"p50 {p50:.3f} ms p90 {np.percentile(ms, 90):.3f} ms max "
         f"{ms.max():.3f} ms, {tokens / (p50 / 1e3):.0f} tokens/s (source "
         f"and target), {WMT_BATCH / (p50 / 1e3):.2f} sentence pairs/s, "
         f"mfu_vs_h100_bf16_peak {mfu:.4f}; peak device memory "
         f"{peak / 2**30:.3f} GiB (less the {before / 2**30:.3f} GiB "
         f"allocated before)")
    _log(f"[transformer] {dict(runs)} runs; launches through the wrappers "
         f"{wrapper}, {want} a step {GATE_NAMES}")
    _log(f"[transformer] repeated batch, {WMT_FALL_STEPS} steps: " +
         " ".join(f"{x:.4f}" for x in fall))
    if not (fall[-1] < fall[0]
            and np.mean(fall[-3:]) < np.mean(fall[:3])):
        raise AssertionError("the transformer's loss does not fall on a "
                             "repeated batch")
    exe.close()
    del exe, scope
    return wrapper, tuple(sum(runs.values()) * w for w in want)


def _wmt_graph_against_interpreter():
    """At 1 + 1 layers of the full widths, bf16 products, dropout 0.3:
    3 steps compiled (eager, capture, replay) against 3 interpreted, from
    the same startup: losses, LRs and every persistable bitwise."""
    import numpy as np
    from paddle_tpu_torch import fluid
    cfg = _wmt_cfg(enc_layers=1, dec_layers=1)
    main, startup, loss, lr = _wmt_train_program(cfg)
    rng = np.random.RandomState(1)
    feeds = [_wmt_batch(rng, WMT_GRAPH_BATCH, cfg) for _ in range(3)]
    got, state = {}, {}
    try:
        with _lane_flags():
            for mode in ("compiled", "interpreted"):
                fluid.core.set_flag("FLAGS_executor_mode", mode)
                exe, scope = fluid.Executor(fluid.CUDAPlace(0)), \
                    fluid.Scope()
                exe.run(startup, scope=scope)
                got[mode] = [exe.run(main, feed=f, fetch_list=[loss, lr],
                                     scope=scope) for f in feeds]
                if mode == "compiled" and \
                        exe._last_block.last_exec != "replay":
                    raise AssertionError("the third compiled step was not "
                                         "a replay")
                state[mode] = _persistables(scope, main)
                exe.close()
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    _bitwise("transformer 1 + 1 layers bf16, 3 steps (eager, capture, "
             "replay) vs interpreted: losses and LRs",
             [x for r in got["compiled"] for x in r],
             [x for r in got["interpreted"] for x in r], "[transformer]")
    names = sorted(state["compiled"])
    _bitwise(f"the same after 3 steps: {len(names)} persistables",
             [state["compiled"][n] for n in names],
             [state["interpreted"][n] for n in names], "[transformer]")


def _wmt_f32_against_cpu():
    """One f32 step at 1 + 1 layers of the full widths, dropout 0, on the
    card (the f32 forward, the f32 dK/dV kernel and the dQ kernel) and by
    the port on the CPU from the same weights: the loss and three grads at
    the train phase's tolerances."""
    import numpy as np
    cfg = _wmt_cfg(enc_layers=1, dec_layers=1, dropout=0.0)
    main, startup, loss, _ = _wmt_train_program(cfg)
    ops = main.global_block().ops
    want = _step_want(ops, _attention_route(main))
    muls = [op for op in ops if op.type == "mul"]
    names = ["src_embedding", muls[0].input("Y")[0], "trg_proj"]
    fetch = [loss] + [n + "@GRAD" for n in names]
    feed = _wmt_batch(np.random.RandomState(2), WMT_CHECK_BATCH, cfg)
    before = _launch_counts()
    gpu, cpu, (exe, _), _ = _card_and_cpu_step(main, startup, fetch, feed)
    delta = tuple(a - b for a, b in zip(_launch_counts(), before))
    _gate_run(exe, delta, want, "the f32 transformer step")
    _loss_and_grads_agree(f"[transformer] f32 1 + 1 layers batch "
                          f"{WMT_CHECK_BATCH}, {want} launches", names, gpu,
                          cpu)
    exe.close()


def _greedy(exe, main, logits, scope, src, smask, trg, each=None):
    """Greedy decode in place: run ``main`` once a position and write each
    argmax into ``trg`` (the same array, fed again each run); ``each``
    is called after every run with (position, seconds)."""
    for pos in range(trg.shape[1] - 1):
        t = time.perf_counter()
        out, = exe.run(main, feed={"src_ids": src, "src_mask": smask,
                                   "trg_ids": trg},
                       fetch_list=[logits], scope=scope)
        dt = time.perf_counter() - t
        trg[:, pos + 1] = out[:, pos].argmax(-1)
        if each is not None:
            each(pos, dt)
    return trg


def _wmt_decode(profile=False):
    """Greedy decode of transformer_big in f32 at dropout 0: B = 8, 64
    source tokens, 80 target positions, 79 runs of one compiled program
    (the f32 forward: cross-attention 80 over 64 keys, causal
    self-attention 80 x 80). Gates: every run compiled with (0, ..., 18, 0)
    launches, each run re-feeds the mutated target array (an upload, the
    other feeds cache hits), a trace of one replay. Then the CPU port
    runs once from the same weights on the card's tokens (a
    teacher-forced prefix): the card's logits at every position against
    the CPU's. → (wrapper launches, executed launches)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer
    cfg = _wmt_cfg(dropout=0.0)
    with fluid.unique_name.guard():
        main, startup, _, logits = transformer.build_greedy_decode_program(
            cfg, src_len=WMT_LEN, max_out_len=WMT_DECODE_OUT)
    startup.random_seed = main.random_seed = SEED
    rng = np.random.RandomState(3)
    src = rng.randint(0, cfg["src_vocab"],
                      (WMT_DECODE_BATCH, WMT_LEN)).astype("int64")
    smask = _ragged_mask(rng, WMT_DECODE_BATCH, WMT_LEN)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    _reset_launch_counts()
    times, kinds = [], []
    last = [_launch_counts(), (0, 0)]

    def gate(pos, dt):
        """The run's launches, and its feeds: the first uploads all three,
        each later one the mutated trg_ids alone."""
        now = _launch_counts()
        delta = tuple(a - b for a, b in zip(now, last[0]))
        kinds.append(_gate_run(exe, delta, WMT_DECODE_WANT, "a decode run"))
        fs = (exe.feed_stats["uploads"], exe.feed_stats["cache_hits"])
        moved = tuple(a - b for a, b in zip(fs, last[1]))
        if moved != ((3, 0) if pos == 0 else (1, 2)):
            raise AssertionError(f"decode run {pos}: {moved[0]} uploads, "
                                 f"{moved[1]} cache hits; want the mutated "
                                 "trg_ids uploaded, the 2 others hit")
        last[:] = [now, fs]
        times.append(dt)

    last[1] = (exe.feed_stats["uploads"], exe.feed_stats["cache_hits"])
    trg = _greedy(exe, main, logits, scope, src, smask,
                  np.zeros((WMT_DECODE_BATCH, WMT_DECODE_OUT), "int64"),
                  gate)  # BOS = 0
    wrapper = _launch_counts()
    n_runs = len(kinds)
    if kinds[:3] != ["eager", "capture", "replay"] \
            or set(kinds[2:]) != {"replay"}:
        raise AssertionError(f"decode runs {kinds[:4]} ...")
    if wrapper != tuple(2 * w for w in WMT_DECODE_WANT):
        raise AssertionError(f"decode launches through the wrappers "
                             f"{wrapper}: want the eager run's and the "
                             "capture's")
    feed = {"src_ids": src, "src_mask": smask, "trg_ids": trg}
    _check_trace(_device_kernel_counts(lambda: exe.run(
        main, feed=feed, fetch_list=[logits], scope=scope)),
        WMT_DECODE_WANT, f"decode run batch {WMT_DECODE_BATCH}")
    if profile:
        _profile_step(exe, main, logits, scope, feed,
                      f"greedy decode run batch {WMT_DECODE_BATCH}")
    ms = np.asarray(times[2:]) * 1e3
    _log(f"[transformer] greedy decode f32 batch {WMT_DECODE_BATCH}, "
         f"{WMT_LEN} source tokens, {WMT_DECODE_OUT} positions: {n_runs} "
         f"runs (eager, capture, {n_runs - 2} replays); per decode step "
         f"(replays) p50 {np.percentile(ms, 50):.3f} ms p99 "
         f"{np.percentile(ms, 99):.3f} ms, "
         f"{WMT_DECODE_BATCH / (np.percentile(ms, 50) / 1e3):.1f} tokens/s; "
         f"each run uploaded only the mutated trg_ids")
    # the CPU port from the card's weights, one run on the card's tokens
    # (teacher forcing): both sides' logits at every position, and the
    # CPU's own choice after each of the card's prefixes
    cpu_scope = fluid.Scope()
    for v in main.global_block().vars.values():
        if v.persistable:
            cpu_scope.var(v.name).set_value(fluid.LoDTensor(
                scope.find_var(v.name).value().array.cpu()))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    t = time.perf_counter()
    card_l, = exe.run(main, feed=feed, fetch_list=[logits], scope=scope)
    cpu_l, = cpu_exe.run(main, feed=feed, fetch_list=[logits],
                         scope=cpu_scope)
    cpu_s = time.perf_counter() - t
    err = float(np.abs(card_l - cpu_l).max())
    scale = float(np.abs(cpu_l).max())
    picks = cpu_l.reshape(trg.shape + (-1,))[:, :-1].argmax(-1)
    same = float((picks == trg[:, 1:]).mean())
    _log(f"[transformer] decode logits on the card's greedy tokens (one "
         f"CPU run, {cpu_s:.1f} s): card vs CPU max|d| "
         f"{err:.3e} of max|logit| {scale:.3e} over all "
         f"{WMT_DECODE_OUT} positions (tol {WMT_LOGIT_TOL:g} of it); the "
         f"CPU's argmax after each of the card's prefixes is the card's "
         f"token at {same:.1%} of positions (random weights: an argmax "
         f"flips on rounding)")
    if not err <= WMT_LOGIT_TOL * scale:
        raise AssertionError("decode logits on the card disagree with the "
                             "CPU's")
    exe.close()
    return wrapper, tuple(n_runs * w for w in WMT_DECODE_WANT)


def _wmt_lane():
    """bench's transformer lane (``python3 -m paddle_tpu_torch.bench
    transformer``): its JSON line, and the bench lanes' gates."""
    from paddle_tpu_torch import bench
    _reset_launch_counts()
    lane = bench.run_transformer()
    wrapper = _launch_counts()
    res = lane.res
    print(json.dumps(res), flush=True)
    want = _step_want(lane.main.global_block().ops, "fused")
    if want != WMT_LANE_WANT:
        raise AssertionError(f"transformer lane: want {want} launches a "
                             f"step, not {WMT_LANE_WANT}")
    runs = _gate_lane(lane, wrapper, want, "transformer lane")
    _log(f"[transformer] lane: batch {res['batch']}, {res['value']} ms a "
         f"step, {res['samples_per_sec']} samples/s, peak "
         f"{res['peak_memory_gib']} GiB, mfu_vs_h100_bf16_peak "
         f"{res['mfu_vs_h100_bf16_peak']}; {want} launches a step")
    lane.close()
    return wrapper, tuple((runs["eager"] + runs["replays"]) * w
                          for w in want)


def phase_transformer(profile=False):
    """Phase 11: transformer_big on the port (the docstring's phase 11)."""
    parts = [_wmt_train_bf16(profile)]
    _wmt_graph_against_interpreter()
    _wmt_f32_against_cpu()
    parts.append(_wmt_decode(profile))
    parts.append(_wmt_lane())
    return {"wrapper": tuple(map(sum, zip(*(p[0] for p in parts)))),
            "executed": tuple(map(sum, zip(*(p[1] for p in parts))))}


LANE512_STEPS = 20            # the S = 512 lane's window (bench's 20): the
                              # first thing to cut if the run outgrows its
                              # time limit


def phase_lane512(profile=False):
    """Phase 12: bench.py's bert lane at S = 512 (the docstring's phase
    12), as ``PADDLE_TPU_BENCH_SEQ=512 PADDLE_TPU_BENCH_BATCH=64 python3 -m
    paddle_tpu_torch.bench bert`` runs it: the batch pinned at 64, so the
    ladder tries no larger batch first."""
    from paddle_tpu_torch import bench
    env = {"PADDLE_TPU_BENCH_SEQ": str(LANE512_SEQ),
           "PADDLE_TPU_BENCH_BATCH": str(LANE512_BATCH)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        _reset_launch_counts()
        lane = bench.run_bert_base(steps=LANE512_STEPS)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wrapper = _launch_counts()
    res = lane.res
    print(json.dumps(res), flush=True)
    if (res["batch"], res["seq_len"]) != (LANE512_BATCH, LANE512_SEQ):
        raise AssertionError(f"S=512 lane ran batch {res['batch']} at S = "
                             f"{res['seq_len']}, want {LANE512_BATCH} at "
                             f"{LANE512_SEQ}")
    ops = lane.main.global_block().ops
    want = _step_want(ops, "streamed")
    if want != LANE512_STEP_WANT:
        raise AssertionError(f"S=512 lane: want {want} launches a step, not "
                             f"{LANE512_STEP_WANT}")
    runs = _gate_lane(lane, wrapper, want, "S=512 lane")
    executed = tuple((runs["eager"] + runs["replays"]) * w for w in want)
    with _lane_flags():
        if profile:
            _profile_step(lane.exe, lane.main, lane.fetches[0], lane.scope,
                          lane.feed, f"S=512 lane bf16 batch {res['batch']}")
    _log(f"[lane512] bert S={res['seq_len']}: batch {res['batch']}, "
         f"{res['value']} samples/s, {res['step_ms']} ms a step, peak "
         f"{res['peak_memory_gib']} GiB, mfu_vs_h100_bf16_peak "
         f"{res['mfu_vs_h100_bf16_peak']}; gate {want} {GATE_NAMES} "
         f"launches a step (wrappers, graph, trace) -> ok; {runs['eager']} "
         f"eager, {runs['captures']} capture, {runs['replays']} replays "
         f"before the trace; kernels run {executed}")
    lane.close()
    return {"wrapper": wrapper, "executed": executed, "bert": res}


WD_SPARSE_DIM = int(1e6)      # bench.py's wide_deep widths, uncut
WD_BATCH = 4096
WD_BITWISE_STEPS = 5          # segmented (eager, capture, 3 replays)
                              # against interpreted on the card, from one
                              # startup
WD_CHECK_DIM = int(1e4)       # card vs CPU: ids a slot
WD_CHECK_STEPS = 3
WD_FALL_STEPS = 10            # ctr_reader batches, one a step
WD_TIMED_STEPS = 20           # steps timed one by one, each synchronized
WD_AUC_TOL = 1e-3             # card vs CPU AUC: one ulp of sigmoid can move
                              # a prediction one bucket


def _wd_program(sparse_dim=WD_SPARSE_DIM):
    from paddle_tpu_torch import bench, fluid
    from paddle_tpu_torch.models import wide_deep
    with fluid.unique_name.guard():
        main, startup, _, loss, auc = wide_deep.build_wide_deep_program(
            sparse_dim=sparse_dim, **bench.WIDE_DEEP)
    return main, startup, loss, auc


def _wd_batches(n, sparse_dim=WD_SPARSE_DIM, seed=SEED):
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import wide_deep
    nb = wide_deep.ctr_reader(WD_BATCH, num_dense=bench.WIDE_DEEP[
        "num_dense"], num_slots=bench.WIDE_DEEP["num_slots"],
        sparse_dim=sparse_dim, seed=seed)
    return [nb() for _ in range(n)]


def _wd_gate_step(exe, stats0, want_exec, what):
    """One segmented run's gates: the segmented path, the run ``want_exec``
    ("eager", "capture" or "replay"), 2 graphs captured by the capture
    run, 2 replays a run from it on, 1 island dispatch a run, and no
    hand-written kernel recorded in a graph. → the block's stats."""
    cb = exe._last_block
    got = {k: cb.stats[k] - stats0[k] for k in ("captures", "replays",
                                                 "islands")}
    want = {"eager": {"captures": 0, "replays": 0, "islands": 1},
            "capture": {"captures": 2, "replays": 2, "islands": 1},
            "replay": {"captures": 0, "replays": 2, "islands": 1}}[want_exec]
    graph = tuple(cb.graph_launches.get(k, 0) for k in KERNELS)
    if exe._last_run_mode != "segmented" or cb.last_exec != want_exec \
            or got != want or graph != NO_KERNELS:
        raise AssertionError(
            f"{what}: ran {exe._last_run_mode} ({cb.last_exec}), {got} "
            f"over the run, {graph} kernels in the graphs; want segmented "
            f"({want_exec}), {want}, {NO_KERNELS}")
    return dict(cb.stats)


def _wd_segmented_vs_interpreted():
    """Wide&Deep at full width: WD_BITWISE_STEPS steps segmented (eager,
    capture, then replays: from the second replay on an island's outputs
    refill a graph's static buffers and the first graph reads state the
    last one wrote in place) and as many interpreted, on the card from the
    same startup values and batches. Loss, AUC, the histograms and every
    parameter and Adam moment bitwise. The segmented scope then trains WD_FALL_STEPS more
    steps: the loss falls and the AUC ends above 0.5. → (the executor,
    scope, program, fetches, one feed), for a traced step."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import core
    main, startup, loss, auc = _wd_program()
    fetch = [loss, auc]
    seg_scope, int_scope = fluid.Scope(), fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=seg_scope)
    for n, t in _persistables(seg_scope, main).items():
        int_scope.var(n).set_value(fluid.LoDTensor(t))
    feeds = _wd_batches(WD_BITWISE_STEPS + WD_FALL_STEPS)
    seg, stats = [], {"captures": 0, "replays": 0, "islands": 0}
    for i in range(WD_BITWISE_STEPS):
        want = ("eager", "capture")[i] if i < 2 else "replay"
        seg.append(exe.run(main, feed=feeds[i], fetch_list=fetch,
                           scope=seg_scope))
        stats = _wd_gate_step(exe, stats, want, f"[wide_deep] step {i}")
    core.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        iexe = fluid.Executor(fluid.CUDAPlace(0))
        interp = [iexe.run(main, feed=feeds[i], fetch_list=fetch,
                           scope=int_scope)
                  for i in range(WD_BITWISE_STEPS)]
        if iexe._last_run_mode != "interpreted":
            raise AssertionError("the oracle did not run interpreted")
    finally:
        core.set_flag("FLAGS_executor_mode", "compiled")
    for i, (s, r) in enumerate(zip(seg, interp)):
        _bitwise(f"step {i} loss and AUC", s, r, tag="[wide_deep]")
    names = sorted(_persistables(int_scope, main))
    differ = [n for n in names if not torch.equal(
        seg_scope.find_var(n).value().array,
        int_scope.find_var(n).value().array)]
    _log(f"[wide_deep] {len(names)} persistables after {WD_BITWISE_STEPS} "
         "steps (parameters, Adam moments and beta powers, the AUC "
         "histograms), segmented vs interpreted on the card: " +
         (f"{len(differ)} differ: {differ[:5]}" if differ
          else "bitwise equal") + f" -> {'FAIL' if differ else 'ok'}")
    if differ:
        raise AssertionError("[wide_deep]: segmented and interpreted "
                             "state differ")
    del int_scope, iexe
    losses, aucs = [], []
    for f in feeds[WD_BITWISE_STEPS:]:
        lv, av = exe.run(main, feed=f, fetch_list=fetch, scope=seg_scope)
        losses.append(float(lv[0]))
        aucs.append(float(av[0]))
        stats = _wd_gate_step(exe, stats, "replay", "[wide_deep] falls")
    ok = losses[-1] < losses[0] and aucs[-1] > 0.5 \
        and all(np.isfinite(losses))
    _log(f"[wide_deep] {WD_FALL_STEPS} more steps on ctr_reader batches: "
         f"loss {losses[0]:.6f} -> {losses[-1]:.6f}, AUC {aucs[0]:.4f} -> "
         f"{aucs[-1]:.4f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[wide_deep]: the loss does not fall, or the "
                             "AUC ends at or under 0.5")
    torch.cuda.synchronize()
    return exe, seg_scope, main, fetch, feeds[0]


def _wd_card_against_cpu():
    """Wide&Deep at WD_CHECK_DIM ids a slot, WD_CHECK_STEPS steps on the
    card and by the port on the CPU from the card's startup values: each
    step's loss within LOSS_TOL relative, the first step's grads of three
    tables within GRAD_TOL of their largest, the last AUC within
    WD_AUC_TOL and the histograms' totals equal."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss, auc = _wd_program(WD_CHECK_DIM)
    names = ["deep_emb_0", "wide_emb_3", "deep_fc_w_0"]
    fetch = [loss, auc] + [n + "@GRAD" for n in names]
    feeds = _wd_batches(WD_CHECK_STEPS, WD_CHECK_DIM, SEED + 1)
    gpu, cpu, (exe, gscope), (cexe, cscope) = _card_and_cpu_step(
        main, startup, fetch, feeds[0])
    _loss_and_grads_agree("[wide_deep] step 0 at sparse_dim "
                          f"{WD_CHECK_DIM}", names,
                          [gpu[0]] + gpu[2:], [cpu[0]] + cpu[2:])
    for i, f in enumerate(feeds[1:], 1):
        g = exe.run(main, feed=f, fetch_list=[loss, auc], scope=gscope)
        c = cexe.run(main, feed=f, fetch_list=[loss, auc], scope=cscope)
        _loss_and_grads_agree(f"[wide_deep] step {i}", [], g, c)
    op = [o for o in main.global_block().ops if o.type == "auc"][0]
    hist = {}
    for tag, sc in (("card", gscope), ("cpu", cscope)):
        hist[tag] = [int(sc.find_var(op.input(s)[0]).value().array.sum())
                     for s in ("StatPos", "StatNeg")]
    err = abs(float(g[1][0]) - float(c[1][0]))
    ok = err <= WD_AUC_TOL and hist["card"] == hist["cpu"] \
        and exe._last_run_mode == cexe._last_run_mode == "segmented"
    _log(f"[wide_deep] AUC after {WD_CHECK_STEPS} steps, card vs CPU: "
         f"{float(g[1][0]):.6f} vs {float(c[1][0]):.6f} (tol {WD_AUC_TOL:g})"
         f"; histogram totals (positives, negatives) {hist['card']} vs "
         f"{hist['cpu']} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[wide_deep]: the card's AUC or histograms "
                             "disagree with the CPU run")
    exe.close()


def _wd_lane(profile):
    """bench's wide_deep lane (``python3 -m paddle_tpu_torch.bench
    wide_deep``): its JSON line; then WD_TIMED_STEPS more steps of the
    lane's program, each synchronized, for p50 and p90. Gates: the
    segmented path (``compiled_metric``), a timed window of 2 replays and
    1 island run a step, no hand-written kernel through the wrappers, in
    the graphs or in a profiler trace of one step."""
    import numpy as np
    import torch
    from paddle_tpu_torch import bench
    _reset_launch_counts()
    lane = bench.run_wide_deep()
    wrapper = _launch_counts()
    res = lane.res
    print(json.dumps(res), flush=True)
    steps = res["steps"]
    if not (np.isfinite(res["loss"]) and res["compiled_metric"] is True
            and res["executor_mode"] == "segmented"
            and res["timed_window"] == {"eager": 0, "captures": 0,
                                        "replays": 2 * steps,
                                        "islands": steps}):
        raise AssertionError(f"wide_deep lane: {res}")
    exe, cb = lane.exe, lane.exe._last_block
    if wrapper != NO_KERNELS or cb.stats["captures"] != 2 \
            or tuple(cb.graph_launches.get(k, 0) for k in KERNELS) \
            != NO_KERNELS:
        raise AssertionError(f"wide_deep lane: {wrapper} launches through "
                             f"the wrappers, {cb.stats}, "
                             f"{cb.graph_launches} in the graphs")

    def one_step():
        exe.run(lane.main, feed=lane.feed, fetch_list=lane.fetches,
                scope=lane.scope)
        if exe._last_block is not cb or cb.last_exec != "replay":
            raise AssertionError("the traced wide_deep step was not a "
                                 "replay of the lane's graphs")
    _check_trace(_device_kernel_counts(one_step), NO_KERNELS,
                 f"wide_deep lane batch {res['batch']} step")
    times = []
    s0 = dict(cb.stats)
    for _ in range(WD_TIMED_STEPS):
        t = time.perf_counter()
        exe.run(lane.main, feed=lane.feed, fetch_list=lane.fetches,
                scope=lane.scope, return_numpy=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    per = {k: (cb.stats[k] - s0[k]) / WD_TIMED_STEPS
           for k in ("captures", "replays", "islands")}
    ms = np.asarray(times) * 1e3
    _log(f"[wide_deep] lane: batch {res['batch']}, {res['value']} samples/s"
         f", {res['step_ms']} ms a step over the lane's {steps} steps; "
         f"{WD_TIMED_STEPS} steps each synchronized: p50 "
         f"{np.percentile(ms, 50):.3f} ms p90 {np.percentile(ms, 90):.3f} "
         f"ms; peak {res['peak_memory_gib']} GiB; AUC {res['auc']}; "
         f"captures {cb.stats['captures']}, {per['replays']:g} replays and "
         f"{per['islands']:g} island runs a step; {NO_KERNELS} "
         f"{GATE_NAMES} launches (wrappers, graphs, trace) -> ok "
         f"({_card_line()})")
    if per != {"captures": 0, "replays": 2, "islands": 1}:
        raise AssertionError(f"wide_deep lane: {per} a timed step")
    if profile:
        _profile_step(exe, lane.main, lane.fetches[0], lane.scope,
                      lane.feed, f"wide_deep lane batch {res['batch']}",
                      fetch=lane.fetches)
    lane.close()
    return res


def phase_wide_deep(profile=False):
    """Phase 13: Wide&Deep CTR training on the port (the docstring's phase
    13)."""
    import torch
    _reset_launch_counts()
    exe, scope, main, fetch, feed = _wd_segmented_vs_interpreted()
    wrapper = _launch_counts()
    if wrapper != NO_KERNELS:
        raise AssertionError(f"[wide_deep] {wrapper} launches through the "
                             "wrappers")
    _check_trace(_device_kernel_counts(
        lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope)),
        NO_KERNELS, "wide_deep step")
    exe.close()
    del exe, scope
    torch.cuda.empty_cache()
    _wd_card_against_cpu()
    _reset_launch_counts()
    res = _wd_lane(profile)
    return {"wrapper": _launch_counts(), "executed": NO_KERNELS,
            "wide_deep": res}


# --------------------------------------------------------------------------
# 14. predictor — save, load and serve through paddle_tpu_torch.inference
# --------------------------------------------------------------------------
PRED_WINDOW_S = 2.0           # seconds served per batch size, after warm-up
PRED_TOL = (1e-5, 1e-6)       # predictor vs the clone for test (rtol, atol)
PRED_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask", "mask_pos")
PRED_CENSUS = {"fc": 73, "fused_embedding_eltwise_layernorm": 1,
               "fused_attention_qkv": 12, "layer_norm": 24, "gelu": 12}
REF_BERT_TOL = {1: 1e-5, 12: 1e-4}  # fused vs unfused, rtol = atol, by depth
RESNET_PRED_BATCH = 8
RESNET_PRED_IMAGE = 224
RESNET_PRED_TOL = (1e-4, 1e-5)      # tests/test_ir_passes.py:566
RESNET_PRED_CENSUS = {"conv2d_fusion": 53, "relu": 49, "elementwise_add": 16,
                      "fc": 1, "pool2d": 2, "flatten2": 1, "softmax": 1}


class _Book:
    """The runs of a phase by kind ("eager", "capture", "replay", "train"
    or "reference", the last two eager), the kernel launches they executed
    on the card, and those that went through the wrappers (every run but
    a replay)."""

    def __init__(self):
        import collections
        self.runs = collections.Counter()
        self.executed = [0] * len(KERNELS)
        self.wrapped = [0] * len(KERNELS)

    def add(self, kind, want):
        self.runs[kind] += 1
        self.executed = [a + b for a, b in zip(self.executed, want)]
        if kind != "replay":
            self.wrapped = [a + b for a, b in zip(self.wrapped, want)]


def _census(program):
    import collections
    return dict(collections.Counter(
        op.type for op in program.global_block().ops))


def _mlm_targets(main):
    """The encoder output (what the MLM head gathers from) and the MLM
    logits (what the loss reads) of the pretraining program."""
    ops = main.global_block().ops
    sm = [o for o in ops if o.type == "softmax_with_cross_entropy"][0]
    gather = [o for o in ops if o.type == "gather"][0]
    return [gather.input("X")[0], sm.input("Logits")[0]]


def _pred_request(rng, bs, cfg):
    """A request of the served pretraining model: the encoder's feeds with
    random padding, and 15 % of the positions for the MLM head."""
    feed = _request(rng, bs, cfg)
    feed["mask_pos"] = rng.randint(0, bs * S, (max(1, int(bs * S * MLM_FRAC)),
                                               1))
    return feed


def _on_card(pred, what):
    """Every persistable of the predictor's rewritten program lies on the
    card before the first capture (the passes' new weights too)."""
    block = pred._program.global_block()
    off = [v.name for v in block.vars.values() if v.persistable
           and pred._scope.find_var(v.name) is not None
           and pred._scope.find_var(v.name).value().array.device.type
           != "cuda"]
    if off:
        raise AssertionError(f"{what}: persistables off the card: {off[:5]}")


def _serve_window(pred, pools, want, what, book):
    """Each batch size's warm-up (eager, capture, replay) and a window of
    replays, every run gated against ``want`` launches; → the first
    replayed (feed, outputs) of each batch size."""
    import numpy as np
    first = {}

    def request(feed, label):
        before = _launch_counts()
        t = time.perf_counter()
        outs = pred.run([feed[n] for n in pred.get_input_names()])
        dt = time.perf_counter() - t
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        book.add(_gate_run(pred._exe, delta, want, label), want)
        for o in outs:
            if not np.isfinite(o).all():
                raise AssertionError(f"{label}: non-finite outputs")
        return outs, dt

    for bs, pool in pools.items():
        for i in range(WARMUP):
            request(pool[i], f"{what} batch-{bs} warm-up request {i}")
        times = []
        while sum(times) < PRED_WINDOW_S:
            feed = pool[len(times) % POOL]
            outs, dt = request(feed, f"{what} batch-{bs} request")
            times.append(dt)
            first.setdefault(bs, (feed, outs))
        _latency_line(f"[predictor] {what} batch", bs, times)
    return first, request


def _compare(what, got, want, rtol, atol):
    import numpy as np
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    ok = all(np.allclose(g, w, rtol=rtol, atol=atol)
             for g, w in zip(got, want))
    _log(f"[predictor] {what}: " + ("bitwise equal" if same else
                                    f"max|d| {err:.3e}") +
         f" (rtol {rtol:g}, atol {atol:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: outputs disagree")
    return same, err


def _predictor_bert(tmp, book, profile=False):
    """(a): the port's BERT-base pretraining program, one Adam step, saved
    with the encoder output and the MLM logits, served by
    create_predictor(Config(dir)) on the card."""
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    L = cfg["layers"]
    want = tuple(L if k == "flash_attention_fwd_f32" else 0 for k in KERNELS)
    main, startup, loss = _pretrain_program(cfg, 0.0)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    rng = np.random.RandomState(SEED)
    exe.run(startup, scope=scope)
    step_want = _step_want(main.global_block().ops, "f32")
    before = _launch_counts()
    exe.run(main, feed=_train_batch(rng, 8, cfg), fetch_list=[loss],
            scope=scope)
    delta = tuple(a - b for a, b in zip(_launch_counts(), before))
    if _gate_run(exe, delta, step_want, "(a) the Adam step") != "eager":
        raise AssertionError("(a) the Adam step did not run eager")
    book.add("train", step_want)
    targets = _mlm_targets(main)
    d = os.path.join(tmp, "bert")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, list(PRED_FEEDS), targets, exe, main)
    n_files = len(os.listdir(d))
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    t1 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(d))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    census = _census(pred._program)
    _log(f"[predictor] (a) BERT-base saved in {t1 - t0:.2f} s ({n_files} "
         f"files, {size / 2**30:.3f} GiB), loaded and rewritten in "
         f"{t2 - t1:.2f} s: {len(pred._program.global_block().ops)} ops "
         f"{census}")
    if any(census.get(k) != v for k, v in PRED_CENSUS.items()):
        raise AssertionError(f"(a) census {census}, want {PRED_CENSUS}")
    if pred.get_output_names() != targets:
        raise AssertionError(f"(a) outputs {pred.get_output_names()}")
    _on_card(pred, "(a)")
    pools = {bs: [_pred_request(rng, bs, cfg) for _ in range(POOL)]
             for bs in SERVE_BATCHES}
    first, request = _serve_window(pred, pools, want, "(a)", book)
    mid = SERVE_BATCHES[len(SERVE_BATCHES) // 2]
    _check_trace(_device_kernel_counts(
        lambda: request(pools[mid][1], "(a) a traced request")), want,
        f"(a) predictor batch-{mid} request")
    # the clone for test on the training scope, pruned by the executor
    test_prog = main.clone(for_test=True)
    for bs in SERVE_BATCHES:
        feed, outs = first[bs]
        ref = exe.run(test_prog, feed={n: feed[n] for n in PRED_FEEDS},
                      fetch_list=targets, scope=scope, use_prune=True)
        book.add("reference", want)
        _compare(f"(a) batch-{bs} request vs exe.run(main.clone(for_test="
                 f"True), use_prune=True)", outs, ref, *PRED_TOL)
    # a clone shares the scope: no second copy of the weights
    ptrs = {n: pred._scope.find_var(n).value().array.data_ptr()
            for n in (v.name for v in pred._program.list_vars()
                      if v.persistable and v.name not in ("feed", "fetch"))}
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    twin = pred.clone()
    m1 = torch.cuda.memory_allocated()
    if twin._scope is not pred._scope or m1 != m0:
        raise AssertionError(f"(a) clone: scope shared "
                             f"{twin._scope is pred._scope}, "
                             f"{m1 - m0} bytes allocated by clone()")
    got = None
    for i in range(3):  # its own executor: eager, capture, replay
        before = _launch_counts()
        got = twin.run([first[mid][0][n] for n in twin.get_input_names()])
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        book.add(_gate_run(twin._exe, delta, want, f"(a) clone run {i}"),
                 want)
    same, _ = _compare(f"(a) clone vs predictor, batch {mid}", got,
                       first[mid][1], 0.0, 0.0)
    if not same or any(pred._scope.find_var(n).value().array.data_ptr() != p
                       for n, p in ptrs.items()):
        raise AssertionError("(a) the clone's answer or weights differ")
    torch.cuda.synchronize()
    _log(f"[predictor] (a) clone(): {m1 - m0} bytes on the card, the same "
         f"scope and weight tensors ({len(ptrs)}); its graphs and buffers "
         f"after 3 runs {(torch.cuda.memory_allocated() - m1) / 2**20:.1f} "
         f"MiB; answers bitwise")
    if profile:  # a request's device time, by kernel, and its idle share
        _log("[predictor] (a) profiled requests (Executor.run of the "
             "rewritten program, both targets fetched):")
        for bs in SERVE_BATCHES:
            _profile(pred._exe, pred._program, pred.get_output_names(),
                     pred._scope, {n: pools[bs][0][n] for n in PRED_FEEDS},
                     bs)
    exe.close()
    twin._exe.close()
    pred._exe.close()


def _ref_bert_program(cfg, layers):
    """A reference-style BERT encoder: the embeddings, then each layer's
    attention decomposed as a reference-serialized program carries it
    (tests/test_ir_passes.py:572-593: the Q, K and V projections as fc,
    reshape2, transpose2; the Q scale; QKᵀ by matmul; + BiasQK, the
    [B, 1, 1, S] key-padding bias; softmax; PV; the head merge), the
    output projection, residual and layer norm, and the FFN."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers as L
    from paddle_tpu_torch.models import bert
    H, N = cfg["heads"], cfg["hidden"]
    D = N // H
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data("src_ids", [S], dtype="int64")
        pos = fluid.data("pos_ids", [S], dtype="int64")
        sent = fluid.data("sent_ids", [S], dtype="int64")
        mask = fluid.data("input_mask", [S], dtype="float32")
        bias_qk = bert.padding_attn_bias(mask)
        x = bert.bert_embedding(src, pos, sent, cfg)
        for i in range(layers):
            def proj(tag):
                p = L.fc(x, H * D, num_flatten_dims=2,
                         param_attr=fluid.ParamAttr(name=f"l{i}_{tag}_w"),
                         bias_attr=fluid.ParamAttr(name=f"l{i}_{tag}_b"))
                return L.transpose(L.reshape(p, [0, 0, H, D]), [0, 2, 1, 3])
            q, k, v = proj("q"), proj("k"), proj("v")
            qk = L.matmul(L.scale(q, scale=float(1.0 / np.sqrt(D))), k,
                          transpose_y=True)
            attn = L.softmax(L.elementwise_add(qk, bias_qk))
            ctx = L.reshape(L.transpose(L.matmul(attn, v), [0, 2, 1, 3]),
                            [0, 0, H * D])
            x = L.layer_norm(L.elementwise_add(
                x, L.fc(ctx, N, num_flatten_dims=2)), begin_norm_axis=2)
            h = L.fc(x, cfg["ffn"], num_flatten_dims=2, act="gelu")
            x = L.layer_norm(L.elementwise_add(
                x, L.fc(h, N, num_flatten_dims=2)), begin_norm_axis=2)
    startup.random_seed = SEED
    return main, startup, x


def _predictor_ref_bert(tmp, book):
    """(b): the reference-style BERT, saved and loaded;
    multihead_matmul_fuse_pass_v2 fuses every attention subgraph, and the
    fused multihead_matmul runs the f32 forward kernel."""
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    feeds = [n for n in PRED_FEEDS if n != "mask_pos"]
    rng = np.random.RandomState(SEED + 1)
    for layers in (cfg["layers"], 1):
        want = tuple(layers if k == "flash_attention_fwd_f32" else 0
                     for k in KERNELS)
        main, startup, out = _ref_bert_program(cfg, layers)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        d = os.path.join(tmp, f"ref_bert_{layers}")
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, feeds, [out], exe, main)
        exe.close()
        del exe, scope
        pred = inference.create_predictor(inference.Config(d))
        census = _census(pred._program)
        unfused_cfg = inference.Config(d)
        unfused_cfg.switch_ir_optim(False)
        plain = inference.create_predictor(unfused_cfg)
        pcensus = _census(plain._program)
        _log(f"[predictor] (b) reference-style BERT, {layers} layer(s): "
             f"{pcensus.get('matmul', 0)} matmul, {pcensus.get('softmax', 0)}"
             f" softmax, {pcensus.get('transpose2', 0)} transpose2 saved; "
             f"after the passes {census}")
        if census.get("multihead_matmul") != layers \
                or any(t in census for t in ("matmul", "softmax",
                                             "transpose2")):
            raise AssertionError(f"(b) {layers} layer(s): census {census}")
        _on_card(pred, "(b)")
        batches = SERVE_BATCHES if layers > 1 \
            else SERVE_BATCHES[len(SERVE_BATCHES) // 2:][:1]
        pools = {bs: [_request(rng, bs, cfg) for _ in range(POOL)]
                 for bs in batches}
        tol = REF_BERT_TOL[layers]
        if layers > 1:
            first, request = _serve_window(pred, pools, want, "(b) fused",
                                           book)
            mid = SERVE_BATCHES[len(SERVE_BATCHES) // 2]
            _check_trace(_device_kernel_counts(
                lambda: request(pools[mid][1], "(b) a traced request")),
                want, f"(b) predictor batch-{mid} request")
        else:
            first, _ = _serve_window(pred, pools, want, "(b) 1 layer", book)
        # the same directory with switch_ir_optim(False): no kernel
        for bs, (feed, outs) in first.items():
            for i in range(3):
                before = _launch_counts()
                got = plain.run([feed[n] for n in plain.get_input_names()])
                delta = tuple(a - b for a, b in zip(_launch_counts(), before))
                book.add(_gate_run(plain._exe, delta, NO_KERNELS,
                                   f"(b) unfused batch-{bs} run {i}"),
                         NO_KERNELS)
            _compare(f"(b) {layers} layer(s) batch {bs}, fused vs unfused",
                     outs, got, tol, tol)
        pred._exe.close()
        plain._exe.close()
        del pred, plain
        torch.cuda.empty_cache()


def _predictor_resnet(tmp, book):
    """(c): ResNet-50 (224x224, 1000 classes) saved with the logits that
    feed softmax and the softmax; the conv folds turn every conv2d +
    batch_norm into conv2d_fusion; batch 8."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.models import resnet
    with fluid.unique_name.guard():
        main, startup, _, _ = resnet.build_resnet_train_program(
            image_size=RESNET_PRED_IMAGE)
    startup.random_seed = SEED
    sm = [o for o in main.global_block().ops if o.type == "softmax"][-1]
    targets = [sm.input("X")[0], sm.output("Out")[0]]
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    d = os.path.join(tmp, "resnet50")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["image"], targets, exe, main)
    pred = inference.create_predictor(inference.Config(d))
    census = _census(pred._program)
    _log(f"[predictor] (c) ResNet-50: after the passes {census}")
    if census != RESNET_PRED_CENSUS:
        raise AssertionError(f"(c) census {census}, want {RESNET_PRED_CENSUS}")
    _on_card(pred, "(c)")
    rng = np.random.RandomState(SEED + 2)
    pools = {RESNET_PRED_BATCH: [
        {"image": rng.rand(RESNET_PRED_BATCH, 3, RESNET_PRED_IMAGE,
                           RESNET_PRED_IMAGE).astype(np.float32)}
        for _ in range(POOL)]}
    first, request = _serve_window(pred, pools, NO_KERNELS, "(c)", book)
    _check_trace(_device_kernel_counts(
        lambda: request(pools[RESNET_PRED_BATCH][1], "(c) a traced request")),
        NO_KERNELS, f"(c) predictor batch-{RESNET_PRED_BATCH} request")
    feed, outs = first[RESNET_PRED_BATCH]
    ref = exe.run(main.clone(for_test=True), feed=feed, fetch_list=targets,
                  scope=scope, use_prune=True)
    book.add("reference", NO_KERNELS)
    # the folds round differently from conv + batch_norm, and at init the
    # logits grow to hundreds (running statistics 0 and 1 normalize
    # nothing): an element far below the largest can miss the elementwise
    # bound by that rounding alone, as the TPU package's fold does (CPU,
    # ResNet-50 at 32x32: max|d| 4.1e-4 at a largest logit of 188). Both
    # are reported; the gate holds the bound to the largest logit.
    rtol, atol = RESNET_PRED_TOL
    for what, got, want in (("logits", outs[0], ref[0]),
                            ("softmax", outs[1], ref[1])):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        elementwise = bool(np.allclose(got, want, rtol=rtol, atol=atol))
        ok = err <= rtol * scale + atol
        _log(f"[predictor] (c) batch-{RESNET_PRED_BATCH} {what} vs exe.run("
             f"main.clone(for_test=True), use_prune=True): max|d| "
             f"{err:.3e} of max {scale:.3e}; elementwise at rtol {rtol:g} "
             f"atol {atol:g}: {'within' if elementwise else 'not within'}; "
             f"of the largest: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(c) {what} disagree with the clone")
    exe.close()
    pred._exe.close()


def phase_predictor(profile=False):
    """Phase 14: save, load and serve through the inference predictor (the
    docstring's phase 14). → the launches of its runs: through the
    wrappers (warm-ups and captures) and on the card (every run)."""
    import shutil
    import tempfile
    import torch
    book = _Book()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predictor_")
    try:
        _reset_launch_counts()
        _predictor_bert(tmp, book, profile)
        _predictor_ref_bert(tmp, book)
        _predictor_resnet(tmp, book)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wrapper = _launch_counts()
    torch.cuda.empty_cache()
    _log(f"[predictor] runs {dict(book.runs)}; launches through the "
         f"wrappers {GATE_NAMES} {wrapper}, on the card "
         f"{tuple(book.executed)}")
    if wrapper != tuple(book.wrapped):
        raise AssertionError(f"[predictor] the wrappers launched {wrapper}, "
                             f"the runs account for {tuple(book.wrapped)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed),
            "runs": dict(book.runs)}


# --------------------------------------------------------------------------
# 15. resume — checkpoints, kill and resume, the guard's rollback
# --------------------------------------------------------------------------
RESUME_STEPS = 12             # steps of the oracle; the resumed runs end there
RESUME_BATCHES = 16           # distinct batches: the loader reads past 12
RESUME_EVERY = 4              # the victim's checkpoints, per step
RESUME_PAST = 2               # steps the victim takes past its last one
RESUME_K = 4                  # windows of DataLoader.window(4)
RESUME_WINDOW_EVERY = 8       # the windowed victim's checkpoints: windows
                              # of 4 cross a boundary of 4 at every window
ROLLBACK_EVERY = 2            # checkpoints under the guard's rollback
ROLLBACK_TOLERANCE = 2        # tripped steps in a row before a restore
ROLLBACK_POISONED = (5, 6)    # steps whose input mask is NaN, once: one
                              # key's, then every key's
WD_RESUME_DIM = int(1e5)      # Wide&Deep ids a slot (bench.py's 1e6): one
                              # checkpoint of 26 tables with Adam's moments
                              # stays near 0.53 GB


class _Resume:
    """What phase 15's runs launched and how long its steps took."""

    def __init__(self):
        import collections
        self.runs = collections.Counter()
        self.executed = [0] * len(KERNELS)
        self.times = {}

    def step(self, exe, main, feed, fetch, scope, want, what, tag=None,
             finite=True):
        """One compiled run of a single step or a window (a WindowBatch
        sets n_steps), gated on its kernel launches. → its fetches."""
        import numpy as np
        before = _launch_counts()
        stats0 = {id(cb): dict(cb.stats)
                  for cb in exe._compiled_cache.values()}
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        dt = time.perf_counter() - t
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        k = getattr(feed, "k", 1)
        if k == 1:
            self.runs[_gate_run(exe, delta, want, what)] += 1
        else:
            _gate_window(exe, delta, stats0.get(id(exe._last_block), {}),
                         k, want, what)
            self.runs["window"] += 1
        for i, w in enumerate(want):
            self.executed[i] += k * w
        if tag is not None:
            self.times.setdefault(tag, []).append(dt)
        if finite and not all(np.isfinite(o).all() for o in out):
            raise AssertionError(f"{what}: a non-finite fetch")
        return out


def _gate_window(exe, delta, s0, k, want, what):
    """A compiled window of ``k`` steps: its eager step and capture went
    through the wrappers, every other step replayed the graph, which
    recorded ``want``."""
    if exe._last_run_mode != "compiled":
        raise AssertionError(f"{what} ran {exe._last_run_mode}")
    cb = exe._last_block
    d = {n: cb.stats[n] - s0.get(n, 0) for n in ("eager", "captures",
                                                  "replays")}
    graph = tuple(cb.graph_launches.get(n, 0) for n in KERNELS)
    if d["eager"] + d["replays"] != k or graph != want or delta != tuple(
            (d["eager"] + d["captures"]) * w for w in want):
        raise AssertionError(
            f"{what}: {d} over a window of {k}, {delta} launches through "
            f"the wrappers, {graph} in the graph; want {want} a step")


def _resume_loader(batches):
    from paddle_tpu_torch import fluid
    ldr = fluid.DataLoader.from_generator(capacity=4)
    ldr.set_batch_generator(lambda: iter(batches), places=fluid.CUDAPlace(0))
    return ldr


def _fresh(main, startup):
    from paddle_tpu_torch import fluid
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _host_steps(scope):
    from paddle_tpu_torch import fluid
    return fluid.Executor._rng_counters[scope]


def _drop(exe):
    """The kill: the executor with its graphs goes, the card's memory is
    returned."""
    import gc
    import torch
    exe.close()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _same_state(what, got, want, tag="[resume]"):
    """Two {name: tensor} maps of persistables equal bit for bit."""
    import torch
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: persistables {sorted(got)[:4]} .. "
                             f"against {sorted(want)[:4]} ..")
    differ = [n for n in want if not torch.equal(got[n], want[n])]
    _log(f"{tag} {what}: {len(want)} persistables " +
         (f"{len(differ)} differ: {differ[:5]}" if differ
          else "bitwise equal") + f" -> {'FAIL' if differ else 'ok'}")
    if differ:
        raise AssertionError(f"{what}: persistables differ")


def _ckpt_bytes(path):
    import os
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def _bert_resume(book, root, main, startup, loss, batches, oracle,
                 oracle_state):
    """(b): a victim checkpointing every RESUME_EVERY steps through
    set_auto_checkpoint, dropped RESUME_PAST steps past its last
    checkpoint; a fresh executor, scope and loader resume_from() it and
    go on to RESUME_STEPS. → the seconds of the victim's steps that
    saved."""
    import os
    from paddle_tpu_torch import fluid
    want = TRAIN_STEP_WANT
    ck = os.path.join(root, "per_step")
    exe, scope = _fresh(main, startup)
    ldr = _resume_loader(batches)
    exe.set_auto_checkpoint(ck, every_n_steps=RESUME_EVERY, program=main,
                            scope=scope, dataloader=ldr)
    last = (RESUME_STEPS // RESUME_EVERY - 1) * RESUME_EVERY
    kill_at = last + RESUME_PAST
    victim, saving = [], []
    for b in ldr:
        (lv,) = book.step(exe, main, b, [loss], scope, want,
                          "[resume] victim step", tag="with")
        victim.append(float(lv.reshape(-1)[0]))
        if _host_steps(scope) % RESUME_EVERY == 0:  # this run saved
            saving.append(book.times["with"][-1])
        if _host_steps(scope) >= kill_at:
            break
    _bitwise("victim vs oracle: losses", [victim], [oracle[:len(victim)]],
             tag="[resume]")
    kept = sorted(os.listdir(ck))
    _log(f"[resume] victim: {len(victim)} steps, checkpoints {kept}, "
         f"dropped {RESUME_PAST} steps past the last without a save")
    _drop(exe)
    del exe, scope, ldr
    exe, scope = _fresh(main, startup)
    ldr = _resume_loader(batches)
    manifest = exe.resume_from(ck, program=main, scope=scope,
                               dataloader=ldr)
    start = manifest["global_step"] - 1
    if manifest["global_step"] != last or manifest["dataloader"] != {
            "epoch": 0, "position": start} or _host_steps(scope) != last:
        raise AssertionError(f"[resume] manifest {manifest['global_step']}"
                             f" {manifest['dataloader']}")
    resumed = []
    for b in ldr:
        (lv,) = book.step(exe, main, b, [loss], scope, want,
                          "[resume] resumed step")
        resumed.append(float(lv.reshape(-1)[0]))
        if _host_steps(scope) > RESUME_STEPS:
            break
    _bitwise(f"resumed at step {start} vs oracle steps {start}.."
             f"{RESUME_STEPS - 1}: losses", [resumed], [oracle[start:]],
             tag="[resume]")
    _same_state("after the resumed run vs the oracle",
                _persistables(scope, main), oracle_state)
    # the plane's own costs, on the resumed run's final state
    t0 = time.perf_counter()
    path = fluid.save_checkpoint(exe, os.path.join(root, "timed"), main,
                                 scope=scope, global_step=99)
    t1 = time.perf_counter()
    m = fluid.validate_checkpoint(path)
    t2 = time.perf_counter()
    fluid.load_checkpoint(exe, path, main, scope=scope)
    import torch
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nbytes = _ckpt_bytes(path)
    _log(f"[resume] BERT-base checkpoint: {len(m['files'])} files, "
         f"{nbytes} bytes ({nbytes / 2**30:.3f} GiB); save "
         f"{t1 - t0:.3f} s, validate {t2 - t1:.3f} s, load "
         f"{t3 - t2:.3f} s ({_card_line()})")
    _drop(exe)
    return saving, nbytes


def _bert_window_resume(book, root, main, startup, loss, batches, oracle,
                        oracle_state):
    """(c): the same kill and resume fed by window(RESUME_K) with the
    default prefetch, one run(n_steps=RESUME_K) a window."""
    import os
    want = TRAIN_STEP_WANT
    ck = os.path.join(root, "window")
    exe, scope = _fresh(main, startup)
    ldr = _resume_loader(batches)
    exe.set_auto_checkpoint(ck, every_n_steps=RESUME_WINDOW_EVERY,
                            program=main, scope=scope, dataloader=ldr)
    victim = []
    for w in ldr.window(RESUME_K):
        (lv,) = book.step(exe, main, w, [loss], scope, want,
                          "[resume] victim window")
        victim.extend(float(x) for x in lv.reshape(-1))
        if len(victim) >= RESUME_STEPS:
            break
    _bitwise("windowed victim vs oracle: losses", [victim], [oracle],
             tag="[resume]")
    kept = sorted(os.listdir(ck))
    position = ldr.state_dict()["position"]
    _log(f"[resume] windowed victim: {len(victim)} steps in windows of "
         f"{RESUME_K}, checkpoints {kept}, loader at {position} handed out "
         "when dropped")
    _drop(exe)
    del exe, scope, ldr
    exe, scope = _fresh(main, startup)
    ldr = _resume_loader(batches)
    manifest = exe.resume_from(ck, program=main, scope=scope,
                               dataloader=ldr)
    start = manifest["global_step"] - 1
    if manifest["dataloader"] != {"epoch": 0, "position": start} \
            or start % RESUME_K:
        raise AssertionError(f"[resume] windowed manifest "
                             f"{manifest['global_step']} "
                             f"{manifest['dataloader']}")
    resumed = []
    for w in ldr.window(RESUME_K):
        (lv,) = book.step(exe, main, w, [loss], scope, want,
                          "[resume] resumed window")
        resumed.extend(float(x) for x in lv.reshape(-1))
        if start + len(resumed) >= RESUME_STEPS:
            break
    _bitwise(f"windows resumed at step {start} vs oracle: losses",
             [resumed], [oracle[start:]], tag="[resume]")
    _same_state("after the resumed windows vs the oracle",
                _persistables(scope, main), oracle_state)
    _drop(exe)


def _bert_rollback(book, root, main, startup, loss, batches, oracle,
                   oracle_state):
    """(d): FLAGS_check_nan_inf with the rollback action, tolerance
    ROLLBACK_TOLERANCE, a checkpoint every ROLLBACK_EVERY steps, the
    input mask NaN at ROLLBACK_POISONED once; the monitor restores the
    last checkpoint and the loader's position, the loop rewinds
    (tests/test_numeric_faults.py:310-370) and replays."""
    import os
    import numpy as np
    from paddle_tpu_torch.fluid import core
    want = TRAIN_STEP_WANT
    flags = {"FLAGS_check_nan_inf": True, "FLAGS_nan_inf_action": "rollback",
             "FLAGS_nan_inf_tolerance": ROLLBACK_TOLERANCE}
    saved = {n: core.globals_[n] for n in flags}
    for n, v in flags.items():
        core.set_flag(n, v)
    try:
        exe, scope = _fresh(main, startup)
        ldr = _resume_loader(batches)
        ck = os.path.join(root, "rollback")
        exe.set_auto_checkpoint(ck, every_n_steps=ROLLBACK_EVERY,
                                program=main, scope=scope, dataloader=ldr)
        base = _host_steps(scope)
        got = [None] * RESUME_STEPS
        poisoned = set(ROLLBACK_POISONED)
        it, i, seen, captures, after = iter(ldr), 0, 0, None, []
        while i < RESUME_STEPS:
            feed = next(it)
            bad = i in poisoned
            if bad:  # one key's mask at the first, every key's at the next
                mask = feed["input_mask"].copy()
                if i == ROLLBACK_POISONED[0]:
                    mask[0, 0] = np.nan
                else:
                    mask[:] = np.nan
                feed = dict(feed, input_mask=mask)
            (lv,) = book.step(exe, main, feed, [loss], scope, want,
                              f"[resume] rollback step {i}", finite=not bad)
            cb = exe._last_block
            if captures is not None:
                after.append(cb.last_exec)
            mon = exe._health_monitor
            if mon is not None and mon.rollbacks > seen:
                seen = mon.rollbacks
                i = mon.last_manifest["global_step"] - base
                if ldr.state_dict() != {"epoch": 0, "position": i}:
                    raise AssertionError(f"[resume] the loader after the "
                                         f"rollback: {ldr.state_dict()}")
                poisoned, it = set(), iter(ldr)
                captures = cb.stats["captures"]
                continue
            got[i] = float(lv.reshape(-1)[0])
            i += 1
        mon = exe._health_monitor
        stats = exe.health_stats()
        if mon is None or (mon.rollbacks, mon.trips) != (1, 2):
            raise AssertionError(f"[resume] rollbacks, trips: "
                                 f"{(mon.rollbacks, mon.trips) if mon else None}")
        new = cb.stats["captures"] - captures
        if new or set(after) != {"replay"}:
            raise AssertionError(f"[resume] after the restore: {new} "
                                 f"captures, runs {after}")
        _log(f"[resume] rollback: steps {list(ROLLBACK_POISONED)} "
             f"poisoned (input mask NaN at one key, then at every key), "
             f"{mon.trips} trips, "
             f"{mon.rollbacks} rollback to global step "
             f"{mon.last_manifest['global_step']} (loader position "
             f"{mon.last_manifest['dataloader']['position']}); "
             f"{len(after)} steps after the restore, all replays, no "
             f"capture; guard stats {stats}")
        _bitwise("rollback replay vs oracle: losses", [got], [oracle],
                 tag="[resume]")
        _same_state("after the rollback run vs the oracle",
                    _persistables(scope, main), oracle_state)
        _drop(exe)
    finally:
        for n, v in saved.items():
            core.set_flag(n, v)


def _wd_resume(book, root):
    """(e): Wide&Deep with its auc island, segmented, at WD_RESUME_DIM
    ids a slot: the same kill and resume per step; the final AUC, the auc
    op's state and every persistable bitwise the oracle's."""
    import os
    main, startup, loss, auc = _wd_program(WD_RESUME_DIM)
    fetch = [loss, auc]
    batches = _wd_batches(RESUME_BATCHES, WD_RESUME_DIM, SEED + 15)
    op = [o for o in main.global_block().ops if o.type == "auc"][0]
    stat_names = [op.input(s)[0] for s in ("StatPos", "StatNeg")]

    def steps(exe, scope, ldr, what, until):
        out = []
        for b in ldr:
            before = _launch_counts()
            r = exe.run(main, feed=b, fetch_list=fetch, scope=scope)
            delta = tuple(a - c for a, c in zip(_launch_counts(), before))
            if exe._last_run_mode != "segmented" or delta != NO_KERNELS:
                raise AssertionError(f"[resume] {what}: ran "
                                     f"{exe._last_run_mode}, {delta}")
            book.runs["wide_deep " + exe._last_block.last_exec] += 1
            out.append((float(r[0][0]), float(r[1][0])))
            if _host_steps(scope) >= until:
                break
        return out

    exe, scope = _fresh(main, startup)
    oracle = steps(exe, scope, _resume_loader(batches), "oracle",
                   RESUME_STEPS + 1)
    want = _persistables(scope, main)
    _drop(exe)
    ck = os.path.join(root, "wide_deep")
    exe, scope = _fresh(main, startup)
    ldr = _resume_loader(batches)
    exe.set_auto_checkpoint(ck, every_n_steps=RESUME_EVERY, program=main,
                            scope=scope, dataloader=ldr)
    last = (RESUME_STEPS // RESUME_EVERY - 1) * RESUME_EVERY
    victim = steps(exe, scope, ldr, "victim", last + RESUME_PAST)
    _bitwise("Wide&Deep victim vs oracle: losses and AUCs", [victim],
             [oracle[:len(victim)]], tag="[resume]")
    _drop(exe)
    del exe, scope, ldr
    exe, scope = _fresh(main, startup)
    ldr = _resume_loader(batches)
    manifest = exe.resume_from(ck, program=main, scope=scope,
                               dataloader=ldr)
    start = manifest["global_step"] - 1
    resumed = steps(exe, scope, ldr, "resumed", RESUME_STEPS + 1)
    _bitwise(f"Wide&Deep resumed at step {start} vs oracle: losses and "
             "AUCs", [resumed], [oracle[start:]], tag="[resume]")
    got = _persistables(scope, main)
    _same_state("Wide&Deep after the resumed run vs the oracle (the auc "
                f"state {stat_names} among them)", got, want)
    nbytes = _ckpt_bytes(os.path.join(ck, f"ckpt-{last}"))
    stats = exe._last_block.stats
    _log(f"[resume] Wide&Deep segmented (auc island), tables cut to "
         f"{WD_RESUME_DIM} ids a slot (bench.py: 1000000): final AUC "
         f"{resumed[-1][1]!r} = oracle's {oracle[-1][1]!r}; positives "
         f"{int(got[stat_names[0]].sum())}; a "
         f"checkpoint {nbytes} bytes ({nbytes / 2**30:.3f} GiB); resumed "
         f"block {stats} ({_card_line()})")
    _drop(exe)


def phase_resume():
    """Phase 15: fault-tolerant BERT-base training (the docstring's phase
    15). → the launches of its runs: through the wrappers (warm-ups and
    captures) and on the card (every step)."""
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    want = _step_want(main.global_block().ops, _attention_route(main))
    if want != TRAIN_STEP_WANT:
        raise AssertionError(f"[resume] want {want} launches a step, not "
                             f"{TRAIN_STEP_WANT}")
    rng = np.random.RandomState(SEED + 15)
    batches = [_train_batch(rng, TRAIN_BATCH, cfg)
               for _ in range(RESUME_BATCHES)]
    book = _Resume()
    _reset_launch_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        # (a) the oracle: RESUME_STEPS steps, unbroken, no checkpoint
        exe, scope = _fresh(main, startup)
        oracle = []
        for b in _resume_loader(batches):
            (lv,) = book.step(exe, main, b, [loss], scope, want,
                              "[resume] oracle step", tag="without")
            oracle.append(float(lv.reshape(-1)[0]))
            if len(oracle) == RESUME_STEPS:
                break
        oracle_state = _persistables(scope, main)
        _drop(exe)
        del exe, scope
        _log(f"[resume] BERT-base f32, dropout {TRAIN_DROPOUT}, input mask, "
             f"Adam, batch {TRAIN_BATCH}, S = {S}: oracle losses " +
             " ".join(f"{x:.6f}" for x in oracle))
        saving, nbytes = _bert_resume(book, root, main, startup, loss,
                                      batches, oracle, oracle_state)
        _bert_window_resume(book, root, main, startup, loss, batches,
                            oracle, oracle_state)
        _bert_rollback(book, root, main, startup, loss, batches, oracle,
                       oracle_state)
        del oracle_state
        _wd_resume(book, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # steps 2.. of the oracle and of the victim are replays; the victim's
    # saved at each boundary of RESUME_EVERY
    wo = np.asarray(book.times["without"][2:]) * 1e3
    wi = np.asarray(book.times["with"][2:]) * 1e3
    share = (wi.mean() - wo.mean()) / wi.mean()
    _log(f"[resume] step p50 without auto-checkpointing "
         f"{np.percentile(wo, 50):.3f} ms (mean {wo.mean():.3f}, n = "
         f"{len(wo)}), with every_n_steps={RESUME_EVERY} "
         f"{np.percentile(wi, 50):.3f} ms (mean {wi.mean():.3f}, n = "
         f"{len(wi)}); the steps that saved {nbytes / 2**30:.3f} GiB: " +
         " ".join(f"{s * 1e3:.1f}" for s in saving) +
         f" ms; auto-checkpointing's share of the mean step "
         f"{share * 100:.1f} % ({_card_line()})")
    wrapper = _launch_counts()
    _log(f"[resume] runs {dict(book.runs)}; launches through the wrappers "
         f"{GATE_NAMES} {wrapper}, on the card {tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed),
            "runs": dict(book.runs)}


# --------------------------------------------------------------------------
# phase 16: control flow and the LR schedules
# --------------------------------------------------------------------------
CF_STEPS = 12                 # (a)'s steps: warm-up 4, decay to step 12
CF_PEAK = 1e-4                # BERT's peak LR (Devlin et al. 2019, §A.2)
CF_WARMUP = 4                 # BERT's 10,000 warm-up steps, compressed
CF_WINDOW = (2, 6)            # the window's steps: across the warm-up end
CF_LR_RTOL = 1e-6             # card LR vs the CPU port's: rtol, and atol
CF_TIMED = 20                 # (a)'s replays timed back to back after it
CF_LOOP_TRIPS = 12            # (b): the shared layer applied 12 times
CF_LOOP_BATCH = 8             # (b): the serve phase's batch 8
CF_LOOP_RUNS = 20             # (b) and its straight line: runs timed
CF_TAG = "[control_flow]"
CF_LOOP_WANT = (0, 0, 0, 0, 0, 0, 0, 0, 0, CF_LOOP_TRIPS, 0, 0)
CF_LOOP_DROP_WANT = (0, 0, 0, 0, 3 * CF_LOOP_TRIPS, 0, 0, 0, 0,
                     CF_LOOP_TRIPS, 0, 0)


def _cf_schedule(layers, peak=CF_PEAK, horizon=CF_STEPS):
    """BERT's schedule at ``peak``: linear warm-up over CF_WARMUP steps,
    then linear decay to 0 at step ``horizon``."""
    return layers.linear_lr_warmup(
        layers.polynomial_decay(peak, decay_steps=horizon,
                                end_learning_rate=0.0, power=1.0),
        warmup_steps=CF_WARMUP, start_lr=0.0, end_lr=peak)


def _cf_adam(fluid, loss):
    lr = _cf_schedule(fluid.layers)
    fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return lr


def _cf_pretrain_program(cfg, dropout, optimize=_cf_adam):
    """The train phase's step (build_bert_pretrain_program's pieces: f32,
    input mask) with ``optimize(fluid, loss)``, which appends the update
    and returns the LR var: by default Adam under BERT's schedule, given
    the scheduled LR inside the program guard as a reference script
    does."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data("src_ids", shape=[S], dtype="int64")
        pos = fluid.data("pos_ids", shape=[S], dtype="int64")
        sent = fluid.data("sent_ids", shape=[S], dtype="int64")
        mask_pos = fluid.data("mask_pos", shape=[1], dtype="int64")
        mask_label = fluid.data("mask_label", shape=[1], dtype="int64")
        input_mask = fluid.data("input_mask", shape=[S], dtype="float32")
        bias = bert.padding_attn_bias(input_mask)
        x = bert.bert_embedding(src, pos, sent, cfg, dropout)
        enc = bert.encoder(x, cfg["layers"], cfg["hidden"], cfg["heads"],
                           cfg["ffn"], dropout, attn_bias=bias)
        picked = L.gather(L.reshape(enc, [-1, cfg["hidden"]]), mask_pos)
        loss = L.mean(L.softmax_with_cross_entropy(
            L.fc(picked, cfg["vocab_size"]), mask_label))
        lr = optimize(fluid, loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, loss, lr


def _cpu_lrs(schedule, runs):
    """A schedule's LR over ``runs`` runs of the port on the CPU."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        lr = schedule(fluid.layers)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    return np.asarray([exe.run(main, fetch_list=[lr], scope=scope)[0][0]
                       for _ in range(runs)], np.float32)


def _card_lrs(schedule, runs, what):
    """The same on the card, compiled (eager, capture, then replays), held
    to the CPU port's at CF_LR_RTOL."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        lr = schedule(fluid.layers)
    exe, scope = _fresh(main, startup)
    got = []
    for _ in range(runs):
        got.append(exe.run(main, fetch_list=[lr], scope=scope)[0][0])
        if exe._last_run_mode != "compiled":
            raise AssertionError(f"{what} ran {exe._last_run_mode}")
    got = np.asarray(got, np.float32)
    _cf_lr_agree(what, got, _cpu_lrs(schedule, runs),
                 exe._last_block.stats)
    exe.close()
    return got


def _cf_lr_agree(what, got, cpu, stats=None):
    import numpy as np
    peak = float(np.abs(cpu).max())
    err = float(np.abs(got - cpu).max())
    ok = np.allclose(got, cpu, rtol=CF_LR_RTOL, atol=CF_LR_RTOL * peak)
    _log(f"[control_flow] {what}: LR over {len(got)} runs on the card " +
         " ".join(f"{v:.7g}" for v in got) +
         f"; vs the CPU port max|d| {err:.3e} (rtol {CF_LR_RTOL:g}, atol "
         f"{CF_LR_RTOL:g} x {peak:.3g})" +
         (f"; {stats}" if stats else "") + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the card's LRs differ from the CPU's")


class _CfBook:
    """What phase 16 ran on the card, in KERNELS' order."""

    def __init__(self):
        self.executed = [0] * len(KERNELS)

    def add(self, counts, times=1):
        for i, c in enumerate(counts):
            self.executed[i] += times * c


def _delta(before):
    """The launches through the wrappers since ``before``
    (``_launch_counts()``)."""
    return tuple(x - y for x, y in zip(_launch_counts(), before))


def _interpreted(iexe, main, feed, fetch, scope, want, book, what):
    """One run of ``main`` by the interpreter on the card: its launches
    through the wrappers held to ``want`` and booked as counted. → its
    fetches."""
    from paddle_tpu_torch.fluid import core
    mode = core.globals_["FLAGS_executor_mode"]
    before = _launch_counts()
    core.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        out = iexe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        core.set_flag("FLAGS_executor_mode", mode)
    delta = _delta(before)
    if delta != want:
        raise AssertionError(f"{what}, interpreted: launches through the "
                             f"wrappers {delta}, want {want}")
    book.add(delta)
    return out


def _gate_mode(exe, before, want, what, book, mode="compiled"):
    """The last run of ``exe`` (launches since ``before``) gated in
    ``mode`` and booked: compiled by ``_gate_run`` on ``want``, segmented
    by ``_rnn_gate`` (none of the kernels). → how it executed."""
    if mode == "compiled":
        kind = _gate_run(exe, _delta(before), want, what)
        book.add(want)
        return kind
    if want != NO_KERNELS:
        raise AssertionError(f"{what}: a {mode} gate counts no kernel")
    return _rnn_gate(exe, before, mode, what, book)


def _lock_step(run, interp, main, feed, fetch, want, book, what, tag,
               extra=(), mode="compiled"):
    """One step of ``main`` on ``run`` (executor, scope), compiled or
    segmented (``mode``) and gated on ``want`` (``_gate_mode``), then
    interpreted on ``interp`` from the same state (``_interpreted``):
    each fetch and every persistable bitwise alike. ``extra`` is fetched
    from the interpreter alone. → (the fetches of ``run``, the
    interpreted fetches with ``extra`` after them, how the run executed,
    its seconds, its persistables)."""
    import numpy as np
    exe, scope = run
    before = _launch_counts()
    t = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    dt = time.perf_counter() - t
    kind = _gate_mode(exe, before, want, f"{tag} {what}", book, mode)
    iout = _interpreted(interp[0], main, feed, list(fetch) + list(extra),
                        interp[1], want, book, f"{tag} {what}")
    for i, (a, c) in enumerate(zip(out, iout)):
        if not np.array_equal(a, c):
            raise AssertionError(f"{tag} {what}: fetch {i} compiled {a}, "
                                 f"interpreted {c}")
    state = _persistables(scope, main)
    _same_state(f"{what} compiled vs interpreted", state,
                _persistables(interp[1], main), tag=tag)
    return out, iout, kind, dt, state


def _cf_bert(book, train_p50):
    """(a) BERT-base pretraining under BERT's schedule: 12 steps compiled
    and 12 interpreted in lock step from one start, then a window of 4
    across the warm-up boundary. → the compiled steps' p50 in ms."""
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid import executor
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    main, startup, loss, lr = _cf_pretrain_program(cfg, TRAIN_DROPOUT)
    ops = main.global_block().ops
    want = _step_want(ops, _attention_route(main))
    if want != TRAIN_STEP_WANT:
        raise AssertionError(f"[control_flow] want {want} launches a step, "
                             f"not {TRAIN_STEP_WANT}")
    n_cond = sum(op.type == "conditional_block" for op in ops)
    if n_cond != 2 or not executor._whole_compilable(ops):
        raise AssertionError(f"[control_flow] {n_cond} conditionals, "
                             "want 2 in a step that compiles whole")
    rng = np.random.RandomState(SEED + 16)
    batches = [_train_batch(rng, TRAIN_BATCH, cfg) for _ in range(CF_STEPS)]
    params = [p.name for p in main.all_parameters()]
    exe, scope = _fresh(main, startup)
    iexe, iscope = _fresh(main, startup)
    start = {n: scope.find_var(n).value().array.clone() for n in params}
    _same_state("(a) the compiled and the interpreted starts",
                _persistables(scope, main), _persistables(iscope, main),
                tag=CF_TAG)
    lrs, losses, times, execs, at = [], [], [], [], {}
    for s, b in enumerate(batches):
        st0 = exe.graph_stats()
        (lv, lrv), _, kind, dt, state = _lock_step(
            (exe, scope), (iexe, iscope), main, b, [loss, lr], want, book,
            f"(a) step {s}", CF_TAG)
        times.append(dt)
        execs.append(kind)
        st = exe.graph_stats()
        if st["islands"] or (kind == "replay" and (
                st["replays"] - st0["replays"] != 1 or st["captures"]
                != st0["captures"] or st["eager"] != st0["eager"])):
            raise AssertionError(f"[control_flow] step {s}: {st0} -> {st}")
        if s == 0:
            moved = [n for n in params if not torch.equal(state[n],
                                                          start[n])]
            moments = [n for n in state if "_moment" in n]
            still = [n for n in moments if not state[n].any()]
            if float(lrv[0]) != 0.0 or moved or not moments or still:
                raise AssertionError(
                    f"[control_flow] the LR-0 step: LR {lrv}, parameters "
                    f"moved {moved[:3]}, moments still zero {still[:3]}")
        if s in (CF_WINDOW[0] - 1, CF_WINDOW[1] - 1):
            at[s] = state
        del state
        lrs.append(float(lrv[0]))
        losses.append(float(lv.reshape(-1)[0]))
    counter = int(scope.find_var("@LR_DECAY_COUNTER@").value().array[0])
    _log(f"[control_flow] (a) BERT-base f32, dropout {TRAIN_DROPOUT}, input "
         f"mask, batch {TRAIN_BATCH}, S = {S}, Adam under linear_lr_warmup"
         f"(polynomial_decay({CF_PEAK:g}, {CF_STEPS}, 0.0, 1.0), "
         f"{CF_WARMUP}, 0.0, {CF_PEAK:g}): {CF_STEPS} steps {execs}, each "
         f"{want} launches, 0 islands; losses and LRs bitwise the "
         f"interpreter's after every step; the LR-0 step left the "
         f"{len(params)} parameters bitwise and moved Adam's moments; "
         f"@LR_DECAY_COUNTER@ {counter} -> ok")
    _log("[control_flow] (a) losses " + " ".join(f"{x:.6f}" for x in losses))
    _cf_lr_agree("(a) the step's schedule", np.asarray(lrs, np.float32),
                 _cpu_lrs(_cf_schedule, CF_STEPS))
    _drop(iexe)
    del iexe, iscope
    # the window: steps CF_WINDOW[0] .. CF_WINDOW[1] - 1 as one run, from
    # the state the single runs had before them
    wexe, wscope = _fresh(main, startup)
    _train_steps(wexe, main, loss, wscope, batches[:CF_WINDOW[0]], want,
                 collections.Counter(), "[control_flow] window prefix step", book)
    _same_state("(a) the window's start vs the single runs'",
                _persistables(wscope, main), at[CF_WINDOW[0] - 1],
                tag=CF_TAG)
    k = CF_WINDOW[1] - CF_WINDOW[0]
    win = {n: np.stack([batches[s][n] for s in range(*CF_WINDOW)])
           for n in batches[0]}
    stats0 = {id(cb): dict(cb.stats)
              for cb in wexe._compiled_cache.values()}
    before = _launch_counts()
    wl, wlr = wexe.run(main, feed=win, fetch_list=[loss, lr], scope=wscope,
                       n_steps=k)
    _gate_window(wexe, _delta(before),
                 stats0.get(id(wexe._last_block), {}), k, want,
                 "[control_flow] the window")
    book.add(want, k)
    single_l = np.asarray(losses[CF_WINDOW[0]:CF_WINDOW[1]], np.float32)
    single_lr = np.asarray(lrs[CF_WINDOW[0]:CF_WINDOW[1]], np.float32)
    _same_state("(a) after the window vs after the single runs",
                _persistables(wscope, main), at[CF_WINDOW[1] - 1],
                tag=CF_TAG)
    if not (np.array_equal(wl.reshape(-1), single_l)
            and np.array_equal(wlr.reshape(-1), single_lr)):
        raise AssertionError(
            f"[control_flow] the window: losses {wl.reshape(-1)} LRs "
            f"{wlr.reshape(-1)} vs {single_l} {single_lr}")
    _log(f"[control_flow] (a) Executor.run(n_steps={k}) over steps "
         f"{CF_WINDOW[0]}..{CF_WINDOW[1] - 1} (LRs " +
         " ".join(f"{v:.7g}" for v in wlr.reshape(-1)) +
         "): losses, LRs and every persistable bitwise the single runs' "
         "-> ok")
    del at
    _drop(wexe)
    del wexe, wscope
    # the steady state, as the train phase times it: replays back to
    # back, nothing between them (the lock step above put an interpreted
    # step and the state compares before each)
    timed, _ = _train_steps(exe, main, loss, scope,
                            [batches[j % CF_STEPS] for j in range(CF_TIMED)],
                            want, collections.Counter(), "[control_flow] timed step",
                            book)
    ms = np.asarray(timed) * 1e3
    lock = np.asarray(times[2:]) * 1e3
    p50 = float(np.percentile(ms, 50))
    _log(f"[control_flow] (a) step p50 {p50:.3f} ms (p90 "
         f"{np.percentile(ms, 90):.3f}, n = {len(ms)} replays back to back) "
         f"beside the train phase's f32 step p50 {train_p50:.3f} ms in this "
         f"call: {100 * (p50 / train_p50 - 1):+.2f} %; in lock step with the "
         f"interpreter p50 {np.percentile(lock, 50):.3f} ms ({_card_line()})")
    _drop(exe)
    return p50


def _cf_loop_program(cfg, dropout, loop=True):
    """(b): one encoder layer of BERT-base applied CF_LOOP_TRIPS times by
    while_loop (an int64 counter, less_than), its parameters made once; or,
    ``loop`` False, the straight line: CF_LOOP_TRIPS layers of the same
    shapes one after another."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    L = fluid.layers
    H = cfg["hidden"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[S, H], dtype="float32")
        mask = fluid.data("input_mask", shape=[S], dtype="float32")
        bias = bert.padding_attn_bias(mask)
        if loop:
            h = L.assign(x)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", CF_LOOP_TRIPS)

            def body(i, h):
                return (L.increment(i, in_place=False),
                        bert.encoder_layer(h, H, cfg["heads"], cfg["ffn"],
                                           dropout, attn_bias=bias))
            _, out = L.while_loop(lambda i, h: L.less_than(i, n), body,
                                  [i, h])
        else:
            out = bert.encoder(x, CF_LOOP_TRIPS, H, cfg["heads"],
                               cfg["ffn"], dropout, attn_bias=bias)
    startup.random_seed = main.random_seed = SEED
    return main, startup, out


def _cf_loop_feed(rng, cfg):
    import numpy as np
    lens = rng.randint(S // 4, S + 1, size=CF_LOOP_BATCH)
    return {"x": rng.randn(CF_LOOP_BATCH, S, cfg["hidden"]).astype(
                np.float32),
            "input_mask": (np.arange(S)[None, :] < lens[:, None]).astype(
                np.float32)}


def _cf_loop_run(exe, main, out, scope, feed, want, what, book):
    """One run of a loop program on the segmented path, gated: the loop
    iterated CF_LOOP_TRIPS times, eagerly on the key's first run and as
    replays of its body's graph after, launching ``want`` a run (through
    the wrappers when eager; a capture records one iteration). →
    (the output, seconds)."""
    sb = exe._last_block if exe._last_run_mode == "segmented" else None
    caps = sb.loop_stats["body_captures"] if sb is not None else 0
    reps = sb.loop_stats["body_replays"] if sb is not None else 0
    before = _launch_counts()
    t = time.perf_counter()
    o, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    dt = time.perf_counter() - t
    delta = tuple(x - y for x, y in zip(_launch_counts(), before))
    sb = exe._last_block
    if exe._last_run_mode != "segmented" or sb.stats["islands"]:
        raise AssertionError(f"{what} ran {exe._last_run_mode}, "
                             f"{sb.stats}")
    (seg,) = [s for s in sb.segments if s.kind == "loop"]
    if sb.last_iterations[seg.start] != CF_LOOP_TRIPS:
        raise AssertionError(f"{what}: {sb.last_iterations} iterations")
    body = tuple(seg.loop.launches.get(k, 0) for k in KERNELS)
    graphs = tuple(sb.graph_launches.get(k, 0) for k in KERNELS)
    if sb.last_exec == "eager":
        ok = delta == want
    else:
        captured = sb.loop_stats["body_captures"] - caps
        replayed = sb.loop_stats["body_replays"] - reps
        ok = not any(graphs) and replayed == CF_LOOP_TRIPS and tuple(
            CF_LOOP_TRIPS * c for c in body) == want and delta == tuple(
            captured * c for c in body)
    if not ok:
        raise AssertionError(f"{what} ({sb.last_exec}): launches through "
                             f"the wrappers {delta}, one body replay "
                             f"{body}, the segments' graphs {graphs}, "
                             f"loop {sb.loop_stats}; want {want} a run")
    book.add(want)
    return o, dt


def _cf_loop(book):
    """(b) while_loop over a shared BERT-base encoder layer at batch 8: at
    dropout 0 bitwise the interpreter's, the body replayed, 12 f32
    forwards a run (wrappers, the body's graph and a trace of one run),
    timed beside the straight line of 12 layers; at dropout 0.1 compiled
    against interpreted bitwise. → (loop p50 ms, straight line p50 ms)."""
    import collections
    import numpy as np
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    rng = np.random.RandomState(SEED + 160)
    feeds = [_cf_loop_feed(rng, cfg) for _ in range(4)]
    results = {}
    for dropout, want in ((0.0, CF_LOOP_WANT),
                          (TRAIN_DROPOUT, CF_LOOP_DROP_WANT)):
        main, startup, out = _cf_loop_program(cfg, dropout)
        if len(main.all_parameters()) != 16:
            raise AssertionError(f"(b) {len(main.all_parameters())} "
                                 "parameters, want one layer's 16")
        exe, scope = _fresh(main, startup)
        iexe, iscope = _fresh(main, startup)
        execs, times = [], []
        for j in range(len(feeds) if dropout else 3 + CF_LOOP_RUNS):
            f = feeds[j % len(feeds)]
            o, dt = _cf_loop_run(exe, main, out, scope, f, want,
                                 f"[control_flow] (b) run {j}", book)
            execs.append(exe._last_block.last_exec)
            times.append(dt)
            if j < len(feeds):
                io, = _interpreted(iexe, main, f, [out], iscope, want, book,
                                   f"[control_flow] (b) run {j}")
                if not np.array_equal(o, io) or not np.isfinite(o).all():
                    raise AssertionError(
                        f"[control_flow] (b) dropout {dropout} run {j}: "
                        f"compiled vs interpreted max|d| "
                        f"{float(np.abs(o - io).max()):.3e}")
        sb = exe._last_block
        if dropout == 0.0:
            timing = {}

            def one_run():
                exe.run(main, feed=feeds[0], fetch_list=[out], scope=scope)

            def warm_run():
                _cf_loop_run(exe, main, out, scope, feeds[0], want,
                             "[control_flow] (b) the trace's warm-up", book)
            # the loop replays two graphs from the host: the warm-up cycle
            # replays them once (the docstring of _device_kernel_counts),
            # gated and booked as any run; the traced run books its trace
            counts = _device_kernel_counts(one_run, timing=timing,
                                           warm=warm_run)
            _log(f"[control_flow] (b) the trace of one run: {counts}, "
                 f"{sb.last_iterations} iterations; on the host's clock "
                 + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                             else f"{k} {v}" for k, v in timing.items()))
            if counts != want:
                raise AssertionError(f"[control_flow] (b): the trace of one "
                                     f"run holds {counts}, want {want}")
            book.add(counts)
            results["loop"] = np.asarray(times[3:]) * 1e3
        _log(f"[control_flow] (b) while_loop over one shared BERT-base "
             f"encoder layer x {CF_LOOP_TRIPS}, batch {CF_LOOP_BATCH}, "
             f"dropout {dropout}: runs {execs[:4]}.., each {want} "
             f"launches ({CF_LOOP_TRIPS} iterations; a body replay "
             f"{tuple(sb.segments[-1].loop.launches.get(k, 0) for k in KERNELS)}"
             f"), loop {sb.loop_stats}, segments "
             f"{[s.kind for s in sb.segments]}; the first "
             f"{len(feeds)} runs bitwise the interpreter's -> ok")
        _drop(iexe)
        _drop(exe)
        del exe, scope, iexe, iscope
    # the straight line: the same work as 12 layers of one graph
    main, startup, out = _cf_loop_program(cfg, 0.0, loop=False)
    exe, scope = _fresh(main, startup)
    line, _ = _train_steps(
        exe, main, out, scope,
        [feeds[j % len(feeds)] for j in range(3 + CF_LOOP_RUNS)],
        CF_LOOP_WANT, collections.Counter(), "[control_flow] straight line run", book)
    line = np.asarray(line[3:]) * 1e3
    _drop(exe)
    del exe, scope
    loop = results["loop"]
    lp50, sp50 = float(np.percentile(loop, 50)), float(np.percentile(line,
                                                                     50))
    _log(f"[control_flow] (b) run p50 {lp50:.3f} ms (p90 "
         f"{np.percentile(loop, 90):.3f}, n = {len(loop)}) beside the "
         f"straight line of {CF_LOOP_TRIPS} layers in one graph "
         f"{sp50:.3f} ms (p90 {np.percentile(line, 90):.3f}): "
         f"{100 * (lp50 / sp50 - 1):+.2f} %, "
         f"{(lp50 - sp50) / CF_LOOP_TRIPS * 1e3:.1f} us an iteration beyond "
         f"its body (a replay and a host read of the condition; "
         f"{_card_line()})")
    return lp50, sp50


def _cf_small_program(build):
    from paddle_tpu_torch import fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid.layers, fluid)
    startup.random_seed = main.random_seed = SEED
    return main, startup, fetch


def _cf_against_interpreter(what, build, feeds, modes, book):
    """A small program on the card, run compiled once a feed and again
    interpreted from the same start: each run's fetches bitwise alike,
    each compiled run in ``modes`` (its run mode and last exec), the
    graphs recording none of KERNELS. → the compiled fetches."""
    import numpy as np
    from paddle_tpu_torch.fluid import core
    main, startup, fetch = _cf_small_program(build)
    exe, scope = _fresh(main, startup)
    iexe, iscope = _fresh(main, startup)
    mode = core.globals_["FLAGS_executor_mode"]
    got, seen = [], []
    for f in feeds:
        loops0 = _cf_body_replays(exe)
        before = _launch_counts()
        o = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        book.add(tuple(x - y for x, y in zip(_launch_counts(), before)))
        # a loop's body replays past its capture ran what it recorded
        for lp, (reps, caps) in _cf_body_replays(exe).items():
            r0, c0 = loops0.get(lp, (0, 0))
            book.add(tuple(lp.launches.get(k, 0) for k in KERNELS),
                     (reps - r0) - (caps - c0))
        cb = exe._last_block
        seen.append((exe._last_run_mode, cb.last_exec))
        if any(cb.graph_launches.get(k, 0) for k in KERNELS):
            raise AssertionError(f"[control_flow] {what}: a graph holds "
                                 f"{cb.graph_launches}")
        before = _launch_counts()
        core.set_flag("FLAGS_executor_mode", "interpreted")
        try:
            io = iexe.run(main, feed=f, fetch_list=fetch, scope=iscope)
        finally:
            core.set_flag("FLAGS_executor_mode", mode)
        book.add(tuple(x - y for x, y in zip(_launch_counts(), before)))
        for a, b in zip(o, io):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"[control_flow] {what}: compiled "
                                     f"{a} vs interpreted {b}")
        got.append(o)
    if seen != list(modes):
        raise AssertionError(f"[control_flow] {what}: ran {seen}, want "
                             f"{list(modes)}")
    _log(f"[control_flow] (c) {what}: {seen}, bitwise the interpreter's "
         "-> ok")
    exe.close()
    iexe.close()
    return got


def _cf_body_replays(exe):
    """{loop plan: (body replays, body captures)} of the executor's last
    block (each plan's share: one loop a block here)."""
    cb = exe._last_block
    if getattr(cb, "loop_stats", None) is None:
        return {}
    return {s.loop: (cb.loop_stats["body_replays"],
                     cb.loop_stats["body_captures"])
            for s in cb.segments if s.loop is not None}


def _cf_small(book):
    """(c) the small checks: a pure cond inside the graph, a cond with a
    dropout in its untaken branch segmented, a while over tensor arrays,
    a Switch assigning a numpy constant, a dropout in a while body,
    piecewise_decay and cosine_decay against the CPU port."""
    import numpy as np
    from paddle_tpu_torch.fluid import core
    r = np.random.RandomState(SEED + 161)
    x = r.randn(64, 768).astype(np.float32)
    graph = [("compiled", "eager"), ("compiled", "capture"),
             ("compiled", "replay"), ("compiled", "replay")]

    def pure_cond(L, fluid):
        v = fluid.data("x", shape=[64, 768], dtype="float32",
                       append_batch_size=False)
        pred = L.reduce_sum(v) > 0.0
        out = L.cond(pred, lambda: L.scale(v, scale=2.0, bias=1.0),
                     lambda: L.elementwise_mul(v, v))
        return [out, pred]
    feeds = [{"x": x}, {"x": -x}, {"x": x}, {"x": -x}]
    got = _cf_against_interpreter("a cond of two pure branches", pure_cond,
                                  feeds, graph, book)
    for f, o in zip(feeds, got):
        want = f["x"] * 2.0 + 1.0 if o[1].all() else f["x"] * f["x"]
        if not np.array_equal(o[0], want.astype(np.float32)):
            raise AssertionError("[control_flow] the pure cond's branch")

    def rng_cond(L, fluid):
        v = fluid.data("x", shape=[64, 768], dtype="float32",
                       append_batch_size=False)
        p = fluid.data("p", shape=[1], dtype="bool",
                       append_batch_size=False)

        def untaken():
            return L.scale(L.dropout(v, 0.5), scale=-1.0)
        return [L.cond(p, lambda: L.scale(v, scale=2.0), untaken)]
    saved = core.globals_["FLAGS_executor_seg_min_ops"]
    core.set_flag("FLAGS_executor_seg_min_ops", 1)
    try:
        feeds = [{"x": x, "p": np.array([True])}] * 4
        seg = [("segmented", e) for _, e in graph]
        got = _cf_against_interpreter(
            "a cond with a dropout in its untaken branch", rng_cond,
            feeds, seg, book)
        if not all(np.array_equal(o[0], 2.0 * x) for o in got):
            raise AssertionError("[control_flow] the taken branch is not "
                                 "exact")
        got = _cf_against_interpreter(
            "the same, its dropout branch taken", rng_cond,
            [{"x": x, "p": np.array([False])}] * 2, seg[:2], book)
        if not np.all((got[0][0] == 0) | (got[0][0] == -x)):
            raise AssertionError("[control_flow] the dropout branch")

        def arrays(L, fluid):
            v = fluid.data("x", shape=[64, 768], dtype="float32",
                           append_batch_size=False)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 4)
            arr = L.create_array("float32")
            c = L.less_than(i, n)
            w = L.While(c)
            with w.block():
                L.array_write(L.scale(v, scale=2.0) * L.cast(i, "float32"),
                              i, arr)
                L.increment(i)
                L.less_than(i, n, cond=c)
            t, _ = L.tensor_array_to_tensor(arr, axis=0)
            return [t, L.array_length(arr)]
        got = _cf_against_interpreter(
            "a while writing a tensor array, joined after it", arrays,
            [{"x": x}] * 3, [("segmented", "eager"),
                             ("segmented", "capture"),
                             ("segmented", "replay")], book)
        want = np.concatenate([(x * 2.0) * np.float32(k) for k in range(4)])
        if not np.array_equal(got[0][0], want) or got[0][1].tolist() != [4]:
            raise AssertionError("[control_flow] the tensor array")

        def drop_loop(L, fluid):
            ones = L.fill_constant([64, 768], "float32", 1.0)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 2)
            acc = L.fill_constant([64, 768], "float32", 0.0)

            def body(i, acc):
                d = L.dropout(ones, TRAIN_DROPOUT,
                              dropout_implementation="upscale_in_train")
                return L.increment(i, in_place=False), acc + d
            _, acc = L.while_loop(lambda i, a: L.less_than(i, n), body,
                                  [i, acc])
            return [acc]
        got = _cf_against_interpreter(
            "a dropout in a while body", drop_loop, [{}] * 3,
            [("segmented", "eager"), ("segmented", "capture"),
             ("segmented", "replay")], book)
        vals = np.unique(got[0][0])
        one = np.float32(1.0) / np.float32(1 - TRAIN_DROPOUT)
        if one not in vals or np.array_equal(got[0][0], got[1][0]):
            raise AssertionError(f"[control_flow] a dropout in a while "
                                 f"body: values {vals}")
        _log(f"[control_flow] (c) the two iterations' dropout masks differ "
             f"(values {vals.tolist()}), and each step's -> ok")
    finally:
        core.set_flag("FLAGS_executor_seg_min_ops", saved)

    def hand_schedule(L, fluid):
        step = L.autoincreased_step_counter(
            counter_name="@LR_DECAY_COUNTER@", begin=0, step=1)
        lr = L.create_global_var([1], 0.5, "float32", persistable=True,
                                 name="hand_lr")
        with L.Switch() as s:
            with s.case(L.less_than(step, L.fill_constant([1], "int64",
                                                          2))):
                L.assign(np.array([0.25], np.float32), lr)
            with s.default():
                L.assign(np.array([0.125], np.float32), lr)
        return [lr]
    got = _cf_against_interpreter(
        "a Switch case assigning a numpy constant", hand_schedule,
        [{}] * 4, graph, book)
    if [float(o[0][0]) for o in got] != [0.25, 0.25, 0.125, 0.125]:
        raise AssertionError("[control_flow] the hand schedule")
    for name, sched in (
            ("piecewise_decay", lambda L: L.piecewise_decay(
                [3, 6], [1e-3, 1e-4, 1e-5])),
            ("cosine_decay", lambda L: L.cosine_decay(1e-3, 2, 5))):
        _card_lrs(sched, 12, f"(c) {name}")


def phase_control_flow(train_p50):
    """Phase 16: control flow and the LR schedules (the docstring's phase
    16). ``train_p50``: the train phase's f32 step p50 of this call. →
    the launches of its runs: through the wrappers (warm-ups, captures,
    the interpreter) and on the card (every run)."""
    book = _CfBook()
    _reset_launch_counts()
    t0 = time.perf_counter()
    step_p50 = _cf_bert(book, train_p50)
    loop_p50, line_p50 = _cf_loop(book)
    _cf_small(book)
    wrapper = _launch_counts()
    _log(f"[control_flow] phase 16 in {time.perf_counter() - t0:.1f} s: "
         f"(a) step p50 {step_p50:.3f} ms vs train {train_p50:.3f}; (b) "
         f"{loop_p50:.3f} ms vs the straight line {line_p50:.3f}; "
         f"launches through the wrappers {GATE_NAMES} {wrapper}, on the "
         f"card {tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed)}


# --------------------------------------------------------------------------
# 17. optimizers
# --------------------------------------------------------------------------
OPT_TAG = "[optimizers]"
OPT_PEAK = 1e-3               # (a)'s peak LR under LAMB: a weight's step is
#                               lr·‖p‖/‖r‖ ≈ lr × 0.02 an element at the init
#                               std of 0.02, so phase 16's 1e-4 would move the
#                               weights ~50× less than Adam does
OPT_HORIZON = 40              # (a)'s decay to 0 at step 40: every step of the
#                               phase after step 0 has a positive LR
OPT_CLIP = 1.0                # BERT's global-norm clip (Google's BERT
#                               optimization.py, clip_by_global_norm)
OPT_WD = 0.01                 # LAMB's weight decay (You et al. 2019)
OPT_STEPS = 6                 # (a): compiled and interpreted in lock step
OPT_TIMED = 20                # (a) and (b): replays timed back to back
NORM_RTOL = 1e-5              # the fetched global norm against float64
#                               from the fetched grads: f32 sums over 110 M
#                               squares in a tree
GM_K = 4                      # (b): micro-steps a window
GM_MICRO = TRAIN_BATCH // GM_K  # (b): micro-batch 8, GM_K of them = 32 rows
GM_LR = 1e-4                  # (b): Adam's LR (the train phase's)
GM_STEPS = 2 * GM_K           # (b): two windows in lock step
GM_MAXD = 3e-5                # (b): parameters after the window vs the
#                               batch-32 step, max|d| (8.93e-6 read on the
#                               card over all of them); Adam's first step
#                               lr·g/(|g| + ε) does not see the grad's scale,
#                               so the merged grads are held too, at
#                               GRAD_TOL. A parameter whose grad is rounding
#                               noise (GM_NOISE) can step either way: 2·lr
GM_SHARE = 1e-3               # (b): the share of elements allowed beyond
#                               1e-7 of the batch-32 step (5.11e-4 read)
GM_NOISE = 1e-6               # (b): a parameter's grad below this share of
#                               the largest grad is rounding noise (the K
#                               projections' biases: softmax does not see a
#                               shift, so their grad is 0 but for rounding),
#                               held to GRAD_TOL of the largest grad
GM_WANT = (0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 12, 12)  # (b): dropout 0
SMALL_TOL = (1e-5, 1e-6)      # (c): card vs CPU port, rtol and atol
#                               (tests/test_gradient_merge.py:69)
SMALL_RUNS = 4                # (c): runs of each case
SMALL_EXECS = ("eager", "capture", "replay", "replay")  # (c): how they run
DPSGD_N = 1 << 20             # dpsgd's noise drawn on the card, by law


def _lamb(clip_norm=OPT_CLIP):
    """(a)'s optimizer: LAMB under BERT's schedule at OPT_PEAK, weight
    decay OPT_WD on every weight but the LayerNorm scales and biases and
    every bias, the grads clipped by global norm ``clip_norm``."""
    def optimize(f, loss):
        lr = _cf_schedule(f.layers, OPT_PEAK, OPT_HORIZON)
        f.optimizer.Lamb(
            learning_rate=lr, lamb_weight_decay=OPT_WD,
            exclude_from_weight_decay_fn=_no_decay,
            grad_clip=f.clip.GradientClipByGlobalNorm(clip_norm)).minimize(
                loss)
        return lr
    return optimize


def _no_decay(param):
    """BERT's exclusion: LayerNorm's scale and bias, and every bias."""
    return param.name.startswith("layer_norm") or param.name.endswith(".b_0")


def _clip_vars(main):
    """(the pre-clip global norm, the clip's scale) of a global-norm clip:
    the ``sqrt`` of the summed squared norms and the ``elementwise_div``
    of clip_norm by max(norm, clip_norm) after it."""
    ops = main.global_block().ops
    i = next(j for j, op in enumerate(ops) if op.type == "sqrt")
    made = {n: op for op in ops[:i] for n in op.output_arg_names}
    summed = made[ops[i].input("X")[0]]
    if summed.type != "sum" or any(made[n].type != "squared_l2_norm"
                                   for n in summed.input("X")):
        raise AssertionError(f"{OPT_TAG} the clip's sqrt does not read the "
                             "summed squared norms")
    div = next(op for op in ops[i:] if op.type == "elementwise_div")
    return ops[i].output("Out")[0], div.output("Out")[0]


def _opt_lamb_block(book, cfg, clip_norm, steps, batches):
    """``steps`` steps of (a)'s program, compiled and interpreted in lock
    step from one start, each gated on its launches; loss, LR, the norm,
    the clip's scale and every persistable bitwise after each step; at
    step 1 the global norm against float64 from the interpreter's grads.
    → (program, loss, the compiled executor and scope, losses, norms,
    scales, run kinds, the launches a step)."""
    import numpy as np
    from paddle_tpu_torch.fluid import executor
    main, startup, loss, lr = _cf_pretrain_program(
        cfg, TRAIN_DROPOUT, _lamb(clip_norm))
    ops = main.global_block().ops
    want = _step_want(ops, _attention_route(main))
    if want != TRAIN_STEP_WANT:
        raise AssertionError(f"{OPT_TAG} want {want} launches a step, not "
                             f"{TRAIN_STEP_WANT}")
    if not executor._whole_compilable(ops):
        raise AssertionError(f"{OPT_TAG} (a)'s step does not compile whole")
    norm, scale = _clip_vars(main)
    params = main.all_parameters()
    grads = [p.name + "@GRAD" for p in params]
    exe, scope = _fresh(main, startup)
    iexe, iscope = _fresh(main, startup)
    losses, norms, scales, execs = [], [], [], []
    for s in range(steps):
        out, iout, kind, _, _ = _lock_step(
            (exe, scope), (iexe, iscope), main, batches[s % len(batches)],
            [loss, lr, norm, scale], want, book,
            f"(a) clip {clip_norm:g} step {s}", OPT_TAG,
            extra=grads if s == 1 else ())
        execs.append(kind)
        if s == 1:
            _norm_agrees(out[2], iout[4:], params)
        losses.append(float(out[0].reshape(-1)[0]))
        norms.append(float(out[2][0]))
        scales.append(float(out[3][0]))
        want_scale = np.float32(clip_norm) / max(np.float32(norms[-1]),
                                                 np.float32(clip_norm))
        if out[3][0] != np.float32(want_scale):
            raise AssertionError(f"{OPT_TAG} (a) step {s}: scale "
                                 f"{out[3][0]}, want {want_scale}")
    _drop(iexe)
    del iexe, iscope
    return main, loss, (exe, scope), losses, norms, scales, execs, want


def _norm_agrees(fetched, grads, params):
    """The fetched pre-clip global norm against a float64 recomputation on
    the host from the fetched grads, at NORM_RTOL."""
    import numpy as np
    total = 0.0
    for g in grads:
        total += float(np.square(g.astype(np.float64)).sum())
    ref = float(np.sqrt(total))
    err = abs(float(fetched[0]) - ref) / ref
    _log(f"{OPT_TAG} (a) the global norm over {len(params)} grads: fetched "
         f"{float(fetched[0]):.7g}, float64 from the fetched grads "
         f"{ref:.9g}: relative {err:.3e} (tol {NORM_RTOL:g}) -> "
         f"{'ok' if err <= NORM_RTOL else 'FAIL'}")
    if err > NORM_RTOL:
        raise AssertionError(f"{OPT_TAG} the global norm disagrees")


def _opt_lamb(book, train_p50):
    """(a) BERT-base pretraining under LAMB with a global-norm clip. →
    (the step's p50, Adam's step p50 timed alternating with it) in ms."""
    import collections
    import numpy as np
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    rng = np.random.RandomState(SEED + 17)
    batches = [_train_batch(rng, TRAIN_BATCH, cfg) for _ in range(OPT_STEPS)]
    main, loss, (exe, scope), losses, norms, scales, execs, want = \
        _opt_lamb_block(book, cfg, OPT_CLIP, OPT_STEPS, batches)
    _log(f"{OPT_TAG} (a) BERT-base f32, dropout {TRAIN_DROPOUT}, input mask, "
         f"batch {TRAIN_BATCH}, S = {S}, Lamb(linear_lr_warmup(polynomial_"
         f"decay({OPT_PEAK:g}, {OPT_HORIZON}, 0.0, 1.0), {CF_WARMUP}, 0.0, "
         f"{OPT_PEAK:g}), lamb_weight_decay={OPT_WD:g}, LayerNorm and biases "
         f"excluded, GradientClipByGlobalNorm({OPT_CLIP:g})): {OPT_STEPS} "
         f"steps {execs}, each {want} launches; loss, LR, norm, scale and "
         f"every persistable bitwise the interpreter's -> ok")
    _log(f"{OPT_TAG} (a) losses " + " ".join(f"{x:.6f}" for x in losses))
    _log(f"{OPT_TAG} (a) pre-clip global norms " +
         " ".join(f"{x:.6f}" for x in norms) + "; the clip's scales " +
         " ".join(f"{x:.6f}" for x in scales))
    engaged = [s for s, n in enumerate(norms) if n > OPT_CLIP]
    if engaged:
        _log(f"{OPT_TAG} (a) the clip engaged at steps {engaged} (norm > "
             f"{OPT_CLIP:g}, scale = {OPT_CLIP:g} / norm < 1) -> ok")
    else:
        # no step exceeded the clip: hold the scale < 1 branch with a
        # clip_norm below the first step's norm
        low = float(np.float32(norms[0] / 2))
        _, _, (lexe, _), _, lnorms, lscales, lexecs, _ = \
            _opt_lamb_block(book, cfg, low, 3, batches)
        _drop(lexe)
        if not all(n > low and c < 1 for n, c in zip(lnorms, lscales)):
            raise AssertionError(f"{OPT_TAG} the clip at {low} did not "
                                 f"engage: norms {lnorms} scales {lscales}")
        _log(f"{OPT_TAG} (a) no step's norm exceeded {OPT_CLIP:g}; with "
             f"clip_norm {low:g} (half step 0's norm): 3 steps {lexecs}, "
             f"norms {lnorms}, scales {lscales} < 1, bitwise the "
             "interpreter's -> ok")
    counts = _device_kernel_counts(lambda: exe.run(
        main, feed=batches[0], fetch_list=[loss], scope=scope))
    _check_trace(counts, want, "(a) LAMB step")
    book.add(counts)
    # the loss on one repeated batch
    _, fall = _train_steps(exe, main, loss, scope,
                           [batches[0]] * FALL_STEPS, want, collections.Counter(),
                           f"{OPT_TAG} (a) repeated step", book)
    _log(f"{OPT_TAG} (a) repeated batch, {FALL_STEPS} steps: " +
         " ".join(f"{x:.4f}" for x in fall))
    if not (fall[-1] < fall[0] and np.mean(fall[-3:]) < np.mean(fall[:3])):
        raise AssertionError(f"{OPT_TAG} the loss does not fall under LAMB")
    # LAMB's step against Adam's under the same schedule, dropout and
    # batch, their replays alternating so that both see the card's drift
    amain, astartup, aloss, _ = _cf_pretrain_program(cfg, TRAIN_DROPOUT)
    awant = _step_want(amain.global_block().ops, _attention_route(amain))
    if awant != want:
        raise AssertionError(f"{OPT_TAG} (a) Adam's step launches {awant}, "
                             f"LAMB's {want}")
    aexe, ascope = _fresh(amain, astartup)
    runs = collections.Counter()
    _train_steps(aexe, amain, aloss, ascope, batches[:2], want, runs,
                 f"{OPT_TAG} (a) Adam warm-up step", book)
    ms, ams = [], []
    for j in range(OPT_TIMED):
        feed = [batches[j % OPT_STEPS]]
        ms += _train_steps(exe, main, loss, scope, feed, want, runs,
                           f"{OPT_TAG} (a) timed step {j}", book)[0]
        ams += _train_steps(aexe, amain, aloss, ascope, feed, want, runs,
                            f"{OPT_TAG} (a) timed Adam step {j}", book)[0]
    ms, ams = np.asarray(ms) * 1e3, np.asarray(ams) * 1e3
    _drop(aexe)
    del aexe, ascope
    p50, ap50 = float(np.percentile(ms, 50)), float(np.percentile(ams, 50))
    _log(f"{OPT_TAG} (a) step p50 {p50:.3f} ms p90 "
         f"{np.percentile(ms, 90):.3f} beside Adam's under the same "
         f"schedule p50 {ap50:.3f} ms p90 {np.percentile(ams, 90):.3f} "
         f"(n = {OPT_TIMED} replays each, alternating): "
         f"{p50 - ap50:+.3f} ms, {100 * (p50 / ap50 - 1):+.2f} % for LAMB "
         f"and the clip; the train phase's f32 Adam step p50 "
         f"{train_p50:.3f} ms earlier in this call ({_card_line()})")
    _drop(exe)
    del exe, scope
    # one step at CHECK_BATCH, dropout 0, on the card against the CPU
    main, startup, loss, _ = _cf_pretrain_program(cfg, 0.0, _lamb())
    norm, _ = _clip_vars(main)
    route = _attention_route(main)
    if route != "f32":
        raise AssertionError(f"{OPT_TAG} (a) batch {CHECK_BATCH}: route "
                             f"{route}, want f32")
    cwant = _step_want(main.global_block().ops, route)
    muls = [op for op in main.global_block().ops if op.type == "mul"]
    names = ["word_embedding", muls[0].input("Y")[0],
             muls[-1].input("Y")[0]]
    feed = _train_batch(np.random.RandomState(SEED + 171), CHECK_BATCH, cfg)
    before = _launch_counts()
    gpu, cpu, (gexe, _), _ = _card_and_cpu_step(
        main, startup, [loss] + [n + "@GRAD" for n in names] + [norm], feed)
    _gate_run(gexe, _delta(before), cwant,
              f"{OPT_TAG} (a) batch {CHECK_BATCH} on the card")
    book.add(cwant)
    _loss_and_grads_agree(f"{OPT_TAG} (a) batch {CHECK_BATCH} dropout 0",
                          names, gpu[:-1], cpu[:-1])
    nerr = abs(float(gpu[-1][0]) - float(cpu[-1][0])) / float(cpu[-1][0])
    _log(f"{OPT_TAG} (a) the global norm, card vs CPU: {float(gpu[-1][0]):.7g}"
         f" vs {float(cpu[-1][0]):.7g}, relative {nerr:.3e} (tol "
         f"{LOSS_TOL:g}) -> {'ok' if nerr <= LOSS_TOL else 'FAIL'}")
    if nerr > LOSS_TOL:
        raise AssertionError(f"{OPT_TAG} the card's global norm disagrees")
    _drop(gexe)
    return p50, ap50


def _gm_batches(rng, cfg):
    """GM_K micro-batches of GM_MICRO rows, each with its own masked
    positions, and the batch of their TRAIN_BATCH rows with those
    positions moved to the rows' new places: one Adam step on it sees the
    mean of the micro-batches' mean losses (equal counts)."""
    import numpy as np
    micro = [_train_batch(rng, GM_MICRO, cfg) for _ in range(GM_K)]
    big = {n: np.concatenate([m[n] for m in micro]) for n in micro[0]}
    big["mask_pos"] = np.concatenate(
        [m["mask_pos"] + i * GM_MICRO * S for i, m in enumerate(micro)])
    return micro, big


def _opt_gm(book):
    """(b) GradientMerge over BERT-base micro-batches. → (micro-step p50,
    plain batch-8 step p50) in ms."""
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch.fluid import executor
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()

    def merged(f, loss):
        f.optimizer.GradientMergeOptimizer(
            f.optimizer.Adam(GM_LR), k_steps=GM_K, avg=True).minimize(loss)

    def plain(f, loss):
        f.optimizer.Adam(GM_LR).minimize(loss)
    main, startup, loss, _ = _cf_pretrain_program(cfg, 0.0, merged)
    ops = main.global_block().ops
    want = _step_want(ops, _attention_route(main))
    n_cond = sum(op.type == "conditional_block" for op in ops)
    if want != GM_WANT or n_cond != 2 or not executor._whole_compilable(ops):
        raise AssertionError(f"{OPT_TAG} (b): {want} launches, {n_cond} "
                             "conditionals; want GM_WANT and a step that "
                             "compiles whole")
    rng = np.random.RandomState(SEED + 172)
    micro, big = _gm_batches(rng, cfg)
    params = [p.name for p in main.all_parameters()]
    exe, scope = _fresh(main, startup)
    iexe, iscope = _fresh(main, startup)
    start = {n: scope.find_var(n).value().array.clone() for n in params}
    execs, after = [], None
    for s in range(GM_STEPS):
        _, _, kind, _, state = _lock_step(
            (exe, scope), (iexe, iscope), main, micro[s % GM_K], [loss],
            want, book, f"(b) micro-step {s + 1}", OPT_TAG)
        execs.append(kind)
        if s < GM_K - 1:
            moved = [n for n in params if not torch.equal(state[n],
                                                          start[n])]
            if moved:
                raise AssertionError(f"{OPT_TAG} (b) micro-step {s + 1} "
                                     f"moved {moved[:3]}")
        elif s == GM_K - 1:
            after = state
        del state
    _drop(iexe)
    _drop(exe)
    del iexe, iscope, exe, scope
    _log(f"{OPT_TAG} (b) GradientMergeOptimizer(Adam({GM_LR:g}), k_steps="
         f"{GM_K}, avg=True), BERT-base f32 at dropout 0, micro-batch "
         f"{GM_MICRO}: {GM_STEPS} micro-steps {execs}, each {want} launches"
         f", 2 conditionals in the step; bitwise the interpreter's after "
         f"every micro-step; micro-steps 1-{GM_K - 1} left the "
         f"{len(params)} parameters bitwise -> ok")
    # one plain Adam step on the same 32 rows from the same start
    bmain, bstartup, bloss, _ = _cf_pretrain_program(cfg, 0.0, plain)
    bexe, bscope = _fresh(bmain, bstartup)
    for n in params:
        bscope.find_var(n).value().array.copy_(start[n])
    del start
    _train_steps(bexe, bmain, bloss, bscope, [big], want,
                 collections.Counter(),
                 f"{OPT_TAG} (b) the batch-{TRAIN_BATCH} step", book)
    _gm_against_batch(after, bscope, params)
    del after
    _drop(bexe)
    del bexe, bscope
    pmain, pstartup, ploss, _ = _cf_pretrain_program(cfg, 0.0, plain)
    gm_ms, gm_peak = _gm_timed(main, startup, loss, micro, want, book,
                               "timed micro-step")
    p_ms, p_peak = _gm_timed(pmain, pstartup, ploss, micro, want, book,
                             "timed plain step")
    gp50, pp50 = (float(np.percentile(gm_ms, 50)),
                  float(np.percentile(p_ms, 50)))
    _log(f"{OPT_TAG} (b) micro-step p50 {gp50:.3f} ms p90 "
         f"{np.percentile(gm_ms, 90):.3f} beside a plain Adam step at batch "
         f"{GM_MICRO} p50 {pp50:.3f} ms p90 {np.percentile(p_ms, 90):.3f} "
         f"(n = {OPT_TIMED} replays each): {100 * (gp50 / pp50 - 1):+.2f} % "
         f"(the accumulate and the both-branch update each micro-step); "
         f"peak memory of a fresh executor (startup, warm-up, capture, "
         f"replays) {gm_peak:.3f} GiB vs {p_peak:.3f} GiB "
         f"({gm_peak - p_peak:+.3f}; {_card_line()})")
    return gp50, pp50


def _gm_timed(main, startup, loss, micro, want, book, what):
    """(b): a fresh executor's startup, eager run, capture and OPT_TIMED
    replays on the micro-batches → (the replays' ms, the peak memory
    above what was allocated before, in GiB)."""
    import collections
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exe, scope = _fresh(main, startup)
    times, _ = _train_steps(
        exe, main, loss, scope,
        [micro[j % GM_K] for j in range(2 + OPT_TIMED)], want,
        collections.Counter(), f"{OPT_TAG} (b) {what}", book)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    _drop(exe)
    return np.asarray(times[2:]) * 1e3, peak


def _gm_against_batch(merged, bscope, params):
    """(b): the persistables after micro-step GM_K against one Adam step
    at batch TRAIN_BATCH on the same rows from the same start. The
    merged, averaged grads as Adam's first update left them in its first
    moment ((1 − β1)·g on both sides): each parameter's within GRAD_TOL of
    its largest magnitude, or of the largest of all where its grad is
    rounding noise (GM_NOISE). The parameters within GM_MAXD, those with
    a noise grad within 2·lr, at most GM_SHARE of all their elements
    beyond 1e-7; those elements sorted by
    cause: a grad near Adam's ε, where the first step lr·g/(|g| + ε) moves
    with the grad's last bits (the step recomputed in float64 from the
    two moments differs by more than half of 1e-7), or one ulp of the
    parameter."""
    import torch
    beta1, eps = 0.9, 1e-8  # AdamOptimizer's defaults
    moment = {p: next(n for n in merged if n.startswith(p + "_moment1_"))
              for p in params}
    ref = {p: bscope.find_var(moment[p]).value().array for p in params}
    gmax = max(float(ref[p].abs().max()) for p in params)
    noise, bad, rel, rel_at = [], [], 0.0, None
    worst, worst_noise, beyond, total = 0.0, 0.0, 0, 0
    near_eps, one_ulp, by_param = 0, 0, {}
    for p in params:
        a, b = merged[moment[p]], ref[p]
        own = float(b.abs().max())
        scale = own if own >= GM_NOISE * gmax else gmax
        if scale != own:
            noise.append(p)
        err = float((a - b).abs().max())
        if err / scale > rel:
            rel, rel_at = err / scale, p
        if err > GRAD_TOL * scale:
            bad.append(f"{p} max|d| {err:.3e} of {scale:.3e}")
        w = bscope.find_var(p).value().array
        d = (merged[p] - w).abs()
        if scale == own:
            worst = max(worst, float(d.max()))
        else:
            worst_noise = max(worst_noise, float(d.max()))
        total += d.numel()
        far = d > 1e-7
        n = int(far.sum())
        if not n:
            continue
        beyond += n
        by_param[p] = n
        ga, gb = (x[far].double() / (1 - beta1) for x in (a, b))
        step_d = GM_LR * (ga / (ga.abs() + eps) - gb / (gb.abs() + eps))
        sens = step_d.abs() > 0.5e-7
        wv = w[far].abs()
        ulp = (torch.nextafter(wv, torch.full_like(wv, float("inf"))) - wv)
        near_eps += int(sens.sum())
        one_ulp += int(((~sens) & (d[far] <= ulp)).sum())
    share = beyond / total
    top = sorted(by_param.items(), key=lambda kv: -kv[1])[:4]
    _log(f"{OPT_TAG} (b) the merged, averaged grads after micro-step "
         f"{GM_K} (Adam's first moment) vs the batch-{TRAIN_BATCH} step's: "
         f"worst max|d| {rel:.3e} of the parameter's largest grad, in "
         f"{rel_at} (tol {GRAD_TOL:g}; "
         f"{len(noise)} grads rounding noise, below {GM_NOISE:g} of the "
         f"largest: {noise[:3]}..) -> {'FAIL' if bad else 'ok'}")
    _log(f"{OPT_TAG} (b) the parameters after micro-step {GM_K} vs one "
         f"Adam step at batch {TRAIN_BATCH} on the same rows: max|d| "
         f"{worst:.3e} (tol {GM_MAXD:g}), where the grad is noise "
         f"{worst_noise:.3e} (tol 2·lr = {2 * GM_LR:g}); {beyond} of {total} "
         f"elements "
         f"beyond 1e-7 ({share:.2e}, tol {GM_SHARE:g}): {near_eps} where "
         f"the grad sits near ε (the float64 step moves by > 5e-8 between "
         f"the two grads), {one_ulp} one ulp of the parameter, "
         f"{beyond - near_eps - one_ulp} neither; most in {top}")
    if bad or worst > GM_MAXD or worst_noise > 2 * GM_LR or \
            share > GM_SHARE:
        raise AssertionError(f"{OPT_TAG} (b) the merged step is not the "
                             f"batch-{TRAIN_BATCH} step: {bad[:3]}")


def _opt_mlp(make):
    """The MLP of the TPU package's optimizer tests
    (tests/test_backward_executor.py:12), ``make(fluid)`` minimizing its
    loss (an optimizer, or a callable that builds the update) →
    (main, startup, fetch list)."""
    from paddle_tpu_torch import fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[8], dtype="float32")
        label = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        extra = make(fluid, loss)
    startup.random_seed = main.random_seed = SEED
    return main, startup, [loss] + list(extra or [])


def _opt_small_feed(step):
    import numpy as np
    r = np.random.RandomState(SEED + 173 + step)
    return {"x": r.rand(64, 8).astype(np.float32),
            "y": r.randint(0, 4, (64, 1)).astype(np.int64)}


def _opt_small_case(book, what, make):
    """A small program on the card, SMALL_RUNS runs compiled (eager,
    capture, replays) and interpreted from one start: fetches and every
    persistable bitwise; and by the port on the CPU from the same start:
    fetches and persistables within SMALL_TOL."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import clip
    main, startup, fetch = _opt_mlp(make)
    clip._gradient_clip_attr = None  # set_gradient_clip's, once built
    exe, scope = _fresh(main, startup)
    iexe, iscope = _fresh(main, startup)
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    # the persistables and the step counter, so that a random op draws
    # the card's bits
    for n in [v.name for v in main.global_block().vars.values()
              if v.persistable] + ["@RNG_COUNTER@"]:
        if scope.find_var(n) is not None:
            cscope.var(n).set_value(fluid.LoDTensor(
                scope.find_var(n).value().array.cpu().clone()))
    seen = []
    for s in range(SMALL_RUNS):
        f = _opt_small_feed(s)
        before = _launch_counts()
        o = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        book.add(tuple(x - y for x, y in zip(_launch_counts(), before)))
        seen.append((exe._last_run_mode, exe._last_block.last_exec))
        io = _interpreted(iexe, main, f, fetch, iscope, (0,) * len(KERNELS),
                          book, f"{OPT_TAG} (c) {what} run {s}")
        c = cpu.run(main, feed=f, fetch_list=fetch, scope=cscope)
        for a, b, d in zip(o, io, c):
            if not np.array_equal(a, b):
                raise AssertionError(f"{OPT_TAG} (c) {what} run {s}: "
                                     f"compiled {a} vs interpreted {b}")
            if not np.allclose(a, d, rtol=SMALL_TOL[0], atol=SMALL_TOL[1]):
                raise AssertionError(f"{OPT_TAG} (c) {what} run {s}: card "
                                     f"{a} vs CPU {d}")
    if seen != [("compiled", e) for e in SMALL_EXECS]:
        raise AssertionError(f"{OPT_TAG} (c) {what}: ran {seen}")
    state = _persistables(scope, main)
    _same_state(f"(c) {what} compiled vs interpreted", state,
                _persistables(iscope, main), tag=OPT_TAG)
    worst = 0.0
    for n, t in state.items():
        c = cscope.find_var(n).value().array
        if t.is_floating_point():
            ok = torch.allclose(t.cpu(), c, rtol=SMALL_TOL[0],
                                atol=SMALL_TOL[1])
            worst = max(worst, float((t.cpu() - c).abs().max()))
        else:
            ok = torch.equal(t.cpu(), c)
        if not ok:
            raise AssertionError(f"{OPT_TAG} (c) {what}: {n} on the card "
                                 "disagrees with the CPU's")
    _log(f"{OPT_TAG} (c) {what}: {seen[-1][0]} {[e for _, e in seen]}, "
         f"bitwise the interpreter's; vs the CPU port max|d| {worst:.2e} "
         f"over {len(state)} persistables (rtol {SMALL_TOL[0]:g}, atol "
         f"{SMALL_TOL[1]:g}) -> ok")
    exe.close()
    iexe.close()
    return state


def _dpsgd_law(device="cuda"):
    """dpsgd's noise on the card, by its law: at a zero grad, lr 1 and
    batch 1 the op's step is the noise, sigma·clip·N(0, 1)."""
    import torch
    from paddle_tpu_torch.ops import rng
    from paddle_tpu_torch.ops.registry import OPS
    sigma, clip = 0.5, 2.0
    kern = OPS.get("dpsgd").kernel
    zs = []
    for seed in (1, 2):
        key = rng.fixed_key(seed, device)
        out = kern({"Param": [torch.zeros(DPSGD_N, device=device)],
                    "Grad": [torch.zeros(DPSGD_N, device=device)],
                    "LearningRate": [torch.ones(1, device=device)]},
                   {"clip": clip, "batch_size": 1.0, "sigma": sigma,
                    "_rng": lambda key=key: key})
        zs.append(-out["ParamOut"][0].double())
    std = sigma * clip
    mean, sd = float(zs[0].mean()), float(zs[0].std())
    ok = abs(mean) < 4 * std / DPSGD_N ** 0.5 and abs(sd / std - 1) < 0.01 \
        and not torch.equal(zs[0], zs[1])
    _log(f"{OPT_TAG} (c) dpsgd at sigma {sigma:g}, clip {clip:g} on the card: "
         f"the noise over {DPSGD_N} elements has mean {mean:.3e} (tol "
         f"{4 * std / DPSGD_N ** 0.5:.3e}) and std {sd:.5f} (want {std:g} "
         f"within 1 %); another key draws other noise -> "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{OPT_TAG} dpsgd's noise on the card")


def _opt_small(book):
    """(c) the small cases."""
    def opt(build):
        def make(f, loss):
            build(f).minimize(loss)
        return make
    O = "optimizer"
    cases = [
        ("LarsMomentum", opt(lambda f: getattr(f, O).LarsMomentum(
            0.1, momentum=0.9))),
        ("Adagrad", opt(lambda f: getattr(f, O).Adagrad(0.1))),
        ("Adamax", opt(lambda f: getattr(f, O).Adamax(0.1))),
        ("Dpsgd sigma 0", opt(lambda f: getattr(f, O).Dpsgd(
            0.01, clip=1.0, batch_size=32, sigma=0.0))),
        ("Dpsgd sigma 1", opt(lambda f: getattr(f, O).Dpsgd(
            0.01, clip=1.0, batch_size=32, sigma=1.0))),
        ("DecayedAdagrad", opt(lambda f: getattr(f, O).DecayedAdagrad(0.1))),
        ("Adadelta", opt(lambda f: getattr(f, O).Adadelta(0.1))),
        ("RMSProp centered", opt(lambda f: getattr(f, O).RMSProp(
            0.01, momentum=0.5, centered=True))),
        ("Ftrl", opt(lambda f: getattr(f, O).Ftrl(0.1, l1=1e-3, l2=1e-3))),
        ("Lamb", opt(lambda f: getattr(f, O).Lamb(
            0.01, exclude_from_weight_decay_fn=_no_decay))),
        ("DGCMomentum", opt(lambda f: getattr(f, O).DGCMomentum(
            0.1, momentum=0.9, rampup_begin_step=0))),
        ("Lookahead(SGD)", opt(lambda f: getattr(f, O).Lookahead(
            getattr(f, O).SGD(0.3), alpha=0.5, k=3))),
        ("GradientMerge k 1", opt(lambda f: getattr(f, O)
                                  .GradientMergeOptimizer(
                                      getattr(f, O).Adam(0.01), k_steps=1))),
        ("GradientClipByValue", opt(lambda f: getattr(f, O).Momentum(
            0.1, 0.9, grad_clip=f.clip.GradientClipByValue(0.05)))),
        ("GradientClipByNorm", opt(lambda f: getattr(f, O).Momentum(
            0.1, 0.9, grad_clip=f.clip.GradientClipByNorm(0.1)))),
        ("GradientClipByGlobalNorm", opt(lambda f: getattr(f, O).Adam(
            0.01, grad_clip=f.clip.GradientClipByGlobalNorm(0.1)))),
        ("L1Decay", opt(lambda f: getattr(f, O).Adam(
            0.01, regularization=f.regularizer.L1Decay(1e-3)))),
    ]

    def per_param(f, loss):
        params = f.default_main_program().all_parameters()
        f.clip.set_gradient_clip(f.clip.GradientClipByNorm(0.05),
                                 param_list=params[:2])
        f.optimizer.SGD(0.5).minimize(loss)

    def grads(f, loss):
        main = f.default_main_program()
        x, h = main.global_block().var("x"), main.global_block().var(
            main.global_block().ops[1].output("Out")[0])
        gx, gh = f.gradients([loss], [x, h])
        return [gx, gh]
    cases += [("set_gradient_clip(param_list=)", per_param),
              ("fluid.gradients", grads)]
    for what, make in cases:
        _opt_small_case(book, what, make)
    _dpsgd_law()
    return len(cases)


def phase_optimizers(train_p50):
    """Phase 17: the optimizer stack (the docstring's phase 17).
    ``train_p50``: the train phase's f32 step p50 of this call. → the
    launches of its runs: through the wrappers (warm-ups, captures, the
    interpreter) and on the card (every run)."""
    book = _CfBook()
    _reset_launch_counts()
    t0 = time.perf_counter()
    step_p50, adam_p50 = _opt_lamb(book, train_p50)
    gm_p50, plain_p50 = _opt_gm(book)
    n_small = _opt_small(book)
    wrapper = _launch_counts()
    _log(f"{OPT_TAG} phase 17 in {time.perf_counter() - t0:.1f} s: (a) step "
         f"p50 {step_p50:.3f} ms vs Adam's {adam_p50:.3f} (train "
         f"{train_p50:.3f}); (b) micro-step "
         f"{gm_p50:.3f} ms vs plain batch {GM_MICRO} {plain_p50:.3f}; (c) "
         f"{n_small} cases; launches through the wrappers {GATE_NAMES} "
         f"{wrapper}, on the card {tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed)}


# --------------------------------------------------------------------------
# 18. LoD sequences and the Dataset path
# --------------------------------------------------------------------------
LOD_TAG = "[lod]"
LOD_VOCAB = 5147              # paddle_tpu/dataset/imdb.py:13
LOD_BATCH = 32                # tests/test_book_extra.py:85
LOD_LR = 5e-2                 # tests/test_book_extra.py:74's Adagrad LR
LOD_STEPS = 50                # (a): ragged batches, a new LoD each
LOD_LOCK = 8                  # (a): of them compiled and interpreted in
#                               lock step from one start
LOD_FIXED_RUNS = 5            # (a): one batch: eager, capture, 3 replays
LOD_TIMED = 20                # (a): replays of the fixed batch timed
LOD_TOL = (1e-4, 1e-5)        # card vs CPU port losses, rtol and atol
#                               (tests/test_torch_optimizer_slice.py:51)
LOD_FIXED_EXECS = ("eager", "capture", "replay", "replay", "replay")
LOD_DEVICE = "cuda"
LOD_WD_BATCHES = 8            # (b): batches of WD_BATCH from slot files
LOD_WD_FILES = 4              # (b): one file a parser thread
LOD_WD_THREADS = 4
LOD_WD_WINDOW = 4             # (b): train_from_dataset(window_size=4)
LOD_REC_STEPS = 4             # (c): recommender steps, card vs CPU port


def _sentiment_batch(rng, batch=LOD_BATCH):
    """(flat word ids [T, 1], offsets, labels [batch, 1]) drawn as the
    synthetic IMDB reader draws a review (paddle_tpu/dataset/imdb.py
    ``_synthetic``): 8-119 base ids from the vocabulary and length // 6
    marker ids from the label's half of 10..109, shuffled."""
    import numpy as np
    seqs, labels = [], []
    for _ in range(batch):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 120))
        base = rng.randint(0, LOD_VOCAB, size=length)
        marker = rng.choice(np.arange(10, 60) if label == 0
                            else np.arange(60, 110), size=max(2, length // 6))
        ids = np.concatenate([base, marker])
        rng.shuffle(ids)
        seqs.append(ids)
        labels.append(label)
    offs = np.concatenate([[0], np.cumsum([len(x) for x in seqs])])
    return (np.concatenate(seqs).reshape(-1, 1).astype(np.int64),
            [int(o) for o in offs], np.array(labels, np.int64).reshape(-1, 1))


def _lod_feed(batch):
    import torch
    from paddle_tpu_torch import fluid
    words, offs, label = batch
    return {"words": fluid.LoDTensor(torch.from_numpy(words), [offs]),
            "label": label}


def _clone_scope(scope, names, device):
    """A scope holding ``names`` (and the step counter) copied from
    ``scope`` onto ``device``: a second run from the same start."""
    from paddle_tpu_torch import fluid
    out = fluid.Scope()
    for n in list(names) + ["@RNG_COUNTER@"]:
        v = scope.find_var(n)
        if v is not None and v.is_initialized():
            out.var(n).set_value(fluid.LoDTensor(
                v.value().array.detach().to(device).clone()))
    return out


def _lod_losses_agree(what, card, cpu):
    import numpy as np
    card, cpu = np.asarray(card), np.asarray(cpu)
    worst = float(np.max(np.abs(card - cpu)))
    ok = np.allclose(card, cpu, rtol=LOD_TOL[0], atol=LOD_TOL[1])
    _log(f"{LOD_TAG} {what}: {len(card)} losses on the card vs the CPU "
         f"port, max|d| {worst:.3e} (rtol {LOD_TOL[0]:g}, atol "
         f"{LOD_TOL[1]:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{LOD_TAG} {what}: card vs CPU losses")


def _lod_sentiment(book):
    """(a) The book's sentiment conv net on ragged batches. → a dict of
    its readings."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import book_extra
    with fluid.unique_name.guard():
        main, startup, _, loss, acc = book_extra.build_sentiment_program(
            LOD_VOCAB, lr=LOD_LR)
    startup.random_seed = main.random_seed = SEED
    names = [v.name for v in main.list_vars() if v.persistable]
    exe, scope = _fresh(main, startup)
    iexe = fluid.Executor(fluid.CUDAPlace(0))
    iscope = _clone_scope(scope, names, LOD_DEVICE)
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), _clone_scope(
        scope, names, "cpu")
    rng = np.random.RandomState(SEED + 18)
    ragged = [_sentiment_batch(rng) for _ in range(LOD_STEPS)]
    fixed = _sentiment_batch(rng)
    fetch = [loss, acc]
    card, host, kinds = [], [], []

    def cpu_step(feed):
        host.append(float(cpu.run(main, feed=feed, fetch_list=[loss],
                                  scope=cscope)[0].reshape(-1)[0]))

    for i in range(LOD_LOCK):
        feed = _lod_feed(ragged[i])
        out, *_ = _lock_step((exe, scope), (iexe, iscope), main, feed, fetch,
                             NO_KERNELS, book, f"(a) ragged step {i}",
                             LOD_TAG)
        card.append(float(out[0].reshape(-1)[0]))
        cpu_step(feed)
    for i in range(LOD_FIXED_RUNS):
        feed = _lod_feed(fixed)
        out, _, kind, _, _ = _lock_step(
            (exe, scope), (iexe, iscope), main, feed, fetch, NO_KERNELS,
            book, f"(a) fixed-LoD run {i}", LOD_TAG)
        kinds.append(kind)
        card.append(float(out[0].reshape(-1)[0]))
        cpu_step(feed)
    if tuple(kinds) != LOD_FIXED_EXECS:
        raise AssertionError(f"{LOD_TAG} (a) fixed-LoD runs: {kinds}")
    iexe.close()
    fixed_cb = exe._last_block
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated()]
    times = []
    for i in range(LOD_LOCK, LOD_STEPS):
        feed = _lod_feed(ragged[i])
        before = _launch_counts()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        times.append(time.perf_counter() - t)
        if _gate_run(exe, _delta(before), NO_KERNELS,
                     f"{LOD_TAG} (a) ragged step {i}") != "eager":
            raise AssertionError(f"{LOD_TAG} (a) a new LoD did not run "
                                 "eagerly")
        book.add(NO_KERNELS)
        card.append(float(out[0].reshape(-1)[0]))
        cpu_step(feed)
        if i == LOD_LOCK + 9:
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
    torch.cuda.synchronize()
    mem.append(torch.cuda.memory_allocated())
    _lod_losses_agree("(a) sentiment", card, host)
    ragged_losses = card[:LOD_LOCK] + card[LOD_LOCK + LOD_FIXED_RUNS:]
    first, last = np.mean(ragged_losses[:10]), np.mean(ragged_losses[-10:])
    if not last < first:
        raise AssertionError(f"{LOD_TAG} (a) the loss did not fall: "
                             f"{first:.4f} -> {last:.4f}")
    lod_keys = [k for k in exe._compiled_cache if k[-1]]
    eager = [exe._compiled_cache[k] for k in lod_keys
             if not exe._compiled_cache[k].stats["captures"]]
    consts = [t for st in eager[-1]._units for t in
              (st.attrs.get("_lodc") or {}).values()]
    const_bytes = sum(t.numel() * t.element_size() for t in consts)
    # a plan kept for every batch would add its constants every step:
    # the last steps may add no more than the kept plans hold
    if mem[2] - mem[1] > (fluid.Executor._LOD_PLANS_KEPT + 1) * const_bytes:
        raise AssertionError(f"{LOD_TAG} (a) device memory grew "
                             f"{mem[2] - mem[1]} B over the last "
                             f"{LOD_STEPS - LOD_LOCK - 10} ragged steps "
                             f"(a plan's LoD constants: {const_bytes} B)")
    # the captured plan's replays, timed
    feed = _lod_feed(fixed)
    rtimes = []
    for _ in range(LOD_TIMED):
        before = _launch_counts()
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        rtimes.append(time.perf_counter() - t)
        if _gate_run(exe, _delta(before), NO_KERNELS,
                     f"{LOD_TAG} (a) timed replay") != LOD_FIXED_EXECS[-1]:
            raise AssertionError(f"{LOD_TAG} (a) the fixed LoD's plan did "
                                 "not replay")
        book.add(NO_KERNELS)
    new_p50 = float(np.median(times)) * 1e3
    rep_p50 = float(np.median(rtimes)) * 1e3
    _log(f"{LOD_TAG} (a) sentiment conv net (vocab {LOD_VOCAB}, emb 32, hid "
         f"32, batch {LOD_BATCH}, Adagrad {LOD_LR:g}): {LOD_STEPS} ragged "
         f"steps, loss {first:.4f} -> {last:.4f} (mean of the first and "
         f"last 10), the first {LOD_LOCK} and {LOD_FIXED_RUNS} runs of one "
         f"fixed-LoD batch ({' '.join(kinds)}) bitwise the interpreter's; "
         f"step p50 {new_p50:.3f} ms with a new LoD (eager), "
         f"{rep_p50:.3f} ms replayed ({fixed_cb.stats['replays']} "
         f"replays); {len(lod_keys)} LoD plans cached "
         f"({len(eager)} never captured, kept "
         f"{fluid.Executor._LOD_PLANS_KEPT}), one holds {len(consts)} LoD "
         f"constants, {const_bytes} B on the card; device memory "
         f"{mem[0]} B before the {LOD_STEPS - LOD_LOCK} ragged steps, "
         f"{mem[1]} after 10, {mem[2]} after all "
         f"({mem[2] - mem[0]:+d} B) -> ok")
    exe.close()
    return {"new_lod_p50_ms": new_p50, "replay_p50_ms": rep_p50,
            "plans": len(lod_keys), "mem": mem, "const_bytes": const_bytes}


def _write_ctr_files(batches, root, n_files):
    """``batches`` (ctr_reader feeds) as slot files in the data feed's
    grammar: label, the 13 dense features, one id a slot; the batches
    dealt to ``n_files`` files in turn."""
    paths = [os.path.join(root, f"part-{k}.txt") for k in range(n_files)]
    outs = [open(p, "w") for p in paths]
    try:
        slots = sorted((k for k in batches[0] if k.startswith("slot_")),
                       key=lambda k: int(k[5:]))
        for j, b in enumerate(batches):
            f = outs[j % n_files]
            cols = [b[k][:, 0] for k in slots]
            for i in range(len(b["label"])):
                f.write(" ".join(
                    ["1", str(int(b["label"][i, 0])),
                     str(b["dense"].shape[1])]
                    + [repr(float(v)) for v in b["dense"][i]]
                    + [f"1 {int(c[i])}" for c in cols]) + "\n")
    finally:
        for f in outs:
            f.close()
    return paths


def _lod_wide_deep(book):
    """(b) Wide&Deep at the lane's widths from slot files through
    train_from_dataset, against the same batches fed dense."""
    import io
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss, auc = _wd_program(WD_SPARSE_DIM)
    block = main.global_block()
    slots = sorted((v.name for v in block.vars.values()
                    if v.name.startswith("slot_")), key=lambda n: int(n[5:]))
    use = [block.var(n) for n in ["label", "dense"] + slots]
    root = tempfile.mkdtemp(prefix="lod_wd_")
    try:
        files = _write_ctr_files(_wd_batches(LOD_WD_BATCHES, WD_SPARSE_DIM),
                                 root, LOD_WD_FILES)
        t = time.perf_counter()
        ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(WD_BATCH)
        ds.set_thread(LOD_WD_THREADS)
        ds.set_filelist(files)
        ds.set_use_var(use)
        ds.load_into_memory()
        ds.local_shuffle(SEED)
        parse_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want_lod = [list(range(WD_BATCH + 1))]
    dense = []
    for f in ds._iter_batches():
        bad = [n for n in f if n != "dense" and f[n].lod() != want_lod]
        if bad or f["dense"].lod():
            raise AssertionError(f"{LOD_TAG} (b) LoDs of {bad[:3]}")
        dense.append({n: t.array.numpy() for n, t in f.items()})
    if len(dense) != LOD_WD_BATCHES:
        raise AssertionError(f"{LOD_TAG} (b) {len(dense)} batches")

    def gate(exe, what):
        cb = exe._last_block
        graph = tuple(cb.graph_launches.get(k, 0) for k in KERNELS)
        if exe._last_run_mode != "segmented" or graph != NO_KERNELS:
            raise AssertionError(f"{LOD_TAG} (b) {what}: ran "
                                 f"{exe._last_run_mode}, graphs {graph}")
        return cb

    # the oracle: the same batches fed dense through Executor.run, two
    # passes (the first warms up and captures; the second, all replays,
    # is timed)
    exe, scope = _fresh(main, startup)
    want_lines, dense_s = [], []
    for _ in range(2):
        before = _launch_counts()
        t = time.perf_counter()
        for i, f in enumerate(dense):
            lv, av = exe.run(main, feed=f, fetch_list=[loss, auc],
                             scope=scope)
            want_lines.append(f"[train_from_dataset] step {i}: "
                              f"loss={lv.reshape(-1)[-1]:.6f}, "
                              f"auc={av.reshape(-1)[-1]:.6f}")
        dense_s.append(time.perf_counter() - t)
        book.add(_delta(before))
    cb = gate(exe, "dense feeds")
    want_exec = cb.last_exec
    want_state = _persistables(scope, main)
    _drop(exe)
    del scope
    runs = {}
    for window in (1, LOD_WD_WINDOW):
        exe, scope = _fresh(main, startup)
        out = io.StringIO()
        secs = []
        for _ in range(2):
            before = _launch_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                exe.train_from_dataset(main, ds, scope=scope,
                                       fetch_list=[loss, auc],
                                       fetch_info=["loss", "auc"],
                                       print_period=1, window_size=window)
            secs.append(time.perf_counter() - t)
            book.add(_delta(before))
        cb = gate(exe, f"train_from_dataset(window_size={window})")
        lines = out.getvalue().splitlines()
        if lines != want_lines or cb.last_exec != want_exec:
            raise AssertionError(
                f"{LOD_TAG} (b) window_size={window}: printed {lines[:2]} "
                f"({cb.last_exec}), want {want_lines[:2]} ({want_exec})")
        _same_state(f"(b) train_from_dataset(window_size={window}) vs dense "
                    "Executor.run", _persistables(scope, main), want_state,
                    tag=LOD_TAG)
        runs[window] = (secs, dict(cb.stats))
        _drop(exe)
        del scope
    n = LOD_WD_BATCHES * WD_BATCH
    sps, dense_sps = n / runs[1][0][1], n / dense_s[1]
    _log(f"{LOD_TAG} (b) Wide&Deep ({WD_SPARSE_DIM} ids a slot, batch "
         f"{WD_BATCH}): {LOD_WD_BATCHES} batches from {LOD_WD_FILES} slot "
         f"files, parsed and shuffled on {LOD_WD_THREADS} threads in "
         f"{parse_s:.3f} s; every slot and the label LoD [0..{WD_BATCH}]; "
         f"two passes of train_from_dataset (segmented, "
         f"{runs[1][1]['captures']} captures, {runs[1][1]['replays']} "
         f"replays) and of window_size={LOD_WD_WINDOW} printed the dense "
         f"loop's {len(want_lines)} lines and left its persistables "
         f"bitwise; the second pass (all replays) {sps:.1f} samples/s from "
         f"the dataset vs {dense_sps:.1f} from the Executor.run loop (the "
         f"first {n / runs[1][0][0]:.1f} vs {n / dense_s[0]:.1f}) -> ok")
    return {"parse_s": parse_s, "samples_s": sps, "dense_samples_s": dense_sps}


def _lod_op_cases():
    """(op, inputs, attrs, LoDs, grad) of the small cases phase 18 (c)
    runs on the card and the CPU: each sequence op, sequence_mask and
    cos_sim, over a LoD with an empty sequence."""
    import numpy as np
    r = np.random.RandomState(SEED)
    lod = ((0, 3, 3, 7, 8),)

    def x(*shape):
        return r.normal(size=shape).astype(np.float32)
    ids = r.randint(1, 9, (8, 1)).astype(np.int64)
    cases = [("sequence_pool", {"X": [x(8, 3)]},
              {"pooltype": p, "pad_value": 0.5}, {"X": [lod]}, True)
             for p in ("SUM", "AVERAGE", "SQRT", "MAX", "FIRST", "LAST")]
    cases += [
        ("sequence_softmax", {"X": [x(8, 1)]}, {}, {"X": [lod]}, True),
        ("sequence_expand", {"X": [x(4, 2)], "Y": [x(8, 1)]},
         {"ref_level": -1}, {"X": [None], "Y": [lod]}, True),
        ("sequence_expand_as", {"X": [x(4, 2)], "Y": [x(8, 1)]}, {},
         {"X": [None], "Y": [lod]}, True),
        ("sequence_concat", {"X": [x(8, 2), x(5, 2)]}, {},
         {"X": [lod, ((0, 0, 2, 4, 5),)]}, True),
        ("sequence_conv", {"X": [x(8, 3)], "Filter": [x(9, 4)]},
         {"contextLength": 3, "contextStart": -1}, {"X": [lod]}, True),
        ("sequence_pad", {"X": [x(8, 3)],
                          "PadValue": [np.array([0.25], np.float32)]},
         {"padded_length": 6}, {"X": [lod], "PadValue": [None]}, True),
        ("sequence_unpad", {"X": [x(4, 5, 3)],
                            "Length": [np.array([2, 0, 5, 1], np.int64)]},
         {}, {"X": [None], "Length": [None]}, True),
        ("sequence_reshape", {"X": [x(8, 4)]}, {"new_dim": 2},
         {"X": [lod]}, True),
        ("sequence_reverse", {"X": [x(8, 3)]}, {}, {"X": [lod]}, True),
        ("sequence_slice", {"X": [x(8, 3)],
                            "Offset": [np.array([[1], [0], [0], [0]])],
                            "Length": [np.array([[2], [0], [3], [1]])]},
         {}, {"X": [lod], "Offset": [None], "Length": [None]}, True),
        ("sequence_scatter", {"X": [x(4, 6)], "Ids": [np.array(
            [[1], [4], [0], [0], [5], [2]], np.int64)],
            "Updates": [x(6, 1)]}, {},
         {"X": [None], "Ids": [((0, 2, 2, 5, 6),)], "Updates": [None]},
         True),
        ("sequence_enumerate", {"X": [ids]}, {"win_size": 3},
         {"X": [lod]}, False),
        ("sequence_erase", {"X": [ids]}, {"tokens": [2, 5]}, {"X": [lod]},
         False),
        ("lod_reset", {"X": [x(8, 2)]}, {"target_lod": [0, 4, 8]},
         {"X": [lod]}, True),
        ("lod_append", {"X": [x(8, 2)]}, {"level": [0, 2, 3, 5, 8]},
         {"X": [((0, 1, 4),)]}, True),
        ("im2sequence", {"X": [x(2, 3, 5, 5)]},
         {"kernels": [2, 2], "strides": [1, 2], "paddings": [1, 0, 0, 1]},
         {"X": [None]}, True),
        ("sequence_mask", {"X": [np.array([3, 0, 5], np.int64)]},
         {"maxlen": 6}, {"X": [None]}, False),
        ("cos_sim", {"X": [x(4, 5)], "Y": [x(4, 5)]}, {},
         {"X": [None], "Y": [None]}, True),
    ]
    return cases


def _lod_op_on(device, op, ins, attrs, lods, grad):
    """The op's kernel (and its generic grad under seeded output grads) on
    ``device`` → {slot: tensor on the host}, the declared LoD."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.registry import OPS, run_generic_grad
    info = OPS.get(op)
    a = dict(info.attr_defaults, **attrs, _lod=lods)
    t_ins = {s: [torch.from_numpy(np.asarray(v)).to(device) for v in vs]
             for s, vs in ins.items()}
    outs = info.kernel(t_ins, a)
    lod = outs.pop("_lod", None)
    got = {s: v[0].detach().cpu() for s, v in outs.items()}
    if grad:
        r = np.random.RandomState(SEED + 7)
        for s, v in list(outs.items()):
            if v[0].is_floating_point():
                t_ins[s + "@GRAD"] = [torch.from_numpy(r.normal(
                    size=tuple(v[0].shape)).astype(np.float32)).to(device)]
        slots = list(ins)
        g = run_generic_grad(op, t_ins, a, [s + "@GRAD" for s in slots],
                             slots)
        for s, vs in g.items():
            for j, v in enumerate(vs):
                if v is not None:
                    got[f"{s}[{j}]"] = v.detach().cpu()
    return got, lod


def _lod_ops(book):
    """(c) Each sequence op, sequence_mask and cos_sim, forward and grad,
    card against CPU port; then the recommender, card against CPU port."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import book_extra
    before = _launch_counts()
    worst, n = 0.0, 0
    cases = _lod_op_cases()
    for op, ins, attrs, lods, grad in cases:
        card, clod = _lod_op_on(LOD_DEVICE, op, ins, attrs, lods, grad)
        host, hlod = _lod_op_on("cpu", op, ins, attrs, lods, grad)
        if clod != hlod or sorted(card) != sorted(host):
            raise AssertionError(f"{LOD_TAG} (c) {op}: LoD {clod} vs {hlod}"
                                 f", outputs {sorted(card)} vs "
                                 f"{sorted(host)}")
        for k in host:
            c, h = card[k], host[k]
            if h.is_floating_point():
                ok = torch.allclose(c, h, rtol=SMALL_TOL[0],
                                    atol=SMALL_TOL[1])
                if h.numel():
                    worst = max(worst, float((c - h).abs().max()))
            else:
                ok = torch.equal(c, h)
            if not ok:
                raise AssertionError(f"{LOD_TAG} (c) {op} {k}: card vs CPU")
            n += 1
    if _delta(before) != NO_KERNELS:
        raise AssertionError(f"{LOD_TAG} (c) the ops launched kernels")
    with fluid.unique_name.guard():
        main, startup, feeds, loss = book_extra.build_recommender_program(
            50, 40)
    startup.random_seed = main.random_seed = SEED
    names = [v.name for v in main.list_vars() if v.persistable]
    exe, scope = _fresh(main, startup)
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), _clone_scope(
        scope, names, "cpu")
    r = np.random.RandomState(SEED + 3)
    card, host = [], []
    for _ in range(LOD_REC_STEPS):
        def ids(hi):
            return r.randint(0, hi, (LOD_BATCH, 1)).astype(np.int64)

        def ragged(hi, lo_len, hi_len):
            lens = r.randint(lo_len, hi_len, LOD_BATCH)
            offs = [int(o) for o in np.concatenate([[0], np.cumsum(lens)])]
            return fluid.LoDTensor(torch.from_numpy(r.randint(
                0, hi, (offs[-1], 1)).astype(np.int64)), [offs])
        feed = {"user_id": ids(51), "gender_id": ids(2), "age_id": ids(7),
                "job_id": ids(21), "movie_id": ids(41),
                "category_id": ragged(18, 1, 4),
                "movie_title": ragged(1000, 0, 6),
                "score": r.uniform(1, 5, (LOD_BATCH, 1)).astype(np.float32)}
        before = _launch_counts()
        card.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0].reshape(-1)[0]))
        _gate_run(exe, _delta(before), NO_KERNELS, f"{LOD_TAG} (c) "
                  "recommender step")
        book.add(NO_KERNELS)
        host.append(float(cpu.run(main, feed=feed, fetch_list=[loss],
                                  scope=cscope)[0].reshape(-1)[0]))
    _lod_losses_agree("(c) recommender", card, host)
    _log(f"{LOD_TAG} (c) {len(cases)} cases of the sequence ops, "
         f"sequence_mask and cos_sim, {n} outputs and grads on the card vs "
         f"the CPU port, max|d| {worst:.2e} (rtol {SMALL_TOL[0]:g}, atol "
         f"{SMALL_TOL[1]:g}); {LOD_REC_STEPS} recommender steps -> ok")
    exe.close()


def phase_lod():
    """Phase 18: LoD sequences and the Dataset path (the docstring's phase
    18). → the launches of its runs: through the wrappers and on the
    card, both held to zero."""
    book = _CfBook()
    _reset_launch_counts()
    t0 = time.perf_counter()
    a = _lod_sentiment(book)
    b = _lod_wide_deep(book)
    _lod_ops(book)
    wrapper = _launch_counts()
    if wrapper != NO_KERNELS or tuple(book.executed) != NO_KERNELS:
        raise AssertionError(f"{LOD_TAG} phase 18 launched {wrapper} through "
                             f"the wrappers, {tuple(book.executed)} on the "
                             "card; want none")
    _log(f"{LOD_TAG} phase 18 in {time.perf_counter() - t0:.1f} s: (a) "
         f"new-LoD step p50 {a['new_lod_p50_ms']:.3f} ms, replayed "
         f"{a['replay_p50_ms']:.3f} ms; (b) {b['samples_s']:.1f} samples/s "
         f"from the dataset vs {b['dense_samples_s']:.1f} dense, parse "
         f"{b['parse_s']:.3f} s; launches through the wrappers {GATE_NAMES} "
         f"{wrapper}, on the card {tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed)}


CP_TAG = "[compiler]"
CP_RESNET_BATCH = 64          # bench.py's resnet lane batch, f32 here
CP_IMAGE = 224                # ImageNet's 224x224 crops, 1000 classes
CP_RESNET_LR = RESNET_FALL_LR  # where the f32 loss falls (bench.py's 0.1
                               # rings at batch 64)
CP_RESNET_STEPS = 3           # eager, capture, replay
CP_EVAL_BATCHES = 4           # eval batches accumulated by Accuracy
CP_BERT_STEPS = 3             # eager, capture, replay
# the census of the fuse passes on the ResNet-50 programs (stem and 16
# bottlenecks: 1 + 2·16 batch_norm + relu, 16 residual add + relu), the
# TPU package's passes' on the same programs in
# tests/test_torch_compiler.py; in the train program the grad ops read
# every intermediate and nothing fuses
CP_RESNET_CENSUS = {
    "train": {"fused_batch_norm_act": 0, "fused_elemwise_activation": 0,
              "batch_norm": 53, "relu": 49},
    "eval": {"fused_batch_norm_act": 33, "fused_elemwise_activation": 16,
             "batch_norm": 20, "relu": 0}}
CP_FUSED_TOL = RESNET_PRED_TOL  # fused vs unfused eval logits, (rtol, atol)
LONGCTX_WANT = (0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0)  # a longctx fwd+bwd
LONGCTX_BOUND_MS = 0.365      # bench.py's 360.8 GFLOP at 989 TFLOP/s
LONGCTX_BLOCK = 128           # rows of a tile, queries or keys
# the streamed kernels against their f32 plain versions at the longctx
# shape: lse by max|d|, each bf16 output by max|d| in a tile's rows of one
# head over that tile's max|plain| (one bf16 ulp is 2^-8 to 2^-7 of it).
# A plain version with one tile of the causal grid left out must fail
# each (_longctx_skip_tile)
LONGCTX_TOL = {"O": 2e-2, "lse": 1e-4, "dQ": 2e-2, "dK": 2e-2, "dV": 2e-2}
MP_BATCH, MP_BATCHES, MP_K = 64, 64, 8  # bench.py's mnist_realdata lane


def _cp_census(program):
    types = [op.type for op in program.global_block().ops]
    return {t: types.count(t) for t in CP_RESNET_CENSUS["train"]}


def _cp_resnet_programs():
    """models/resnet.py's ResNet-50 train step as PaddleCV's script builds
    it: the eval clone taken before Momentum → (main, startup, test,
    [loss, acc, logits])."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("image", shape=[3, CP_IMAGE, CP_IMAGE],
                         dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        pred = resnet.resnet(img, 1000, 50)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        acc = fluid.layers.accuracy(pred, label)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(CP_RESNET_LR, momentum=0.9).minimize(loss)
    startup.random_seed = main.random_seed = test.random_seed = SEED
    return main, startup, test, [loss.name, acc.name, pred.name]


def _cp_fuse_strategy():
    from paddle_tpu_torch import fluid
    bs = fluid.BuildStrategy()
    bs.fuse_bn_act_ops = True
    bs.fuse_elewise_add_act_ops = True
    return bs


def _cp_same(what, a, b):
    import numpy as np
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if not np.array_equal(u, v):
                raise AssertionError(f"{CP_TAG} {what}: run {i} fetch {j} "
                                     "differs")
    _log(f"{CP_TAG} {what}: {len(a)} runs, every fetch bitwise equal")


def _cp_resnet(book):
    """(a) ResNet-50 at batch 64 under CompiledProgram with BuildStrategy's
    fuse passes, its eval clone with share_vars_from and
    fluid.metrics.Accuracy."""
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    main, startup, test, fetch = _cp_resnet_programs()
    rng = np.random.RandomState(SEED + 19)

    def batch():
        return {"image": rng.rand(CP_RESNET_BATCH, 3, CP_IMAGE,
                                  CP_IMAGE).astype("float32"),
                "label": rng.randint(0, 1000, (CP_RESNET_BATCH, 1))
                .astype("int64")}
    feeds = [batch() for _ in range(CP_RESNET_STEPS)]
    evals = [batch() for _ in range(CP_EVAL_BATCHES)]
    names = [v.name for v in main.list_vars() if v.persistable]
    exe0, scope0 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe0.run(startup, scope=scope0)
    init = _clone_scope(scope0, names, "cuda")
    exe0.close()
    del exe0, scope0
    runs = {}
    for how in ("plain", "compiled", "fused"):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = _clone_scope(init, names, "cuda")
        if how == "plain":
            prog = main
        else:
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=fetch[0],
                build_strategy=_cp_fuse_strategy() if how == "fused"
                else None)
        t0 = time.perf_counter()
        out, modes = [], collections.Counter()
        times, losses = _train_steps(exe, prog, fetch[:2], scope, feeds,
                                     NO_KERNELS, modes,
                                     f"{CP_TAG} ResNet-50 {how}", book,
                                     outs=out)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[how] = (out, exe, scope, prog)
        _log(f"{CP_TAG} ResNet-50 batch {CP_RESNET_BATCH} f32, Momentum "
             f"{CP_RESNET_LR}, {how}: {CP_RESNET_STEPS} compiled steps "
             f"{dict(modes)} in {dt:.2f} s (ms a run " + ", ".join(
                 f"{t * 1e3:.1f}" for t in times) + "), losses " +
             " ".join(f"{x:.4f}" for x in losses))
        if how != "fused":
            exe.close()
    _cp_same("ResNet-50 CompiledProgram.with_data_parallel (no build "
             "strategy) vs Executor.run", runs["compiled"][0],
             runs["plain"][0])
    # nothing fuses in the train program, so the fused strategy's step is
    # the plain one
    _cp_same("ResNet-50 with fuse_bn_act_ops and fuse_elewise_add_act_ops "
             "vs Executor.run", runs["fused"][0], runs["plain"][0])
    _, exe, scope, train = runs["fused"]
    census = {"train": _cp_census(train._program)}
    ev = fluid.CompiledProgram(test.clone()).with_data_parallel(
        share_vars_from=train, build_strategy=_cp_fuse_strategy())
    metric = fluid.metrics.Accuracy()
    fused, modes = [], collections.Counter()
    t0 = time.perf_counter()
    # no scope: the eval program reads the trained program's
    _train_steps(exe, ev, fetch, None, evals, NO_KERNELS, modes,
                 f"{CP_TAG} fused eval", outs=fused, segmented=True)
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    for got in fused:
        metric.update(got[1], CP_RESNET_BATCH)
    census["eval"] = _cp_census(ev._program)
    if census != CP_RESNET_CENSUS:
        raise AssertionError(f"{CP_TAG} fused census {census}, the TPU "
                             f"package's passes give {CP_RESNET_CENSUS}")
    _log(f"{CP_TAG} fused-op census, train {census['train']}, eval "
         f"{census['eval']}: the TPU package's on the same programs")
    # the stateful fused_batch_norm_act is an island: compiled segments
    # (a CUDA graph each) around 33 islands
    if modes != {"segmented": CP_EVAL_BATCHES}:
        raise AssertionError(f"{CP_TAG} fused eval runs {dict(modes)}")
    segs = exe._last_block.segments
    n_islands = sum(s.kind == "island" for s in segs)
    t0 = time.perf_counter()
    plain = [exe.run(test, feed=f, fetch_list=fetch, scope=scope)
             for f in evals]
    plain_s = time.perf_counter() - t0
    if exe._last_run_mode != "compiled":
        raise AssertionError(f"{CP_TAG} unfused eval ran "
                             f"{exe._last_run_mode}")
    worst, bitwise = 0.0, True
    for got, ref in zip(fused, plain):
        a, b = got[2], ref[2]
        bitwise &= bool(np.array_equal(a, b))
        worst = max(worst, float(np.abs(a - b).max()))
        if not np.allclose(a, b, rtol=CP_FUSED_TOL[0], atol=CP_FUSED_TOL[1]):
            raise AssertionError(f"{CP_TAG} fused eval logits off the "
                                 f"unfused ones by {worst:.3e}")
    # a replayed batch of each, host clock, 3 runs
    def per_batch(prog, **kw):
        t = time.perf_counter()
        for _ in range(3):
            exe.run(prog, feed=evals[-1], fetch_list=fetch, **kw)
        return (time.perf_counter() - t) / 3 * 1e3
    fused_ms, plain_ms = per_batch(ev), per_batch(test, scope=scope)
    accs = [float(g[1].reshape(-1)[0]) for g in fused]
    mean = sum(a * CP_RESNET_BATCH for a in accs) / (
        CP_RESNET_BATCH * len(accs))
    if metric.eval() != mean:
        raise AssertionError(f"{CP_TAG} Accuracy.eval() {metric.eval()} vs "
                             f"the weighted mean {mean}")
    # allow_mixed_compilation=False pins the mixed block to the interpreter
    es = fluid.ExecutionStrategy()
    es.allow_mixed_compilation = False
    pinned = fluid.CompiledProgram(test.clone()).with_data_parallel(
        share_vars_from=train, build_strategy=_cp_fuse_strategy(),
        exec_strategy=es)
    before = _launch_counts()
    got = exe.run(pinned, feed=evals[0], fetch_list=fetch)
    if exe._last_run_mode != "interpreted" or _delta(before) != NO_KERNELS:
        raise AssertionError(f"{CP_TAG} allow_mixed_compilation=False ran "
                             f"{exe._last_run_mode}")
    _cp_same("fused eval, allow_mixed_compilation=False (interpreted) vs "
             "segmented", [got], fused[:1])
    _log(f"{CP_TAG} eval (the test clone, share_vars_from the trained "
         f"program): {CP_EVAL_BATCHES} batches of {CP_RESNET_BATCH} in "
         f"{ev_s:.3f} s, runs {dict(modes)} ({len(segs)} segments, {n_islands} "
         f"islands; the unfused eval program, compiled whole, "
         f"{plain_s:.3f} s, each with its eager run and capture); a "
         f"replayed batch {fused_ms:.2f} ms fused (segmented), "
         f"{plain_ms:.2f} ms unfused (one graph); logits fused vs "
         f"unfused " +
         ("bitwise equal" if bitwise else f"max|d| {worst:.3e}") +
         f" (tol rtol {CP_FUSED_TOL[0]:g} atol {CP_FUSED_TOL[1]:g}); "
         f"Accuracy.eval() {metric.eval():.6f} = the sample-weighted mean "
         f"of the batches' {accs}")
    exe.close()
    return {"census": census, "bitwise_logits": bitwise}


def _cp_bert(book):
    """(b) The BERT-base f32 pretraining step at batch 32 through
    CompiledProgram.with_data_parallel(loss_name) with
    ExecutionStrategy(), against Executor.run from the same parameters;
    with allow_mixed_compilation=False; through the interpreter."""
    import collections
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    want = _step_want(main.global_block().ops, _attention_route(main))
    if want != TRAIN_STEP_WANT:
        raise AssertionError(f"{CP_TAG} BERT step wants {want}")
    rng = np.random.RandomState(SEED + 20)
    feeds = [_train_batch(rng, TRAIN_BATCH, cfg)
             for _ in range(CP_BERT_STEPS)]
    names = [v.name for v in main.list_vars() if v.persistable]
    exe0, scope0 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe0.run(startup, scope=scope0)
    init = _clone_scope(scope0, names, "cuda")
    exe0.close()
    del exe0, scope0
    es_pinned = fluid.ExecutionStrategy()
    es_pinned.allow_mixed_compilation = False
    results, state = {}, {}
    for how in ("plain", "compiled", "pinned", "interpreted"):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = _clone_scope(init, names, "cuda")
        prog = main if how == "plain" else \
            fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name,
                exec_strategy=es_pinned if how == "pinned"
                else fluid.ExecutionStrategy())
        if how == "interpreted":
            out = [_interpreted(exe, prog, f, [loss], scope, want, book,
                                f"{CP_TAG} BERT-base interpreted")
                   for f in feeds]
            modes, times = {"interpreted": len(out)}, []
        else:
            out, modes = [], collections.Counter()
            times, _ = _train_steps(exe, prog, loss, scope, feeds, want,
                                    modes, f"{CP_TAG} BERT-base {how}",
                                    book, outs=out)
        results[how] = out
        state[how] = _persistables(scope, main)
        _log(f"{CP_TAG} BERT-base f32 step batch {TRAIN_BATCH}, {how}: "
             f"runs {dict(modes)} (ms a run " + ", ".join(
                 f"{t * 1e3:.1f}" for t in times) + "), losses " +
             " ".join(f"{float(o[0].reshape(-1)[0]):.6f}" for o in out))
        if how == "compiled":
            # two more replays, the second in a trace (the first in its
            # warm-up cycle, ROADMAP C2): the card ran the step's kernels
            def replay():
                exe.run(prog, feed=feeds[-1], fetch_list=[loss],
                        scope=scope)
            _check_trace(_device_kernel_counts(replay, warm=replay), want,
                         "BERT-base step through CompiledProgram")
            book.add(want, 2)
        exe.close()
    for how in ("compiled", "pinned", "interpreted"):
        _cp_same(f"BERT-base {how} vs Executor.run", results[how],
                 results["plain"])
        _same_state(f"BERT-base {how} vs Executor.run after "
                    f"{CP_BERT_STEPS} steps", state[how], state["plain"],
                    tag=CP_TAG)
    return results


def _longctx_errs(got, want):
    """Each longctx output of ``got`` against ``want`` (dicts keyed as
    LONGCTX_TOL) → {name: (its measure against LONGCTX_TOL, max|d|)}:
    lse by max|d|; O, dQ, dK and dV, each [B, H, S, D], by the largest
    max|d| over max|want| of a tile of LONGCTX_BLOCK rows of one head."""
    out = {}
    for n, w in want.items():
        d = (got[n].float() - w.float()).abs()
        if n == "lse":
            out[n] = (d.max().item(), d.max().item())
            continue
        tiles = (*w.shape[:2], w.shape[2] // LONGCTX_BLOCK, -1)
        scale = w.float().abs().reshape(tiles).amax(-1).clamp_min(1e-30)
        out[n] = ((d.reshape(tiles).amax(-1) / scale).max().item(),
                  d.max().item())
    return out


def _longctx_skip_tile(q, k, v, do, sm, o, lse, dq, dk, dv, qt, kt):
    """The plain outputs (o, lse, dq, dk, dv) of causal attention with the
    scores of query tile ``qt`` on key tile ``kt`` < ``qt`` left out, as
    kernels whose causal skip drops one tile more would give them: that
    tile's share of each row's softmax taken out of O and lse, and its
    terms out of dQ (those rows) and dK, dV (those keys), with the
    forward's lse and delta, as the backward kernels read them."""
    import torch
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    B, H = q.shape[:2]
    qi = slice(qt * LONGCTX_BLOCK, (qt + 1) * LONGCTX_BLOCK)
    kj = slice(kt * LONGCTX_BLOCK, (kt + 1) * LONGCTX_BLOCK)
    qf, dof = q[:, :, qi].float(), do[:, :, qi].float()
    kf, vf = k[:, :, kj].float(), v[:, :, kj].float()
    lq = lse.reshape(B, H, -1)[:, :, qi, None]
    p = torch.exp(qf @ kf.transpose(-1, -2) * sm - lq)
    rest = 1 - p.sum(-1, keepdim=True)
    o2, lse2, dq2, dk2, dv2 = (t.clone() for t in (o, lse, dq, dk, dv))
    o2[:, :, qi] = ((o[:, :, qi].float() - p @ vf) / rest).to(o.dtype)
    lse2.reshape(B, H, -1)[:, :, qi] = (lq + torch.log(rest))[..., 0]
    delta = fa.bwd_delta(o, do).reshape(B, H, -1)[:, :, qi, None]
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * sm
    dq2[:, :, qi] = (dq[:, :, qi].float() - ds @ kf).to(dq.dtype)
    dk2[:, :, kj] = (dk[:, :, kj].float()
                     - ds.transpose(-1, -2) @ qf).to(dk.dtype)
    dv2[:, :, kj] = (dv[:, :, kj].float()
                     - p.transpose(-1, -2) @ dof).to(dv.dtype)
    return o2, lse2, dq2, dk2, dv2


def _cp_longctx(fwd_rows, bwd_rows):
    """(c)'s comparisons and timings: the streamed kernels at the longctx
    shape against their plain versions, twice and bitwise alike, each
    timed beside its bound, its plain version and SDPA. Launches here are
    comparisons: the caller resets the counts after."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    shape = bench.LONGCTX
    B_, H_, S_, D_ = (shape[k] for k in ("batch", "heads", "seq_len",
                                         "head_dim"))
    q, k, v = bench.longctx_inputs(device=torch.device("cuda", 0), **shape)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8192)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    sm = 1.0 / D_ ** 0.5
    tail = (sm, True, 0.0, None, None)
    if fa.fwd_route(q.shape, k.shape, q.dtype) != "streamed":
        raise AssertionError(f"{CP_TAG} longctx does not take the streamed "
                             "kernels")
    what = f"bfloat16 B={B_} H={H_} S={S_} D={D_} causal no bias"
    o, lse = fa.flash_attention_fwd_streamed_cuda(q, k, v, *tail)
    o2, lse2 = fa.flash_attention_fwd_streamed_cuda(q, k, v, *tail)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{CP_TAG} streamed forward at {what}: two "
                             "runs differ")
    ref = fa.flash_attention_reference(q, k, v, *tail)
    dq, stats = fa.flash_attention_bwd_dq_streamed_cuda(q, k, v, o, lse, do,
                                                        *tail)
    dk, dv = fa.flash_attention_bwd_dkdv_streamed_cuda(q, k, v, do, stats,
                                                       *tail)
    dq2, stats2 = fa.flash_attention_bwd_dq_streamed_cuda(q, k, v, o, lse,
                                                          do, *tail)
    dk2, dv2 = fa.flash_attention_bwd_dkdv_streamed_cuda(q, k, v, do, stats2,
                                                         *tail)
    if not all(torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2),
                                              (dv, dv2))):
        raise AssertionError(f"{CP_TAG} streamed backward at {what}: two "
                             "runs differ")
    delta = fa.bwd_delta(o, do)
    want_q = fa.flash_attention_bwd_q_reference(q, k, v, do, lse, delta,
                                                *tail)
    want_kv = fa.flash_attention_bwd_kv_reference(q, k, v, do, lse, delta,
                                                  *tail)
    want = dict(zip(LONGCTX_TOL, (*ref, want_q, *want_kv)))
    errs = _longctx_errs(dict(zip(LONGCTX_TOL, (o, lse, dq, dk, dv))),
                         want)
    qt = S_ // LONGCTX_BLOCK - 1
    planted = _longctx_errs(dict(zip(LONGCTX_TOL, _longctx_skip_tile(
        q, k, v, do, sm, *want.values(), qt, qt // 2))), want)
    _log(f"[kernel] longctx {what} (twice, bitwise alike) against the plain "
         f"versions: " + ", ".join(
             f"{n} {errs[n][0]:.3e} (max|d| {errs[n][1]:.3e})"
             for n in LONGCTX_TOL) + f"; with query tile {qt}'s scores on "
         f"key tile {qt // 2} left out of the plain versions: " +
         ", ".join(f"{n} {planted[n][0]:.3e}" for n in LONGCTX_TOL) +
         "; limits " + ", ".join(f"{n} {t:g}" for n, t in
                                 LONGCTX_TOL.items()))
    for n, t in LONGCTX_TOL.items():
        if not errs[n][0] <= t:
            raise AssertionError(f"{CP_TAG} streamed {n} at {what}: "
                                 f"{errs[n][0]:.3e} off its plain version, "
                                 f"limit {t:g}")
        if not planted[n][0] > t:
            raise AssertionError(f"{CP_TAG} the {n} limit {t:g} passes a "
                                 f"skipped tile ({planted[n][0]:.3e})")
    err_f = max(errs["O"][1], errs["lse"][1])
    e_q, e_k, e_v = (errs[n][1] for n in ("dQ", "dK", "dV"))
    del ref, want, want_q, want_kv, dq2, dk2, dv2, stats2, o2, lse2
    torch.cuda.empty_cache()
    # times: each kernel graph-replayed, the plain versions issued from
    # Python (a call holds S x S f32 matrices), SDPA's causal forward and
    # backward (is_causal, its flash backend) graph-replayed
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              scale=sm)
    sdpa_fwd = _cuda_ms(sdpa, iters=20)
    sdpa_all = _cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs),
                                                    do), iters=20)
    port_all = _cuda_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, *fa.flash_attention_cuda(q, k, v, *tail), do, *tail),
        iters=20)
    rows = {}
    for name, fn, plain_fn, bnd in (
            ("flash_attention_fwd_streamed",
             lambda: fa.flash_attention_fwd_streamed_cuda(q, k, v, *tail),
             lambda: fa.flash_attention_reference(q, k, v, *tail),
             fwd_bound(B_, H_, S_, S_, D_, "bfloat16", False, True)),
            ("flash_attention_bwd_dq_streamed",
             lambda: fa.flash_attention_bwd_dq_streamed_cuda(
                 q, k, v, o, lse, do, *tail),
             lambda: fa.flash_attention_bwd_q_reference(
                 q, k, v, do, lse, fa.bwd_delta(o, do), *tail),
             _bwd_bound(B_, H_, S_, S_, D_, 6, "q_streamed", "bfloat16",
                        False, True)),
            ("flash_attention_bwd_dkdv_streamed",
             lambda: fa.flash_attention_bwd_dkdv_streamed_cuda(
                 q, k, v, do, stats, *tail),
             lambda: fa.flash_attention_bwd_kv_reference(
                 q, k, v, do, lse, delta, *tail),
             _bwd_bound(B_, H_, S_, S_, D_, 8, "kv", "bfloat16", False,
                        True))):
        ms = _cuda_ms(fn, iters=20)
        plain = _cuda_ms(plain_fn, iters=2, warmup=1, graph=False)
        torch.cuda.empty_cache()
        lib = sdpa_fwd if name.endswith("fwd_streamed") \
            else sdpa_all - sdpa_fwd
        err = err_f if name.endswith("fwd_streamed") else (
            e_q if "dq" in name else max(e_k, e_v))
        _log(f"[kernel] time {name} {what}: kernel {ms:.4f} ms, plain "
             f"{plain:.4f} ms, SDPA {'forward' if lib is sdpa_fwd else 'backward (fwd+bwd minus fwd)'} "
             f"(is_causal, graph-timed) {lib:.4f} ms, bound {bnd[0]:.4f} "
             f"ms ({bnd[1]}: {bnd[2]} FLOP, {bnd[3]} B), "
             f"{bnd[0] / ms:.1%} of it")
        _check_bound(f"{name} {what}", ms, bnd[0])
        row = dict(shape=what, ms=ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err)
        rows[name] = row
        (fwd_rows if name.endswith("fwd_streamed") else bwd_rows)[name][
            "timings"].append(row)
    _log(f"{CP_TAG} longctx fwd+bwd on the card, graph-replayed: the "
         f"port's kernels {port_all:.4f} ms, SDPA (is_causal) "
         f"{sdpa_all:.4f} ms, port/SDPA {port_all / sdpa_all:.3f}; bound "
         f"{LONGCTX_BOUND_MS} ms (bench.py's 360.8 GFLOP at 989 TFLOP/s)")
    return {"port_ms": port_all, "sdpa_ms": sdpa_all, "rows": rows}


def _cp_longctx_lane(book):
    """(c)'s main path: bench.py's longctx lane through
    paddle_tpu_torch.bench (flash_attention's autograd function), its
    launches counted, one step's in a trace."""
    import torch
    from paddle_tpu_torch import bench
    before = _launch_counts()
    res = bench.bench_longctx(device="cuda")
    steps = 10  # bench_longctx's 2 warm-up steps and 8 timed
    got = _delta(before)
    if got != tuple(steps * w for w in LONGCTX_WANT):
        raise AssertionError(f"{CP_TAG} longctx lane launched {got}, want "
                             f"{steps} x {LONGCTX_WANT}")
    book.add(LONGCTX_WANT, steps)
    q, k, v = bench.longctx_inputs(device=torch.device("cuda", 0),
                                   **bench.LONGCTX)
    # the trace holds a replay of the step's graph, as every other gate's
    # does
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            bench.longctx_step(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bench.longctx_step(q, k, v)
    graph.replay()
    timing = {}
    counts = _device_kernel_counts(graph.replay, warm=graph.replay,
                                   timing=timing)
    _log(f"{CP_TAG} the longctx trace on the host's clock (ms): {timing}")
    _check_trace(counts, LONGCTX_WANT, "a longctx fwd+bwd step's graph")
    # 3 warm-ups and 3 replays ran the kernels (the capture none)
    book.add(LONGCTX_WANT, 6)
    print(json.dumps(res), flush=True)
    _log(f"{CP_TAG} longctx lane: {res['value']} tokens/s, step "
         f"{res['step_ms']} ms (CUDA events over 8 host-issued steps), "
         f"{res['attn_tflops']} TFLOP/s of attention; bound "
         f"{res['bound_ms']} ms, {res['bound_ms'] / res['step_ms']:.1%} of "
         f"it; {res['device']}, {res['power_limit']}")
    return res


def _cp_loader(book):
    """(d) bench.py's mnist_realdata lane's loader with use_multiprocess
    beside the thread prefetch: batches and the losses of two passes
    bitwise alike, samples/s of each pass (the first with the executor's
    eager run and capture, the second warm), /dev/shm left as it was."""
    import os
    import numpy as np
    import torch
    from paddle_tpu_torch import bench, fluid
    batches = bench._mnist_batches(MP_BATCH, MP_BATCHES)
    build = bench._mnist_realdata_build(256)
    prefix = fluid.reader.segment_prefix()
    shm_before = sorted(os.listdir("/dev/shm"))
    res = {}
    for mp in (False, True):
        ldr = fluid.DataLoader.from_generator(capacity=4,
                                              use_multiprocess=mp)
        ldr.set_batch_generator(lambda: iter(batches),
                                places=fluid.CUDAPlace(0))
        seen = list(ldr)
        if len(seen) != len(batches) or not all(
                np.array_equal(s[n], b[n]) for s, b in zip(seen, batches)
                for n in b):
            raise AssertionError(f"{CP_TAG} loader (multiprocess {mp}): "
                                 "batches differ from the generator's")
        for windowed in (False, True):
            main, startup, fetch = build()
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            for warm in (False, True):
                src = ldr.window(MP_K) if windowed else ldr
                losses = []
                t0 = time.perf_counter()
                first = None
                for f in src:
                    if first is None:  # a worker's fork with its batch
                        first = (time.perf_counter() - t0) * 1e3
                    before = _launch_counts()
                    out = exe.run(main, feed=f, fetch_list=fetch,
                                  scope=scope)
                    if _delta(before) != NO_KERNELS:
                        raise AssertionError(f"{CP_TAG} the MLP launched "
                                             f"{_delta(before)}")
                    losses.append(np.asarray(out[0]).ravel())
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                res[mp, windowed, warm] = (np.concatenate(losses),
                                           MP_BATCH * len(batches) / dt,
                                           first)
            exe.close()
    for key in ((w, p) for w in (False, True) for p in (False, True)):
        if not np.array_equal(res[(False, *key)][0], res[(True, *key)][0]):
            raise AssertionError(f"{CP_TAG} a pass's losses differ between "
                                 f"the loaders (window, warm: {key})")
    shm_after = sorted(os.listdir("/dev/shm"))
    leaked = [n for n in shm_after if n.startswith(prefix)]
    if leaked:
        raise AssertionError(f"{CP_TAG} the loaders left {leaked} in "
                             "/dev/shm")

    def line(windowed, warm):
        t, m = res[False, windowed, warm], res[True, windowed, warm]
        return (f"thread {t[1]:.1f}, multiprocess {m[1]:.1f} (x"
                f"{m[1] / t[1]:.3f}; first batch after {t[2]:.1f} and "
                f"{m[2]:.1f} ms)")
    _log(f"{CP_TAG} mnist_realdata loader, {MP_BATCHES} batches of "
         f"{MP_BATCH}: batches bitwise the generator's and the losses of "
         f"two passes bitwise alike through both loaders; samples/s of a "
         f"pass, the first with the executor's eager run and capture: " +
         line(False, False) + f", window({MP_K}) " + line(True, False) +
         "; the second pass, warm: " + line(False, True) +
         f", window({MP_K}) " + line(True, True) + f"; /dev/shm held "
         f"{len(shm_before)} entries before, {len(shm_after)} after, none "
         f"of this process's")
    return {k: v[1] for k, v in res.items()}


def phase_compiler(fwd_rows, bwd_rows):
    """Phase 19: the v1.7 training-script front end (the docstring's
    phase 19). → the launches of its main paths: through the wrappers and
    on the card."""
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    longctx = _cp_longctx(fwd_rows, bwd_rows)
    book = _CfBook()
    _reset_launch_counts()
    resnet = _cp_resnet(book)
    _cp_bert(book)
    lane = _cp_longctx_lane(book)
    loader = _cp_loader(book)
    before = _launch_counts()
    loss = fluid.install_check.run_check()
    if _delta(before) != NO_KERNELS:
        raise AssertionError(f"{CP_TAG} run_check launched {_delta(before)}")
    _log(f"{CP_TAG} fluid.install_check.run_check() on the card: loss "
         f"{float(loss.reshape(-1)[0]):.6f}")
    wrapper = _launch_counts()
    _log(f"{CP_TAG} phase 19 in {time.perf_counter() - t0:.1f} s: launches "
         f"through the wrappers {GATE_NAMES} {wrapper}, on the card "
         f"{tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed),
            "resnet": resnet, "longctx": longctx, "lane": lane,
            "loader": loader}


# --------------------------------------------------------------------------
# 20. models
# --------------------------------------------------------------------------
MD_TAG = "[models]"
MD_SE_BATCH = 32              # (a) SE-ResNeXt-50 32x4d, 224x224, f32
MD_SE_CLASSES = 1000
MD_IMAGE = 224
MD_SE_LR = 0.0125             # PaddleCV's 0.1 at batch 256, linearly to 32
MD_VGG_BATCH = 128            # (b) VGG16 on CIFAR-10 (the book's
MD_VGG_LR = 1e-3              # image_classification): 32x32, Adam 1e-3
MD_PTB = dict(vocab_size=10000, hidden_size=1500, num_layers=2,
              num_steps=35, init_scale=0.04, lr=1.0, max_grad_norm=10.0)
MD_PTB_BATCH = 20             # (c) Zaremba et al. 2014's large config
MD_W2V_DICT = 2048            # (d) tests/book/test_word2vec.py's widths
MD_W2V_EMB = 32
MD_NGRAM_HID = 256
MD_NGRAM_WINDOW = 4
MD_NGRAM_LR = 1e-3            # build_ngram_lm_program's default SGD rate
MD_W2V_BATCH = 100
MD_W2V_NEG = 5
MD_SKIP_LR = 0.1              # Adagrad: a rate at which the loss falls in
                              # 10 steps (each step draws new negatives)
MD_SRL = dict(word_dict_len=44068, label_dict_len=59, emb=32, hidden=512)
MD_SRL_BATCH = 64             # (e) label_semantic_roles' dictionaries and
MD_SRL_LENS = (10, 60)        # hidden size; sentence lengths drawn here
MD_LOCK = 3                   # runs compiled and interpreted in lock step:
MD_LOCK_EXECS = ("eager", "capture", "replay")
MD_STEPS = 10                 # steps on one fixed batch, the loss falling
MD_CHECK_BATCH = 2            # (a), (b) card vs CPU at batch 2
MD_CHECK_STEPS = 2            # card vs CPU: steps from the same start
                              # (the PTB LM: MD_STEPS)
MD_AMP_BATCH = 64             # AMP on ResNet-50 at bench's resnet batch
MD_AMP_LR = 0.01              # where the f32 loss falls (RESNET_FALL_LR)
MD_AMP_TIMED = 8              # replays timed of each of f32 and AMP


def _md_fixed(fn):
    """``fn()`` run with a fixed program seed: the models' startups and
    random ops draw alike in every run of the script."""
    from paddle_tpu_torch import fluid
    with fluid.unique_name.guard():
        built = fn()
    built[0].random_seed = built[1].random_seed = SEED
    return built


def _md_run(main, fetch, feed):
    """``_md_train``'s runs for one program on one fixed feed."""
    return [(main, fetch, lambda outs: feed)]


def _md_train(book, what, runs, starts, want, mode="compiled",
              finite=(), overshoots=False, tag=MD_TAG, keep_scope=False,
              new_plans=False):
    """MD_STEPS steps on one fixed batch on the card, ``mode`` "compiled"
    or "segmented", from the ``starts`` (startup programs) run into one
    scope. A step runs each (main, fetch, feed_fn) of ``runs`` once in
    turn, ``feed_fn`` given the fetches of the step's runs before it.
    The first MD_LOCK steps run in lock step with the interpreter
    (``_lock_step``: fetches and persistables bitwise), every run's
    launches gated on ``want`` (``_gate_mode``), then two more replays of
    a step, the second in a trace that must hold ``want`` for each run.
    Gates: each run executes eager, capture, then replays; each run's
    loss (its first fetch) falls from the first step to the last, or
    with ``overshoots`` (a run whose updates overshoot on the repeated
    batch, its every loss held to the CPU port's by ``_md_card_vs_cpu``)
    below the first at some step; the first run's fetches at ``finite``
    (indices) are finite; ``tag`` heads its lines. ``new_plans``: a
    segmented step whose islands give new LoDs as the weights move runs
    as a new plan where they change, so how each step ran is reported,
    not gated, and every step after the lock is timed. → its readings
    (with ``keep_scope`` the executor, to be closed, and the trained
    scope too): losses by run, the step's p50 (ms) over the replayed
    steps (every step after the lock with ``new_plans``), peak memory
    (bytes, with what was allocated before the startup), how each run
    of each step ran and each step's ms."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    for s in starts:
        exe.run(s, scope=scope)
    names = sorted({v.name for m, _, _ in runs for v in m.list_vars()
                    if v.persistable})
    iexe = fluid.Executor(fluid.CUDAPlace(0))
    iscope = _clone_scope(scope, names, "cuda")
    losses = [[] for _ in runs]
    kinds = [[] for _ in runs]
    times, step_ms = [], []
    for i in range(MD_STEPS):
        outs, feeds, dt = [], [], 0.0
        for j, (main, fetch, feed_fn) in enumerate(runs):
            feeds.append(feed_fn(outs))
            w = f"{what} step {i}" + (f" run {j}" if len(runs) > 1 else "")
            if i < MD_LOCK:
                out, _, kind, t, _ = _lock_step(
                    (exe, scope), (iexe, iscope), main, feeds[j], fetch,
                    want, book, w, tag, mode=mode)
            else:
                before = _launch_counts()
                t = time.perf_counter()
                out = exe.run(main, feed=feeds[j], fetch_list=fetch,
                              scope=scope)
                t = time.perf_counter() - t
                kind = _gate_mode(exe, before, want, f"{tag} {w}", book,
                                  mode)
            kinds[j].append(kind)
            outs.append(out)
            dt += t
            losses[j].append(float(np.asarray(out[0]).reshape(-1)[0]))
            if j == 0 and i >= MD_LOCK:
                for k in finite:
                    if not np.isfinite(out[k]).all():
                        raise AssertionError(f"{tag} {what}: fetch {k} is "
                                             "not finite")
        step_ms.append(dt * 1e3)
        if all(k[-1] == "replay" for k in kinds) or (new_plans and
                                                    i >= MD_LOCK):
            times.append(dt)
    iexe.close()
    runs_as = tuple(MD_LOCK_EXECS) + ("replay",) * (MD_STEPS - MD_LOCK)
    if not new_plans and any(tuple(k) != runs_as for k in kinds):
        raise AssertionError(f"{tag} {what}: runs {kinds}")
    for j, ls in enumerate(losses):
        falls = (min(ls[1:]) if overshoots else ls[-1]) < ls[0]
        if not np.isfinite(ls).all() or not falls:
            raise AssertionError(f"{tag} {what}: the loss"
                                 + (f" of run {j}" if len(runs) > 1 else "")
                                 + f" did not fall: {ls}")

    def step():
        for (main, fetch, _), f in zip(runs, feeds):
            exe.run(main, feed=f, fetch_list=fetch, scope=scope)
    n = len(runs)
    _check_trace(_device_kernel_counts(step, warm=step),
                 tuple(n * k for k in want), f"{what} step")
    book.add(want, 2 * n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(times)) * 1e3
    _log(f"{tag} {what}: {MD_STEPS} steps on one batch"
         + (f", {n} runs a step" if n > 1 else "")
         + (f" ({' '.join(kinds[0])}, {mode})" if new_plans else
            f" ({' '.join(MD_LOCK_EXECS)}, then replays, {mode})")
         + ", the first "
         f"{MD_LOCK} bitwise the interpreter's, loss "
         + "; ".join(" ".join(f"{x:.4f}" for x in ls) for ls in losses)
         + f"; step p50 {p50:.3f} ms over {len(times)} "
         + ("steps after them" if new_plans else "replayed steps") + ", "
         f"peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
         f"GiB above the {base / 2**30:.3f} GiB held before) on "
         f"{_card_line()}; launches a run {want} -> ok")
    res = {"losses": losses, "p50_ms": p50, "peak_gib": peak / 2**30,
           "net_gib": (peak - base) / 2**30, "kinds": kinds,
           "step_ms": step_ms}
    if keep_scope:
        res.update(exe=exe, scope=scope)
    else:
        exe.close()
    return res


def _md_noise_grads(block):
    """The grads of the biases added just before a batch norm, which
    takes out any shift: 0 but for rounding."""
    made_by = {o: op for op in block.ops for o in op.output_arg_names}
    params = {p.name for p in block.all_parameters()}
    adds = [made_by.get(op.input("X")[0]) for op in block.ops
            if op.type == "batch_norm"]
    return {a.input("Y")[0] + "@GRAD" for a in adds
            if a is not None and a.type == "elementwise_add"
            and a.input("Y")[0] in params}


def _md_grads_agree(names, gpu, cpu, noise, conv, tiny=False):
    """Each grad of ``names`` on the card against the CPU's: max|d|
    within GRAD_TOL of its max|grad|, or for a conv net (``conv``) within
    KINK_L2_TOL in relative L2; the ``_md_noise_grads`` within GRAD_TOL
    of the largest grad of all (``noise``), and with ``tiny`` so is every
    grad whose max|grad| is itself within GRAD_TOL of the largest (a
    batch norm scale's grad at a random start, a sum that cancels to
    1e-5 of the step's grads, rounds as they do). → (names that
    disagree, (the worst share of its limit, its name), the largest
    grad)."""
    import numpy as np
    top = max(float(np.abs(b).max()) for b in cpu)
    bad, worst = [], (-1.0, "")
    for name, a, b in zip(names, gpu, cpu):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if name in noise or (tiny and np.abs(b).max() <= GRAD_TOL * top):
            err, lim = float(np.abs(a - b).max()), GRAD_TOL * top
        elif conv:
            err = float(np.linalg.norm(a - b))
            lim = KINK_L2_TOL * float(np.linalg.norm(b))
        else:
            err = float(np.abs(a - b).max())
            lim = GRAD_TOL * float(np.abs(b).max())
        if not err <= lim:
            bad.append(name)
        share = err / lim if lim else (np.inf if err else 0.0)
        worst = max(worst, (share, name))
    return bad, worst, top


def _md_card_vs_cpu(book, what, main, startup, fetch, feed, exact=(),
                    conv=False, steps=MD_CHECK_STEPS, adaptive=False,
                    tag=MD_TAG, noise=(), resync=False, tape=None,
                    tiny=False):
    """``steps`` steps on the card and by the port on the CPU from the
    card's startup values and step counter (so the random ops draw
    alike). The first also fetches every parameter's grad, held by
    ``_md_grads_agree``, and the fetches at ``exact`` (indices) must be
    equal. Every step's loss (first fetch) within LOSS_TOL relative: a
    later step's loss reads the card's grads, clip and update. For a
    conv net, or under Adam or Adagrad (``adaptive``: their g/(√v+ε)
    turns rounding noise on a near-zero grad into a step of ±lr), a
    later loss may instead be within KINK_L2_TOL of how far the updates
    moved the CPU's loss from its first: the first update's grads may
    differ by that much. ``noise``: more grads that are 0 but for
    rounding, held as the ``_md_noise_grads``. ``resync``, for a net
    whose rounding differences part the card and the CPU within a step,
    as they part the card from itself with the input one ulp up
    (DL_CHECK_MIDDLE): the first step's update, each parameter's move
    from the one start, is held as its grad (the learning rate, momentum
    and weight decay as each side applied them); each later step starts
    the CPU from the card's state, its loss within LOSS_TOL. → the
    card's fetches of the last step. ``tape`` (an ``IslandTape``)
    records the host ops of each card step and the CPU's step replays
    them. ``tiny``: ``_md_grads_agree``'s."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops.registry import OPS
    names = [v.name for v in main.list_vars() if v.persistable]
    block = main.global_block()
    grads = [p.name + "@GRAD" for p in block.all_parameters()
             if block.has_var(p.name + "@GRAD")]
    noise = _md_noise_grads(block) | set(noise)
    before = _launch_counts()
    exe, scope = _fresh(main, startup)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_scope = _clone_scope(scope, names, "cpu")
    start = _persistables(scope, main) if resync else None
    pairs = []
    for i in range(steps):
        if i == 1 and resync:
            card, cpu = _persistables(scope, main), \
                _persistables(cpu_scope, main)
            moves = [[(s[g[:-5]].double().cpu() - start[g[:-5]].double()
                       .cpu()).numpy() for g in grads] for s in (card, cpu)]
            mbad, mworst, _ = _md_grads_agree(grads, *moves, noise, conv,
                                              tiny)
            bad += [f"{g[:-5]}'s update" for g in mbad]
        if i and resync:
            cpu_scope = _clone_scope(scope, names, "cpu")
        f = list(fetch) + (grads if i == 0 else [])
        with (tape.recording(OPS, _det_card_np) if tape
              else contextlib.nullcontext()):
            gpu = exe.run(main, feed=feed, fetch_list=f, scope=scope)
        with (tape.replaying(OPS, _det_cpu_from_np, _det_card_np) if tape
              else contextlib.nullcontext()):
            cpu = cpu_exe.run(main, feed=feed, fetch_list=f,
                              scope=cpu_scope)
        pairs.append((float(gpu[0].reshape(-1)[0]),
                      float(cpu[0].reshape(-1)[0])))
        if i == 0:
            n = len(fetch)
            bad, worst, top = _md_grads_agree(grads, gpu[n:], cpu[n:],
                                              noise, conv, tiny)
            bad += [f"fetch {k}" for k in exact
                    if not np.array_equal(gpu[k], cpu[k])]
            first = gpu
    book.add(_delta(before))
    exe.close()
    c0 = pairs[0][1]
    for i, (g, c) in enumerate(pairs):
        lim = LOSS_TOL * abs(c)
        if i and (conv or adaptive) and not resync:
            lim = max(lim, KINK_L2_TOL * abs(c - c0))
        if not abs(g - c) <= lim:
            bad.append(f"step {i + 1}'s loss")
    rule = (f"relative L2 within {KINK_L2_TOL:g}" if conv else
            f"max|d| within {GRAD_TOL:g} of max|grad|")
    _log(f"{tag} {what}, card vs CPU, {steps} steps from one start: "
         "loss " + ", ".join(f"{g:.6f} vs {c:.6f}" for g, c in pairs)
         + f" (tol {LOSS_TOL:g} relative" + (
             f", or {KINK_L2_TOL:g} of the move from the first"
             if (conv or adaptive) and not resync else "")
         + ("; each later step from the card's state" if resync else "")
         + f"); the first step's {len(grads)} parameter grads, {rule} ("
         f"{len(noise)} grads that are 0 but for rounding"
         + (f" ({', '.join(sorted(noise))})" if 0 < len(noise) <= 2 else "")
         + (", and the grads whose max|grad| is as small," if tiny else "")
         + f" within {GRAD_TOL:g} of the largest grad, {top:.3e}): the "
         f"worst {worst[1]} at "
         f"{worst[0]:.3f} of its limit" + (
             f"; its update, each parameter's move, as its grad: the worst "
             f"{mworst[1][:-5]}'s at {mworst[0]:.3f} of its limit"
             if resync else "") + "".join(
             f"; fetch {k} {tuple(first[k].shape)} " + (
                 "DIFFERS" if f"fetch {k}" in bad else "equal")
             for k in exact)
         + f" -> {'FAIL ' + ', '.join(bad[:8]) if bad else 'ok'}")
    if bad:
        raise AssertionError(f"{tag} {what}: the card disagrees with the "
                             f"CPU: {', '.join(bad[:8])}")
    return gpu


def _md_images(rng, bs, size, classes):
    return {"image": rng.rand(bs, 3, size, size).astype("float32"),
            "label": rng.randint(0, classes, (bs, 1)).astype("int64")}


def _md_se_resnext(book):
    """(a) SE-ResNeXt-50 (32x4d) at 224x224, 1000 classes, batch 32, f32,
    Nesterov Momentum 0.0125, its classifier's dropout 0.5: the dropout
    kernel once a step."""
    import numpy as np
    from paddle_tpu_torch.models import se_resnext
    main, startup, _, loss, acc = _md_fixed(
        lambda: se_resnext.build_se_resnext_train_program(
            class_dim=MD_SE_CLASSES, image_size=MD_IMAGE, lr=MD_SE_LR))
    ops = main.global_block().ops
    want = _step_want(ops, "split", forwards=0)
    if want != (0, 0, 0, 0, 1) + (0,) * 7:
        raise AssertionError(f"{MD_TAG} (a) SE-ResNeXt-50: a step would "
                             f"launch {want}")
    groups = sorted({op.attr("groups") for op in ops if op.type == "conv2d"})
    rng = np.random.RandomState(SEED + 20)
    res = _md_train(book, f"(a) SE-ResNeXt-50 batch {MD_SE_BATCH} f32",
                    _md_run(main, [loss, acc], _md_images(
                        rng, MD_SE_BATCH, MD_IMAGE, MD_SE_CLASSES)),
                    [startup], want)
    _md_card_vs_cpu(book, f"(a) SE-ResNeXt-50 batch {MD_CHECK_BATCH} "
                    "(dropout 0.5: the kernel's mask is its plain version's)",
                    main, startup, [loss],
                    _md_images(rng, MD_CHECK_BATCH, MD_IMAGE, MD_SE_CLASSES),
                    conv=True)
    _log(f"{MD_TAG} (a) {sum(op.type == 'conv2d' for op in ops)} conv2d "
         f"(groups {groups}), {sum(op.type == 'sigmoid' for op in ops)} "
         f"squeeze-and-excitation gates, {len(ops)} ops a step")
    return res


def _md_vgg(book):
    """(b) The book's VGG16 on CIFAR-10 shapes: 32x32, batch 128, Adam
    1e-3."""
    import numpy as np
    from paddle_tpu_torch.models import book_extra
    main, startup, _, loss, acc = _md_fixed(
        lambda: book_extra.build_vgg_cifar(class_dim=10, image_size=32,
                                           lr=MD_VGG_LR, depth="16"))
    rng = np.random.RandomState(SEED + 21)

    def batch(bs):
        return {"img": rng.rand(bs, 3, 32, 32).astype("float32"),
                "label": rng.randint(0, 10, (bs, 1)).astype("int64")}
    res = _md_train(book, f"(b) VGG16 batch {MD_VGG_BATCH}",
                    _md_run(main, [loss, acc], batch(MD_VGG_BATCH)),
                    [startup], NO_KERNELS)
    _md_card_vs_cpu(book, f"(b) VGG16 batch {MD_CHECK_BATCH}", main,
                    startup, [loss], batch(MD_CHECK_BATCH), conv=True,
                    adaptive=True)
    return res


def _md_ptb(book):
    """(c) The PTB LSTM LM, large: vocab 10,000, hidden 1,500, 2 layers,
    35 steps, batch 20, init scale 0.04, global-norm clip 10, SGD 1.0; no
    dropout (build_ptb_lm_program has none)."""
    import numpy as np
    from paddle_tpu_torch.models import ptb_lm
    main, startup, _, loss, last_h, last_c = _md_fixed(
        lambda: ptb_lm.build_ptb_lm_program(**MD_PTB))
    rng = np.random.RandomState(SEED + 22)
    T, V = MD_PTB["num_steps"], MD_PTB["vocab_size"]
    feed = {"x": rng.randint(0, V, (MD_PTB_BATCH, T)).astype("int64"),
            "y": rng.randint(0, V, (MD_PTB_BATCH, T, 1)).astype("int64")}
    fetch = [loss, last_h, last_c]
    # SGD 1.0 under the clip at 10, without the published dropout, on one
    # repeated batch: the updates overshoot and the loss rises and falls
    # again within the 10 steps, as the TPU package's does at hidden 400
    # (tests/test_torch_models_a7.py::test_ptb_lm_ten_steps_at_sgd_1); so
    # each of the 10 losses is held to the CPU port's at full width
    res = _md_train(book, f"(c) PTB LSTM LM large batch {MD_PTB_BATCH}",
                    _md_run(main, fetch, feed), [startup], NO_KERNELS,
                    finite=(1, 2), overshoots=True)
    got = _md_card_vs_cpu(book, f"(c) PTB LSTM LM large batch "
                          f"{MD_PTB_BATCH}", main, startup, fetch, feed,
                          steps=MD_STEPS)
    shape = (MD_PTB["num_layers"], MD_PTB_BATCH, MD_PTB["hidden_size"])
    for name, v in zip(("last_h", "last_c"), got[1:]):
        if tuple(v.shape) != shape or not np.isfinite(v).all():
            raise AssertionError(f"{MD_TAG} (c) {name} {v.shape}, finite "
                                 f"{np.isfinite(v).all()}")
    return res


def _md_word2vec(book):
    """(d) The book's N-gram LM (dict 2048, emb 32, hidden 256, window 4,
    SGD) and the skip-gram model (dict 2048, emb 32, Adagrad) under nce
    (5 negatives) and under hsigmoid, batch 100 each."""
    import numpy as np
    from paddle_tpu_torch.models import word2vec
    rng = np.random.RandomState(SEED + 23)
    out = {}
    main, startup, feeds, loss = _md_fixed(
        lambda: word2vec.build_ngram_lm_program(
            dict_size=MD_W2V_DICT, emb_dim=MD_W2V_EMB, hid_dim=MD_NGRAM_HID,
            window=MD_NGRAM_WINDOW, lr=MD_NGRAM_LR))
    feed = {n: rng.randint(0, MD_W2V_DICT, (MD_W2V_BATCH, 1)).astype(
        "int64") for n in feeds}
    out["ngram"] = _md_train(book, f"(d) N-gram LM batch {MD_W2V_BATCH}",
                             _md_run(main, [loss], feed), [startup],
                             NO_KERNELS)
    _md_card_vs_cpu(book, "(d) N-gram LM", main, startup, [loss], feed)
    for kind in ("nce", "hsigmoid"):
        main, startup, feeds, loss = _md_fixed(
            lambda: word2vec.build_skipgram_program(
                dict_size=MD_W2V_DICT, emb_dim=MD_W2V_EMB,
                neg_num=MD_W2V_NEG, lr=MD_SKIP_LR, loss_type=kind))
        feed = {n: rng.randint(0, MD_W2V_DICT, (MD_W2V_BATCH, 1)).astype(
            "int64") for n in feeds}
        fetch = [loss]
        if kind == "nce":
            nce = [op for op in main.global_block().ops
                   if op.type == "nce"][0]
            fetch.append(nce.output("SampleLabels")[0])
        out[kind] = _md_train(book, f"(d) skip-gram {kind} batch "
                              f"{MD_W2V_BATCH}", _md_run(main, fetch, feed),
                              [startup], NO_KERNELS)
        # the negatives are counter-hash draws: the card draws the CPU's
        _md_card_vs_cpu(book, f"(d) skip-gram {kind}", main, startup, fetch,
                        feed, exact=(1,) if kind == "nce" else (),
                        adaptive=True)
    return out


def _md_srl_batch(rng, bs):
    """``bs`` sentences with lengths drawn in MD_SRL_LENS: word ids and
    tags as LoD tensors on the host."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    lens = rng.randint(MD_SRL_LENS[0], MD_SRL_LENS[1] + 1, size=bs)
    offs = [0] + [int(x) for x in np.cumsum(lens)]
    n = offs[-1]
    word = rng.randint(0, MD_SRL["word_dict_len"], (n, 1)).astype("int64")
    target = rng.randint(0, MD_SRL["label_dict_len"], (n, 1)).astype("int64")
    return {"word": fluid.LoDTensor(torch.from_numpy(word), [offs]),
            "target": fluid.LoDTensor(torch.from_numpy(target), [offs])}


def _md_srl(book):
    """(e) The book's SRL tagger over LoD: embedding, fc tanh, fc to the
    tags, linear_chain_crf and crf_decoding sharing the transitions
    (crfw); SGD 1e-2. The fixed batch trains; the decode on the card
    equals the CPU port's on the same batch."""
    import numpy as np
    from paddle_tpu_torch.models import book_extra
    main, startup, _, loss, decode = _md_fixed(
        lambda: book_extra.build_srl_crf_program(**MD_SRL))
    rng = np.random.RandomState(SEED + 24)
    feed = _md_srl_batch(rng, MD_SRL_BATCH)
    res = _md_train(book, f"(e) SRL tagger batch {MD_SRL_BATCH} sentences "
                    f"({feed['word'].array.shape[0]} words)",
                    _md_run(main, [loss, decode], feed), [startup],
                    NO_KERNELS)
    got = _md_card_vs_cpu(book, "(e) SRL tagger, the Viterbi decode", main,
                          startup, [loss, decode], feed, exact=(1,))
    tags = got[1].reshape(-1)
    if tags.min() < 0 or tags.max() >= MD_SRL["label_dict_len"]:
        raise AssertionError(f"{MD_TAG} (e) decoded tags outside the tag "
                             "set")
    return res


def _md_amp_resnet(fluid, resnet, amp):
    """ResNet-50 (1000 classes, 224x224) under Momentum(MD_AMP_LR, 0.9),
    decorated by contrib.mixed_precision when ``amp``."""
    from paddle_tpu_torch.fluid.contrib import mixed_precision

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.data("image", shape=[3, MD_IMAGE, MD_IMAGE],
                             dtype="float32")
            label = fluid.data("label", shape=[1], dtype="int64")
            pred = resnet.resnet(img, 1000, 50)
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred,
                                                                label))
            opt = fluid.optimizer.Momentum(MD_AMP_LR, momentum=0.9)
            if amp:
                opt = mixed_precision.decorate(opt)
            opt.minimize(loss)
        return main, startup, loss
    return _md_fixed(build)


def _md_amp(book, lane_ms):
    """AMP on ResNet-50 at batch MD_AMP_BATCH: the f32 program and its
    decorate()d twin (bf16 casts before conv2d and mul) each trained
    MD_STEPS steps on one batch by ``_md_train`` (the first runs in lock
    step with the interpreter); step p50 of each beside the bf16 lane's
    (phase 10, bench.py's resnet lane, the same run)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet
    feed = _md_images(np.random.RandomState(SEED + 25), MD_AMP_BATCH,
                      MD_IMAGE, 1000)
    out = {}
    for amp in (False, True):
        main, startup, loss = _md_amp_resnet(fluid, resnet, amp)
        casts = sum(op.type == "cast" for op in main.global_block().ops)
        if amp != (casts > 0):
            raise AssertionError(f"{MD_TAG} AMP ResNet-50: {casts} casts")
        what = "AMP (bf16)" if amp else "f32"
        out[what] = _md_train(book, f"ResNet-50 {what} batch "
                              f"{MD_AMP_BATCH}, {casts} casts",
                              _md_run(main, [loss], feed), [startup],
                              NO_KERNELS)
    amp_ms, f32_ms = out["AMP (bf16)"]["p50_ms"], out["f32"]["p50_ms"]
    _log(f"{MD_TAG} AMP on ResNet-50 batch {MD_AMP_BATCH}: step p50 "
         f"{amp_ms:.3f} ms under decorate() against {f32_ms:.3f} ms in f32 "
         f"(x{f32_ms / amp_ms:.2f}) and the bf16 lane's {lane_ms} ms "
         f"(phase 10, this run) on {_card_line()}")
    return {"amp_p50_ms": amp_ms, "f32_p50_ms": f32_ms, "lane_ms": lane_ms}


def phase_models(lane_ms):
    """Phase 20: the op library's first model batch (the docstring's phase
    20). ``lane_ms``: the bf16 resnet lane's step (phase 10). → the
    launches of its main paths: through the wrappers and on the card."""
    book = _CfBook()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = {"se_resnext": _md_se_resnext(book), "vgg16": _md_vgg(book),
           "ptb": _md_ptb(book), "word2vec": _md_word2vec(book),
           "srl": _md_srl(book), "amp": _md_amp(book, lane_ms)}
    wrapper = _launch_counts()
    # the dropout kernel is SE-ResNeXt's alone: its steps, the interpreted
    # ones and the card-vs-CPU step
    if any(wrapper[:4]) or any(wrapper[5:]):
        raise AssertionError(f"{MD_TAG} phase 20 launched {wrapper}")
    _log(f"{MD_TAG} phase 20 in {time.perf_counter() - t0:.1f} s: step p50 "
         + ", ".join(f"{k} {v['p50_ms']:.3f} ms" for k, v in res.items()
                     if "p50_ms" in v)
         + f", word2vec " + ", ".join(
             f"{k} {v['p50_ms']:.3f} ms" for k, v in res["word2vec"].items())
         + f"; launches through the wrappers {GATE_NAMES} {wrapper}, on "
         f"the card {tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed), **res}


# --------------------------------------------------------------------------
# phase 21: the recurrences. The two book programs and the legacy LoD
# path are user programs built from fluid.layers: each builder takes the
# ``fluid`` module (the port's, or the TPU package's in the parity tests)
# and builds the same ops in both.
# --------------------------------------------------------------------------
RNN_TAG = "[rnn]"
RNN_EMB = 128                 # (a) stacked_lstm_net (book chapter 6,
RNN_HID = 512                 # understand_sentiment): emb 128, HID_DIM
RNN_STACKED = 3               # 512 (LSTM hidden 128), STACKED_NUM 3
RNN_LR = 0.002                # the chapter's Adagrad rate
RNN_BATCH = 128               # reviews a batch
MT_DICT = 30000               # (b) machine_translation (book chapter 8,
MT_HID = 512                  # v1.7): source and target dicts, word_dim =
MT_BATCH = 64                 # hidden_dim = decoder_size, batch
MT_LEN = 50                   # source and target padded to
MT_BEAM = 4                   # BeamSearchDecoder's beam, bos and eos
MT_BOS, MT_EOS = 0, 1
MT_MAX_STEP = 64              # dynamic_decode's steps (the book's 256)
MT_LR = 1e-3                  # Adam
# (a)'s served program after the inference passes, as the TPU package's
# passes leave it (tests/test_torch_rnn_layers.py): fc_lstm_fuse_pass
# fuses no projection (each has a bias and more than one reader), the
# first one's mul + add become an fc
RNN_SENT_CENSUS = {"lookup_table": 1, "fc": 1, "dynamic_lstm": 3, "mul": 6,
                   "sum": 3, "elementwise_add": 3, "sequence_pool": 2,
                   "softmax": 1}
# and rnn_lstm_classifier's: its bias-free projection fused
RNN_FUSED_CENSUS = {"lookup_table": 1, "fusion_lstm": 1, "sequence_pool": 1,
                    "fc": 1, "softmax": 1}
LG_LENS = (10, 50)            # (c) ragged source and reference lengths
LG_BEAM_STEPS = 32            # host-stepped beam steps


def rnn_sentiment_program(fluid, dict_dim=LOD_VOCAB, emb_dim=RNN_EMB,
                          hid_dim=RNN_HID, stacked_num=RNN_STACKED,
                          class_dim=2, lr=RNN_LR):
    """(a) The book's stacked_lstm_net (chapter 6, understand_sentiment):
    an embedding, fc to ``hid_dim`` and a dynamic_lstm of size ``hid_dim``
    (hidden hid_dim / 4), then ``stacked_num - 1`` more fc + dynamic_lstm
    pairs over the last pair, every second one reversed, max-pooled fc
    and LSTM outputs into a softmax fc; Adagrad ``lr``. → (main,
    startup, the test clone taken before the optimizer, the prediction,
    loss, accuracy)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.data("words", shape=[1], dtype="int64", lod_level=1)
        label = fluid.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(words, size=[dict_dim, emb_dim],
                               is_sparse=True)
        fc1 = layers.fc(emb, hid_dim)
        lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim)
        inputs = [fc1, lstm1]
        for i in range(2, stacked_num + 1):
            fc = layers.fc(inputs, hid_dim)
            lstm, _ = layers.dynamic_lstm(fc, size=hid_dim,
                                          is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        fc_last = layers.sequence_pool(inputs[0], "max")
        lstm_last = layers.sequence_pool(inputs[1], "max")
        pred = layers.fc([fc_last, lstm_last], class_dim, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        test = main.clone(for_test=True)
        fluid.optimizer.Adagrad(lr).minimize(loss)
    return main, startup, test, pred, loss, acc


def rnn_lstm_classifier(fluid, dict_dim=LOD_VOCAB, emb_dim=RNN_EMB,
                        hid_dim=RNN_HID, class_dim=2):
    """An inference program at (a)'s widths whose LSTM reads a bias-free
    projection alone (what fc_lstm_fuse_pass fuses into fusion_lstm):
    embedding, fc(bias_attr=False), dynamic_lstm, max pool, softmax fc.
    → (main, startup, the prediction)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.data("words", shape=[1], dtype="int64", lod_level=1)
        emb = layers.embedding(words, size=[dict_dim, emb_dim])
        lstm, _ = layers.dynamic_lstm(layers.fc(emb, hid_dim,
                                                bias_attr=False),
                                      size=hid_dim)
        pred = layers.fc(layers.sequence_pool(lstm, "max"), class_dim,
                         act="softmax")
    return main, startup, pred


class _MtDecoderCell:
    """The book's chapter 8 decoder cell: additive attention over the
    encoder (an fc of the state added to the encoder's projection, a
    size-1 fc, the padding mask, softmax, the weighted sum), its context
    joined to the step input, then a GRUCell. The attention expands the
    state over the static source length ``src_len``."""

    def __init__(self, fluid, hidden, src_len):
        self.fluid, self.hidden, self.src_len = fluid, hidden, src_len
        self.gru = fluid.layers.GRUCell(hidden, name="mt_dec_gru")

    def __call__(self, step_input, hidden, encoder_output=None,
                 encoder_output_proj=None, encoder_padding_mask=None):
        layers, P = self.fluid.layers, self.fluid.ParamAttr
        proj = layers.unsqueeze(layers.fc(
            hidden, self.hidden, param_attr=P(name="mt_att_state_w"),
            bias_attr=False), [1])
        mixed = layers.elementwise_add(
            encoder_output_proj, layers.expand(proj, [1, self.src_len, 1]))
        scores = layers.squeeze(layers.fc(
            mixed, 1, num_flatten_dims=2, param_attr=P(name="mt_att_v"),
            bias_attr=False), [2])
        scores = layers.softmax(layers.elementwise_add(
            scores, encoder_padding_mask))
        context = layers.reduce_sum(layers.elementwise_mul(
            encoder_output, scores, axis=0), dim=1)
        return self.gru(layers.concat([step_input, context], axis=1),
                        hidden)


def _mt_encoder(fluid, src, src_len, dict_dim, hidden, max_len):
    """The bidirectional GRU encoder (two GRUCells under layers.rnn), its
    projection for the attention, the padding mask (-1e9 past a
    source's length) and the decoder's initial state (an fc with tanh of
    the two final states)."""
    layers, P = fluid.layers, fluid.ParamAttr
    emb = layers.embedding(src, size=[dict_dim, hidden],
                           param_attr=P(name="mt_src_emb"))
    fwd, fwd_state = layers.rnn(layers.GRUCell(hidden, name="mt_enc_fwd"),
                                emb)
    bwd, bwd_state = layers.rnn(layers.GRUCell(hidden, name="mt_enc_bwd"),
                                emb, is_reverse=True)
    enc = layers.concat([fwd, bwd], axis=2)
    enc_proj = layers.fc(enc, hidden, num_flatten_dims=2,
                         param_attr=P(name="mt_enc_proj_w"), bias_attr=False)
    mask = layers.sequence_mask(src_len, maxlen=max_len, dtype="float32")
    pad = layers.scale(mask, scale=1e9, bias=-1e9)
    init = layers.fc(layers.concat([fwd_state, bwd_state], axis=1), hidden,
                     act="tanh", param_attr=P(name="mt_init_w"),
                     bias_attr=P(name="mt_init_b"))
    return enc, enc_proj, pad, init


def _mt_output(fluid, x, dict_dim):
    P = fluid.ParamAttr
    return fluid.layers.fc(x, dict_dim, num_flatten_dims=len(x.shape) - 1,
                           param_attr=P(name="mt_out_w"),
                           bias_attr=P(name="mt_out_b"))


def _mt_trg_embed(fluid, ids, dict_dim, hidden):
    return fluid.layers.embedding(ids, size=[dict_dim, hidden],
                                  param_attr=fluid.ParamAttr(
                                      name="mt_trg_emb"))


def mt_train_program(fluid, dict_dim=MT_DICT, hidden=MT_HID,
                     max_len=MT_LEN, lr=MT_LR):
    """(b) The book's chapter 8 translator as v1.7 wrote it, trained
    teacher-forced through layers.rnn: softmax_with_cross_entropy over
    the target dict, masked by the target padding, summed over the
    tokens and divided by their count; Adam ``lr``. Feeds: src, src_len,
    trg (the decoder's inputs), trg_next [B, T, 1] (its labels),
    trg_len. → (main, startup, loss)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src", shape=[max_len], dtype="int64")
        src_len = fluid.data("src_len", shape=[], dtype="int64")
        trg = fluid.data("trg", shape=[max_len], dtype="int64")
        trg_next = fluid.data("trg_next", shape=[max_len, 1], dtype="int64")
        trg_len = fluid.data("trg_len", shape=[], dtype="int64")
        enc, enc_proj, pad, init = _mt_encoder(fluid, src, src_len,
                                               dict_dim, hidden, max_len)
        cell = _MtDecoderCell(fluid, hidden, max_len)
        dec, _ = layers.rnn(cell, _mt_trg_embed(fluid, trg, dict_dim, hidden),
                            initial_states=init, encoder_output=enc,
                            encoder_output_proj=enc_proj,
                            encoder_padding_mask=pad)
        logits = _mt_output(fluid, dec, dict_dim)
        ce = layers.squeeze(layers.softmax_with_cross_entropy(
            logits, trg_next), [2])
        mask = layers.sequence_mask(trg_len, maxlen=max_len,
                                    dtype="float32")
        loss = layers.elementwise_div(
            layers.reduce_sum(layers.elementwise_mul(ce, mask)),
            layers.reduce_sum(mask))
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss


def mt_decode_program(fluid, dict_dim=MT_DICT, hidden=MT_HID,
                      max_len=MT_LEN, beam=MT_BEAM, max_step=MT_MAX_STEP):
    """(b)'s beam decode: the encoder, its outputs, projection and padding
    mask tiled to B·beam rows (unsqueeze, expand, reshape, as
    dynamic_decode tiles its states), then BeamSearchDecoder (bos
    MT_BOS, eos MT_EOS) through dynamic_decode for ``max_step`` steps.
    Its parameters are the training program's, by name. → (main,
    startup, predicted ids [B, max_step, beam], final scores [B, beam])."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src", shape=[max_len], dtype="int64")
        src_len = fluid.data("src_len", shape=[], dtype="int64")
        enc, enc_proj, pad, init = _mt_encoder(fluid, src, src_len,
                                               dict_dim, hidden, max_len)

        def tile(x, shape):
            t = layers.expand(layers.unsqueeze(x, [1]),
                              [1, beam] + [1] * len(shape))
            return layers.reshape(t, [-1] + shape)
        cell = _MtDecoderCell(fluid, hidden, max_len)
        decoder = layers.BeamSearchDecoder(
            cell, MT_BOS, MT_EOS, beam,
            embedding_fn=lambda ids: _mt_trg_embed(fluid, ids, dict_dim,
                                                   hidden),
            output_fn=lambda x: _mt_output(fluid, x, dict_dim))
        ids, scores = layers.dynamic_decode(
            decoder, inits=init, max_step_num=max_step,
            encoder_output=tile(enc, [max_len, 2 * hidden]),
            encoder_output_proj=tile(enc_proj, [max_len, hidden]),
            encoder_padding_mask=tile(pad, [max_len]))
    return main, startup, ids, scores


def _lg_encoder(fluid, src, dict_dim, hidden):
    """(c)'s encoder: an embedding, fc(bias_attr=False) to 3·hidden into
    dynamic_gru (what fc_gru_fuse_pass fuses), its sequence_last_step
    through an fc with tanh. → [B, hidden]."""
    layers, P = fluid.layers, fluid.ParamAttr
    emb = layers.embedding(src, size=[dict_dim, hidden],
                           param_attr=P(name="lg_src_emb"))
    proj = layers.fc(emb, 3 * hidden, param_attr=P(name="lg_proj_w"),
                     bias_attr=False)
    gru = layers.dynamic_gru(proj, hidden, param_attr=P(name="lg_gru_w"),
                             bias_attr=P(name="lg_gru_b"))
    return layers.fc(layers.sequence_last_step(gru), hidden, act="tanh",
                     param_attr=P(name="lg_enc_w"),
                     bias_attr=P(name="lg_enc_b"))


def lg_encoder_program(fluid, dict_dim=MT_DICT, hidden=MT_HID):
    """(c)'s encoder alone (its inference program). → (main, startup,
    the encoder vector)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("lsrc", shape=[1], dtype="int64", lod_level=1)
        enc = _lg_encoder(fluid, src, dict_dim, hidden)
    return main, startup, enc


def lg_score_program(fluid, dict_dim=MT_DICT, hidden=MT_HID):
    """(c)'s DynamicRNN decoder, forward only: over each reference's
    tokens a gru_unit step from an fc of the token's embedding and the
    encoder vector (a static_input), the memory booted from the encoder
    vector (need_reorder), then the output fc and each next token's
    softmax_with_cross_entropy summed over the reference. → (main,
    startup, the scores [B, 1], the step outputs)."""
    layers, P = fluid.layers, fluid.ParamAttr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("lsrc", shape=[1], dtype="int64", lod_level=1)
        trg = fluid.data("ltrg", shape=[1], dtype="int64", lod_level=1)
        nxt = fluid.data("ltrg_next", shape=[1], dtype="int64", lod_level=1)
        enc = _lg_encoder(fluid, src, dict_dim, hidden)
        emb = layers.embedding(trg, size=[dict_dim, hidden],
                               param_attr=P(name="lg_trg_emb"))
        drnn = layers.DynamicRNN()
        with drnn.block():
            # the arrays' entries carry no static shape: fc reads its
            # input's width from it
            word = layers.reshape(drnn.step_input(emb), [-1, hidden])
            ctx = layers.reshape(drnn.static_input(enc), [-1, hidden])
            mem = drnn.memory(init=enc, need_reorder=True)
            x = layers.fc([word, ctx], 3 * hidden,
                          param_attr=[P(name="lg_dec_x_w"),
                                      P(name="lg_dec_c_w")],
                          bias_attr=False)
            h, _, _ = layers.gru_unit(x, mem, 3 * hidden,
                                      param_attr=P(name="lg_dec_gru_w"),
                                      bias_attr=P(name="lg_dec_gru_b"))
            drnn.update_memory(mem, h)
            drnn.output(h)
        hs = layers.reshape(drnn(), [-1, hidden])
        logits = layers.fc(hs, dict_dim, param_attr=P(name="lg_out_w"),
                           bias_attr=P(name="lg_out_b"))
        scores = layers.sequence_pool(
            layers.softmax_with_cross_entropy(logits, nxt), "sum")
    return main, startup, scores, hs


def _contrib_decoder(fluid):
    """``fluid.contrib.decoder`` of the package ``fluid`` belongs to."""
    import importlib
    return importlib.import_module(fluid.__name__ + ".contrib.decoder")


def _lg_state_cell(fluid, boot, hidden):
    """The contrib StateCell of (c)'s decoders: state h booted from
    ``boot``, updated by gru_unit over an fc of the input x."""
    layers, P = fluid.layers, fluid.ParamAttr
    dec = _contrib_decoder(fluid)
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=boot)},
                         out_state="h")

    @cell.state_updater
    def _update(c):
        g = layers.fc(c.get_input("x"), 3 * hidden,
                      param_attr=P(name="lg_td_in_w"), bias_attr=False)
        h, _, _ = layers.gru_unit(g, c.get_state("h"), 3 * hidden,
                                  param_attr=P(name="lg_td_gru_w"),
                                  bias_attr=P(name="lg_td_gru_b"))
        c.set_state("h", h)
    return cell


def lg_train_program(fluid, dict_dim=MT_DICT, hidden=MT_HID,
                     max_len=MT_LEN, lr=MT_LR):
    """(c)'s contrib TrainingDecoder over StaticRNN, booted by the LoD
    encoder: the padded targets time-major, the StateCell's gru_unit a
    step, the output fc, softmax_with_cross_entropy masked by the
    padding; Adam ``lr``. → (main, startup, loss)."""
    layers, P = fluid.layers, fluid.ParamAttr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("lsrc", shape=[1], dtype="int64", lod_level=1)
        trg = fluid.data("ttrg", shape=[max_len, -1], dtype="int64",
                         append_batch_size=False)
        nxt = fluid.data("ttrg_next", shape=[max_len, -1, 1], dtype="int64",
                         append_batch_size=False)
        mask = fluid.data("ttrg_mask", shape=[max_len, -1], dtype="float32",
                          append_batch_size=False)
        enc = _lg_encoder(fluid, src, dict_dim, hidden)
        emb = layers.embedding(trg, size=[dict_dim, hidden],
                               param_attr=P(name="lg_trg_emb"))
        cell = _lg_state_cell(fluid, enc, hidden)
        decoder = _contrib_decoder(fluid).TrainingDecoder(cell)
        with decoder.block():
            cell.compute_state({"x": decoder.step_input(emb)})
            decoder.output(cell.out_state())
        logits = layers.fc(decoder(), dict_dim, num_flatten_dims=2,
                           param_attr=P(name="lg_out_w"),
                           bias_attr=P(name="lg_out_b"))
        ce = layers.squeeze(layers.softmax_with_cross_entropy(logits, nxt),
                            [2])
        loss = layers.elementwise_div(
            layers.reduce_sum(layers.elementwise_mul(ce, mask)),
            layers.reduce_sum(mask))
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss


def lg_beam_program(fluid, dict_dim=MT_DICT, hidden=MT_HID, beam=MT_BEAM):
    """(c)'s contrib BeamSearchDecoder: ``decode()`` builds one beam step
    (the embedding of the previous ids, the StateCell, the output fc,
    softmax, top-k, the accumulated log-probabilities, beam_search),
    which the caller runs from the host once a step. Feeds: bs_ids and
    bs_scores (two-level LoD), bs_h (the state of each row). → (main,
    startup, selected ids, selected scores, parent rows, the new state of
    every row)."""
    layers, P = fluid.layers, fluid.ParamAttr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.data("bs_ids", shape=[1], dtype="int64", lod_level=2)
        scores = fluid.data("bs_scores", shape=[1], dtype="float32",
                            lod_level=2)
        h = fluid.data("bs_h", shape=[hidden], dtype="float32")
        cell = _lg_state_cell(fluid, h, hidden)
        bsd = _contrib_decoder(fluid).BeamSearchDecoder(
            cell, ids, scores, target_dict_dim=dict_dim, word_dim=hidden,
            beam_size=beam, end_id=MT_EOS)

        @bsd.embedding
        def _embed(x):
            return layers.embedding(x, size=[dict_dim, hidden],
                                    param_attr=P(name="lg_trg_emb"))

        @bsd.scoring
        def _score(state):
            return layers.fc(state, dict_dim, param_attr=P(name="lg_out_w"),
                             bias_attr=P(name="lg_out_b"))
        sel_ids, sel_scores, parent = bsd.decode()
    return main, startup, sel_ids, sel_scores, parent, cell.out_state()


RNN_CHECK_BATCH = 8           # (a) card vs CPU
MT_CHECK_BATCH = 2            # (b), (c) card vs CPU
RNN_RAGGED = 10               # (a) ragged batches, a new LoD each
RNN_TIMED = 20                # requests or runs timed, replayed
BEAM_REL = 1e-5               # a beam choice whose score is within this
#                               share of the next candidate's: a near-tie
LG_SCORE_TOL = (1e-4, 1e-5)   # (c) the scorer, card vs CPU (rtol, atol)
RNN_EXECS = ("eager", "capture", "replay")
# (c)'s served encoder after the passes (tests/test_torch_rnn_layers.py):
# fc_gru_fuse_pass turned its mul + dynamic_gru into fusion_gru
LG_ENC_CENSUS = {"lookup_table": 1, "fusion_gru": 1, "sequence_pool": 1,
                 "fc": 1, "tanh": 1}


def _rnn_memory():
    import torch
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _rnn_gate(exe, before, mode, what, book):
    """The last run of ``exe`` ran in ``mode`` ("compiled", "segmented"
    or "interpreted"), launched none of the twelve kernels through the
    wrappers and recorded none in its graphs. → how it executed."""
    delta = _delta(before)
    if mode == "compiled":
        kind = _gate_run(exe, delta, NO_KERNELS, what)
    elif mode == "interpreted":
        if exe._last_run_mode != mode or any(delta):
            raise AssertionError(f"{what} ran {exe._last_run_mode} with "
                                 f"launches {delta}, want {mode} and none")
        kind = mode
    else:
        if exe._last_run_mode != mode:
            raise AssertionError(f"{what} ran {exe._last_run_mode}, want "
                                 f"{mode}")
        cb = exe._last_block
        graph = tuple(cb.graph_launches.get(k, 0) for k in KERNELS)
        if any(delta) or any(graph):
            raise AssertionError(f"{what}: launches through the wrappers "
                                 f"{delta}, in the graphs {graph}")
        kind = cb.last_exec
    book.add(NO_KERNELS)
    return kind


def _rnn_lock(run, interp, main, feed, fetch, mode, book, what):
    """One run of ``main`` on ``run`` (executor, scope) gated on ``mode``,
    then the interpreter's on ``interp`` from the same state: every fetch
    and its LoD bitwise alike. → (the fetches as LoDTensors, how the run
    executed, its seconds)."""
    import numpy as np
    from paddle_tpu_torch.fluid import core
    exe, scope = run
    before = _launch_counts()
    t = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    dt = time.perf_counter() - t
    kind = _rnn_gate(exe, before, mode, f"{RNN_TAG} {what}", book)
    old = core.globals_["FLAGS_executor_mode"]
    core.set_flag("FLAGS_executor_mode", "interpreted")
    before = _launch_counts()
    try:
        iout = interp[0].run(main, feed=feed, fetch_list=fetch,
                             scope=interp[1], return_numpy=False)
    finally:
        core.set_flag("FLAGS_executor_mode", old)
    if _delta(before) != NO_KERNELS:
        raise AssertionError(f"{RNN_TAG} {what}, interpreted: launched "
                             f"{_delta(before)}")
    book.add(NO_KERNELS)
    for i, (a, c) in enumerate(zip(out, iout)):
        if not np.array_equal(a.numpy(), c.numpy()) or a.lod() != c.lod():
            raise AssertionError(f"{RNN_TAG} {what}: fetch {i} compiled "
                                 "and interpreted differ")
    return out, kind, dt


def _rnn_serve(book, what, main, startup, target, feed, census, tmp):
    """``main`` saved with ``target`` from its startup values and served
    by AnalysisPredictor: the census after the passes, every request gated
    (eager, capture, then replays), RNN_TIMED replays timed, the outputs
    against the unfused program's Executor.run within PRED_TOL. → the
    request p50 (ms)."""
    import numpy as np
    from paddle_tpu_torch import fluid, inference
    exe, scope = _fresh(main, startup)
    d = os.path.join(tmp, f"rnn{len(os.listdir(tmp))}")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, list(feed), [target], exe, main)
    pred = inference.create_predictor(inference.Config(d))
    got = _census(pred._program)
    if got != census:
        raise AssertionError(f"{RNN_TAG} {what}: census {got}, want "
                             f"{census}")
    _on_card(pred, what)
    kinds, times = [], []
    for i in range(len(RNN_EXECS) + RNN_TIMED):
        before = _launch_counts()
        t = time.perf_counter()
        outs = pred.run([feed[n] for n in pred.get_input_names()])
        times.append(time.perf_counter() - t)
        kinds.append(_rnn_gate(pred._exe, before, "compiled",
                               f"{RNN_TAG} {what} request {i}", book))
    if tuple(kinds[:3]) != RNN_EXECS or set(kinds[3:]) != {"replay"}:
        raise AssertionError(f"{RNN_TAG} {what}: requests ran {kinds}")
    ref = exe.run(main, feed=feed, fetch_list=[target], scope=scope,
                  use_prune=True)
    book.add(NO_KERNELS)
    same = np.array_equal(outs[0], ref[0])
    err = float(np.abs(outs[0] - ref[0]).max())
    ok = np.allclose(outs[0], ref[0], rtol=PRED_TOL[0], atol=PRED_TOL[1])
    p50 = float(np.median(times[3:])) * 1e3
    _log(f"{RNN_TAG} {what}: served by AnalysisPredictor, after the "
         f"passes {got}; requests {' '.join(kinds[:4])} ..., p50 "
         f"{p50:.3f} ms over {RNN_TIMED} replays on {_card_line()}; "
         f"outputs vs the unfused program's Executor.run: "
         + ("bitwise equal" if same else f"max|d| {err:.3e}")
         + f" (rtol {PRED_TOL[0]:g}, atol {PRED_TOL[1]:g}) -> "
         + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{RNN_TAG} {what}: served outputs disagree")
    pred._exe.close()
    exe.close()
    return p50


def _rnn_sentiment(book, tmp):
    """(a) The book's stacked-LSTM sentiment net (the docstring's phase
    21 (a)). → its readings."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, test, pred, loss, acc = _md_fixed(
        lambda: rnn_sentiment_program(
            fluid, LOD_VOCAB, RNN_EMB, RNN_HID, RNN_STACKED))
    rng = np.random.RandomState(SEED + 30)
    fixed = _sentiment_batch(rng, RNN_BATCH)
    res = _md_train(book, f"(a) stacked-LSTM sentiment net batch "
                    f"{RNN_BATCH} ({len(fixed[0])} words)",
                    _md_run(main, [loss, acc], _lod_feed(fixed)), [startup],
                    NO_KERNELS, tag=RNN_TAG)
    # ragged batches: a new LoD a step, each run eagerly, the cache of
    # plans and the card's memory bounded
    exe, scope = _fresh(main, startup)
    mem, times, losses = [_rnn_memory()], [], []
    for i in range(RNN_RAGGED):
        feed = _lod_feed(_sentiment_batch(rng, RNN_BATCH))
        before = _launch_counts()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t)
        if _rnn_gate(exe, before, "compiled", f"{RNN_TAG} (a) ragged step "
                     f"{i}", book) != "eager":
            raise AssertionError(f"{RNN_TAG} (a) a new LoD did not run "
                                 "eagerly")
        losses.append(float(out[0].reshape(-1)[0]))
        if i == RNN_RAGGED // 2 - 1:
            mem.append(_rnn_memory())
    mem.append(_rnn_memory())
    lod_keys = [k for k in exe._compiled_cache if k[-1]]
    consts = [t for st in exe._compiled_cache[lod_keys[-1]]._units
              for t in (st.attrs.get("_lodc") or {}).values()]
    const_bytes = sum(t.numel() * t.element_size() for t in consts)
    kept = fluid.Executor._LOD_PLANS_KEPT
    if not np.isfinite(losses).all() or len(lod_keys) > kept + 1 \
            or mem[2] - mem[1] > (kept + 1) * const_bytes:
        raise AssertionError(f"{RNN_TAG} (a) ragged steps: losses {losses}, "
                             f"{len(lod_keys)} LoD plans, memory {mem}")
    new_p50 = float(np.median(times)) * 1e3
    _log(f"{RNN_TAG} (a) {RNN_RAGGED} ragged batches of {RNN_BATCH}, each "
         f"a new LoD run eagerly: step p50 {new_p50:.3f} ms, losses "
         + " ".join(f"{x:.4f}" for x in losses) + f"; {len(lod_keys)} LoD "
         f"plans cached (kept {kept}), one holds {const_bytes} B of LoD "
         f"constants; device memory {mem[0]} B before, {mem[1]} after "
         f"{RNN_RAGGED // 2}, {mem[2]} after all on {_card_line()} -> ok")
    exe.close()
    _md_card_vs_cpu(book, f"(a) stacked-LSTM sentiment net batch "
                    f"{RNN_CHECK_BATCH}", main, startup, [loss],
                    _lod_feed(_sentiment_batch(rng, RNN_CHECK_BATCH)),
                    adaptive=True, tag=RNN_TAG)
    words = _lod_feed(_sentiment_batch(rng, RNN_BATCH))["words"]
    req = _rnn_serve(book, f"(a) stacked-LSTM sentiment net, a request of "
                     f"{RNN_BATCH} reviews", test, startup, pred,
                     {"words": words}, RNN_SENT_CENSUS, tmp)
    m, s, p = _md_fixed(lambda: rnn_lstm_classifier(
        fluid, LOD_VOCAB, RNN_EMB, RNN_HID))
    fused = _rnn_serve(book, f"(c) fusion_lstm: a bias-free projection into "
                       f"dynamic_lstm at (a)'s widths, {RNN_BATCH} reviews",
                       m, s, p, {"words": words}, RNN_FUSED_CENSUS, tmp)
    return dict(res, ragged_p50_ms=new_p50, request_p50_ms=req,
                fusion_lstm_request_p50_ms=fused)


def _mt_feed(rng, bs, decode=False):
    """A batch of ``bs`` pairs padded to MT_LEN: lengths drawn in
    LG_LENS, word ids from 2 (0 and 1 are bos and eos), eos closing each
    target."""
    import numpy as np
    lo, hi = LG_LENS
    src_len = rng.randint(lo, hi + 1, bs).astype(np.int64)
    feed = {"src": rng.randint(2, MT_DICT, (bs, MT_LEN)).astype(np.int64),
            "src_len": src_len}
    if decode:
        return feed
    trg_len = rng.randint(lo, hi + 1, bs).astype(np.int64)
    trg = rng.randint(2, MT_DICT, (bs, MT_LEN)).astype(np.int64)
    trg[:, 0] = MT_BOS
    nxt = np.concatenate([trg[:, 1:], np.full((bs, 1), MT_EOS)], 1)
    nxt[np.arange(bs), trg_len - 1] = MT_EOS
    feed.update(trg=trg, trg_next=nxt[..., None].astype(np.int64),
                trg_len=trg_len)
    return feed


def _beam_steps_agree(what, card, cpu, scores_cpu, beam):
    """Each step's choices on the card against the CPU's, row by row:
    equal, or a near-tie (the card's choices scored by the CPU within
    BEAM_REL of the CPU's own, elementwise), after which the row's later
    steps are not compared (the beams differ). ``card``, ``cpu``: each
    step's chosen indices [B, beam]; ``scores_cpu``: the CPU's candidate
    scores [B, n] a step. → (rows that stayed equal, near-ties)."""
    import numpy as np
    rows = card[0].shape[0]
    alive, near = set(range(rows)), 0
    for t, (g, c, x) in enumerate(zip(card, cpu, scores_cpu)):
        for b in sorted(alive):
            if np.array_equal(g[b], c[b]):
                continue
            mine, theirs = x[b][g[b]], x[b][c[b]]
            lim = BEAM_REL * np.abs(theirs)
            if not (np.abs(mine - theirs) <= lim).all():
                raise AssertionError(
                    f"{RNN_TAG} {what}: step {t} row {b} chose {g[b]} on the "
                    f"card, {c[b]} on the CPU, scores {mine} vs {theirs}")
            near += 1
            alive.discard(b)
    return alive, near


def _mt_decode(book, trained, feed, check_feed):
    """(b)'s beam decode on the card (the docstring's phase 21 (b)), with
    the parameters of ``trained``, the scope of (b)'s 10 steps (they
    share their names). → the decode p50 (ms)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, ids, scores = _md_fixed(lambda: mt_decode_program(
        fluid, MT_DICT, MT_HID, MT_LEN, MT_BEAM, MT_MAX_STEP))
    names = [v.name for v in main.list_vars() if v.persistable]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = _clone_scope(trained, names, "cuda")
    iexe = fluid.Executor(fluid.CUDAPlace(0))
    iscope = _clone_scope(scope, names, "cuda")
    kinds, times = [], []
    for i in range(len(RNN_EXECS)):
        out, kind, dt = _rnn_lock((exe, scope), (iexe, iscope), main, feed,
                                  [ids, scores], "compiled", book,
                                  f"(b) decode run {i}")
        kinds.append(kind)
    iexe.close()
    for i in range(RNN_TIMED // 2):
        before = _launch_counts()
        t = time.perf_counter()
        got = exe.run(main, feed=feed, fetch_list=[ids, scores], scope=scope)
        times.append(time.perf_counter() - t)
        kinds.append(_rnn_gate(exe, before, "compiled",
                               f"{RNN_TAG} (b) decode run", book))
    if tuple(kinds[:3]) != RNN_EXECS or set(kinds[3:]) != {"replay"}:
        raise AssertionError(f"{RNN_TAG} (b) decode runs {kinds}")

    def replay():
        exe.run(main, feed=feed, fetch_list=[ids, scores], scope=scope)
    _check_trace(_device_kernel_counts(replay, warm=replay), NO_KERNELS,
                 "(b) beam decode")
    book.add(NO_KERNELS, 2)
    p, s = got
    bs = feed["src"].shape[0]
    if p.shape != (bs, MT_MAX_STEP, MT_BEAM) or p.min() < 0 \
            or p.max() >= MT_DICT or not (np.diff(s, axis=1) <= 1e-6).all():
        raise AssertionError(f"{RNN_TAG} (b) decode: ids {p.shape} in "
                             f"[{p.min()}, {p.max()}], scores {s[:2]}")
    p50 = float(np.median(times)) * 1e3
    # the card against the CPU at MT_CHECK_BATCH: each step's top-k
    topks = [op for op in main.global_block().ops if op.type == "top_k"]
    fetch = [ids, scores] + [op.output("Indices")[0] for op in topks]
    gpu = exe.run(main, feed=check_feed, fetch_list=fetch, scope=scope)
    book.add(NO_KERNELS)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = cpu_exe.run(main, feed=check_feed, fetch_list=fetch + [
        op.input("X")[0] for op in topks],
        scope=_clone_scope(scope, names, "cpu"))
    n = len(topks)
    alive, near = _beam_steps_agree("(b) beam decode", gpu[2:2 + n],
                                    cpu[2:2 + n], cpu[2 + n:], MT_BEAM)
    keep = sorted(alive)
    same_ids = np.array_equal(gpu[0][keep], cpu[0][keep])
    score_ok = np.allclose(gpu[1][keep], cpu[1][keep], rtol=LOSS_TOL,
                           atol=0)
    _log(f"{RNN_TAG} (b) beam decode (beam {MT_BEAM}, {MT_MAX_STEP} steps, "
         f"bos {MT_BOS}, eos {MT_EOS}) of {bs} sources: runs "
         f"{' '.join(kinds[:4])} ..., the first {len(RNN_EXECS)} bitwise the "
         f"interpreter's; decode p50 {p50:.3f} ms over {RNN_TIMED // 2} "
         f"replays on {_card_line()}; card vs CPU at batch "
         f"{check_feed['src'].shape[0]}: {n} top-k steps, {near} near-ties "
         f"(within {BEAM_REL:g} relative), rows {keep} equal throughout: "
         f"ids {'equal' if same_ids else 'DIFFER'}, final scores "
         f"{'within' if score_ok else 'NOT within'} {LOSS_TOL:g} relative "
         f"-> {'ok' if same_ids and score_ok else 'FAIL'}")
    if not (same_ids and score_ok):
        raise AssertionError(f"{RNN_TAG} (b) decode: card vs CPU")
    exe.close()
    return {"decode_p50_ms": p50, "near_ties": near}


def _rnn_translator(book):
    """(b) The book's chapter 8 translator (the docstring's phase 21
    (b)). → its readings."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss = _md_fixed(lambda: mt_train_program(
        fluid, MT_DICT, MT_HID, MT_LEN))
    rng = np.random.RandomState(SEED + 31)
    res = _md_train(book, f"(b) GRU translator batch {MT_BATCH}, "
                    f"{MT_LEN} tokens",
                    _md_run(main, [loss], _mt_feed(rng, MT_BATCH)),
                    [startup], NO_KERNELS, tag=RNN_TAG, keep_scope=True)
    res.pop("exe").close()
    trained = res.pop("scope")
    # the book's attention adds the state's projection to every source
    # position's alike, and softmax takes out a shift: the grad of that
    # projection's weight is 0 but for rounding
    _md_card_vs_cpu(book, f"(b) GRU translator batch {MT_CHECK_BATCH}",
                    main, startup, [loss], _mt_feed(rng, MT_CHECK_BATCH),
                    adaptive=True, tag=RNN_TAG,
                    noise={"mt_att_state_w@GRAD"})
    res.update(_mt_decode(book, trained, _mt_feed(rng, MT_BATCH, decode=True),
                          _mt_feed(rng, MT_CHECK_BATCH, decode=True)))
    return res


def _lg_lod(rng, bs):
    """``bs`` ragged sequences of LG_LENS tokens: (ids [T, 1], offsets)."""
    import numpy as np
    lens = rng.randint(LG_LENS[0], LG_LENS[1] + 1, bs)
    offs = [0] + [int(x) for x in np.cumsum(lens)]
    return rng.randint(2, MT_DICT, (offs[-1], 1)).astype(np.int64), offs


def _lod_tensor(ids, offs):
    import torch
    from paddle_tpu_torch import fluid
    return fluid.LoDTensor(torch.from_numpy(ids), [offs])


def _lg_score_feed(rng, bs):
    import numpy as np
    src, soffs = _lg_lod(rng, bs)
    trg, toffs = _lg_lod(rng, bs)
    nxt = np.concatenate([trg[1:], [[MT_EOS]]]).astype(np.int64)
    nxt[np.asarray(toffs[1:]) - 1] = MT_EOS
    return {"lsrc": _lod_tensor(src, soffs), "ltrg": _lod_tensor(trg, toffs),
            "ltrg_next": _lod_tensor(nxt, toffs)}


def _lg_scorer(book, rng):
    """(c) The DynamicRNN scorer, forward only: segmented around its
    islands (the rank table, the arrays, the ``while``, run by the
    interpreter), eager, capture and replays, each bitwise the
    interpreter's; card vs CPU. → its run p50 (ms)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, scores, hs = _md_fixed(lambda: lg_score_program(
        fluid, MT_DICT, MT_HID))
    names = [v.name for v in main.list_vars() if v.persistable]
    exe, scope = _fresh(main, startup)
    iexe = fluid.Executor(fluid.CUDAPlace(0))
    iscope = _clone_scope(scope, names, "cuda")
    feed = _lg_score_feed(rng, MT_BATCH)
    kinds, times = [], []
    for i in range(len(RNN_EXECS) + 2):
        out, kind, dt = _rnn_lock((exe, scope), (iexe, iscope), main, feed,
                                  [scores, hs], "segmented", book,
                                  f"(c) DynamicRNN scorer run {i}")
        kinds.append(kind)
        if i >= len(RNN_EXECS):
            times.append(dt)
    iexe.close()
    if tuple(kinds[:3]) != RNN_EXECS or set(kinds[3:]) != {"replay"}:
        raise AssertionError(f"{RNN_TAG} (c) scorer runs {kinds}")
    cb = exe._last_block
    islands = sum(s.kind == "island" for s in cb.segments)
    for i in range(RNN_TIMED // 2):
        before = _launch_counts()
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[scores, hs], scope=scope)
        times.append(time.perf_counter() - t)
        _rnn_gate(exe, before, "segmented", f"{RNN_TAG} (c) scorer run",
                  book)
    s = out[0].numpy()
    if s.shape != (MT_BATCH, 1) or not np.isfinite(s).all():
        raise AssertionError(f"{RNN_TAG} (c) scores {s.shape}")
    check = _lg_score_feed(rng, MT_CHECK_BATCH)
    gpu = exe.run(main, feed=check, fetch_list=[scores, hs], scope=scope)
    book.add(NO_KERNELS)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=check, fetch_list=[scores, hs],
        scope=_clone_scope(scope, names, "cpu"))
    errs = [float(np.abs(a - b).max()) for a, b in zip(gpu, cpu)]
    ok = all(np.allclose(a, b, rtol=LG_SCORE_TOL[0], atol=LG_SCORE_TOL[1])
             for a, b in zip(gpu, cpu))
    p50 = float(np.median(times)) * 1e3
    _log(f"{RNN_TAG} (c) DynamicRNN scorer (gru_unit, need_reorder memory, "
         f"static_input) over {MT_BATCH} references of "
         f"{LG_LENS[0]}-{LG_LENS[1]} tokens: segmented, {len(cb.segments)} "
         f"segments ({islands} islands, the while in the interpreter: each "
         f"step's batch is its rank-table prefix), runs {' '.join(kinds)}, "
         f"each bitwise the interpreter's; run p50 {p50:.3f} ms on "
         f"{_card_line()}; card vs CPU at batch {MT_CHECK_BATCH}: scores "
         f"max|d| {errs[0]:.3e}, step outputs {errs[1]:.3e} (rtol "
         f"{LG_SCORE_TOL[0]:g}, atol {LG_SCORE_TOL[1]:g}) -> "
         + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{RNN_TAG} (c) scorer: card vs CPU")
    exe.close()
    return p50


def _lg_beam(book, rng):
    """(c) The contrib BeamSearchDecoder's step program run from the host
    LG_BEAM_STEPS steps over MT_BATCH sources (each step in lock step with
    the interpreter), beam_search_decode's backtrace; the card against
    the CPU at MT_CHECK_BATCH, each step from the card's beam state. → the
    step p50 (ms)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    tmain, tstart, _ = _md_fixed(lambda: lg_train_program(
        fluid, MT_DICT, MT_HID, MT_LEN))
    emain, _, enc = _md_fixed(lambda: lg_encoder_program(
        fluid, MT_DICT, MT_HID))
    bmain, _, sel_ids, sel_sc, parent, new_h = _md_fixed(
        lambda: lg_beam_program(fluid, MT_DICT, MT_HID, MT_BEAM))
    names = [v.name for v in tmain.list_vars() if v.persistable]
    exe, scope = _fresh(tmain, tstart)
    iexe = fluid.Executor(fluid.CUDAPlace(0))
    iscope = _clone_scope(scope, names, "cuda")
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cscope = _clone_scope(scope, names, "cpu")
    fetch = [sel_ids, sel_sc, parent, new_h]
    acc = [op for op in bmain.global_block().ops
           if op.type == "beam_search"][0].input("scores")[0]

    def start(bs):
        src, offs = _lg_lod(rng, bs)
        (h,) = exe.run(emain, feed={"lsrc": _lod_tensor(src, offs)},
                       fetch_list=[enc], scope=scope)
        lod = [list(range(bs + 1))] * 2
        return (np.full((bs, 1), MT_BOS, np.int64), np.zeros((bs, 1),
                np.float32), lod, h)

    def feed_of(state):
        ids, sc, lod, h = state
        return {"bs_ids": fluid.LoDTensor(torch.from_numpy(ids), lod),
                "bs_scores": fluid.LoDTensor(torch.from_numpy(sc), lod),
                "bs_h": h}

    def advance(out):
        ids, sc, par, h = out
        return (ids.numpy(), sc.numpy(), ids.lod(),
                h.numpy()[par.numpy().astype(np.int64)])
    state, steps, times = start(MT_BATCH), [], []
    for t in range(LG_BEAM_STEPS):
        out, kind, dt = _rnn_lock((exe, scope), (iexe, iscope), bmain,
                                  feed_of(state), fetch,
                                  _lg_beam_mode(bmain), book,
                                  f"(c) beam step {t}")
        times.append(dt)
        steps.append(out)
        state = advance(out)
    iexe.close()
    # beam_search_decode over the steps' selections
    dmain = fluid.Program()
    with fluid.program_guard(dmain, fluid.Program()):
        block = dmain.global_block()
        arrs = [block.create_var(
            name=n, type=fluid.core.VarDesc.VarType.LOD_TENSOR_ARRAY,
            dtype=d) for n, d in (("lg_step_ids", "int64"),
                                  ("lg_step_scores", "float32"))]
        sent_ids, sent_sc = fluid.layers.beam_search_decode(
            arrs[0], arrs[1], MT_BEAM, MT_EOS)
    for k, a in enumerate(arrs):
        arr = scope.var(a.name).get_lod_tensor_array()
        arr.clear()
        arr.extend(s[k] for s in steps)
    sid, ssc = exe.run(dmain, fetch_list=[sent_ids, sent_sc], scope=scope,
                       return_numpy=False)
    lod = sid.lod()
    hyps = len(lod[1]) - 1
    if len(lod[0]) != MT_BATCH + 1 or hyps != lod[0][-1] \
            or sid.numpy().min() < 0 or sid.numpy().max() >= MT_DICT:
        raise AssertionError(f"{RNN_TAG} (c) beam_search_decode: LoD "
                             f"{[len(x) for x in lod]}")
    # the card against the CPU from the card's state, step by step
    state, near, equal = start(MT_CHECK_BATCH), 0, 0
    for t in range(LG_BEAM_STEPS):
        f = feed_of(state)
        g = exe.run(bmain, feed=f, fetch_list=fetch, scope=scope,
                    return_numpy=False)
        book.add(NO_KERNELS)
        c = cpu_exe.run(bmain, feed=f, fetch_list=fetch, scope=cscope,
                        return_numpy=False)
        gi, ci = g[0].numpy().reshape(-1), c[0].numpy().reshape(-1)
        gs, cs_ = g[1].numpy().reshape(-1), c[1].numpy().reshape(-1)
        if g[0].lod() == c[0].lod() and np.array_equal(gi, ci):
            equal += 1
        elif len(gs) == len(cs_) and (np.abs(np.sort(gs) - np.sort(cs_))
                                      <= BEAM_REL * np.abs(np.sort(cs_))
                                      ).all():
            near += 1
        else:
            raise AssertionError(f"{RNN_TAG} (c) beam step {t}: card "
                                 f"{gi} {gs}, CPU {ci} {cs_}")
        state = advance(g)
    p50 = float(np.median(times)) * 1e3
    _log(f"{RNN_TAG} (c) contrib BeamSearchDecoder (beam {MT_BEAM}): "
         f"{LG_BEAM_STEPS} host-stepped steps over {MT_BATCH} sources "
         f"({_lg_beam_mode(bmain)}), each bitwise the interpreter's, step "
         f"p50 {p50:.3f} ms on {_card_line()}; beam_search_decode: {hyps} "
         f"hypotheses, {len(sid.numpy())} tokens; card vs CPU at batch "
         f"{MT_CHECK_BATCH} from the card's beam state: {equal} steps "
         f"equal, {near} near-ties (scores within {BEAM_REL:g} relative) "
         f"-> ok")
    exe.close()
    return p50


def _lg_beam_mode(main):
    """How Executor.run runs the beam step program: "segmented" when its
    compiled ops reach FLAGS_executor_seg_min_ops, else "interpreted"."""
    from paddle_tpu_torch.fluid import core
    from paddle_tpu_torch.fluid.ir import op_island_reason
    n = sum(op_island_reason(op) is None for op in main.global_block().ops)
    return ("segmented" if n >= int(core.globals_[
        "FLAGS_executor_seg_min_ops"]) else "interpreted")


def _rnn_legacy(book, tmp):
    """(c) The legacy LoD path at (b)'s widths (the docstring's phase 21
    (c)). → its readings."""
    import numpy as np
    from paddle_tpu_torch import fluid
    rng = np.random.RandomState(SEED + 32)
    src, offs = _lg_lod(rng, MT_BATCH)
    m, s, e = _md_fixed(lambda: lg_encoder_program(
        fluid, MT_DICT, MT_HID))
    enc = _rnn_serve(book, f"(c) encoder (fc_gru_fuse_pass), {MT_BATCH} "
                     "sources", m, s, e, {"lsrc": _lod_tensor(src, offs)},
                     LG_ENC_CENSUS, tmp)
    score = _lg_scorer(book, rng)
    main, startup, loss = _md_fixed(lambda: lg_train_program(
        fluid, MT_DICT, MT_HID, MT_LEN))

    def train_feed(bs):
        src, offs = _lg_lod(rng, bs)
        lens = rng.randint(LG_LENS[0], LG_LENS[1] + 1, bs)
        return {"lsrc": _lod_tensor(src, offs),
                "ttrg": rng.randint(2, MT_DICT, (MT_LEN, bs)).astype(
                    np.int64),
                "ttrg_next": rng.randint(2, MT_DICT, (MT_LEN, bs, 1)).astype(
                    np.int64),
                "ttrg_mask": (np.arange(MT_LEN)[:, None] < lens[None, :]
                              ).astype(np.float32)}
    res = _md_train(book, f"(c) contrib TrainingDecoder (StaticRNN, "
                    f"gru_unit) batch {MT_BATCH}, {MT_LEN} steps",
                    _md_run(main, [loss], train_feed(MT_BATCH)), [startup],
                    NO_KERNELS, tag=RNN_TAG)
    _md_card_vs_cpu(book, f"(c) contrib TrainingDecoder batch "
                    f"{MT_CHECK_BATCH}", main, startup, [loss],
                    train_feed(MT_CHECK_BATCH), adaptive=True, tag=RNN_TAG)
    beam = _lg_beam(book, rng)
    return dict(res, encoder_request_p50_ms=enc, scorer_p50_ms=score,
                beam_step_p50_ms=beam)


def phase_rnn():
    """Phase 21: the recurrences (the docstring's phase 21). → the
    launches of its main paths: through the wrappers and on the card."""
    import tempfile
    book = _CfBook()
    _reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = {"sentiment": _rnn_sentiment(book, tmp),
               "translator": _rnn_translator(book),
               "legacy": _rnn_legacy(book, tmp)}
    wrapper = _launch_counts()
    if any(wrapper) or any(book.executed):
        raise AssertionError(f"{RNN_TAG} phase 21 launched {wrapper}, on the "
                             f"card {book.executed}")
    _log(f"{RNN_TAG} phase 21 in {time.perf_counter() - t0:.1f} s: step p50 "
         f"(a) {res['sentiment']['p50_ms']:.3f} ms, request "
         f"{res['sentiment']['request_p50_ms']:.3f} ms; (b) "
         f"{res['translator']['p50_ms']:.3f} ms, decode "
         f"{res['translator']['decode_p50_ms']:.3f} ms; (c) training "
         f"{res['legacy']['p50_ms']:.3f} ms, scorer "
         f"{res['legacy']['scorer_p50_ms']:.3f} ms, beam step "
         f"{res['legacy']['beam_step_p50_ms']:.3f} ms; launches through the "
         f"wrappers {GATE_NAMES} {wrapper}, on the card "
         f"{tuple(book.executed)}")
    return {"wrapper": wrapper, "executed": tuple(book.executed), **res}



# --------------------------------------------------------------------------
# phase 22: the vision and loss op batch. CycleGAN, DeepLabv3+ and CRNN-CTC
# are user programs built from fluid.layers: each builder takes the
# ``fluid`` module (the port's, or the TPU package's in the parity tests),
# a depth and a width scale, and builds the same ops in both. Neither
# package gives pad2d's or conv2d_transpose's output a static shape, so
# the programs reshape to it where a later layer reads it.
# --------------------------------------------------------------------------
VS_TAG = "[vision]"
GAN_IMAGE = 256               # (a) CycleGAN (Zhu et al. 2017, appendix 7.2):
GAN_BLOCKS = 9                # 256x256, ResNet-9-block generators, 70x70
GAN_LR = 2e-4                 # PatchGAN discriminators, Adam 2e-4 with
GAN_BETA1 = 0.5               # beta1 0.5, batch 1, LSGAN losses, cycle
GAN_CYCLE = 10.0              # L1 with lambda 10
DL_CLASSES = 19               # (b) DeepLabv3+ (Chen et al. 2018) on
DL_CROP = 769                 # Cityscapes shapes: 19 classes, 769x769
DL_BATCH = 4                  # crops, batch 4, aligned Xception-65 at
DL_MIDDLE = 16                # output stride 16 (16 middle-flow blocks)
DL_LR = 0.01                  # Momentum 0.9 under polynomial_decay power
DL_DECAY_STEPS = 90000        # 0.9 (PaddleCV's deeplabv3+ schedule),
DL_L2 = 4e-5                  # L2Decay 4e-5, dropout 0.1 after the ASPP
DL_DROPOUT = 0.1              # projection; label 255 ignored
DL_IGNORE = 255
DL_CHECK_CROP = 129           # card vs CPU at 129x129, batch 2, one
DL_CHECK_MIDDLE = 1           # middle-flow block, its first update held
                              # and each later step from the card's
                              # state: at random weights the net is
                              # chaotic, the image one ulp up parts the
                              # card from itself as far as from the CPU
                              # (PERF.md)
CRNN_SHAPE = (1, 48, 512)     # (c) CRNN-CTC (PaddleCV ocr_recognition's
CRNN_CLASSES = 95             # crnn_ctc_model.py): grayscale 48x512, 95
CRNN_HID = 200                # classes and the blank, GRU 200 each way,
CRNN_BATCH = 32               # batch 32, labels of 3-12 symbols,
CRNN_LABEL = (3, 12)          # Momentum 1e-3 / 0.9 with L2Decay 4e-4
CRNN_LR = 1e-3
CRNN_L2 = 4e-4


def _w(width, c):
    return max(1, int(round(c * width)))


def _gan_attr(fluid, name, std=0.02):
    return fluid.ParamAttr(name=name,
                           initializer=fluid.initializer.Normal(0.0, std))


def _gan_in(fluid, x, name, act):
    """instance_norm, then ReLU or a leaky ReLU of slope 0.2."""
    x = fluid.layers.instance_norm(
        x, param_attr=fluid.ParamAttr(name=name + "_in_scale"),
        bias_attr=fluid.ParamAttr(name=name + "_in_offset"))
    if act == "relu":
        return fluid.layers.relu(x)
    return fluid.layers.leaky_relu(x, 0.2)


def _gan_reflect(fluid, x, pad, shape):
    """x padded by reflection, reshaped to its static shape."""
    n, c, h, w = shape
    y = fluid.layers.pad2d(x, [pad] * 4, mode="reflect")
    return fluid.layers.reshape(y, [n, c, h + 2 * pad, w + 2 * pad])


def gan_generator(fluid, x, name, batch, image, blocks, width):
    """The ResNet generator: c7s1-64, d128, d256, ``blocks`` x R256, u128,
    u64, c7s1-3 (reflection padding, instance_norm, conv2d_transpose 3x3
    stride 2 to twice the size for the u-layers), tanh out."""
    L = fluid.layers
    c1, c2, c3 = _w(width, 64), _w(width, 128), _w(width, 256)

    def conv(v, tag, nf, k, s, p, bias=False):
        return L.conv2d(v, nf, k, stride=s, padding=p,
                        param_attr=_gan_attr(fluid, f"{name}_{tag}_w"),
                        bias_attr=(fluid.ParamAttr(name=f"{name}_{tag}_b")
                                   if bias else False))

    y = _gan_reflect(fluid, x, 3, (batch, 3, image, image))
    y = _gan_in(fluid, conv(y, "c0", c1, 7, 1, 0), f"{name}_c0", "relu")
    y = _gan_in(fluid, conv(y, "d1", c2, 3, 2, 1), f"{name}_d1", "relu")
    y = _gan_in(fluid, conv(y, "d2", c3, 3, 2, 1), f"{name}_d2", "relu")
    q = image // 4
    for i in range(blocks):
        r = _gan_reflect(fluid, y, 1, (batch, c3, q, q))
        r = _gan_in(fluid, conv(r, f"r{i}a", c3, 3, 1, 0), f"{name}_r{i}a",
                    "relu")
        r = _gan_reflect(fluid, r, 1, (batch, c3, q, q))
        r = fluid.layers.instance_norm(
            conv(r, f"r{i}b", c3, 3, 1, 0),
            param_attr=fluid.ParamAttr(name=f"{name}_r{i}b_in_scale"),
            bias_attr=fluid.ParamAttr(name=f"{name}_r{i}b_in_offset"))
        y = L.elementwise_add(y, r)
    for tag, nf, size in (("u1", c2, image // 2), ("u2", c1, image)):
        y = L.conv2d_transpose(
            y, nf, output_size=[size, size], filter_size=3, padding=1,
            stride=2, param_attr=_gan_attr(fluid, f"{name}_{tag}_w"),
            bias_attr=False)
        y = L.reshape(y, [batch, nf, size, size])
        y = _gan_in(fluid, y, f"{name}_{tag}", "relu")
    y = _gan_reflect(fluid, y, 3, (batch, c1, image, image))
    return L.tanh(conv(y, "out", 3, 7, 1, 0, bias=True))


def gan_discriminator(fluid, x, name, width):
    """The 70x70 PatchGAN: C64 (no norm), C128, C256 (4x4 stride 2),
    C512 (stride 1), each with a leaky ReLU 0.2, then a 4x4 conv to one
    channel."""
    L = fluid.layers

    def conv(v, tag, nf, s, bias):
        return L.conv2d(v, nf, 4, stride=s, padding=1,
                        param_attr=_gan_attr(fluid, f"{name}_{tag}_w"),
                        bias_attr=(fluid.ParamAttr(name=f"{name}_{tag}_b")
                                   if bias else False))

    y = L.leaky_relu(conv(x, "c64", _w(width, 64), 2, True), 0.2)
    for tag, nf, s in (("c128", 128, 2), ("c256", 256, 2), ("c512", 512, 1)):
        y = _gan_in(fluid, conv(y, tag, _w(width, nf), s, False),
                    f"{name}_{tag}", "leaky")
    return conv(y, "out", 1, 1, True)


def _gan_params(program, prefixes):
    return [p.name for p in program.global_block().all_parameters()
            if p.name.split("_")[0] in prefixes]


def _gan_mse_to(fluid, x, value):
    return fluid.layers.mse_loss(
        x, fluid.layers.fill_constant(list(x.shape), "float32", value))


def cyclegan_programs(fluid, depth=GAN_BLOCKS, width=1.0, batch=1,
                      image=GAN_IMAGE, lr=GAN_LR):
    """(a) CycleGAN: generators gA (A to B) and gB (B to A) of ``depth``
    residual blocks, discriminators dA and dB, channels times ``width``.
    Three programs, a training step running each once in turn: the
    generators' (LSGAN losses against 1 through both discriminators plus
    GAN_CYCLE times the two cycle L1s; Adam over gA and gB), then dA's and
    dB's (half the LSGAN losses of the real images against 1 and of the
    generators' fakes, fed, against 0; Adam over each one's own). The
    parameters are shared by name. → ({"g", "da", "db"}: (main, startup,
    loss, ...)); g also returns the fakes fed to da and db."""
    L = fluid.layers
    shape = [batch, 3, image, image]

    def program(build):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            return (main, startup) + build(main)

    def adam(loss, main, prefixes):
        fluid.optimizer.Adam(lr, beta1=GAN_BETA1).minimize(
            loss, parameter_list=_gan_params(main, prefixes))

    def gen(main):
        a = L.data("real_A", shape, append_batch_size=False)
        b = L.data("real_B", shape, append_batch_size=False)
        fake_b = gan_generator(fluid, a, "gA", batch, image, depth, width)
        fake_a = gan_generator(fluid, b, "gB", batch, image, depth, width)
        cyc_a = gan_generator(fluid, fake_b, "gB", batch, image, depth,
                              width)
        cyc_b = gan_generator(fluid, fake_a, "gA", batch, image, depth,
                              width)
        gan = L.elementwise_add(
            _gan_mse_to(fluid, gan_discriminator(fluid, fake_b, "dB",
                                                 width), 1.0),
            _gan_mse_to(fluid, gan_discriminator(fluid, fake_a, "dA",
                                                 width), 1.0))
        cyc = L.elementwise_add(
            L.reduce_mean(L.abs(L.elementwise_sub(cyc_a, a))),
            L.reduce_mean(L.abs(L.elementwise_sub(cyc_b, b))))
        loss = L.elementwise_add(gan, L.scale(cyc, GAN_CYCLE))
        adam(loss, main, ("gA", "gB"))
        return loss, fake_a, fake_b

    def disc(name, real, fake):
        def build(main):
            r = L.data(real, shape, append_batch_size=False)
            f = L.data(fake, shape, append_batch_size=False)
            loss = L.scale(L.elementwise_add(
                _gan_mse_to(fluid, gan_discriminator(fluid, r, name, width),
                            1.0),
                _gan_mse_to(fluid, gan_discriminator(fluid, f, name, width),
                            0.0)), 0.5)
            adam(loss, main, (name,))
            return (loss,)
        return build

    return {"g": program(gen),
            "da": program(disc("dA", "real_A", "fake_A")),
            "db": program(disc("dB", "real_B", "fake_B"))}


def _dl_conv_bn(fluid, x, nf, k, s=1, dilation=1, groups=1, act="relu"):
    """conv (no bias, same padding) + batch_norm (+ ReLU)."""
    y = fluid.layers.conv2d(
        x, nf, k, stride=s, padding=dilation * (k // 2), dilation=dilation,
        groups=groups, bias_attr=False,
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Normal(0.0, 0.09)))
    return fluid.layers.batch_norm(y, act=act)


def _dl_sep(fluid, x, nf, s=1, dilation=1, act="relu"):
    """Depthwise separable 3x3: the depthwise conv with BN and ReLU, the
    1x1 pointwise conv with BN (and ReLU), as the aligned Xception of
    DeepLabv3+ adds them."""
    c = x.shape[1]
    y = _dl_conv_bn(fluid, x, c, 3, s, dilation, groups=c)
    return _dl_conv_bn(fluid, y, nf, 1, act=act)


def _dl_block(fluid, x, widths, stride, dilation=1, skip="conv"):
    """An Xception block: three separable convs (the last at ``stride``)
    and a shortcut (a 1x1 conv with BN at ``stride``, or the identity).
    → (the output, the second conv's output: the decoder's low-level
    features)."""
    y = x
    mids = []
    for i, nf in enumerate(widths):
        y = _dl_sep(fluid, y, nf, stride if i == 2 else 1, dilation,
                    act="relu" if i < 2 else None)
        mids.append(y)
    short = x if skip == "identity" else _dl_conv_bn(
        fluid, x, widths[-1], 1, stride, act=None)
    return fluid.layers.relu(fluid.layers.elementwise_add(y, short)), \
        mids[1]


def deeplab_program(fluid, depth=DL_MIDDLE, width=1.0, crop=DL_CROP,
                    classes=DL_CLASSES, lr=DL_LR):
    """(b) DeepLabv3+: the aligned Xception-65 at output stride 16
    (entry flow 32, 64, blocks of 128, 256 and 728; ``depth`` middle-flow
    blocks of 728; exit flow 728-1024-1024 and 1536-1536-2048 at dilation
    2), channels times ``width``; ASPP (image pooling by reduce_mean, a
    1x1 conv and resize_bilinear; a 1x1 and three separable 3x3 atrous
    branches at rates 6, 12, 18; all 256) projected to 256 with dropout
    DL_DROPOUT; the decoder (low-level features to 48, the encoder
    upsampled x4, two 3x3 convs of 256, a 1x1 conv to the classes,
    upsampled x4 to the crop). The loss: softmax_with_cross_entropy over
    the NHWC-flattened logits with ignore_index DL_IGNORE, summed over
    the valid pixels' count. Momentum 0.9 under polynomial_decay(power
    0.9), L2Decay DL_L2. The eval clone (taken before the optimizer)
    computes mean_iou. → (main, startup, eval clone, loss, mean IoU,
    wrong, correct)."""
    L = fluid.layers
    cw = lambda c: _w(width, c)  # noqa: E731
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", [3, crop, crop], "float32")
        label = fluid.data("label", [1, crop, crop], "int64")
        y = _dl_conv_bn(fluid, img, cw(32), 3, 2)
        y = _dl_conv_bn(fluid, y, cw(64), 3)
        y, _ = _dl_block(fluid, y, [cw(128)] * 3, 2)
        y, low = _dl_block(fluid, y, [cw(256)] * 3, 2)
        y, _ = _dl_block(fluid, y, [cw(728)] * 3, 2)
        for _ in range(depth):
            y, _ = _dl_block(fluid, y, [cw(728)] * 3, 1, skip="identity")
        y, _ = _dl_block(fluid, y, [cw(728), cw(1024), cw(1024)], 1, 2)
        for nf in (1536, 1536, 2048):
            y = _dl_sep(fluid, y, cw(nf), dilation=2)
        fh = y.shape[2]
        pool = L.reduce_mean(y, dim=[2, 3], keep_dim=True)
        pool = _dl_conv_bn(fluid, pool, cw(256), 1)
        branches = [L.resize_bilinear(pool, out_shape=[fh, fh]),
                    _dl_conv_bn(fluid, y, cw(256), 1)]
        branches += [_dl_sep(fluid, y, cw(256), dilation=r)
                     for r in (6, 12, 18)]
        enc = _dl_conv_bn(fluid, L.concat(branches, axis=1), cw(256), 1)
        enc = L.dropout(enc, DL_DROPOUT,
                        dropout_implementation="upscale_in_train")
        lh = low.shape[2]
        dec = L.concat([L.resize_bilinear(enc, out_shape=[lh, lh]),
                        _dl_conv_bn(fluid, low, cw(48), 1)], axis=1)
        dec = _dl_conv_bn(fluid, dec, cw(256), 3)
        dec = _dl_conv_bn(fluid, dec, cw(256), 3)
        logit = L.conv2d(dec, classes, 1)
        logit = L.resize_bilinear(logit, out_shape=[crop, crop])
        flat = L.reshape(L.transpose(logit, [0, 2, 3, 1]), [-1, classes])
        lbl = L.reshape(label, [-1, 1])
        ce = L.softmax_with_cross_entropy(flat, lbl, ignore_index=DL_IGNORE)
        valid = L.cast(L.less_than(
            L.cast(lbl, "float32"),
            L.fill_constant([1], "float32", float(classes))), "float32")
        valid.stop_gradient = True
        loss = L.elementwise_div(L.reduce_sum(ce), L.reduce_sum(valid))
        pred = L.argmax(logit, axis=1)
        miou, wrong, correct = L.mean_iou(pred, L.reshape(label, [-1, crop,
                                                                  crop]),
                                          classes)
        test = main.clone(for_test=True)
        sched = L.polynomial_decay(lr, DL_DECAY_STEPS, power=0.9)
        fluid.optimizer.Momentum(
            sched, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(DL_L2)).minimize(loss)
    return main, startup, test, loss, miou, wrong, correct


def crnn_program(fluid, width=1.0, hidden=CRNN_HID, classes=CRNN_CLASSES,
                 shape=CRNN_SHAPE, lr=CRNN_LR):
    """(c) CRNN-CTC: four groups of two 3x3 convs (16, 32, 64, 128 filters
    times ``width``) with BN and ReLU, each group then a 2x2 max pool;
    im2sequence over the remaining height; two fc of 3 x ``hidden`` into
    dynamic_gru forward and reverse (candidate ReLU); an fc of both to
    ``classes`` + 1; warpctc with the blank last and norm_by_times,
    summed. ctc_greedy_decoder's ids scored by edit_distance against the
    label. Momentum ``lr`` / 0.9 with L2Decay CRNN_L2. → (main, startup,
    the summed loss, the decoded ids, the distances)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("pixel", list(shape), "float32")
        label = fluid.data("label", [1], "int32", lod_level=1)
        y = img
        for nf in (16, 32, 64, 128):
            for _ in range(2):
                y = L.batch_norm(L.conv2d(y, _w(width, nf), 3, padding=1,
                                          bias_attr=False), act="relu")
            y = L.pool2d(y, 2, "max", 2)
        feat = y.shape[1] * y.shape[2]
        seq = L.reshape(L.im2sequence(y, filter_size=[y.shape[2], 1],
                                      stride=[1, 1]), [-1, feat])
        init = fluid.initializer.Normal(0.0, 0.02)
        grus = [L.dynamic_gru(
            L.fc(seq, 3 * hidden, param_attr=fluid.ParamAttr(
                initializer=init), bias_attr=False),
            hidden, is_reverse=rev, candidate_activation="relu",
            param_attr=fluid.ParamAttr(initializer=init),
            bias_attr=fluid.ParamAttr(initializer=init))
            for rev in (False, True)]
        logits = L.fc(grus, classes + 1,
                      param_attr=fluid.ParamAttr(initializer=init))
        cost = L.warpctc(logits, label, blank=classes, norm_by_times=True)
        loss = L.reduce_sum(cost)
        decoded = L.ctc_greedy_decoder(logits, blank=classes)
        dist, _ = L.edit_distance(decoded, L.cast(label, "int64"),
                                  normalized=False)
        fluid.optimizer.Momentum(
            lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(CRNN_L2)).minimize(loss)
    return main, startup, loss, decoded, dist



def _vs_x(rng, *shape):
    return rng.normal(size=shape).astype("float32")


def _vs_battery():
    """(d) One case of every op type phase 22's batch registers: (op type,
    its inputs as numpy arrays, attrs, the ``_lod`` attr or None, the
    slots its generic grad is taken for). Made from a seed; the parity
    tests run the same cases against the TPU package."""
    import numpy as np
    r = np.random.RandomState(SEED + 22)
    x = lambda *s: _vs_x(r, *s)  # noqa: E731
    x4, x5 = x(2, 6, 5, 4), x(2, 3, 6, 5, 4)
    s6, b6 = x(6) + 1.0, x(6)

    def probs(*s):
        e = np.exp(x(*s))
        return (e / e.sum(-1, keepdims=True)).astype("float32")

    def spd(n):
        a = x(n, n)
        return (a @ a.T + n * np.eye(n)).astype("float32")

    lbl = np.array([[1], [0], [3], [2], [3]], "int64")
    ctc_lod = {"Logits": [((0, 7, 12, 21),)], "Label": [((0, 3, 5, 9),)]}
    miou_lbl = r.randint(0, 5, (2, 8, 8)).astype("int32")
    miou_lbl[r.rand(2, 8, 8) < 0.3] = 255
    cases = [
        # nn_ops: the losses
        ("log_softmax", {"X": [x(3, 4, 5)]}, {"axis": 1}, None, ["X"]),
        ("cross_entropy2", {"X": [probs(5, 4)], "Label": [lbl]}, {}, None,
         ["X"]),
        ("sigmoid_cross_entropy_with_logits",
         {"X": [x(4, 3)], "Label": [np.array(
             [[1, 0, -1], [0, 1, 1], [-1, -1, 0], [1, 1, 0]], "float32")]},
         {"ignore_index": -1, "normalize": True}, None, ["X"]),
        ("bce_loss", {"X": [1 / (1 + np.exp(-x(4, 3)))],
                      "Label": [(x(4, 3) > 0).astype("float32")]}, {}, None,
         ["X"]),
        ("huber_loss", {"X": [x(5, 1)], "Y": [x(5, 1)]}, {"delta": 0.6},
         None, ["X"]),
        ("smooth_l1_loss", {"X": [x(4, 3, 2)], "Y": [x(4, 3, 2)],
                            "InsideWeight": [np.abs(x(4, 3, 2))],
                            "OutsideWeight": [np.abs(x(4, 3, 2))]},
         {"sigma": 1.5}, None, ["X"]),
        ("kldiv_loss", {"X": [x(3, 4)], "Target": [probs(3, 4)]},
         {"reduction": "batchmean"}, None, ["X"]),
        ("hinge_loss", {"Logits": [x(5, 1)],
                        "Labels": [(x(5, 1) > 0).astype("float32")]}, {},
         None, ["Logits"]),
        ("rank_loss", {"Label": [(x(5, 1) > 0).astype("float32")],
                       "Left": [x(5, 1)], "Right": [x(5, 1)]}, {}, None,
         ["Left", "Right"]),
        ("margin_rank_loss", {"Label": [np.sign(x(5, 1))], "X1": [x(5, 1)],
                              "X2": [x(5, 1)]}, {"margin": 0.1}, None,
         ["X1", "X2"]),
        ("nll_loss", {"X": [np.log(probs(5, 4))], "Label": [lbl[:, 0]],
                      "Weight": [np.abs(x(4))]}, {}, None, ["X"]),
        ("mse_loss", {"X": [x(4, 3)], "Y": [x(4, 3)]}, {}, None, ["X", "Y"]),
        ("bpr_loss", {"X": [x(5, 4)], "Label": [lbl]}, {}, None, ["X"]),
        # nn_ops: the norms
        ("instance_norm", {"X": [x4], "Scale": [s6], "Bias": [b6]}, {},
         None, ["X", "Scale", "Bias"]),
        ("group_norm", {"X": [x4], "Scale": [s6], "Bias": [b6]},
         {"groups": 3}, None, ["X", "Scale", "Bias"]),
        ("norm", {"X": [x(3, 5, 4)]}, {"axis": 1}, None, ["X"]),
        ("data_norm", {"X": [x(4, 3)], "BatchSize": [np.full(3, 8.0,
                                                              "float32")],
                       "BatchSum": [x(3)],
                       "BatchSquareSum": [np.abs(x(3)) + 4.0]}, {}, None,
         ["X"]),
        ("lrn", {"X": [x4]}, {"n": 5, "k": 1.0, "alpha": 1e-2}, None,
         ["X"]),
        ("sync_batch_norm", {"X": [x4], "Scale": [s6], "Bias": [b6],
                             "Mean": [np.zeros(6, "float32")],
                             "Variance": [np.ones(6, "float32")]}, {}, None,
         ["X", "Scale", "Bias"]),
        # nn_ops: convolution and pooling
        ("conv3d", {"Input": [x(2, 3, 5, 6, 4)], "Filter": [x(4, 3, 3, 2, 3)]},
         {"strides": [1, 2, 1], "paddings": [1, 0, 1]}, None,
         ["Input", "Filter"]),
        ("conv2d_transpose", {"Input": [x(2, 4, 5, 6)],
                              "Filter": [x(4, 3, 3, 3)]},
         {"strides": [2, 2], "paddings": [1, 1], "output_size": [10, 12]},
         None, ["Input", "Filter"]),
        ("pool3d", {"X": [x5]}, {"pooling_type": "avg", "ksize": [3, 2, 2],
                                 "strides": [1, 2, 1],
                                 "paddings": [1, 1, 0]}, None, ["X"]),
        ("max_pool2d_with_index", {"X": [x(2, 3, 7, 6)]},
         {"ksize": [3, 2], "strides": [2, 2], "paddings": [1, 0]}, None,
         ["X"]),
        ("max_pool3d_with_index", {"X": [x5]},
         {"ksize": [2, 2, 2], "strides": [2, 2, 1], "paddings": [0, 1, 1]},
         None, ["X"]),
        # nn_ops: resize and rearrangement
        ("nearest_interp", {"X": [x(2, 3, 5, 7)]},
         {"out_h": 9, "out_w": 12, "align_corners": False}, None, ["X"]),
        ("bilinear_interp", {"X": [x(2, 3, 5, 7)]},
         {"out_h": 9, "out_w": 12, "align_corners": True}, None, ["X"]),
        ("pixel_shuffle", {"X": [x(2, 8, 3, 4)]}, {"upscale_factor": 2},
         None, ["X"]),
        ("space_to_depth", {"X": [x(2, 3, 4, 6)]}, {"blocksize": 2}, None,
         ["X"]),
        ("shuffle_channel", {"X": [x4]}, {"group": 3}, None, ["X"]),
        # math_ops
        ("matmul_v2", {"X": [x(2, 3, 4)], "Y": [x(2, 5, 4)]},
         {"trans_y": True}, None, ["X", "Y"]),
        ("bmm", {"X": [x(2, 3, 4)], "Y": [x(2, 4, 5)]}, {}, None, ["X", "Y"]),
        ("dot", {"X": [x(3, 4)], "Y": [x(3, 4)]}, {}, None, ["X", "Y"]),
        ("mv", {"X": [x(3, 4)], "Vec": [x(4)]}, {}, None, ["X", "Vec"]),
        ("addmm", {"Input": [x(3, 5)], "X": [x(3, 4)], "Y": [x(4, 5)]},
         {"Alpha": 0.5, "Beta": 2.0}, None, ["Input", "X", "Y"]),
        ("kron", {"X": [x(2, 3)], "Y": [x(3, 2)]}, {}, None, ["X", "Y"]),
        ("trace", {"Input": [x(3, 4, 5)]}, {"offset": 1, "axis1": 1,
                                           "axis2": 2}, None, ["Input"]),
        ("logsumexp", {"X": [x(3, 4, 5)]}, {"axis": [1, 2]}, None, ["X"]),
        ("frobenius_norm", {"X": [x(3, 4, 5)]}, {"dim": [1, 2]}, None,
         ["X"]),
        ("p_norm", {"X": [np.abs(x(3, 4)) + 0.1]}, {"porder": 3.0,
                                                    "axis": 1}, None, ["X"]),
        ("dist", {"X": [x(3, 4)], "Y": [x(3, 4)]}, {"p": 2.0}, None,
         ["X", "Y"]),
        ("prelu", {"X": [x4], "Alpha": [x(6)]}, {"mode": "channel"}, None,
         ["X", "Alpha"]),
        ("maximum", {"X": [x(3, 4)], "Y": [x(3, 4)]}, {}, None, ["X", "Y"]),
        ("minus", {"X": [x(3, 4)], "Y": [x(3, 4)]}, {}, None, ["X", "Y"]),
        ("allclose", {"Input": [x(3, 4)], "Other": [x(3, 4)]},
         {"atol": 3.0}, None, []),
        ("inverse", {"Input": [spd(4)]}, {}, None, ["Input"]),
        ("cholesky", {"X": [spd(4)]}, {"upper": True}, None, ["X"]),
        # nn_extra_ops
        ("maxout", {"X": [x4]}, {"groups": 3}, None, ["X"]),
        ("affine_channel", {"X": [x4], "Scale": [s6], "Bias": [b6]}, {},
         None, ["X", "Scale", "Bias"]),
        ("bilinear_tensor_product", {"X": [x(3, 4)], "Y": [x(3, 5)],
                                     "Weight": [x(2, 4, 5)],
                                     "Bias": [x(1, 2)]}, {}, None,
         ["X", "Y", "Weight", "Bias"]),
        ("cvm", {"X": [np.abs(x(4, 5)) * 3], "CVM": [x(4, 2)]}, {}, None,
         ["X"]),
        ("fsp", {"X": [x(2, 3, 4, 5)], "Y": [x(2, 4, 4, 5)]}, {}, None,
         ["X", "Y"]),
        ("temporal_shift", {"X": [x(6, 8, 3, 2)]}, {"seg_num": 3}, None,
         ["X"]),
        ("unfold", {"X": [x(2, 3, 6, 5)]},
         {"kernel_sizes": [3, 2], "strides": [2, 1],
          "paddings": [1, 0, 1, 1], "dilations": [1, 2]}, None, ["X"]),
        ("mean_iou", {"Predictions": [r.randint(0, 5, (2, 8, 8))
                                      .astype("int32")],
                      "Labels": [miou_lbl]}, {"num_classes": 5}, None, []),
        ("row_conv", {"X": [x(2, 6, 4)], "Filter": [x(3, 4)]}, {}, None,
         ["X", "Filter"]),
        ("sigmoid_focal_loss", {"X": [x(5, 4)],
                                "Label": [np.array([[0], [1], [4], [2], [3]],
                                                   "int32")],
                                "FgNum": [np.array([3], "int32")]}, {}, None,
         ["X"]),
        ("iou_similarity", {"X": [np.sort(np.abs(x(3, 4)), -1)],
                            "Y": [np.sort(np.abs(x(5, 4)), -1)]}, {}, None,
         []),
        ("pad_constant_batch_size_like", {"X": [x(4, 3)], "Y": [x(2, 3)]},
         {}, None, ["Y"]),
        ("squared_l2_distance", {"X": [x(4, 3, 2)], "Y": [x(4, 3, 2)]}, {},
         None, ["X", "Y"]),
        # loss_extra_ops
        ("warpctc", {"Logits": [x(21, 6) * 2],
                     "Label": [r.randint(1, 6, (9, 1)).astype("int32")]},
         {"norm_by_times": True}, ctc_lod, ["Logits"]),
        ("ctc_align", {"Input": [np.array([0, 1, 1, 0, 2, 2, 2, 0, 3, 0, 0,
                                           0, 4, 4], "int32")[:, None]]},
         {"blank": 0}, {"Input": [((0, 9, 12, 14),)]}, []),
        ("edit_distance", {"Hyps": [np.array([1, 2, 3, 4, 5, 5, 1, 2],
                                             "int64")[:, None]],
                           "Refs": [np.array([1, 3, 3, 5, 5, 2, 1],
                                             "int64")[:, None]]},
         {"normalized": False}, {"Hyps": [((0, 4, 6, 8),)],
                                 "Refs": [((0, 3, 5, 7),)]}, []),
        ("center_loss", {"X": [x(6, 4)], "Label": [np.array(
            [[0], [2], [2], [1], [0], [2]], "int64")], "Centers": [x(3, 4)],
            "CenterUpdateRate": [np.array([0.3], "float32")]}, {}, None,
         ["X"]),
        ("grid_sampler", {"X": [x(2, 3, 5, 6)],
                          "Grid": [r.uniform(-1.2, 1.2, (2, 4, 3, 2))
                                   .astype("float32")]}, {}, None,
         ["X", "Grid"]),
        ("spectral_norm", {"Weight": [x(4, 3, 2)], "U": [x(4)], "V": [x(6)]},
         {"power_iters": 2}, None, ["Weight"]),
        ("teacher_student_sigmoid_loss",
         {"X": [x(6, 1) * 10], "Label": [np.array(
             [[1], [0], [-1.3], [-2.0], [1], [-1.0]], "float32")]}, {},
         None, ["X"]),
        # the random ops draw alike on the card and the CPU from one key
        ("random_crop", {"X": [x(2, 3, 7, 6)]}, {"shape": [4, 3]}, None, []),
        ("sampled_softmax_with_cross_entropy",
         {"Logits": [x(6, 9)], "Label": [np.arange(6)[:, None] % 9]},
         {"num_samples": 5}, None, ["Logits"]),
        ("py_func", {"X": [x(3, 4), x(4)]},
         {"forward_callable_id": _vs_py_func_id()}, None, []),
    ]
    return cases


_VS_PY_FUNC = []


def _vs_py_func_id():
    """The id of the battery's py_func callable (x·2 + y, and x's row
    sums) in the port's py_func registry, registered once."""
    from paddle_tpu_torch.fluid.layers.py_func_registry import \
        register_callable
    if not _VS_PY_FUNC:
        _VS_PY_FUNC.append(register_callable(
            lambda a, b: [a * 2 + b, a.sum(1)]))
    return _VS_PY_FUNC[0]


def vision_layers_program(fluid, random=True):
    """(d) Every layer of the batch over a batch of 2, in one program:
    the inputs are parameters, so each layer's grad reaches them; the
    loss is the sum of every float output's mean, under SGD. ``random``
    adds the layers that draw (random_crop,
    sampled_softmax_with_cross_entropy), which the TPU package draws
    otherwise. No layer reads a tensor on the host. → (main, startup,
    loss, the outputs)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()

    def param(name, shape, std=1.0, positive=False):
        init = (fluid.initializer.Uniform(0.5, 1.5) if positive
                else fluid.initializer.Normal(0.0, std))
        return L.create_parameter(shape, "float32", name=name,
                                  default_initializer=init)

    with fluid.program_guard(main, startup):
        x = param("vs_x", [2, 4, 8, 8])
        x5 = L.reshape(x, [2, 4, 2, 4, 8])
        x2 = L.reshape(x, [2, 256])
        x3 = L.reshape(x, [2, 32, 8])
        p8, q2 = param("vs_p8", [2, 8]), param("vs_q2", [2, 2])
        a1, b1 = param("vs_a1", [2, 1]), param("vs_b1", [2, 1])
        lbl = L.data("vs_label", [2, 1], False, "int64")
        seg = L.data("vs_seg", [2, 8, 8], False, "int32")
        outs = [
            L.conv2d_transpose(x, 3, output_size=[16, 16], filter_size=3,
                               stride=2, padding=1),
            L.conv3d(x5, 2, 3, padding=1),
            L.pool3d(x5, 2, "avg", 2),
            L.adaptive_pool3d(x5, [2, 2, 4], "max"),
            L.adaptive_pool3d(x5, [2, 2, 2], require_index=True)[0],
            L.adaptive_pool2d(x, [2, 4], "avg"),
            L.instance_norm(x), L.group_norm(x, 2), L.data_norm(x2),
            L.lrn(x, n=3), L.l2_normalize(x2, 1),
            L.image_resize(x, [5, 6]),
            L.resize_bilinear(x, [16, 12], align_corners=False,
                              align_mode=0),
            L.resize_nearest(x, scale=2.0), L.image_resize_short(x, 4),
            L.interpolate(x, [3, 3], resample="NEAREST"),
            L.pixel_shuffle(x, 2), L.space_to_depth(x, 2),
            L.shuffle_channel(x, 2), L.prelu(x, "channel"),
            L.prelu(x, "element"), L.maxout(x, 2),
            L.affine_channel(x, scale=param("vs_s", [4], positive=True),
                             bias=param("vs_b", [4])),
            L.bilinear_tensor_product(x2, x2, 3),
            L.continuous_value_model(L.abs(x2), param("vs_cvm", [2, 2])),
            L.fsp_matrix(x, x), L.row_conv(x3, 2),
            L.temporal_shift(x, 2), L.unfold(x, [2, 3], 2),
            L.grid_sampler(x, L.tanh(param("vs_grid", [2, 5, 6, 2]))),
            L.spectral_norm(param("vs_w", [4, 3, 2]), power_iters=2),
            L.smooth_l1(x2, L.scale(x2, 0.5)),
            L.dice_loss(L.softmax(p8), lbl),
            L.sigmoid_cross_entropy_with_logits(
                x2, L.cast(L.greater_than(x2, L.scale(x2, 0.0)),
                           "float32")),
            L.rank_loss(L.cast(lbl, "float32"), a1, b1),
            L.margin_rank_loss(L.scale(L.cast(lbl, "float32"), 1.0, -1.0),
                               a1, b1),
            L.huber_loss(x2, L.scale(x2, 0.3), 0.5),
            L.kldiv_loss(x2, L.softmax(L.scale(x2, 2.0))),
            L.mse_loss(x2, L.scale(x2, 0.5)),
            L.bpr_loss(p8, lbl),
            L.center_loss(x2, lbl, 3, 0.1),
            L.teacher_student_sigmoid_loss(a1, b1),
            L.npair_loss(p8, L.scale(p8, 0.5), L.softmax(q2)),
        ]
        pred = L.argmax(x, axis=1)
        miou = L.mean_iou(L.cast(pred, "int32"), seg, 4)
        if random:
            outs += [L.random_crop(x, [5, 6]),
                     L.sampled_softmax_with_cross_entropy(x2, lbl, 4)]
        loss = L.sums([L.reduce_mean(o) for o in outs])
        fluid.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss, outs + list(miou)



AFFINE_CONVS = 3              # (d) the frozen-BN program's conv layers


def affine_channel_program(fluid, width=1.0, image=224):
    """(d) A Detectron-style frozen-BN stem served for inference: three
    conv2d (no bias) each followed by affine_channel (the frozen batch
    norm's scale and shift as parameters) and ReLU, a max pool between,
    then global average pooling and an fc. conv_affine_channel_fuse_pass
    folds each affine_channel into its conv. → (main, startup, the
    prediction)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        y = fluid.data("image", [3, image, image], "float32")
        for i, (nf, k, s) in enumerate(((64, 7, 2), (64, 3, 1),
                                        (256, 3, 1))):
            y = L.conv2d(y, _w(width, nf), k, stride=s, padding=k // 2,
                         bias_attr=False)
            c = _w(width, nf)
            y = L.affine_channel(
                y, scale=L.create_parameter(
                    [c], "float32", name=f"ac{i}_scale",
                    default_initializer=fluid.initializer.Uniform(0.5,
                                                                  1.5)),
                bias=L.create_parameter([c], "float32", name=f"ac{i}_bias"),
                act="relu")
            if i == 0:
                y = L.pool2d(y, 3, "max", 2, 1)
        pred = L.fc(L.pool2d(y, global_pooling=True, pool_type="avg"), 10)
    return main, startup, pred



GAN_CHECK_IMAGE = 64          # (a) card vs CPU at 64x64
VS_WIDTH = 1.0                # the three programs' width scale (published)
CRNN_CHECK_BATCH = 8          # (c) card vs CPU at batch 8
VS_EVAL_RUNS = 6              # eval or decode runs timed, after 3


def _vs_seeded(programs):
    for p in programs:
        p.random_seed = SEED
    return programs


def _vs_timed(book, exe, scope, main, feed, fetch, mode, what, tag=VS_TAG,
              runs=None, clock=()):
    """3 + ``runs`` (VS_EVAL_RUNS by default) runs of ``main`` (eager,
    capture, replays), each gated, the timed ones under
    ``_det_host_clock(clock)``; → (the last fetches, the p50 of the
    timed runs in ms, the clocked host ops' share of their wall time)."""
    import numpy as np
    times, kinds, host = [], [], 0.0
    for i in range(3 + (VS_EVAL_RUNS if runs is None else runs)):
        with _det_host_clock(clock if i >= 3 else ()) as spent:
            before = _launch_counts()
            t = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            times.append(time.perf_counter() - t)
        host += spent["seconds"]
        kinds.append(_gate_mode(exe, before, NO_KERNELS, f"{tag} {what}",
                                book, mode))
    if kinds[-1] != "replay":
        raise AssertionError(f"{tag} {what}: runs {kinds}")
    return (out, float(np.median(times[3:])) * 1e3,
            host / sum(times[3:]))


def _vs_gan(book):
    """(a) CycleGAN at 256x256 (the docstring's phase 22 (a)), trained."""
    import numpy as np
    from paddle_tpu_torch import fluid
    with fluid.unique_name.guard():
        built = cyclegan_programs(fluid, GAN_BLOCKS, VS_WIDTH, 1, GAN_IMAGE)
    _vs_seeded([p for k in built for p in built[k][:2]])
    g, da, db = built["g"], built["da"], built["db"]
    ops = g[0].global_block().ops
    n_in = sum(op.type == "instance_norm" for op in ops)
    n_tr = sum(op.type == "conv2d_transpose" for op in ops)
    rng = np.random.RandomState(SEED + 30)
    imgs = {k: rng.uniform(-1, 1, (1, 3, GAN_IMAGE, GAN_IMAGE)).astype(
        "float32") for k in ("real_A", "real_B")}
    runs = [(g[0], [g[2], g[3], g[4]], lambda outs: imgs),
            (da[0], [da[2]], lambda outs: {"real_A": imgs["real_A"],
                                            "fake_A": outs[0][1]}),
            (db[0], [db[2]], lambda outs: {"real_B": imgs["real_B"],
                                            "fake_B": outs[0][2]})]
    res = _md_train(book, f"(a) CycleGAN {GAN_IMAGE}x{GAN_IMAGE} batch 1, "
                    f"{GAN_BLOCKS} residual blocks", runs,
                    [g[1], da[1], db[1]], NO_KERNELS, tag=VS_TAG)
    _log(f"{VS_TAG} (a) the generators' program: {n_in} instance_norm and "
         f"{n_tr} conv2d_transpose ops (and their grads) ran in its "
         f"compiled step, {len(ops)} ops")
    return res


def _vs_gan_check(book):
    """(a) CycleGAN's generators and discriminator A, card against CPU at
    GAN_CHECK_IMAGE."""
    import numpy as np
    from paddle_tpu_torch import fluid
    with fluid.unique_name.guard():
        small = cyclegan_programs(fluid, GAN_BLOCKS, VS_WIDTH, 1,
                                  GAN_CHECK_IMAGE)
    _vs_seeded([p for k in small for p in small[k][:2]])
    crng = np.random.RandomState(SEED + 31)
    cimgs = {k: crng.uniform(-1, 1, (1, 3, GAN_CHECK_IMAGE,
                                     GAN_CHECK_IMAGE)).astype("float32")
             for k in ("real_A", "real_B", "fake_A")}
    _md_card_vs_cpu(book, f"(a) CycleGAN generators {GAN_CHECK_IMAGE}x"
                    f"{GAN_CHECK_IMAGE}", small["g"][0], small["g"][1],
                    [small["g"][2]], {k: cimgs[k] for k in ("real_A",
                                                             "real_B")},
                    conv=True, adaptive=True, tag=VS_TAG)
    _md_card_vs_cpu(book, f"(a) CycleGAN discriminator A "
                    f"{GAN_CHECK_IMAGE}x{GAN_CHECK_IMAGE}", small["da"][0],
                    small["da"][1], [small["da"][2]],
                    {k: cimgs[k] for k in ("real_A", "fake_A")}, conv=True,
                    adaptive=True, tag=VS_TAG)


def _dl_feed(rng, bs, crop):
    """Images of noise and labels in blocks of 16x16 pixels (regions, as
    a segmentation's labels come), a tenth of the blocks ignored
    (DL_IGNORE)."""
    import numpy as np
    n = -(-crop // 16)
    label = rng.randint(0, DL_CLASSES, (bs, 1, n, n)).astype("int64")
    label[rng.rand(*label.shape) < 0.1] = DL_IGNORE
    label = label.repeat(16, 2).repeat(16, 3)[:, :, :crop, :crop]
    return {"image": rng.normal(size=(bs, 3, crop, crop)).astype("float32"),
            "label": np.ascontiguousarray(label)}


def _vs_deeplab(book):
    """(b) DeepLabv3+ on Cityscapes shapes (the docstring's phase 22
    (b)), trained, then its eval clone. → its readings and the shape its
    dropout op takes."""
    import numpy as np
    from paddle_tpu_torch import fluid
    built = _md_fixed(lambda: deeplab_program(fluid, DL_MIDDLE, VS_WIDTH,
                                              DL_CROP, DL_CLASSES, DL_LR))
    main, startup, test, loss, miou, wrong, correct = built
    test.random_seed = SEED
    block = main.global_block()
    want = _step_want(block.ops, "split", forwards=0)
    if want != (0, 0, 0, 0, 1) + (0,) * 7:
        raise AssertionError(f"{VS_TAG} (b) DeepLabv3+: a step would launch "
                             f"{want}")
    drop = next(op for op in block.ops if op.type == "dropout")
    rng = np.random.RandomState(SEED + 32)
    feed = _dl_feed(rng, DL_BATCH, DL_CROP)
    res = _md_train(book, f"(b) DeepLabv3+ {DL_CROP}x{DL_CROP} batch "
                    f"{DL_BATCH}, Xception-65", _md_run(main, [loss], feed),
                    [startup], want, tag=VS_TAG, keep_scope=True)
    exe = res.pop("exe")
    out, res["eval_p50_ms"], _ = _vs_timed(
        book, exe, res.pop("scope"), test, feed, [miou, wrong, correct],
        "compiled", "(b) the eval clone")
    exe.close()
    _log(f"{VS_TAG} (b) the eval clone at batch {DL_BATCH}: mean IoU "
         f"{float(out[0].numpy()[0]):.4f}, p50 {res['eval_p50_ms']:.3f} ms "
         f"on {_card_line()}")
    res["dropout_shape"] = (DL_BATCH,) + tuple(
        block.var(drop.input("X")[0]).shape[1:])
    return res


def _vs_deeplab_check(book, dropout_shape):
    """(b) DeepLabv3+'s checks: the dropout kernel against its plain
    version at the shape the step gives it, then card against CPU at
    DL_CHECK_CROP with DL_CHECK_MIDDLE middle-flow blocks, 2 steps from
    one start, and the eval clone's mean_iou."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops.cuda import dropout as dk
    gen = torch.Generator(device=VS_CARD).manual_seed(SEED + 38)
    x = torch.randn(dropout_shape, generator=gen, device=VS_CARD)
    key = torch.tensor([SEED + 38], dtype=torch.int64, device=VS_CARD)
    before = _launch_counts()
    _dropout_agrees(dk, x, key, DL_DROPOUT, True,
                    f"(b) DeepLabv3+'s dropout rate {DL_DROPOUT:g}", VS_TAG)
    book.add(_delta(before))
    small = _md_fixed(lambda: deeplab_program(
        fluid, DL_CHECK_MIDDLE, VS_WIDTH, DL_CHECK_CROP, DL_CLASSES, DL_LR))
    small[2].random_seed = SEED
    cfeed = _dl_feed(np.random.RandomState(SEED + 33), MD_CHECK_BATCH,
                     DL_CHECK_CROP)
    _md_card_vs_cpu(book, f"(b) DeepLabv3+ {DL_CHECK_CROP}x{DL_CHECK_CROP} "
                    f"batch {MD_CHECK_BATCH}, {DL_CHECK_MIDDLE} middle-flow "
                    "block (dropout: the kernel's mask is its plain "
                    "version's)", small[0], small[1], [small[3]], cfeed,
                    conv=True, tag=VS_TAG, resync=True)
    _vs_eval_exact(book, small, cfeed)


def _vs_eval_exact(book, built, feed):
    """The eval clone of ``built`` on the card and by the CPU port from
    the same start on one batch: mean IoU, wrong and correct equal."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, test = built[:3]
    fetch = list(built[4:7])
    names = [v.name for v in main.list_vars() if v.persistable]
    before = _launch_counts()
    exe, scope = _fresh(main, startup)
    card = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=feed, fetch_list=fetch,
        scope=_clone_scope(scope, names, "cpu"))
    book.add(_delta(before))
    exe.close()
    same = all(np.array_equal(a, b) for a, b in zip(card, cpu))
    _log(f"{VS_TAG} (b) the eval clone's mean_iou on the card and the CPU "
         f"from one start: mean IoU {card[0][0]:.6f} vs {cpu[0][0]:.6f}, "
         f"wrong {card[1].tolist()}, correct {card[2].tolist()} -> "
         + ("equal" if same else "DIFFER"))
    if not same:
        raise AssertionError(f"{VS_TAG} (b) mean_iou: the card and the CPU "
                             "differ")


def _crnn_feed(rng, bs):
    import numpy as np
    shape, classes, lens = CRNN_SHAPE, CRNN_CLASSES, CRNN_LABEL
    n = rng.randint(lens[0], lens[1] + 1, bs)
    offs = [0] + [int(x) for x in np.cumsum(n)]
    return {"pixel": rng.normal(size=(bs,) + tuple(shape)).astype(
        "float32"), "label": _lod_tensor(rng.randint(
            0, classes, (offs[-1], 1)).astype("int32"), offs)}


def _vs_crnn(book):
    """(c) CRNN-CTC (the docstring's phase 22 (c)), trained, then its
    decode."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss, decoded, dist = _md_fixed(
        lambda: crnn_program(fluid, VS_WIDTH, CRNN_HID, CRNN_CLASSES,
                             CRNN_SHAPE))
    rng = np.random.RandomState(SEED + 34)
    feed = _crnn_feed(rng, CRNN_BATCH)
    res = _md_train(book, f"(c) CRNN-CTC {CRNN_SHAPE} batch {CRNN_BATCH}",
                    _md_run(main, [loss, dist], feed), [startup],
                    NO_KERNELS, mode="segmented", tag=VS_TAG,
                    keep_scope=True)
    exe, scope = res.pop("exe"), res.pop("scope")
    sb = exe._last_block
    kinds = [s.kind for s in sb.segments]
    res["segments"] = kinds.count("compiled")
    res["islands"] = kinds.count("island")
    reasons = sorted({r for s in sb.segments if s.kind == "island"
                      for r in (s.island_reasons or ())})
    _log(f"{VS_TAG} (c) a CRNN-CTC step runs {res['segments']} compiled "
         f"segments and {res['islands']} islands ({', '.join(reasons)}): "
         f"{' '.join(kinds)}")
    test = main.clone(for_test=True)
    out, res["decode_p50_ms"], _ = _vs_timed(
        book, exe, scope, test, feed, [decoded, dist], "segmented",
        "(c) the decode")
    _log(f"{VS_TAG} (c) greedy decode and edit distance at batch "
         f"{CRNN_BATCH}: {out[0].numpy().shape[0]} ids, mean distance "
         f"{float(out[1].numpy().mean()):.3f}, p50 "
         f"{res['decode_p50_ms']:.3f} ms on {_card_line()}")
    exe.close()
    return res


def _vs_crnn_check(book):
    """(c) CRNN-CTC card against CPU at CRNN_CHECK_BATCH: the losses, the
    grads, the decoded ids and the distances."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss, decoded, dist = _md_fixed(
        lambda: crnn_program(fluid, VS_WIDTH, CRNN_HID, CRNN_CLASSES,
                             CRNN_SHAPE))
    cfeed = _crnn_feed(np.random.RandomState(SEED + 35), CRNN_CHECK_BATCH)
    _md_card_vs_cpu(book, f"(c) CRNN-CTC batch {CRNN_CHECK_BATCH}, the "
                    "decoded ids and distances", main, startup,
                    [loss, decoded, dist], cfeed, exact=(1, 2), conv=True,
                    tag=VS_TAG)


def _vs_battery_run(book, cases=None, tag=VS_TAG, exact=()):
    """(d) Every op type of the batch on the card against the CPU port
    (``cases``, by default ``_vs_battery``'s): each output (integers
    exactly, floats at VS_TOL, or exactly for the op types in ``exact``)
    and, where it has one, the generic grad under a seeded output grad.
    None launches a counted kernel. ``tag`` heads the lines. → how many
    cases."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import rng as oprng
    from paddle_tpu_torch.ops.registry import OPS, run_generic_grad
    before = _launch_counts()
    worst = (0.0, "")
    cases = _vs_battery() if cases is None else cases
    for op_type, ins, attrs, lod, diff in cases:
        info = OPS.get(op_type)
        got = {}
        for dev in (VS_CARD, "cpu"):
            a = dict(info.attr_defaults, **attrs)
            if lod is not None:
                a["_lod"] = lod
            a["_device"] = torch.device(dev)
            a["_rng"] = lambda d=dev: oprng.fixed_key(SEED, d)
            t_ins = {s: [torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                         for v in vals] for s, vals in ins.items()}
            o = info.kernel(t_ins, a)
            res = {k: [v.detach().cpu().numpy() for v in vals]
                   for k, vals in o.items() if not k.startswith("_")}
            if diff:
                g = np.random.RandomState(SEED)
                for k, vals in res.items():
                    if vals[0].dtype.kind == "f":
                        t_ins[k + "@GRAD"] = [torch.from_numpy(
                            g.normal(size=v.shape).astype(v.dtype)).to(dev)
                            for v in vals]
                grads = run_generic_grad(op_type, t_ins, a,
                                         [s + "@GRAD" for s in diff],
                                         list(ins))
                res.update({k: [v.detach().cpu().numpy() for v in vals]
                            for k, vals in grads.items()})
            got[dev] = res
        for k, vals in got["cpu"].items():
            for i, (c, gpu) in enumerate(zip(vals, got[VS_CARD][k])):
                what = f"{op_type} {k}[{i}]"
                if c.dtype.kind != "f" or op_type in exact:
                    ok = c.shape == gpu.shape and np.array_equal(
                        c, gpu, equal_nan=c.dtype.kind == "f")
                    err = 0.0 if ok else np.inf
                else:
                    ok = np.allclose(gpu, c, rtol=VS_TOL[0], atol=VS_TOL[1],
                                     equal_nan=True)
                    err = float(np.nanmax(np.abs(gpu - c))) if c.size else 0.
                worst = max(worst, (err, what))
                if not ok:
                    raise AssertionError(f"{tag} (d) {what}: the card and "
                                         f"the CPU differ by {err:.3e}")
    if _delta(before) != NO_KERNELS:
        raise AssertionError(f"{tag} (d) the battery launched "
                             f"{_delta(before)}")
    _log(f"{tag} (d) {len(cases)} op types on the card against the CPU "
         f"port, forward and generic grads (rtol {VS_TOL[0]:g}, atol "
         f"{VS_TOL[1]:g}; integers"
         + (f" and the {len(exact)} host ops' outputs" if exact else "")
         + f" exactly): the largest difference {worst[0]:.3e} ({worst[1]})"
         " -> ok")
    return len(cases)


def _vs_programs(book):
    """(d) The capturable layers in one program (``vision_layers_program``)
    trained 3 steps on the card in lock step with the interpreter, and
    the frozen-BN program served through the predictor after
    conv_affine_channel_fuse_pass against its unfused Executor.run."""
    import tempfile
    import numpy as np
    from paddle_tpu_torch import fluid, inference
    main, startup, loss, outs = _md_fixed(
        lambda: vision_layers_program(fluid))
    rng = np.random.RandomState(SEED + 36)
    seg = rng.randint(0, 4, (2, 8, 8)).astype("int32")
    seg[rng.rand(2, 8, 8) < 0.2] = 255
    feed = {"vs_label": np.array([[1], [2]], "int64"), "vs_seg": seg}
    exe, scope = _fresh(main, startup)
    iexe = fluid.Executor(fluid.CUDAPlace(0))
    iscope = _clone_scope(scope, [v.name for v in main.list_vars()
                                  if v.persistable], "cuda")
    kinds = [_lock_step((exe, scope), (iexe, iscope), main, feed,
                        [loss] + list(outs), NO_KERNELS, book,
                        f"(d) the layers' program step {i}", VS_TAG)[2]
             for i in range(MD_LOCK)]
    if tuple(kinds) != MD_LOCK_EXECS:
        raise AssertionError(f"{VS_TAG} (d) the layers' program ran {kinds}")
    types = sorted({op.type for op in main.global_block().ops})
    _log(f"{VS_TAG} (d) the layers' program ({len(outs)} outputs, "
         f"{len(types)} op types): {' '.join(kinds)}, each bitwise the "
         "interpreter's -> ok")
    exe.close()
    iexe.close()
    amain, astart, pred = _md_fixed(lambda: affine_channel_program(fluid))
    img = np.random.RandomState(SEED + 37).normal(
        size=(8, 3, 224, 224)).astype("float32")
    exe, scope = _fresh(amain, astart)
    plain = exe.run(amain, feed={"image": img}, fetch_list=[pred],
                    scope=scope)[0]
    with tempfile.TemporaryDirectory() as d:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["image"], [pred], exe, amain)
        p = inference.create_predictor(inference.Config(d))
        census = _census(p._program)
        if "affine_channel" in census or \
                census.get("conv2d_fusion") != AFFINE_CONVS:
            raise AssertionError(f"{VS_TAG} (d) the served frozen-BN "
                                 f"program: census {census}")
        kinds, times = [], []
        for _ in range(3 + VS_EVAL_RUNS):
            before = _launch_counts()
            t = time.perf_counter()
            served = p.run([img])[0]
            times.append(time.perf_counter() - t)
            kinds.append(_gate_mode(p._exe, before, NO_KERNELS,
                                    f"{VS_TAG} (d) a served request", book))
        p._exe.close()
    exe.close()
    err = float(np.abs(served - plain).max())
    ok = np.allclose(served, plain, rtol=RESNET_PRED_TOL[0],
                     atol=RESNET_PRED_TOL[1])
    _log(f"{VS_TAG} (d) the frozen-BN program served after "
         f"conv_affine_channel_fuse_pass (census {census}), batch 8 at "
         f"224x224: requests {' '.join(kinds[:4])} ..., p50 "
         f"{float(np.median(times[3:])) * 1e3:.3f} ms on {_card_line()}; "
         f"against the unfused program's Executor.run max|d| {err:.3e} "
         f"(rtol {RESNET_PRED_TOL[0]:g}, atol {RESNET_PRED_TOL[1]:g}: the "
         "folded weights round otherwise) -> "
         + ("ok" if ok else "FAIL"))
    if not ok or kinds[-1] != "replay":
        raise AssertionError(f"{VS_TAG} (d) the served frozen-BN program")


VS_TOL = (1e-4, 1e-5)         # (d) an op on the card against the CPU port
VS_CARD = "cuda"              # (d) the battery's card


def phase_vision():
    """Phase 22: the vision and loss op batch (the docstring's phase 22).
    The main path, counted from zero: the three programs trained at their
    widths, DeepLabv3+'s eval and CRNN's decode. Then, counted apart, the
    checks: card against CPU, the dropout kernel at DeepLabv3+'s shape,
    the op battery and the two programs of (d). → the main path's
    launches: through the wrappers and on the card."""
    book, checks = _CfBook(), _CfBook()
    t0 = time.perf_counter()
    _reset_launch_counts()
    res = {"cyclegan": _vs_gan(book), "deeplab": _vs_deeplab(book),
           "crnn": _vs_crnn(book)}
    wrapper, ran = _launch_counts(), tuple(book.executed)
    _reset_launch_counts()
    _vs_gan_check(checks)
    _vs_deeplab_check(checks, res["deeplab"]["dropout_shape"])
    _vs_crnn_check(checks)
    res["battery"] = _vs_battery_run(checks)
    _vs_programs(checks)
    checked = _launch_counts()
    # the dropout kernel is DeepLabv3+'s alone: its steps, its interpreted
    # ones, and in the checks its card-vs-CPU steps and the kernel's own
    for counts in (wrapper, ran, checked, checks.executed):
        if any(counts[:4]) or any(counts[5:]) or not ran[4]:
            raise AssertionError(f"{VS_TAG} phase 22 launched {wrapper}, on "
                                 f"the card {ran}; its checks {checked}, "
                                 f"on the card {tuple(checks.executed)}")
    _log(f"{VS_TAG} phase 22 in {time.perf_counter() - t0:.1f} s: step p50 "
         + ", ".join(f"{k} {res[k]['p50_ms']:.3f} ms"
                     for k in ("cyclegan", "deeplab", "crnn"))
         + f"; DeepLabv3+ eval {res['deeplab']['eval_p50_ms']:.3f} ms, "
         f"CRNN decode {res['crnn']['decode_p50_ms']:.3f} ms; the main "
         f"path's launches through the wrappers {GATE_NAMES} {wrapper}, on "
         f"the card {ran}; the checks' apart: {checked}, on the card "
         f"{tuple(checks.executed)}")
    return {"wrapper": wrapper, "executed": ran,
            "check_executed": tuple(checks.executed), **res}



# --------------------------------------------------------------------------
# phase 23: the detection batch
# --------------------------------------------------------------------------
DET_TAG = "[det]"
YOLO_IMAGE = 608              # (a) YOLOv3 DarkNet-53 (PaddleDetection
YOLO_BATCH = 8                # configs/yolov3_darknet.yml, release/0.2;
YOLO_CLASSES = 80             # Redmon & Farhadi 2018): 608x608, batch 8,
YOLO_BOXES = 50               # 80 classes, 50 ground-truth boxes at most,
YOLO_STAGES = (1, 2, 8, 8, 4)  # DarkNet-53's residual blocks a stage
YOLO_ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326)
YOLO_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))  # the 32, 16, 8 heads
YOLO_LR = 1e-3                # Momentum 0.9 with L2Decay 5e-4 (the
YOLO_L2 = 5e-4                # warm-up's 4000 steps cut)
SSD_IMAGE = 300               # (b) MobileNet-SSD on VOC (PaddleCV
SSD_BATCH = 32                # ssd/mobilenet_ssd.py, models release 1.7;
SSD_CLASSES = 21              # PaddleDetection ssd_mobilenet_v1_voc.yml):
SSD_BLOCKS = 5                # 300x300, batch 32, 21 classes; the five
SSD_LR = 1e-3                 # 512-wide blocks at 19x19; RMSProp 1e-3
SSD_L2 = 5e-5                 # with L2Decay 5e-5 (ssd/train.py)
SSD_BOXES = (1, 6)            # VOC-like ground truth: 1-6 boxes an image
FRCN_IMAGE = (800, 1344)      # (c) Faster R-CNN R50-FPN (PaddleDetection
FRCN_STAGES = (3, 4, 6, 3)    # faster_rcnn_r50_fpn_1x.yml): one image,
FRCN_CLASSES = 81             # 800x1333 padded to 1344, 81 classes,
FRCN_LR = 0.02 / 16           # Momentum 0.9 with L2Decay 1e-4: the
FRCN_L2 = 1e-4                # config's 0.02 at 16 images scaled to one
                              # (the warm-up cut); COCO-like ground truth,
FRCN_BOXES = (1, 20)          # 1-20 boxes
FRCN_PROPOSALS = (2000, 1000)  # pre- and post-NMS a level, train and test
FRCN_ROIS = 512               # RoIs sampled an image for the box head
FRCN_BRANCH_SCALE = 0.25      # a residual branch's frozen scale at start
FRCN_SEEDS = {"rpn_target_assign": 11, "generate_proposal_labels": 12}


def _yolo_conv(fluid, x, nf, k, s=1):
    """DarkNet's conv: no bias, batch_norm, leaky_relu 0.1."""
    y = fluid.layers.conv2d(
        x, nf, k, stride=s, padding=(k - 1) // 2, bias_attr=False,
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Normal(0.0, 0.01)))
    return fluid.layers.leaky_relu(fluid.layers.batch_norm(y), alpha=0.1)


def yolov3_program(fluid, depth=YOLO_STAGES, width=1.0, image=YOLO_IMAGE,
                   classes=YOLO_CLASSES, boxes=YOLO_BOXES, lr=YOLO_LR):
    """(a) YOLOv3: DarkNet-53 (a 3x3 conv of 32, then five stages of a
    stride-2 3x3 conv and ``depth[i]`` residual blocks of a 1x1 and a 3x3
    conv, 64 to 1024 channels times ``width``); three heads at strides
    32, 16 and 8, each five convs alternating 1x1 (512, 256, 128) and
    3x3, a 3x3 tip and a 1x1 conv with bias to 3 x (5 + classes), the
    route of each upsampled x2 (resize_nearest) into the next; a
    yolov3_loss a head over the nine anchors and its mask, their means
    summed. Momentum 0.9 with L2Decay YOLO_L2. The eval program (a clone
    for test before the loss): yolo_box a head (conf 0.01), the boxes
    joined and multiclass_nms (score 0.01, nms_top_k 1000, keep_top_k
    100, threshold 0.45, no background, pixel boxes). → (main, startup,
    eval program, loss, the NMS output)."""
    L = fluid.layers
    cw = lambda c: _w(width, c)  # noqa: E731
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", [3, image, image], "float32")
        gt_box = fluid.data("gt_box", [boxes, 4], "float32")
        gt_label = fluid.data("gt_label", [boxes], "int32")
        y = _yolo_conv(fluid, img, cw(32), 3)
        feats = []
        for i, n in enumerate(depth):
            c = 64 << i
            y = _yolo_conv(fluid, y, cw(c), 3, 2)
            for _ in range(n):
                r = _yolo_conv(fluid, _yolo_conv(fluid, y, cw(c // 2), 1),
                               cw(c), 3)
                y = L.elementwise_add(y, r)
            feats.append(y)
        heads, route = [], None
        for feat, c in zip(feats[:1:-1], (512, 256, 128)):
            if route is not None:
                r = _yolo_conv(fluid, route, cw(c), 1)
                r = L.resize_nearest(r, out_shape=[feat.shape[2],
                                                   feat.shape[3]])
                feat = L.concat([r, feat], axis=1)
            y = feat
            for _ in range(2):
                y = _yolo_conv(fluid, _yolo_conv(fluid, y, cw(c), 1),
                               cw(2 * c), 3)
            route = _yolo_conv(fluid, y, cw(c), 1)
            tip = _yolo_conv(fluid, route, cw(2 * c), 3)
            heads.append(L.conv2d(
                tip, 3 * (5 + classes), 1,
                param_attr=fluid.ParamAttr(
                    initializer=fluid.initializer.Normal(0.0, 0.01))))
        test = main.clone(for_test=True)
        loss = L.sums([L.reduce_mean(L.yolov3_loss(
            h, gt_box, gt_label, list(YOLO_ANCHORS), list(m), classes, 0.7,
            32 >> i)) for i, (h, m) in enumerate(zip(heads, YOLO_MASKS))])
        fluid.optimizer.Momentum(
            lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(YOLO_L2)).minimize(loss)
    with fluid.program_guard(test, fluid.Program()):
        im_size = fluid.data("im_size", [2], "int32")
        bs, ss = [], []
        for i, (h, m) in enumerate(zip(heads, YOLO_MASKS)):
            b, s = L.yolo_box(test.global_block().var(h.name), im_size,
                              [YOLO_ANCHORS[2 * a + k] for a in m
                               for k in (0, 1)], classes, 0.01, 32 >> i)
            bs.append(b)
            ss.append(L.transpose(s, [0, 2, 1]))
        pred = L.multiclass_nms(L.concat(bs, axis=1), L.concat(ss, axis=2),
                                0.01, 1000, 100, 0.45, normalized=False,
                                background_label=-1)
    return main, startup, test, loss, pred


def _ssd_conv_bn(fluid, x, nf, k, s, groups=1):
    y = fluid.layers.conv2d(x, nf, k, stride=s, padding=(k - 1) // 2,
                            groups=groups, bias_attr=False)
    return fluid.layers.batch_norm(y, act="relu")


def _ssd_separable(fluid, x, c_in, c_out, s, cw):
    """MobileNet's depthwise 3x3 (groups = its channels) and pointwise
    1x1, each with BN and ReLU."""
    y = _ssd_conv_bn(fluid, x, cw(c_in), 3, s, groups=cw(c_in))
    return _ssd_conv_bn(fluid, y, cw(c_out), 1, 1)


def ssd_program(fluid, depth=SSD_BLOCKS, width=1.0, image=SSD_IMAGE,
                classes=SSD_CLASSES, lr=SSD_LR):
    """(b) MobileNet-SSD: MobileNet v1 times ``width`` (``depth`` of its
    five 512-wide separable blocks at 19x19), four extra blocks (a 1x1
    then a stride-2 3x3 conv: 256-512, 128-256, 128-256, 64-128);
    multi_box_head over the 19, 10, 5, 3, 2 and 1 maps (min_sizes 60 ...
    285, max_sizes [[], 150 ... 300], aspect ratios [2] then [2, 3],
    flip: 1917 priors at 300x300); ssd_loss as the TPU package builds it,
    summed. RMSProp with L2Decay SSD_L2. The eval program (a clone for
    test before the loss): detection_output of the softmax scores (NMS
    0.45) and detection_map (11point, difficult ground truth left out)
    against the label rows [label, difficult, box]. → (main, startup,
    eval program, loss, the detections, the mAP)."""
    L = fluid.layers
    cw = lambda c: _w(width, c)  # noqa: E731
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", [3, image, image], "float32")
        gt_box = fluid.data("gt_box", [4], "float32", lod_level=1)
        gt_label = fluid.data("gt_label", [1], "int32", lod_level=1)
        difficult = fluid.data("gt_difficult", [1], "int32", lod_level=1)
        y = _ssd_conv_bn(fluid, img, cw(32), 3, 2)
        for c_in, c_out, s in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                               (128, 256, 2), (256, 256, 1),
                               (256, 512, 2)):
            y = _ssd_separable(fluid, y, c_in, c_out, s, cw)
        for _ in range(depth):
            y = _ssd_separable(fluid, y, 512, 512, 1, cw)
        maps = [y]
        y = _ssd_separable(fluid, y, 512, 1024, 2, cw)
        maps.append(_ssd_separable(fluid, y, 1024, 1024, 1, cw))
        for c1, c2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
            y = _ssd_conv_bn(fluid, maps[-1], cw(c1), 1, 1)
            maps.append(_ssd_conv_bn(fluid, y, cw(c2), 3, 2))
        locs, confs, box, var = L.multi_box_head(
            maps, img, image, classes,
            [[2.0]] + [[2.0, 3.0]] * 5, min_ratio=20, max_ratio=90,
            min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
            max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0], flip=True,
            offset=0.5)
        test = main.clone(for_test=True)
        loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                       var))
        fluid.optimizer.RMSProp(
            lr, regularization=fluid.regularizer.L2Decay(SSD_L2)).minimize(
                loss)
    with fluid.program_guard(test, fluid.Program()):
        v = test.global_block().var
        dets = L.detection_output(v(locs.name), L.softmax(v(confs.name)),
                                  v(box.name), v(var.name),
                                  nms_threshold=0.45)
        label = L.concat([L.cast(v(gt_label.name), "float32"),
                          L.cast(v(difficult.name), "float32"),
                          v(gt_box.name)], axis=1)
        m_ap = L.detection_map(dets, label, classes, 0, 0.5, False,
                               ap_version="11point")
    return main, startup, test, loss, dets, m_ap


def _frcn_conv_affine(fluid, x, nf, k, s=1, act="relu", frozen=False,
                      scale=1.0):
    """ResNet's conv (no bias) and its frozen BN as affine_channel (scale
    and bias not trained, as PaddleDetection's affine_channel norm; the
    scale starts at ``scale``); ``frozen``: the conv's filter not trained
    either (freeze_at 2)."""
    L = fluid.layers
    y = L.conv2d(x, nf, k, stride=s, padding=(k - 1) // 2, bias_attr=False,
                 param_attr=fluid.ParamAttr(
                     trainable=not frozen,
                     initializer=fluid.initializer.Normal(
                         0.0, (2.0 / (x.shape[1] * k * k)) ** 0.5)))
    gamma = L.create_parameter([nf], "float32", attr=fluid.ParamAttr(
        trainable=False, initializer=fluid.initializer.Constant(scale)))
    beta = L.create_parameter([nf], "float32", attr=fluid.ParamAttr(
        trainable=False, initializer=fluid.initializer.Constant(0.0)))
    y = L.affine_channel(y, gamma, beta)
    return L.relu(y) if act == "relu" else y


def _frcn_bottleneck(fluid, x, c, s, cw, frozen):
    """A bottleneck (1x1, 3x3 at stride ``s``, 1x1 to 4c) and its
    shortcut; the branch's last frozen scale starts at FRCN_BRANCH_SCALE,
    so that 16 residual blocks of random filters keep the activations'
    scale, as a trained net's frozen BN does (from random weights with
    scales of 1 each block doubles the variance: a loss of 1.7e3 at
    init, then NaN)."""
    y = _frcn_conv_affine(fluid, x, cw(c), 1, 1, frozen=frozen)
    y = _frcn_conv_affine(fluid, y, cw(c), 3, s, frozen=frozen)
    y = _frcn_conv_affine(fluid, y, cw(4 * c), 1, act=None, frozen=frozen,
                          scale=FRCN_BRANCH_SCALE)
    short = x if x.shape[1] == cw(4 * c) and s == 1 else _frcn_conv_affine(
        fluid, x, cw(4 * c), 1, s, act=None, frozen=frozen)
    return fluid.layers.relu(fluid.layers.elementwise_add(y, short))


def _frcn_levels(fluid, feats, cw):
    """FPN: 1x1 laterals to 256 (times the width), the top-down sum with
    x2 nearest upsampling, 3x3 outputs; P6 a stride-2 1x1 max pool of P5.
    → [P2, P3, P4, P5, P6]."""
    L = fluid.layers
    lat = [L.conv2d(f, cw(256), 1) for f in feats]
    tops = [lat[-1]]
    for lt in lat[-2::-1]:
        up = L.resize_nearest(tops[-1], out_shape=[lt.shape[2],
                                                   lt.shape[3]])
        tops.append(L.elementwise_add(lt, up))
    outs = [L.conv2d(t, cw(256), 3, padding=1) for t in tops[::-1]]
    return outs + [L.pool2d(outs[-1], 1, "max", 2)]


def faster_rcnn_program(fluid, depth=FRCN_STAGES, width=1.0,
                        image=FRCN_IMAGE, classes=FRCN_CLASSES, lr=FRCN_LR,
                        proposals=FRCN_PROPOSALS, rois=FRCN_ROIS):
    """(c) Faster R-CNN with FPN: ResNet-50 (``depth`` bottlenecks a
    stage, widths times ``width``) with frozen BN as affine_channel, the
    stem and res2 frozen; FPN P2-P6 of 256; an RPN head shared by the
    levels (3x3 conv, then 1x1 to 3 objectness logits and 12 deltas),
    anchors 32-512 at ratios 0.5, 1, 2 (variances 1); rpn_target_assign
    over the levels' anchors (256 an image, 0.5 foreground, 0.7 / 0.3),
    its sigmoid loss meaned and its smooth L1 (sigma 3) over 256;
    generate_proposals a level (pre- and post-NMS ``proposals[0]``, 2000
    in training, NMS 0.7), collect_fpn_proposals (as many),
    generate_proposal_labels (``rois`` an image, 512,
    0.25 foreground at 0.5, weights 0.1, 0.1, 0.2, 0.2), then
    distribute_fpn_proposals (P2-P5, level 4 at 224), roi_align 7x7 on
    each level (sampling ratio 2), the RoIs put back in order; two fc of
    1024 and the classifier and box regressor over ``classes``; softmax
    loss meaned and smooth L1 (sigma 1) meaned. Momentum 0.9 with
    L2Decay FRCN_L2. The samplers' seeds are pinned (FRCN_SEEDS), so
    each run draws alike. The eval program (built alike, with
    ``proposals[1]``, 1000 in test): box_decoder_and_assign picks each RoI's best-class box,
    box_clip, then multiclass_nms (score 0.05, keep 100, NMS 0.5, pixel
    boxes). → (main, startup, eval program, loss, the NMS output)."""
    import numpy as np
    L = fluid.layers
    cw = lambda c: _w(width, c)  # noqa: E731
    h, w = image

    def backbone_and_rpn(train):
        img = fluid.data("image", [3, h, w], "float32")
        im_info = fluid.data("im_info", [3], "float32")
        y = _frcn_conv_affine(fluid, img, cw(64), 7, 2, frozen=True)
        y = L.pool2d(y, 3, "max", 2, pool_padding=1)
        feats = []
        for i, n in enumerate(depth):
            for b in range(n):
                y = _frcn_bottleneck(fluid, y, 64 << i,
                                     2 if b == 0 and i else 1, cw, i == 0)
            feats.append(y)
        levels = _frcn_levels(fluid, feats, cw)
        rpn = {}
        shared = [fluid.ParamAttr(name=f"rpn_{k}.w") for k in
                  ("conv", "cls", "box")]
        biases = [fluid.ParamAttr(name=f"rpn_{k}.b") for k in
                  ("conv", "cls", "box")]
        for li, p in enumerate(levels):
            t = L.conv2d(p, cw(256), 3, padding=1, act="relu",
                         param_attr=shared[0], bias_attr=biases[0])
            cls = L.conv2d(t, 3, 1, param_attr=shared[1], bias_attr=biases[1])
            box = L.conv2d(t, 12, 1, param_attr=shared[2], bias_attr=biases[2])
            anc, var = L.anchor_generator(
                p, [32.0 * 2 ** li], [0.5, 1.0, 2.0], [1.0] * 4,
                [4.0 * 2 ** li] * 2)
            rpn.setdefault("cls", []).append(cls)
            rpn.setdefault("box", []).append(box)
            rpn.setdefault("anchor", []).append(anc)
            rpn.setdefault("var", []).append(var)
            pre = proposals[0 if train else 1]
            rois, probs = L.generate_proposals(
                L.sigmoid(cls), box, im_info, anc, var, pre, pre, 0.7, 0.0)
            rpn.setdefault("rois", []).append(rois)
            rpn.setdefault("probs", []).append(probs)
        fpn_rois = L.collect_fpn_proposals(rpn["rois"], rpn["probs"], 2, 6,
                                           proposals[0 if train else 1])
        return img, im_info, levels, rpn, fpn_rois

    def roi_head(levels, rois):
        multi, restore = L.distribute_fpn_proposals(rois, 2, 5, 4, 224)
        pooled = [L.roi_align(p, r, 7, 7, 1.0 / (4 << i), 2)
                  for i, (p, r) in enumerate(zip(levels[:4], multi))]
        feat = L.gather(L.concat(pooled, axis=0), restore)
        fc = L.fc(L.fc(feat, cw(1024), act="relu"), cw(1024), act="relu")
        cls = L.fc(fc, classes, param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Normal(0.0, 0.01)))
        box = L.fc(fc, 4 * classes, param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Normal(0.0, 0.001)))
        return cls, box

    def flat(vs, k):
        return L.concat([L.reshape(L.transpose(v, [0, 2, 3, 1]), [0, -1, k])
                         for v in vs], axis=1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img, im_info, levels, rpn, fpn_rois = backbone_and_rpn(True)
        gt_box = fluid.data("gt_box", [4], "float32", lod_level=1)
        gt_class = fluid.data("gt_class", [1], "int32", lod_level=1)
        is_crowd = fluid.data("is_crowd", [1], "int32", lod_level=1)
        anchors = L.concat([L.reshape(a, [-1, 4]) for a in rpn["anchor"]],
                           axis=0)
        avars = L.concat([L.reshape(v, [-1, 4]) for v in rpn["var"]], axis=0)
        score, loc, s_tgt, l_tgt, l_w = L.rpn_target_assign(
            flat(rpn["box"], 4), flat(rpn["cls"], 1), anchors, avars,
            gt_box, is_crowd, im_info, 256, 0.0, 0.5, 0.7, 0.3, True)
        s_tgt = L.cast(s_tgt, "float32")
        s_tgt.stop_gradient = True
        rpn_cls = L.reduce_mean(L.sigmoid_cross_entropy_with_logits(score,
                                                                    s_tgt))
        rpn_box = L.scale(L.reduce_sum(L.smooth_l1(loc, l_tgt, l_w, l_w,
                                                   3.0)), 1.0 / 256)
        rois, labels, b_tgt, b_in, b_out = L.generate_proposal_labels(
            fpn_rois, gt_class, is_crowd, gt_box, im_info, rois, 0.25, 0.5,
            0.5, 0.0, [0.1, 0.1, 0.2, 0.2], classes, True)
        cls, box = roi_head(levels, rois)
        ce = L.reduce_mean(L.softmax_with_cross_entropy(
            cls, L.cast(labels, "int64")))
        reg = L.reduce_mean(L.smooth_l1(box, b_tgt, b_in, b_out, 1.0))
        loss = L.sums([rpn_cls, rpn_box, ce, reg])
        fluid.optimizer.Momentum(
            lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(FRCN_L2)).minimize(loss)
    for op in main.global_block().ops:
        if op.type in FRCN_SEEDS:
            op._set_attr("seed", FRCN_SEEDS[op.type])
    test = fluid.Program()
    # names counted afresh: the eval program's parameters are the main's
    with fluid.unique_name.guard(), \
            fluid.program_guard(test, fluid.Program()):
        img, im_info, levels, _, fpn_rois = backbone_and_rpn(False)
        cls, box = roi_head(levels, fpn_rois)
        prob = L.softmax(cls)
        pvar = L.assign(np.asarray([0.1, 0.1, 0.2, 0.2], "float32"))
        _, best = L.box_decoder_and_assign(fpn_rois, pvar, box, prob, 4.135)
        best = L.box_clip(best, im_info)
        pred = L.multiclass_nms(
            L.reshape(best, [1, -1, 4]),
            L.transpose(L.reshape(prob, [1, -1, classes]), [0, 2, 1]),
            0.05, -1, 100, 0.5, normalized=False, background_label=0)
    return main, startup, test, loss, pred


def _det_boxes(rng, n, w, h, lo=0.02, hi=0.5):
    """``n`` random valid xyxy boxes inside w x h, sides lo to hi of it."""
    import numpy as np
    bw = rng.uniform(lo, hi, n) * w
    bh = rng.uniform(lo, hi, n) * h
    x1 = rng.uniform(0, 1, n) * (w - bw)
    y1 = rng.uniform(0, 1, n) * (h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype("float32")


def yolo_feed(rng, bs, image=YOLO_IMAGE, classes=YOLO_CLASSES,
              boxes=YOLO_BOXES, per_image=FRCN_BOXES):
    """Images in [0, 1) and COCO-like ground truth: 1-20 boxes an image
    (``per_image``) as relative (cx, cy, w, h), padded with zero rows to
    ``boxes``; labels in [0, classes)."""
    import numpy as np
    gt = np.zeros((bs, boxes, 4), "float32")
    lab = np.zeros((bs, boxes), "int32")
    for i in range(bs):
        n = min(rng.randint(per_image[0], per_image[1] + 1), boxes)
        b = _det_boxes(rng, n, 1.0, 1.0)
        gt[i, :n] = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3])
                              / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)
        lab[i, :n] = rng.randint(0, classes, n)
    return {"image": rng.uniform(0, 1, (bs, 3, image, image)).astype(
        "float32"), "gt_box": gt, "gt_label": lab}


def ssd_feed(rng, bs, image=SSD_IMAGE, classes=SSD_CLASSES,
             per_image=SSD_BOXES):
    """Images in [0, 1) and VOC-like ground truth: 1-6 normalized xyxy
    boxes an image (LoD), labels in [1, classes), a tenth difficult."""
    import numpy as np
    n = rng.randint(per_image[0], per_image[1] + 1, bs)
    offs = [0] + [int(v) for v in np.cumsum(n)]
    t = offs[-1]
    return {"image": rng.uniform(0, 1, (bs, 3, image, image)).astype(
                "float32"),
            "gt_box": (_det_boxes(rng, t, 1.0, 1.0, 0.05, 0.6), offs),
            "gt_label": (rng.randint(1, classes, (t, 1)).astype("int32"),
                         offs),
            "gt_difficult": ((rng.rand(t, 1) < 0.1).astype("int32"), offs)}


def frcn_feed(rng, image=FRCN_IMAGE, classes=FRCN_CLASSES,
              per_image=FRCN_BOXES):
    """One image: its content (h, w − 11 of the padded size, as 800x1333
    in 800x1344) in [0, 1), COCO-like ground truth of 1-20 pixel boxes
    within it, labels in [1, classes), none crowd."""
    import numpy as np
    h, w = image
    cw = w - 11 if w > 64 else w
    n = rng.randint(per_image[0], per_image[1] + 1)
    img = np.zeros((1, 3, h, w), "float32")
    img[:, :, :, :cw] = rng.uniform(0, 1, (1, 3, h, cw))
    offs = [0, n]
    return {"image": img,
            "im_info": np.array([[h, cw, 1.0]], "float32"),
            "gt_box": (_det_boxes(rng, n, cw, h, 0.04, 0.4), offs),
            "gt_class": (rng.randint(1, classes, (n, 1)).astype("int32"),
                         offs),
            "is_crowd": (np.zeros((n, 1), "int32"), offs)}


# the detection batch's host ops: islands, selections with data-dependent
# sizes (ops/detection_ops.py, detection_train_ops.py, metrics_misc_ops.py)
DET_HOST_OPS = (
    "bipartite_match", "target_assign", "multiclass_nms", "multiclass_nms2",
    "roi_pool", "generate_proposals", "distribute_fpn_proposals",
    "collect_fpn_proposals", "rpn_target_assign", "retinanet_target_assign",
    "retinanet_detection_output", "locality_aware_nms", "mine_hard_examples",
    "generate_proposal_labels", "generate_mask_labels",
    "roi_perspective_transform", "detection_map")


class IslandTape:
    """The host ops' calls of one run, replayed into another: where the
    dense layers before a selection (NMS, top-k, matching, sampling)
    round otherwise on two sides (the card and the CPU, or two
    packages), a near-tie can part their selections, and everything
    after differs. ``recording(ops, to_np)`` patches the kernels of
    DET_HOST_OPS in the registry ``ops`` to keep each call's inputs,
    LoD and outputs as numpy. ``replaying(ops, from_np, to_np)`` patches
    another registry's: each call takes the next record of its op type,
    runs its own kernel on the RECORDED inputs, which must give the
    recorded outputs exactly (the island held exactly), and returns
    that; it also runs the kernel on its own inputs, and counts the
    selections that parted (``parted``: integers or LoD other than the
    record's, or floats beyond ``rtol``, ``atol``: a gathered payload
    rounds as its inputs do) and the float inputs' largest relative L2
    from the record (``input_rel_l2``), so that the dense parts before
    an island are held too. ``rewind()`` replays the records again (a
    second run of the same step)."""

    def __init__(self, rtol=1e-4, atol=1e-5):
        self.rtol, self.atol = rtol, atol
        self.records = {}
        self.cursor = {}
        self.parted = 0
        self.held = 0
        self.input_rel_l2 = 0.0

    def rewind(self):
        self.cursor = {}

    @contextlib.contextmanager
    def _patched(self, ops, make):
        saved = {}
        for t in DET_HOST_OPS:
            if ops.has(t):
                info = ops.get(t)
                saved[t] = info.kernel
                info.kernel = make(t, info.kernel)
        try:
            yield self
        finally:
            for t, k in saved.items():
                ops.get(t).kernel = k

    def recording(self, ops, to_np):
        def make(t, orig):
            def kernel(ins, attrs):
                outs = orig(ins, attrs)
                self.records.setdefault(t, []).append((
                    {s: [None if v is None else to_np(v) for v in vals]
                     for s, vals in ins.items()},
                    attrs.get("_lod"), _tape_outs(outs, to_np)))
                return outs
            return kernel
        return self._patched(ops, make)

    def replaying(self, ops, from_np, to_np):
        import numpy as np

        def make(t, orig):
            def kernel(ins, attrs):
                k = self.cursor.get(t, 0)
                self.cursor[t] = k + 1
                rec_ins, rec_lod, rec_outs = self.records[t][k]
                own = _tape_outs(orig(ins, attrs), to_np)
                self.parted += not own.close(rec_outs, self.rtol, self.atol)
                for s, vals in ins.items():
                    for v, r in zip(vals, rec_ins.get(s) or []):
                        if v is None or r is None or r.dtype.kind != "f":
                            continue
                        a = np.asarray(to_np(v), np.float64)
                        b = np.asarray(r, np.float64)
                        err = (float(np.linalg.norm(a - b)
                                     / max(np.linalg.norm(b), 1e-30))
                               if a.shape == b.shape else np.inf)
                        self.input_rel_l2 = max(self.input_rel_l2, err)
                mine_ins = {s: [None if r is None else from_np(r, v)
                                for r, v in zip(rec_ins[s], vals)]
                            for s, vals in ins.items()}
                a2 = dict(attrs)
                if "_lod" in attrs:
                    a2["_lod"] = rec_lod
                outs = orig(mine_ins, a2)
                if _tape_outs(outs, to_np) != rec_outs:
                    raise AssertionError(f"{t}: the island's outputs on the "
                                         "recorded inputs differ from the "
                                         "record")
                self.held += 1
                return outs
            return kernel
        return self._patched(ops, make)


class _TapeOuts:
    """A host op's outputs as numpy, compared exactly (values, shapes and
    LoD; not dtypes: the TPU package keeps int64 as int32)."""

    def __init__(self, arrays, lod):
        self.arrays, self.lod = arrays, lod

    def __eq__(self, other):
        return self.close(other, 0.0, 0.0)

    def close(self, other, rtol, atol):
        """Equal but for floats within ``rtol``, ``atol``."""
        import numpy as np
        if self.lod != other.lod or self.arrays.keys() != \
                other.arrays.keys():
            return False
        for k in self.arrays:
            a, b = self.arrays[k], other.arrays[k]
            if len(a) != len(b) or any(x.shape != y.shape for x, y in
                                       zip(a, b)):
                return False
            for x, y in zip(a, b):
                if x.dtype.kind == "f":
                    if not np.allclose(x, y, rtol=rtol, atol=atol,
                                       equal_nan=True):
                        return False
                elif not np.array_equal(x, y):
                    return False
        return True


def _tape_outs(outs, to_np):
    return _TapeOuts({k: [to_np(v) for v in vals] for k, vals in outs.items()
                      if not k.startswith("_")}, outs.get("_lod"))


def _det_battery():
    """(d) One case of each of the batch's 44 op types: (op type, its
    inputs as numpy arrays, attrs, the ``_lod`` attr or None, the slots
    its generic grad is taken for). Made from a seed; the parity tests
    run the same cases against the TPU package."""
    import numpy as np
    from paddle_tpu_torch.ops import detection_ops as det
    r = np.random.RandomState(SEED + 23)
    x = lambda *s: _vs_x(r, *s)  # noqa: E731

    def boxes(n, size=1.0, lo=0.05):
        return _det_boxes(r, n, size, size, lo, 0.5)
    i32 = lambda v: np.asarray(v, "int32")  # noqa: E731
    anchors = det._anchor_np(6, 8, {
        "anchor_sizes": [16.0, 32.0], "aspect_ratios": [0.5, 1.0, 2.0],
        "stride": [8.0, 8.0], "variances": [0.1] * 4})[0].reshape(-1, 4)
    gt, gt_lod = boxes(5, 60.0, 0.2), ((0, 3, 5),)
    rois = boxes(6, 16.0, 0.1)
    roi_lod = {"ROIs": [((0, 2, 6),)]}
    nms_scores = r.rand(2, 4, 40).astype("float32")
    nms_scores[r.rand(2, 4, 40) < 0.3] = 0.5                # ties
    nms_boxes = np.stack([boxes(40) for _ in range(2)])
    polys = r.uniform(5, 50, (9, 2)).astype("float32")
    yolo_gt = np.zeros((2, 6, 4), "float32")
    yolo_gt[:, :4] = np.concatenate([r.uniform(0.1, 0.9, (2, 4, 2)),
                                     r.uniform(0.05, 0.5, (2, 4, 2))], -1)
    det_rows = np.concatenate([r.randint(1, 5, (7, 1)),
                               np.round(r.rand(7, 1) * 8) / 8,
                               boxes(7, 50.0, 0.2)], 1).astype("float32")
    map_gt = np.concatenate([r.randint(1, 5, (5, 1)),
                             (r.rand(5, 1) < 0.3), boxes(5, 50.0, 0.2)],
                            1).astype("float32")
    cases = [
        # detection_ops: the generators and the pure ops
        ("prior_box", {"Input": [x(1, 4, 3, 4)], "Image": [x(1, 3, 12, 16)]},
         {"min_sizes": [2.0, 4.0], "max_sizes": [3.0, 6.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True}, None,
         []),
        ("density_prior_box", {"Input": [x(1, 2, 2, 3)],
                               "Image": [x(1, 3, 16, 24)]},
         {"densities": [2, 1], "fixed_sizes": [4.0, 8.0],
          "fixed_ratios": [1.0, 2.0]}, None, []),
        ("anchor_generator", {"Input": [x(1, 2, 3, 4)]},
         {"anchor_sizes": [32.0, 64.0], "stride": [8.0, 8.0]}, None, []),
        ("box_coder", {"PriorBox": [boxes(7)], "TargetBox": [boxes(5)]},
         {"variance": [0.1, 0.1, 0.2, 0.2]}, None, ["TargetBox"]),
        ("box_clip", {"Input": [r.uniform(-5, 40, (5, 4)).astype(
            "float32")], "ImInfo": [np.array([[20, 30, 1.0], [16, 12, 2.0]],
                                             "float32")]},
         {}, {"Input": [((0, 2, 5),)]}, ["Input"]),
        ("yolo_box", {"X": [x(2, 27, 5, 6)], "ImgSize": [i32([[40, 48],
                                                             [33, 50]])]},
         {"anchors": [4, 5, 6, 9, 11, 8], "class_num": 4,
          "conf_thresh": 0.3, "downsample_ratio": 8}, None, []),
        ("yolov3_loss", {"X": [x(2, 27, 4, 4) * 0.5], "GTBox": [yolo_gt],
                         "GTLabel": [r.randint(0, 4, (2, 6)).astype(
                             "int32")]},
         {"anchors": list(YOLO_ANCHORS), "anchor_mask": [0, 1, 2],
          "class_num": 4, "downsample_ratio": 8}, None, ["X"]),
        ("roi_align", {"X": [x(2, 3, 8, 10)], "ROIs": [rois]},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
          "sampling_ratio": 2}, roi_lod, ["X"]),
        # detection_ops: the host ops
        ("bipartite_match", {"DistMat": [np.round(r.rand(5, 9) * 4) / 4]},
         {"match_type": "per_prediction", "dist_threshold": 0.4},
         {"DistMat": [((0, 3, 5),)]}, []),
        ("target_assign", {"X": [x(5, 6, 4)], "MatchIndices": [i32(
            r.randint(-1, 2, (2, 6)))]}, {}, {"X": [((0, 3, 5),)]}, []),
        ("multiclass_nms", {"BBoxes": [nms_boxes], "Scores": [nms_scores]},
         {"score_threshold": 0.1, "nms_top_k": 30, "keep_top_k": 25,
          "nms_threshold": 0.3, "nms_eta": 0.9}, {}, []),
        ("multiclass_nms2", {"BBoxes": [nms_boxes * 60],
                             "Scores": [nms_scores]},
         {"score_threshold": 0.2, "nms_top_k": 20, "keep_top_k": 10,
          "nms_threshold": 0.5, "normalized": False,
          "background_label": -1}, {}, []),
        ("roi_pool", {"X": [x(2, 3, 8, 10)], "ROIs": [rois]},
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5},
         roi_lod, []),
        ("generate_proposals", {
            "Scores": [r.rand(1, 3, 4, 5).astype("float32")],
            "BboxDeltas": [x(1, 12, 4, 5) * 0.5],
            "ImInfo": [np.array([[32, 40, 1.0]], "float32")],
            "Anchors": [det._anchor_np(4, 5, {
                "anchor_sizes": [8.0, 16.0, 32.0], "aspect_ratios": [1.0],
                "stride": [8.0, 8.0], "variances": [1.0] * 4})[0]],
            "Variances": [np.full((4, 5, 3, 4), 0.5, "float32")]},
         {"pre_nms_topN": 40, "post_nms_topN": 15, "nms_thresh": 0.5,
          "min_size": 2.0}, None, []),
        ("distribute_fpn_proposals", {"FpnRois": [boxes(30, 600.0, 0.01)]},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224}, {"FpnRois": [((0, 18, 30),)]}, []),
        ("collect_fpn_proposals", {
            "MultiLevelRois": [boxes(5, 300.0), boxes(7, 300.0)],
            "MultiLevelScores": [r.rand(5, 1).astype("float32"),
                                 r.rand(7, 1).astype("float32")]},
         {"post_nms_topN": 9}, {}, []),
        # detection_train_ops
        ("rpn_target_assign", {
            "Anchor": [anchors], "GtBoxes": [gt],
            "IsCrowd": [np.zeros((5, 1), "int32")],
            "ImInfo": [np.array([[48, 64, 1.0]] * 2, "float32")]},
         {"seed": 7, "rpn_batch_size_per_im": 32},
         {"GtBoxes": [gt_lod]}, []),
        ("retinanet_target_assign", {
            "Anchor": [anchors], "GtBoxes": [gt],
            "GtLabels": [r.randint(1, 5, (5, 1)).astype("int32")],
            "IsCrowd": [np.zeros((5, 1), "int32")],
            "ImInfo": [np.array([[48, 64, 1.0]] * 2, "float32")]},
         {}, {"GtBoxes": [gt_lod]}, []),
        ("retinanet_detection_output", {
            "BBoxes": [x(2, 12, 4) * 0.3, x(2, 6, 4) * 0.3],
            "Scores": [r.rand(2, 12, 4).astype("float32"),
                       r.rand(2, 6, 4).astype("float32")],
            "Anchors": [boxes(12, 50.0, 0.2), boxes(6, 50.0, 0.2)],
            "ImInfo": [np.array([[50, 50, 1.0]] * 2, "float32")]},
         {"score_threshold": 0.3, "nms_top_k": 10, "keep_top_k": 12,
          "nms_threshold": 0.4}, {}, []),
        ("locality_aware_nms", {
            "BBoxes": [(np.repeat(boxes(6, 40.0, 0.2), 4, 0)
                        + r.uniform(-1, 1, (24, 4)).astype("float32"))[
                            None]],
            "Scores": [r.rand(1, 2, 24).astype("float32")]},
         {"score_threshold": 0.2, "nms_threshold": 0.3}, {}, []),
        ("box_decoder_and_assign", {
            "PriorBox": [boxes(5, 50.0, 0.2)],
            "PriorBoxVar": [np.array([0.1, 0.1, 0.2, 0.2], "float32")],
            "TargetBox": [x(5, 12)], "BoxScore": [r.rand(5, 3).astype(
                "float32")]}, {"box_clip": 1.0}, None, []),
        ("mine_hard_examples", {
            "ClsLoss": [r.rand(3, 20).astype("float32")],
            "LocLoss": [r.rand(3, 20).astype("float32")],
            "MatchIndices": [i32(np.where(r.rand(3, 20) < 0.5, -1,
                                          r.randint(0, 3, (3, 20))))],
            "MatchDist": [r.rand(3, 20).astype("float32")]},
         {"mining_type": "hard_example", "sample_size": 4}, {}, []),
        ("generate_proposal_labels", {
            "RpnRois": [boxes(40, 60.0, 0.1)],
            "GtClasses": [r.randint(1, 6, (5, 1)).astype("int32")],
            "IsCrowd": [np.zeros((5, 1), "int32")], "GtBoxes": [gt],
            "ImInfo": [np.array([[60, 60, 1.0]] * 2, "float32")]},
         {"seed": 3, "batch_size_per_im": 24, "class_nums": 6,
          "fg_thresh": 0.3},
         {"RpnRois": [((0, 25, 40),)], "GtBoxes": [gt_lod],
          "GtClasses": [gt_lod]}, []),
        ("generate_mask_labels", {
            "ImInfo": [np.array([[60, 60, 1.0]] * 2, "float32")],
            "GtClasses": [i32([[1], [2], [3]])],
            "IsCrowd": [np.zeros((3, 1), "int32")], "GtSegms": [polys],
            "Rois": [boxes(7, 60.0, 0.2)],
            "LabelsInt32": [i32([[2], [0], [1], [3], [0], [1], [2]])]},
         {"num_classes": 4, "resolution": 6},
         {"GtSegms": [((0, 2, 3, 4), (0, 3, 5, 7, 9))],
          "GtClasses": [((0, 2, 3),)], "Rois": [((0, 4, 7),)]}, []),
        ("roi_perspective_transform", {
            "X": [x(2, 2, 10, 12)],
            "ROIs": [np.array([[1, 1, 8, 2, 9, 7, 2, 8],
                               [0, 0, 11, 0, 11, 9, 0, 9],
                               [3, 2, 6, 1, 7, 5, 2, 6]], "float32")]},
         {"transformed_height": 4, "transformed_width": 5},
         {"ROIs": [((0, 2, 3),)]}, []),
        ("detection_map", {"DetectRes": [det_rows], "Label": [map_gt]},
         {"class_num": 5, "overlap_threshold": 0.4,
          "evaluate_difficult": False},
         {"DetectRes": [((0, 4, 7),)], "Label": [((0, 3, 5),)]}, []),
        # vision_ops
        ("crop", {"X": [x(3, 5, 6)], "Y": [x(2, 3, 4)],
                  "Offsets": [i32([1, 2, 1])]}, {}, None, ["X"]),
        ("crop_tensor", {"X": [x(2, 4, 5, 6)]},
         {"shape": [2, 2, -1, 3], "offsets": [0, 2, 0, 3]}, None, ["X"]),
        ("affine_grid", {"Theta": [x(2, 2, 3)]},
         {"output_shape": [2, 3, 5, 4], "align_corners": False}, None,
         ["Theta"]),
        ("unpool", {"X": [x(2, 3, 3, 3)], "Indices": [i32(
            r.randint(0, 36, (2, 3, 3, 3)))]}, {}, None, ["X"]),
        ("spp", {"X": [x(2, 3, 7, 9)]}, {"pyramid_height": 3}, None, ["X"]),
        ("psroi_pool", {"X": [x(2, 12, 8, 8)], "ROIs": [rois]},
         {"output_channels": 3, "spatial_scale": 0.5, "pooled_height": 2,
          "pooled_width": 2}, roi_lod, ["X"]),
        ("prroi_pool", {"X": [x(2, 3, 8, 8)], "ROIs": [rois]},
         {"spatial_scale": 0.5, "pooled_height": 3, "pooled_width": 2},
         roi_lod, ["X"]),
        ("conv3d_transpose", {"Input": [x(1, 2, 3, 4, 4)],
                              "Filter": [x(2, 3, 2, 3, 2)],
                              "Bias": [x(3)]},
         {"strides": [2, 2, 2], "paddings": [1, 1, 1]}, None,
         ["Input", "Filter", "Bias"]),
        ("depthwise_conv2d_transpose", {"Input": [x(1, 4, 5, 5)],
                                        "Filter": [x(4, 1, 3, 3)]},
         {"groups": 4, "strides": [2, 2], "paddings": [1, 1]}, None,
         ["Input", "Filter"]),
        ("deformable_conv", {
            "Input": [x(2, 4, 6, 6)], "Offset": [x(2, 36, 6, 6) * 1.5],
            "Mask": [r.rand(2, 18, 6, 6).astype("float32")],
            "Filter": [x(6, 2, 3, 3)]},
         {"paddings": [1, 1], "groups": 2, "deformable_groups": 2}, None,
         ["Input", "Offset", "Mask", "Filter"]),
        ("deformable_conv_v1", {"Input": [x(2, 4, 6, 6)],
                                "Offset": [x(2, 18, 6, 6) * 1.5],
                                "Filter": [x(6, 4, 3, 3)]},
         {"paddings": [1, 1]}, None, ["Input", "Offset", "Filter"]),
        ("deformable_psroi_pooling", {
            "Input": [x(2, 8, 8, 8)], "ROIs": [rois],
            "Trans": [x(6, 2, 2, 2) * 0.3]},
         {"spatial_scale": 0.5, "output_dim": 2, "group_size": [2, 2],
          "pooled_height": 2, "pooled_width": 2, "part_size": [2, 2],
          "sample_per_part": 2, "trans_std": 0.2}, roi_lod,
         ["Input", "Trans"]),
        ("conv_shift", {"X": [x(3, 7)], "Y": [x(3, 3)]}, {}, None,
         ["X", "Y"]),
        ("bicubic_interp", {"X": [x(1, 2, 5, 6)]},
         {"out_h": 8, "out_w": 9}, None, ["X"]),
        ("trilinear_interp", {"X": [x(1, 2, 3, 4, 5)]},
         {"out_d": 4, "out_h": 6, "out_w": 7, "align_corners": False,
          "align_mode": 0}, None, ["X"]),
        ("similarity_focus", {"X": [x(2, 3, 4, 5)]},
         {"axis": 1, "indexes": [0, 2]}, None, []),
        ("polygon_box_transform", {"Input": [x(1, 4, 3, 3)]}, {}, None,
         ["Input"]),
        ("inplace_abn", {"X": [x(2, 3, 4, 4)], "Scale": [x(3)],
                         "Bias": [x(3)], "Mean": [np.zeros(3, "float32")],
                         "Variance": [np.ones(3, "float32")]},
         {"activation": "leaky_relu", "alpha": 0.3}, None,
         ["X", "Scale", "Bias"]),
    ]
    return cases


DET_WIDTH = 1.0               # the three programs' width scale (published)
DET_EVAL_RUNS = 2             # eval runs or requests timed, after 3
YOLO_CHECK = dict(depth=(0, 0, 0, 0, 0), width=0.25, image=96)
SSD_CHECK = dict(depth=1, width=0.25)
FRCN_CHECK = dict(depth=(1, 1, 1, 1), width=0.25, image=(256, 384),
                  proposals=(300, 150), rois=128)
DET_CHECK_BATCH = 2           # (a), (b) card vs CPU; (c) is one image


def _det_tensors(feed):
    """A feed's (array, offsets) pairs as LoDTensors."""
    return {k: _lod_tensor(*v) if isinstance(v, tuple) else v
            for k, v in feed.items()}


@contextlib.contextmanager
def _det_host_clock(types):
    """The host seconds of the kernels of ``types`` while in the block:
    each call starts after the card has finished the work queued before
    it (the island's copy to the host would wait for it), so the clock
    reads the island alone. Yields a dict: seconds, calls."""
    import torch
    from paddle_tpu_torch.ops.registry import OPS
    spent = {"seconds": 0.0, "calls": 0}
    saved = {t: OPS.get(t).kernel for t in types}

    def clocked(orig):
        def kernel(ins, attrs):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return orig(ins, attrs)
            finally:
                spent["seconds"] += time.perf_counter() - t
                spent["calls"] += 1
        return kernel
    for t, k in saved.items():
        OPS.get(t).kernel = clocked(k)
    try:
        yield spent
    finally:
        for t, k in saved.items():
            OPS.get(t).kernel = k


def _det_segments(exe):
    """(compiled segments, islands, the islands' op types) of the last
    segmented step of ``exe``."""
    sb = exe._last_block
    kinds = [s.kind for s in sb.segments]
    ops = sorted({op.type for s in sb.segments if s.kind == "island"
                  for op in s.ops})
    return kinds.count("compiled"), kinds.count("island"), ops


def _det_yolo(book):
    """(a) YOLOv3 (the docstring's phase 23 (a)): 10 steps, a step one
    CUDA-graph replay; its eval program timed with the NMS island's
    share; the eval program saved and served at batch 1."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, test, loss, pred = _md_fixed(
        lambda: yolov3_program(fluid, YOLO_STAGES, DET_WIDTH, YOLO_IMAGE,
                               YOLO_CLASSES))
    test.random_seed = SEED
    feed = yolo_feed(np.random.RandomState(SEED + 40), YOLO_BATCH,
                     YOLO_IMAGE, YOLO_CLASSES)
    res = _md_train(book, f"(a) YOLOv3 DarkNet-53 {YOLO_IMAGE}x{YOLO_IMAGE} "
                    f"batch {YOLO_BATCH}, {YOLO_CLASSES} classes",
                    _md_run(main, [loss], feed), [startup], NO_KERNELS,
                    tag=DET_TAG, keep_scope=True)
    exe, scope = res.pop("exe"), res.pop("scope")
    # _md_train gated each step compiled: its whole block one CUDA graph
    if exe._last_run_mode != "compiled" or res["kinds"][0][-1] != "replay":
        raise AssertionError(f"{DET_TAG} (a) the last step ran "
                             f"{exe._last_run_mode}, {res['kinds']}")
    _log(f"{DET_TAG} (a) a YOLOv3 step is one CUDA-graph replay (the "
         f"compiled path, the last {MD_STEPS - MD_LOCK} steps replays)")
    efeed = {"image": feed["image"],
             "im_size": np.full((YOLO_BATCH, 2), YOLO_IMAGE, "int32")}
    out, res["eval_p50_ms"], res["nms_share"] = _vs_timed(
        book, exe, scope, test, efeed, [pred], "segmented",
        "(a) the eval program", DET_TAG, DET_EVAL_RUNS, ("multiclass_nms",))
    dets = out[0].numpy()
    seg = _det_segments(exe)
    _log(f"{DET_TAG} (a) the eval program at batch {YOLO_BATCH} "
         f"({seg[0]} compiled segments, {seg[1]} islands: "
         f"{', '.join(seg[2])}): {dets.shape[0]} rows, LoD "
         f"{out[0].lod()[0][:4]}..., p50 {res['eval_p50_ms']:.3f} ms, the "
         f"NMS island {100 * res['nms_share']:.1f} % of it, on "
         f"{_card_line()}")
    res["predictor_p50_ms"] = _det_serve(book, exe, scope, test, efeed,
                                         pred)
    exe.close()
    return res


def _det_serve(book, exe, scope, test, efeed, pred):
    """(a)'s eval program saved by save_inference_model and served by
    AnalysisPredictor at batch 1, as PaddleDetection's export_model then
    infer: 3 + DET_EVAL_RUNS requests, gated. → their p50 in ms."""
    import tempfile
    import numpy as np
    from paddle_tpu_torch import fluid, inference
    one = [efeed["image"][:1], efeed["im_size"][:1]]
    with tempfile.TemporaryDirectory() as d:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["image", "im_size"], [pred],
                                          exe, test)
        p = inference.create_predictor(inference.Config(d))
        kinds, times = [], []
        for _ in range(3 + DET_EVAL_RUNS):
            before = _launch_counts()
            t = time.perf_counter()
            served = p.run(one)[0]
            times.append(time.perf_counter() - t)
            kinds.append(_gate_mode(p._exe, before, NO_KERNELS,
                                    f"{DET_TAG} (a) a served request", book,
                                    "segmented"))
        p._exe.close()
    served = np.asarray(served)
    p50 = float(np.median(times[3:])) * 1e3
    ok = kinds[-1] == "replay" and np.isfinite(served).all() and \
        served.shape[-1] in (1, 6)
    _log(f"{DET_TAG} (a) the eval program served by AnalysisPredictor at "
         f"batch 1: requests {' '.join(kinds)}, {served.shape[0]} rows of "
         f"{served.shape[-1]}, p50 {p50:.3f} ms on {_card_line()} -> "
         + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{DET_TAG} (a) the served eval program")
    return p50


def _det_ssd(book):
    """(b) MobileNet-SSD (the docstring's phase 23 (b)): 10 steps
    segmented around its islands, then its eval program (detection_output
    and detection_map) timed."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, test, loss, dets, m_ap = _md_fixed(
        lambda: ssd_program(fluid, SSD_BLOCKS, DET_WIDTH, SSD_IMAGE))
    test.random_seed = SEED
    feed = _det_tensors(ssd_feed(np.random.RandomState(SEED + 41),
                                 SSD_BATCH, SSD_IMAGE))
    res = _md_train(book, f"(b) MobileNet-SSD {SSD_IMAGE}x{SSD_IMAGE} batch "
                    f"{SSD_BATCH}, {SSD_CLASSES} classes",
                    _md_run(main, [loss], feed), [startup], NO_KERNELS,
                    mode="segmented", tag=DET_TAG, keep_scope=True)
    exe, scope = res.pop("exe"), res.pop("scope")
    res["segments"], res["islands"], ops = _det_segments(exe)
    _log(f"{DET_TAG} (b) a MobileNet-SSD step runs {res['segments']} "
         f"compiled segments and {res['islands']} islands ("
         f"{', '.join(ops)})")
    out, res["eval_p50_ms"], res["nms_share"] = _vs_timed(
        book, exe, scope, test, feed, [dets, m_ap], "segmented",
        "(b) the eval program", DET_TAG, DET_EVAL_RUNS,
        ("multiclass_nms", "detection_map"))
    _log(f"{DET_TAG} (b) the eval program at batch {SSD_BATCH}: "
         f"{out[0].numpy().shape[0]} detections, mAP "
         f"{float(out[1].numpy()[0]):.4f}, p50 {res['eval_p50_ms']:.3f} ms, "
         f"the NMS and mAP islands {100 * res['nms_share']:.1f} % of it, on "
         f"{_card_line()}")
    exe.close()
    return res


def _det_frcn(book):
    """(c) Faster R-CNN R50-FPN (the docstring's phase 23 (c)): 10 steps
    segmented around its islands, each step's proposals new LoDs (a new
    plan where they change), then its eval program timed."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, test, loss, pred = _md_fixed(
        lambda: faster_rcnn_program(fluid, FRCN_STAGES, DET_WIDTH,
                                    FRCN_IMAGE, proposals=FRCN_PROPOSALS,
                                    rois=FRCN_ROIS))
    test.random_seed = SEED
    feed = _det_tensors(frcn_feed(np.random.RandomState(SEED + 42),
                                  FRCN_IMAGE))
    h, w = FRCN_IMAGE
    res = _md_train(book, f"(c) Faster R-CNN R50-FPN {h}x{w} batch 1, "
                    f"{FRCN_CLASSES} classes", _md_run(main, [loss], feed),
                    [startup], NO_KERNELS, mode="segmented", tag=DET_TAG,
                    keep_scope=True, new_plans=True)
    exe, scope = res.pop("exe"), res.pop("scope")
    res["segments"], res["islands"], ops = _det_segments(exe)
    kinds, ms = res["kinds"][0], res["step_ms"]
    new = [t for k, t in zip(kinds, ms) if k != "replay"]
    rep = [t for k, t in zip(kinds, ms) if k == "replay"]
    res["new_plan_p50_ms"] = float(np.median(new)) if new else None
    res["replay_p50_ms"] = float(np.median(rep)) if rep else None
    _log(f"{DET_TAG} (c) a Faster R-CNN step runs {res['segments']} "
         f"compiled segments and {res['islands']} islands ("
         f"{', '.join(ops)}); the steps ran {' '.join(kinds)}: new-plan "
         f"steps p50 " + (f"{res['new_plan_p50_ms']:.3f} ms" if new else
                          "none") + ", replayed " + (
             f"{res['replay_p50_ms']:.3f} ms" if rep else "none")
         + f" on {_card_line()}")
    efeed = {k: feed[k] for k in ("image", "im_info")}
    out, res["eval_p50_ms"], res["nms_share"] = _vs_timed(
        book, exe, scope, test, efeed, [pred], "segmented",
        "(c) the eval program", DET_TAG, DET_EVAL_RUNS,
        ("generate_proposals", "multiclass_nms"))
    _log(f"{DET_TAG} (c) the eval program: {out[0].numpy().shape[0]} rows, "
         f"p50 {res['eval_p50_ms']:.3f} ms, the proposal and NMS islands "
         f"{100 * res['nms_share']:.1f} % of it, on {_card_line()}")
    exe.close()
    return res


def _det_card_np(v):
    return v.detach().cpu().numpy()


def _det_cpu_from_np(a, like):
    import numpy as np
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(like.dtype) if isinstance(like, torch.Tensor) else t


def _det_check(book, what, built, fetch, feed, eval_feed, eval_fetch):
    """Card against CPU from one start at a small size
    (``_md_card_vs_cpu``: the losses, step 1's grads by the conv nets'
    rule) under an ``IslandTape``: each host op of the CPU's runs takes
    the card's inputs and must give the card's outputs exactly, and the
    CPU goes on from them, so a selection parted by a near-tie cannot
    part what follows; the selections that parted on the CPU's own
    inputs are counted. Then the eval program on both from one start (the
    startup's values), under the tape too. → (islands held, parted)."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops.registry import OPS
    main, startup, test = built[:3]
    tape = IslandTape()
    before = _launch_counts()
    _md_card_vs_cpu(book, what, main, startup, fetch, feed, conv=True,
                    tag=DET_TAG, tape=tape, tiny=True)
    names = [v.name for v in main.list_vars() if v.persistable]
    exe, scope = _fresh(main, startup)
    with tape.recording(OPS, _det_card_np):
        card = exe.run(test, feed=eval_feed, fetch_list=eval_fetch,
                       scope=scope)
    with tape.replaying(OPS, _det_cpu_from_np, _det_card_np):
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            test, feed=eval_feed, fetch_list=eval_fetch,
            scope=_clone_scope(scope, names, "cpu"))
    exe.close()
    book.add(_delta(before))
    same = all(np.allclose(a, b, rtol=LOSS_TOL, atol=LOSS_TOL)
               for a, b in zip(card, cpu))
    ok = same and tape.input_rel_l2 <= KINK_L2_TOL
    _log(f"{DET_TAG} {what}: {tape.held} island calls held exactly on the "
         f"card's inputs, {tape.parted} selections parted on the CPU's own "
         f"inputs, the islands' float inputs within relative L2 "
         f"{tape.input_rel_l2:.3e} of the card's (limit {KINK_L2_TOL:g}); "
         f"the eval program's outputs {[tuple(a.shape) for a in card]} "
         + ("equal" if same else "DIFFER") + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{DET_TAG} {what}: the eval program or the "
                             "islands' inputs differ")
    return tape.held, tape.parted


def _det_checks(book):
    """Card against CPU for each program at its check size (YOLO_CHECK,
    SSD_CHECK, FRCN_CHECK). → {program: (islands held, parted)}."""
    import numpy as np
    from paddle_tpu_torch import fluid
    res = {}
    built = _md_fixed(lambda: yolov3_program(fluid, **YOLO_CHECK))
    feed = yolo_feed(np.random.RandomState(SEED + 43), DET_CHECK_BATCH,
                     YOLO_CHECK["image"])
    res["yolov3"] = _det_check(
        book, f"(a) YOLOv3 {YOLO_CHECK['image']}x{YOLO_CHECK['image']} batch "
        f"{DET_CHECK_BATCH}, width {YOLO_CHECK['width']:g}, no residual "
        "blocks", built, [built[3]], feed,
        {"image": feed["image"], "im_size": np.full(
            (DET_CHECK_BATCH, 2), YOLO_CHECK["image"], "int32")},
        [built[4]])
    built = _md_fixed(lambda: ssd_program(fluid, **SSD_CHECK))
    feed = _det_tensors(ssd_feed(np.random.RandomState(SEED + 44),
                                 DET_CHECK_BATCH,
                                 SSD_CHECK.get("image", SSD_IMAGE)))
    res["ssd"] = _det_check(
        book, f"(b) MobileNet-SSD batch {DET_CHECK_BATCH}, width "
        f"{SSD_CHECK['width']:g}, {SSD_CHECK['depth']} block at 19x19",
        built, [built[3]], feed, feed, [built[4], built[5]])
    built = _md_fixed(lambda: faster_rcnn_program(fluid, **FRCN_CHECK))
    feed = _det_tensors(frcn_feed(np.random.RandomState(SEED + 45),
                                  FRCN_CHECK["image"]))
    h, w = FRCN_CHECK["image"]
    res["faster_rcnn"] = _det_check(
        book, f"(c) Faster R-CNN {h}x{w}, width {FRCN_CHECK['width']:g}, one "
        "bottleneck a stage", built, [built[3]], feed,
        {k: feed[k] for k in ("image", "im_info")}, [built[4]])
    return res


def phase_detection():
    """Phase 23: the detection batch (the docstring's phase 23). The main
    path, counted from zero: the three programs trained at their
    published widths and their eval programs, and (a)'s predictor. Then,
    counted apart, the checks: card against CPU under the island tape
    and the op battery. → the main path's launches: through the wrappers
    and on the card."""
    book, checks = _CfBook(), _CfBook()
    t0 = time.perf_counter()
    _reset_launch_counts()
    res = {"yolov3": _det_yolo(book), "ssd": _det_ssd(book),
           "faster_rcnn": _det_frcn(book)}
    wrapper, ran = _launch_counts(), tuple(book.executed)
    _reset_launch_counts()
    res["checks"] = _det_checks(checks)
    res["battery"] = _vs_battery_run(checks, _det_battery(), tag=DET_TAG,
                                     exact=DET_HOST_OPS)
    checked = _launch_counts()
    for counts in (wrapper, ran, checked, tuple(checks.executed)):
        if any(counts):
            raise AssertionError(f"{DET_TAG} phase 23 launched {wrapper}, on "
                                 f"the card {ran}; its checks {checked}, on "
                                 f"the card {tuple(checks.executed)}")
    parted = sum(p for _, p in res["checks"].values())
    _log(f"{DET_TAG} phase 23 in {time.perf_counter() - t0:.1f} s: step p50 "
         + ", ".join(f"{k} {res[k]['p50_ms']:.3f} ms"
                     for k in ("yolov3", "ssd", "faster_rcnn"))
         + "; eval p50 " + ", ".join(f"{k} {res[k]['eval_p50_ms']:.3f} ms"
                                     for k in ("yolov3", "ssd",
                                               "faster_rcnn"))
         + f"; YOLOv3 served at batch 1 {res['yolov3']['predictor_p50_ms']:.3f}"
         f" ms; {parted} selections parted card vs CPU; the main path's "
         f"launches through the wrappers {GATE_NAMES} {wrapper}, on the card "
         f"{ran}; the checks' apart: {checked}, on the card "
         f"{tuple(checks.executed)}")
    return {"wrapper": wrapper, "executed": ran,
            "check_executed": tuple(checks.executed), **res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401 — fails outside a checkout
    from paddle_tpu_torch.fluid import core
    # f32 products in full f32 everywhere, the kernel's plain version too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"[card] {_card_line()}")
    _log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    _log(f"[card] a fetched bf16 var comes back as numpy "
         f"{core.BF16_HOST_DTYPE}" + (
             "" if core.BF16_HOST_DTYPE.name == "bfloat16"
             else " (ml_dtypes is not installed)"))
    seconds = {}

    def timed(fn, *a, **k):
        # each phase's seconds, so that a slow run shows where it went
        t = time.perf_counter()
        out = fn(*a, **k)
        seconds[fn.__name__] = round(time.perf_counter() - t, 1)
        _log(f"[time] {fn.__name__} in {seconds[fn.__name__]} s")
        return out
    timed(phase_build)
    fwd_rows = timed(phase_kernel)
    bwd_rows = timed(phase_kernel_bwd)
    timed(phase_attention_routes)
    drop_row = timed(phase_kernel_dropout)
    paths = {"serve": timed(phase_slice, profile=args.profile),
             "train": timed(phase_train, profile=args.profile),
             "window": timed(phase_window),
             "lane": timed(phase_lane, profile=args.profile)}
    paths["remat"] = timed(phase_remat, paths["lane"]["bert"],
                           profile=args.profile)
    paths["amp"] = timed(phase_amp, paths["train"], profile=args.profile)
    paths["guard"] = timed(phase_guard)
    paths["resnet"] = timed(phase_resnet, profile=args.profile)
    paths["transformer"] = timed(phase_transformer, profile=args.profile)
    paths["lane512"] = timed(phase_lane512, profile=args.profile)
    paths["wide_deep"] = timed(phase_wide_deep, profile=args.profile)
    paths["predictor"] = timed(phase_predictor, profile=args.profile)
    paths["resume"] = timed(phase_resume)
    paths["control_flow"] = timed(phase_control_flow,
                                  paths["train"]["p50_ms"])
    paths["optimizers"] = timed(phase_optimizers, paths["train"]["p50_ms"])
    paths["lod"] = timed(phase_lod)
    paths["compiler"] = timed(phase_compiler, fwd_rows, bwd_rows)
    paths["models"] = timed(phase_models,
                            paths["resnet"]["lane"]["step_ms"])
    paths["rnn"] = timed(phase_rnn)
    paths["vision"] = timed(phase_vision)
    paths["detection"] = timed(phase_detection)
    # launches: what the card ran over the main paths of this run, each
    # path counted from zero just before it (launches_by_path: warm-ups
    # and captures through the wrappers, each replay as its graph recorded
    # and as the profiler counted); wrapper_calls_by_path: the wrappers'
    # own counts, which a replay does not move. The heading numbers of
    # the whole-block forward and the fused backward are at the bench
    # lane's shape (bf16, batch 256, no bias), those of the f32 forward,
    # dK/dV and dQ kernels, of the tiled forward and the split dK/dV and dQ
    # kernels (the old route, timed on the same inputs) at the f32
    # training step's (batch 32, bias, dropout 0.1), those of the streamed
    # kernels at the S = 512 lane's (bf16, batch 64, no bias); "timings"
    # holds every shape timed.
    # The entries are in KERNELS' order.
    src = "paddle_tpu_torch/ops/cuda/csrc/"
    replaces = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    entries = [("flash_attention_fwd", "flash_attention_fwd.cu",
                replaces + "298", fwd_rows["flash_attention_fwd"]),
               ("flash_attention_bwd_kv", "flash_attention_bwd.cu",
                replaces + "514", bwd_rows["flash_attention_bwd_kv"]),
               ("flash_attention_bwd_q", "flash_attention_bwd.cu",
                replaces + "543", bwd_rows["flash_attention_bwd_q"]),
               # both pallas_calls of _pallas_bwd and its delta prologue
               ("flash_attention_bwd_fused", "flash_attention_bwd_fused.cu",
                replaces + "480", bwd_rows["flash_attention_bwd_fused"]),
               # no Pallas kernel: jax.random.bernoulli in an XLA fusion
               ("dropout_fwd", "dropout.cu", "paddle_tpu/ops/nn_ops.py:263",
                drop_row),
               ("flash_attention_fwd_whole", "flash_attention_fwd_whole.cu",
                replaces + "298", fwd_rows["flash_attention_fwd_whole"]),
               ("flash_attention_fwd_streamed",
                "flash_attention_fwd_streamed.cu", replaces + "298",
                fwd_rows["flash_attention_fwd_streamed"]),
               # _bwd_q_kernel's pallas_call and the delta prologue (:492)
               ("flash_attention_bwd_dq_streamed",
                "flash_attention_bwd_streamed.cu", replaces + "543",
                bwd_rows["flash_attention_bwd_dq_streamed"]),
               ("flash_attention_bwd_dkdv_streamed",
                "flash_attention_bwd_streamed.cu", replaces + "514",
                bwd_rows["flash_attention_bwd_dkdv_streamed"]),
               ("flash_attention_fwd_f32", "flash_attention_fwd_f32.cu",
                replaces + "298", fwd_rows["flash_attention_fwd_f32"]),
               ("flash_attention_bwd_dkdv_f32",
                "flash_attention_bwd_dkdv_f32.cu", replaces + "514",
                bwd_rows["flash_attention_bwd_dkdv_f32"]),
               # _bwd_q_kernel's pallas_call and the delta prologue (:492)
               ("flash_attention_bwd_dq_f32",
                "flash_attention_bwd_dq_f32.cu", replaces + "543",
                bwd_rows["flash_attention_bwd_dq_f32"])]
    if tuple(e[0] for e in entries) != KERNELS:
        raise AssertionError("the kernels line's entries are not KERNELS")
    kernels = []
    for i, (name, source, repl, r) in enumerate(entries):
        by_path = {p: v["executed"][i] for p, v in paths.items()}
        kernels.append(dict(
            name=name, route="cuda", source=src + source, replaces=repl,
            launches=sum(by_path.values()), launches_by_path=by_path,
            wrapper_calls_by_path={p: v["wrapper"][i]
                                   for p, v in paths.items()},
            **{k: r[k] for k in keys},
            **{k: r[k] for k in ("max_abs_err_by_dtype", "timings",
                                 "tiled_ms", "pair_ms", "split_route_ms",
                                 "old_route_ms", "delta_ms")
               if k in r}))
    # a trace gate fails when its trace came up short (ROADMAP C2)
    _log(f"[C2] {len(TRACES)} profiler traces in phases 1-23, each "
         "holding its gate's kernels: none came up short")
    _log(f"[card] phases 1-23 in {time.perf_counter() - t_start:.1f} s: "
         + ", ".join(f"{k} {v}" for k, v in seconds.items()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
