"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (one JSON line each; any failure exits non-zero):

1. build       — nvcc builds every kernel source of the paths from csrc/
                 (one nvcc per source, all started together).
2. kernel      — the forward kernel against its plain PyTorch version on
                 the card, at the main path's shapes and edge shapes
                 (ragged causal Sq != Sk both ways, rows with no visible
                 key reading o = 0 and lse = -1e30, a GQA prefill with a
                 short Sq), with the variant each launch took
                 (flash_fwd_plan: wgmma for bf16, fma for fp32), two
                 launches bit-equal, and timings (event and device time)
                 beside its bound and a library call's time (SDPA: the
                 device time of its kernels under torch.profiler, and the
                 event time of the call beside it).
   kernel_bwd  — the two backward kernels (dq; dk/dv) against the plain
                 backward, likewise, at the training and BERT shapes and
                 edge shapes: the variant and GQA split each launch took
                 (flash_bwd_plan; a GQA shape with and without the split),
                 two launches bit-equal, ragged Sq/Sk (70, 130, 160, 200),
                 keys sharing a large mean (k = randn + 4, beside what a
                 single-bf16 dS would give), bf16 dq/dk within 5e-4 (1e-3
                 with the shared mean) and dv within 5e-3 of the plain
                 version; SDPA's backward timed by device time likewise.
3. forward     — llama_110m (bf16, full width, 12 layers, seeded random
                 weights): llama_forward on 4 x 512 tokens through the
                 flash-attention kernel, against the same model with the
                 plain attention. Phases 3-5 check that every forward
                 launch took the wgmma variant, phase 6 (fp32) the FMA one.
4. prefill     — llama_prefill_paged of one 300-token prompt into the pool.
5. serve       — InferenceServer (batch 8, 512 KV blocks of 16): 16
                 requests, ~2/3 sharing a 48-token system prompt, 32 new
                 tokens each, plus 2 oversized requests that must be shed.
6. consistency — the same traffic at fp32: every greedy token equals the
                 argmax of the kernel-backed llama_forward, except where
                 the top-2 margin is under 1e-3 (counted and printed).
7. train       — llama_110m bf16, full width and depth: ShardedTrainStep
                 (llama_loss, adamw, lr 3e-4), 6 steps on one seeded
                 8 x 1025 token batch, every flash launch on the wgmma
                 variant (12/12/12 a step); then one step split into
                 forward+loss / backward / optimizer by CUDA events, and the
                 loss gradient: at bf16 through the backward kernels vs the
                 plain backward, at fp32 through all kernels vs plain
                 attention, and both bf16 paths vs the fp32 gradient.
8. train_gqa   — llama3_8b_dry (8B widths, 2 layers, GQA 32/8, D 128,
                 remat, one-hot embedding): 3 steps on 2 x 513 tokens, every
                 flash launch on the wgmma variant (4 forward with the
                 remat recompute, 2/2 backward a step).
   train_profile — torch.profiler over 2 more steps: device time by
                 kernel group and the device's idle share of the window.
9. checkpoint  — the train phase's state saved after steps 5 and 6,
                 restored bit-equal, one more step from each copy equal; a
                 corrupted step 6 falls back to step 5.
10. kernel_cbr — the fused conv3x3 + folded-BN + ReLU kernel against its
                 plain version at ResNet-50's four bottleneck 3x3 shapes
                 (batch 64; bf16 and fp32, with and without a residual), at
                 SSD-512's (batch 32 at 512x512: phase 33's shapes) and
                 at edge shapes (the wgmma variant's ragged M, W not a
                 multiple of 8, grids under a wave), with the variant and
                 tile each launch took, two launches bit-equal, and timings
                 beside its bound and the cuDNN conv alone.
11. resnet_infer — resnet50_v1(layout="NHWC") with MXNET_TPU_FUSED_CONVBN=1
                 at full width and depth, seeded random weights and running
                 statistics, bf16: one predict-mode forward of 64 images at
                 224x224, checked against the same net on the CPU (fp32 and
                 bf16, 4 images); the composed net (gate off) as a second
                 route; a .params round trip on the card.
12. resnet_throughput — images/s at batch 64 and 256, batch-1 latency
                 p50/p99, peak memory, and torch.profiler over 2 forwards.
13. kernel_cbr_train — the training conv + batch statistics kernel
                 (conv_bn_stats) and the BN + ReLU backward kernel
                 (cbr_train_bwd) against their plain versions at ResNet-50's
                 four bottleneck 3x3 shapes (batch 256), SSD-512's (batch
                 32) and kernel_cbr's edge shapes, bf16 and fp32, with and
                 without a residual,
                 with the variant (and tile) each launch took, two launches
                 of each bit-equal, and timings: cbr_train_bwd by event and
                 device time, with its three-launch split_v8 variant's
                 device time beside it; cbr_train_bwd_global (#6's split
                 route in two calls around a cross-rank sum of its sums,
                 as path 20's C1 leg runs it) with the identity sum
                 bit-equal to the split variant's one call.
14. kernel_opt — the flat SGD and Adam kernels against their plain versions
                 over every flag combination (bit for bit), one-tensor and
                 multi-tensor launches (mixed bf16/fp32 lists, a tensor off
                 16 bytes, a list longer than one launch holds: 0 ulps
                 against the one-tensor launches and the plain version),
                 timed at 25.6M elements and over one ResNet-50 step's
                 193 tensors in one launch; the calls of phases 30 and 31
                 at 0 ulps (phase 33 checks its own).
15. resnet_train — resnet50_v1 NHWC fused, bf16 with fp32 BatchNorm,
                 224x224: FusedTrainStep + Trainer("sgd", lr 0.1, momentum
                 0.9) + SoftmaxCrossEntropyLoss, 8 steps at batch 256; the
                 imperative loop (record, backward, trainer.step) with
                 "adam", 3 steps at batch 64; both routes from one state;
                 one step's gradients against the CPU (fp32 and bf16);
                 all with cuDNN's deterministic algorithms, so that every
                 run checks the same numbers.
16. resnet_train_throughput — images/s of FusedTrainStep at batch 256, the
                 imperative step's time, peak memory, and torch.profiler
                 over one step.

17. kernel_lamb — LAMB's two kernels (flat_lamb1: moments, direction and
                 per-key squared norms; flat_lamb2: the trust-ratio apply)
                 against their plain versions over clip, bias correction,
                 mp, scalar/vector wd and scale, with and without norms,
                 fp32/bf16/fp16 and sizes 1, 7, 4097, twelve 768-element
                 keys and the 23.4M-element word embedding: elementwise
                 outputs at 0 ulps, norms within 1e-5; timed over one bf16
                 BERT-base step's buckets and one 133.5M-element vector.
18. bert_train — bert_12_768_12 (bf16, dropout 0, batch 128 x seq 128):
                 record -> SoftmaxCrossEntropyLoss on the MLM logits ->
                 backward -> Trainer("lamb", lr 1e-3, wd 0.01,
                 kvstore="device", zero=True).step, 6 steps; the ZeRO and
                 per-parameter LAMB routes at fp32 (batch 8); one fp32
                 batch-8 step's gradients against the CPU; a .params round
                 trip; the functional bert_mlm_loss at bert_base (bf16,
                 128 x 128) through the flash kernels, non-causal (12/12/12
                 flash launches on the wgmma variant), against plain
                 attention.
19. bert_train_throughput — step time (median of steps 2-6), tokens/s,
                 peak memory, and torch.profiler over one step.
20. kernel_segment_sum — the segment-sum kernel against its plain version
                 (on the CPU) bit for bit, each call on the route
                 segment_sum_plan picks and two launches bit-equal:
                 fp32/bf16/fp16 values, int32/int64 ids, widths 1, 3, 16,
                 64, 65, 128, 129 and rank-3 rows, sorted and shuffled ids
                 with many duplicates, all-equal ids, negative ids and ids
                 past the last segment (and past int32's range), nnz 0 and
                 nnz at the fused route's edge and past it (widths 16 and
                 1); timed at the main paths' shapes (8192 x 64 into
                 1,000,001 rows; 128 x 16 into 10,131,228; the
                 factorization machine's 39,000 x 16 and 39,000 x 1 into
                 1,000 rows and into 1,000,000, all on the presorted route;
                 matrix factorization's merge of 128 x 128 into its 120
                 unique ids, 16-byte loads over 32 lanes) and with
                 shuffled ids at the first, by event and device
                 time, beside its bytes bound, torch's index_add_ (zeros +
                 index_add_ by event and device time, and index_add_ alone
                 into a buffer zeroed outside the timed call) and
                 cudaMemsetAsync of the output's bytes.
21. sparse_embed — bench.py::bench_sparse's loop at its accelerator shape:
                 kv.create("local"), ShardedEmbedding(1,000,000, 64, sgd,
                 lr 0.1), init_embedding, 20 steps of a row-sparse push of
                 the step's unique zipf ids and a row_sparse_pull of 256 of
                 them; pushed rows/s, lookup p50/p99, retraces, peak memory,
                 a profile of 2 steps; the table and the last pull against
                 the same 20 steps on the CPU.
22. dlrm_train — DLRM at the Criteo Kaggle widths (facebookresearch/dlrm
                 bench/dlrm_s_criteo_kaggle.sh: 26 tables, 33,762,577 rows of
                 16, bottom 13-512-256-64-16, top 367-512-256-1), each table a
                 ShardedEmbedding (sgd, lr 0.1) through embed_fn, the towers
                 by SGD: 10 steps at batch 128 (loss falling), the first 3
                 against the CPU, a profile of 2 steps, and one forward at
                 batch 16384.

23. optimizers — the reference's 16 fusable (optimizer, args) pairs
                 (tests/test_fused_step.py) on its MLP at fp32, 4 steps of
                 Trainer.step and of FusedTrainStep from one state, within
                 rtol 2e-5 / atol 2e-6, each pair's kernel launches as
                 expected (#7 for SGD and LARS, #8 for Adam, #9/#10 for
                 LAMB, none for the plain ops); SGLD through Trainer.step,
                 its noise N(0, lr) over 1e5 elements; the four multi-SGD
                 registry ops over 8 mixed, ragged bf16/fp32 tensors (one
                 flat_sgd launch of variant multi a call, 0 ulps from the
                 plain version) and the mp LAMB phases (one flat_lamb1 and
                 one flat_lamb2 launch, 0 ulps).
24. bert_gluon_train — bench.py::bench_bert_gluon: bert_12_768_12 (bf16,
                 dropout 0, hybridized), Trainer("adamw", lr 1e-4, wd 0.01)
                 + FusedTrainStep, SoftmaxCrossEntropyLoss on out[3], one
                 seeded 128 x 128 batch: 3 warm-up and 10 timed steps (the
                 bench runs 10 + 50; cut for the smoke run's time),
                 tokens/s, the median step, peak memory, one profiled step
                 (device time, idle share, top kernels, the AdamW update's
                 `fused_step.update` range), the card's name and power
                 limit; then the bench's narrow CPU configuration at fp32:
                 FusedTrainStep against Trainer.step on the card (3 steps,
                 rtol 2e-5 / atol 2e-6), step 1's gradients against the CPU
                 (the card's one-ulp spread) and the parameters after 3
                 fused steps against the CPU (1e-4 per leaf).
25. gluon_sparse_fm — the factorization machine of BASELINE config 4 at
                 the Criteo widths (1,000,000 features, 39 nonzeros a row,
                 factor 16, batch 1000): a seeded libsvm file of 13,000
                 rows, LibSVMIter, 3 warm-up and 10 timed steps of the
                 reference's loop (models.factorization.fm_step: three CSR
                 dots under autograd.record, the logistic loss, row-sparse
                 pushes to kv.create("local") with AdaGrad, row_sparse_pull
                 of the touched rows, the bias by SGD), the iterator's
                 next() inside the window; examples/s, the median step by
                 CUDA events, peak memory, a step's host syncs, the
                 iterator's host time, a profiled step; 6 segment_sum a
                 step, all presorted; two narrow copies (2,000 features,
                 factor 4, batch 50 and batch 450, the second on the
                 presorted route) 3 steps on the card and the CPU.
26. gluon_sparse_mf — matrix factorization through Gluon at
                 MovieLens-10M's id ranges (71,569 users, 65,135 items,
                 factor 128, batch 128): MFNet's four
                 Embedding(sparse_grad=True) tables, L2Loss,
                 Trainer("sgd", lr 0.1, momentum 0.9, lazy_update), 3
                 warm-up and 20 timed steps over 4 cycled batches of
                 seeded low-rank ratings; Trainer.step's host time, a
                 profiled step; one segment_sum (fused) and one flat_sgd
                 (single) a table a step; rows no batch touched and their
                 momentum bit-unchanged; two narrow copies (60 users, 50
                 items, batch 16, factor 8 and factor 128, the second on
                 the path's merge plan) 3 steps on the card and the CPU.
27. gluon_mlp_mnist — BASELINE config 1, examples/mnist_mlp.py's Gluon
                 MLP through gluon.data.vision.MNIST: 60,000 + 10,000
                 seeded digits (one template set) written as MNIST's idx
                 files, transform_first(ToTensor()), DataLoader(batch 128,
                 shuffle), Dense 128-64-10 (ReLU) on gpu(0), hybridized,
                 SoftmaxCrossEntropyLoss, Trainer("sgd", lr 0.05, momentum
                 0.9), metric.Accuracy: one epoch of 469 steps (one multi
                 flat_sgd each), then the test set; examples/s, the median
                 step, the loader's and metric.update's host ms, host
                 syncs, peak memory, a profiled step; the same epoch
                 through Estimator.fit bit-equal; 3 steps against the CPU.
28. gluon_data_resnet50 — path 4's ResNet-50 (NHWC, fused, bf16,
                 FusedTrainStep + SGD) fed by a GluonCV-style DataLoader:
                 1,024 seeded 256x341 uint8 images in a memory-mapped .npy,
                 RandomResizedCrop(224), flips, colour jitter, lighting,
                 ToTensor, Normalize in 4 and then min(16, cpus) spawned
                 workers, batch 256; 2 warm-up and 10 timed steps each,
                 Accuracy, TopKAccuracy(5) and a Speedometer; the loader's
                 share of the step; labels in the sampler's order, no
                 worker with CUDA, workers bit-equal to the main process on
                 a deterministic chain, no shared memory left behind.
29. module_resnet50 — examples/train_image_classification.py --api module
                 at full width: resnet50_v1 (composed, NCHW, fp32, 1000
                 classes) traced on mx.sym.Variable("data") with
                 SoftmaxOutput, mx.mod.Module(context=gpu(0)).fit with
                 Xavier, SGD (lr 0.01, momentum 0.9), Accuracy, a
                 Speedometer and do_checkpoint, batch 128 from an
                 NDArrayIter on the host (one seeded 224x224 batch, 1000
                 classes, repeated; the example's ImageRecordIter is not
                 ported): 3 warm-up and 10 timed batches on the whole-graph
                 route, under cuDNN's deterministic algorithms; images/s,
                 the median step by CUDA events, Module.update's host ms,
                 whole-graph runs, compiler.fallback (0), peak memory, a
                 profiled step; losses falling, all 53 running means
                 moved; score and predict over 4 batches, Module.load of
                 the checkpoint predicting bit-equal; one step with
                 MXNET_TPU_WHOLE_GRAPH=0 against the whole-graph route and
                 3 Module steps against 3 imperative Gluon steps
                 (Trainer + SoftmaxCrossEntropyLoss), each within twice the
                 route's own spread under a one-ulp weight change.
30. gluon_word_lm — examples/word_lm.py's WordLM (Embedding -> rnn.LSTM
                 NTC -> Dropout -> Dense) at upstream MXNet's medium Gluon
                 word-LM widths (emsize 650, nhid 650, 2 layers, dropout
                 0.5, bptt 35, batch 32, a 10,000-word vocabulary) on the
                 example's seeded Zipf corpus, hybridize(static_alloc=True),
                 Trainer("sgd", lr 1.0, clip_gradient 0.25): 3 warm-up and
                 20 timed steps (one multi flat_sgd each); tokens/s, the
                 median step, trainer.step's host ms, peak memory, a
                 profiled step, the RNN op's forward and backward device
                 time beside cuDNN's LSTM (torch._VF.lstm) on the same flat
                 weights, perplexity falling; the first step's loss and
                 gradients against the CPU; the greedy continuation.
31. module_lstm_bucketing — upstream example/rnn/bucketing/lstm_bucketing.py
                 through mx.rnn: 2 stacked LSTMCell(200), Embedding(10000,
                 200), merged outputs, FullyConnected(10000), SoftmaxOutput,
                 BucketSentenceIter over seeded Zipf sentences (buckets 10
                 to 60, batch 32, invalid label 0), BucketingModule.fit with
                 SGD (lr 0.01, wd 1e-5) and Perplexity(0): 2 warm-up and 20
                 timed batches (one single flat_sgd per trainable argument
                 each); batches/s, tokens/s, the median step per bucket,
                 programs built (one per bucket), compiler.fallback (0),
                 Module.update's host ms; perplexity falling; the rnn
                 checkpoint reloaded bit-equal.
32. ops        — every name the op-set slice registers (205: tensor, nn,
                 linalg, random, image, quantization and detection ops)
                 once on the card at a small seeded shape against the
                 port's CPU result, within the CPU tests' tolerances (fp32
                 1e-5, linalg 1e-4, box log/exp 1e-6, integers exact); the
                 draws held to the CPU's shape and dtype and to their range.
33. ssd_resnet50 — SSD-512 on resnet50_v1 (NHWC, fused gate, bf16),
                 upstream example/ssd's get_config("resnet50", 512): the
                 ends of stages 3 and 4, extra layers 512/256/256/128, the
                 six maps' sizes and ratios (6,132 anchors), 21 classes,
                 built from public Gluon blocks as examples/ssd_detection.py
                 builds TinySSD; batch 32 at 512x512 of seeded synthetic
                 images and boxes (1 to 8 a image, 16 label rows);
                 MultiBoxTarget with hard-negative mining,
                 SoftmaxCrossEntropyLoss with the keep mask, HuberLoss,
                 Trainer("sgd", lr 0.002, momentum 0.9, wd 5e-4): 3 warm-up
                 and 10 timed steps; images/s, the median step, the host ms
                 of MultiBoxTarget and MultiBoxDetection, peak memory, a
                 profiled step; inference images/s at batch 32 and batch-1
                 p50/p99 over 20 calls (MultiBoxDetection, nms 0.45, top
                 400); the loss falling; the last timed step's MultiBox
                 results equal to the CPU route's on the same tensors;
                 every #4-#6 variant the path launched held to its plain
                 version at its shapes (kernel_cbr, kernel_cbr_train), and
                 the Trainer's flat_sgd call over this net's parameter
                 table (shapes, dtypes, lr and wd of each, momentum 0.9,
                 rescale 1/32) at 0 ulps, timed beside its bound.
34. zoo_inception_v3 — get_model("inceptionv3") at full width (1000
                 classes, 299x299, NCHW, fp32, seeded weights), hybridized,
                 SoftmaxCrossEntropyLoss and Trainer("sgd", lr 0.01,
                 momentum 0.9, wd 1e-4) on a seeded batch of 64: 3 warm-up
                 and 10 timed steps (one multi flat_sgd per 320 trainable
                 tensors a step); images/s, the median step, peak memory, a
                 profiled step; the loss falling; the Trainer's flat_sgd
                 call over this net's table at 0 ulps, timed beside its
                 bound; the first step's loss and gradients at batch 4
                 against the CPU (dropout off), within the limit or twice
                 the card's own spread under a one-ulp weight change; then
                 alexnet, vgg16_bn, squeezenet1.1, densenet121,
                 mobilenet1.0 and mobilenetv2_1.0 at 224 and inceptionv3 at
                 299 in predict mode, each at batch 2 against the CPU (fp32
                 logits within 1e-5, top-1 equal) and timed at batch 64;
                 all under cuDNN's deterministic algorithms.
35. gluon_dcgan — examples/dcgan.py's generator and discriminator at
                 upstream example/gluon/dc_gan's widths (ngf = ndf = 64,
                 nc 3, 100-dim latent), batch 64 at 32x32 of the example's
                 seeded blob images, Normal(0.02), hybridized,
                 SigmoidBinaryCrossEntropyLoss, two Trainer("adam", lr
                 2e-4, beta1 0.5) with the example's alternating D and G
                 updates: 3 warm-up and 20 timed steps (one multi
                 flat_adam per Trainer a step); steps/s, the median step,
                 peak memory, a profiled step; each Trainer's flat_adam
                 call over its own table at 0 ulps, timed beside its bound;
                 one step of both nets against the CPU.
36. serve_spec — bench.py::bench_serve's accelerator leg: llama_110m
                 (bf16, seeded) served with the identity draft at spec_k 4
                 (512 KV blocks of 16, batch 8, 32 requests in 4 bursts
                 of 8, ~2/3 sharing a 48-token system prompt, 32 + i mod 5
                 new tokens, 2 oversized requests shed) and again with no
                 draft: tokens/s, TTFT/TPOT p50/p99, accept rate, spec
                 rounds, prefix hit rate, peak memory, a decode round's
                 host syncs and profile; at fp32 (TF32 off) spec streams
                 equal plain greedy but at near ties (top-two margin
                 under 1e-3), the identity draft's rejections only at
                 near ties, a 2-layer draft (seed 1) that disagrees with
                 the same output; 8 sampled streams (temperature 0.8,
                 top_k 50, top_p 0.95): the card's uniforms equal the
                 CPU's bit for bit and its tokens the CPU's but at near
                 ties, one B = 8 draw timed beside the former per-row
                 loop; ReplicaGroup(2, max_restarts 0) under
                 serve.step:error:3 with greedy and sampled streams: one
                 replica dies, the other finishes every stream with the
                 unfaulted tokens, its pool reconciles to 0, each trace
                 covers >= 95% of its request's wall clock; one server
                 under serve.step:hang:2 with a 2 s step deadline stalls
                 once, recovers and finishes.
37. multi_rank — main path 19, the port's multi-rank layer. The ranks
                 (world = device_count(), one process a card) start under
                 `python -m mxnet_tpu_torch.launch` over NCCL with a
                 FileStore rendezvous and run this file with
                 --multi-rank-worker: (c) allreduce_bench at 64 MB fp32
                 (algorithmic and bus GB/s; at world 1 a copy, not
                 BASELINE's metric); (a) path 4's ResNet-50 (bf16, batch
                 256 a rank) through Trainer(kvstore="dist_device_sync",
                 sgd, momentum 0.9), 4 steps in registration order and 4
                 in readiness order (the first step initializes the
                 store), from one state, beside the one-card device store:
                 bit-equal at world 1 (at world > 1 the ranks' weights
                 equal each other and rank 0 is within P19_DP_REL of the
                 one card summing every rank's batch), readiness rounds
                 and flushes during backward counted; (b) FusedTrainStep
                 over a data mesh bit-equal to path 4's (its digests over
                 every parameter and the BatchNorm running statistics,
                 which at world > 1 come from the global batch, equal on
                 every rank); (d) BERT-base
                 LAMB on the ZeRO updater through Trainer(zero=True,
                 "dist_device_sync") bit-equal to path 5's device store at
                 world 1, then a fleet of 4 virtual ranks on the card
                 (fp32, rank r pushing its own share (2r + 1)/16 of the
                 gradients) within P19_ZERO_REL of world 1; (e) each
                 rank's chunk of llama_110m's heads (S 4096, causal, bf16
                 and fp32) through the public ring_attention and its
                 backward over the process group; (f) bench_sparse's 20
                 row-sparse pushes and pulls through a dist_sync store
                 (#11 in the unique-rows exchange; rank r the traffic of
                 seed r) against a local store pushing every rank's rows:
                 bit-equal at world 1. Then, in this process, (e) ring
                 attention at the same shapes over a fleet of 4 (4 blocks
                 of 1024; the ranks call the ring's passes, past the
                 autograd.Function), against the whole-sequence kernels.
38. tensor_parallel — main path 20, tensor and FSDP parallelism. In this
                 process llama3_8b_dry (8B widths, 2 layers, GQA 32/8, D
                 128, remat) from seeded weights, fp32 and bf16, 3 AdamW
                 steps (lr 1e-5, eps 1e-4) on one rank on a global batch
                 of 4 x 513 tokens; then four ranks under `python -m
                 mxnet_tpu_torch.launch` (all on the one card over gloo,
                 collectives staged through host memory, when
                 device_count() is 1; one a card over NCCL with four or
                 more) run this file with --tp-worker: the same weights
                 and batch through ShardedTrainStep(rules=LLAMA_RULES) on
                 mesh fsdp=2, model=2 (each rank its 16 query heads, 4 KV
                 heads, 7168 hidden columns and 4096 vocab rows, B 2):
                 fp32 losses within P20_LOSS_REL of the one-rank run a
                 step and the gathered parameters within P20_PARAM_RTOL +
                 P20_PARAM_ATOL, bf16 losses within P20_BF16_LOSS_REL;
                 each rank's flash launches a step 2n / n / n (n layers,
                 remat), bf16 all on wgmma, fp32 on fma; step time and
                 peak memory a rank (four processes sharing one card over
                 gloo is a correctness run: its step time says nothing of
                 NVLink); MeshEmbeddingComm over the four ranks with
                 bench_sparse's traffic (lookups of seed 0's ids bit-equal
                 to the world-1 table, rank r pushing seed r's rows, the
                 table within SPARSE_REL of the world-1 table fed every
                 rank's rows); the data-mesh FusedTrainStep of a
                 conv-BN-ReLU net at world 4 (#5, and #6 through its split
                 route in two calls around the all-reduce of its sums),
                 running statistics equal on every rank and within
                 P20_C1_REL of one rank fed the whole batch. With four
                 cards, also 2 bf16 steps of llama3_8b itself (32 layers,
                 vocab 128256) on the same mesh: step time and peak
                 memory.
39. resilient_bert — main path 21, native Megatron for BERT and
                 resilient sharded training. In this process bert_base
                 (vocab 30522, 12 layers, 12 heads of 64, hidden 3072)
                 from seeded weights, fp32 and bf16, 3 AdamW steps (lr
                 1e-5, eps 1e-4) on one rank on global batches of 16 x
                 128 with 15% MLM sites; then four ranks under `python -m
                 mxnet_tpu_torch.launch` (gloo on the one card, or NCCL
                 one a card) run this file with --resilient-worker: (a)
                 the same through ShardedTrainStep(rules=BERT_RULES) on
                 data=2, model=2 (6 heads, 1536 hidden columns, 15261
                 vocab rows and B 8 a rank): fp32 losses within
                 P21_LOSS_REL of one rank, gathered parameters within
                 P21_PARAM_RTOL + P21_PARAM_ATOL, bf16 losses within
                 P21_BF16_LOSS_REL, 12 / 12 / 12 flash launches a rank a
                 step (bf16 wgmma, fp32 fma), no gather over model, step
                 time and peak memory beside the same rules with every
                 split gathered on use; (b) under
                 torch.use_deterministic_algorithms, at P21_RUN_LAYERS
                 layers, ResilientRunner.for_sharded_step with
                 ckpt_every 2, commit and a PreemptionListener, 8 steps
                 under a train.step preemption and a preempt.poll notice,
                 a checkpoint.save fault on rank 1 then a resume, and a
                 train.batch corruption: each bit-equal to its fault-free
                 run (the skipped batch's for the rollback), every rank at
                 the same resumed step; save and restore ms, and one save
                 and one restore of (a)'s fp32 step at its 12 layers
                 (ms and snapshot bytes a rank). Then here
                 (c) path 5's BERT-base LAMB through Trainer(zero=True) at
                 batch 32 under MXNET_TPU_INTEGRITY=1: the ZeRO state
                 round trip, a NaN gradient tripping zero.bucket and the
                 rollback bit-equal to a run that skipped its batch, one
                 #9 and one #10 a bucket a step, the sentinel's checks and
                 host syncs a step off and on.

Twenty-one main paths, each with its own expected kernels, counts set to
0 just before and read just after: serving (phases 3-5: flash_fwd), training
(phase 7's 6 steps: flash_fwd, flash_bwd_dq, flash_bwd_dkv), ResNet-50
inference (phase 11's forward: conv_bn_relu, 16 launches, all on the
wgmma variant), ResNet-50 training (phase 15: 16 conv_bn_stats, all on the
wgmma variant, 16 cbr_train_bwd, all on the persistent variant, and one
multi-tensor flat_sgd over every trainable parameter in each
FusedTrainStep step; one multi-tensor flat_adam in each Adam step) and
BERT-base
pretraining (phase
18's 6 steps: one flat_lamb1 and one flat_lamb2 per ZeRO bucket a step;
its functional step: 12 launches of each flash kernel) and sparse
embeddings (phase 21's 20 pushes: 2 segment_sum a push; phase 22's 10
steps: 2 segment_sum per table a step; all on the fused route) and
BERT-base through Gluon with AdamW (phase 24's 13 steps: no kernel, as
the reference runs no Pallas kernel there; its update is the plain
adamw_update per parameter) and Gluon-sparse: the factorization machine
(phase 25's 10 steps: 6 segment_sum a step, all presorted) and matrix
factorization (phase 26's 20 steps: 4 segment_sum, all fused, and 4
flat_sgd, all single, a step) and the data layer: the MLP on MNIST (phase
27's epoch: one flat_sgd, multi, a step) and ResNet-50 behind a DataLoader
(phase 28's timed steps: as phase 15) and ResNet-50 through the symbolic
Module (phase 29's 10 timed steps: one flat_sgd, single, per trainable
argument a step: 193) and the recurrent models: the Gluon word LM (phase
30's 20 timed steps: one flat_sgd, multi, a step) and the LSTM
BucketingModule (phase 31's 20 timed batches: one flat_sgd, single, per
trainable argument a batch: 11) and SSD-512 (phase 33's 10 timed steps:
16 conv_bn_stats, 16 cbr_train_bwd and one multi flat_sgd a step; one
predict-mode forward: 16 conv_bn_relu) and the model zoo: Inception-v3
(phase 34's 10 timed steps: one multi flat_sgd a step) and the DCGAN
(phase 35's 20 timed steps: two multi flat_adam a step) and speculative
serving (phase 36's spec and baseline runs: no kernel; the server's
windows run the plain paged attention) and multi-rank communication
(phase 37: 16 conv_bn_stats and 16 cbr_train_bwd a ResNet-50 step, 193
single flat_sgd a store step, one multi a FusedTrainStep step; one
flat_lamb1 and one flat_lamb2 a ZeRO bucket a rank a step; one
segment_sum and one flat_sgd a sparse push; one flash launch of each
kind a visible ring block) and tensor parallelism (phase 38: 2n flash_fwd
and n of each flash backward a rank a step, the embedding leg's
segment_sum, the C1 leg's conv_bn_stats and cbr_train_bwd) and BERT's
split and resilience (phase 39: n flash launches of each kind a rank a
step in leg (a); one flat_lamb1 and one flat_lamb2 a bucket a step in leg
(c)'s clean run). Then the card's name and power limit,
the `kernels` line, and as the last line {"ok": true, "device": {...}}.
Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

BF16_ATOL = BF16_RTOL = 2e-2    # bf16 o: p is rounded to bf16 in the plain
FP32_ATOL = 1e-4                # fp32 o: summation order only
LSE_ATOL = 1e-3
NEG_INF = -1e30                 # masked logits; lse of a row that sees no key
LOGITS_REL = 2e-2               # ||a - b|| / ||b|| of bf16 model logits
MARGIN = 1e-3                   # fp32 consistency: near-ties exempt
BWD_BF16_REL = 2e-2             # ||a - b|| / ||b|| of bf16 dq, dk, dv: P is
                                # rounded to bf16 as an mma operand, and the
                                # outputs to bf16
BWD_FP32_ATOL = 1e-4            # fp32 dq, dk, dv: summation order only
BWD_BF16_DQK_REL = 5e-4         # bf16 dq, dk: dS enters as bf16 hi + lo
                                # (~16 bits), so only the outputs' rounding
                                # and the order of the fp32 sums remain
BWD_BF16_DV_REL = 5e-3          # bf16 dv: P is rounded to bf16 as an operand
BWD_SHARED_MEAN_REL = 1e-3      # bf16 dq, dk with keys that share a large
                                # mean (k = randn + 4), where a single bf16
                                # dS would lose several percent
GRAD_REL = 2e-2                 # per-leaf ||a - b|| / ||b|| of model
                                # gradients: bf16 with the backward kernels
                                # vs the plain backward (same forward), and
                                # fp32 with all kernels vs plain attention
SERVE_KERNELS = ("flash_fwd",)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
RESNET_KERNELS = ("conv_bn_relu",)

CBR_FP32_REL = 1e-4             # fp32 conv_bn_relu: max abs error over the
                                # output's max abs (summation order only)
CBR_BF16_ATOL = CBR_BF16_RTOL = 2e-2    # bf16 conv_bn_relu: both round the
                                # same fp32 value once; order differs
CBR_STAGES = [
    # name, N, H, W, Cin, Cout, launches per resnet50_v1 forward: the
    # bottleneck 3x3 convs of the four stages at batch 64
    ("stage1_56x56x64", 64, 56, 56, 64, 64, 3),
    ("stage2_28x28x128", 64, 28, 28, 128, 128, 4),
    ("stage3_14x14x256", 64, 14, 14, 256, 256, 6),
    ("stage4_7x7x512", 64, 7, 7, 512, 512, 3),
]
SSD_CBR_STAGES = [
    # the same 3x3 convs in SSD-512's trunk (main path 15: batch 32 at
    # 512x512; 3, 4, 6, 3 launches a forward and a step), checked, timed
    # and printed for #4, #5 and #6; the kernels line keeps its weights
    ("ssd512_stage1_128x128x64", 32, 128, 128, 64, 64),
    ("ssd512_stage2_64x64x128", 32, 64, 64, 128, 128),
    ("ssd512_stage3_32x32x256", 32, 32, 32, 256, 256),
    ("ssd512_stage4_16x16x512", 32, 16, 16, 512, 512),
]
SSD_CHECKED_VARIANTS = set()    # "kernel/variant" labels that the kernel
                                # phases held to the plain version at
                                # SSD_CBR_STAGES; path 15 launches no other
CBR_EDGES = [
    ("cin3_cout12", 2, 5, 5, 3, 12),
    ("image_1x1", 4, 1, 1, 64, 64),
    ("batch1_7x7", 1, 7, 7, 64, 64),
    ("cin20_cout36", 3, 9, 11, 20, 36),
] + [
    # the wgmma variant's ragged edges: M = 147, not a multiple of BM
    ("ragged_m_3x7x7x512", 3, 7, 7, 512, 512),
    # W = 14, not a multiple of 8
    ("w14_2x14x14x256", 2, 14, 14, 256, 256),
    # 49 blocks of 64 x 64: one grid under a wave
    ("under_a_wave_1x56x56x64", 1, 56, 56, 64, 64),
    # 128-row tiles with a ragged last tile, BN 128 and 64
    ("ragged_bm128_37x28x28x128", 37, 28, 28, 128, 128),
    ("ragged_bm128_7x56x56x64", 7, 56, 56, 64, 64),
]
RESNET_BATCH, RESNET_IMAGE = 64, 224
RESNET_BF16_REL = 2e-2          # bf16 logits vs the same net on the CPU:
                                # every layer rounds to bf16 on both sides
RESNET_FP32_REL = 1e-5          # fp32 logits vs the CPU: both paths fp32
                                # (TF32 off), so only the summation order
                                # differs; measured 2.9e-7 on an H100


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def check(cond, phase, msg):
    if not cond:
        fail(phase, msg)


def time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
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


def device_ms(fn, calls=20, warmup=5, tries=3):
    """fn's device time per call under torch.profiler, after `warmup`
    calls (the library yardsticks' time without their host and autograd
    overhead): for each kernel name, its mean duration over the launches
    the profiler saw in `calls` calls, times its launches a call (its
    count over `calls`, rounded). Late in a long run the profiler drops
    some records (17 of 20 launches seen), so the sum over `calls` would
    read low. A window in which the profiler saw no kernel at all is read
    again, up to `tries` windows; None if none saw one."""
    for _ in range(warmup):
        fn()
    for _ in range(tries):
        win = profile_window(lambda: [fn() for _ in range(calls)],
                             per_kernel=True)
        ms = per_call_ms(win["per_kernel"], calls)
        if ms > 0:
            return ms
    return None


def per_call_ms(per_kernel, calls):
    """Device ms a call from profile_window's per_kernel counts: each
    kernel's mean duration times its launches a call."""
    return sum(total / seen * max(1, round(seen / calls))
               for seen, total in per_kernel.values())


def bound(flops, nbytes, dtype):
    """(ms, "operations" | "bytes"): the larger of the two least times."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, H, Hkv, Sq, Sk, D, causal, dtype):
    flops = 4.0 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * D * (2 * B * H * Sq + 2 * B * Hkv * Sk)
    return bound(flops, nbytes, dtype)


def backward_bounds(B, H, Hkv, Sq, Sk, D, causal, dtype):
    """{kernel: (ms, by)}. dq recomputes S and dP and forms dS K: 3
    products; dk/dv recompute S and dP and form P^T dO and dS^T Q: 4; each
    2 * B * H * Sq * Sk * D flops, halved when causal. Bytes: each input
    read once (q, dO, k, v; lse and delta fp32), each output written once
    (dq; dk and dv)."""
    prod = 2.0 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    size = torch.tensor([], dtype=dtype).element_size()
    q_rows, kv_rows = size * D * B * H * Sq, size * D * B * Hkv * Sk
    rows = 4 * 2 * B * H * Sq
    return {"flash_bwd_dq": bound(3 * prod, 3 * q_rows + 2 * kv_rows + rows,
                                  dtype),
            "flash_bwd_dkv": bound(4 * prod,
                                   2 * q_rows + 4 * kv_rows + rows, dtype)}


def phase_build():
    from mxnet_tpu_torch.ops import KERNELS
    from mxnet_tpu_torch.ops._build import build, build_log
    t0 = time.perf_counter()
    seconds = build(list(KERNELS))
    sources = sorted({source for source, _ in KERNELS.values()})
    ptxas = {src: [ln.strip() for ln in (build_log(src) or "").splitlines()
                   if "registers" in ln or "spill" in ln]
             for src in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": seconds, "ptxas": ptxas})


def phase_kernel(gen):
    """flash_attention kernel vs _ref_forward, with the variant each launch
    took (flash_fwd_plan) and two launches bit-equal; returns the
    kernels-line entry measured at the forward phase's shape."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel.flash_attention import (_flash_forward,
                                                          _ref_forward,
                                                          flash_fwd_plan)
    bf16, fp32 = torch.bfloat16, torch.float32
    shapes = [
        # name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed
        ("forward_path", 4, 12, 12, 512, 512, 64, True, bf16, True),
        ("llama_110m_s1024", 4, 12, 12, 1024, 1024, 64, True, bf16, True),
        ("llama3_8b_layer_gqa", 1, 32, 8, 2048, 2048, 128, True, bf16,
         True),
        # main path 20: a rank's heads of llama3_8b_dry at model=2, fsdp=2
        ("llama3_8b_dry_tp_rank", 2, 16, 4, 512, 512, 128, True, bf16,
         True),
        ("llama3_8b_dry_tp_rank_fp32", 2, 16, 4, 512, 512, 128, True, fp32,
         False),
        # main path 21: a rank's heads of bert_base at data=2, model=2
        ("bert_base_tp_rank", 8, 6, 6, 128, 128, 64, False, bf16, True),
        ("bert_base_tp_rank_fp32", 8, 6, 6, 128, 128, 64, False, fp32,
         False),
        ("prefill_path", 1, 12, 12, 304, 304, 64, True, bf16, False),
        ("fp32_77x301", 2, 4, 2, 77, 301, 64, False, fp32, False),
        ("bert_base_path", 128, 12, 12, 128, 128, 64, False, bf16, True),
        ("fp32_77x301_causal", 2, 4, 2, 77, 301, 128, True, fp32, False),
        # ragged and causal with Sq != Sk: Sq < Sk (offset diagonal) and
        # Sq > Sk (the first 224 rows see no key: o = 0, lse = -1e30)
        ("bf16_ragged_causal_77x301", 2, 8, 2, 77, 301, 64, True, bf16,
         True),
        ("bf16_ragged_causal_301x77_g8", 1, 8, 1, 301, 77, 128, True, bf16,
         False),
        ("fp32_ragged_causal_301x77_g8", 1, 8, 1, 301, 77, 64, True, fp32,
         False),
        # a GQA prefill with a short Sq: 16 tokens of 32 heads against
        # 1040 cached keys of 8
        ("bf16_gqa_short_sq", 1, 32, 8, 16, 1040, 128, True, bf16, True),
    ]
    entry = None
    for name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed in shapes:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
        q, k, v = rnd(B, H, Sq, D), rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)
        sc = D ** -0.5
        plan = flash_fwd_plan(B, H, Hkv, Sq, Sk, D, dtype)
        (o, lse), variants = launched_variant(
            lambda: _flash_forward(q, k, v, causal, sc))
        o2, lse2 = _flash_forward(q, k, v, causal, sc)
        o_ref, lse_ref = _ref_forward(q, k, v, causal, sc)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs()
        lse_err = (lse - lse_ref).abs().max().item()
        if dtype == torch.bfloat16:
            ok_o = bool((err <= BF16_ATOL
                         + BF16_RTOL * o_ref.float().abs()).all())
        else:
            ok_o = err.max().item() <= FP32_ATOL
        rec = {"phase": "kernel", "kernel": "flash_fwd", "shape": name,
               "B": B, "H": H, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D,
               "causal": causal, "dtype": str(dtype).split(".")[-1],
               "plan": plan._asdict(), "variants": variants,
               "bit_equal": torch.equal(o, o2) and torch.equal(lse, lse2),
               "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
               "finite": bool(torch.isfinite(o).all())}
        ok = rec["bit_equal"] and variants == ["flash_fwd/" + plan.label] \
            and plan.variant == ("wgmma" if dtype == bf16 else "fma")
        if causal and Sq > Sk:
            blind = Sq - Sk
            rec["blind_rows"] = blind
            ok &= not o[:, :, :blind].any() \
                and bool((lse[:, :, :blind] == NEG_INF).all())
        if timed:
            g = H // Hkv
            ke, ve = (k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)) \
                if g > 1 else (k, v)
            rec["ms"] = time_ms(lambda: _flash_forward(q, k, v, causal,
                                                          sc))
            # the kernel's own device time: the event time of back-to-back
            # wrapper calls carries host time where the host is slower
            rec["device_ms"] = device_ms(lambda: _flash_forward(
                q, k, v, causal, sc))
            rec["plain_ms"] = time_ms(lambda: _ref_forward(q, k, v,
                                                              causal, sc),
                                      iters=5)
            # yardstick only: the port never calls it. Its kernels' device
            # time, and beside it the event time of the call

            def sdpa():
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=causal)
            rec["library_ms"] = device_ms(sdpa)
            rec["library_wall_ms"] = time_ms(sdpa)
            rec["bound_ms"], rec["bound_by"] = attention_bound(
                B, H, Hkv, Sq, Sk, D, causal, dtype)
        emit(rec)
        check(rec["finite"] and ok_o and lse_err <= LSE_ATOL, "kernel",
              "flash_fwd disagrees with _ref_forward at %s" % name)
        check(ok, "kernel", "flash_fwd launched another variant than its "
              "plan, differs between launches, or gave rows with no "
              "visible key other than o = 0, lse = -1e30 at %s" % name)
        if name == "forward_path":
            entry = rec
    return entry


def phase_kernel_bwd(gen):
    """The backward kernels vs the plain backward, at the main paths' shapes
    and edge shapes, with the variant and split each launch took, two
    launches bit-equal, and timings beside the bounds and SDPA's backward;
    returns {kernel: the kernels-line entry measured at the training
    path's shape}."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel.flash_attention import (FlashBwdPlan,
                                                          _delta,
                                                          _device_plan,
                                                          _flash_backward,
                                                          _flash_forward,
                                                          _launch_dkv,
                                                          _launch_dq,
                                                          _ref_backward)
    bf16, fp32 = torch.bfloat16, torch.float32
    no_split = FlashBwdPlan("wgmma", 128, 64, 1)
    shapes = [
        # name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed, plan (None:
        # the wrapper's), key mean
        ("train_path", 8, 12, 12, 1024, 1024, 64, True, bf16, True, None, 0),
        # the wrapper splits the GQA group into 2 shares here ...
        ("llama3_8b_dry_gqa", 2, 32, 8, 512, 512, 128, True, bf16, True,
         None, 0),
        # ... and the same shape without the split
        ("llama3_8b_dry_gqa_no_split", 2, 32, 8, 512, 512, 128, True, bf16,
         True, no_split, 0),
        # main path 20: a rank's heads of llama3_8b_dry at model=2, fsdp=2
        ("llama3_8b_dry_tp_rank", 2, 16, 4, 512, 512, 128, True, bf16, True,
         None, 0),
        ("llama3_8b_dry_tp_rank_fp32", 2, 16, 4, 512, 512, 128, True, fp32,
         False, None, 0),
        # main path 21: a rank's heads of bert_base at data=2, model=2
        ("bert_base_tp_rank", 8, 6, 6, 128, 128, 64, False, bf16, True,
         None, 0),
        ("bert_base_tp_rank_fp32", 8, 6, 6, 128, 128, 64, False, fp32,
         False, None, 0),
        ("bert_base_path", 128, 12, 12, 128, 128, 64, False, bf16, True,
         None, 0),
        # ragged: S not a multiple of the 64-row step or the 128-row tile
        ("bf16_160_gqa", 2, 4, 2, 160, 160, 64, True, bf16, False, None, 0),
        ("bf16_200_d128", 1, 4, 4, 200, 200, 128, True, bf16, False, None,
         0),
        ("bf16_130x70_causal", 1, 2, 2, 130, 70, 64, True, bf16, False, None,
         0),
        ("bf16_70x130_causal", 1, 2, 2, 70, 130, 64, True, bf16, False, None,
         0),
        ("bf16_200x160_d128_gqa", 2, 8, 2, 200, 160, 128, False, bf16, False,
         None, 0),
        ("bf16_130x200_gqa_dkv128_split2", 3, 8, 2, 130, 200, 64, True,
         bf16, False, FlashBwdPlan("wgmma", 64, 128, 2), 0),
        # keys sharing a large mean component: dS's hi/lo split at work
        ("bf16_shared_key_mean", 2, 8, 8, 512, 512, 64, True, bf16, False,
         None, 4.0),
        ("bf16_shared_key_mean_d128_gqa", 1, 8, 2, 256, 256, 128, True, bf16,
         False, None, 4.0),
        ("fp32_77x301", 2, 4, 2, 77, 301, 64, False, fp32, False, None, 0),
        ("fp32_77x301_causal", 2, 4, 2, 77, 301, 64, True, fp32, False, None,
         0),
        ("fp32_77x301_d128", 2, 4, 2, 77, 301, 128, False, fp32, False, None,
         0),
        ("fp32_77x301_causal_d128", 2, 4, 2, 77, 301, 128, True, fp32, False,
         None, 0),
    ]
    entries = {}
    for (name, B, H, Hkv, Sq, Sk, D, causal, dtype, timed, forced,
         kmean) in shapes:
        def rnd(*shape, mean=0.0):
            return (torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.float32) + mean).to(dtype)
        q, k = rnd(B, H, Sq, D), rnd(B, Hkv, Sk, D, mean=kmean)
        v, do = rnd(B, Hkv, Sk, D), rnd(B, H, Sq, D)
        sc = D ** -0.5
        o, lse = _flash_forward(q, k, v, causal, sc)
        delta = _delta(o, do)
        plan = forced or _device_plan(q, k)

        def backward():
            if forced is None:      # the wrapper, which plans by itself
                return _flash_backward(q, k, v, o, lse, do, causal, sc)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            _launch_dq(q, k, v, do, lse, delta, dq, causal, sc, plan)
            _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, sc, plan)
            return dq, dk, dv
        got, variants = launched_variant(backward)
        again = backward()
        want = _ref_backward(q, k, v, o, lse, do, causal, sc)
        torch.cuda.synchronize()
        rec = {"phase": "kernel_bwd", "shape": name, "B": B, "H": H,
               "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D, "causal": causal,
               "dtype": str(dtype).split(".")[-1], "key_mean": kmean,
               "plan": plan._asdict(), "variants": variants,
               "bit_equal": all(torch.equal(a, b)
                                for a, b in zip(got, again))}
        ok = rec["bit_equal"] and variants == sorted(
            ["flash_bwd_dq/" + plan.dq_label,
             "flash_bwd_dkv/" + plan.dkv_label])
        ok &= plan.variant == ("wgmma" if dtype == bf16 else "fma")
        dqk_rel = BWD_SHARED_MEAN_REL if kmean else BWD_BF16_DQK_REL
        for grad, a, b in zip(("dq", "dk", "dv"), got, want):
            a, b = a.float(), b.float()
            rec[grad + "_max_abs_err"] = (a - b).abs().max().item()
            rec[grad + "_rel_err"] = rel_err(a, b)
            rec[grad + "_norm"] = b.norm().item()
            finite = bool(torch.isfinite(a).all())
            if dtype == bf16:
                limit = BWD_BF16_DV_REL if grad == "dv" else dqk_rel
                ok &= finite and rec[grad + "_rel_err"] <= min(limit,
                                                               BWD_BF16_REL)
            else:
                ok &= finite and rec[grad + "_max_abs_err"] <= BWD_FP32_ATOL
        if kmean:
            for grad, a, b in zip(("dq", "dk"), single_bf16_ds(
                    q, k, v, lse, delta, do, causal, sc), want):
                rec["single_bf16_ds_%s_rel_err" % grad] = rel_err(
                    a.float(), b.float())
        if timed:
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            launches = {
                "flash_bwd_dq": lambda: _launch_dq(
                    q, k, v, do, lse, delta, dq, causal, sc, plan),
                "flash_bwd_dkv": lambda: _launch_dkv(
                    q, k, v, do, lse, delta, dk, dv, causal, sc, plan)}
            rec["ms"] = {kern: time_ms(fn) for kern, fn in launches.items()}
            rec["device_ms"] = {kern: device_ms(fn)
                                for kern, fn in launches.items()}
            # the plain version computes dq, dk and dv together
            rec["plain_ms"] = time_ms(lambda: _ref_backward(
                q, k, v, o, lse, do, causal, sc), iters=5)
            # yardstick only: the backward of PyTorch's own attention (dq,
            # dk and dv together; K/V repeated over the group beforehand):
            # its kernels' device time, and the event time of the call
            g = H // Hkv
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (
                q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
            out = F.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal)

            def sdpa_backward():
                return torch.autograd.grad(out, (qs, ks, vs), do,
                                           retain_graph=True)
            rec["library_ms"] = device_ms(sdpa_backward)
            rec["library_wall_ms"] = time_ms(sdpa_backward)
            rec["bound"] = backward_bounds(B, H, Hkv, Sq, Sk, D, causal,
                                           dtype)
        emit(rec)
        check(ok, "kernel_bwd",
              "backward kernels disagree with _ref_backward (or launched "
              "another variant, or differ between launches) at %s" % name)
        if name == "train_path":
            for kern, err in (("flash_bwd_dq", rec["dq_max_abs_err"]),
                              ("flash_bwd_dkv", max(rec["dk_max_abs_err"],
                                                    rec["dv_max_abs_err"]))):
                entries[kern] = {
                    "max_abs_err": err, "ms": rec["ms"][kern],
                    "plain_ms": rec["plain_ms"],
                    "library_ms": rec["library_ms"],
                    "bound_ms": rec["bound"][kern][0],
                    "bound_by": rec["bound"][kern][1]}
    return entries


def single_bf16_ds(q, k, v, lse, delta, do, causal, sc):
    """(dq, dk) as the plain backward computes them but with dS rounded
    once to bf16 before dS K and dS^T Q: what the kernels would give
    without dS's hi/lo split (a yardstick of that split only)."""
    from mxnet_tpu_torch.parallel.flash_attention import _visible
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    dog = do.reshape(B, Hkv, g, Sq, D).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = torch.matmul(qg, kf.transpose(-1, -2)) * sc
    p = torch.where(_visible(Sq, Sk, causal, q.device),
                    torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1)),
                    torch.zeros_like(s))
    dp = torch.matmul(dog, vf.transpose(-1, -2))
    ds = (p * (dp - delta.reshape(B, Hkv, g, Sq, 1)) * sc).to(
        torch.bfloat16).float()
    dq = torch.matmul(ds, kf).reshape(B, H, Sq, D)
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype)


class _PlainBackward(torch.autograd.Function):
    """Attention whose backward is the backward kernels' plain version
    (`_ref_backward`, on dense fp32 tensors); the forward is `fwd`: the
    forward kernel or its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, fwd):
        o, lse = fwd(q, k, v, causal, q.shape[-1] ** -0.5)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from mxnet_tpu_torch.parallel.flash_attention import _ref_backward
        q, k, v, o, lse = ctx.saved_tensors
        return _ref_backward(q, k, v, o, lse, do, ctx.causal,
                             q.shape[-1] ** -0.5) + (None, None)


@contextlib.contextmanager
def _attention_as(fwd):
    from mxnet_tpu_torch.models import bert, llama
    saved = llama.flash_attention
    llama.flash_attention = bert.flash_attention = \
        lambda q, k, v, causal=False: _PlainBackward.apply(q, k, v, causal,
                                                           fwd)
    try:
        yield
    finally:
        llama.flash_attention = bert.flash_attention = saved


def plain_attention():
    """llama_forward and bert_forward, and their gradients, with the flash
    kernels' plain versions in their place."""
    from mxnet_tpu_torch.parallel.flash_attention import _ref_forward
    return _attention_as(_ref_forward)


def plain_backward():
    """The forward kernel with the backward kernels' plain version: the
    model's gradient then differs from the kernel path's only by the
    backward kernels."""
    from mxnet_tpu_torch.parallel.flash_attention import _flash_forward
    return _attention_as(_flash_forward)


def rel_err(a, b):
    return ((a - b).norm() / b.norm()).item()


def phase_forward(params, cfg, gen):
    from mxnet_tpu_torch.models.llama import llama_forward
    from mxnet_tpu_torch.ops import launch_counts
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                           device="cuda")
    before = launch_counts()["flash_fwd"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = llama_forward(params, tokens, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()["flash_fwd"] - before
    with plain_attention():
        ref = llama_forward(params, tokens, cfg)
    rel = rel_err(logits, ref)
    rec = {"phase": "forward", "tokens": [4, 512], "ms": ms,
           "launches": launches, "logits_shape": list(logits.shape),
           "max_abs_diff_vs_plain": (logits - ref).abs().max().item(),
           "rel_err_vs_plain": rel,
           "argmax_agree": (logits.argmax(-1) == ref.argmax(-1))
           .float().mean().item()}
    emit(rec)
    check(launches == cfg.n_layers, "forward",
          "expected %d flash launches, saw %d" % (cfg.n_layers, launches))
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (4, 512, cfg.vocab_size),
          "forward", "non-finite or misshapen logits")
    check(rel <= LOGITS_REL, "forward", "logits differ from the plain path")
    return tokens


def phase_prefill(params, cfg, tokens):
    from mxnet_tpu_torch.models.llama import (init_kv_pools, llama_forward,
                                              llama_prefill_paged)
    from mxnet_tpu_torch.ops import launch_counts
    bs, length, S = 16, 300, 304
    pools = init_kv_pools(cfg, 512, bs, device="cuda")
    prompt = tokens[0, :length]
    padded = torch.zeros(S, dtype=torch.long, device="cuda")
    padded[:length] = prompt
    table = torch.arange(S // bs, device="cuda") + 7     # any blocks do
    before = launch_counts()["flash_fwd"]
    logits, pools = llama_prefill_paged(params, pools, padded, length, table,
                                        cfg, bs)
    torch.cuda.synchronize()
    launches = launch_counts()["flash_fwd"] - before
    ref = llama_forward(params, prompt[None], cfg)[0, -1]
    written = int((pools["0"]["k"].abs().sum(dim=(1, 2, 3)) > 0).sum())
    rel = rel_err(logits, ref)
    emit({"phase": "prefill", "length": length, "launches": launches,
          "rel_err_vs_forward": rel, "blocks_written": written})
    check(launches == cfg.n_layers, "prefill",
          "expected %d flash launches, saw %d" % (cfg.n_layers, launches))
    check(written == -(-length // bs), "prefill", "pool writes wrong")
    check(rel <= LOGITS_REL, "prefill", "logits differ from llama_forward")


def traffic(cfg):
    rng = np.random.RandomState(0)
    sys_prompt = rng.randint(1, cfg.vocab_size - 1, size=48).tolist()
    out = []
    for i in range(16):
        tail = rng.randint(1, cfg.vocab_size - 1,
                           size=rng.randint(2, 9)).tolist()
        out.append((sys_prompt + tail) if i % 3 else tail)
    return out


def serve_once(params, cfg, phase):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import InferenceServer, Overloaded, Request
    telemetry.reset()
    server = InferenceServer(params, cfg, max_batch=8, kv_blocks=512,
                             block_size=16, device="cuda").warmup()
    prompts = traffic(cfg)
    handles = [server.submit(Request(p, max_new_tokens=32)) for p in prompts]
    shed = 0
    for big in ([1] * 600, [2] * 40):
        try:
            server.submit(Request(big, max_new_tokens=10000))
        except Overloaded as exc:
            shed += exc.reason == "too_large"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [h.result(timeout=0) for h in handles]
    snap = telemetry.snapshot()
    in_use_before_clear = server.pool.blocks_in_use
    prefix_blocks = server.pool.prefix_blocks
    server.pool.clear_prefix_cache()
    hist = snap["histograms"]
    rec = {"phase": phase, "requests": len(handles), "shed": shed,
           "tokens": sum(len(o) for o in outs), "wall_s": wall,
           "tokens_per_s": sum(len(o) for o in outs) / wall,
           "ttft_ms_p50": hist["serve.ttft_ms"]["p50"],
           "ttft_ms_p99": hist["serve.ttft_ms"]["p99"],
           "tpot_ms_p50": hist["serve.tpot_ms"]["p50"],
           "tpot_ms_p99": hist["serve.tpot_ms"]["p99"],
           "prefix_hits": snap["counters"].get("serve.prefix.hits", 0),
           "prefill_chunks": snap["counters"].get("serve.prefill_chunks", 0),
           "kv_blocks_peak": snap["gauges"]["serve.kv.blocks_in_use"]["max"],
           "free_blocks_after": server.pool.free_blocks}
    emit(rec)
    check(all(len(o) == 32 for o in outs), phase, "a request fell short")
    check(shed == 2, phase, "oversized requests were not shed")
    check(in_use_before_clear == prefix_blocks, phase,
          "blocks held after every stream retired")
    check(server.pool.free_blocks == server.pool.num_blocks, phase,
          "blocks missing from the free list")
    return prompts, outs


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


def phase_consistency(params, cfg):
    from mxnet_tpu_torch.models.llama import llama_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = to_fp32(params)
    prompts, outs = serve_once(p32, cfg32, "consistency_serve")
    checked = near_ties = 0
    for prompt, out in zip(prompts, outs):
        ctx = torch.tensor([prompt + out[:-1]], device="cuda")
        logits = llama_forward(p32, ctx, cfg32)[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        want = logits.argmax(-1).tolist()
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        for got, w, m in zip(out, want, margin):
            checked += 1
            if got != w:
                check(m < MARGIN, "consistency",
                      "token %d != argmax %d (margin %.3g)" % (got, w, m))
                near_ties += 1
    emit({"phase": "consistency", "tokens_checked": checked,
          "near_tie_mismatches": near_ties})


def tree_dtypes(tree):
    if isinstance(tree, dict):
        return {k: tree_dtypes(v) for k, v in tree.items()}
    return str(tree.dtype) if torch.is_tensor(tree) else type(tree).__name__


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + "/" + k)
    elif torch.is_tensor(tree):
        yield prefix, tree


def trees_equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def launches_per_step(before, after, steps):
    return {k: (after[k] - before[k]) / steps for k in after}


def check_wgmma(before, after, expect, phase, what):
    """Every launch of the kernels in `expect` between two variant_counts()
    readings took the wgmma variant: expect[kernel] launches of each, and
    none of another variant."""
    diff = {key: n - before.get(key, 0) for key, n in after.items()}
    got = {kern: wgmma_launches(diff, kern) for kern in expect}
    other = {"%s/%s" % key: n for key, n in diff.items()
             if key[0] in expect and n and not key[1].startswith("wgmma")}
    check(got == expect and not other, phase,
          "%s: launches on the wgmma variant %s, expected %s (all variants: "
          "%s)" % (what, got, expect, diff))


def check_bwd_wgmma(before, after, launches, phase, what):
    """Every flash-backward launch between two variant_counts() readings
    took the wgmma variant: `launches` of each kernel."""
    check_wgmma(before, after, dict.fromkeys(BWD_KERNELS, launches), phase,
                what)


def check_fwd_wgmma(before, after, launches, phase, what):
    """Every flash-forward launch between two variant_counts() readings
    took the wgmma variant: `launches` of them (bf16 paths)."""
    check_wgmma(before, after, {"flash_fwd": launches}, phase, what)


def run_steps(step, params, state, batch, n, phase, expect, first=0,
              on_step=None):
    """n training steps, each synchronised and timed on the host clock,
    with its kernel launches read around it; every flash-forward and
    flash-backward launch must take the wgmma variant."""
    from mxnet_tpu_torch.ops import launch_counts, variant_counts
    losses, times = [], []
    for i in range(n):
        before, vbefore = launch_counts(), variant_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, step_num=first + i)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per = launches_per_step(before, launch_counts(), 1)
        check(all(per[k] == expect.get(k, 0) for k in per), phase,
              "step %d launched %s, expected %s" % (first + i, per, expect))
        vafter = variant_counts()
        check_bwd_wgmma(vbefore, vafter, expect.get("flash_bwd_dq", 0),
                        phase, "step %d" % (first + i))
        check_fwd_wgmma(vbefore, vafter, expect.get("flash_fwd", 0), phase,
                        "step %d" % (first + i))
        if on_step is not None:
            on_step(first + i + 1, params, state)
    return params, state, losses, times


def model_grads(params, batch, cfg, context=contextlib.nullcontext):
    """{leaf: fp32 gradient of llama_loss} with the attention `context`
    gives (default: the kernels)."""
    from mxnet_tpu_torch.models.llama import llama_loss
    names = [n for n, _ in leaves(params)]
    flat = [t for _, t in leaves(params)]
    for t in flat:
        t.requires_grad_(True)
    try:
        with context():
            got = torch.autograd.grad(llama_loss(params, batch, cfg), flat)
    finally:
        for t in flat:
            t.requires_grad_(False)
    return dict(zip(names, (g.float() for g in got)))


def leaf_errs(a, b):
    """(worst leaf, its ||a - b|| / ||b||, median over leaves)."""
    errs = {n: rel_err(a[n], b[n]) for n in b}
    worst = max(errs, key=errs.get)
    return worst, errs[worst], statistics.median(errs.values())


def phase_train(gen, ckpt_dir):
    """llama_110m bf16 training; returns (params, state, batch, step,
    launches on the path)."""
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init, llama_loss
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.parallel import ShardedTrainStep, save_train_state
    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 1025),
                                     generator=gen, device="cuda")}
    step = ShardedTrainStep(lambda p, b: llama_loss(p, b, cfg), params,
                            optimizer="adamw", lr=3e-4)
    params, state = step.init()
    dtypes = (tree_dtypes(params), tree_dtypes(state))
    n = cfg.n_layers
    expect = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}

    def save(done, p, s):
        if done in (5, 6):
            save_train_state(ckpt_dir, p, s, step=done)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    params, state, losses, times = run_steps(step, params, state, batch, 6,
                                             "train", expect, on_step=save)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    rec = {"phase": "train", "config": "llama_110m", "dtype": "bfloat16",
           "tokens": [8, 1024], "losses": losses, "step_ms": times,
           "median_step_ms_2_6": med, "tokens_per_s": 8 * 1024 / med * 1e3,
           "launches": launches, "max_memory_allocated_bytes": peak}
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "train",
          "losses not finite or not decreasing: %s" % losses)
    check(launches == {k: 6 * expect.get(k, 0) for k in launches}, "train",
          "launches on the training path %s" % launches)
    check((tree_dtypes(params), tree_dtypes(state)) == dtypes, "train",
          "a leaf changed dtype")
    emit(rec)
    return cfg, step, batch, params, state, launches


def phase_train_split(cfg, step, batch, params, state):
    """One more step split into forward+loss, backward and optimizer by
    CUDA events, then the gradient parity checks."""
    from mxnet_tpu_torch.models.llama import llama_loss
    from mxnet_tpu_torch.parallel.train_step import _leaves, _tmap
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    flat = list(_leaves(params))      # the order _tmap rebuilds
    for t in flat:
        t.requires_grad_(True)
    ev[0].record()
    loss = llama_loss(params, batch, cfg)
    ev[1].record()
    grads = torch.autograd.grad(loss, flat)
    ev[2].record()
    for t in flat:
        t.requires_grad_(False)
    it = iter(grads)
    step._opt_update(params, _tmap(lambda _: next(it), params), state,
                     step.lr, **step.opt_kwargs)
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_loss": ev[0].elapsed_time(ev[1]),
             "backward": ev[1].elapsed_time(ev[2]),
             "optimizer": ev[2].elapsed_time(ev[3])}
    # gradient parity. bf16: the model's gradient through the backward
    # kernels vs the same forward with the plain backward. fp32 (params
    # cast): the whole kernel path vs plain attention. Both paths at bf16
    # are also held against the fp32 plain gradient: two bf16 runs of the
    # model differ by about as much as either differs from fp32, so the
    # kernel path may be no further from the fp32 gradient than the plain
    # bf16 path is (x1.5 at the median leaf, x2 at the worst), as
    # bert_train holds its functional step
    g_k = model_grads(params, batch, cfg)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    bwd = leaf_errs(g_k, model_grads(params, batch, cfg, plain_backward))
    g_p = model_grads(params, batch, cfg, plain_attention)
    full_bf16 = leaf_errs(g_k, g_p)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = to_fp32(params)
    g_32 = model_grads(p32, batch, cfg32, plain_attention)
    fp32 = leaf_errs(model_grads(p32, batch, cfg32), g_32)
    del p32
    k_vs_32, p_vs_32 = leaf_errs(g_k, g_32), leaf_errs(g_p, g_32)
    median_limit = max(GRAD_REL, 1.5 * p_vs_32[2])
    max_limit = max(GRAD_REL, 2.0 * p_vs_32[1])
    names = ("leaf", "rel_err", "median_rel_err")
    emit({"phase": "train_split", "split_ms": split, "loss": loss.item(),
          "grad_batch": int(batch["tokens"].shape[0]),
          "grad_bf16_bwd_kernels_vs_plain_bwd": dict(zip(names, bwd)),
          "grad_fp32_kernels_vs_plain": dict(zip(names, fp32)),
          "grad_bf16_kernels_vs_plain": dict(zip(names, full_bf16)),
          "grad_bf16_kernels_vs_fp32": dict(zip(names, k_vs_32)),
          "grad_bf16_plain_vs_fp32": dict(zip(names, p_vs_32)),
          "grad_bf16_vs_fp32_median_limit": median_limit,
          "grad_bf16_vs_fp32_max_limit": max_limit})
    check(finite and bwd[1] <= GRAD_REL, "train_split",
          "bf16 gradient through the backward kernels differs from the "
          "plain backward's at %s" % bwd[0])
    check(fp32[1] <= GRAD_REL, "train_split",
          "fp32 gradient differs from the plain-attention one at %s"
          % fp32[0])
    check(k_vs_32[2] <= median_limit and k_vs_32[1] <= max_limit,
          "train_split", "bf16 gradient through the kernels is further from "
          "the fp32 gradient than the plain bf16 path: median %s > %s or "
          "worst %s (%s) > %s" % (k_vs_32[2], median_limit, k_vs_32[1],
                                  k_vs_32[0], max_limit))


def kernel_group(name):
    n = name.lower()
    if "flash_bwd" in n:
        return "flash_bwd"
    if "flash_fwd" in n:
        return "flash_fwd"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    if any(t in n for t in ("softmax", "log_softmax", "nll", "gather",
                            "scatter", "index")):
        return "loss_and_embedding"
    return "elementwise_and_other"


def phase_train_profile(step, batch, params, state):
    """Two training steps under torch.profiler: device time per kernel
    group (summed over the CUDA kernels of the window) against the
    window's wall time; idle share = 1 - device time / wall time (one
    stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            params, state, _ = step(params, state, batch, step_num=8 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, {}
    for ev in prof.key_averages():
        # the kernels themselves (CUPTI sees the ctypes-launched ones too),
        # not the CPU-side ops that launched them
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    rec = {"phase": "train_profile", "steps": 2, "wall_ms": wall_ms,
           "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / wall_ms,
           "device_ms_by_group": groups,
           "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                  [:12])}
    emit(rec)
    check(device_ms > 0, "train_profile", "the profiler saw no device time")


def phase_train_gqa(gen):
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init, llama_loss
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    cfg = CONFIGS["llama3_8b_dry"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(1), cfg)
    batch = torch.randint(0, cfg.vocab_size, (2, 513), generator=gen,
                          device="cuda")
    step = ShardedTrainStep(lambda p, b: llama_loss(p, b, cfg), params,
                            optimizer="adamw", lr=3e-4)
    params, state = step.init()
    n = cfg.n_layers
    # remat: each layer's forward runs again in the backward
    expect = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, times = run_steps(step, params, state, batch, 3,
                                             "train_gqa", expect)
    emit({"phase": "train_gqa", "config": "llama3_8b_dry",
          "tokens": [2, 512], "losses": losses, "step_ms": times,
          "launches_per_step": expect,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    check(all(np.isfinite(losses)), "train_gqa", "non-finite loss")
    del params, state


def phase_checkpoint(step, batch, params, state, ckpt_dir):
    """Restore step 6 into fresh tensors: bit-equal to the live state after
    step 6; one more step from each copy gives the same loss; a corrupted
    step 6 falls back to step 5."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import latest_step, restore_train_state
    p6, s6, n6 = restore_train_state(ckpt_dir)
    same = trees_equal(p6, params) and trees_equal(s6, state)
    check(n6 == 6 and latest_step(ckpt_dir) == 6 and same, "checkpoint",
          "restore of step 6 is not bit-equal to the live state")
    _, _, la = step(params, state, batch, step_num=6)
    _, _, lb = step(p6, s6, batch, step_num=6)
    la, lb = la.item(), lb.item()
    del p6, s6
    payload = os.path.join(ckpt_dir, "6", "state.pt")
    with open(payload, "r+b") as f:
        f.seek(os.path.getsize(payload) // 2)
        chunk = f.read(64)
        f.seek(-len(chunk), 1)
        f.write(bytes(b ^ 0xFF for b in chunk))
    telemetry.reset()
    _, _, n_back = restore_train_state(ckpt_dir)
    corrupt = telemetry.counter_value("checkpoint.corrupt")
    emit({"phase": "checkpoint", "restored_step": n6, "bit_equal": same,
          "next_loss_live": la, "next_loss_restored": lb,
          "after_corruption_restored_step": n_back,
          "checkpoint_corrupt": corrupt})
    check(la == lb, "checkpoint", "losses differ after restore")
    check(n_back == 5 and corrupt == 1, "checkpoint",
          "corrupted step 6 did not fall back to step 5")


def launched_variant(fn):
    """(fn's result, the "kernel/variant_BMxBN" labels of the launches it
    made), read from the wrappers' variant counts around the call."""
    from mxnet_tpu_torch.ops import variant_counts
    before = variant_counts()
    result = fn()
    after = variant_counts()
    return result, sorted("%s/%s" % k for k, n in after.items()
                          if n != before.get(k, 0))


def wgmma_launches(variants, kernel):
    """Launches of `kernel`'s wgmma variant in a variant_counts() dict."""
    return sum(n for (name, label), n in variants.items()
               if name == kernel and label.startswith("wgmma"))


def cbr_work(N, H, W, C, Cout, residual, dtype):
    """conv_bn_relu's (flops, bytes): 2*N*H*W*9*C*Cout flops; x, w, out
    (and the residual) in the working dtype plus scale and shift in fp32,
    each moved once."""
    size = torch.tensor([], dtype=dtype).element_size()
    pix = N * H * W
    nbytes = size * (pix * C + 9 * C * Cout
                     + pix * Cout * (2 if residual else 1)) + 8 * Cout
    return 2.0 * pix * 9 * C * Cout, nbytes


def phase_kernel_cbr(gen):
    """conv_bn_relu vs _ref_conv_bn_relu on the card at ResNet-50's four
    bottleneck 3x3 shapes (batch 64; bf16 and fp32, with and without a
    residual), at SSD-512's (SSD_CBR_STAGES) and at edge shapes. Returns
    the kernels-line entry: the bf16, residual-free batch-64 stage shapes
    weighted by their launches in one resnet50_v1 forward (3, 4, 6, 3 of
    16)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.fused_conv import (_ref_conv_bn_relu,
                                                conv_bn_relu, fold_bn_params)
    weighted = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
                "bytes": 0.0, "max_abs_err": 0.0}
    shapes = [(name, N, H, W, C, Co, n, True) for name, N, H, W, C, Co, n
              in CBR_STAGES] + [(name, N, H, W, C, Co, 0, True)
                                for name, N, H, W, C, Co in SSD_CBR_STAGES] \
        + [(name, N, H, W, C, Co, 0, False)
           for name, N, H, W, C, Co in CBR_EDGES]
    for name, N, H, W, C, Co, per_forward, timed in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") \
                    * scale
            x = rnd(N, H, W, C).to(dtype)
            w = rnd(3, 3, C, Co, scale=(9 * C) ** -0.5).to(dtype)
            scale, shift = fold_bn_params(
                torch.rand(Co, generator=gen, device="cuda") + 0.5,
                rnd(Co, scale=0.1), rnd(Co, scale=0.1),
                torch.rand(Co, generator=gen, device="cuda") + 0.5)
            lib_ms = None
            if timed:
                # yardstick only: the conv alone through cuDNN (no single
                # PyTorch call adds the BN affine and ReLU); the port never
                # calls it
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1))
            for res in (None, rnd(N, H, W, Co).to(dtype)):
                out, variant = launched_variant(
                    lambda: conv_bn_relu(x, w, scale, shift, res))
                again = conv_bn_relu(x, w, scale, shift, res)
                ref = _ref_conv_bn_relu(x, w, scale, shift, res)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                out_scale = ref.float().abs().max().item()
                if dtype == torch.bfloat16:
                    ok = bool((err <= CBR_BF16_ATOL + CBR_BF16_RTOL
                               * ref.float().abs()).all())
                else:
                    ok = err.max().item() <= CBR_FP32_REL * max(out_scale,
                                                                1.0)
                rec = {"phase": "kernel_cbr", "kernel": "conv_bn_relu",
                       "shape": name, "NHWC": [N, H, W, C], "Cout": Co,
                       "dtype": str(dtype).split(".")[-1],
                       "residual": res is not None, "variant": variant,
                       "max_abs_err": err.max().item(),
                       "out_max_abs": out_scale,
                       "finite": bool(torch.isfinite(out).all()),
                       "rerun_bit_equal": bool(torch.equal(out, again))}
                if timed:
                    rec["ms"] = time_ms(lambda: conv_bn_relu(x, w, scale,
                                                             shift, res))
                    rec["plain_ms"] = time_ms(lambda: _ref_conv_bn_relu(
                        x, w, scale, shift, res), iters=5)
                    rec["library_ms"] = lib_ms
                    rec["library"] = "conv only (cuDNN)"
                    work = cbr_work(N, H, W, C, Co, res is not None, dtype)
                    rec["bound_ms"], rec["bound_by"] = bound(*work, dtype)
                    if dtype == torch.bfloat16 and res is None \
                            and per_forward:
                        for key in ("ms", "plain_ms", "library_ms"):
                            weighted[key] += per_forward * rec[key] / 16
                        weighted["flops"] += per_forward * work[0]
                        weighted["bytes"] += per_forward * work[1]
                        weighted["max_abs_err"] = max(
                            weighted["max_abs_err"], rec["max_abs_err"])
                emit(rec)
                if name.startswith("ssd512"):
                    SSD_CHECKED_VARIANTS.update(variant)
                check(rec["finite"] and ok, "kernel_cbr",
                      "conv_bn_relu disagrees with _ref_conv_bn_relu at %s "
                      "%s residual=%s" % (name, dtype, res is not None))
                check(rec["rerun_bit_equal"], "kernel_cbr",
                      "two conv_bn_relu launches differ at %s %s" % (name,
                                                                     dtype))
                check(len(variant) == 1 and (variant[0].split("/")[1]
                                             .startswith("wgmma")) == (
                    dtype == torch.bfloat16 and C % 64 == 0
                    and Co % 64 == 0), "kernel_cbr",
                      "%s %s launched %s" % (name, dtype, variant))
    bms, by = bound(weighted["flops"] / 16, weighted["bytes"] / 16,
                    torch.bfloat16)
    return {"max_abs_err": weighted["max_abs_err"], "ms": weighted["ms"],
            "plain_ms": weighted["plain_ms"],
            "library_ms": weighted["library_ms"], "bound_ms": bms,
            "bound_by": by}


def resnet50(fused):
    """resnet50_v1(classes=1000, layout="NHWC") with the fused gate on or
    off, named as in a fresh process."""
    import mxnet_tpu_torch as mx
    os.environ["MXNET_TPU_FUSED_CONVBN"] = "1" if fused else "0"
    with mx.name.NameManager():
        return mx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                     layout="NHWC")


def randomize(net, seed, ctx, image=RESNET_IMAGE):
    """Seeded weights (Xavier, gaussian, fan-in, magnitude 2) and seeded
    BN parameters and running statistics: gamma and running_var in
    [0.5, 1.5), beta and running_mean N(0, 0.1^2), so the fold is not the
    identity."""
    import mxnet_tpu_torch as mx
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    with mx.autograd.predict_mode():      # resolve the deferred shapes
        net(mx.nd.zeros((1, image, image, 3), ctx=ctx))
    g = torch.Generator(device=ctx.torch_device).manual_seed(seed)
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array(torch.rand(shape, generator=g,
                                              device=ctx.torch_device)
                                   + 0.5, ctx=ctx))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array(torch.randn(shape, generator=g,
                                               device=ctx.torch_device)
                                   * 0.1, ctx=ctx))


def logits_of(net, x, ctx):
    import mxnet_tpu_torch as mx
    with mx.autograd.predict_mode():
        return net(mx.nd.array(x, ctx=ctx)).data_torch.float().cpu()


def host_copy(fused, path, dtype):
    """The same net, with the same weights, on the CPU (plain paths)."""
    import mxnet_tpu_torch as mx
    cpu_net = resnet50(fused)
    cpu_net.load_parameters(path, ctx=mx.cpu())
    cpu_net.cast(dtype)
    return cpu_net


def compare_logits(got, want, limit, phase, what):
    rel = rel_err(got, want)
    top1 = bool((got.argmax(1) == want.argmax(1)).all())
    check(bool(torch.isfinite(got).all()) and rel <= limit and top1, phase,
          "%s: logits rel. error %.3g (limit %g), top-1 equal %s"
          % (what, rel, limit, top1))
    return rel


def phase_resnet_infer(gen, tmp, batch=RESNET_BATCH, image=RESNET_IMAGE):
    """Main path 3: resnet50_v1 NHWC with the fused gate, bf16, one
    predict-mode forward of `batch` images through the Gluon entry points,
    counts reset just before and read just after. Checked against the same
    net on the CPU (fp32 and bf16, first 4 images), the composed net (gate
    off) as a second route, and a .params round trip on the card. Returns
    (net, launches on the path)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    gpu = mx.gpu(0)
    net = resnet50(True)
    randomize(net, 0, gpu, image)
    path = os.path.join(tmp, "resnet50_fused.params")
    net.save_parameters(path)
    x = torch.randn((batch, image, image, 3), generator=gen, device="cuda")
    x4 = x[:4].cpu()
    rel32 = compare_logits(logits_of(net, x[:4], gpu),
                           logits_of(host_copy(True, path, "float32"),
                                     x4, mx.cpu()),
                           RESNET_FP32_REL, "resnet_infer", "fp32 vs CPU")
    net.cast("bfloat16")
    xb = mx.nd.array(x.to(torch.bfloat16), ctx=gpu)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with mx.autograd.predict_mode():
        out = net(xb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    variants = variant_counts()
    check_path(launches, RESNET_KERNELS, "main_path_resnet")
    check(launches["conv_bn_relu"] == 16, "resnet_infer",
          "expected 16 conv_bn_relu launches, saw %s" % launches)
    check(wgmma_launches(variants, "conv_bn_relu") == 16, "resnet_infer",
          "expected all 16 conv_bn_relu launches on the wgmma variant, saw "
          "%s" % variants)
    logits = out.data_torch.float()
    check(tuple(logits.shape) == (batch, 1000)
          and bool(torch.isfinite(logits).all()), "resnet_infer",
          "non-finite or misshapen logits")
    rel16 = compare_logits(
        logits[:4].cpu(), logits_of(host_copy(True, path, "bfloat16"),
                                    x4.to(torch.bfloat16), mx.cpu()),
        RESNET_BF16_REL, "resnet_infer", "bf16 vs CPU")

    # the composed route: gate off, cuDNN convs, no kernel
    cnet = resnet50(False)
    randomize(cnet, 0, gpu, image)
    cpath = os.path.join(tmp, "resnet50_composed.params")
    cnet.save_parameters(cpath)
    cnet.cast("bfloat16")
    reset_launch_counts()
    with mx.autograd.predict_mode():
        cout = cnet(xb).data_torch.float()
    torch.cuda.synchronize()
    composed_launches = launch_counts()
    check(not any(composed_launches.values()), "resnet_infer",
          "the composed net launched %s" % composed_launches)
    rel_c = compare_logits(
        cout[:4].cpu(), logits_of(host_copy(False, cpath, "bfloat16"),
                                  x4.to(torch.bfloat16), mx.cpu()),
        RESNET_BF16_REL, "resnet_infer", "composed bf16 vs CPU")
    del cnet

    # .params round trip on the card, bit-equal
    rt = os.path.join(tmp, "resnet50_bf16.params")
    net.save_parameters(rt)
    back = resnet50(True)
    back.cast("bfloat16")
    back.load_parameters(rt, ctx=gpu)
    mine = net._collect_params_with_prefix()
    theirs = back._collect_params_with_prefix()
    same = sorted(mine) == sorted(theirs) and all(
        mine[k].data().data_torch.dtype == theirs[k].data().data_torch.dtype
        and torch.equal(mine[k].data().data_torch,
                        theirs[k].data().data_torch) for k in mine)
    check(same, "resnet_infer", ".params round trip is not bit-equal")
    del back
    emit({"phase": "resnet_infer", "config": "resnet50_v1 NHWC fused",
          "batch": batch, "image": image, "dtype": "bfloat16",
          "first_forward_ms": ms, "launches": launches,
          "variants": {"%s/%s" % k: n for k, n in variants.items()},
          "logits_shape": list(logits.shape),
          "rel_err_fp32_vs_cpu": rel32, "rel_err_bf16_vs_cpu": rel16,
          "composed_launches": composed_launches,
          "rel_err_composed_bf16_vs_cpu": rel_c,
          "params_round_trip_bit_equal": same})
    return net, launches


def infer_kernel_group(name):
    n = name.lower()
    if "cbr_" in n:    # cbr_wgmma_kernel<false, ...>, cbr_mma_kernel<false>
        return "conv_bn_relu"
    if any(t in n for t in ("fprop", "conv", "cudnn", "dgrad", "xmma")):
        return "cudnn_conv"
    if any(t in n for t in ("gemm", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "pool" in n:
        return "pooling"
    return "bn_and_elementwise"


def phase_resnet_throughput(net, gen, batches=(64, 256), image=RESNET_IMAGE):
    """Images/s (median of 10 forwards after 3 warm-ups, CUDA events) at
    each batch; batch-1 latency p50/p99 over 20 forwards; peak memory; and
    torch.profiler over 2 forwards at the first batch: device time by
    kernel group and the idle share of the window."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile

    def run(x):
        with mx.autograd.predict_mode():
            return net(x)

    def forward_ms(x, n, warmup):
        for _ in range(warmup):
            run(x)
        out = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(x)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def images(b):
        return mx.nd.array(torch.randn((b, image, image, 3), generator=gen,
                                       device="cuda").to(torch.bfloat16),
                           ctx=mx.gpu(0))

    rec = {"phase": "resnet_throughput", "dtype": "bfloat16",
           "image": image}
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        med = statistics.median(forward_ms(images(b), 10, 3))
        rec["batch%d_ms" % b] = med
        rec["batch%d_images_per_s" % b] = b / med * 1e3
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    lat = forward_ms(images(1), 20, 3)
    rec["batch1_ms_p50"] = float(np.percentile(lat, 50))
    rec["batch1_ms_p99"] = float(np.percentile(lat, 99))

    x = images(batches[0])
    run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            run(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = infer_kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    rec.update({"profile_forwards": 2, "profile_batch": batches[0],
                "profile_wall_ms": wall_ms, "profile_device_ms": device_ms,
                "idle_share": 1.0 - device_ms / wall_ms,
                "device_ms_by_group": groups,
                "top_kernels_ms": dict(sorted(top.items(),
                                              key=lambda kv: -kv[1])[:10])})
    emit(rec)
    check(device_ms > 0, "resnet_throughput",
          "the profiler saw no device time")


# --------------------------------------------------------------------------
# ResNet-50 training: kernels #5-#8 and main path 4
# --------------------------------------------------------------------------
CBR_TRAIN_STAGES = [
    # name, N, H, W, Cin, Cout, launches per training step: the bottleneck
    # 3x3 convs of the four stages at batch 256
    ("stage1_56x56x64", 256, 56, 56, 64, 64, 3),
    ("stage2_28x28x128", 256, 28, 28, 128, 128, 4),
    ("stage3_14x14x256", 256, 14, 14, 256, 256, 6),
    ("stage4_7x7x512", 256, 7, 7, 512, 512, 3),
]
TRAIN_FP32_REL = 1e-5           # fp32 kernel outputs (#5, #6): max abs error
                                # over the output's max abs; summation order
                                # only
RESNET_TRAIN_KERNELS = ("conv_bn_stats", "cbr_train_bwd", "flat_sgd")
RESNET_ADAM_KERNELS = ("conv_bn_stats", "cbr_train_bwd", "flat_adam")
TRAIN_BATCH, TRAIN_STEPS = 256, 8
ADAM_BATCH, ADAM_STEPS = 64, 3
CPU_BATCH = 8
GRAD_FP32_REL = 1e-3            # per-leaf ||a - b|| / ||b|| of one step's
                                # gradients, card vs CPU, fp32: the
                                # summation order differs (TF32 off); the
                                # limit, or twice the card's own spread
                                # under a one-ulp input change where that
                                # is larger (phase_resnet_train)
GRAD_BF16_REL = 5e-2            # bf16, against the fp32 step: every layer
                                # rounds its output to bf16; the limit, or
                                # what the CPU's plain bf16 path shows


def bf16_ulp(t):
    """One bf16 ulp at each value of t (fp32 tensor of bf16 values)."""
    a = t.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ulps_apart(a, b):
    """Elementwise distance in units in the last place of a and b (same
    float dtype, finite): the difference of their ordered integer
    images."""
    ib = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
          torch.float16: torch.int16}[a.dtype]
    x, y = a.contiguous().view(ib).long(), b.contiguous().view(ib).long()
    top = {torch.int32: 0x7FFFFFFF, torch.int16: 0x7FFF}[ib]
    x = torch.where(x < 0, -(x & top), x)
    y = torch.where(y < 0, -(y & top), y)
    return (x - y).abs()


def close_rel(a, b, rel):
    """max |a - b| <= rel * max |b| (fp32 compare)."""
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item() if a.numel() else 0.0
    scale = b.abs().max().item() if b.numel() else 0.0
    return err, err <= rel * max(scale, 1e-30)


def cbr_train_works(N, H, W, C, Cout, residual, dtype):
    """{kernel: (flops, bytes)} of one training block: conv_bn_stats reads
    x and w and writes the conv output and the (2, Cout) sums;
    cbr_train_bwd reads conv_out and dy (and the residual) and six
    (Cout,) fp32 vectors and writes the fp32 dconv (and dres) and the sums
    (about 20 operations an element, far under the bytes)."""
    size = torch.tensor([], dtype=dtype).element_size()
    pix = N * H * W
    stats = (2.0 * pix * 9 * C * Cout,
             size * (pix * C + 9 * C * Cout + pix * Cout) + 8 * Cout)
    res = pix * Cout * size if residual else 0
    bwd = (20.0 * pix * Cout,
           size * 2 * pix * Cout + 2 * res + 4 * pix * Cout + 32 * Cout)
    return {"conv_bn_stats": stats, "cbr_train_bwd": bwd}


def phase_kernel_cbr_train(gen):
    """conv_bn_stats (#5) and cbr_train_bwd (#6) against their plain
    versions on the card at ResNet-50's four bottleneck 3x3 shapes (batch
    256), at SSD-512's (SSD_CBR_STAGES) and at edge shapes, bf16 and fp32,
    with and without a residual. Compared: the op's out, mean and var, and
    dconv, dgamma, dbeta, dres. Returns {kernel: kernels-line entry}: the
    bf16, residual-free batch-256 stage shapes, weighted by their launches
    in one resnet50_v1 step (3, 4, 6, 3 of 16)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.fused_conv import (_conv3x3_backward,
                                                _launch_cbr_bwd,
                                                _normalize_relu,
                                                _ref_cbr_train_bwd,
                                                _ref_conv_bn_stats,
                                                cbr_bwd_plan, cbr_train_bwd,
                                                cbr_train_bwd_global,
                                                conv_bn_stats)
    names = ("conv_bn_stats", "cbr_train_bwd")
    # the fused blocks' dx/dw: PyTorch's conv backward in full fp32 from
    # the fp32 dconv (the reference's numerics), per training step
    dxdw = {"ms": 0.0, "flops": 0.0}
    weighted = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "flops": 0.0, "bytes": 0.0, "max_abs_err": 0.0,
                    "device_ms": 0.0}
                for k in names}
    weighted["cbr_train_bwd"]["library_ms"] = None
    shapes = [(n, N, H, W, C, Co, k, True) for n, N, H, W, C, Co, k
              in CBR_TRAIN_STAGES] + [(n, N, H, W, C, Co, 0, True)
                                      for n, N, H, W, C, Co
                                      in SSD_CBR_STAGES] \
        + [(n, N, H, W, C, Co, 0, False) for n, N, H, W, C, Co in CBR_EDGES]
    eps = 1e-3
    for name, N, H, W, C, Co, per_step, timed in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") \
                    * scale
            x = rnd(N, H, W, C).to(dtype)
            w = rnd(3, 3, C, Co, scale=(9 * C) ** -0.5).to(dtype)
            gamma = torch.rand(Co, generator=gen, device="cuda") + 0.5
            beta = rnd(Co, scale=0.1)
            dy = rnd(N, H, W, Co).to(dtype)
            M = N * H * W

            def stats(conv_fn):
                conv, s, sq = conv_fn(x, w)
                mean = s / M
                var = torch.clamp_min(sq / M - mean * mean, 0.0)
                return conv, mean, var, torch.rsqrt(var + eps)

            raw, variant = launched_variant(lambda: conv_bn_stats(x, w))
            rerun = conv_bn_stats(x, w)
            rerun_equal = all(torch.equal(a, b) for a, b in zip(raw, rerun))
            del rerun
            got, want = stats(lambda *_: raw), stats(_ref_conv_bn_stats)
            lib_ms = None
            if timed:
                # yardstick only: the conv alone through cuDNN on
                # channels-last tensors; the port never calls it
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1))
            for res in (None, rnd(N, H, W, Co).to(dtype)):
                rec = {"phase": "kernel_cbr_train", "shape": name,
                       "NHWC": [N, H, W, C], "Cout": Co,
                       "dtype": str(dtype).split(".")[-1],
                       "residual": res is not None,
                       "conv_bn_stats_variant": variant,
                       "rerun_bit_equal": rerun_equal}
                outs = []
                for conv, mean, _, invstd in (got, want):
                    _, y = _normalize_relu(conv, mean, invstd, gamma, beta,
                                           res)
                    outs.append(torch.relu(y).to(dtype))
                torch.cuda.synchronize()
                bad = []           # the outputs out of their bound
                if not bool(torch.isfinite(got[0].float()).all()):
                    bad.append("conv_out finite")
                if not rerun_equal:
                    bad.append("conv_out and sums differ between launches")
                if len(variant) != 1 or (variant[0].split("/")[1]
                                         .startswith("wgmma")) != (
                        dtype == torch.bfloat16 and C % 64 == 0
                        and Co % 64 == 0):
                    bad.append("variant %s" % variant)
                # #5: the conv output, and the op's out, mean and var
                if dtype == torch.bfloat16:
                    # bf16: one ulp of the larger of the two values (each
                    # side rounds its fp32 value once), plus the fp32
                    # summation order's share, which decides the rounding
                    # of values near zero; for out also what the conv
                    # output's difference moves it by (|gamma * invstd *
                    # dconv|)
                    moved = (gamma * want[3]).abs() * (
                        got[0].float() - want[0].float()).abs()
                    for key, a, b, extra in (
                            ("conv_out", got[0], want[0], 0.0),
                            ("out", outs[0], outs[1], moved)):
                        a, b = a.float(), b.float()
                        err = (a - b).abs()
                        rec[key + "_max_abs_err"] = err.max().item()
                        lim = bf16_ulp(torch.maximum(a.abs(), b.abs())) \
                            + extra + TRAIN_FP32_REL * b.abs().max()
                        if not bool((err <= lim).all()):
                            bad.append(key)
                else:
                    for key, a, b in (("conv_out", got[0], want[0]),
                                      ("out", outs[0], outs[1])):
                        rec[key + "_max_abs_err"], good = close_rel(
                            a, b, TRAIN_FP32_REL)
                        if not good:
                            bad.append(key)
                for key, i in (("mean", 1), ("var", 2)):
                    rec[key + "_max_abs_err"], good = close_rel(
                        got[i], want[i], TRAIN_FP32_REL)
                    if not good:
                        bad.append(key)
                # #6 on the same (plain) saved tensors: the variant the plan
                # picks, two launches bit-equal
                conv, mean, _, invstd = want
                kb, bwd_variant = launched_variant(lambda: cbr_train_bwd(
                    conv, dy, mean, invstd, gamma, beta, res))
                kb2 = cbr_train_bwd(conv, dy, mean, invstd, gamma, beta, res)
                pb = _ref_cbr_train_bwd(conv, dy, mean, invstd, gamma, beta,
                                        res)
                torch.cuda.synchronize()
                rec["cbr_train_bwd_variant"] = bwd_variant
                if bwd_variant != ["cbr_train_bwd/" + cbr_bwd_plan(Co)]:
                    bad.append("cbr_train_bwd variant %s" % bwd_variant)
                if not all(torch.equal(a, b) for a, b in zip(kb, kb2)
                           if a is not None):
                    bad.append("cbr_train_bwd differs between launches")
                del kb2
                for key, a, b in zip(("dconv", "dgamma", "dbeta"), kb, pb):
                    rec[key + "_max_abs_err"], good = close_rel(
                        a, b, TRAIN_FP32_REL)
                    rec[key + "_max_abs"] = b.abs().max().item()
                    if not (good and bool(torch.isfinite(a).all())):
                        bad.append(key)
                if res is not None:
                    rec["dres_equal"] = bool(torch.equal(kb[3], pb[3]))
                    if not rec["dres_equal"]:
                        bad.append("dres")
                # #6 in two calls around a cross-rank sum of its sums (the
                # data-mesh step at world > 1; main path 20's C1 leg), here
                # with the identity for that sum: bit-equal to the split
                # variant's one call, so within the bound above too
                split = "split_v8" if Co % 8 == 0 else "split_v1"
                kg, g_variant = launched_variant(
                    lambda: cbr_train_bwd_global(conv, dy, mean, invstd,
                                                 gamma, beta, res,
                                                 torch.clone, M))
                ks = _launch_cbr_bwd(split, conv, dy, mean, invstd, gamma,
                                     beta, res)
                torch.cuda.synchronize()
                rec["global_variant"] = g_variant
                rec["global_bit_equal_split"] = all(
                    torch.equal(a, b) for a, b in zip(kg, ks)
                    if a is not None)
                if g_variant != ["cbr_train_bwd/%s+global" % split] \
                        or not rec["global_bit_equal_split"]:
                    bad.append("cbr_train_bwd_global")
                for key, a, b in zip(("dconv", "dgamma", "dbeta"), kg, pb):
                    if not close_rel(a, b, TRAIN_FP32_REL)[1]:
                        bad.append("global " + key)
                del kg, ks
                rec["out_of_bound"] = bad
                if timed:
                    works = cbr_train_works(N, H, W, C, Co, res is not None,
                                            dtype)
                    rec["ms"] = {
                        "conv_bn_stats": time_ms(
                            lambda: conv_bn_stats(x, w)),
                        "cbr_train_bwd": time_ms(lambda: cbr_train_bwd(
                            conv, dy, mean, invstd, gamma, beta, res))}
                    # #6's own device time; and the three-launch variant
                    # that vectorizes without holding rows on chip
                    rec["device_ms"] = {"cbr_train_bwd": device_ms(
                        lambda: cbr_train_bwd(conv, dy, mean, invstd, gamma,
                                              beta, res))}
                    if dtype == torch.bfloat16 and res is None \
                            and per_step:
                        rec["split_v8_device_ms"] = device_ms(
                            lambda: _launch_cbr_bwd("split_v8", conv, dy,
                                                    mean, invstd, gamma,
                                                    beta, res))
                    rec["plain_ms"] = {
                        "conv_bn_stats": time_ms(
                            lambda: _ref_conv_bn_stats(x, w), iters=5),
                        "cbr_train_bwd": time_ms(
                            lambda: _ref_cbr_train_bwd(
                                conv, dy, mean, invstd, gamma, beta, res),
                            iters=5)}
                    rec["library_ms"] = {"conv_bn_stats": lib_ms,
                                         "cbr_train_bwd": None}
                    rec["bound"] = {k: bound(*works[k], dtype)
                                    for k in names}
                    if dtype == torch.bfloat16 and res is None \
                            and per_step:
                        errs = {"conv_bn_stats": max(
                            rec["mean_max_abs_err"], rec["var_max_abs_err"],
                            rec["out_max_abs_err"]),
                            "cbr_train_bwd": max(
                                rec["dconv_max_abs_err"],
                                rec["dgamma_max_abs_err"],
                                rec["dbeta_max_abs_err"])}
                        weighted["cbr_train_bwd"]["device_ms"] += \
                            per_step * rec["device_ms"]["cbr_train_bwd"] / 16
                        for k in names:
                            acc = weighted[k]
                            acc["ms"] += per_step * rec["ms"][k] / 16
                            acc["plain_ms"] += \
                                per_step * rec["plain_ms"][k] / 16
                            if rec["library_ms"][k] is not None:
                                acc["library_ms"] += \
                                    per_step * rec["library_ms"][k] / 16
                            acc["flops"] += per_step * works[k][0] / 16
                            acc["bytes"] += per_step * works[k][1] / 16
                            acc["max_abs_err"] = max(acc["max_abs_err"],
                                                     errs[k])
                        rec["dxdw_fp32_ms"] = time_ms(
                            lambda: _conv3x3_backward(x, w, pb[0]), iters=5)
                        dxdw["ms"] += per_step * rec["dxdw_fp32_ms"]
                        dxdw["flops"] += per_step * 2 * 2.0 * N * H * W \
                            * 9 * C * Co
                emit(rec)
                if name.startswith("ssd512"):
                    SSD_CHECKED_VARIANTS.update(variant + bwd_variant)
                check(not bad, "kernel_cbr_train",
                      "conv_bn_stats/cbr_train_bwd disagree with their plain "
                      "versions at %s %s residual=%s: %s"
                      % (name, dtype, res is not None, bad))
    emit({"phase": "kernel_cbr_train", "dxdw_fp32_ms_per_step": dxdw["ms"],
          "dxdw_flops_per_step": dxdw["flops"],
          "dxdw_bound_ms_per_step": dxdw["flops"] / PEAK_FLOPS[
              torch.float32] * 1e3})
    out = {}
    for k in names:
        acc = weighted[k]
        bms, by = bound(acc["flops"], acc["bytes"], torch.bfloat16)
        out[k] = {"max_abs_err": acc["max_abs_err"], "ms": acc["ms"],
                  "plain_ms": acc["plain_ms"],
                  "library_ms": acc["library_ms"], "bound_ms": bms,
                  "bound_by": by}
    out["cbr_train_bwd"]["device_ms"] = weighted["cbr_train_bwd"][
        "device_ms"]
    return out


def opt_inputs(kind, n, wdt, gdt, sdt, mp, vec, gen):
    """Seeded inputs of one flat update: weights N(0, 1), gradients N(0,
    1), momentum and Adam's mean N(0, 0.1^2), Adam's var made from squared
    gradients (as training makes it), lr/wd per element when `vec`."""
    def rnd(scale=1.0):
        return torch.randn(n, generator=gen, device="cuda") * scale
    w = rnd().to(wdt)
    t = {"w": w, "g": rnd().to(gdt),
         "master": w.float().clone() if mp else None}
    if kind == "sgd":
        t["mom"] = rnd(0.1).to(sdt)
    else:
        t["mean"] = rnd(0.1).to(sdt)
        t["var"] = (0.1 * rnd() ** 2 + 0.9 * rnd() ** 2).to(sdt)
    if vec:
        t["lr"] = torch.rand(n, generator=gen, device="cuda") * 0.1
        t["wd"] = torch.rand(n, generator=gen, device="cuda") * 1e-3
    else:
        t["lr"], t["wd"] = 0.05, 1e-4
    return t


def run_flat(kind, fn, t, mom_on, clip_on, mp):
    """One update by `fn` (the kernel wrapper or the plain version):
    returns the outputs (weight, states, master)."""
    if kind == "sgd":
        out = fn(t["w"], t["g"], t["mom"], t["master"], t["lr"], t["wd"],
                 0.9, 1.0 / 256, 0.5, mom_on, clip_on, mp)
        return [out[0]] + ([out[1]] if mom_on else []) + \
            ([out[2]] if mp else [])
    out = fn(t["w"], t["g"], t["mean"], t["var"], t["master"], t["lr"],
             t["wd"], 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 1.0 / 256,
             0.5, clip_on, mp)
    return list(out[:3]) + ([out[3]] if mp else [])


def clone_inputs(t):
    return {k: (v.clone() if torch.is_tensor(v) else v) for k, v in t.items()}


def opt_bytes(t, kind, mom_on, mp):
    """Bytes one update must move: w, g (and state, master) read, w (and
    state, master) written, lr/wd vectors read."""
    def nb(x):
        return x.numel() * x.element_size() if torch.is_tensor(x) else 0
    states = ([t["mom"]] if mom_on else []) if kind == "sgd" \
        else [t["mean"], t["var"]]
    rw = [t["w"]] + states + ([t["master"]] if mp else [])
    return 2 * sum(nb(x) for x in rw) + nb(t["g"]) + nb(t["lr"]) \
        + nb(t["wd"])


def resnet50_param_shapes():
    """(shape, dtype) of every trainable parameter of resnet50_v1 NHWC
    with the fused gate, cast to bf16 (BN parameters stay fp32)."""
    import mxnet_tpu_torch as mx
    net = resnet50(True)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 32, 32, 3), ctx=mx.cpu()))
    net.cast("bfloat16")
    return [(p.shape, p.data().data_torch.dtype)
            for p in net.collect_params().values() if p.grad_req != "null"]


def multi_list(kind, specs, gen, offset_at=()):
    """Seeded tensors of one multi-tensor update: per (n, weight dtype,
    gradient dtype) a dict as opt_inputs makes it (states in the weight's
    dtype, an fp32 master beside every weight), with lr and wd of its own.
    A tensor whose index is in
    `offset_at` is a view one element into a larger buffer: off 16
    bytes."""
    out = []
    for j, (n, wdt, gdt) in enumerate(specs):
        t = opt_inputs(kind, n + 1, wdt, gdt, wdt, True, False, gen)
        cut = (lambda x: x[1:]) if j in offset_at else (lambda x: x[:n])
        t = {k: cut(v) if torch.is_tensor(v) else v for k, v in t.items()}
        t["lr"], t["wd"] = 0.01 * (1 + j % 5), 1e-4 * (j % 3)
        out.append(t)
    return out


def run_multi(kind, ts, mom_on, clip_on, mp):
    """One multi_sgd / multi_adam call over the list `ts` (opt_inputs
    dicts), with opt_inputs' per-tensor scalar lr/wd."""
    from mxnet_tpu_torch.ops.fused_optimizer import multi_adam, multi_sgd
    ws, gs = [t["w"] for t in ts], [t["g"] for t in ts]
    masters = [t["master"] for t in ts]
    lrs = [t["lr"] for t in ts]
    wds = [t["wd"] for t in ts]
    if kind == "sgd":
        multi_sgd(ws, gs, [t["mom"] for t in ts], masters, lrs, wds, 0.9,
                  1.0 / 256, 0.5, mom_on, clip_on, mp)
    else:
        multi_adam(ws, gs, [t["mean"] for t in ts], [t["var"] for t in ts],
                   masters, lrs, wds, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999,
                   1e-8, 1.0 / 256, 0.5, clip_on, mp)


def outputs(kind, t, mom_on, mp):
    keys = ["w"] + ((["mom"] if mom_on else []) if kind == "sgd"
                    else ["mean", "var"]) + (["master"] if mp else [])
    return [t[k] for k in keys]


def fused_library(kind, ts):
    """torch._fused_sgd_ / torch._fused_adam_ over the tensors of `ts`,
    one call per dtype (they take one dtype a list). Another function:
    SGD's lr outside the momentum and no clip; Adam's sqrt(v / bc2)."""
    groups = {}
    for t in ts:
        groups.setdefault(t["w"].dtype, []).append(t)
    calls = []
    for dt, grp in groups.items():
        ws, gs = [t["w"] for t in grp], [t["g"] for t in grp]
        if kind == "sgd":
            moms = [t["mom"] for t in grp]
            calls.append(lambda ws=ws, gs=gs, moms=moms: torch._fused_sgd_(
                ws, gs, moms, weight_decay=1e-4, momentum=0.9, lr=0.05,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
        else:
            means, vs = [t["mean"] for t in grp], [t["var"] for t in grp]
            steps = [torch.ones((), device="cuda") for _ in grp]
            calls.append(lambda ws=ws, gs=gs, means=means, vs=vs,
                         steps=steps: torch._fused_adam_(
                             ws, gs, means, vs, [], steps, lr=1e-3,
                             beta1=0.9, beta2=0.999, weight_decay=1e-4,
                             eps=1e-8, amsgrad=False, maximize=False))
    return lambda: [c() for c in calls]


def rnn_sgd_lists():
    """The #7 calls of paths 13 and 14, at their shapes (fp32, no momentum,
    no master): label -> (parameter shapes, lr, wd of the weights (biases
    take none), rescale, clip or None, multi). Path 13's Trainer hands
    WordLM's 11 parameters to one `multi` launch (the example's lr 1.0 and
    clip 0.25); path 14's Updater sends the bucketing model's 11 to one
    `single` launch each (lr 0.01, wd 1e-5, rescale 1/batch). The paths
    check that their parameters have these shapes."""
    def lstm(inp, hid, layers):
        out = []
        for i in range(layers):
            out += [(4 * hid, inp if i == 0 else hid), (4 * hid, hid),
                    (4 * hid,), (4 * hid,)]
        return out
    lm = [(LM_VOCAB, LM_EMB)] + lstm(LM_EMB, LM_HID, LM_LAYERS) \
        + [(LM_VOCAB, LM_HID), (LM_VOCAB,)]
    bk = [(BK_VOCAB, BK_EMB)] + lstm(BK_EMB, BK_HID, BK_LAYERS) \
        + [(BK_VOCAB, BK_HID), (BK_VOCAB,)]
    return {"gluon_word_lm": (lm, 1.0, 0.0, 1.0, 0.25, True),
            "module_lstm_bucketing": (bk, BK_SGD["learning_rate"],
                                      BK_SGD["wd"], 1.0 / BK_BATCH, None,
                                      False)}


def same_shapes(shapes, want):
    return sorted(tuple(s) for s in shapes) == sorted(want)


def rnn_sgd_calls():
    """rnn_sgd_lists as kernel_opt_paths takes them: fp32 tensors, no
    momentum."""
    out = {}
    for label, (shapes, lr, wd, rescale, clip, multi) in \
            rnn_sgd_lists().items():
        params = [(s, torch.float32, lr, wd if len(s) == 2 else 0.0)
                  for s in shapes]
        out[label] = (params, None, rescale, clip, multi)
    return out


def multi_launches(kernel, n):
    """Launches one multi call of #7 or #8 over n tensors makes: one per
    table of the kernel's capacity (read from the built library)."""
    from mxnet_tpu_torch.ops.fused_optimizer import _capacity
    return -(-n // _capacity[kernel])


def kernel_opt_paths(gen, calls):
    """#7 at main paths' own calls: label -> (params, momentum or None,
    rescale, clip or None, multi), params a list of (shape, dtype, lr, wd)
    (rnn_sgd_calls: path 13's one multi launch over WordLM's 11 tensors
    and path 14's 11 single launches; trainer_sgd_call: path 15's one multi
    launch over SSD-512's bf16 table with momentum; path 16's over
    Inception-v3's fp32 table). Gradients and momenta
    in the weight's dtype, as the Trainer keeps them. Every weight and
    momentum bit-equal (0 ulps) to the plain version's, the launches
    counted; then each call timed (events and device time) beside its
    bound."""
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    from mxnet_tpu_torch.ops.fused_optimizer import (_ref_flat_sgd, flat_sgd,
                                                     multi_sgd)
    recs = {}
    for label, (params, momentum, rescale, clip, multi) in calls.items():
        def rnd(s, dt, scale):
            return (torch.randn(s, generator=gen, device="cuda")
                    * scale).to(dt)
        ws = [rnd(s, dt, 0.05) for s, dt, _, _ in params]
        gs = [rnd(s, dt, 0.5) for s, dt, _, _ in params]
        mom_on = momentum is not None
        moms = [rnd(s, dt, 0.01) for s, dt, _, _ in params] if mom_on \
            else [None] * len(params)
        lrs, wds = [p[2] for p in params], [p[3] for p in params]
        momentum = momentum if mom_on else 0.0
        clip_on = clip is not None
        clip = clip if clip_on else 0.0

        def update(ws=ws, gs=gs, moms=moms, lrs=lrs, wds=wds,
                   momentum=momentum, mom_on=mom_on, rescale=rescale,
                   clip=clip, clip_on=clip_on, multi=multi):
            if multi:
                multi_sgd(ws, gs, moms if mom_on else [], None, lrs, wds,
                          momentum, rescale, clip, mom_on, clip_on, False)
            else:
                for w, g, m, lr, d in zip(ws, gs, moms, lrs, wds):
                    flat_sgd(w, g, m, None, lr, d, momentum, rescale, clip,
                             mom_on, clip_on, False)

        def plain():
            return [_ref_flat_sgd(w, g, m, None, lr, d, momentum, rescale,
                                  clip, mom_on, clip_on, False)
                    for w, g, m, lr, d in zip(ws, gs, moms, lrs, wds)]
        want = plain()
        reset_launch_counts()
        update()
        seen = variant_counts()
        torch.cuda.synchronize()
        ulps = max(ulps_apart(w, ref[0]).max().item()
                   for w, ref in zip(ws, want))
        if mom_on:
            ulps = max([ulps] + [ulps_apart(m, ref[1]).max().item()
                                 for m, ref in zip(moms, want)])
        expect = {("flat_sgd", "multi"): multi_launches("flat_sgd",
                                                        len(ws))} if multi \
            else {("flat_sgd", "single"): len(ws)}
        n = sum(w.numel() for w in ws)
        # w and the momentum read and written, g read
        nbytes = sum(w.numel() * w.element_size() * (5 if mom_on else 3)
                     for w in ws)
        rec = {"phase": "kernel_opt", "kernel": "flat_sgd", "path": label,
               "tensors": len(ws), "elements": n,
               "dtypes": sorted({str(w.dtype)[6:] for w in ws}),
               "momentum": momentum, "rescale": rescale,
               "largest": max(w.numel() for w in ws), "max_ulps": ulps,
               "variants": {"%s/%s" % k: c for k, c in seen.items()},
               "ms": time_ms(update, iters=20),
               "device_ms": device_ms(update),
               "plain_ms": time_ms(plain, iters=5)}
        rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes, torch.float32)
        emit(rec)
        check(ulps == 0 and seen == expect, "kernel_opt",
              "%s's #7 calls: %s ulps from the plain version, launches %s "
              "(expected %s)" % (label, ulps, seen, expect))
        recs[label] = rec
        del ws, gs, moms, want
    return recs


def phase_kernel_opt(gen):
    """flat_sgd (#7) and flat_adam (#8) on the card. One-tensor launches
    against their plain versions: momentum on/off, clip on/off, mp on/off,
    scalar and per-element lr/wd, fp32 and bf16 weights (and a bf16
    gradient with an fp32 weight), n = 1, 7, 4097; fp32 and bf16 outputs
    must be bit-equal to the plain version's (a difference of 1 ulp is
    allowed and printed with its count). Multi-tensor launches (the
    aggregated route) over every flag combination, on a mixed list (n = 1,
    7, 4097 with fp32/bf16 weights and gradients, one tensor off 16-byte
    alignment, and one ResNet-50 step's 193 tensors: bf16 weights beside
    fp32 BatchNorm vectors) and on a list longer than one launch holds:
    every output bit-equal (0 ulps) to the one-tensor launches' and to the
    plain version's, and the launches counted. Then times: one ResNet-50
    step's 193 tensors in one multi-tensor call (by events and by device
    time; the kernels-line entry), beside the one-launch-per-tensor loop,
    torch._fused_sgd_ / _fused_adam_ (another function: context only) and
    the bound; and one launch over 25.6M elements (ResNet-50's parameter
    count) at fp32 and bf16. Last, the recurrent paths' own calls
    (kernel_opt_paths)."""
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    from mxnet_tpu_torch.ops._build import library
    from mxnet_tpu_torch.ops.fused_optimizer import (_ref_flat_adam,
                                                     _ref_flat_sgd, flat_adam,
                                                     flat_sgd)
    fns = {"sgd": (flat_sgd, _ref_flat_sgd),
           "adam": (flat_adam, _ref_flat_adam)}
    f32, b16 = torch.float32, torch.bfloat16
    worst = {"flat_sgd": 0, "flat_adam": 0}
    ulp_cases = []
    n_cases = 0
    for kind in ("sgd", "adam"):
        kernel, plain = fns[kind]
        for mom_on in ((True, False) if kind == "sgd" else (True,)):
            for clip_on in (True, False):
                for mp in (False, True):
                    for vec in (False, True):
                        for wdt, gdt in ((f32, f32), (b16, b16), (f32, b16)):
                            for n in (1, 7, 4097):
                                t = opt_inputs(kind, n, wdt, gdt, wdt, mp,
                                               vec, gen)
                                k = run_flat(kind, kernel, clone_inputs(t),
                                             mom_on, clip_on, mp)
                                p = run_flat(kind, plain, t, mom_on,
                                             clip_on, mp)
                                torch.cuda.synchronize()
                                n_cases += 1
                                for i, (a, b) in enumerate(zip(k, p)):
                                    d = ulps_apart(a, b)
                                    m = d.max().item()
                                    worst["flat_" + kind] = max(
                                        worst["flat_" + kind], m)
                                    if m:
                                        ulp_cases.append(
                                            [kind, mom_on, clip_on, mp, vec,
                                             str(wdt)[6:], str(gdt)[6:], n,
                                             i, m, int((d > 0).sum())])
    emit({"phase": "kernel_opt", "cases": n_cases,
          "max_ulps": worst, "cases_with_ulp_differences": ulp_cases})
    check(max(worst.values()) <= 1, "kernel_opt",
          "flat kernels differ from their plain versions by more than 1 ulp: "
          "%s" % ulp_cases)

    # multi-tensor launches: 0 ulps against the one-tensor launches and
    # the plain version
    shapes = resnet50_param_shapes()
    cap = library("flat_sgd").mx_multi_capacity()
    small = [(1, b16, b16), (7, f32, f32), (4097, b16, b16), (7, f32, b16),
             (4097, f32, f32), (1, f32, b16)]
    mixed = small + [(int(np.prod(s)), dt, dt) for s, dt in shapes]
    long_list = [((1, 7, 4097, 64)[j % 4], (b16, f32)[j % 2],
                  (b16, f32)[j % 2]) for j in range(cap + 7)]
    lists = {"mixed_%d" % len(mixed): (mixed, (2,)),
             "longer_than_capacity_%d" % len(long_list): (long_list, (5,))}
    multi_cases, multi_fail = [], []
    for kind in ("sgd", "adam"):
        kernel, plain = fns[kind]
        for mom_on in ((True, False) if kind == "sgd" else (True,)):
            for clip_on in (True, False):
                for mp in (False, True):
                    for label, (specs, offset) in lists.items():
                        ts = multi_list(kind, specs, gen, offset)
                        single = [clone_inputs(t) for t in ts]
                        ref = [clone_inputs(t) for t in ts]
                        reset_launch_counts()
                        run_multi(kind, ts, mom_on, clip_on, mp)
                        seen = variant_counts()
                        want = {("flat_" + kind, "multi"):
                                -(-len(specs) // cap)}
                        diff = 0
                        for t, s1, r in zip(ts, single, ref):
                            got = outputs(kind, t, mom_on, mp)
                            one = run_flat(kind, kernel, s1, mom_on,
                                           clip_on, mp)
                            pl = run_flat(kind, plain, r, mom_on, clip_on,
                                          mp)
                            for a, b, c in zip(got, one, pl):
                                diff = max(diff, ulps_apart(a, b).max()
                                           .item(), ulps_apart(a, c).max()
                                           .item())
                        torch.cuda.synchronize()
                        case = [kind, mom_on, clip_on, mp, label, diff,
                                seen.get(("flat_" + kind, "multi"), 0)]
                        multi_cases.append(case)
                        if diff or seen != want:
                            multi_fail.append(case + [str(want)])
    emit({"phase": "kernel_opt", "multi_capacity": cap,
          "multi_cases": len(multi_cases),
          "multi_max_ulps": max(c[5] for c in multi_cases),
          "multi_launches": {c[4]: c[6] for c in multi_cases}})
    check(not multi_fail, "kernel_opt",
          "multi-tensor launches differ from the one-tensor launches or the "
          "plain version, or launched otherwise than expected "
          "([kind, momentum, clip, mp, list, max ulps, launches, "
          "expected]): %s" % multi_fail)

    entries = {}
    for kind, name in (("sgd", "flat_sgd"), ("adam", "flat_adam")):
        kernel, plain = fns[kind]
        for wdt in (b16, f32):
            n = 25_600_000
            t = opt_inputs(kind, n, wdt, wdt, wdt, False, False, gen)
            kt = clone_inputs(t)
            nbytes = opt_bytes(t, kind, True, False)

            def one():
                run_flat(kind, kernel, kt, True, False, False)
            rec = {"phase": "kernel_opt", "kernel": name, "n": n,
                   "dtype": str(wdt)[6:], "variant": "single",
                   "ms": time_ms(one), "device_ms": device_ms(one),
                   "plain_ms": time_ms(lambda: run_flat(
                       kind, plain, t, True, False, False), iters=10),
                   "library_ms": None}
            rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes, f32)
            emit(rec)
            del t, kt
        # one ResNet-50 step: all 193 tensors in one multi-tensor call,
        # bf16 conv/dense weights and fp32 BN parameters, states in the
        # weight's dtype
        params = [opt_inputs(kind, int(np.prod(shape)), dt, dt, dt, False,
                             False, gen) for shape, dt in shapes]
        kparams = [clone_inputs(t) for t in params]
        nbytes = sum(opt_bytes(t, kind, True, False) for t in params)
        err = 0.0
        multi = [clone_inputs(t) for t in kparams]
        run_multi(kind, multi, True, False, False)
        for mt, t in zip(multi, params):
            for a, b in zip(outputs(kind, mt, True, False),
                            run_flat(kind, plain, clone_inputs(t), True,
                                     False, False)):
                err = max(err, (a.float() - b.float()).abs().max().item())
        del multi

        def step():
            run_multi(kind, kparams, True, False, False)

        def loop():
            for kt in kparams:
                run_flat(kind, kernel, kt, True, False, False)
        lib = fused_library(kind, kparams)
        rec = {"phase": "kernel_opt", "kernel": name, "variant": "multi",
               "resnet50_step_params": len(shapes),
               "elements": sum(int(np.prod(s)) for s, _ in shapes),
               "max_abs_err": err, "ms": time_ms(step, iters=20),
               "device_ms": device_ms(step),
               "per_tensor_loop_ms": time_ms(loop, iters=5),
               "per_tensor_loop_device_ms": device_ms(loop, calls=5),
               "plain_ms": time_ms(lambda: [run_flat(kind, plain, t, True,
                                                     False, False)
                                            for t in params], iters=3),
               "library_ms": None,
               "another_function": "torch._fused_%s_" % kind,
               "another_function_ms": time_ms(lib, iters=20),
               "another_function_device_ms": device_ms(lib)}
        rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes, f32)
        emit(rec)
        entries[name] = {k: rec[k] for k in ("max_abs_err", "ms",
                                             "device_ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bound_by")}
        del params, kparams
    kernel_opt_paths(gen, rnn_sgd_calls())
    return entries


def check_path(launches, expected, phase):
    """Every kernel of the path launched, and no other."""
    check(all((launches[k] > 0) == (k in expected) for k in launches),
          phase, "kernels of the path %s, launched: %s"
          % (list(expected), launches))


def train_net(seed, ctx, image=RESNET_IMAGE, dtype="bfloat16"):
    """resnet50_v1 NHWC with the fused gate: Xavier (gaussian) weights from
    mx.random.seed(seed), shapes resolved by one predict-mode pass, cast
    to `dtype` (BatchNorm stays fp32) and hybridized."""
    import mxnet_tpu_torch as mx
    net = resnet50(True)
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, image, image, 3), ctx=ctx))
    net.cast(dtype)
    net.hybridize(static_alloc=True)
    return net


def train_batch(batch, image, ctx, dtype="bfloat16", seed=0):
    """One fixed batch from numpy with a seed: N(0, 1) images, uniform
    labels over the 1000 classes."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    y = rng.randint(0, 1000, batch).astype(np.float32)
    return mx.nd.array(x, ctx=ctx, dtype=dtype), mx.nd.array(y, ctx=ctx)


def snapshot(net):
    """{structural name: a copy of the parameter's tensor}."""
    return {k: p.data().data_torch.detach().clone()
            for k, p in net._collect_params_with_prefix().items()}


def n_trainable(net):
    return sum(p.grad_req != "null" for p in net.collect_params().values())


def imperative_step(mx, net, loss_fn, trainer, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_resnet_train(gen, tmp, batch=TRAIN_BATCH, image=RESNET_IMAGE,
                       steps=TRAIN_STEPS, adam_batch=ADAM_BATCH,
                       cpu_batch=CPU_BATCH):
    """Main path 4 with cuDNN held to its deterministic algorithms (see
    resnet_train_checks); resnet_train_throughput times the default ones."""
    torch.backends.cudnn.deterministic = True
    try:
        return resnet_train_checks(gen, tmp, batch, image, steps,
                                   adam_batch, cpu_batch)
    finally:
        torch.backends.cudnn.deterministic = False


def resnet_train_checks(gen, tmp, batch, image, steps, adam_batch,
                        cpu_batch):
    """Main path 4: bench.py's headline training configuration. resnet50_v1
    NHWC, fused gate, bf16 with fp32 BatchNorm, 224x224:
    FusedTrainStep(net, SoftmaxCrossEntropyLoss, Trainer("sgd", lr 0.1,
    momentum 0.9)) for `steps` steps on one seeded batch, counts reset just
    before and read just after; then the imperative loop (record ->
    backward -> trainer.step) with "adam" at lr 1e-3, 3 steps at
    `adam_batch`, counted likewise. Checks the launches per step, a finite
    and falling loss, the dtypes, moved running statistics, the two routes
    agreeing from one state, and one step against the same step on the
    CPU. cuDNN's default weight-gradient algorithms add in a varying order,
    so without the deterministic ones every weight after step 1, and with it
    the card-vs-CPU comparison's sample of rounding, changes from run to
    run. Returns (net, loss_fn, {kernel: launches on the path})."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    gpu = mx.gpu(0)
    net = train_net(0, gpu, image)
    n_train = n_trainable(net)
    dtypes = {k: t.dtype for k, t in snapshot(net).items()}
    stats0 = {k: t for k, t in snapshot(net).items() if "running" in k}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    step = mx.gluon.FusedTrainStep(net, loss_fn, trainer)
    x, y = train_batch(batch, image, gpu)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(x, y).asnumpy().item() for _ in range(steps)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    sgd_launches = launch_counts()
    sgd_variants = variant_counts()
    check_path(sgd_launches, RESNET_TRAIN_KERNELS, "main_path_resnet_train")
    check(wgmma_launches(sgd_variants, "conv_bn_stats") == 16 * steps,
          "resnet_train", "expected all %d conv_bn_stats launches of the "
          "FusedTrainStep steps on the wgmma variant, saw %s"
          % (16 * steps, sgd_variants))
    check(sgd_variants.get(("cbr_train_bwd", "persistent"), 0)
          == 16 * steps, "resnet_train", "expected all %d cbr_train_bwd "
          "launches of the FusedTrainStep steps on the persistent variant, "
          "saw %s" % (16 * steps, sgd_variants))
    want = {"conv_bn_stats": 16 * steps, "cbr_train_bwd": 16 * steps,
            "flat_sgd": steps, "conv_bn_relu": 0, "flat_adam": 0}
    check(all(sgd_launches[k] == v for k, v in want.items())
          and sgd_variants.get(("flat_sgd", "multi"), 0) == steps,
          "resnet_train", "FusedTrainStep launches %s (%s), expected %s, "
          "every flat_sgd launch multi-tensor: one a step over all %d "
          "parameters" % (sgd_launches, sgd_variants, want, n_train))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "resnet_train", "loss not finite or not falling: %s" % losses)
    after = snapshot(net)
    check(all(after[k].dtype == dt for k, dt in dtypes.items()),
          "resnet_train", "a parameter changed its dtype")
    moved = sum(not torch.equal(after[k], v) for k, v in stats0.items())
    check(moved == len(stats0), "resnet_train",
          "%d of %d running statistics moved" % (moved, len(stats0)))

    # the two routes from one state, 2 SGD steps each (cuDNN deterministic,
    # so that only the route differs)
    path = os.path.join(tmp, "resnet50_train.params")
    net.save_parameters(path)
    xs, ys = train_batch(adam_batch, image, gpu, seed=1)
    routes, route_launches = [], {}
    for fused in (True, False):
        rnet = resnet50(True)
        rnet.cast("bfloat16")
        rnet.load_parameters(path, ctx=gpu)
        rtr = mx.gluon.Trainer(rnet.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        rstep = mx.gluon.FusedTrainStep(rnet, loss_fn, rtr)
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(2):
            if fused:
                rstep(xs, ys)
            else:
                imperative_step(mx, rnet, loss_fn, rtr, xs, ys)
        torch.cuda.synchronize()
        route = "fused_step" if fused else "imperative"
        route_launches[route] = {
            "flat_sgd": launch_counts()["flat_sgd"],
            "multi": variant_counts().get(("flat_sgd", "multi"), 0)}
        routes.append(snapshot(rnet))
        del rnet, rtr, rstep
    check(all(v == {"flat_sgd": 2, "multi": 2}
              for v in route_launches.values()), "resnet_train",
          "route comparison: flat_sgd launches %s, expected one "
          "multi-tensor launch a step on each route" % route_launches)
    route_diff = max((a.float() - routes[1][k].float()).abs().max().item()
                     for k, a in routes[0].items())
    route_equal = all(torch.equal(a, routes[1][k])
                      for k, a in routes[0].items())
    check(route_equal, "resnet_train",
          "FusedTrainStep and the imperative loop differ by %g" % route_diff)

    # the imperative loop with Adam, counted
    atrainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    torch.cuda.synchronize()
    reset_launch_counts()
    adam_losses, adam_ms = [], []
    for _ in range(ADAM_STEPS):
        t0 = time.perf_counter()
        adam_losses.append(imperative_step(mx, net, loss_fn, atrainer, xs,
                                           ys).asnumpy().mean().item())
        adam_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    adam_launches = launch_counts()
    adam_variants = variant_counts()
    check_path(adam_launches, RESNET_ADAM_KERNELS, "main_path_resnet_adam")
    check(wgmma_launches(adam_variants, "conv_bn_stats") == 16 * ADAM_STEPS,
          "resnet_train", "expected all %d conv_bn_stats launches of the "
          "Adam loop on the wgmma variant, saw %s"
          % (16 * ADAM_STEPS, adam_variants))
    check(adam_variants.get(("cbr_train_bwd", "persistent"), 0)
          == 16 * ADAM_STEPS, "resnet_train", "expected all %d cbr_train_bwd "
          "launches of the Adam loop on the persistent variant, saw %s"
          % (16 * ADAM_STEPS, adam_variants))
    want = {"conv_bn_stats": 16 * ADAM_STEPS,
            "cbr_train_bwd": 16 * ADAM_STEPS,
            "flat_adam": ADAM_STEPS, "flat_sgd": 0, "conv_bn_relu": 0}
    check(n_train >= 2 and all(adam_launches[k] == v
                               for k, v in want.items())
          and adam_variants.get(("flat_adam", "multi"), 0) == ADAM_STEPS,
          "resnet_train", "Adam loop launches %s (%s), expected %s, every "
          "flat_adam launch multi-tensor: one a step over all %d "
          "parameters" % (adam_launches, adam_variants, want, n_train))
    check(all(np.isfinite(adam_losses)), "resnet_train",
          "Adam loss not finite: %s" % adam_losses)
    del atrainer

    # one step on the card against the same step on the CPU (plain
    # paths): the gradients of every leaf, fp32 and bf16
    net.save_parameters(path)
    xc, yc = train_batch(cpu_batch, image, mx.cpu(), "float32", seed=2)

    def grads_of(ctx, dtype, x=xc):
        cnet = resnet50(True)
        cnet.load_parameters(path, ctx=ctx, cast_dtype=True)
        cnet.cast(dtype)
        with mx.autograd.record():
            loss = loss_fn(cnet(x.astype(dtype).as_in_context(ctx)),
                           yc.as_in_context(ctx))
        loss.backward()
        return {k: p.grad().data_torch.float().cpu()
                for k, p in cnet._collect_params_with_prefix().items()
                if p.grad_req != "null"}

    card = {dt: grads_of(gpu, dt) for dt in ("float32", "bfloat16")}
    host = {dt: grads_of(mx.cpu(), dt) for dt in ("float32", "bfloat16")}
    # the card at fp32 with every input moved by one ulp: how far rounding
    # alone moves a leaf. A ReLU or max-pool input within rounding of its
    # threshold flips, and in a channel of M = N*H*W pixels one flipped term
    # moves a BatchNorm beta or gamma gradient by about 1/sqrt(M) of itself
    nudged = grads_of(gpu, "float32", mx.nd.array(torch.nextafter(
        xc.data_torch, torch.tensor(float("inf"))), ctx=mx.cpu()))
    # every conv bias of ResNetV1 feeds a batch-statistics BatchNorm, so
    # its gradient is zero in exact arithmetic (the batch mean takes the
    # bias out) and the computed one is rounding noise on both sides: those
    # leaves are held apart, to be small against the median leaf
    null = {k for k in host["float32"] if k.endswith(".bias")
            and not k.startswith("output.")}
    med_norm = statistics.median(g.norm().item()
                                 for g in host["float32"].values())

    def leaf_stats(a, b):
        errs = {k: rel_err(g, b[k]) for k, g in a.items() if k not in null}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:5])}

    vs_cpu, failures = {}, []
    for dtype, limit in (("float32", GRAD_FP32_REL),
                         ("bfloat16", GRAD_BF16_REL)):
        noise = max(max(card[dtype][k].norm().item(),
                        host[dtype][k].norm().item())
                    for k in null) / med_norm if null else 0.0
        rec = {"card_vs_cpu": leaf_stats(card[dtype], host[dtype]),
               "limit": limit, "zero_gradient_leaves": len(null),
               "their_max_norm_over_median": noise}
        if dtype == "float32":
            # the CPU differs from the card by rounding only: held to the
            # limit, or to twice the card's own one-ulp spread where that
            # is larger (median and worst leaf alike)
            rec["one_ulp_input"] = leaf_stats(card[dtype], nudged)
            held, yard = rec["card_vs_cpu"], rec["one_ulp_input"]
        else:
            # bf16 against the fp32 step on the CPU (the reference here):
            # the card's bf16 path must be no further from it than the
            # CPU's plain bf16 path is, within 1.5x (median) and 2x (worst
            # leaf), or within the limit
            rec["card_vs_cpu_fp32"] = leaf_stats(card[dtype], host["float32"])
            rec["cpu_vs_cpu_fp32"] = leaf_stats(host[dtype], host["float32"])
            held, yard = rec["card_vs_cpu_fp32"], rec["cpu_vs_cpu_fp32"]
        factor = {"float32": (2.0, 2.0), "bfloat16": (1.5, 2.0)}[dtype]
        rec["median_limit"] = max(limit, factor[0] * yard["median"])
        rec["max_limit"] = max(limit, factor[1] * yard["max"])
        vs_cpu[dtype] = rec
        if noise > limit:
            failures.append("%s: conv biases before BatchNorm have gradients "
                            "of %.3g of the median leaf's (limit %g)"
                            % (dtype, noise, limit))
        if held["median"] > rec["median_limit"] \
                or held["max"] > rec["max_limit"]:
            failures.append("%s gradients: median %g (limit %g), worst %s "
                            "(limit %g)" % (dtype, held["median"],
                                            rec["median_limit"],
                                            held["worst_leaves"],
                                            rec["max_limit"]))
    emit({"phase": "resnet_train_vs_cpu", "batch": cpu_batch,
          "card_vs_cpu": vs_cpu})

    emit({"phase": "resnet_train", "config": "resnet50_v1 NHWC fused, bf16 "
          "(BatchNorm fp32), FusedTrainStep + sgd(lr 0.1, momentum 0.9)",
          "batch": batch, "image": image, "steps": steps,
          "trainable_params": n_train, "losses": losses,
          "steps_wall_s": wall_s, "launches": sgd_launches,
          "variants": {"%s/%s" % k: n for k, n in sgd_variants.items()},
          "running_stats_moved": moved,
          "routes_bit_equal": route_equal, "routes_max_abs_diff": route_diff,
          "route_launches": route_launches,
          "adam": {"batch": adam_batch, "steps": ADAM_STEPS,
                   "losses": adam_losses, "step_ms": adam_ms,
                   "launches": adam_launches,
                   "variants": {"%s/%s" % k: n
                                for k, n in adam_variants.items()}},
          "card_vs_cpu_batch": cpu_batch,
          "card_vs_cpu_max_leaf_rel_err": {
              k: v["card_vs_cpu"]["max"] for k, v in vs_cpu.items()}})
    check(not failures, "resnet_train", "; ".join(failures))
    paths = {k: sgd_launches[k] + adam_launches[k] for k in sgd_launches}
    return net, loss_fn, paths


def train_kernel_group(name):
    n = name.lower()
    if "cbr_wgmma_kernel<true" in n or "cbr_mma_kernel<true" in n \
            or "cbr_fma_kernel<true" in n or "stats_col_sum" in n:
        return "conv_bn_stats"
    if "cbr_bwd" in n or "bwd_col_sum" in n or "split_partial" in n \
            or "split_dconv" in n:
        return "cbr_train_bwd"
    if "flat_sgd" in n:
        return "flat_sgd"
    if "flat_adam" in n:
        return "flat_adam"
    if any(t in n for t in ("dgrad", "wgrad", "bprop", "backward_data",
                            "backward_filter")):
        return "cudnn_conv_backward"
    if any(t in n for t in ("fprop", "conv", "cudnn", "xmma", "implicit")):
        return "cudnn_conv_forward"
    if any(t in n for t in ("gemm", "cutlass", "nvjet", "cublas")):
        return "gemm"
    if "pool" in n:
        return "pooling"
    return "bn_and_elementwise"


def phase_resnet_train_throughput(net, loss_fn, batch=TRAIN_BATCH,
                                  image=RESNET_IMAGE):
    """Images/s of FusedTrainStep at `batch` (median step of steps 3-10 by
    CUDA events), the imperative loop's step time, peak device memory, and
    torch.profiler over one step: device time by kernel group and the
    device's idle share of the step."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    gpu = mx.gpu(0)
    x, y = train_batch(batch, image, gpu, seed=3)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    step = mx.gluon.FusedTrainStep(net, loss_fn, trainer)

    def step_ms(fn, n):
        out = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused = step_ms(lambda: step(x, y), 10)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(fused[2:])
    imp = step_ms(lambda: imperative_step(mx, net, loss_fn, trainer, x, y),
                  4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top, by_op = {}, {}, {}
    for ev in prof.key_averages():
        if ev.key in ("aten::convolution", "aten::convolution_backward"):
            # the device time of every kernel under the op, whatever the
            # kernels are named (fp32 dx/dw of the fused blocks included)
            us = getattr(ev, "device_time_total", None)
            by_op[ev.key] = (ev.cuda_time_total if us is None else us) / 1e3
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = train_kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    emit({"phase": "resnet_train_throughput", "dtype": "bfloat16",
          "batch": batch, "image": image,
          "fused_step_ms_median_3_10": med, "fused_step_ms": fused,
          "images_per_s": batch / med * 1e3,
          "imperative_step_ms_median": statistics.median(imp[1:]),
          "max_memory_allocated_bytes": peak,
          "profile_wall_ms": wall_ms, "profile_device_ms": device_ms,
          "idle_share": 1.0 - device_ms / wall_ms,
          "device_ms_by_group": groups, "conv_device_ms_by_op": by_op,
          "top_kernels_ms": dict(sorted(top.items(),
                                        key=lambda kv: -kv[1])[:12])})
    check(device_ms > 0, "resnet_train_throughput",
          "the profiler saw no device time")


LAMB_KERNELS = ("flat_lamb1", "flat_lamb2")
LAMB_NORM_REL = 1e-5            # per-key squared norms, kernel vs plain:
                                # fp32 sums in another order
ZERO_RTOL, ZERO_ATOL = 5e-5, 5e-6   # ZeRO vs per-parameter LAMB at fp32:
                                # the norms are summed in another order
                                # (the reference's bound, test_zero.py)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 128, 128, 6
BERT_VOCAB, BERT_FN_CONFIG = 30522, "bert_base"
BERT_ROUTE_BATCH = BERT_CPU_BATCH = 8
EMBED_ROWS = 30522 * 768        # BERT-base's word embedding, one key
LAMB_ARGS = (0.9, 0.1, 0.999, 1.0 - 0.999, 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3,
             1e-6, 1.0 / 256, 0.5)   # beta1, omb1, beta2, omb2, d1, d2,
                                     # eps, rescale, clip


def lamb_inputs(n, wdt, mp, vec, gen):
    """Seeded inputs of one LAMB update: weights and gradients N(0, 1),
    mean N(0, 0.1^2), var from squared gradients (as training makes it),
    the moments fp32 under mp (the ZeRO state rule), wd and scale per
    element when `vec`."""
    def rnd(scale=1.0):
        return torch.randn(n, generator=gen, device="cuda") * scale
    sdt = torch.float32 if mp else wdt
    w = rnd().to(wdt)
    g = rnd()
    return {"w": w, "g": g.to(wdt), "mean": rnd(0.1).to(sdt),
            "var": (0.1 * g * g + 0.9 * rnd() ** 2).to(sdt),
            "master": w.float() if mp else None,
            "wd": torch.rand(n, generator=gen, device="cuda") * 1e-2
            if vec else 0.01,
            "scale": torch.rand(n, generator=gen, device="cuda") * 1e-3
            if vec else 1e-3}


def lamb_segments(n):
    """Key segments covering most of n elements, the rest padding."""
    if n < 8:
        return ((0, 0, n),) if n < 4 else ((0, 0, 3), (1, 3, n - 4))
    a = min(768, n // 3)
    return ((0, 0, a), (1, a, n - a - 300), (2, n - 300, 298))


def lamb_pass1(fn, t, clip, bias, mp, segs):
    """Pass 1 by `fn` (kernel or plain) on copies of the moments:
    (direction, mean, var, norms)."""
    return fn(t["w"], t["g"], t["mean"].clone(), t["var"].clone(),
              t["master"], t["wd"], *LAMB_ARGS, clip, mp, bias, segs,
              0 if segs is None else max(k for k, _, _ in segs) + 1)


def lamb_pass2(fn, t, gdir, mp):
    w = t["w"].clone()
    master = t["master"].clone() if mp else None
    return fn(w, master, gdir, t["scale"], mp)


def lamb_bytes(t, mp, norms, n_chunks=0, n_keys=0):
    """Bytes each pass must move: #9 reads w (or the master), g, mean,
    var, wd and writes the direction, mean and var (and the partials and
    norms); #10 reads w (or the master), the direction and the scale and
    writes w (and the master)."""
    def nb(x):
        return x.numel() * x.element_size() if torch.is_tensor(x) else 0
    w = t["master"] if mp else t["w"]
    b1 = nb(w) + nb(t["g"]) + 2 * nb(t["mean"]) + 2 * nb(t["var"]) \
        + nb(t["wd"]) + 4 * t["w"].numel()
    if norms:
        b1 += 12 * n_chunks + 8 * n_keys
    b2 = nb(w) + 4 * t["w"].numel() + nb(t["scale"]) + nb(t["w"]) \
        + (nb(t["master"]) if mp else 0)
    return b1, b2


def bert_param_shapes():
    """[(key, shape)] of bert_12_768_12's parameters in the order the
    Trainer pushes them: reverse registration order, registration being
    the sorted parameter names."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.bert_12_768_12(dropout=0.0)
    net.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 8), ctx=mx.cpu()))
    params = net.collect_params()
    names = sorted(params.keys())
    return [(str(i), params[names[i]].shape)
            for i in reversed(range(len(names)))]


def phase_kernel_lamb(gen):
    """flat_lamb1 (#9) and flat_lamb2 (#10) against their plain versions on
    the card, then their times over one bf16 BERT-base step's ZeRO buckets
    and over one 133.5M-element vector: the kernels-line entries."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops.fused_optimizer import (_ref_flat_lamb1,
                                                     _ref_flat_lamb2,
                                                     flat_lamb1, flat_lamb2,
                                                     lamb_chunk_table)
    f32, b16, f16 = torch.float32, torch.bfloat16, torch.float16
    worst = {"flat_lamb1": 0, "flat_lamb2": 0}
    norm_err, bad, n_cases = 0.0, [], 0
    sizes = [(n, False) for n in (1, 7, 4097)] + [(12 * 768 + 3, True),
                                                  (EMBED_ROWS, True)]
    for wdt in (f32, b16, f16):
        for n, large in sizes:
            flag_sets = [(False, True, False, True, True)] if large else \
                list(itertools.product((False, True), repeat=5))
            for clip, bias, mp, vec, with_norms in flag_sets:
                t = lamb_inputs(n, wdt, mp, vec, gen)
                if not vec and with_norms:
                    # one fp32 value on the card (the per-parameter path's
                    # lr x trust ratio); else a host scalar or per element
                    t["scale"] = torch.tensor(1e-3, device="cuda")
                segs = None
                if with_norms:
                    segs = tuple((k, 768 * k, 768) for k in range(12)) \
                        if n == 12 * 768 + 3 else ((0, 0, n),) \
                        if n == EMBED_ROWS else lamb_segments(n)
                k1 = lamb_pass1(flat_lamb1, t, clip, bias, mp, segs)
                p1 = lamb_pass1(_ref_flat_lamb1, t, clip, bias, mp, segs)
                k2 = lamb_pass2(flat_lamb2, t, p1[0], mp)
                p2 = lamb_pass2(_ref_flat_lamb2, t, p1[0], mp)
                torch.cuda.synchronize()
                n_cases += 1
                case = [str(wdt)[6:], n, clip, bias, mp, vec, with_norms]
                for name, pairs in (("flat_lamb1", zip(k1[:3], p1[:3])),
                                    ("flat_lamb2", zip(k2, p2))):
                    for a, b in pairs:
                        if a is None:
                            continue
                        m = ulps_apart(a, b).max().item()
                        worst[name] = max(worst[name], m)
                        if m:
                            bad.append(case + [name, m])
                if with_norms:
                    rel = ((k1[3] - p1[3]).abs()
                           / p1[3].abs().clamp_min(1e-30)).max().item()
                    norm_err = max(norm_err, rel)
                del t, k1, p1, k2, p2
    emit({"phase": "kernel_lamb", "cases": n_cases, "max_ulps": worst,
          "norms_max_rel_err": norm_err, "cases_with_ulp_differences":
          bad[:20]})
    check(max(worst.values()) == 0 and norm_err <= LAMB_NORM_REL,
          "kernel_lamb", "LAMB kernels differ from their plain versions: "
          "%s ulps, norms %g (limit %g): %s" % (worst, norm_err,
                                                LAMB_NORM_REL, bad[:20]))

    # one bf16 BERT-base step: the ZeRO buckets the Trainer freezes
    shapes = bert_param_shapes()
    layout = engine.BucketLayout.from_entries(
        ((k, torch.empty(s, dtype=b16, device="meta")) for k, s in shapes),
        1, engine.bucket_bytes())
    buckets = []
    for spec in layout:
        by_key = {k: i for i, k in enumerate(spec.keys)}
        segs = tuple((by_key[k], s, ln) for k, s, ln, _
                     in spec.shard_segments(0))
        t = lamb_inputs(spec.shard, b16, False, True, gen)
        # the chunk table is built once per bucket, as ZeroUpdater does
        t["table"] = lamb_chunk_table(segs, len(segs), spec.shard, "cuda")
        buckets.append((t, segs, {"mean": t["mean"].clone(),
                                  "var": t["var"].clone()}))
    gdirs = [lamb_pass1(_ref_flat_lamb1, t, False, True, False, segs)[0]
             for t, segs, _ in buckets]

    def run1(fn):
        # in place on one set of moments per bucket: the real traffic
        return [fn(t["w"], t["g"], st["mean"], st["var"], None, t["wd"],
                   *LAMB_ARGS, False, False, True, segs, len(segs),
                   *([t["table"]] if fn is flat_lamb1 else []))
                for t, segs, st in buckets]

    def run2(fn):
        return [fn(t["w"], None, gd, t["scale"], False)
                for (t, _, _), gd in zip(buckets, gdirs)]

    b1 = b2 = 0
    for t, segs, _ in buckets:
        x1, x2 = lamb_bytes(t, False, True, t["table"][0].numel(), len(segs))
        b1, b2 = b1 + x1, b2 + x2
    elements = sum(t["w"].numel() for t, _, _ in buckets)
    step = {"buckets": len(layout), "keys": len(shapes),
            "elements": elements,
            "flat_lamb1_ms": time_ms(lambda: run1(flat_lamb1), iters=10),
            "flat_lamb1_plain_ms": time_ms(lambda: run1(_ref_flat_lamb1),
                                           iters=3),
            "flat_lamb2_ms": time_ms(lambda: run2(flat_lamb2), iters=10),
            "flat_lamb2_plain_ms": time_ms(lambda: run2(_ref_flat_lamb2),
                                           iters=3),
            "flat_lamb2_addcmul_ms": time_ms(lambda: [
                torch.addcmul(t["w"], t["scale"], gd, value=-1.0)
                for (t, _, _), gd in zip(buckets, gdirs)], iters=10)}
    step["flat_lamb1_bound_ms"], step["flat_lamb1_bound_by"] = \
        bound(0.0, b1, f32)
    step["flat_lamb2_bound_ms"], step["flat_lamb2_bound_by"] = \
        bound(0.0, b2, f32)
    emit(dict({"phase": "kernel_lamb", "what": "one bf16 BERT-base step's "
               "ZeRO buckets"}, **step))
    del buckets, gdirs

    # one 133.5M-element vector holding every key (one bucket, no cap)
    n = sum(int(np.prod(s)) for _, s in shapes)
    segs, off = [], 0
    for i, (_, s) in enumerate(shapes):
        segs.append((i, off, int(np.prod(s))))
        off += int(np.prod(s))
    segs = tuple(segs)
    t = lamb_inputs(n, b16, False, True, gen)
    table = lamb_chunk_table(segs, len(segs), n, "cuda")
    gd = lamb_pass1(_ref_flat_lamb1, t, False, True, False, segs)[0]
    x1, x2 = lamb_bytes(t, False, True, table[0].numel(), len(segs))
    whole = {"elements": n, "keys": len(segs),
             "flat_lamb1_ms": time_ms(lambda: flat_lamb1(
                 t["w"], t["g"], t["mean"], t["var"], None, t["wd"],
                 *LAMB_ARGS, False, False, True, segs, len(segs), table),
                 iters=10),
             "flat_lamb2_ms": time_ms(lambda: flat_lamb2(
                 t["w"], None, gd, t["scale"], False), iters=10),
             "flat_lamb2_addcmul_ms": time_ms(lambda: torch.addcmul(
                 t["w"], t["scale"], gd, value=-1.0), iters=10)}
    whole["flat_lamb1_bound_ms"], _ = bound(0.0, x1, f32)
    whole["flat_lamb2_bound_ms"], _ = bound(0.0, x2, f32)
    emit(dict({"phase": "kernel_lamb", "what": "one 133.5M-element vector"},
              **whole))
    del t, gd
    torch.cuda.empty_cache()
    return {"flat_lamb1": {"max_abs_err": float(worst["flat_lamb1"]),
                           "ms": step["flat_lamb1_ms"],
                           "plain_ms": step["flat_lamb1_plain_ms"],
                           "bound_ms": step["flat_lamb1_bound_ms"],
                           "bound_by": step["flat_lamb1_bound_by"],
                           "library_ms": None},
            "flat_lamb2": {"max_abs_err": float(worst["flat_lamb2"]),
                           "ms": step["flat_lamb2_ms"],
                           "plain_ms": step["flat_lamb2_plain_ms"],
                           "bound_ms": step["flat_lamb2_bound_ms"],
                           "bound_by": step["flat_lamb2_bound_by"],
                           "library_ms": step["flat_lamb2_addcmul_ms"]}}


def bert_net(ctx, dtype="bfloat16", path=None, seed=0):
    """bert_12_768_12 (dropout 0) on `ctx`: Normal(0.02) weights from
    mx.random.seed(seed) with the shapes resolved by one predict-mode pass,
    or the weights of `path`; cast to `dtype`."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.bert_12_768_12(dropout=0.0)
    if path is None:
        mx.random.seed(seed)
        net.initialize(mx.init.Normal(0.02), ctx=ctx)
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 8), ctx=ctx))
        net.cast(dtype)
    else:
        net.cast(dtype)
        net.load_parameters(path, ctx=ctx, cast_dtype=True)
    net.hybridize(static_alloc=True)
    return net


def bert_batch(batch, ctx, seed=0):
    """BERT_SEQ token ids and MLM labels a row, uniform over the
    vocabulary, from numpy with a seed, as float32 arrays (bench.py's
    bench_bert_gluon)."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed)
    x = rng.randint(0, BERT_VOCAB, (batch, BERT_SEQ)).astype(np.float32)
    y = rng.randint(0, BERT_VOCAB, (batch, BERT_SEQ)).astype(np.float32)
    return mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)


def bert_step(mx, net, sce, trainer, x, y):
    with mx.autograd.record():
        loss = sce(net(x)[3], y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def bert_eval_loss(mx, net, sce, x, y):
    """The mean MLM loss in predict mode, its log-softmax on fp32 logits:
    a bf16 loss (ulp 0.0625 near ln(30522)) cannot show a few steps'
    progress."""
    with mx.autograd.predict_mode():
        out = net(x)[3].astype("float32")
        return sce(out, y).asnumpy().astype(np.float64).mean().item()


def lamb_trainer(mx, net, zero):
    return mx.gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": 1e-3, "wd": 0.01},
                            kvstore="device" if zero else None, zero=zero)


def bert_grads(mx, net, sce, x, y):
    with mx.autograd.record():
        loss = sce(net(x)[3], y)
    loss.backward()
    return {k: p.grad().data_torch.float().cpu()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def functional_bert_step(gen):
    """bert_mlm_loss at bert_base, bf16, batch x seq = 128 x 128, 15% of the
    positions predicted: forward, loss and backward through the flash
    kernels (causal=False), counted, against the same step with plain
    attention (bf16), and both against the plain step at fp32. Returns
    (record, launches)."""
    from mxnet_tpu_torch.models.bert import CONFIGS, bert_init, bert_mlm_loss
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    cfg = CONFIGS[BERT_FN_CONFIG]
    params = bert_init(gen, cfg, device=gen.device)
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (BERT_BATCH,
                                                       BERT_SEQ)),
             "targets": rng.randint(0, cfg.vocab_size, (BERT_BATCH,
                                                        BERT_SEQ)),
             "mask": (rng.rand(BERT_BATCH, BERT_SEQ) < 0.15)
             .astype(np.float32)}

    def grads(tree, context):
        names = [n for n, _ in leaves(tree)]
        flat = [t for _, t in leaves(tree)]
        for t in flat:
            t.requires_grad_(True)
        try:
            with context():
                loss = bert_mlm_loss(tree, batch, cfg)
                got = torch.autograd.grad(loss, flat)
        finally:
            for t in flat:
                t.requires_grad_(False)
        return loss.item(), dict(zip(names, (g.float() for g in got)))

    torch.cuda.synchronize()
    reset_launch_counts()
    loss, kern = grads(params, contextlib.nullcontext)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_bwd_wgmma({}, variant_counts(), 12, "bert_train",
                    "functional step")
    check_fwd_wgmma({}, variant_counts(), 12, "bert_train",
                    "functional step")
    ploss, plain = grads(params, plain_attention)
    _, exact = grads(to_fp32(params), plain_attention)
    # the key bias adds q . bk to every score of a query row, which the
    # softmax takes out: its gradient is zero in exact arithmetic and
    # rounding noise on every path, so it is held apart (small against
    # the median leaf)
    null = [n for n in kern if n.endswith("bk")]
    med_norm = statistics.median(g.norm().item() for g in exact.values())
    noise = max(max(kern[n].norm().item(), plain[n].norm().item())
                for n in null) / med_norm
    for tree in (kern, plain, exact):
        for n in null:
            del tree[n]
    whole = rel_err(torch.cat([g.flatten() for g in kern.values()]),
                    torch.cat([plain[n].flatten() for n in kern]))

    def stats(a):
        errs = {n: rel_err(g, exact[n]) for n, g in a.items()}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:4])}

    vs_fp32 = {"kernels": stats(kern), "plain": stats(plain)}
    rec = {"config": "%s bf16" % BERT_FN_CONFIG, "batch": BERT_BATCH,
           "seq": BERT_SEQ, "loss": loss, "plain_loss": ploss,
           "loss_rel_err": abs(loss - ploss) / abs(ploss),
           "grads_rel_err_vs_plain": whole,
           "grads_vs_fp32_step": vs_fp32,
           "median_limit": max(GRAD_REL,
                               1.5 * vs_fp32["plain"]["median"]),
           "max_limit": max(GRAD_REL, 2.0 * vs_fp32["plain"]["max"]),
           "key_bias_grad_norm_over_median": noise,
           "launches": {k: v for k, v in launches.items() if v}}
    return rec, launches


def phase_bert_train(gen, tmp):
    """Main path 5: BERT-base pretraining through Gluon with LAMB on the
    ZeRO updater. bert_12_768_12 (bf16, dropout 0), SoftmaxCrossEntropyLoss
    on the MLM logits (out[3]) over every position, Trainer("lamb", lr 1e-3,
    wd 0.01, kvstore="device", zero=True), BERT_STEPS steps on one seeded
    batch, counts reset just before and read just after; then the ZeRO and
    per-parameter routes at fp32, one step's gradients against the CPU, a
    .params round trip, and the functional bert_mlm_loss through the flash
    kernels. Returns (net, trainer, batch, {kernel: launches on the
    path})."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    gpu = mx.gpu(0)
    net = bert_net(gpu)
    dtypes = {k: t.dtype for k, t in snapshot(net).items()}
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = lamb_trainer(mx, net, True)
    x, y = bert_batch(BERT_BATCH, gpu)
    before = snapshot(net)
    eval_before = bert_eval_loss(mx, net, sce, x, y)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [bert_step(mx, net, sce, trainer, x, y).asnumpy().mean().item()
              for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    eval_after = bert_eval_loss(mx, net, sce, x, y)
    layout = trainer._kvstore._updater.layout
    check_path(launches, LAMB_KERNELS, "main_path_bert_train")
    want = {k: len(layout) * BERT_STEPS for k in LAMB_KERNELS}
    check(all(launches[k] == v for k, v in want.items()), "bert_train",
          "launches %s, expected %s a step for %d buckets"
          % (launches, want, len(layout)))
    check(all(np.isfinite(losses)) and eval_after < eval_before,
          "bert_train", "loss not finite or not falling: steps %s, fp32 "
          "loss before %r after %r" % (losses, eval_before, eval_after))
    after = snapshot(net)
    check(all(after[k].dtype == dt for k, dt in dtypes.items()),
          "bert_train", "a parameter changed its dtype")
    # a bf16 weight moves only where the step exceeds half its ulp
    moved = sum(int((after[k] != v).sum()) for k, v in before.items()) \
        / sum(v.numel() for v in before.values())
    del before
    path = os.path.join(tmp, "bert_base.params")
    net.save_parameters(path)

    # the .params round trip, bit for bit
    back = snapshot(bert_net(gpu, path=path))
    round_trip = sorted(back) == sorted(after) and all(
        torch.equal(t, back[k]) for k, t in after.items())
    del back
    check(round_trip, "bert_train", ".params round trip not bit-equal")

    # the ZeRO route against the per-parameter route (kvstore=None: #9 and
    # #10 once per parameter), fp32, 2 steps from one state
    xs, ys = bert_batch(BERT_ROUTE_BATCH, gpu, seed=1)
    routes, route_launches = [], []
    for zero in (True, None):
        rnet = bert_net(gpu, "float32", path)
        rtr = lamb_trainer(mx, rnet, zero)
        reset_launch_counts()
        for _ in range(2):
            bert_step(mx, rnet, sce, rtr, xs, ys)
        torch.cuda.synchronize()
        route_launches.append({k: v for k, v in launch_counts().items()
                               if v})
        routes.append(snapshot(rnet))
        del rnet, rtr
    excess = max(((a - routes[1][k]).abs() - ZERO_ATOL
                  - ZERO_RTOL * routes[1][k].abs()).max().item()
                 for k, a in routes[0].items())
    diff = max((a - routes[1][k]).abs().max().item()
               for k, a in routes[0].items())
    n_params = len(routes[0])
    check(excess <= 0, "bert_train", "ZeRO and per-parameter LAMB differ "
          "beyond rtol %g / atol %g (max abs %g)" % (ZERO_RTOL, ZERO_ATOL,
                                                     diff))
    check(route_launches[1].get("flat_lamb1") == 2 * n_params
          and route_launches[1].get("flat_lamb2") == 2 * n_params,
          "bert_train", "per-parameter route launches %s for %d parameters"
          % (route_launches[1], n_params))
    del routes
    torch.cuda.empty_cache()

    # one fp32 batch-8 step's gradients, card against CPU, held to the
    # card's own spread when every weight moves by one ulp
    xc, yc = bert_batch(BERT_CPU_BATCH, mx.cpu(), seed=2)
    card = bert_grads(mx, bert_net(gpu, "float32", path), sce,
                      xc.as_in_context(gpu), yc.as_in_context(gpu))
    nudged_net = bert_net(gpu, "float32", path)
    with torch.no_grad():
        for p in nudged_net.collect_params().values():
            d = p.data().data_torch
            d.copy_(torch.nextafter(d, torch.tensor(float("inf"),
                                                    device=d.device)))
    nudged = bert_grads(mx, nudged_net, sce, xc.as_in_context(gpu),
                        yc.as_in_context(gpu))
    del nudged_net
    host = bert_grads(mx, bert_net(mx.cpu(), "float32", path), sce, xc, yc)

    def stats(a, b):
        errs = {k: rel_err(g, b[k]) for k, g in a.items()
                if b[k].norm() > 0}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:5])}

    vs_cpu, spread = stats(card, host), stats(card, nudged)
    median_limit = max(GRAD_FP32_REL, 2.0 * spread["median"])
    max_limit = max(GRAD_FP32_REL, 2.0 * spread["max"])
    del card, nudged, host
    torch.cuda.empty_cache()

    fn_rec, fn_launches = functional_bert_step(gen)
    emit({"phase": "bert_train", "config": "bert_12_768_12 bf16, dropout 0, "
          "Trainer(lamb lr 1e-3 wd 0.01, kvstore=device, zero=True)",
          "batch": BERT_BATCH, "seq": BERT_SEQ, "steps": BERT_STEPS,
          "losses": losses, "fp32_eval_loss_before": eval_before,
          "fp32_eval_loss_after": eval_after,
          "share_of_weights_moved": moved,
          "steps_wall_s": wall_s, "buckets": len(layout),
          "bucket_elements": [s.size for s in layout],
          "trainable_params": n_params, "launches": launches,
          "params_round_trip_bit_equal": round_trip,
          "zero_vs_per_parameter": {"batch": BERT_ROUTE_BATCH, "steps": 2,
                                    "max_abs_diff": diff,
                                    "max_excess_over_bound": excess,
                                    "launches": route_launches},
          "card_vs_cpu_fp32": {"batch": BERT_CPU_BATCH, "grads": vs_cpu,
                               "one_ulp_weights": spread,
                               "median_limit": median_limit,
                               "max_limit": max_limit},
          "functional_mlm_step": fn_rec})
    check(vs_cpu["median"] <= median_limit and vs_cpu["max"] <= max_limit,
          "bert_train", "fp32 gradients vs the CPU: median %g (limit %g), "
          "worst %s (limit %g)" % (vs_cpu["median"], median_limit,
                                   vs_cpu["worst_leaves"], max_limit))
    check(all(fn_launches[k] == 12 for k in TRAIN_KERNELS)
          and all(fn_launches[k] == 0 for k in fn_launches
                  if k not in TRAIN_KERNELS), "bert_train",
          "functional step launches %s, expected 12 of each flash kernel"
          % fn_launches)
    # bf16 query/key gradients of the deeper layers are rounding noise on
    # both paths (their fp32 step differs by several times their norm):
    # per leaf, the kernels may be no further from the fp32 step than the
    # plain bf16 path is (x1.5 median, x2 worst leaf), as resnet_train holds
    # bf16
    fk = fn_rec["grads_vs_fp32_step"]["kernels"]
    check(fn_rec["loss_rel_err"] <= GRAD_REL
          and fn_rec["grads_rel_err_vs_plain"] <= GRAD_REL
          and fk["median"] <= fn_rec["median_limit"]
          and fk["max"] <= fn_rec["max_limit"]
          and fn_rec["key_bias_grad_norm_over_median"] <= GRAD_REL,
          "bert_train", "functional step vs plain attention: %s" % fn_rec)
    paths = {k: launches[k] + fn_launches[k] for k in launches}
    return net, trainer, (x, y), paths


def bert_kernel_group(name):
    n = name.lower()
    if "lamb1" in n or "lamb_norms" in n:
        return "flat_lamb1"
    if "lamb2" in n:
        return "flat_lamb2"
    if any(t in n for t in ("gemm", "cutlass", "nvjet", "cublas", "xmma",
                            "sm90")):
        return "matmul"
    return "elementwise_ln_softmax_embedding_loss_copies"


def phase_bert_train_throughput(net, trainer, batch):
    """Step time of the main path (median of steps 2-6, CUDA events),
    tokens/s, peak memory, and torch.profiler over one step: device time by
    kernel group, the ZeRO legs (pack; update: #9, #10 and the trust-ratio
    scale, which is also timed alone; unpack) and the trainer's weight
    write-back by profiler range, and the idle share."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = batch
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(BERT_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        bert_step(mx, net, sce, trainer, x, y)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bert_step(mx, net, sce, trainer, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = ("zero.pack", "zero.update", "zero.lamb_scale", "zero.unpack",
              "trainer.writeback")
    groups, top, legs = {}, {}, {}
    for ev in prof.key_averages():
        if ev.key in ranges:
            # the host-side range: the device time of the kernels launched
            # inside it, and its host time (the range also appears on the
            # device timeline as an annotation, which is no kernel)
            if ev.device_type == torch.autograd.DeviceType.CPU:
                us = getattr(ev, "device_time_total", None)
                legs[ev.key] = {
                    "kernels_device_ms": (ev.cuda_time_total if us is None
                                          else us) / 1e3,
                    "host_ms": ev.cpu_time_total / 1e3, "calls": ev.count}
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        g = bert_kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(groups.values())
    emit({"phase": "bert_train_throughput", "dtype": "bfloat16",
          "batch": BERT_BATCH, "seq": BERT_SEQ,
          "step_ms_median_2_6": med, "step_ms": times,
          "tokens_per_s": BERT_BATCH * BERT_SEQ / med * 1e3,
          "max_memory_allocated_bytes": peak,
          "profile_wall_ms": wall_ms, "profile_device_ms": device_ms,
          "idle_share": 1.0 - device_ms / wall_ms,
          "device_ms_by_group": groups, "zero_and_writeback_legs": legs,
          "top_kernels_ms": dict(sorted(top.items(),
                                        key=lambda kv: -kv[1])[:12])})
    check(device_ms > 0, "bert_train_throughput",
          "the profiler saw no device time")


# ---------------------------------------------------------------------------
# the optimizer family (card phase `optimizers`) and main path 7: BERT-base
# through Gluon with AdamW and FusedTrainStep
# ---------------------------------------------------------------------------
FUSED_RTOL, FUSED_ATOL = 2e-5, 2e-6     # FusedTrainStep against Trainer.step
                                        # at fp32: the reference's own bar
                                        # (tests/test_fused_step.py)
OPT_PAIRS = [                           # tests/test_fused_step.py:33-49
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 1e-4}),
    ("signsgd", {"learning_rate": 0.005}),
    ("ftml", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.05}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-5}),
    ("adamax", {"learning_rate": 0.002}),
    ("nadam", {"learning_rate": 0.005}),
    ("rmsprop", {"learning_rate": 0.005}),
    ("rmsprop", {"learning_rate": 0.005, "centered": True, "gamma2": 0.85}),
    ("ftrl", {"learning_rate": 0.05, "lamda1": 0.001}),
    ("lamb", {"learning_rate": 0.01}),
    ("lars", {"learning_rate": 0.05, "momentum": 0.9, "eta": 0.001}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9}),
]
OPT_STEPS, OPT_PARAMS = 4, 4            # steps; the MLP's trainable tensors
# kernel launches of both routes over OPT_STEPS steps: SGD and Adam one
# multi-tensor launch a step each route (Trainer's aggregated route and
# FusedTrainStep); LAMB #9 and #10 once per tensor a step each route; LARS
# #7 once per tensor a step each route (sgd_mom_update); the rest none
OPT_LAUNCHES = {"sgd": {"flat_sgd": 2 * OPT_STEPS},
                "adam": {"flat_adam": 2 * OPT_STEPS},
                "lamb": {"flat_lamb1": 2 * OPT_STEPS * OPT_PARAMS,
                         "flat_lamb2": 2 * OPT_STEPS * OPT_PARAMS},
                "lars": {"flat_sgd": 2 * OPT_STEPS * OPT_PARAMS}}
SGLD_NOISE_N = 100_000
MULTI_SGD_OPS = {"multi_sgd_update": ("w", "g"),
                 "multi_sgd_mom_update": ("w", "g", "mom"),
                 "multi_mp_sgd_update": ("w", "g", "w32"),
                 "multi_mp_sgd_mom_update": ("w", "g", "mom", "w32")}
MULTI_SIZES = [1, 7, 300, 4097, 64, 2048, 33, 8192]
GLUON_BERT_WARMUP, GLUON_BERT_STEPS = 3, 10   # bench.py runs 10 + 50
ADAMW_ARGS = {"learning_rate": 1e-4, "wd": 0.01}
NARROW_BERT = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
                   num_heads=4, max_length=32, dropout=0.0)
NARROW_BATCH, NARROW_SEQ, NARROW_STEPS = 4, 32, 3   # bench.py:280-284
NARROW_PARAM_REL = 1e-4         # per-leaf ||card - cpu|| / ||cpu|| after 3
                                # fp32 AdamW steps


def opt_mlp(mx, ctx):
    """The reference test's MLP: Dense(32, relu), Dense(8), Xavier
    (gaussian) weights from the current seed."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"))
        net.add(nn.Dense(8))
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
    return net


def route_excess(a, b, rtol, atol):
    """(max over tensors of max(|a - b| - atol - rtol |b|), max |a - b|)
    between two {name: tensor} snapshots of one net's parameters."""
    excess = max(((a[k] - v).abs() - atol - rtol * v.abs()).max().item()
                 for k, v in b.items())
    diff = max((a[k] - v).abs().max().item() for k, v in b.items())
    return excess, diff


def mixed_sgd_list(keys, seed):
    """MULTI_SIZES tensors, bf16 and fp32 (every third fp32), on the card:
    the interleaved argument list of a multi-SGD op (fp32 masters)."""
    rng = np.random.RandomState(seed)
    args = []
    for j, n in enumerate(MULTI_SIZES):
        dt = torch.float32 if j % 3 == 2 else torch.bfloat16
        w32 = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        t = {"w": w32.to(dt), "w32": w32,
             "g": torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
             .to(dt),
             "mom": torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
             .cuda().to(dt)}
        args += [t[k] for k in keys]
    return args


def phase_optimizers():
    """The reference's 16 fusable (optimizer, args) pairs on the card: its
    MLP at fp32, OPT_STEPS steps of Trainer.step and of FusedTrainStep from
    one state, within rtol 2e-5 / atol 2e-6, each pair's kernel launches
    as expected; SGLD through Trainer.step alone, and its noise's mean
    and deviation; then the four multi-SGD registry ops over 8 mixed,
    ragged tensors (one flat_sgd launch of variant multi a call, 0 ulps
    from the plain version on the card) and the mp LAMB phases (one
    flat_lamb1 / flat_lamb2 launch each, 0 ulps)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (launch_counts, registry,
                                     reset_launch_counts, variant_counts)
    gpu = mx.gpu(0)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(16, 12).astype(np.float32), ctx=gpu)
    y = mx.nd.array(rng.randint(0, 8, (16,)).astype(np.float32), ctx=gpu)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    routes = {}
    for name, args in OPT_PAIRS:
        label = name + ("_centered" if args.get("centered") else "")
        mx.random.seed(7)
        a, b = opt_mlp(mx, gpu), opt_mlp(mx, gpu)
        a(x)
        b(x)
        for (_, pa), (_, pb) in zip(sorted(a.collect_params().items()),
                                    sorted(b.collect_params().items())):
            pb.set_data(pa.data().copy())
        ta = mx.gluon.Trainer(a.collect_params(), name, dict(args))
        tb = mx.gluon.Trainer(b.collect_params(), name, dict(args))
        fused = mx.gluon.FusedTrainStep(b, sce, tb)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = []
        for _ in range(OPT_STEPS):
            la = imperative_step(mx, a, sce, ta, x, y)
            lb = fused(x, y)
            losses.append((la.asnumpy().astype(np.float64).mean().item(),
                           float(lb.asnumpy())))
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        excess, diff = route_excess(snapshot(b), snapshot(a), FUSED_RTOL,
                                    FUSED_ATOL)
        routes[label] = {"max_abs_diff": diff, "excess": excess,
                         "losses": losses, "launches": launches}
        check(np.isfinite(losses).all() and excess <= 0, "optimizers",
              "%s: FusedTrainStep and Trainer.step differ beyond rtol %g / "
              "atol %g: %s" % (label, FUSED_RTOL, FUSED_ATOL, routes[label]))
        check(launches == OPT_LAUNCHES.get(name, {}), "optimizers",
              "%s: launches %s, expected %s" % (
                  label, launches, OPT_LAUNCHES.get(name, {})))

    # SGLD: the imperative route alone (no fused route takes it)
    mx.random.seed(7)
    net = opt_mlp(mx, gpu)
    net(x)
    tr = mx.gluon.Trainer(net.collect_params(), "sgld",
                          {"learning_rate": 0.01})
    before = snapshot(net)
    sgld_losses = [imperative_step(mx, net, sce, tr, x, y).asnumpy()
                   .astype(np.float64).mean().item() for _ in range(4)]
    after = snapshot(net)
    moved = all(not torch.equal(after[k], v) for k, v in before.items())
    lr = 0.01
    mx.random.seed(3)
    w = mx.nd.zeros((SGLD_NOISE_N,), ctx=gpu)
    mx.optimizer.get_updater(mx.optimizer.create("sgld", learning_rate=lr))(
        0, mx.nd.zeros((SGLD_NOISE_N,), ctx=gpu), w)
    noise = w.data_torch.double()
    sgld = {"losses": sgld_losses, "every_tensor_moved": moved,
            "noise_mean": noise.mean().item(),
            "noise_std_over_sqrt_lr": noise.std().item() / math.sqrt(lr)}
    check(np.isfinite(sgld_losses).all() and moved
          and abs(sgld["noise_mean"]) <= 5 * math.sqrt(lr / SGLD_NOISE_N)
          and abs(sgld["noise_std_over_sqrt_lr"] - 1.0) <= 0.01,
          "optimizers", "SGLD on the card: %s" % sgld)

    # the multi-SGD registry ops: one launch a call, 0 ulps from the plain
    multi = {}
    for name, keys in MULTI_SGD_OPS.items():
        for seed, clip in ((0, -1.0), (1, 0.3)):
            args = mixed_sgd_list(keys, seed)
            kw = dict(lrs=[0.01 * (j + 1) for j in range(len(MULTI_SIZES))],
                      wds=[1e-4] * len(MULTI_SIZES), rescale_grad=0.5,
                      clip_gradient=clip)
            if "mom" in keys:
                kw["momentum"] = 0.9
            want = registry.get(name).fn(*[t.clone() for t in args], **kw)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = registry.get(name).best_fn(True)(*args, **kw)
            torch.cuda.synchronize()
            variants = variant_counts()
            ulps = max(ulps_apart(g, w).max().item()
                       for g, w in zip(got, want))
            multi["%s_clip%s" % (name, clip)] = {
                "ulps": ulps, "variants": {"/".join(k): v
                                           for k, v in variants.items()}}
            check(variants == {("flat_sgd", "multi"): 1} and ulps == 0
                  and all(g.dtype == w.dtype for g, w in zip(got, want)),
                  "optimizers", "%s: launches %s, %d ulps from the plain "
                  "version" % (name, variants, ulps))

    # the mp LAMB phases: one launch each, 0 ulps
    r = np.random.RandomState(3)
    n = 4097
    w32 = torch.from_numpy(r.randn(n).astype(np.float32)).cuda()
    wb = w32.bfloat16()
    g = torch.from_numpy(r.randn(n).astype(np.float32)).cuda()
    mean = torch.from_numpy((r.randn(n) * 0.1).astype(np.float32)).cuda()
    var = (g * g * 0.1).contiguous()
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=3, wd=0.01,
              rescale_grad=0.5, clip_gradient=1.0)
    op1 = registry.get("mp_lamb_update_phase1")
    want1 = op1.fn(wb, g, mean.clone(), var.clone(), w32.clone(), **kw)
    reset_launch_counts()
    got1 = op1.best_fn(True)(wb, g, mean, var, w32, **kw)
    torch.cuda.synchronize()
    l1 = launch_counts()["flat_lamb1"]
    op2 = registry.get("mp_lamb_update_phase2")
    r1, r2 = w32.norm(), got1[0].norm()
    want2 = op2.fn(wb.clone(), got1[0], r1, r2, w32.clone(), lr=1e-3,
                   lower_bound=0.1, upper_bound=10.0)
    reset_launch_counts()
    got2 = op2.best_fn(True)(wb, got1[0], r1, r2, w32, lr=1e-3,
                             lower_bound=0.1, upper_bound=10.0)
    torch.cuda.synchronize()
    l2 = launch_counts()["flat_lamb2"]
    lamb_ulps = max(ulps_apart(a, b).max().item()
                    for a, b in zip(got1 + got2, want1 + want2))
    emit({"phase": "optimizers", "steps": OPT_STEPS, "routes": routes,
          "sgld": sgld, "multi_sgd_ops": multi,
          "mp_lamb": {"flat_lamb1": l1, "flat_lamb2": l2,
                      "ulps": lamb_ulps}})
    check(l1 == 1 and l2 == 1 and lamb_ulps == 0, "optimizers",
          "mp LAMB phases: %d / %d launches, %d ulps" % (l1, l2, lamb_ulps))


def card_name_and_limit():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def adamw_step(mx, net):
    """Trainer("adamw", lr 1e-4, wd 0.01) and FusedTrainStep with the MLM
    loss on out[3], as bench.py::bench_bert_gluon builds them."""
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               dict(ADAMW_ARGS))
    return mx.gluon.FusedTrainStep(net, lambda out, label: sce(out[3], label),
                                   trainer)


def narrow_bert(mx, ctx, path):
    """bench_bert_gluon's CPU configuration at fp32, from `path`."""
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.BERTModel(**NARROW_BERT)
    net.load_parameters(path, ctx=ctx)
    net.hybridize(static_alloc=True)
    return net


def narrow_batch(mx, ctx, seed):
    rng = np.random.RandomState(seed)
    shape = (NARROW_BATCH, NARROW_SEQ)
    x = rng.randint(0, NARROW_BERT["vocab_size"], shape).astype(np.float32)
    y = rng.randint(0, NARROW_BERT["vocab_size"], shape).astype(np.float32)
    return mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)


def narrow_checks(mx, tmp):
    """bench_bert_gluon's narrow configuration at fp32: FusedTrainStep
    against record/backward/Trainer.step on the card (3 steps, rtol 2e-5 /
    atol 2e-6), step 1's gradients card against CPU (the card's one-ulp
    spread, as bert_train holds them) and the parameters after 3 fused
    steps, card against CPU, within 1e-4 per leaf."""
    from mxnet_tpu_torch.gluon.model_zoo import bert
    gpu = mx.gpu(0)
    mx.random.seed(0)
    init = bert.BERTModel(**NARROW_BERT)
    init.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    with mx.autograd.predict_mode():
        init(mx.nd.zeros((1, 8), ctx=mx.cpu()))
    path = os.path.join(tmp, "narrow_bert.params")
    init.save_parameters(path)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xc, yc = narrow_batch(mx, mx.cpu(), 1)
    xg, yg = xc.as_in_context(gpu), yc.as_in_context(gpu)

    # the two routes on the card
    fnet, inet = narrow_bert(mx, gpu, path), narrow_bert(mx, gpu, path)
    fstep = adamw_step(mx, fnet)
    itr = mx.gluon.Trainer(inet.collect_params(), "adamw", dict(ADAMW_ARGS))
    losses = []
    for _ in range(NARROW_STEPS):
        lf = float(fstep(xg, yg).asnumpy())
        with mx.autograd.record():
            li = sce(inet(xg)[3], yg)
        li.backward()
        itr.step(NARROW_BATCH)
        losses.append((lf, li.asnumpy().astype(np.float64).mean().item()))
    card = snapshot(fnet)
    excess, diff = route_excess(card, snapshot(inet), FUSED_RTOL, FUSED_ATOL)
    del inet, itr

    # the same fused steps on the CPU
    cnet = narrow_bert(mx, mx.cpu(), path)
    cstep = adamw_step(mx, cnet)
    cpu_losses = [float(cstep(xc, yc).asnumpy())
                  for _ in range(NARROW_STEPS)]
    host = snapshot(cnet)
    leaf = {k: (card[k].cpu() - v).norm().item()
            / max(v.norm().item(), 1e-30) for k, v in host.items()}

    # step 1's gradients, card against CPU, and the card's own spread
    # under a one-ulp change of every weight
    g_card = bert_grads(mx, narrow_bert(mx, gpu, path), sce, xg, yg)
    nudged_net = narrow_bert(mx, gpu, path)
    with torch.no_grad():
        for p in nudged_net.collect_params().values():
            d = p.data().data_torch
            d.copy_(torch.nextafter(d, torch.tensor(float("inf"),
                                                    device=d.device)))
    g_nudged = bert_grads(mx, nudged_net, sce, xg, yg)
    g_host = bert_grads(mx, narrow_bert(mx, mx.cpu(), path), sce, xc, yc)

    def stats(a, b):
        errs = {k: rel_err(v, b[k]) for k, v in a.items() if b[k].norm() > 0}
        return {"median": statistics.median(errs.values()),
                "max": max(errs.values()),
                "worst_leaves": dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:4])}

    vs_cpu, spread = stats(g_card, g_host), stats(g_card, g_nudged)
    rec = {"config": "BERTModel units 64, hidden 128, 2 layers, 4 heads, "
           "vocab 256, fp32", "batch": NARROW_BATCH, "seq": NARROW_SEQ,
           "steps": NARROW_STEPS,
           "fused_vs_imperative": {"losses": losses, "max_abs_diff": diff,
                                   "excess": excess},
           "card_vs_cpu": {"cpu_losses": cpu_losses,
                           "params_rel_max": max(leaf.values()),
                           "params_worst_leaves": dict(sorted(
                               leaf.items(), key=lambda kv: -kv[1])[:4]),
                           "grads": vs_cpu, "one_ulp_weights": spread,
                           "median_limit": max(GRAD_FP32_REL,
                                               2.0 * spread["median"]),
                           "max_limit": max(GRAD_FP32_REL,
                                            2.0 * spread["max"])}}
    return rec


def phase_bert_gluon_train(tmp):
    """Main path 7: bench.py::bench_bert_gluon on the card.
    bert_12_768_12 (bf16, dropout 0, hybridized), Trainer("adamw", lr 1e-4,
    wd 0.01) and FusedTrainStep with SoftmaxCrossEntropyLoss on out[3], one
    seeded batch of 128 x 128: GLUON_BERT_WARMUP warm-up and
    GLUON_BERT_STEPS timed steps (the bench runs 10 + 50; cut for the smoke
    run's time), counts reset just before and read just after; then one
    profiled step (device time, idle share, top kernels, the AdamW
    update's `fused_step.update` range) and the narrow configuration's
    checks at fp32. Returns {kernel: launches on the path}."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from torch.profiler import ProfilerActivity, profile
    gpu = mx.gpu(0)
    net = bert_net(gpu)
    dtypes = {k: t.dtype for k, t in snapshot(net).items()}
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = adamw_step(mx, net)
    x, y = bert_batch(BERT_BATCH, gpu, seed=1)
    eval_before = bert_eval_loss(mx, net, sce, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = [step(x, y) for _ in range(GLUON_BERT_WARMUP)]
    torch.cuda.synchronize()
    times = []
    t0 = time.perf_counter()
    for _ in range(GLUON_BERT_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(step(x, y))
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in times]
    losses = [float(v.asnumpy()) for v in out]
    eval_after = bert_eval_loss(mx, net, sce, x, y)
    after = snapshot(net)
    kept = all(after[k].dtype == dt for k, dt in dtypes.items())
    del after

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    top, update = {}, {}
    for ev in prof.key_averages():
        if ev.key == "fused_step.update":
            if ev.device_type == torch.autograd.DeviceType.CPU:
                us = getattr(ev, "device_time_total", None)
                update = {"kernels_device_ms": (ev.cuda_time_total
                                                if us is None else us) / 1e3,
                          "host_ms": ev.cpu_time_total / 1e3,
                          "calls": ev.count}
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
    device_ms = sum(top.values())
    med = statistics.median(step_ms)
    narrow = narrow_checks(mx, tmp)
    emit({"phase": "bert_gluon_train",
          "config": "bench.py::bench_bert_gluon: bert_12_768_12 bf16, "
          "dropout 0, hybridize(static_alloc), Trainer(adamw lr 1e-4 wd "
          "0.01) + FusedTrainStep, SoftmaxCrossEntropyLoss on out[3]",
          "batch": BERT_BATCH, "seq": BERT_SEQ,
          "steps": "%d warm-up + %d timed (bench.py: 10 + 50; cut for the "
          "smoke run's time)" % (GLUON_BERT_WARMUP, GLUON_BERT_STEPS),
          "card": card_name_and_limit(),
          "losses": losses, "fp32_eval_loss_before": eval_before,
          "fp32_eval_loss_after": eval_after, "dtypes_kept": kept,
          "tokens_per_s": BERT_BATCH * BERT_SEQ * GLUON_BERT_STEPS / wall_s,
          "step_ms_median": med, "step_ms": step_ms,
          "tokens_per_s_at_median_step": BERT_BATCH * BERT_SEQ / med * 1e3,
          "max_memory_allocated_bytes": peak,
          "launches": {k: v for k, v in launches.items()},
          "profile_wall_ms": prof_wall_ms, "profile_device_ms": device_ms,
          "idle_share": 1.0 - device_ms / prof_wall_ms,
          "adamw_update": update,
          "top_kernels_ms": dict(sorted(top.items(),
                                        key=lambda kv: -kv[1])[:12]),
          "narrow_fp32": narrow})
    check(all(np.isfinite(losses)) and eval_after < eval_before,
          "bert_gluon_train", "loss not finite or not falling: steps %s, "
          "fp32 loss before %r after %r" % (losses, eval_before, eval_after))
    check(kept, "bert_gluon_train", "a parameter changed its dtype")
    check(device_ms > 0 and update.get("calls") == 1, "bert_gluon_train",
          "the profiler saw no device time or no fused_step.update range")
    fi, cc = narrow["fused_vs_imperative"], narrow["card_vs_cpu"]
    check(fi["excess"] <= 0 and np.isfinite(fi["losses"]).all(),
          "bert_gluon_train", "narrow: FusedTrainStep and Trainer.step "
          "differ beyond rtol %g / atol %g (max abs %g)"
          % (FUSED_RTOL, FUSED_ATOL, fi["max_abs_diff"]))
    check(cc["grads"]["median"] <= cc["median_limit"]
          and cc["grads"]["max"] <= cc["max_limit"], "bert_gluon_train",
          "narrow: step 1's gradients vs the CPU: %s" % cc["grads"])
    check(cc["params_rel_max"] <= NARROW_PARAM_REL, "bert_gluon_train",
          "narrow: parameters after %d steps vs the CPU: %s"
          % (NARROW_STEPS, cc["params_worst_leaves"]))
    return launches


# ---------------------------------------------------------------------------
# main path 6: sparse embeddings (kernel #11)
# ---------------------------------------------------------------------------
SPARSE_KERNELS = ("segment_sum",)
SPARSE_VOCAB, SPARSE_DIM, SPARSE_NNZ, SPARSE_STEPS = 1_000_000, 64, 8192, 20
SPARSE_REL = 1e-6               # table vs the CPU replay, over its max abs:
                                # each row takes one gradient a step, so the
                                # same fp32 ops give the same bits
DLRM_REL = 1e-5                 # loss, towers and tables vs the CPU: fp32
                                # matmuls sum in another order
# facebookresearch/dlrm bench/dlrm_s_criteo_kaggle.sh: the 26 Criteo Kaggle
# vocab sizes, --arch-sparse-feature-size=16, --arch-mlp-bot=13-512-256-64-16,
# --arch-mlp-top=512-256-1 (dot interaction: 16 + 27 * 26 / 2 = 367 wide),
# --mini-batch-size=128, --test-mini-batch-size=16384
KAGGLE_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                 7046547, 18, 15, 286181, 105, 142572)
DLRM_BATCH, DLRM_TEST_BATCH, DLRM_STEPS, DLRM_CPU_STEPS = 128, 16384, 10, 3
SEGSUM_MAIN = [
    # name, nnz, row, num_segments, ids: the table update of a bench_sparse
    # push (8192 ascending ids into the 1,000,000 rows and the scratch
    # row) and of the largest Kaggle table at batch 128
    ("sparse_embed_update", 8192, (64,), SPARSE_VOCAB + 1, "unique"),
    ("dlrm_largest_table", 128, (16,), KAGGLE_VOCABS[2] + 1, "unique"),
    # the factorization machine's CSR dots at batch 1000 x 39 nonzeros,
    # factor 16, both on the presorted route: a row sum (the entries of a
    # row are adjacent) and the gradient's scatter into the 1,000,000
    # feature rows (Criteo-layout zipf ids, duplicates across rows)
    ("fm_dot_rows", 39_000, (16,), 1000, "csr_rows"),
    ("fm_dot_grad", 39_000, (16,), 1_000_000, "csr_cols"),
    # the same for its linear term x.w, one value a row
    ("fm_lin_rows", 39_000, (1,), 1000, "csr_rows"),
    ("fm_lin_grad", 39_000, (1,), 1_000_000, "csr_cols"),
    # matrix factorization's merge of a factor table's row-sparse
    # gradient: merge_rows sums 128 rows of 128 values into their unique
    # ids, by the int64 inverse of a host np.unique (unsorted, 8
    # duplicates): the fused route's 16-byte loads over 32 lanes
    ("mf_merge", 128, (128,), 120, "merge"),
]
# the first shape with shuffled ids, about two of each of 4000 ids: the
# fused route's sort
SEGSUM_SHUFFLED = [("shuffled_8192x64", 8192, (64,), SPARSE_VOCAB + 1,
                    "shuffled")]
SEGSUM_SHUFFLED_IDS = 4000
# #11's bound: its bytes over the card's write rate, the HBM rate. No zero
# fill of 256 MB or more beats it on an H100 by events
# (tools/kernel_times.py: cudaMemsetAsync and zero_ reach 3.1-3.27 TB/s);
# the device times that read faster came from profiler windows that had
# dropped kernel records, which device_ms now counts. (A fill that L2
# holds, 32 MB, does finish faster by device time.)
SEGSUM_WRITE_RATE = PEAK_BYTES


def profile_window(fn, per_kernel=False):
    """fn() under torch.profiler: its wall time, the device time of its
    kernels, the kernels the profiler saw, the idle share (one stream) and
    the top kernels; with `per_kernel`, {kernel: (launches seen, device
    ms)} too."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top, per = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        top[ev.key[:120]] = top.get(ev.key[:120], 0.0) + us / 1e3
        seen, total = per.get(ev.key, (0, 0.0))
        per[ev.key] = (seen + ev.count, total + us / 1e3)
    device_ms = sum(top.values())
    rec = {"wall_ms": wall_ms, "device_ms": device_ms,
           "kernel_count": sum(seen for seen, _ in per.values()),
           "idle_share": 1.0 - device_ms / wall_ms,
           "top_kernels_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}
    if per_kernel:
        rec["per_kernel"] = per
    return rec


def segsum_ids(rng, nnz, segments, sort, low=0, unique=False):
    """Ids in [low, segments) with many duplicates, or ascending unique
    ids below the last segment (the main paths' case)."""
    if unique:
        return np.sort(rng.choice(segments - 1, size=nnz, replace=False))
    ids = rng.randint(low, segments, size=nnz)
    return np.sort(ids) if sort else ids


def phase_kernel_segment_sum(gen):
    """Kernel #11 against its plain version (run on the CPU, where it adds
    in occurrence order), bit for bit, over dtypes, id dtypes, widths,
    sorted and shuffled ids with many duplicates, all-equal ids, negative
    and out-of-range ids, nnz 0 and nnz at the edge of the fused route,
    each with the route it took (segment_sum_plan) and two launches
    bit-equal; then at the main paths' shapes, timed beside its bound,
    torch's index_add_ (atomics) on the same non-negative ids and
    cudaMemsetAsync of the same output bytes; and at the first main shape
    with shuffled, duplicated ids."""
    import ctypes

    from mxnet_tpu_torch.test_utils import CRITEO_FIELDS, criteo_ids
    from mxnet_tpu_torch.ops._build import bind
    from mxnet_tpu_torch.ops.sparse_ops import (FUSED_MAX_NNZ,
                                                _segment_sum_plain,
                                                segment_sum, segment_sum_plan)
    rng = np.random.RandomState(0)
    cases, worst, routes = [], 0.0, {}

    def held(vals, ids, segments, what):
        nonlocal worst
        vc, ic = vals.cuda(), ids.cuda()
        got, variant = launched_variant(lambda: segment_sum(vc, ic,
                                                            segments))
        again = segment_sum(vc, ic, segments)
        torch.cuda.synchronize()
        want = _segment_sum_plain(vals, ids, segments)
        plan = segment_sum_plan(vals.shape[0], math.prod(vals.shape[1:]),
                                vals.dtype, vc.data_ptr() % 16 == 0)
        ok = got.shape == want.shape and got.dtype == want.dtype \
            and torch.equal(got, again) \
            and variant == ["segment_sum/" + plan.variant]
        if ok and want.numel():
            got = got.cpu()
            worst = max(worst, (got.float() - want.float()).abs().max()
                        .item())
            ok = ulps_apart(got, want).max().item() == 0
        cases.append(what)
        routes[plan.variant] = routes.get(plan.variant, 0) + 1
        check(ok, "kernel_segment_sum", "kernel differs from the plain "
              "version, between launches, or took another route than %s "
              "(%s; took %s)" % (plan.variant, what, variant))

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for id_dtype in (torch.int32, torch.int64):
            for row in ((1,), (3,), (16,), (64,), (65,), (128,), (129,),
                        (3, 43)):
                for sort, low in ((True, 0), (False, -3)):
                    ids = torch.from_numpy(segsum_ids(rng, 4096, 600, sort,
                                                      low)).to(id_dtype)
                    vals = torch.randn((4096,) + row, generator=gen,
                                       device="cuda").cpu().to(dtype)
                    held(vals, ids, 1000, (str(dtype), str(id_dtype), row,
                                           sort, low))
            held(torch.zeros((0, 7), dtype=dtype),
                 torch.zeros((0,), dtype=id_dtype), 33, (str(dtype), "nnz 0"))
            held(torch.randn((300, 5), generator=gen, device="cuda").cpu()
                 .to(dtype), torch.full((300,), 4, dtype=id_dtype), 10 ** 6,
                 (str(dtype), "one run, segments far above the ids"))
            held(torch.randn((2000, 64), generator=gen, device="cuda").cpu()
                 .to(dtype), torch.full((2000,), 999, dtype=id_dtype), 1000,
                 (str(dtype), str(id_dtype), "all ids equal, the last row"))
            # ids past the last segment (and, as int64, past int32's range)
            far = rng.randint(-5, 1300, size=3000).astype(np.int64)
            if id_dtype == torch.int64:
                far[::7] = 2 ** 33 + 17
                far[::11] = -2 ** 40
            held(torch.randn((3000, 16), generator=gen, device="cuda").cpu()
                 .to(dtype), torch.from_numpy(far).to(id_dtype), 1000,
                 (str(dtype), str(id_dtype), "ids out of range"))
    # the fused route's edge
    for nnz, sort, width in ((FUSED_MAX_NNZ, True, 16),
                             (FUSED_MAX_NNZ, False, 16),
                             (FUSED_MAX_NNZ + 1, False, 16),
                             (FUSED_MAX_NNZ + 1, True, 1),
                             (FUSED_MAX_NNZ + 1, False, 1)):
        held(torch.randn((nnz, width), generator=gen, device="cuda").cpu(),
             torch.from_numpy(segsum_ids(rng, nnz, 5000, sort)).to(
                 torch.int32), 5000, ("nnz", nnz, "width", width,
                                      "sorted" if sort else "shuffled"))
    # cudaMemsetAsync of an output's bytes: the fill's yardstick
    _, memset_fn = bind("segment_sum", "mx_memset_zero",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])

    def yardstick(fn):
        """fn by event time and under the profiler (device time per call,
        and the kernels the profiler saw in its 20 calls)."""
        for _ in range(5):
            fn()
        win = profile_window(lambda: [fn() for _ in range(20)],
                             per_kernel=True)
        return {"ms": time_ms(fn, iters=20),
                "device_ms": per_call_ms(win["per_kernel"], 20),
                "kernels_seen": win["kernel_count"]}

    main = {}
    for name, nnz, row, segments, kind in SEGSUM_MAIN + SEGSUM_SHUFFLED:
        if kind == "unique":
            ids = torch.from_numpy(segsum_ids(rng, nnz, segments, True,
                                              unique=True)).to(torch.int32)
        elif kind == "csr_rows":
            ids = torch.arange(segments, dtype=torch.int32) \
                .repeat_interleave(nnz // segments)
        elif kind == "csr_cols":
            ids = torch.from_numpy(criteo_ids(rng, nnz // CRITEO_FIELDS,
                                              segments).reshape(-1)).to(
                torch.int32)
        elif kind == "merge":
            users = rng.choice(MF_USERS, segments, replace=False)
            raw = rng.permutation(np.concatenate(
                [users, users[:nnz - segments]]))
            ids = torch.from_numpy(np.unique(raw, return_inverse=True)[1]
                                   .reshape(-1).astype(np.int64))
        else:
            ids = torch.from_numpy(rng.randint(0, SEGSUM_SHUFFLED_IDS,
                                               size=nnz)).to(torch.int32)
        vals = torch.randn((nnz,) + row, generator=gen, device="cuda")
        held(vals.cpu(), ids, segments, name)
        ids_c, ids64 = ids.cuda(), ids.cuda().long()
        # the output written once, the values and ids read once
        out_bytes = segments * row[0] * vals.element_size()
        nbytes = out_bytes + nnz * row[0] * vals.element_size() \
            + nnz * ids.element_size()
        _, variant = launched_variant(lambda: segment_sum(vals, ids_c,
                                                          segments))
        rec = {
            "nnz": nnz, "row": list(row), "num_segments": segments,
            "ids": kind, "variant": variant,
            "plan": segment_sum_plan(nnz, row[0], vals.dtype,
                                     vals.data_ptr() % 16 == 0)._asdict(),
            # the whole wrapper call by event time, and its kernels' device
            # time
            "ms": time_ms(lambda: segment_sum(vals, ids_c, segments),
                          iters=20),
            "device_ms": device_ms(lambda: segment_sum(vals, ids_c,
                                                       segments)),
            "plain_ms": time_ms(lambda: _segment_sum_plain(
                vals, ids_c, segments), iters=20),
            "bound_ms": nbytes / SEGSUM_WRITE_RATE * 1e3,
            "bound_by": "bytes", "bytes": nbytes}
        if kind != "shuffled":
            out = torch.zeros((segments,) + row, device="cuda")

            def fill_and_add():
                return torch.zeros((segments,) + row,
                                   device="cuda").index_add_(0, ids64, vals)
            # yardsticks: zeros + index_add_ (the same function, allocation
            # included), cudaMemsetAsync of the output's bytes, and
            # index_add_ alone into a buffer zeroed outside the timed call
            # (its sums pile up across calls, which does not change its
            # work), by device time
            lib = yardstick(fill_and_add)
            mem = yardstick(lambda: memset_fn(
                out.data_ptr(), out_bytes,
                torch.cuda.current_stream().cuda_stream))
            rec.update({
                "library_ms": lib["ms"],
                "library_fill_device_ms": lib["device_ms"],
                "library_kernels_seen": lib["kernels_seen"],
                "memset_ms": mem["ms"], "memset_device_ms": mem["device_ms"],
                "memset_kernels_seen": mem["kernels_seen"],
                "library_device_ms": device_ms(
                    lambda: out.index_add_(0, ids64, vals))})
            del out
        main[name] = rec
        route = "presorted" if nnz > FUSED_MAX_NNZ else "fused"
        check(variant == ["segment_sum/" + route], "kernel_segment_sum",
              "%s took %s, not the %s route" % (name, variant, route))
        if kind == "merge":
            check(rec["plan"]["vec"] == 4 and rec["plan"]["lanes"] == 32,
                  "kernel_segment_sum", "%s planned %s, not 16-byte loads "
                  "over 32 lanes" % (name, rec["plan"]))
    emit({"phase": "kernel_segment_sum", "cases": len(cases),
          "routes": routes, "max_abs_err": worst, "main_shapes": main})
    head = main[SEGSUM_MAIN[0][0]]
    return {"max_abs_err": worst, "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "library_ms": head["library_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes"}


def sparse_traffic(seed=0):
    """bench_sparse's traffic: zipf(1.3) ids modulo the vocab, unique per
    step, and fp32 gradient rows, from RandomState(seed) in its order
    (bench_sparse's own is seed 0)."""
    rng = np.random.RandomState(seed)
    raw = rng.zipf(1.3, size=(SPARSE_STEPS, SPARSE_NNZ)).astype(np.int64) \
        % SPARSE_VOCAB
    batches = [np.unique(b).astype(np.int32) for b in raw]
    return [(ids, rng.randn(len(ids), SPARSE_DIM).astype(np.float32))
            for ids in batches]


def sparse_loop(mx, kv, ctx, traffic, lookup_ms=None, pulls=None):
    """bench_sparse's loop: push each step's row-sparse gradient, then
    row_sparse_pull its first 256 ids (or the step's ids in `pulls`).
    Returns the last pull."""
    sp = mx.nd.sparse
    out = None
    for i, (ids, grads) in enumerate(traffic):
        kv.push(0, sp.RowSparseNDArray(grads, ids,
                                       (SPARSE_VOCAB, SPARSE_DIM), ctx=ctx))
        out = sp.zeros("row_sparse", (SPARSE_VOCAB, SPARSE_DIM), ctx=ctx)
        t1 = time.perf_counter()
        kv.row_sparse_pull(0, out=out, row_ids=mx.nd.array(
            ids[:256] if pulls is None else pulls[i], ctx=ctx,
            dtype="int32"))
        if lookup_ms is not None:
            torch.cuda.synchronize()
            lookup_ms.append((time.perf_counter() - t1) * 1e3)
    return out


def phase_sparse_embed():
    """bench.py::bench_sparse's loop at its accelerator shape on the card:
    kv.create("local"), ShardedEmbedding(1,000,000, 64, sgd, lr 0.1),
    init_embedding, 20 steps of push + row_sparse_pull; the table and the
    last pull held against the same 20 steps on the CPU. Returns the
    launches of the 20 steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.embedding import ShardedEmbedding
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    traffic = sparse_traffic()
    gpu = mx.gpu(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    table = ShardedEmbedding(SPARSE_VOCAB, SPARSE_DIM, optimizer="sgd",
                             learning_rate=0.1, name="bench.sparse")
    w0 = table.weight.cpu()
    kv = mx.kv.create("local")
    kv.init_embedding(0, table, max_batch=SPARSE_NNZ)
    telemetry.reset()
    lookup_ms = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    pulled = sparse_loop(mx, kv, gpu, traffic, lookup_ms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    variants = variant_counts()
    counters = telemetry.snapshot()["counters"]
    peak = torch.cuda.max_memory_allocated()
    got = table.gathered_weight().cpu()
    # the same 20 steps on the CPU, from the same table
    ctable = ShardedEmbedding(SPARSE_VOCAB, SPARSE_DIM, optimizer="sgd",
                              learning_rate=0.1, device="cpu", weight=w0)
    ckv = mx.kv.create("local")
    ckv.init_embedding(0, ctable, max_batch=SPARSE_NNZ)
    cpulled = sparse_loop(mx, ckv, mx.cpu(), traffic)
    want = ctable.gathered_weight()
    diff = (got - want).abs()
    err = diff.max().item()
    limit = SPARSE_REL * want.abs().max().item()
    worst_row = int(diff.max(dim=1).values.argmax())
    pushed = sum(len(ids) for ids, _ in traffic)
    prof = profile_window(lambda: sparse_loop(mx, kv, gpu, traffic[:2]))
    lookup_ms.sort()
    rec = {"phase": "sparse_embed", "vocab": SPARSE_VOCAB,
           "dim": SPARSE_DIM, "ids_per_step": SPARSE_NNZ,
           "steps": SPARSE_STEPS, "pushed_rows": pushed,
           "pushed_rows_per_s": pushed / dt, "seconds": dt,
           "lookup_ms_p50": lookup_ms[len(lookup_ms) // 2],
           "lookup_ms_p99": lookup_ms[min(len(lookup_ms) - 1,
                                          int(0.99 * len(lookup_ms)))],
           "serve_retraces": counters.get("serve.retrace", 0),
           "unique_rows": counters.get("embedding.push.unique_rows", 0),
           "launches": {k: v for k, v in launches.items() if v},
           "variants": {"%s/%s" % k: n for k, n in variants.items()},
           "max_memory_allocated_bytes": peak,
           "table_vs_cpu_max_abs": err, "table_vs_cpu_limit": limit,
           "table_vs_cpu_ulps": ulps_apart(got, want).max().item(),
           "worst_row": worst_row, "profile_2_steps": prof}
    emit(rec)
    check(launches == {k: (2 * SPARSE_STEPS if k in SPARSE_KERNELS else 0)
                       for k in launches}, "sparse_embed",
          "launches %s, expected 2 segment_sum a push and nothing else"
          % launches)
    check(variants == {("segment_sum", "fused"): 2 * SPARSE_STEPS},
          "sparse_embed", "segment_sum launches took %s, expected all %d "
          "on the fused route" % (variants, 2 * SPARSE_STEPS))
    check(rec["serve_retraces"] == 0, "sparse_embed", "pulls retraced")
    check(rec["unique_rows"] == pushed, "sparse_embed",
          "unique rows %s, pushed %s" % (rec["unique_rows"], pushed))
    check(bool(torch.isfinite(got).all()) and err <= limit, "sparse_embed",
          "table differs from the CPU replay by %s (limit %s) at row %d"
          % (err, limit, worst_row))
    check(torch.equal(pulled._indices.cpu(), cpulled._indices)
          and torch.equal(pulled._values.cpu(), cpulled._values),
          "sparse_embed", "the last pull differs from the CPU replay's")
    check(prof["device_ms"] > 0, "sparse_embed",
          "the profiler saw no device time")
    return launches


def dlrm_batch(cfg, batch, seed, device):
    """Seeded dense features in [0, 1), zipf(1.3) ids per field modulo its
    vocab, Bernoulli(0.25) labels."""
    rng = np.random.RandomState(seed)
    dense = rng.rand(batch, cfg.dense_dim).astype(np.float32)
    ids = np.stack([rng.zipf(1.3, batch) % v for v in cfg.vocab_sizes],
                   axis=1).astype(np.int32)
    labels = (rng.rand(batch) < 0.25).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (dense, ids, labels))


def dlrm_leaves(towers):
    return [t for layer in towers["bottom"] + towers["top"]
            for t in layer.values()]


def dlrm_step(cfg, towers, tables, batch, lr=0.1):
    """One training step: look the rows up, forward and loss with the rows
    as leaves, backward, apply_grads for each table, SGD on the towers.
    Returns the loss (a 0-d tensor)."""
    from mxnet_tpu_torch.models.dlrm import dlrm_loss
    dense, ids, labels = batch
    rows = [t.lookup(ids[:, f]).requires_grad_()
            for f, t in enumerate(tables)]
    leaves = dlrm_leaves(towers)
    for p in leaves:
        p.requires_grad_(True)
    loss = dlrm_loss(towers, dense, ids, labels, cfg,
                     embed_fn=lambda f, _ids: rows[f])
    loss.backward()
    for f, t in enumerate(tables):
        t.apply_grads(ids[:, f], rows[f].grad)
    with torch.no_grad():
        for p in leaves:
            p -= lr * p.grad
            p.grad = None
    return loss.detach()


def phase_dlrm_train(gen):
    """DLRM at the Criteo Kaggle widths: 26 ShardedEmbedding tables (sgd,
    lr 0.1; 33,762,577 rows of 16) through embed_fn, the towers by plain
    SGD (lr 0.1), 10 steps on one seeded batch of 128; the first 3 steps
    held against the CPU; a forward at batch 16384. Returns the launches of
    the 10 steps."""
    from mxnet_tpu_torch.embedding import ShardedEmbedding
    from mxnet_tpu_torch.models.dlrm import (DLRMConfig, dlrm_forward,
                                             dlrm_init)
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    cfg = DLRMConfig(vocab_sizes=KAGGLE_VOCABS, embed_dim=16, dense_dim=13,
                     bottom_dims=(512, 256, 64), top_dims=(512, 256))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    towers = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       with_tables=False)
    tables = [ShardedEmbedding(v, cfg.embed_dim, optimizer="sgd",
                               learning_rate=0.1, seed=f, name="t%d" % f)
              for f, v in enumerate(cfg.vocab_sizes)]
    table_bytes = sum(t._nbytes() for t in tables)
    cpu_towers = {part: [{k: v.to("cuda", copy=True).cpu()
                          for k, v in layer.items()}
                         for layer in towers[part]]
                  for part in ("bottom", "top")}
    cpu_w0 = [t.weight.cpu() for t in tables]
    batch = dlrm_batch(cfg, DLRM_BATCH, 0, "cuda")
    losses, times, after = [], [], None
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in range(DLRM_STEPS):
        t0 = time.perf_counter()
        loss = dlrm_step(cfg, towers, tables, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if i + 1 == DLRM_CPU_STEPS:
            # each step makes new tables, so these stay the step-3 ones
            after = ([t.weight for t in tables],
                     [p.detach().clone() for p in dlrm_leaves(towers)])
    launches = launch_counts()
    variants = variant_counts()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    # the first 3 steps on the CPU, from the same towers and tables
    ctables = [ShardedEmbedding(v, cfg.embed_dim, optimizer="sgd",
                                learning_rate=0.1, device="cpu", weight=w)
               for v, w in zip(cfg.vocab_sizes, cpu_w0)]
    del cpu_w0
    cbatch = tuple(t.cpu() for t in batch)
    closses = [dlrm_step(cfg, cpu_towers, ctables, cbatch).item()
               for _ in range(DLRM_CPU_STEPS)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, closses))
    table_err, touched = 0.0, 0
    for f, (w_card, ct) in enumerate(zip(after[0], ctables)):
        rows = torch.unique(cbatch[1][:, f].long())
        scale = ct.weight[rows].abs().max().item()
        # over the whole table: the untouched rows must be equal too
        table_err = max(table_err, (w_card.cpu() - ct.weight).abs().max()
                        .item() / scale)
        touched += rows.numel()
    tower_err = max(rel_err(a.cpu(), b) for a, b in
                    zip(after[1], dlrm_leaves(cpu_towers)))
    del ctables, cpu_towers, after
    prof = profile_window(lambda: [dlrm_step(cfg, towers, tables, batch)
                                   for _ in range(2)])
    # one forward at the script's test batch
    tb = dlrm_batch(cfg, DLRM_TEST_BATCH, 1, "cuda")

    def forward():
        with torch.no_grad():
            return dlrm_forward(towers, tb[0], tb[1], cfg,
                                embed_fn=lambda f, ids: tables[f].lookup(ids))

    logits = forward()
    fwd_ms = time_ms(forward, iters=5, warmup=1)
    rec = {"phase": "dlrm_train", "config": "dlrm_s_criteo_kaggle",
           "tables": cfg.n_fields, "rows": sum(cfg.vocab_sizes),
           "table_bytes": table_bytes, "batch": DLRM_BATCH,
           "losses": losses, "step_ms": times, "step_ms_median_2_10": med,
           "examples_per_s": DLRM_BATCH / med * 1e3,
           "launches": {k: v for k, v in launches.items() if v},
           "variants": {"%s/%s" % k: n for k, n in variants.items()},
           "max_memory_allocated_bytes": peak,
           "cpu_losses": closses, "loss_rel_err_vs_cpu": loss_err,
           "table_err_vs_cpu": table_err, "touched_rows_checked": touched,
           "tower_rel_err_vs_cpu": tower_err,
           "forward_batch": DLRM_TEST_BATCH, "forward_ms": fwd_ms,
           "forward_examples_per_s": DLRM_TEST_BATCH / fwd_ms * 1e3,
           "profile_2_steps": prof}
    emit(rec)
    per_step = 2 * cfg.n_fields
    check(launches == {k: (per_step * DLRM_STEPS if k in SPARSE_KERNELS
                           else 0) for k in launches}, "dlrm_train",
          "launches %s, expected %d segment_sum a step and nothing else"
          % (launches, per_step))
    check(variants == {("segment_sum", "fused"): per_step * DLRM_STEPS},
          "dlrm_train", "segment_sum launches took %s, expected all %d on "
          "the fused route" % (variants, per_step * DLRM_STEPS))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "dlrm_train", "losses not finite or not falling: %s" % losses)
    check(loss_err <= DLRM_REL and table_err <= DLRM_REL
          and tower_err <= DLRM_REL, "dlrm_train",
          "3 steps differ from the CPU: loss %s, tables %s, towers %s"
          % (loss_err, table_err, tower_err))
    check(logits.shape == (DLRM_TEST_BATCH,)
          and bool(torch.isfinite(logits).all()), "dlrm_train",
          "forward at batch %d: shape %s or not finite"
          % (DLRM_TEST_BATCH, tuple(logits.shape)))
    check(prof["device_ms"] > 0, "dlrm_train",
          "the profiler saw no device time")
    return launches


# ---------------------------------------------------------------------------
# main paths 8 and 9: Gluon-sparse (kernels #11 and #7)
# ---------------------------------------------------------------------------
# the factorization machine (BASELINE config 4): the Criteo display-ad set
# as the LIBSVM datasets page publishes it (1,000,000 features, 13 integer
# and 26 categorical fields, 39 nonzeros a row); factor size 16 and batch
# 1000 (taken as upstream example/sparse/factorization_machine/train.py's
# defaults); a seeded file of 13,000 rows: 3 warm-up and 10 timed steps
FM_FEATURES, FM_FACTOR, FM_BATCH = 1_000_000, 16, 1000
FM_ROWS, FM_WARMUP, FM_STEPS = 13_000, 3, 10
# narrow copies, card vs CPU (features, factor, batch): the second's
# 450 x 39 = 17,550 entries take #11's presorted route, as the path does
FM_NARROW = ((2000, 4, 50), (2000, 4, 450))
FM_LAUNCHES = 6                          # a step: 3 CSR dots + 3 gradients
# matrix factorization through Gluon: MovieLens-10M's id ranges (the
# upstream example's max_user / max_movie), factor 128 and batch 128 (taken
# as that example's defaults), SGD lr 0.1, momentum 0.9, lazy_update; 512
# seeded low-rank ratings, 4 batches cycled: 3 warm-up and 20 timed steps
MF_USERS, MF_ITEMS, MF_FACTOR, MF_BATCH = 71_569, 65_135, 128, 128
MF_OBS, MF_WARMUP, MF_STEPS = 4 * 128, 3, 20
# narrow copies (users, items, factor, batch): the second at the path's
# factor 128, whose gradient merges take the fused route's 16-byte loads
# over 32 lanes
MF_NARROW = ((60, 50, 8, 16), (60, 50, 128, 16))
MF_KERNELS = ("segment_sum", "flat_sgd")
MF_TABLES = 4
GLUON_SPARSE_REL = 1e-5                  # card vs CPU, 3 narrow steps: per
                                         # leaf over its max abs, and the
                                         # losses; fp32 both sides


def count_syncs(fn):
    """fn()'s result and the host syncs torch's sync debug mode reported
    during it (device-to-host copies, stream waits)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def leaf_rel(card, host):
    """Max abs difference over the host leaf's max abs."""
    card, host = card.detach().cpu(), host.detach().cpu()
    return (card - host).abs().max().item() / max(host.abs().max().item(),
                                                   1e-30)


def fm_run(mx, path, features, factor, batch, steps, ctx):
    """`steps` FM steps from the file at `path` on `ctx`; returns the
    losses and (w, v, b)."""
    from mxnet_tpu_torch.models import factorization as fz
    with ctx:
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=features,
                              batch_size=batch)
        w, v, b = fz.fm_init(features, factor, seed=0)
        kv = mx.kv.create("local")
        fz.fm_store(kv, w, v, batch)
        losses = [float(fz.fm_step(kv, next(it), w, v, b, batch).asnumpy())
                  for _ in range(steps)]
    return losses, (w, v, b)


def fm_narrow(mx, tmp, shape):
    """A narrow FM for 3 steps on the card and on the CPU, with the
    kernel variants the card's steps took (the CPU launches none)."""
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    from mxnet_tpu_torch.test_utils import criteo_libsvm
    features, factor, batch = shape
    path = os.path.join(tmp, "fm_narrow_%d.libsvm" % batch)
    criteo_libsvm(path, 3 * batch, features, seed=1)
    reset_launch_counts()
    card = fm_run(mx, path, features, factor, batch, 3, mx.gpu(0))
    host = fm_run(mx, path, features, factor, batch, 3, mx.cpu())
    return {"shape": list(shape), "card_losses": card[0],
            "cpu_losses": host[0],
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(card[0], host[0])),
            "leaf_rel": [leaf_rel(a._data, b._data)
                         for a, b in zip(card[1], host[1])],
            "variants": {"%s/%s" % k: n
                         for k, n in variant_counts().items()}}


def phase_gluon_sparse_fm(tmp):
    """Main path 8: the factorization machine at the Criteo widths. A
    seeded libsvm file of 13,000 rows (written before the timed window),
    LibSVMIter, 3 warm-up and 10 timed steps of models.factorization's
    fm_step (the reference's loop), the iterator's next() inside the
    window; the host syncs of a step, a profiled step, and the narrow
    copy against the CPU. Returns the launches of the timed steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import factorization as fz
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from mxnet_tpu_torch.test_utils import criteo_libsvm
    path = os.path.join(tmp, "criteo.libsvm")
    t0 = time.perf_counter()
    criteo_libsvm(path, FM_ROWS, FM_FEATURES, seed=0)
    write_s = time.perf_counter() - t0
    gpu = mx.gpu(0)
    torch.cuda.empty_cache()
    with gpu:
        t0 = time.perf_counter()
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=FM_FEATURES,
                              batch_size=FM_BATCH)
        parse_s = time.perf_counter() - t0
        w, v, b = fz.fm_init(FM_FEATURES, FM_FACTOR, seed=0)
        kv = mx.kv.create("local")
        fz.fm_store(kv, w, v, FM_BATCH)

        def step():
            t1 = time.perf_counter()
            batch = next(it)
            iter_s.append(time.perf_counter() - t1)
            return float(fz.fm_step(kv, batch, w, v, b, FM_BATCH).asnumpy())

        iter_s, losses = [], []
        for i in range(FM_WARMUP):
            if i + 1 < FM_WARMUP:
                losses.append(step())
            else:
                loss, syncs = count_syncs(step)
                losses.append(loss)
        iter_s.clear()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(FM_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            losses.append(step())
            end.record()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches = launch_counts()
        variants = variant_counts()
        peak = torch.cuda.max_memory_allocated()
        step_ms = [s.elapsed_time(e) for s, e in events]
        dtypes = [str(p._data.dtype) for p in (w, v, b)]
        it.reset()
        prof = profile_window(step, per_kernel=True)
    narrow = [fm_narrow(mx, tmp, shape) for shape in FM_NARROW]
    segsum_ms = sum(total for name, (_, total) in prof["per_kernel"].items()
                    if "ordered_sums" in name or "fill_zero" in name)
    rec = {"phase": "gluon_sparse_fm", "features": FM_FEATURES,
           "factor": FM_FACTOR, "batch": FM_BATCH, "nnz_per_row": 39,
           "file_rows": FM_ROWS, "write_s": write_s, "parse_s": parse_s,
           "steps": FM_STEPS, "examples_per_s":
               FM_STEPS * FM_BATCH / window_s, "window_s": window_s,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "iterator_host_ms": [s * 1e3 for s in iter_s[:FM_STEPS]],
           "host_syncs_per_step": syncs,
           "max_memory_allocated_bytes": peak, "losses": losses,
           "launches": {k: n for k, n in launches.items() if n},
           "variants": {"%s/%s" % k: n for k, n in variants.items()},
           "dtypes": dtypes,
           "profile_one_step": {k: prof[k] for k in prof
                                if k != "per_kernel"},
           "segment_sum_device_ms_one_step": segsum_ms,
           "narrow_vs_cpu": narrow}
    emit(rec)
    n = FM_LAUNCHES * FM_STEPS
    check(launches == {k: (n if k in SPARSE_KERNELS else 0)
                       for k in launches},
          "gluon_sparse_fm", "launches %s, expected %d segment_sum a step "
          "and nothing else" % (launches, FM_LAUNCHES))
    check(variants == {("segment_sum", "presorted"): n}, "gluon_sparse_fm",
          "segment_sum took %s, expected all %d presorted (nnz 39,000 > "
          "16384)" % (variants, n))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "gluon_sparse_fm", "losses not finite or not falling: %s" % losses)
    check(dtypes == ["torch.float32"] * 3, "gluon_sparse_fm",
          "dtypes changed: %s" % dtypes)
    for nar in narrow:
        check(nar["loss_rel"] <= GLUON_SPARSE_REL
              and max(nar["leaf_rel"]) <= GLUON_SPARSE_REL,
              "gluon_sparse_fm", "narrow FM on the card vs the CPU: %s" % nar)
    # the wide copy on the path's route: 6 launches a step, 3 steps
    check(narrow[1]["variants"] == {"segment_sum/presorted":
                                    FM_LAUNCHES * 3}, "gluon_sparse_fm",
          "the narrow FM at batch %d took %s, not the presorted route"
          % (FM_NARROW[1][2], narrow[1]["variants"]))
    check(prof["device_ms"] > 0 and segsum_ms > 0, "gluon_sparse_fm",
          "the profiler saw no device time or no segment_sum kernel")
    return launches


def mf_tables(net, seed):
    """Seeded N(0, 0.1) tables for MFNet's parameters, in name order."""
    rng = np.random.RandomState(seed)
    return {name: rng.normal(0, 0.1, p.shape).astype(np.float32)
            for name, p in sorted(net.collect_params().items())}


def mf_setup(mx, users, items, factor, ctx, seed=0):
    """MFNet on `ctx` with seeded tables, L2Loss and the path's Trainer."""
    from mxnet_tpu_torch.models.factorization import MFNet
    net = MFNet(users, items, k=factor)
    net.initialize(ctx=ctx)
    init = mf_tables(net, seed)
    for name, p in net.collect_params().items():
        p.set_data(mx.nd.array(init[name], ctx=ctx))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "lazy_update": True})
    return net, mx.gluon.loss.L2Loss(), trainer, init


def mf_batches(mx, data, batch, steps, ctx):
    users, items, ratings = data
    n = len(users) // batch
    out = []
    for s in range(steps):
        sl = slice((s % n) * batch, (s % n + 1) * batch)
        out.append((mx.nd.array(users[sl], ctx=ctx, dtype="int32"),
                    mx.nd.array(items[sl], ctx=ctx, dtype="int32"),
                    mx.nd.array(ratings[sl], ctx=ctx)))
    return out


def mf_step(mx, net, loss_fn, trainer, batch, host_ms=None):
    u, i, r = batch
    with mx.autograd.record():
        loss = loss_fn(net(u, i), r)
    loss.backward()
    t0 = time.perf_counter()
    trainer.step(u.shape[0])
    if host_ms is not None:
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return float(loss.mean().asnumpy())


def mf_narrow(mx, shape):
    """A narrow MF for 3 steps on the card and on the CPU, with the
    kernel variants the card's steps took (the CPU launches none) and the
    plan of a factor table's gradient merge."""
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    from mxnet_tpu_torch.ops.sparse_ops import segment_sum_plan
    from mxnet_tpu_torch.test_utils import synthetic_ratings
    users, items, factor, batch = shape
    data = synthetic_ratings(users, items, 3 * batch, seed=1)[:3]
    runs = []
    reset_launch_counts()
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            net, loss_fn, trainer, _ = mf_setup(mx, users, items, factor,
                                                ctx, seed=1)
            losses = [mf_step(mx, net, loss_fn, trainer, bt) for bt in
                      mf_batches(mx, data, batch, 3, ctx)]
            # by name without the net's prefix, which counts nets
            runs.append((losses, {k[len(net.prefix):]: p.data()._data
                                  for k, p in net.collect_params().items()}))
    (cl, cp), (hl, hp) = runs
    return {"shape": list(shape), "card_losses": cl, "cpu_losses": hl,
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(cl, hl)),
            "leaf_rel": {k: leaf_rel(cp[k], hp[k]) for k in hp},
            "variants": {"%s/%s" % k: n
                         for k, n in variant_counts().items()},
            "factor_merge_plan": segment_sum_plan(
                batch, factor, torch.float32)._asdict()}


def phase_gluon_sparse_mf():
    """Main path 9: matrix factorization through Gluon at MovieLens-10M's
    id ranges. MFNet (four Embedding(sparse_grad=True) tables), L2Loss,
    Trainer("sgd", lr 0.1, momentum 0.9, lazy_update): 3 warm-up and 20
    timed steps; Trainer.step's host time, a profiled step, the rows no
    batch touched (and their momentum) bit-unchanged, the narrow copy
    against the CPU. Returns the launches of the timed steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.test_utils import synthetic_ratings
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    gpu = mx.gpu(0)
    torch.cuda.empty_cache()
    data = synthetic_ratings(MF_USERS, MF_ITEMS, MF_OBS)[:3]
    with gpu:
        net, loss_fn, trainer, init = mf_setup(mx, MF_USERS, MF_ITEMS,
                                               MF_FACTOR, gpu)
        batches = mf_batches(mx, data, MF_BATCH, MF_WARMUP + MF_STEPS, gpu)
        losses, host_ms = [], []
        for i, bt in enumerate(batches[:MF_WARMUP]):
            if i + 1 < MF_WARMUP:
                losses.append(mf_step(mx, net, loss_fn, trainer, bt))
            else:
                loss, syncs = count_syncs(
                    lambda: mf_step(mx, net, loss_fn, trainer, bt))
                losses.append(loss)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(MF_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for (start, end), bt in zip(events, batches[MF_WARMUP:]):
            start.record()
            losses.append(mf_step(mx, net, loss_fn, trainer, bt, host_ms))
            end.record()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches = launch_counts()
        variants = variant_counts()
        peak = torch.cuda.max_memory_allocated()
        step_ms = [s.elapsed_time(e) for s, e in events]
        # rows no batch touched: weights and momentum as they were
        params = dict(net.collect_params().items())
        states = trainer._updaters[0].states
        ids_of = {net.user.weight.name: data[0], net.user_b.weight.name:
                  data[0], net.item.weight.name: data[1],
                  net.item_b.weight.name: data[1]}
        untouched = {}
        for name, p in params.items():
            rest = np.setdiff1d(np.arange(p.shape[0]), ids_of[name])
            idx = torch.from_numpy(rest).cuda()
            w = p.data().data_torch[idx].cpu().numpy()
            mom = states[trainer._param2idx[name]]._data[idx]
            untouched[name] = {
                "rows": int(len(rest)),
                "weights_equal": bool(np.array_equal(w, init[name][rest])),
                "momentum_zero": bool((mom == 0).all().item())}
        dtypes = [str(p.data()._data.dtype) for p in params.values()]
        prof = profile_window(lambda: mf_step(mx, net, loss_fn, trainer,
                                              batches[0]), per_kernel=True)
    narrow = [mf_narrow(mx, shape) for shape in MF_NARROW]
    n = len(data[0]) // MF_BATCH
    rec = {"phase": "gluon_sparse_mf", "users": MF_USERS,
           "items": MF_ITEMS, "factor": MF_FACTOR, "batch": MF_BATCH,
           "ratings": MF_OBS, "steps": MF_STEPS,
           "examples_per_s": MF_STEPS * MF_BATCH / window_s,
           "window_s": window_s, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms),
           "trainer_step_host_ms": host_ms,
           "trainer_step_host_ms_median": statistics.median(host_ms),
           "host_syncs_per_step": syncs,
           "max_memory_allocated_bytes": peak, "losses": losses,
           "first_cycle_mean": statistics.mean(losses[:n]),
           "last_cycle_mean": statistics.mean(losses[-n:]),
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "dtypes": dtypes, "untouched": untouched,
           "profile_one_step": {k: prof[k] for k in prof
                                if k != "per_kernel"},
           "narrow_vs_cpu": narrow}
    emit(rec)
    per = MF_TABLES * MF_STEPS
    check(launches == {k: (per if k in MF_KERNELS else 0) for k in launches},
          "gluon_sparse_mf", "launches %s, expected one segment_sum and one "
          "flat_sgd a table a step and nothing else" % launches)
    check(variants == {("segment_sum", "fused"): per,
                       ("flat_sgd", "single"): per}, "gluon_sparse_mf",
          "variants %s, expected %d fused segment_sum and %d single "
          "flat_sgd" % (variants, per, per))
    # 4 batches cycled: the last cycle's losses against the first's (the
    # same batches)
    check(all(np.isfinite(losses))
          and rec["last_cycle_mean"] < rec["first_cycle_mean"],
          "gluon_sparse_mf", "losses not finite or not falling: %s" % losses)
    check(dtypes == ["torch.float32"] * MF_TABLES, "gluon_sparse_mf",
          "dtypes changed: %s" % dtypes)
    check(all(u["weights_equal"] and u["momentum_zero"] and u["rows"] > 0
              for u in untouched.values()), "gluon_sparse_mf",
          "rows no batch touched changed: %s" % untouched)
    for nar in narrow:
        check(nar["loss_rel"] <= GLUON_SPARSE_REL
              and max(nar["leaf_rel"].values()) <= GLUON_SPARSE_REL,
              "gluon_sparse_mf", "narrow MF on the card vs the CPU: %s" % nar)
    # the wide copy's factor merges on the path's plan; 4 tables, 3 steps
    plan = narrow[1]["factor_merge_plan"]
    check(plan["variant"] == "fused" and plan["vec"] == 4
          and plan["lanes"] == 32 and narrow[1]["variants"] == {
              "segment_sum/fused": MF_TABLES * 3,
              "flat_sgd/single": MF_TABLES * 3}, "gluon_sparse_mf",
          "the narrow MF at factor %d planned %s and took %s"
          % (MF_NARROW[1][2], plan, narrow[1]["variants"]))
    check(prof["device_ms"] > 0, "gluon_sparse_mf",
          "the profiler saw no device time")
    return launches



# -- main path 10: the Gluon MLP on MNIST (BASELINE config 1) -------------
MNIST_TRAIN, MNIST_TEST, MNIST_BATCH = 60_000, 10_000, 128
MNIST_STEPS = -(-MNIST_TRAIN // MNIST_BATCH)     # 469, the last of 96
MNIST_SEED = 0
MLP_CPU_STEPS = 3
MLP_CPU_REL = 1e-5              # card vs CPU after 3 steps, per leaf over
                                # its max abs: fp32 both sides, TF32 off
MLP_ACC = 0.9                   # train (over the epoch) and test accuracy


def mlp_net(mx, ctx, seed):
    """examples/mnist_mlp.py's net, Dense 128-64-10 with ReLU, initialized
    on `ctx` from mx.random.seed(seed) (shapes by one predict-mode pass)
    and hybridized."""
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(128, activation="relu"),
            mx.gluon.nn.Dense(64, activation="relu"),
            mx.gluon.nn.Dense(10))
    net.initialize(ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 1, 28, 28), ctx=ctx))
    net.hybridize()
    return net


def mlp_trainer(mx, net):
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})


def mlp_step(mx, net, loss_fn, trainer, data, label, ctx):
    """The example's step: the batch to `ctx`, record, backward, step."""
    data = data.as_in_context(ctx)
    label = label.as_in_context(ctx)
    with mx.autograd.record():
        out = net(data)
        loss = loss_fn(out, label)
    loss.backward()
    trainer.step(data.shape[0])
    return out, label, loss


def params_of(net):
    return [p.data().data_torch.clone()
            for p in net.collect_params().values()]


def phase_gluon_mlp(tmp):
    """Main path 10: examples/mnist_mlp.py as a user runs it through
    gluon.data.vision.MNIST, at MNIST's size: one epoch of 469 steps with
    the loader's next() inside the window, counts reset just before and
    read just after; then the test set, the same epoch through
    Estimator.fit from the same seed (bit-equal parameters), 3 steps
    against the CPU, a step's host syncs and a profiled step. Returns the
    launches of the epoch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.data.vision import MNIST, transforms
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from mxnet_tpu_torch.test_utils import synthetic_mnist, write_mnist
    gpu, cpu = mx.gpu(0), mx.cpu()
    root = os.path.join(tmp, "mnist")
    os.makedirs(root)
    xtr, ytr, xte, yte = synthetic_mnist(MNIST_TRAIN, MNIST_TEST,
                                         seed=MNIST_SEED)
    write_mnist(root, xtr, ytr, train=True)
    write_mnist(root, xte, yte, train=False)
    train_set = MNIST(root=root, train=True)
    test_set = MNIST(root=root, train=False)
    datasets_on_host = (train_set._data.context == cpu
                        and test_set._data.context == cpu)
    to_tensor = transforms.ToTensor()
    train_data = train_set.transform_first(to_tensor)
    test_data = test_set.transform_first(to_tensor)
    loader = mx.gluon.data.DataLoader(train_data, batch_size=MNIST_BATCH,
                                      shuffle=True)
    net = mlp_net(mx, gpu, MNIST_SEED)
    init = params_of(net)
    init_path = os.path.join(tmp, "mlp_init.params")
    net.save_parameters(init_path)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mlp_trainer(mx, net)
    metric = mx.metric.Accuracy()
    losses, load_ms, metric_ms, wall_ms, first = [], [], [], [], []
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(MNIST_STEPS)]
    syncs0 = telemetry.counter_value("metric.host_syncs")
    np.random.seed(MNIST_SEED)
    it = iter(loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_start = time.perf_counter()
    for start, end in events:
        t0 = time.perf_counter()
        start.record()
        data, label = next(it)
        t1 = time.perf_counter()
        if len(first) < MLP_CPU_STEPS:
            first.append((data, label))
        out, lab, loss = mlp_step(mx, net, loss_fn, trainer, data, label,
                                  gpu)
        t2 = time.perf_counter()
        metric.update([lab], [out])
        t3 = time.perf_counter()
        end.record()
        losses.append(loss.mean())
        load_ms.append((t1 - t0) * 1e3)
        metric_ms.append((t3 - t2) * 1e3)
        wall_ms.append((t3 - t0) * 1e3)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    launches = launch_counts()
    variants = variant_counts()
    peak = torch.cuda.max_memory_allocated()
    epoch_over = next(it, None) is None
    metric_syncs = (telemetry.counter_value("metric.host_syncs")
                    - syncs0) / MNIST_STEPS
    losses = [float(v.asscalar()) for v in losses]
    train_acc = metric.get()[1]
    step_ms = [s.elapsed_time(e) for s, e in events]
    final = params_of(net)
    dtypes = [str(t.dtype) for t in final]
    batch_on_host = all(a.context == cpu for a in first[0])

    test_metric = mx.metric.Accuracy()
    with mx.autograd.predict_mode():
        for data, label in mx.gluon.data.DataLoader(test_data,
                                                    batch_size=MNIST_BATCH):
            test_metric.update([label], [net(data.as_in_context(gpu))])
    test_acc = test_metric.get()[1]

    # the same epoch through Estimator.fit: a fresh net from the same
    # seed, the sampler from the same numpy seed
    enet = mlp_net(mx, gpu, MNIST_SEED)
    same_init = all(torch.equal(a, b) for a, b in zip(params_of(enet), init))
    est = mx.gluon.contrib.estimator.Estimator(
        enet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        metrics=mx.metric.Accuracy(), trainer=mlp_trainer(mx, enet),
        context=gpu)
    np.random.seed(MNIST_SEED)
    est.fit(loader, epochs=1)
    est_params = params_of(enet)
    est_equal = all(torch.equal(a, b) for a, b in zip(est_params, final))
    est_diff = max((a - b).abs().max().item()
                   for a, b in zip(est_params, final))

    # the first 3 steps on the card and on the CPU from the same weights
    runs = []
    for ctx in (gpu, cpu):
        with ctx:
            cnet = mlp_net(mx, ctx, MNIST_SEED)
            cnet.load_parameters(init_path, ctx=ctx)
            ctr = mlp_trainer(mx, cnet)
            closses = [float(mlp_step(mx, cnet, loss_fn, ctr, d, lab,
                                      ctx)[2].mean().asscalar())
                       for d, lab in first]
            runs.append((closses, params_of(cnet)))
    (gl, gp), (hl, hp) = runs
    cpu_leaf_rel = [leaf_rel(a, b) for a, b in zip(gp, hp)]
    cpu_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, hl))

    # one step's host syncs and a profiled step (the loader's next() in)
    it2 = iter(loader)

    def one_step():
        data, label = next(it2)
        out, lab, _ = mlp_step(mx, net, loss_fn, trainer, data, label, gpu)
        metric.update([lab], [out])
    _, syncs = count_syncs(one_step)
    prof = profile_window(one_step)
    del it2
    rec = {"phase": "gluon_mlp_mnist", "train_images": MNIST_TRAIN,
           "test_images": MNIST_TEST, "batch": MNIST_BATCH,
           "steps": MNIST_STEPS, "examples_per_s": MNIST_TRAIN / window_s,
           "window_s": window_s,
           "examples_per_s_after_step_1": (MNIST_TRAIN - MNIST_BATCH)
           / (window_s - wall_ms[0] / 1e3),
           "step_ms_median": statistics.median(step_ms),
           "step_ms_first": step_ms[0],
           "step_ms_p90": float(np.percentile(step_ms, 90)),
           "step_ms_max": max(step_ms),
           "step_wall_ms_median": statistics.median(wall_ms),
           "loader_ms_median": statistics.median(load_ms),
           "loader_ms_mean": statistics.mean(load_ms),
           "loader_share": sum(load_ms) / sum(wall_ms),
           "metric_update_ms_median": statistics.median(metric_ms),
           "metric_update_ms_mean": statistics.mean(metric_ms),
           "metric_host_syncs_per_step": metric_syncs,
           "host_syncs_per_step": syncs,
           "max_memory_allocated_bytes": peak,
           "train_accuracy": train_acc, "test_accuracy": test_acc,
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_first_20_mean": statistics.mean(losses[:20]),
           "loss_last_20_mean": statistics.mean(losses[-20:]),
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "dtypes": sorted(set(dtypes)),
           "datasets_on_host": datasets_on_host,
           "batch_on_host": batch_on_host, "epoch_over": epoch_over,
           "estimator_same_init": same_init,
           "estimator_bit_equal": est_equal,
           "estimator_max_abs_diff": est_diff,
           "estimator_train_accuracy": est.train_metrics[0].get()[1],
           "cpu_3_steps_leaf_rel": cpu_leaf_rel,
           "cpu_3_steps_loss_rel": cpu_loss_rel,
           "profile_one_step": prof}
    emit(rec)
    phase = "gluon_mlp_mnist"
    check(launches == {k: (MNIST_STEPS if k == "flat_sgd" else 0)
                       for k in launches}
          and variants == {("flat_sgd", "multi"): MNIST_STEPS}, phase,
          "launches %s (%s), expected one multi flat_sgd a step and no "
          "other kernel" % (launches, variants))
    check(all(np.isfinite(losses)) and rec["loss_last_20_mean"]
          < rec["loss_first_20_mean"], phase,
          "losses not finite or not falling")
    check(train_acc > MLP_ACC and test_acc > MLP_ACC, phase,
          "accuracy train %s test %s, expected both above %s"
          % (train_acc, test_acc, MLP_ACC))
    check(dtypes == ["torch.float32"] * 6, phase, "dtypes %s" % dtypes)
    check(datasets_on_host and batch_on_host and epoch_over, phase,
          "datasets or batches not on the host, or the epoch not 469 "
          "batches")
    check(same_init and est_equal, phase, "Estimator.fit: same init %s, "
          "parameters after the epoch bit-equal %s (max diff %s)"
          % (same_init, est_equal, est_diff))
    check(max(cpu_leaf_rel) <= MLP_CPU_REL and cpu_loss_rel <= MLP_CPU_REL,
          phase, "3 steps vs the CPU: leaves %s, losses %s"
          % (cpu_leaf_rel, cpu_loss_rel))
    check(prof["device_ms"] > 0, phase, "the profiler saw no device time")
    return launches


# -- main path 11: ResNet-50 fed by a GluonCV-style DataLoader --------------
IMNET_N, IMNET_H, IMNET_W = 1024, 256, 341     # short side 256 at 4:3
LOADER_BATCH = 256
LOADER_WARMUP, LOADER_STEPS = 2, 10
LOADER_WORKERS = 4                  # train_imagenet.py --num-data-workers
IMNET_MEAN, IMNET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


class ImageNetNpy:
    """Seeded HWC uint8 images in one .npy and their labels. Each process
    memory-maps the file at its first access: a spawned worker receives
    the path, not the pixels."""

    def __init__(self, path, labels):
        self._path = path
        self._labels = labels
        self._images = None

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, i):
        import mxnet_tpu_torch as mx
        if self._images is None:
            self._images = np.load(self._path, mmap_mode="r")
        return (mx.nd.array(self._images[i], ctx=mx.cpu(), dtype="uint8"),
                self._labels[i])

    def __getstate__(self):
        return {"_path": self._path, "_labels": self._labels,
                "_images": None}


def worker_probe(_):
    """A pool task: the worker's pid and whether it initialized CUDA."""
    time.sleep(0.2)
    return os.getpid(), torch.cuda.is_initialized()


def shm_segments():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def imagenet_train_chain(T):
    """train_imagenet.py's training transforms with GluonCV's defaults."""
    return T.Compose([T.RandomResizedCrop(224), T.RandomFlipLeftRight(),
                      T.RandomColorJitter(0.4, 0.4, 0.4),
                      T.RandomLighting(0.1), T.ToTensor(),
                      T.Normalize(IMNET_MEAN, IMNET_STD)])


def loader_epochs(loader, n, seed):
    """(epoch, batch, expected indices, batch) forever: each epoch's
    RandomSampler order replayed from np.random.seed(seed + epoch) just
    before the loader shuffles with it."""
    epoch = 0
    while True:
        np.random.seed(seed + epoch)
        order = np.arange(n)
        np.random.shuffle(order)
        np.random.seed(seed + epoch)
        for k, batch in enumerate(iter(loader)):
            yield epoch, k, order[k * LOADER_BATCH:(k + 1) * LOADER_BATCH], \
                batch
        epoch += 1


def loader_run(mx, step, ds, labels, workers, profile):
    """Path 11's loop at `workers` workers: 2 warm-up and 10 timed steps,
    counts reset just before the timed steps and read just after."""
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    gpu = mx.gpu(0)
    Param = collections.namedtuple("Param", ["epoch", "nbatch",
                                             "eval_metric"])
    t_make = time.perf_counter()
    loader = mx.gluon.data.DataLoader(ds, batch_size=LOADER_BATCH,
                                      shuffle=True, last_batch="discard",
                                      num_workers=workers)
    acc, top5 = mx.metric.Accuracy(), mx.metric.TopKAccuracy(5)
    speedometer = mx.callback.Speedometer(LOADER_BATCH, frequent=5)
    gen = loader_epochs(loader, len(labels), seed=100 * workers)
    losses, load_ms, metric_ms, wall_ms = [], [], [], []
    labels_in_order = True
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(LOADER_STEPS)]

    def one_step(i, timed):
        nonlocal labels_in_order
        t0 = time.perf_counter()
        if timed:
            events[i][0].record()
        epoch, k, want, (data, label) = next(gen)
        t1 = time.perf_counter()
        labels_in_order &= bool(np.array_equal(label.asnumpy(),
                                               labels[want]))
        x = data.as_in_context(gpu).transpose((0, 2, 3, 1)).astype(
            "bfloat16")
        y = label.as_in_context(gpu)
        loss = step(x, y)
        t2 = time.perf_counter()
        acc.update([y], [step.outputs])
        top5.update([y], [step.outputs])
        t3 = time.perf_counter()
        if timed:
            events[i][1].record()
            losses.append(loss)
            load_ms.append((t1 - t0) * 1e3)
            metric_ms.append((t3 - t2) * 1e3)
            wall_ms.append((t3 - t0) * 1e3)
        speedometer(Param(epoch, k + 1, acc))

    for i in range(LOADER_WARMUP):
        one_step(i, False)
    first_batches_s = time.perf_counter() - t_make
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_start = time.perf_counter()
    for i in range(LOADER_STEPS):
        one_step(i, True)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    launches = launch_counts()
    variants = variant_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v.asscalar()) for v in losses]
    step_ms = [s.elapsed_time(e) for s, e in events]
    # the metrics' own host time: the updates in the loop also wait there
    # for the step's kernels (their first copy to the host is the sync)
    synced = []
    for _ in range(3):
        fresh = (mx.metric.Accuracy(), mx.metric.TopKAccuracy(5))
        y = mx.nd.array(labels[:LOADER_BATCH], ctx=gpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in fresh:
            m.update([y], [step.outputs])
        synced.append((time.perf_counter() - t0) * 1e3)
    probes = [r.get(120) for r in [loader._pool.apply_async(
        worker_probe, (j,)) for j in range(4 * workers)]]
    rec = {"workers": workers, "examples_per_s":
           LOADER_STEPS * LOADER_BATCH / window_s, "window_s": window_s,
           "warmup_s_with_spawn": first_batches_s,
           "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
           "step_wall_ms_median": statistics.median(wall_ms),
           "loader_ms": load_ms,
           "loader_ms_median": statistics.median(load_ms),
           "loader_share": sum(load_ms) / sum(wall_ms),
           "metric_update_ms_median": statistics.median(metric_ms),
           "metric_update_ms_synced": statistics.median(synced),
           "max_memory_allocated_bytes": peak, "losses": losses,
           "accuracy": acc.get()[1], "top5": top5.get()[1],
           "labels_in_sampler_order": labels_in_order,
           "worker_pids": len({p for p, _ in probes}),
           "workers_with_cuda": sum(c for _, c in probes),
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()}}
    if profile:
        _, rec["host_syncs_per_step"] = count_syncs(
            lambda: one_step(0, False))
        rec["profile_one_step"] = profile_window(lambda: one_step(0, False))
    gen.close()
    del gen, loader
    return rec, launches, variants


def phase_resnet_dataloader(tmp):
    """Main path 11: path 4's ResNet-50 training step fed by GluonCV's
    ImageNet DataLoader (train_imagenet.py's transforms and
    --num-data-workers 4), then at min(16, cpus) workers; the labels in
    the sampler's order, no worker with CUDA, a deterministic chain's batch
    from 4 workers bit-equal to the main process's, and no shared-memory
    segment left. Returns the timed steps' launches (both runs)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    phase = "gluon_data_resnet50"
    shm_before = shm_segments()
    rng = np.random.RandomState(0)
    path = os.path.join(tmp, "imagenet_like.npy")
    np.save(path, rng.randint(0, 256, (IMNET_N, IMNET_H, IMNET_W, 3),
                              dtype=np.uint8))
    labels = rng.randint(0, 1000, IMNET_N).astype(np.int32)
    ds = mx.gluon.data.SimpleDataset(ImageNetNpy(path, labels)) \
        .transform_first(imagenet_train_chain(T))
    gpu = mx.gpu(0)
    net = train_net(0, gpu)
    dtypes = {k: t.dtype for k, t in snapshot(net).items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    step = mx.gluon.FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                   trainer)
    cpus = os.cpu_count()
    runs, total = [], {}
    for workers, profile in ((LOADER_WORKERS, True),
                             (min(16, cpus), False)):
        rec, launches, variants = loader_run(mx, step, ds, labels, workers,
                                             profile)
        runs.append(rec)
        want = {"conv_bn_stats": 16 * LOADER_STEPS,
                "cbr_train_bwd": 16 * LOADER_STEPS,
                "flat_sgd": LOADER_STEPS}
        check(launches == {k: want.get(k, 0) for k in launches}
              and variants.get(("flat_sgd", "multi"), 0) == LOADER_STEPS
              and wgmma_launches(variants, "conv_bn_stats")
              == 16 * LOADER_STEPS, phase,
              "%d workers: launches %s (%s), expected %s a window, every "
              "flat_sgd multi" % (workers, launches, variants, want))
        check(all(np.isfinite(rec["losses"])), phase,
              "losses not finite: %s" % rec["losses"])
        check(rec["labels_in_sampler_order"], phase,
              "a label batch differs from the sampler's indices")
        check(rec["workers_with_cuda"] == 0
              and rec["worker_pids"] == workers, phase,
              "%d workers: %d answered, %d initialized CUDA"
              % (workers, rec["worker_pids"], rec["workers_with_cuda"]))
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
    after = snapshot(net)
    dtypes_kept = all(after[k].dtype == dt for k, dt in dtypes.items())
    del net, trainer, step

    # a deterministic chain: 4 workers against the main process
    det = mx.gluon.data.SimpleDataset(ImageNetNpy(path, labels)) \
        .transform_first(T.Compose([T.CenterCrop(224), T.ToTensor(),
                                    T.Normalize(IMNET_MEAN, IMNET_STD)]))
    batches = []
    for workers in (LOADER_WORKERS, 0):
        loader = mx.gluon.data.DataLoader(det, batch_size=LOADER_BATCH,
                                          num_workers=workers)
        it = iter(loader)
        batches.append(next(it))
        del it, loader
    det_equal = all(torch.equal(a.data_torch, b.data_torch)
                    for a, b in zip(*batches))
    leaked = sorted(shm_segments() - shm_before)
    emit({"phase": phase, "images": IMNET_N, "image_hw": [IMNET_H, IMNET_W],
          "batch": LOADER_BATCH, "warmup": LOADER_WARMUP,
          "steps": LOADER_STEPS, "cpu_count": cpus, "runs": runs,
          "dtypes_kept": dtypes_kept,
          "deterministic_chain_bit_equal": det_equal,
          "shm_leaked": leaked})
    check(dtypes_kept, phase, "a parameter changed its dtype")
    check(det_equal, phase, "the deterministic chain's batch from %d "
          "workers differs from the main process's" % LOADER_WORKERS)
    check(not leaked, phase, "shared-memory segments left: %s" % leaked)
    check(runs[0]["profile_one_step"]["device_ms"] > 0, phase,
          "the profiler saw no device time")
    return total


# -- main path 12: ResNet-50 through the symbolic Module API ---------------
MODULE_BATCH, MODULE_IMAGE, MODULE_CLASSES = 128, 224, 1000
MODULE_WARMUP, MODULE_STEPS = 3, 10
MODULE_EVAL_BATCHES = 4
MODULE_SEED = 0
MODULE_SGD = {"learning_rate": 0.01, "momentum": 0.9}
MODULE_ROUTE_REL = 1e-5         # per-leaf ||a - b|| / ||b||: whole-graph vs
                                # op-by-op, one step's loss and gradients,
                                # the same kernels in the same order; the
                                # limit, or twice the card's own spread
                                # under a one-ulp weight change
MODULE_GLUON_REL = 1e-4         # Module vs imperative Gluon after 3 steps,
                                # per parameter and running statistic: the
                                # head's gradient is computed two ways
                                # (SoftmaxOutput, log_softmax's autograd);
                                # the limit, or twice the spread likewise


def module_symbol(mx):
    """examples/train_image_classification.py --api module's graph:
    resnet50_v1 (composed, NCHW, 1000 classes) traced to a symbol, with
    SoftmaxOutput named softmax."""
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.resnet50_v1(classes=MODULE_CLASSES)
    return net, mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                     name="softmax")


def module_data(batch, image, n_batches, seed=MODULE_SEED):
    """One seeded batch (N(0, 1) images, labels uniform over the 1000
    classes) repeated `n_batches` times, on the host: a fixed batch, as
    path 4 trains on, so that a falling loss shows the update learns."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 3, image, image), dtype=np.float32)
    y = rng.integers(0, MODULE_CLASSES, batch).astype(np.float32)
    return np.tile(x, (n_batches, 1, 1, 1)), np.tile(y, n_batches)


def module_iter(mx, x, y, batch):
    with mx.cpu():
        return mx.io.NDArrayIter(x, y, batch_size=batch,
                                 label_name="softmax_label")


def module_batch(mx, x, y, batch):
    with mx.cpu():
        return mx.io.DataBatch([mx.nd.array(x[:batch])],
                               [mx.nd.array(y[:batch])])


def module_bound(mx, sym, ctx, batch, image, arg_params, aux_params):
    """A Module on `ctx` bound for training at (batch, 3, image, image)
    with the given parameters and SGD-momentum."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, 3, image, image))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(MODULE_SGD))
    return mod


def ce_loss(out, label):
    """Mean cross-entropy of SoftmaxOutput's probabilities (a tensor, no
    host sync)."""
    p = out.data_torch.float()
    lab = label.data_torch.to(p.device).long()
    return -torch.log(p.gather(1, lab[:, None]).clamp_min(1e-30)).mean()


def module_grads(mx, sym, ctx, batch_data, shape, arg_params, aux_params):
    """One forward_backward's loss and gradients {name: tensor}."""
    mod = module_bound(mx, sym, ctx, shape[0], shape[2], arg_params,
                       aux_params)
    mod.forward_backward(batch_data)
    loss = ce_loss(mod.get_outputs()[0], batch_data.label[0]).item()
    grads = {n: g[0].data_torch.detach().clone()
             for n, g in zip(mod._exec_group.param_names,
                             mod._exec_group.grad_arrays)}
    return loss, grads


def nudged(params):
    """The parameters moved up by one ulp each."""
    import mxnet_tpu_torch as mx
    out = {}
    for k, v in params.items():
        t = v.data_torch
        out[k] = mx.nd.NDArray(torch.nextafter(
            t, torch.tensor(float("inf"), device=t.device)), ctx=v.context)
    return out


def leaf_rel_stats(a, b, skip=()):
    """Median, max and worst leaves of ||a - b|| / ||b|| over the leaves
    of `b` (on the host) that are not skipped and not zero."""
    errs = {k: rel_err(v.cpu(), b[k].cpu()) for k, v in a.items()
            if k not in skip and b[k].norm() > 0}
    return {"median": statistics.median(errs.values()),
            "max": max(errs.values()),
            "worst_leaves": dict(sorted(errs.items(),
                                        key=lambda kv: -kv[1])[:5])}


def module_three_steps(mx, sym, ctx, batch_data, shape, arg_params,
                       aux_params):
    """3 Module steps from the given state: {name: tensor} after."""
    mod = module_bound(mx, sym, ctx, shape[0], shape[2], arg_params,
                       aux_params)
    for _ in range(3):
        mod.forward_backward(batch_data)
        mod.update()
    args, auxs = mod.get_params()
    return {k: v.data_torch.clone() for k, v in
            list(args.items()) + list(auxs.items())}


def gluon_three_steps(mx, ctx, batch_data, arg_params, aux_params):
    """The same 3 steps through the imperative Gluon route: resnet50_v1
    (named as `module_symbol`'s) with the Module's initial parameters,
    Trainer("sgd") and SoftmaxCrossEntropyLoss, step(batch)."""
    net, _ = module_symbol(mx)
    net.initialize(ctx=ctx)
    params = net.collect_params()
    for name, v in dict(arg_params, **aux_params).items():
        params[name].set_data(v)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(params, "sgd", dict(MODULE_SGD))
    x = batch_data.data[0].as_in_context(ctx)
    y = batch_data.label[0].as_in_context(ctx)
    for _ in range(3):
        imperative_step(mx, net, loss_fn, trainer, x, y)
    return {name: p.data().data_torch.clone()
            for name, p in params.items()}


def phase_module_resnet50(tmp, batch=MODULE_BATCH, image=MODULE_IMAGE):
    """Main path 12: examples/train_image_classification.py --api module
    at full width: resnet50_v1 traced to a symbol, Module(context=gpu)
    .fit with SGD-momentum (lr 0.01, 0.9) and Xavier init over an
    NDArrayIter, 3 warm-up and 10 timed batches, Speedometer and
    do_checkpoint; counts reset just before the timed batches and read
    just after. Then score and predict over 4 batches, Module.load of the
    checkpoint (predictions bit-equal), one step with
    MXNET_TPU_WHOLE_GRAPH=0 against the whole-graph route, 3 Module steps
    against 3 imperative Gluon steps, and a profiled step. Returns the
    launches of the timed batches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    phase = "module_resnet50"
    gpu = mx.gpu(0)
    torch.backends.cudnn.deterministic = True
    _, sym = module_symbol(mx)
    n_trainable = len(sym.list_arguments()) - 2
    n_batches = MODULE_WARMUP + MODULE_STEPS
    x, y = module_data(batch, image, n_batches)
    it = module_iter(mx, x, y, batch)
    telemetry.reset()
    mod = mx.mod.Module(sym, context=gpu)
    update_ms, step_events, step_wall, losses, counted = [], [], [], [], {}
    update = mod.update

    def timed_update():
        t0 = time.perf_counter()
        update()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    mod.update = timed_update

    def on_batch(param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_events.append(ev)
        losses.append(ce_loss(mod.get_outputs()[0],
                              param.locals["data_batch"].label[0]))
        if param.nbatch == MODULE_WARMUP - 1:
            torch.cuda.synchronize()
            counted["runs0"] = telemetry.counter_value(
                "compiler.program_runs")
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            step_wall.append(time.perf_counter())
        elif param.nbatch == n_batches - 1:
            torch.cuda.synchronize()
            step_wall.append(time.perf_counter())
            counted["launches"] = launch_counts()
            counted["variants"] = variant_counts()
            counted["runs"] = telemetry.counter_value(
                "compiler.program_runs") - counted["runs0"]
            counted["peak"] = torch.cuda.max_memory_allocated()

    prefix = os.path.join(tmp, "resnet50")
    mx.random.seed(MODULE_SEED)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    args0, auxs0 = mod.get_params()
    init_args = {k: v.copy() for k, v in args0.items()}
    init_auxs = {k: v.copy() for k, v in auxs0.items()}
    t_fit = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(MODULE_SGD), eval_metric="acc",
            batch_end_callback=[on_batch,
                                mx.callback.Speedometer(batch, 5)],
            epoch_end_callback=mx.callback.do_checkpoint(prefix))
    fit_s = time.perf_counter() - t_fit
    launches, variants = counted["launches"], counted["variants"]
    losses = [float(v) for v in losses]
    timed_ms = [a.elapsed_time(b) for a, b in
                zip(step_events[MODULE_WARMUP - 1:-1],
                    step_events[MODULE_WARMUP:])]
    window_s = step_wall[1] - step_wall[0]
    args_after, auxs_after = mod.get_params()
    moved = sum(not torch.equal(auxs_after[k].data_torch,
                                init_auxs[k].data_torch)
                for k in init_auxs if k.endswith("running_mean"))
    fallback = telemetry.counter_value("compiler.fallback")

    # score and predict over 4 batches in inference mode
    eval_it = module_iter(mx, x[:MODULE_EVAL_BATCHES * batch],
                          y[:MODULE_EVAL_BATCHES * batch], batch)
    score = mod.score(eval_it, "acc")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = mod.predict(eval_it)
    pred_t = pred.data_torch.clone()
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred_again = mod.predict(eval_it).data_torch
    torch.cuda.synchronize()
    predict2_s = time.perf_counter() - t0

    # the checkpoint do_checkpoint wrote, loaded into a new Module
    loaded = mx.mod.Module.load(prefix, 1, context=gpu)
    loaded.bind(data_shapes=eval_it.provide_data,
                label_shapes=eval_it.provide_label, for_training=False)
    reloaded_equal = torch.equal(loaded.predict(eval_it).data_torch, pred_t)
    del loaded
    profile = profile_window(lambda: (mod.forward_backward(
        module_batch(mx, x, y, batch)), mod.update()))
    del mod
    torch.cuda.empty_cache()

    # one step with MXNET_TPU_WHOLE_GRAPH=0 against the whole-graph route,
    # beside the whole-graph route's own one-ulp spread
    one = module_batch(mx, x, y, batch)
    shape = (batch, 3, image, image)
    loss_wg, g_wg = module_grads(mx, sym, gpu, one, shape, init_args,
                                 init_auxs)
    prev = os.environ.get("MXNET_TPU_WHOLE_GRAPH")
    os.environ["MXNET_TPU_WHOLE_GRAPH"] = "0"
    try:
        lowered = telemetry.counter_value("compiler.lower")
        loss_op, g_op = module_grads(mx, sym, gpu, one, shape, init_args,
                                     init_auxs)
        op_lowered = telemetry.counter_value("compiler.lower") - lowered
    finally:
        if prev is None:
            del os.environ["MXNET_TPU_WHOLE_GRAPH"]
        else:
            os.environ["MXNET_TPU_WHOLE_GRAPH"] = prev
    _, g_nudged = module_grads(mx, sym, gpu, one, shape, nudged(init_args),
                               init_auxs)
    # conv biases before a batch-statistics BatchNorm: zero gradient in
    # exact arithmetic, rounding noise in practice
    null = {k for k in g_wg if k.endswith("_bias") and "dense" not in k}
    routes = {"op_by_op_vs_whole_graph": leaf_rel_stats(g_op, g_wg, null),
              "one_ulp_weights": leaf_rel_stats(g_nudged, g_wg, null),
              "loss_whole_graph": loss_wg, "loss_op_by_op": loss_op,
              "op_by_op_lowered": op_lowered}
    routes["median_limit"] = max(MODULE_ROUTE_REL, 2.0 * routes[
        "one_ulp_weights"]["median"])
    routes["max_limit"] = max(MODULE_ROUTE_REL,
                              2.0 * routes["one_ulp_weights"]["max"])
    del g_wg, g_op, g_nudged
    torch.cuda.empty_cache()

    # 3 Module steps against 3 imperative Gluon steps from the same state
    m3 = module_three_steps(mx, sym, gpu, one, shape, init_args, init_auxs)
    m3_nudged = module_three_steps(mx, sym, gpu, one, shape,
                                   nudged(init_args), init_auxs)
    g3 = gluon_three_steps(mx, gpu, one, init_args, init_auxs)
    vs_gluon = {"module_vs_gluon": leaf_rel_stats(g3, m3, null),
                "one_ulp_weights": leaf_rel_stats(m3_nudged, m3, null)}
    vs_gluon["median_limit"] = max(MODULE_GLUON_REL, 2.0 * vs_gluon[
        "one_ulp_weights"]["median"])
    vs_gluon["max_limit"] = max(MODULE_GLUON_REL,
                                2.0 * vs_gluon["one_ulp_weights"]["max"])
    del m3, m3_nudged, g3
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    step_med = statistics.median(timed_ms)
    rec = {"phase": phase, "config": "resnet50_v1 composed NCHW fp32, "
           "Module.fit sgd lr 0.01 momentum 0.9, Xavier",
           "batch": batch, "image": image, "warmup": MODULE_WARMUP,
           "steps": MODULE_STEPS, "trainable_arguments": n_trainable,
           "images_per_s": MODULE_STEPS * batch / window_s,
           "window_s": window_s, "fit_s": fit_s,
           "step_ms_median": step_med, "step_ms": timed_ms,
           "images_per_s_by_median_step": batch / step_med * 1e3,
           "update_host_ms_median": statistics.median(
               update_ms[MODULE_WARMUP:]),
           "flat_sgd_launches_per_step": launches["flat_sgd"]
           / MODULE_STEPS,
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "program_runs_timed": counted["runs"],
           "compiler_program_runs": telemetry.counter_value(
               "compiler.program_runs"),
           "compiler_fallback": fallback,
           "max_memory_allocated_bytes": counted["peak"],
           "losses": losses, "running_means_moved": moved,
           "score": score, "predict_images_per_s":
           MODULE_EVAL_BATCHES * batch / predict_s,
           "predict_images_per_s_second_call":
           MODULE_EVAL_BATCHES * batch / predict2_s,
           "predict_repeat_bit_equal": torch.equal(pred_again, pred_t),
           "reloaded_predict_bit_equal": reloaded_equal,
           "routes": routes, "vs_gluon_3_steps": vs_gluon,
           "profile_one_step": profile, "card": card_name_and_limit()}
    emit(rec)
    check(launches["flat_sgd"] == MODULE_STEPS * n_trainable
          and sum(launches.values()) == launches["flat_sgd"]
          and variants == {("flat_sgd", "single"): MODULE_STEPS * n_trainable},
          phase, "launches %s (%s), expected one single flat_sgd per "
          "trainable argument (%d) a step and no other kernel"
          % (launches, variants, n_trainable))
    check(counted["runs"] == MODULE_STEPS, phase,
          "%s whole-graph runs in %d steps" % (counted["runs"],
                                               MODULE_STEPS))
    check(fallback == 0, phase, "compiler.fallback %s" % fallback)
    check(all(np.isfinite(losses)) and statistics.mean(losses[-3:])
          < statistics.mean(losses[:3]), phase,
          "losses not finite or not falling: %s" % losses)
    check(moved == 53, phase, "%d of 53 running means moved" % moved)
    check(reloaded_equal, phase, "the reloaded checkpoint's predictions "
          "differ")
    check(op_lowered == 0 and routes["op_by_op_vs_whole_graph"]["median"]
          <= routes["median_limit"]
          and routes["op_by_op_vs_whole_graph"]["max"] <= routes["max_limit"]
          and abs(loss_op - loss_wg) <= MODULE_ROUTE_REL * abs(loss_wg),
          phase, "op-by-op vs whole-graph step: %s" % routes)
    check(vs_gluon["module_vs_gluon"]["median"] <= vs_gluon["median_limit"]
          and vs_gluon["module_vs_gluon"]["max"] <= vs_gluon["max_limit"],
          phase, "Module vs Gluon after 3 steps: %s" % vs_gluon)
    check(profile["device_ms"] > 0, phase, "the profiler saw no device time")
    return launches



# -- main path 13: the Gluon word-level language model ---------------------
LM_VOCAB, LM_EMB, LM_HID, LM_LAYERS = 10000, 650, 650, 2
LM_DROPOUT, LM_BPTT, LM_BATCH = 0.5, 35, 32
LM_TOKENS = 200_000                 # examples/word_lm.py's corpus default
LM_WARMUP, LM_STEPS = 3, 20
LM_LOSS_REL = 1e-5              # the first step's loss, card vs CPU: fp32
                                # on both sides (TF32 off), only the
                                # summation order differs
LM_GRAD_REL = 1e-4              # per-leaf ||card - cpu|| / ||cpu|| of the
                                # first step's gradients: the same, through
                                # 70 recurrent steps forward and back
LM_PARAM_REL = 1e-5             # every parameter after the first
                                # trainer.step, card vs CPU: max |diff|
                                # over max |cpu| (the update itself is
                                # bit-equal to its plain version)
LM_CUDNN_ABS = 1e-5             # the RNN op vs cuDNN's LSTM on the same
                                # flat weights: max abs difference over
                                # the outputs and final states, relative to
                                # max(1, their largest value)


def word_lm_net(mx, dropout=LM_DROPOUT):
    """examples/word_lm.py's WordLM at the path's widths: Embedding ->
    rnn.LSTM(layout="NTC") -> Dropout -> Dense(vocab, flatten=False),
    weights not tied."""
    gluon = mx.gluon

    class WordLM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(LM_VOCAB, LM_EMB)
                self.lstm = gluon.rnn.LSTM(LM_HID, num_layers=LM_LAYERS,
                                           dropout=dropout, layout="NTC")
                self.drop = gluon.nn.Dropout(dropout)
                self.proj = gluon.nn.Dense(LM_VOCAB, flatten=False)

        def hybrid_forward(self, F, x, *args, **params):
            return self.proj(self.drop(self.lstm(self.embed(x))))
    return WordLM(prefix="wordlm_")


def lm_batches(n):
    """The first `n` (x, y) batches of examples/word_lm.py: its Zipf(1.3)
    corpus (seed 0, 200,000 tokens, ids mod the vocabulary) batchified
    into LM_BATCH rows of LM_BPTT steps, y the next token."""
    data = (np.random.RandomState(0).zipf(1.3, LM_TOKENS)
            % LM_VOCAB).astype(np.int32)
    per = LM_BATCH * LM_BPTT
    m = (len(data) - 1) // per * per
    x = data[:m].reshape(LM_BATCH, -1)
    y = data[1:m + 1].reshape(LM_BATCH, -1)
    return [(x[:, t:t + LM_BPTT], y[:, t:t + LM_BPTT])
            for t in range(0, LM_BPTT * n, LM_BPTT)]


def lm_loss(mx, net, sce, xb, yb, ctx):
    x = mx.nd.array(xb, ctx=ctx)
    y = mx.nd.array(yb, ctx=ctx)
    with mx.autograd.record():
        logits = net(x)
        loss = sce(logits.reshape((-1, LM_VOCAB)), y.reshape((-1,))).mean()
    loss.backward()
    return loss


def rnn_vs_cudnn(gen):
    """The RNN op (mode lstm, path 13's 2 x 650 over 35 x 32 x 650, fp32)
    against cuDNN's LSTM through torch._VF.lstm on the same flat weights
    (a layout check, and the layer's yardstick): the largest difference,
    and each one's forward and forward+backward device time (torch.profiler)
    and event time."""
    from mxnet_tpu_torch.ops.rnn_ops import (_rnn, _slice_params,
                                             rnn_param_size)
    n = rnn_param_size("lstm", LM_EMB, LM_HID, LM_LAYERS)
    flat = (torch.rand(n, generator=gen, device="cuda") - 0.5) * 0.1
    x = torch.randn(LM_BPTT, LM_BATCH, LM_EMB, generator=gen, device="cuda")
    h0 = torch.randn(LM_LAYERS, LM_BATCH, LM_HID, generator=gen,
                     device="cuda") * 0.1
    c0 = torch.randn(LM_LAYERS, LM_BATCH, LM_HID, generator=gen,
                     device="cuda") * 0.1
    # cuDNN's per-layer [w_ih, w_hh, b_ih, b_hh], copied out of the flat
    # vector (gate order [i, f, g, o] in both)
    weights = [t.clone() for spec in _slice_params(
        flat, "lstm", LM_EMB, LM_HID, LM_LAYERS, False)
        for t in (spec["i2h_w"], spec["h2h_w"], spec["i2h_b"],
                  spec["h2h_b"])]
    kw = dict(state_size=LM_HID, num_layers=LM_LAYERS, mode="lstm",
              _training=False)

    def ours():
        return _rnn(x, flat, h0, c0, **kw)

    def cudnn():
        # train=True, which cuDNN's backward needs; dropout 0, so the
        # forward is the inference one
        return torch._VF.lstm(x, (h0, c0), weights, True, LM_LAYERS, 0.0,
                              True, False, False)
    with torch.no_grad():
        got, want = ours(), cudnn()
    err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
              for a, b in zip(got, want))
    cot = torch.randn(LM_BPTT, LM_BATCH, LM_HID, generator=gen,
                      device="cuda")
    leaves = [x, flat, h0, c0] + weights

    def with_backward(fn):
        def run():
            for t in leaves:
                t.requires_grad_(True)
            out = fn()
            (out[0] * cot).sum().backward()
            for t in leaves:
                t.grad = None
                t.requires_grad_(False)
        return run
    rec = {"max_rel_err": err}
    for name, fn in (("rnn_op", ours), ("cudnn_lstm", cudnn)):
        with torch.no_grad():
            fwd_dev = device_ms(fn, calls=5, warmup=2)
            fwd_ev = time_ms(fn, iters=5, warmup=1)
        both_dev = device_ms(with_backward(fn), calls=5, warmup=2)
        both_ev = time_ms(with_backward(fn), iters=5, warmup=1)
        rec[name] = {"fwd_device_ms": fwd_dev, "fwd_event_ms": fwd_ev,
                     "fwd_bwd_device_ms": both_dev,
                     "fwd_bwd_event_ms": both_ev,
                     "bwd_device_ms": None if None in (fwd_dev, both_dev)
                     else both_dev - fwd_dev}
    return rec


def phase_gluon_word_lm(tmp):
    """Main path 13: examples/word_lm.py at upstream MXNet's medium Gluon
    word-LM widths, 3 warm-up and 20 timed steps with counts reset just
    before the timed steps and read just after; then the first step (loss,
    gradients, and every parameter after trainer.step) against the CPU (dropout off on both sides: the masks
    come from each device's generator), the RNN op against cuDNN's LSTM,
    a profiled step and the example's greedy continuation. Returns the
    launches of the timed steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    phase = "gluon_word_lm"
    gpu, cpu = mx.gpu(0), mx.cpu()
    batches = lm_batches(LM_WARMUP + LM_STEPS + 1)
    with gpu:
        mx.random.seed(0)
        net = word_lm_net(mx)
        net.initialize(mx.init.Xavier(), ctx=gpu)
        net.hybridize(static_alloc=True)
        with mx.autograd.predict_mode():
            net(mx.nd.array(batches[0][0], ctx=gpu))
    check(same_shapes([p.shape for p in net.collect_params().values()],
                      rnn_sgd_lists()[phase][0]), phase,
          "parameters other than those kernel_opt checked #7 at")
    init_path = os.path.join(tmp, "word_lm_init.params")
    net.save_parameters(init_path)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1.0, "clip_gradient": 0.25})
    n_steps = LM_WARMUP + LM_STEPS
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_steps + 1)]
    losses, step_host_ms = [], []
    events[0].record()
    for i, (xb, yb) in enumerate(batches[:n_steps]):
        if i == LM_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t_start = time.perf_counter()
        with gpu:
            loss = lm_loss(mx, net, sce, xb, yb, gpu)
            t0 = time.perf_counter()
            trainer.step(1)
            step_host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.data_torch)
        events[i + 1].record()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    launches, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(LM_WARMUP, n_steps)]
    ppl_first, ppl_last = math.exp(losses[LM_WARMUP]), math.exp(losses[-1])

    def one_step():
        with gpu:
            lm_loss(mx, net, sce, *batches[n_steps], gpu)
            trainer.step(1)
    prof = profile_window(one_step)

    # the example's greedy continuation from token 1
    tokens = []
    with gpu:
        cur = mx.nd.array(np.full((1, 1), 1, np.int32), ctx=gpu)
        for _ in range(10):
            nxt = int(np.argmax(net(cur).asnumpy()[0, -1]))
            tokens.append(nxt)
            cur = mx.nd.array(np.array([[nxt]], np.int32), ctx=gpu)

    # the first step on the card and on the CPU, the same weights and
    # batch: the loss, three gradients, and every parameter after the
    # Trainer's update (on the card one multi #7 launch, on the CPU its
    # plain version)
    first = []
    for ctx in (gpu, cpu):
        with ctx:
            cnet = word_lm_net(mx, dropout=0.0)
            cnet.load_parameters(init_path, ctx=ctx)
            loss = lm_loss(mx, cnet, sce, *batches[0], ctx)
            grads = {"l0_h2h_weight": cnet.lstm.l0_h2h_weight.grad(ctx)
                     .data_torch.cpu(),
                     "proj_weight": cnet.proj.weight.grad(ctx).data_torch
                     .cpu(),
                     "proj_bias": cnet.proj.bias.grad(ctx).data_torch.cpu()}
            mx.gluon.Trainer(cnet.collect_params(), "sgd",
                             {"learning_rate": 1.0,
                              "clip_gradient": 0.25}).step(1)
            first.append((float(loss.asscalar()), grads,
                          {k: p.data(ctx).data_torch.cpu() for k, p in
                           cnet.collect_params().items()}))
            del cnet
    (lg, gg, pg), (lc, gc, pc) = first
    cpu_loss_rel = abs(lg - lc) / abs(lc)
    cpu_grad_rel = {k: rel_err(gg[k], gc[k]) for k in gc}
    # max |card - cpu| over max |cpu| for each parameter after the step
    cpu_param_rel = {k: ((pg[k] - pc[k]).abs().max()
                         / pc[k].abs().max()).item() for k in pc}
    del first, gg, gc, pg, pc
    cudnn = rnn_vs_cudnn(torch.Generator(device="cuda").manual_seed(13))

    med = statistics.median(step_ms)
    rec = {"phase": phase,
           "config": "WordLM vocab %d, emsize %d, nhid %d, %d layers, "
                     "dropout %s, bptt %d, batch %d, sgd lr 1.0 clip 0.25"
                     % (LM_VOCAB, LM_EMB, LM_HID, LM_LAYERS, LM_DROPOUT,
                        LM_BPTT, LM_BATCH),
           "warmup": LM_WARMUP, "steps": LM_STEPS,
           "step_ms_median": med, "step_ms": step_ms,
           "tokens_per_s": LM_STEPS * LM_BATCH * LM_BPTT / window_s,
           "tokens_per_s_by_median_step": LM_BATCH * LM_BPTT / med * 1e3,
           "window_s": window_s,
           "trainer_step_host_ms_median": statistics.median(
               step_host_ms[LM_WARMUP:]),
           "max_memory_allocated_bytes": peak,
           "perplexity_first_timed": ppl_first,
           "perplexity_last_timed": ppl_last, "losses": losses,
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "profile_one_step": prof, "greedy_tokens": tokens,
           "cpu_first_step_loss_rel": cpu_loss_rel,
           "cpu_first_step_grad_rel": cpu_grad_rel,
           "cpu_first_step_param_rel_max": max(cpu_param_rel.values()),
           "cpu_first_step_param_rel": cpu_param_rel,
           "rnn_op_vs_cudnn_lstm": cudnn, "card": card_name_and_limit()}
    emit(rec)
    check(launches["flat_sgd"] == LM_STEPS
          and sum(launches.values()) == LM_STEPS
          and variants == {("flat_sgd", "multi"): LM_STEPS}, phase,
          "launches %s (%s), expected one multi flat_sgd a step and no "
          "other kernel" % (launches, variants))
    check(all(np.isfinite(losses)) and ppl_last < ppl_first, phase,
          "perplexity not finite or not falling: %s -> %s"
          % (ppl_first, ppl_last))
    check(len(tokens) == 10 and all(0 <= t < LM_VOCAB for t in tokens),
          phase, "greedy continuation %s" % tokens)
    check(cpu_loss_rel <= LM_LOSS_REL
          and max(cpu_grad_rel.values()) <= LM_GRAD_REL, phase,
          "first step vs the CPU: loss %s, gradients %s"
          % (cpu_loss_rel, cpu_grad_rel))
    check(len(cpu_param_rel) == len(rnn_sgd_lists()["gluon_word_lm"][0])
          and max(cpu_param_rel.values()) <= LM_PARAM_REL, phase,
          "parameters after the first trainer.step vs the CPU: %s"
          % cpu_param_rel)
    check(cudnn["max_rel_err"] <= LM_CUDNN_ABS, phase,
          "RNN op vs cuDNN's LSTM: %s" % cudnn["max_rel_err"])
    check(prof["device_ms"] > 0, phase, "the profiler saw no device time")
    return launches


# -- main path 14: an LSTM BucketingModule through mx.rnn ------------------
BK_VOCAB, BK_EMB, BK_HID, BK_LAYERS = 10000, 200, 200, 2
BK_KEYS = [10, 20, 30, 40, 50, 60]
BK_WARMUP_PER_KEY = [1] * 6         # one warm-up batch of each bucket
BK_PER_KEY = [4, 4, 3, 3, 3, 3]     # timed batches per bucket: 20
BK_BATCH = 32
BK_WARMUP, BK_STEPS = sum(BK_WARMUP_PER_KEY), sum(BK_PER_KEY)
BK_SGD = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}


def bucket_sentences(per_key, seed):
    """Zipf(1.3) sentences (ids 1 to 9999; 0 is the invalid label), as
    many of each bucket's lengths (above the bucket below, up to its own)
    as `per_key` batches hold, in a seeded shuffled order."""
    rng = np.random.RandomState(seed)
    sents, low = [], 1
    for key, n in zip(BK_KEYS, per_key):
        for _ in range(n * BK_BATCH):
            length = rng.randint(low + 1, key + 1)
            sents.append(list(rng.zipf(1.3, length) % (BK_VOCAB - 1) + 1))
        low = key
    return [sents[i] for i in rng.permutation(len(sents))]


def lstm_bucketing_sym_gen(mx, stack):
    """upstream lstm_bucketing.py's sym_gen over the shared `stack`, with
    zero begin states."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=BK_VOCAB,
                                 output_dim=BK_EMB, name="embed")
        stack.reset()
        begin = [mx.sym.zeros((BK_BATCH, BK_HID))
                 for _ in range(2 * BK_LAYERS)]
        outputs, _ = stack.unroll(seq_len, inputs=embed, begin_state=begin,
                                  merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, BK_HID))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=BK_VOCAB,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def phase_module_lstm_bucketing(tmp):
    """Main path 14: upstream example/rnn/bucketing/lstm_bucketing.py on
    the port at its defaults. BucketingModule.fit over one warm-up batch
    of each bucket (every bucket's program built), then fit over 20 timed
    batches, counts reset just before the timed fit and read just after
    its last batch; the rnn checkpoint written and read back. Returns the
    launches of the timed batches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    phase = "module_lstm_bucketing"
    gpu = mx.gpu(0)
    stack = mx.rnn.SequentialRNNCell()
    for i in range(BK_LAYERS):
        stack.add(mx.rnn.LSTMCell(num_hidden=BK_HID, prefix="lstm_l%d_" % i))
    np.random.seed(0)
    with mx.cpu():
        warm_it, it = (mx.rnn.BucketSentenceIter(
            bucket_sentences(per_key, seed), BK_BATCH, buckets=list(BK_KEYS),
            invalid_label=0)
            for per_key, seed in ((BK_WARMUP_PER_KEY, 1), (BK_PER_KEY, 0)))
    mod = mx.mod.BucketingModule(lstm_bucketing_sym_gen(mx, stack),
                                 default_bucket_key=it.default_bucket_key,
                                 context=gpu)
    update_ms, events, keys, ppl, counted = [], [], [], [], {}
    prev = [0.0, 0]
    update = mod.update

    def timed_update():
        t0 = time.perf_counter()
        update()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    mod.update = timed_update

    def on_batch(param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        keys.append(param.locals["data_batch"].bucket_key)
        # the batch's perplexity from the fit's Perplexity(0) metric: its
        # sums since the last batch (fit resets it at each epoch's start)
        m = param.eval_metric
        if param.nbatch == 0:
            prev[:] = [0.0, 0]
        n = m.num_inst - prev[1]
        ppl.append((math.exp((m.sum_metric - prev[0]) / n), n))
        prev[:] = [m.sum_metric, m.num_inst]
        if len(keys) == BK_WARMUP + BK_STEPS:
            torch.cuda.synchronize()
            counted["t1"] = time.perf_counter()
            counted["launches"] = launch_counts()
            counted["variants"] = variant_counts()
            counted["peak"] = torch.cuda.max_memory_allocated()
            counted["built"] = telemetry.counter_value("compiler.compile")

    def fit(data):
        mod.fit(data, eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
                optimizer_params=dict(BK_SGD),
                initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
                num_epoch=1,
                batch_end_callback=[on_batch, mx.callback.Speedometer(
                    BK_BATCH, 5, auto_reset=False)])

    telemetry.reset()
    mx.random.seed(0)
    with mx.cpu():      # the iterator's batches on the host
        fit(warm_it)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        built_before = telemetry.counter_value("compiler.compile")
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        reset_launch_counts()
        counted["t0"] = time.perf_counter()
        fit(it)
    launches, variants = counted["launches"], counted["variants"]
    programs = telemetry.counter_value("compiler.compile")
    fallback = telemetry.counter_value("compiler.fallback")
    n_trainable = len(mod.symbol.list_arguments()) - 2
    window_s = counted["t1"] - counted["t0"]
    step_ms = [a.elapsed_time(b) for a, b in
               zip([start] + events[BK_WARMUP:-1], events[BK_WARMUP:])]
    timed_keys = keys[BK_WARMUP:]
    by_key = {k: statistics.median(ms for ms, kk in zip(step_ms, timed_keys)
                                   if kk == k)
              for k in sorted(set(timed_keys))}

    # a profiled batch of the longest bucket, and of the shortest
    profiles = {}
    with mx.cpu():
        it.reset()
        for batch in it:
            if batch.bucket_key in (BK_KEYS[0], BK_KEYS[-1]) and \
                    batch.bucket_key not in profiles:
                profiles[batch.bucket_key] = profile_window(
                    lambda: (mod.forward_backward(batch), mod.update()))

    # the rnn checkpoint: written, read back bit-equal
    arg, aux = mod.get_params()
    check(same_shapes([v.shape for v in arg.values()],
                      rnn_sgd_lists()[phase][0]), phase,
          "parameters other than those kernel_opt checked #7 at")
    prefix = os.path.join(tmp, "lstm_bucketing")
    mx.rnn.save_rnn_checkpoint(stack, prefix, 1, mod.symbol, arg, aux)
    _, arg2, aux2 = mx.rnn.load_rnn_checkpoint(stack, prefix, 1)
    reloaded = sorted(arg2) == sorted(arg) and all(
        torch.equal(arg2[k].data_torch.cpu(), arg[k].data_torch.cpu())
        for k in arg)

    rec = {"phase": phase,
           "config": "2 x LSTMCell(%d), Embedding(%d, %d), buckets %s, "
                     "batch %d, sgd lr 0.01 wd 1e-5, Xavier in 2.34"
                     % (BK_HID, BK_VOCAB, BK_EMB, BK_KEYS, BK_BATCH),
           "warmup": BK_WARMUP, "steps": BK_STEPS,
           "batches_per_s": BK_STEPS / window_s, "window_s": window_s,
           "tokens_per_s": sum(BK_BATCH * k for k in timed_keys) / window_s,
           "valid_tokens_per_s": sum(n for _, n in ppl[BK_WARMUP:])
           / window_s,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "step_ms_median_by_bucket": by_key,
           "bucket_keys": keys, "programs_built": programs,
           "programs_built_in_window": counted["built"] - built_before,
           "buckets_seen": len(set(keys)), "compiler_fallback": fallback,
           "trainable_arguments": n_trainable,
           "update_host_ms_median": statistics.median(
               update_ms[BK_WARMUP:]),
           "max_memory_allocated_bytes": counted["peak"],
           "perplexity": [p for p, _ in ppl],
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "checkpoint_reloaded_bit_equal": reloaded,
           "profile_one_batch_by_bucket": profiles,
           "card": card_name_and_limit()}
    emit(rec)
    first3 = statistics.mean(p for p, _ in ppl[:3])
    last3 = statistics.mean(p for p, _ in ppl[-3:])
    check(len(keys) == BK_WARMUP + BK_STEPS
          and set(keys[:BK_WARMUP]) == set(BK_KEYS), phase,
          "batches %s, expected one of each bucket, then %d"
          % (keys, BK_STEPS))
    check(launches["flat_sgd"] == BK_STEPS * n_trainable
          and sum(launches.values()) == launches["flat_sgd"]
          and variants == {("flat_sgd", "single"): BK_STEPS * n_trainable},
          phase, "launches %s (%s), expected one single flat_sgd per "
          "trainable argument (%d) a batch and no other kernel"
          % (launches, variants, n_trainable))
    check(programs == len(BK_KEYS) and counted["built"] == built_before
          and fallback == 0, phase,
          "%s programs for %d buckets (%s built in the timed window), "
          "compiler.fallback %s" % (programs, len(BK_KEYS),
                                    counted["built"] - built_before,
                                    fallback))
    check(all(np.isfinite([p for p, _ in ppl])) and last3 < first3, phase,
          "perplexity not finite or not falling: %s" % ppl)
    check(reloaded, phase, "the rnn checkpoint did not reload bit-equal")
    check(all(p["device_ms"] > 0 for p in profiles.values()), phase,
          "the profiler saw no device time")
    return launches


# ---------------------------------------------------------------------------
# the op set: every op the op-set slice registers, once on the card
# against the port's CPU result; and main path 15, SSD-512 on ResNet-50
# ---------------------------------------------------------------------------
NEW_OPS = """
BatchNorm_v1 BilinearSampler Correlation Crop Deconvolution GridGenerator
GroupNorm InstanceNorm L2Normalization RMSNorm ROIPooling SoftmaxActivation
UpSampling _contrib_div_sqrt_dim crop dot_scaled hard_sigmoid
softmax_cross_entropy softmin BlockGrad_inner _copyto _div_scalar
_internal_getitem _minus_scalar _mul_scalar _plus_scalar _power
_power_scalar amp_cast arccos arccosh arcsin arcsinh arctan arctan2 arctanh
argmax argmin argsort batch_dot boolean_mask broadcast_axes broadcast_axis
broadcast_hypot broadcast_logical_and broadcast_logical_or
broadcast_logical_xor broadcast_mod broadcast_power cbrt ceil cos cosh
cumsum degrees depth_to_space diag erf erfinv expm1 eye fix floor gamma
gammaln gather_nd isfinite isinf isnan khatri_rao linalg_gemm2 linalg_potrf
linalg_syrk log10 log1p log2 logical_not logsumexp max max_axis min min_axis
moveaxis nanprod nansum pow prod radians reciprocal repeat rint round rsqrt
scatter_nd shape_array sign sin sinh size_array slice slice_like smooth_l1
softsign sort space_to_depth squeeze stop_gradient_passthrough take
take_along_axis tan tile topk trunc where_index IdentityAttachKLSparseReg
LRN SVMOutput SpatialTransformer argmax_channel batch_take broadcast_like
cast_storage col2im digamma fill_element_0index im2col linalg_det
linalg_extractdiag linalg_extracttrian linalg_gelqf linalg_gemm
linalg_inverse linalg_makediag linalg_maketrian linalg_potri linalg_slogdet
linalg_sumlogdiag linalg_trmm linalg_trsm linspace make_loss moments
ravel_multi_index rcbrt reshape_like unravel_index
_contrib_AdaptiveAvgPooling2D _contrib_BilinearResize2D
_contrib_DeformableConvolution _contrib_MultiBoxDetection
_contrib_MultiBoxPrior _contrib_MultiBoxTarget _contrib_PSROIPooling
_contrib_ROIAlign _contrib_adaptive_avg_pooling2d _contrib_arange_like
_contrib_bilinear_resize2d _contrib_box_decode _contrib_box_encode
_contrib_box_iou _contrib_box_nms _contrib_dequantize _contrib_quantize_v2
_contrib_quantized_conv _contrib_quantized_fully_connected
_contrib_requantize _image_crop _image_flip_left_right
_image_flip_top_bottom _image_normalize _image_random_brightness
_image_random_contrast _image_random_flip_left_right
_image_random_flip_top_bottom _image_resize _image_to_tensor
_random_exponential _random_gamma _random_generalized_negative_binomial
_random_negative_binomial _random_normal _random_poisson _random_randint
_random_uniform _sample_gamma _sample_multinomial _sample_normal
_sample_uniform _sample_unique_zipfian _shuffle bernoulli normal randint
randn random_exponential random_gamma random_generalized_negative_binomial
random_negative_binomial random_normal random_poisson random_randint
random_uniform sample_multinomial shuffle uniform
""".split()
OPS_TOL = 1e-5              # fp32, card vs CPU, over max(1, max |CPU|): the
                            # CPU tests' forward tolerance
OPS_LINALG_TOL = 1e-4       # the linalg_* ops: the CPU tests' tolerance
OPS_EXP_LOG_TOL = 1e-6      # box targets and decoded boxes (a log, an exp)


def op_cases():
    """{op name: [(inputs, kwargs, tolerance or a check of a draw)]}: every
    name of NEW_OPS at a small seeded shape. Inputs are numpy arrays or
    Python numbers."""
    r = np.random.RandomState(0)

    def N(*s):
        return r.randn(*s).astype(np.float32)

    def U(lo, hi, *s):
        return r.uniform(lo, hi, s).astype(np.float32)

    def I(lo, hi, *s, dt=np.float32):
        return r.randint(lo, hi, s).astype(dt)

    def spd(b, n):
        a = N(b, n, n)
        return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)

    def lower(b, n):
        return (np.tril(N(b, n, n) * .3, -1) + np.eye(n, dtype=np.float32)
                * U(2, 3, b, n, 1)).astype(np.float32)

    def boxes(*s):
        xy = U(0, .6, *s, 2)
        return np.concatenate([xy, xy + U(.05, .4, *s, 2)], -1)

    cases = collections.defaultdict(list)

    def add(names, args, kw=None, tol=OPS_TOL):
        for name in names.split():
            cases[name].append((args, kw or {}, tol))

    x = N(3, 4)
    add("sign expm1 sin cos tan arctan sinh cosh arcsinh erf softsign "
        "degrees radians logical_not ceil floor trunc fix round rint "
        "isnan isinf isfinite shape_array size_array _copyto "
        "BlockGrad_inner stop_gradient_passthrough hard_sigmoid softmin "
        "cast_storage", [x])
    add("reciprocal cbrt rcbrt", [U(.5, 2, 3, 4) * np.sign(N(3, 4))])
    add("rsqrt log2 log10 log1p gammaln digamma arccosh",
        [U(1.2, 4, 3, 4)])
    add("arcsin arccos arctanh erfinv", [U(-.9, .9, 3, 4)])
    add("gamma", [U(.5, 4, 3, 4)])
    add("amp_cast", [x], {"dtype": "float16"})
    add("broadcast_mod", [N(3, 4) * 3, U(.5, 2, 1, 4)])
    add("broadcast_power _power pow", [U(.5, 2, 3, 4), N(3, 1)])
    add("broadcast_hypot arctan2", [N(3, 4), N(1, 4)])
    add("broadcast_logical_and broadcast_logical_or broadcast_logical_xor",
        [I(0, 2, 3, 4), I(0, 2, 3, 4)])
    add("_plus_scalar _minus_scalar _mul_scalar _div_scalar _power_scalar",
        [U(.5, 2, 3, 4), 2.5])
    add("smooth_l1", [x * 2], {"scalar": 2.0})
    x3 = U(.5, 1.5, 2, 3, 4)
    add("prod max min nansum nanprod max_axis min_axis logsumexp", [x3],
        {"axis": 1})
    ties = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 5, 5, 1]], np.float32)
    add("argmax argmin", [ties], {"axis": 1})
    add("argsort", [ties], {"is_ascend": False})
    add("sort", [N(3, 5)], {"is_ascend": False})
    add("topk", [ties], {"k": 3, "ret_typ": "both"})
    add("cumsum", [N(3, 4)], {"axis": 1})
    add("squeeze", [N(2, 1, 3, 1)])
    add("moveaxis", [x3], {"source": 0, "destination": 2})
    add("broadcast_axis broadcast_axes", [N(2, 1, 3)], {"axis": 1,
                                                         "size": 4})
    add("tile", [x3], {"reps": (2, 1, 3)})
    add("repeat", [x3], {"repeats": 3, "axis": 1})
    add("slice", [x3], {"begin": (None, 2, 3), "end": (None, None, 0),
                        "step": (1, -1, -2)})
    add("slice_like", [N(4, 5), N(2, 3)])
    add("space_to_depth", [N(1, 2, 4, 6)], {"block_size": 2})
    add("depth_to_space", [N(1, 8, 2, 3)], {"block_size": 2})
    add("diag", [N(3, 4)], {"k": -1})
    add("eye", [], {"N": 3, "M": 4, "k": 1})
    add("take", [N(5, 3), np.array([0, 4, 7, -1], np.float32)],
        {"mode": "wrap"})
    add("take_along_axis", [N(3, 4), I(0, 4, 3, 2)], {"axis": 1})
    add("gather_nd", [N(3, 4, 5), I(0, 3, 2, 6)])
    add("scatter_nd", [N(5), np.array([[0, 1, 2, 2, 0], [3, 0, 1, 2, 2]],
                                      np.float32)], {"shape": (3, 4)})
    add("boolean_mask", [N(5, 3), np.array([1, 0, 1, 1, 0], np.float32)])
    add("where_index", [np.where(N(3, 4) > 0, 1.0, 0.0).astype(np.float32)])
    add("_internal_getitem", [x3], {"index": (slice(0, 2), 1)})
    add("batch_dot", [N(2, 3, 4), N(2, 4, 5)])
    add("linalg_gemm2", [N(2, 4, 3), N(2, 4, 5)], {"transpose_a": True},
        OPS_LINALG_TOL)
    add("linalg_potrf linalg_inverse linalg_sumlogdiag", [spd(2, 3)], {},
        OPS_LINALG_TOL)
    add("linalg_syrk", [N(2, 3, 4)], {}, OPS_LINALG_TOL)
    add("khatri_rao", [N(2, 3), N(4, 3)])
    xi = N(2, 4, 5, 6)
    g4, b4 = U(.5, 1.5, 4), N(4)
    add("BatchNorm_v1", [xi, g4, b4, N(4), U(.5, 2, 4)],
        {"fix_gamma": False, "use_global_stats": True})
    add("InstanceNorm", [xi, g4, b4])
    add("GroupNorm", [xi, g4, b4], {"num_groups": 2})
    add("L2Normalization", [xi], {"mode": "channel"})
    add("RMSNorm", [N(3, 5), U(.5, 1.5, 5)])
    add("SoftmaxActivation", [xi])
    add("softmax_cross_entropy", [N(4, 5), I(0, 5, 4)])
    add("UpSampling", [N(1, 2, 3, 4)], {"scale": 2,
                                        "sample_type": "bilinear"})
    add("BilinearSampler", [N(2, 2, 5, 6), U(-1.1, 1.1, 2, 2, 4, 3)])
    add("GridGenerator", [N(2, 6)], {"target_shape": (3, 4)})
    add("SpatialTransformer", [N(2, 2, 5, 6), N(2, 6) * .5],
        {"target_shape": (4, 3)})
    rois = np.array([[0, 1, 1, 6, 5], [1, 0, 2, 7, 7], [0, 3.4, .6, 5.2,
                                                       3.1]], np.float32)
    add("ROIPooling", [N(2, 3, 8, 9), rois], {"pooled_size": (2, 3),
                                              "spatial_scale": .9})
    add("Correlation", [N(1, 3, 7, 8), N(1, 3, 7, 8)],
        {"kernel_size": 3, "max_displacement": 2, "pad_size": 2})
    add("dot_scaled", [N(3, 4), N(4, 2)], {"scale": .5})
    add("crop Crop", [N(1, 2, 6, 7)], {"h_w": (3, 4), "offset": (1, 2)})
    add("_contrib_div_sqrt_dim", [N(2, 3, 16)])
    add("Deconvolution", [N(2, 3, 5, 4), N(3, 4, 3, 3), N(4)],
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
         "num_filter": 4, "no_bias": False})
    add("Deconvolution", [N(2, 3, 4, 5, 3), N(3, 2, 2, 3, 3)],
        {"kernel": (2, 3, 3), "stride": (1, 2, 2), "num_filter": 2})
    add("IdentityAttachKLSparseReg", [U(.1, .9, 4, 3)])
    add("LRN", [N(2, 6, 3, 3)], {"nsize": 3})
    add("SVMOutput", [N(4, 5), I(0, 5, 4)], {"margin": .5})
    add("argmax_channel", [N(3, 4, 2)])
    add("batch_take", [N(4, 5), I(0, 5, 4)])
    add("broadcast_like", [N(1, 3), N(4, 3)])
    add("im2col", [N(2, 2, 4, 5)], {"kernel": (2, 3), "pad": (1, 0)})
    add("col2im", [N(1, 8, 12)], {"output_size": (4, 5), "kernel": (2, 2)})
    add("fill_element_0index", [N(3, 4), I(0, 4, 3), N(3)])
    add("make_loss", [x], {"grad_scale": 2.0})
    add("moments", [N(3, 4, 5)], {"axes": (0, 2)})
    add("ravel_multi_index", [np.array([[0, 3, 5, 1], [2, 0, 7, 5]],
                                       np.float32)], {"shape": (4, 6)})
    add("unravel_index", [np.array([0, 5, 23, 11], np.float32)],
        {"shape": (4, 6)})
    add("reshape_like", [N(2, 6, 5), N(2, 3)], {"lhs_begin": 1, "lhs_end": 2,
                                                "rhs_begin": 0,
                                                "rhs_end": 2})
    add("linspace", [], {"start": -1.0, "stop": 2.0, "num": 7})
    add("linalg_det linalg_slogdet", [N(2, 3, 3)], {}, OPS_LINALG_TOL)
    add("linalg_potri", [np.linalg.cholesky(spd(2, 3)).astype(np.float32)],
        {}, OPS_LINALG_TOL)
    add("linalg_gemm", [N(2, 3, 4), N(2, 5, 4), N(2, 3, 5)],
        {"transpose_b": True, "beta": 2.0}, OPS_LINALG_TOL)
    add("linalg_trmm linalg_trsm", [lower(2, 3), N(2, 3, 3)],
        {"rightside": True, "transpose": True}, OPS_LINALG_TOL)
    add("linalg_gelqf", [N(2, 3, 5)], {}, OPS_LINALG_TOL)
    add("linalg_makediag", [N(2, 3)], {"offset": 1})
    add("linalg_extractdiag", [N(2, 3, 4)], {"offset": -1})
    add("linalg_maketrian", [N(2, 6)])
    add("linalg_extracttrian", [N(2, 3, 3)], {"lower": False})
    # detection and contrib vision
    feat = np.zeros((2, 3, 5, 7), np.float32)
    add("_contrib_MultiBoxPrior", [feat], {"sizes": (.2, .35),
                                           "ratios": (1, 2, .5)})
    n = 5 * 7 * 4
    anchors = np.concatenate([boxes(1, n)], 0).astype(np.float32)
    label = np.full((2, 4, 5), -1, np.float32)
    label[:, :3, 0] = I(0, 3, 2, 3)
    label[:, :3, 1:] = boxes(2, 3)
    prob = r.dirichlet(np.ones(4), (2, n)).astype(np.float32).transpose(
        0, 2, 1).copy()
    add("_contrib_MultiBoxTarget", [anchors, label, prob],
        {"negative_mining_ratio": 3.0}, OPS_EXP_LOG_TOL)
    add("_contrib_MultiBoxDetection", [prob, N(2, n * 4) * .2, anchors],
        {"nms_threshold": .45, "nms_topk": 50}, OPS_EXP_LOG_TOL)
    nms = np.concatenate([I(0, 3, 2, 40, 1), r.choice(
        [.2, .5, .7, .9], (2, 40, 1)).astype(np.float32),
        boxes(2, 40) * .5], -1).astype(np.float32)
    add("_contrib_box_nms", [nms], {"id_index": 0, "topk": 25})
    add("_contrib_box_iou", [boxes(2, 5), boxes(2, 6)])
    add("_contrib_box_encode", [U(0, 1, 2, 5), I(0, 6, 2, 5), boxes(2, 5),
                                boxes(2, 6)], {}, OPS_EXP_LOG_TOL)
    add("_contrib_box_decode", [N(2, 5, 4) * .3, boxes(2, 5)], {"clip": .2},
        OPS_EXP_LOG_TOL)
    img = U(0, 1, 2, 3, 9, 11)
    add("_contrib_BilinearResize2D _contrib_bilinear_resize2d", [img],
        {"height": 5, "width": 17})
    add("_contrib_AdaptiveAvgPooling2D _contrib_adaptive_avg_pooling2d",
        [img], {"output_size": (4, 3)})
    add("_contrib_ROIAlign", [img, rois], {"pooled_size": (3, 2),
                                           "spatial_scale": .9})
    add("_contrib_PSROIPooling", [U(0, 1, 2, 18, 9, 11), rois],
        {"spatial_scale": .9, "output_dim": 2, "pooled_size": 3})
    add("_contrib_DeformableConvolution", [U(0, 1, 2, 4, 6, 7),
                                           N(2, 36, 6, 7) * .8,
                                           N(5, 4, 3, 3), N(5)],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5,
         "num_deformable_group": 2})
    add("_contrib_arange_like", [img], {"start": 2, "step": .5,
                                        "repeat": 3})
    # quantization: integer results exact
    rng8 = [np.array(v, np.float32) for v in (-1.5, 1.2, -.4, .6, -2., 2.)]
    add("_contrib_quantize_v2", [N(4, 5) * .7], {}, 0.0)
    add("_contrib_dequantize", [I(-127, 128, 3, 4, dt=np.int8), rng8[0],
                                rng8[1]], {}, 0.0)
    add("_contrib_requantize", [I(-200000, 200000, 3, 4, dt=np.int32),
                                rng8[4], rng8[5]], {}, 0.0)
    add("_contrib_quantized_fully_connected",
        [I(-127, 128, 3, 16, dt=np.int8), I(-127, 128, 6, 16, dt=np.int8),
         I(-127, 128, 6, dt=np.int8)] + rng8, {"num_hidden": 6}, 0.0)
    add("_contrib_quantized_conv",
        [I(-127, 128, 2, 4, 9, 10, dt=np.int8),
         I(-127, 128, 5, 4, 3, 3, dt=np.int8), I(-127, 128, 5, dt=np.int8)]
        + rng8, {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5}, 0.0)
    # images
    u8 = I(0, 256, 2, 6, 8, 3, dt=np.uint8)
    add("_image_to_tensor _image_flip_left_right _image_flip_top_bottom",
        [u8])
    add("_image_crop", [u8], {"x": 1, "y": 2, "width": 3, "height": 2})
    add("_image_normalize", [U(0, 1, 2, 3, 5, 6)],
        {"mean": (.4, .5, .6), "std": (.2, .3, .25)})
    add("_image_resize", [U(0, 255, 2, 6, 8, 3)], {"size": (9, 7)})

    # draws: shape and dtype as on the CPU, values in range
    def within(lo, hi, integral=False):
        def check(got):
            return bool(np.all(got >= lo) and np.all(got < hi) and (
                not integral or np.all(got == np.round(got))))
        return check

    big = 4096
    for name in ("_random_uniform", "uniform", "random_uniform"):
        cases[name].append(([], {"low": -2.0, "high": 3.0, "shape": (big,)},
                            within(-2.0, 3.0)))
    for name in ("_random_normal", "normal", "random_normal", "randn"):
        cases[name].append(([], {"loc": 1.0, "scale": 2.0, "shape": (big,)},
                            lambda g: bool(np.isfinite(g).all()
                                           and abs(g.mean() - 1) < .3)))
    for name in ("_random_randint", "randint", "random_randint"):
        cases[name].append(([], {"low": -3, "high": 7, "shape": (big,)},
                            within(-3, 7, True)))
    for name in ("_random_gamma", "random_gamma"):
        cases[name].append(([], {"alpha": 2.5, "beta": .5, "shape": (big,)},
                            within(0, np.inf)))
    for name in ("_random_exponential", "random_exponential"):
        cases[name].append(([], {"lam": 4.0, "shape": (big,)},
                            within(0, np.inf)))
    for name in ("_random_poisson", "random_poisson"):
        cases[name].append(([], {"lam": 3.5, "shape": (big,)},
                            within(0, np.inf, True)))
    for name in ("_random_negative_binomial", "random_negative_binomial"):
        cases[name].append(([], {"k": 3, "p": .4, "shape": (big,)},
                            within(0, np.inf, True)))
    for name in ("_random_generalized_negative_binomial",
                 "random_generalized_negative_binomial"):
        cases[name].append(([], {"mu": 2.0, "alpha": .5, "shape": (big,)},
                            within(0, np.inf, True)))
    cases["_sample_unique_zipfian"].append(
        ([], {"range_max": 1000, "shape": (big,)}, within(0, 1000, True)))
    cases["_sample_uniform"].append(([np.array([0., -1.], np.float32),
                                      np.array([1., 1.], np.float32)],
                                     {"shape": (big,)}, within(-1, 1)))
    cases["_sample_normal"].append(([np.array([0., 3.], np.float32),
                                     np.array([1., .5], np.float32)],
                                    {"shape": (big,)},
                                    lambda g: bool(np.isfinite(g).all())))
    cases["_sample_gamma"].append(([np.array([.5, 4.], np.float32),
                                    np.array([2., .25], np.float32)],
                                   {"shape": (big,)}, within(0, np.inf)))
    for name in ("_sample_multinomial", "sample_multinomial"):
        cases[name].append(([np.array([[.1, .2, .7], [.5, .25, .25]],
                                      np.float32)], {"shape": (big,)},
                            within(0, 3, True)))
    for name in ("_shuffle", "shuffle"):
        cases[name].append(([np.arange(64, dtype=np.float32)], {},
                            lambda g: bool(np.array_equal(np.sort(g),
                                                          np.arange(64)))))
    cases["bernoulli"].append(([np.full((big,), .3, np.float32)], {},
                               within(0, 2, True)))
    flip = I(0, 256, 4, 5, 3, dt=np.uint8)
    for name, axis in (("_image_random_flip_left_right", 1),
                       ("_image_random_flip_top_bottom", 0)):
        cases[name].append(([flip], {}, lambda g, a=axis: bool(
            np.array_equal(g, flip) or np.array_equal(g, np.flip(flip, a)))))
    pix = U(1, 200, 4, 5, 3)
    cases["_image_random_brightness"].append(
        ([pix], {"min_factor": .5, "max_factor": 1.5},
         lambda g: bool(np.all((g / pix >= .5 - 1e-5)
                               & (g / pix <= 1.5 + 1e-5)))))
    cases["_image_random_contrast"].append(
        ([pix], {"min_factor": .5, "max_factor": 1.5},
         lambda g: bool(np.isfinite(g).all())))
    return cases


def _op_outputs(mx, name, args, kw, ctx):
    vals = [mx.nd.array(a, ctx=ctx, dtype=a.dtype)
            if isinstance(a, np.ndarray) else a for a in args]
    out = mx.nd.invoke(name, *vals, ctx=ctx, **kw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        check(o.context == ctx, "ops", "%s gave an array on %s, not %s"
              % (name, o.context, ctx))
    return [o.asnumpy() for o in outs]


def _ops_err(got, want):
    """Max error over max(1, max |want|); inf where shape, dtype, NaNs or
    infinities differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return math.inf
    if got.dtype.kind in "biu":
        return 0.0 if np.array_equal(got, want) else math.inf
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return math.inf
    fin = np.isfinite(want)
    if not np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)]):
        return math.inf
    if not fin.any():
        return 0.0
    scale = max(1.0, float(np.abs(want[fin]).max()))
    return float(np.abs(got[fin].astype(np.float64)
                        - want[fin].astype(np.float64)).max()) / scale


def phase_ops():
    """Every op of the op-set slice (NEW_OPS) once on the card at a small
    seeded shape against the port's CPU result: within the CPU tests'
    tolerances (1e-5 fp32, 1e-4 linalg, 1e-6 the box log/exp, integers
    exact); the draws held to the CPU's shape and dtype and to their range.
    Each result must lie on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.ops import registry
    phase = "ops"
    cases = op_cases()
    check(set(cases) == set(NEW_OPS) and len(NEW_OPS) == 205
          and set(NEW_OPS) <= set(registry.list_ops()), phase,
          "the table and the registry disagree: %s"
          % sorted(set(NEW_OPS) ^ set(cases)))
    gpu, cpu = mx.gpu(0), mx.cpu()
    worst, failed, runs = {}, [], 0
    reset_launch_counts()
    t0 = time.perf_counter()
    for name in NEW_OPS:
        for args, kw, tol in cases[name]:
            mx.random.seed(7)
            got = _op_outputs(mx, name, args, kw, gpu)
            mx.random.seed(7)
            want = _op_outputs(mx, name, args, kw, cpu)
            runs += 1
            if callable(tol):
                ok = len(got) == len(want) and all(
                    g.shape == w.shape and g.dtype == w.dtype
                    for g, w in zip(got, want)) and all(tol(g) for g in got)
                worst[name] = 0.0 if ok else math.inf
            else:
                err = max(_ops_err(g, w) for g, w in zip(got, want))
                ok = len(got) == len(want) and err <= tol
                worst[name] = max(worst.get(name, 0.0), err)
            if not ok:
                failed.append(name)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: v for k, v in launch_counts().items() if v}
    emit({"phase": phase, "ops": len(cases), "runs": runs,
          "seconds": secs, "failed": failed,
          "max_err_over_1e-7": sum(1 for v in worst.values() if v > 1e-7),
          "worst": dict(sorted(worst.items(), key=lambda kv: -kv[1])[:8]),
          "kernel_launches": launched})
    check(not failed, phase, "ops off the CPU result: %s" % failed)


SSD_BATCH, SSD_IMAGE, SSD_CLASSES, SSD_MAX_BOXES = 32, 512, 20, 16
SSD_FILTERS = [512, 256, 256, 128]      # symbol_factory get_config
SSD_SIZES = [[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79],
             [.88, .961]]
SSD_RATIOS = [[1, 2, .5]] + [[1, 2, .5, 3, 1 / 3.]] * 3 + [[1, 2, .5]] * 2
SSD_ANCHORS = 6132
SSD_WARMUP, SSD_STEPS, SSD_LAT_CALLS = 3, 10, 20
SSD_KERNELS_TRAIN = ("conv_bn_stats", "cbr_train_bwd", "flat_sgd")
SSD_TARGET_KW = dict(overlap_threshold=0.5, ignore_label=-1,
                     negative_mining_ratio=3, negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2))
SSD_DETECT_KW = dict(nms_threshold=0.45, nms_topk=400, threshold=0.01,
                     force_suppress=False)


def ssd_net(mx):
    """SSD-512 over resnet50_v1 (NHWC, the fused conv-BN-ReLU gate on), as
    upstream MXNet's example/ssd symbol_factory.get_config("resnet50",
    512) lays it out: the ends of stages 3 and 4 (upstream's _plus12 and
    _plus15), then one 1x1 conv to max(128, f / 2) + ReLU and one 3x3
    stride-2 conv to f + ReLU for each of `filters`; a 3x3 class head and
    box head on each of the six maps, flattened cell-major (as
    examples/ssd_detection.py's TinySSD does) and concatenated. Built from
    public Gluon blocks; returns (cls (B, N, classes + 1), box (B, 4 N))."""
    os.environ["MXNET_TPU_FUSED_CONVBN"] = "1"
    nn = mx.gluon.nn
    classes = SSD_CLASSES
    anchors = [len(s) + len(r) - 1 for s, r in zip(SSD_SIZES, SSD_RATIOS)]

    class SSD(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.base = mx.gluon.model_zoo.vision.resnet50_v1(
                    layout="NHWC")
                self.extras = nn.HybridSequential()
                for f in SSD_FILTERS:
                    blk = nn.HybridSequential()
                    blk.add(nn.Conv2D(max(128, f // 2), 1, layout="NHWC"),
                            nn.Activation("relu"),
                            nn.Conv2D(f, 3, 2, 1, layout="NHWC"),
                            nn.Activation("relu"))
                    self.extras.add(blk)
                self.cls_heads = nn.HybridSequential()
                self.box_heads = nn.HybridSequential()
                for a in anchors:
                    self.cls_heads.add(nn.Conv2D(a * (classes + 1), 3, 1, 1,
                                                 layout="NHWC"))
                    self.box_heads.add(nn.Conv2D(a * 4, 3, 1, 1,
                                                 layout="NHWC"))

        def feature_maps(self, x):
            stages = list(self.base.features._children.values())[:-1]
            for blk in stages[:-1]:
                x = blk(x)
            maps = [x, stages[-1](x)]
            for blk in self.extras._children.values():
                maps.append(blk(maps[-1]))
            return maps

        def hybrid_forward(self, F, x):
            cls, box = [], []
            for m, ch, bh in zip(self.feature_maps(x),
                                 self.cls_heads._children.values(),
                                 self.box_heads._children.values()):
                cls.append(F.reshape(ch(m), shape=(0, -1, classes + 1)))
                box.append(F.reshape(bh(m), shape=(0, -1)))
            return F.concat(*cls, dim=1), F.concat(*box, dim=1)

    with mx.name.NameManager():
        return SSD(prefix="ssd_")


def ssd_anchors(mx, net, image, ctx):
    """MultiBoxPrior over each map, given an NCHW-shaped (1, 1, H, W) array
    of the map's size (the op reads shape[2], shape[3])."""
    with mx.autograd.predict_mode():
        maps = net.feature_maps(mx.nd.zeros((1, image, image, 3), ctx=ctx,
                                            dtype=net_dtype(net)))
    per = [mx.nd.contrib.MultiBoxPrior(
        mx.nd.zeros((1, 1, m.shape[1], m.shape[2]), ctx=ctx), sizes=s,
        ratios=r, clip=False) for m, s, r in zip(maps, SSD_SIZES,
                                                  SSD_RATIOS)]
    return mx.nd.concat(*per, dim=1), [m.shape[1:3] for m in maps]


def net_dtype(net):
    return next(iter(net.base.collect_params().values())).data().dtype


def ssd_data(n_batches, batch, image, classes, seed=0):
    """Seeded uint8 NHWC images (noise under 60, 1 to 8 filled rectangles,
    each class its own color) and labels [cls, x1, y1, x2, y2] in [0, 1],
    padded to SSD_MAX_BOXES rows with -1."""
    rng = np.random.RandomState(seed)
    colors = rng.randint(80, 256, (classes, 3)).astype(np.uint8)
    out = []
    for _ in range(n_batches):
        x = rng.randint(0, 60, (batch, image, image, 3)).astype(np.uint8)
        y = np.full((batch, SSD_MAX_BOXES, 5), -1, np.float32)
        for i in range(batch):
            for j in range(rng.randint(1, 9)):
                w, h = rng.randint(image // 16, image // 2, 2)
                x0 = rng.randint(0, image - w)
                y0 = rng.randint(0, image - h)
                c = rng.randint(0, classes)
                x[i, y0:y0 + h, x0:x0 + w] = colors[c]
                y[i, j] = [c, x0 / image, y0 / image, (x0 + w) / image,
                           (y0 + h) / image]
        out.append((x, y))
    return out


def ssd_inputs(mx, x, y, ctx, dtype):
    """uint8 images -> [0, 1] in `dtype` on `ctx`; labels float32."""
    xs = (mx.nd.array(x, ctx=ctx, dtype="uint8").astype("float32")
          / 255.0).astype(dtype)
    return xs, mx.nd.array(y, ctx=ctx)


def ssd_step(mx, net, anchors, x, y, trainer, cls_loss, box_loss):
    """One training step: heads to fp32, MultiBoxTarget with hard-negative
    mining, SoftmaxCrossEntropyLoss with the keep mask, HuberLoss on the
    masked boxes, Trainer.step. Returns (loss, prob, targets)."""
    b = x.shape[0]
    with mx.autograd.record():
        cls, box = net(x)
        cls, box = cls.astype("float32"), box.astype("float32")
        prob = mx.nd.softmax(mx.nd.transpose(cls, axes=(0, 2, 1)), axis=1)
        bt, bm, ct = mx.nd.contrib.MultiBoxTarget(anchors, y, prob,
                                                  **SSD_TARGET_KW)
        keep = (ct >= 0).reshape((b, -1, 1))
        loss = cls_loss(cls, ct, keep).mean() + \
            box_loss(box * bm, bt * bm).mean()
    loss.backward()
    trainer.step(b)
    return loss, prob, (bt, bm, ct)


def ssd_detect(mx, net, anchors, x):
    with mx.autograd.predict_mode():
        cls, box = net(x)
        prob = mx.nd.softmax(mx.nd.transpose(cls.astype("float32"),
                                             axes=(0, 2, 1)), axis=1)
        return mx.nd.contrib.MultiBoxDetection(
            prob, box.astype("float32"), anchors, **SSD_DETECT_KW), prob, box


def trainer_table(trainer):
    """(indices, [(shape, dtype)]) of a Trainer's trainable parameters."""
    idx = [i for i, p in enumerate(trainer._params) if p.grad_req != "null"]
    return idx, [(trainer._params[i].shape,
                  trainer._params[i].data().data_torch.dtype) for i in idx]


def trainer_sgd_call(label, trainer):
    """A path's #7 call as kernel_opt_paths takes it: the Trainer's multi
    launch over every trainable parameter (their shapes and dtypes, and
    the lr and wd the optimizer gives each), its momentum and its rescale
    (1 / batch)."""
    opt = trainer.optimizer
    idx, table = trainer_table(trainer)
    params = [(shape, dt, lr, wd) for (shape, dt), lr, wd in zip(
        table, opt._get_lrs(idx), opt._get_wds(idx))]
    return {label: (params, opt.momentum, opt.rescale_grad,
                    opt.clip_gradient, True)}


def host_ms(fn, calls=5):
    """Median wall ms of fn() between two synchronizes (host dispatch and
    device time together)."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_ssd_resnet50(batch=SSD_BATCH, image=SSD_IMAGE):
    """Main path 15: SSD-512 on resnet50_v1 NHWC with the fused gate, bf16
    (heads cast to fp32 before the MultiBox ops and losses), 21 classes,
    6,132 anchors; Trainer("sgd", lr 0.002, momentum 0.9, wd 0.0005) as
    upstream's train.py; seeded synthetic images and boxes (VOC is not in
    the repository). Counts set to 0 just before the timed training steps
    and read just after (16 conv_bn_stats, 16 cbr_train_bwd and one multi
    flat_sgd a step, nothing else), and around one batch-32 forward in
    predict mode (16 conv_bn_relu). Every variant of #4-#6 that the path
    launched was held to its plain version at the path's shapes
    (SSD_CHECKED_VARIANTS), and the Trainer's #7 call over this net's
    parameter table at 0 ulps (kernel_opt_paths). The loss falls; the
    three MultiBox ops on the last timed step's own tensors equal the CPU
    route's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    phase = "ssd_resnet50"
    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = ssd_net(mx)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", magnitude=2), ctx=gpu)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, image, image, 3), ctx=gpu))
    net.cast("bfloat16")
    net.hybridize(static_alloc=True)
    anchors, map_hw = ssd_anchors(mx, net, image, gpu)
    check(image != SSD_IMAGE or (anchors.shape == (1, SSD_ANCHORS, 4)
                                 and map_hw == [(32, 32), (16, 16), (8, 8),
                                                (4, 4), (2, 2), (1, 1)]),
          phase, "anchors %s over maps %s" % (anchors.shape, map_hw))
    data = [ssd_inputs(mx, x, y, gpu, "bfloat16")
            for x, y in ssd_data(2, batch, image, SSD_CLASSES)]
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.002, "momentum": 0.9, "wd": 0.0005})
    cls_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    box_loss = mx.gluon.loss.HuberLoss()
    telemetry.reset()

    losses = []
    for i in range(SSD_WARMUP):
        losses.append(ssd_step(mx, net, anchors, *data[i % 2], trainer,
                               cls_loss, box_loss)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(SSD_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, prob, targets = ssd_step(mx, net, anchors, *data[i % 2],
                                       trainer, cls_loss, box_loss)
        end.record()
        losses.append(loss)
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    window_s = time.perf_counter() - t0
    launches, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated()
    last_x, last_y = data[(SSD_STEPS - 1) % 2]
    losses = [float(l.asscalar()) for l in losses]
    # the last timed step's targets through the CPU route
    cpu = mx.cpu()
    on_cpu = [a.as_in_context(cpu) for a in (anchors, last_y, prob)]
    want = [t.asnumpy() for t in mx.nd.contrib.MultiBoxTarget(
        *on_cpu, **SSD_TARGET_KW)]
    got = [t.asnumpy() for t in targets]
    target_err = float(np.abs(got[0] - want[0]).max())
    target_equal = bool(np.array_equal(got[1], want[1])
                        and np.array_equal(got[2], want[2]))
    # #7 as the Trainer called it, at 0 ulps (outside the counted window)
    opt_rec = kernel_opt_paths(torch.Generator(device="cuda").manual_seed(
        15), trainer_sgd_call("ssd_resnet50", trainer))["ssd_resnet50"]

    # the MultiBox ops alone, and one profiled step
    target_ms = host_ms(lambda: mx.nd.contrib.MultiBoxTarget(
        anchors, last_y, prob, **SSD_TARGET_KW))
    profile = profile_window(lambda: ssd_step(
        mx, net, anchors, last_x, last_y, trainer, cls_loss, box_loss))

    # inference: a batch-32 forward counted, detections vs the CPU route,
    # images/s, batch-1 latency
    reset_launch_counts()
    dets, dprob, dbox = ssd_detect(mx, net, anchors, last_x)
    torch.cuda.synchronize()
    infer_launches = launch_counts()
    path_variants = {"%s/%s" % k for k, c in variants.items() if c} | {
        "%s/%s" % k for k, c in variant_counts().items() if c}
    unchecked = sorted(path_variants - SSD_CHECKED_VARIANTS
                       - {"flat_sgd/multi"})
    det = dets.asnumpy()
    det_cpu = mx.nd.contrib.MultiBoxDetection(
        dprob.as_in_context(cpu), dbox.astype("float32").as_in_context(cpu),
        anchors.as_in_context(cpu), **SSD_DETECT_KW).asnumpy()
    det_equal = bool(np.array_equal(det[..., :2], det_cpu[..., :2]))
    det_box_err = float(np.abs(det[..., 2:] - det_cpu[..., 2:]).max())
    detect_ms = host_ms(lambda: mx.nd.contrib.MultiBoxDetection(
        dprob, dbox.astype("float32"), anchors, **SSD_DETECT_KW))
    infer_ms = host_ms(lambda: ssd_detect(mx, net, anchors, last_x)[0])
    one = last_x[:1]
    for _ in range(3):
        ssd_detect(mx, net, anchors, one)
    lat = []
    for _ in range(SSD_LAT_CALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ssd_detect(mx, net, anchors, one)[0].asnumpy()
        lat.append((time.perf_counter() - t1) * 1e3)
    lat.sort()
    fallback = telemetry.counter_value("compiler.fallback")

    rec = {"phase": phase, "config": "SSD-512, resnet50_v1 NHWC fused, "
           "bf16 (fp32 heads into MultiBox/losses), %d classes + background,"
           " filters %s, batch %d at %dx%d, sgd lr 0.002 momentum 0.9 wd "
           "5e-4" % (SSD_CLASSES, SSD_FILTERS, batch, image, image),
           "anchors": anchors.shape[1], "maps": map_hw,
           "warmup": SSD_WARMUP, "steps": SSD_STEPS,
           "images_per_s": batch * SSD_STEPS / window_s,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "multibox_target_host_ms": target_ms,
           "multibox_detection_host_ms": detect_ms,
           "max_memory_allocated_bytes": peak, "profile_one_step": profile,
           "infer_images_per_s": batch / infer_ms * 1e3,
           "infer_batch_ms": infer_ms,
           "batch1_ms_p50": lat[len(lat) // 2],
           "batch1_ms_p99": lat[min(len(lat) - 1,
                                    int(round(.99 * (len(lat) - 1))))],
           "losses": losses,
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "infer_launches": {k: c for k, c in infer_launches.items() if c},
           "variants_unchecked_at_path_shapes": unchecked,
           "flat_sgd_path_call": {k: opt_rec[k] for k in (
               "tensors", "elements", "dtypes", "max_ulps", "ms",
               "device_ms", "plain_ms", "bound_ms", "bound_by")},
           "target_box_err_vs_cpu": target_err,
           "target_cls_mask_equal_cpu": target_equal,
           "detections_ids_scores_equal_cpu": det_equal,
           "detection_box_err_vs_cpu": det_box_err,
           "detections_kept": int((det[..., 0] >= 0).sum()),
           "compiler_fallback": fallback, "card": card_name_and_limit()}
    emit(rec)
    check(launches["conv_bn_stats"] == 16 * SSD_STEPS
          and launches["cbr_train_bwd"] == 16 * SSD_STEPS
          and launches["flat_sgd"] == SSD_STEPS
          and variants.get(("flat_sgd", "multi")) == SSD_STEPS
          and sum(launches.values()) == 33 * SSD_STEPS, phase,
          "training launches %s (%s), expected 16 conv_bn_stats, 16 "
          "cbr_train_bwd and one multi flat_sgd a step" % (launches,
                                                             variants))
    check(infer_launches["conv_bn_relu"] == 16
          and sum(infer_launches.values()) == 16, phase,
          "predict-mode launches %s, expected 16 conv_bn_relu"
          % infer_launches)
    check(not unchecked, phase, "kernel variants launched on the path but "
          "not held to their plain versions at its shapes: %s" % unchecked)
    check(all(np.isfinite(losses))
          and statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
          phase, "loss not finite or not falling: %s" % losses)
    check(target_equal and target_err <= OPS_EXP_LOG_TOL, phase,
          "MultiBoxTarget on the card vs the CPU: cls/mask equal %s, box "
          "targets %.3g apart" % (target_equal, target_err))
    check(det_equal and det_box_err <= OPS_EXP_LOG_TOL
          and det.shape == (batch, anchors.shape[1], 6)
          and np.isfinite(det).all(), phase,
          "MultiBoxDetection on the card vs the CPU: ids/scores equal %s, "
          "boxes %.3g apart, shape %s" % (det_equal, det_box_err, det.shape))
    check(fallback == 0, phase, "compiler.fallback %s" % fallback)
    check(profile["device_ms"] > 0, phase, "the profiler saw no device time")
    return launches, infer_launches


# -- main path 16: Inception-v3 training and the model zoo's families ------
INC_BATCH, INC_IMAGE, INC_CLASSES = 64, 299, 1000
INC_WARMUP, INC_STEPS = 3, 10
INC_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
INC_CPU_BATCH = 4
INC_LOSS_REL = 1e-5             # the first step's loss, card vs CPU: fp32
                                # on both sides (TF32 off), only the
                                # summation order differs
INC_GRAD_REL = 1e-3             # per-leaf ||card - cpu|| / ||cpu|| of the
                                # first step's gradients: the limit, or
                                # twice the card's own spread under a
                                # one-ulp weight change where that is larger
ZOO_FAMILIES = [("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
                ("densenet121", 224), ("mobilenet1.0", 224),
                ("mobilenetv2_1.0", 224), ("inceptionv3", 299)]
ZOO_CPU_BATCH, ZOO_BATCH, ZOO_CALLS = 2, 64, 5


def zoo_net(mx, name, seed, ctx, hw):
    """get_model(name) on ctx with seeded weights (Xavier, gaussian,
    fan-in, magnitude 2), BatchNorm's vectors as `randomize` draws them,
    shapes resolved by one predict-mode forward, hybridized."""
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.get_model(name)
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, hw, hw), ctx=ctx))
    g = torch.Generator(device=ctx.torch_device).manual_seed(seed)
    for pname, p in net.collect_params().items():
        if pname.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array(torch.rand(
                p.shape, generator=g, device=ctx.torch_device) + 0.5,
                ctx=ctx))
        elif pname.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array(torch.randn(
                p.shape, generator=g, device=ctx.torch_device) * 0.1,
                ctx=ctx))
    net.hybridize(static_alloc=True)
    return net


def cpu_twin(mx, name, path):
    """The same zoo net on the CPU from a save_parameters file."""
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.get_model(name)
    net.load_parameters(path, ctx=mx.cpu())
    net.hybridize(static_alloc=True)
    return net


def nudge(net):
    """Move every trainable parameter of `net` up by one ulp."""
    params = net.collect_params()
    for k, v in nudged({k: p.data() for k, p in params.items()
                        if p.grad_req != "null"}).items():
        params[k].set_data(v)


def without_dropout(net):
    """Dropout off in every block (each device draws its own masks)."""
    import mxnet_tpu_torch as mx
    net.apply(lambda b: isinstance(b, mx.gluon.nn.Dropout)
              and setattr(b, "_rate", 0.0))
    return net


def sce_grads(mx, net, x, y, ctx):
    """One recorded forward + SoftmaxCrossEntropyLoss + backward: (mean
    loss, {name: gradient on the host})."""
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = sce(net(mx.nd.array(x, ctx=ctx)),
                   mx.nd.array(y, ctx=ctx)).mean()
    loss.backward()
    return float(loss.asscalar()), {
        k: p.grad(ctx).data_torch.detach().float().cpu()
        for k, p in net.collect_params().items() if p.grad_req != "null"}


def zoo_families(tmp):
    """Each family in predict mode: batch ZOO_CPU_BATCH against its twin
    on the CPU (fp32 logits within RESNET_FP32_REL, top-1 equal), then
    images/s at batch ZOO_BATCH over ZOO_CALLS calls by CUDA events."""
    import mxnet_tpu_torch as mx
    gpu = mx.gpu(0)
    out = {}
    for i, (name, hw) in enumerate(ZOO_FAMILIES):
        net = zoo_net(mx, name, 100 + i, gpu, hw)
        path = os.path.join(tmp, "zoo_%s.params" % name)
        net.save_parameters(path)
        x = np.random.RandomState(i).rand(ZOO_BATCH, 3, hw, hw).astype(
            np.float32)
        got = logits_of(net, x[:ZOO_CPU_BATCH], gpu)
        want = logits_of(cpu_twin(mx, name, path), x[:ZOO_CPU_BATCH],
                         mx.cpu())
        rel = compare_logits(got, want, RESNET_FP32_REL, "zoo_inception_v3",
                             "%s at batch %d vs the CPU" % (
                                 name, ZOO_CPU_BATCH))
        xb = mx.nd.array(x, ctx=gpu)
        with mx.autograd.predict_mode():
            net(xb)
            ms = time_ms(lambda: net(xb), iters=ZOO_CALLS, warmup=1)
        out[name] = {"image": hw, "params": sum(
            p.data().size for p in net.collect_params().values()),
            "logits_rel_vs_cpu": rel, "batch": ZOO_BATCH,
            "forward_ms": ms, "images_per_s": ZOO_BATCH / ms * 1e3}
        del net, xb
        os.remove(path)
        torch.cuda.empty_cache()
    return out


def phase_zoo_inception_v3(tmp):
    """Main path 16: get_model("inceptionv3") at full width (1000 classes,
    299x299, NCHW, fp32), hybridized, SoftmaxCrossEntropyLoss and
    Trainer("sgd", lr 0.01, momentum 0.9, wd 1e-4) on one seeded batch of
    64: 3 warm-up and 10 timed steps, counts reset just before the timed
    steps and read just after (one multi flat_sgd per 320 trainable
    tensors a step, nothing else); the loss falls; the Trainer's #7 call
    over this net's table at 0 ulps (kernel_opt_paths); the first step's
    loss and gradients at batch 4 against the CPU; then the other
    families in predict mode (zoo_families). Run whole under cuDNN's
    deterministic algorithms. Returns the timed steps' launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    phase = "zoo_inception_v3"
    gpu, cpu = mx.gpu(0), mx.cpu()
    torch.backends.cudnn.deterministic = True
    try:
        net = zoo_net(mx, "inceptionv3", 0, gpu, INC_IMAGE)
        init_path = os.path.join(tmp, "inception_init.params")
        net.save_parameters(init_path)
        n_tensors = sum(p.grad_req != "null"
                        for p in net.collect_params().values())
        rng = np.random.RandomState(16)
        x = rng.rand(INC_BATCH, 3, INC_IMAGE, INC_IMAGE).astype(np.float32)
        y = rng.randint(0, INC_CLASSES, INC_BATCH).astype(np.float32)
        xb, yb = mx.nd.array(x, ctx=gpu), mx.nd.array(y, ctx=gpu)
        sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(INC_SGD))

        def step():
            with mx.autograd.record():
                loss = sce(net(xb), yb)
            loss.backward()
            trainer.step(INC_BATCH)
            return loss.mean()

        losses = [step() for _ in range(INC_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(INC_STEPS + 1)]
        reset_launch_counts()
        t0 = time.perf_counter()
        events[0].record()
        for i in range(INC_STEPS):
            losses.append(step())
            events[i + 1].record()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches, variants = launch_counts(), variant_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v.asscalar()) for v in losses]
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(INC_STEPS)]
        per_step = multi_launches("flat_sgd", n_tensors)
        profile = profile_window(step)
        # #7 as the Trainer called it, at 0 ulps (outside the counted window)
        opt_rec = kernel_opt_paths(
            torch.Generator(device="cuda").manual_seed(16),
            trainer_sgd_call(phase, trainer))[phase]
        del net, trainer, xb, yb
        torch.cuda.empty_cache()

        # the first step at batch 4, card against CPU, and the card's own
        # spread under a one-ulp weight change; dropout off on both sides
        xs, ys = x[:INC_CPU_BATCH], y[:INC_CPU_BATCH]
        first = {}
        for label, ctx in (("card", gpu), ("cpu", cpu), ("nudged", gpu)):
            twin = without_dropout(cpu_twin(mx, "inceptionv3", init_path))
            params = twin.collect_params()
            params.reset_ctx(ctx)
            if label == "nudged":
                nudge(twin)
            first[label] = sce_grads(mx, twin, xs, ys, ctx)
            del twin
        (lg, gg), (lc, gc), (_, gn) = first["card"], first["cpu"], \
            first["nudged"]
        vs_cpu, spread = leaf_rel_stats(gg, gc), leaf_rel_stats(gn, gg)
        grad_limits = {"median": max(INC_GRAD_REL, 2.0 * spread["median"]),
                       "max": max(INC_GRAD_REL, 2.0 * spread["max"])}
        loss_rel = abs(lg - lc) / abs(lc)
        del first, gg, gc, gn
        torch.cuda.empty_cache()
        families = zoo_families(tmp)
    finally:
        torch.backends.cudnn.deterministic = False

    med = statistics.median(step_ms)
    rec = {"phase": phase,
           "config": "inceptionv3 (get_model), 1000 classes, %dx%d NCHW "
                     "fp32, batch %d, sgd lr 0.01 momentum 0.9 wd 1e-4, "
                     "cuDNN deterministic" % (INC_IMAGE, INC_IMAGE,
                                              INC_BATCH),
           "warmup": INC_WARMUP, "steps": INC_STEPS,
           "trainable_tensors": n_tensors, "multi_launches_a_step": per_step,
           "images_per_s": INC_BATCH * INC_STEPS / window_s,
           "images_per_s_by_median_step": INC_BATCH / med * 1e3,
           "step_ms_median": med, "step_ms": step_ms, "window_s": window_s,
           "max_memory_allocated_bytes": peak, "profile_one_step": profile,
           "losses": losses,
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "flat_sgd_path_call": {k: opt_rec[k] for k in (
               "tensors", "elements", "dtypes", "max_ulps", "ms",
               "device_ms", "plain_ms", "bound_ms", "bound_by")},
           "cpu_first_step_batch": INC_CPU_BATCH,
           "cpu_first_step_loss_rel": loss_rel,
           "cpu_first_step_grads": vs_cpu, "one_ulp_weights": spread,
           "grad_limits": grad_limits, "families_predict": families,
           "card": card_name_and_limit()}
    emit(rec)
    check(variants == {("flat_sgd", "multi"): per_step * INC_STEPS}
          and sum(launches.values()) == per_step * INC_STEPS, phase,
          "launches %s (%s), expected %d multi flat_sgd a step over %d "
          "tensors and no other kernel" % (launches, variants, per_step,
                                           n_tensors))
    check(all(np.isfinite(losses))
          and statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
          phase, "loss not finite or not falling: %s" % losses)
    check(loss_rel <= INC_LOSS_REL
          and vs_cpu["median"] <= grad_limits["median"]
          and vs_cpu["max"] <= grad_limits["max"], phase,
          "first step vs the CPU: loss %s, gradients %s (limits %s)"
          % (loss_rel, vs_cpu, grad_limits))
    check(profile["device_ms"] > 0, phase, "the profiler saw no device time")
    return launches


# -- main path 17: examples/dcgan.py's DCGAN ------------------------------
GAN_NGF = GAN_NDF = 64                  # upstream example/gluon/dc_gan
GAN_NC, GAN_LATENT, GAN_BATCH, GAN_IMAGE = 3, 100, 64, 32
GAN_WARMUP, GAN_STEPS = 3, 20
GAN_ADAM = {"learning_rate": 2e-4, "beta1": 0.5}
GAN_LOSS_REL = 1e-5             # one step's D and G losses, card vs CPU
GAN_PARAM_REL = 1e-5            # per-leaf ||card - cpu|| / ||cpu|| of every
                                # parameter after the step: the limit, or
                                # twice the card's own spread under a
                                # one-ulp weight change where that is
                                # larger (Adam's first update is about
                                # lr * g / (|g| + eps), so an element whose
                                # gradient is near eps moves by what
                                # rounding gives its gradient)


def dcgan_nets(mx):
    """examples/dcgan.py's build_generator(ngf, nc) and
    build_discriminator(ndf), copied: latent (B, Z, 1, 1) -> image
    (B, nc, 32, 32) in [-1, 1] -> logit (B, 1, 1, 1)."""
    nn = mx.gluon.nn
    gen = nn.HybridSequential(prefix="gen_")
    with gen.name_scope():
        gen.add(nn.Conv2DTranspose(GAN_NGF * 4, 4, strides=1, padding=0,
                                   use_bias=False))
        gen.add(nn.BatchNorm(), nn.Activation("relu"))
        gen.add(nn.Conv2DTranspose(GAN_NGF * 2, 4, strides=2, padding=1,
                                   use_bias=False))
        gen.add(nn.BatchNorm(), nn.Activation("relu"))
        gen.add(nn.Conv2DTranspose(GAN_NGF, 4, strides=2, padding=1,
                                   use_bias=False))
        gen.add(nn.BatchNorm(), nn.Activation("relu"))
        gen.add(nn.Conv2DTranspose(GAN_NC, 4, strides=2, padding=1,
                                   use_bias=False))
        gen.add(nn.Activation("tanh"))
    disc = nn.HybridSequential(prefix="disc_")
    with disc.name_scope():
        disc.add(nn.Conv2D(GAN_NDF, 4, strides=2, padding=1, use_bias=False))
        disc.add(nn.LeakyReLU(0.2))
        disc.add(nn.Conv2D(GAN_NDF * 2, 4, strides=2, padding=1,
                           use_bias=False))
        disc.add(nn.BatchNorm(), nn.LeakyReLU(0.2))
        disc.add(nn.Conv2D(GAN_NDF * 4, 4, strides=2, padding=1,
                           use_bias=False))
        disc.add(nn.BatchNorm(), nn.LeakyReLU(0.2))
        disc.add(nn.Conv2D(1, 4, strides=1, padding=0, use_bias=False))
    return gen, disc


def gan_batches(n, seed=0):
    """examples/dcgan.py's synthetic blob images (its stand-in for a
    dataset) and N(0, 1) latents, seeded: n (latent, real) pairs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:GAN_IMAGE, 0:GAN_IMAGE].astype(np.float32) \
        / GAN_IMAGE - 0.5
    out = []
    for _ in range(n):
        shape = (GAN_BATCH, GAN_NC, 1, 1)
        cx, cy = rng.uniform(-0.3, 0.3, shape), rng.uniform(-0.3, 0.3, shape)
        s = rng.uniform(0.05, 0.15, shape)
        img = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2)))
        out.append((rng.randn(GAN_BATCH, GAN_LATENT, 1, 1).astype(np.float32),
                    (img * 2.0 - 1.0).astype(np.float32)))
    return out


def gan_step(mx, gen, disc, trainers, latent, real, ctx):
    """One iteration of the example's loop on arrays already on ctx: the
    discriminator on real and detached fake, trainer_d.step, then the
    generator through the discriminator, trainer_g.step. Returns the mean
    D and G losses (arrays)."""
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainer_g, trainer_d = trainers
    real_label = mx.nd.ones((GAN_BATCH,), ctx=ctx)
    fake_label = mx.nd.zeros((GAN_BATCH,), ctx=ctx)
    with mx.autograd.record():
        err_real = loss_fn(disc(real).reshape((-1,)), real_label)
        fake = gen(latent)
        err_fake = loss_fn(disc(fake.detach()).reshape((-1,)), fake_label)
        err_d = err_real + err_fake
    err_d.backward()
    trainer_d.step(GAN_BATCH)
    with mx.autograd.record():
        err_g = loss_fn(disc(fake).reshape((-1,)), real_label)
    err_g.backward()
    trainer_g.step(GAN_BATCH)
    return err_d.mean(), err_g.mean()


def gan_setup(mx, ctx, paths=None):
    """(gen, disc, trainers) on ctx: Normal(0.02) from seed 0, or the
    parameters of `paths`; hybridized; two Adam Trainers."""
    gen, disc = dcgan_nets(mx)
    if paths is None:
        mx.random.seed(0)
        gen.initialize(mx.init.Normal(0.02), ctx=ctx)
        disc.initialize(mx.init.Normal(0.02), ctx=ctx)
        with mx.autograd.predict_mode():
            disc(gen(mx.nd.zeros((1, GAN_LATENT, 1, 1), ctx=ctx)))
    else:
        gen.load_parameters(paths[0], ctx=ctx)
        disc.load_parameters(paths[1], ctx=ctx)
    gen.hybridize(static_alloc=True)
    disc.hybridize(static_alloc=True)
    trainers = (mx.gluon.Trainer(gen.collect_params(), "adam",
                                 dict(GAN_ADAM)),
                mx.gluon.Trainer(disc.collect_params(), "adam",
                                 dict(GAN_ADAM)))
    return gen, disc, trainers


def trainer_adam_call(trainer):
    """A Trainer's last #8 call: its trainable parameters' shapes and
    dtypes, the bias-corrected lr of each at its step count, wd, the betas
    (1 - beta in fp32, as the optimizer computes them), eps, rescale."""
    opt = trainer.optimizer
    idx, table = trainer_table(trainer)
    lrs = [opt._get_lr(i) * math.sqrt(1. - opt.beta2 ** opt._index_update_count[i])
           / (1. - opt.beta1 ** opt._index_update_count[i]) for i in idx]
    params = [(shape, dt, lr, wd) for (shape, dt), lr, wd in zip(
        table, lrs, opt._get_wds(idx))]
    one = np.float32(1.0)
    return (params, opt.beta1, float(one - np.float32(opt.beta1)),
            opt.beta2, float(one - np.float32(opt.beta2)), opt.epsilon,
            opt.rescale_grad)


def kernel_adam_paths(gen, calls):
    """#8 at a path's own calls: label -> trainer_adam_call's tuple. Seeded
    weights, gradients and moments (the variance from squared draws) in
    the weight's dtype; one multi_adam call bit-equal (0 ulps) to the
    plain version for every weight and moment, its launches counted, then
    timed (events and device time) beside its bound (w, mean and var read
    and written, g read)."""
    from mxnet_tpu_torch.ops import reset_launch_counts, variant_counts
    from mxnet_tpu_torch.ops.fused_optimizer import _ref_flat_adam, multi_adam
    recs = {}
    for label, (params, b1, omb1, b2, omb2, eps, rescale) in calls.items():
        def rnd(s, dt, scale):
            return (torch.randn(s, generator=gen, device="cuda")
                    * scale).to(dt)
        ws = [rnd(s, dt, 0.05) for s, dt, _, _ in params]
        gs = [rnd(s, dt, 0.5) for s, dt, _, _ in params]
        means = [rnd(s, dt, 0.05) for s, dt, _, _ in params]
        vs = [rnd(s, dt, 0.3) ** 2 for s, dt, _, _ in params]
        lrs, wds = [p[2] for p in params], [p[3] for p in params]

        def update():
            multi_adam(ws, gs, means, vs, None, lrs, wds, b1, omb1, b2, omb2,
                       eps, rescale, 0.0, False, False)

        def plain():
            return [_ref_flat_adam(w, g, m, v, None, lr, d, b1, omb1, b2,
                                   omb2, eps, rescale, 0.0, False, False)
                    for w, g, m, v, lr, d in zip(ws, gs, means, vs, lrs,
                                                 wds)]
        want = plain()
        reset_launch_counts()
        update()
        seen = variant_counts()
        torch.cuda.synchronize()
        ulps = max(ulps_apart(a, b).max().item()
                   for w, m, v, ref in zip(ws, means, vs, want)
                   for a, b in zip((w, m, v), ref[:3]))
        expect = {("flat_adam", "multi"): multi_launches("flat_adam",
                                                         len(ws))}
        n = sum(w.numel() for w in ws)
        nbytes = sum(w.numel() * w.element_size() * 7 for w in ws)
        rec = {"phase": "kernel_opt", "kernel": "flat_adam", "path": label,
               "tensors": len(ws), "elements": n,
               "dtypes": sorted({str(w.dtype)[6:] for w in ws}),
               "largest": max(w.numel() for w in ws), "max_ulps": ulps,
               "variants": {"%s/%s" % k: c for k, c in seen.items()},
               "ms": time_ms(update, iters=20),
               "device_ms": device_ms(update),
               "plain_ms": time_ms(plain, iters=5)}
        rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes, torch.float32)
        emit(rec)
        check(ulps == 0 and seen == expect, "kernel_opt",
              "%s's #8 call: %s ulps from the plain version, launches %s "
              "(expected %s)" % (label, ulps, seen, expect))
        recs[label] = rec
        del ws, gs, means, vs, want
    return recs


def phase_gluon_dcgan(tmp):
    """Main path 17: examples/dcgan.py's generator and discriminator at
    upstream MXNet's example/gluon/dc_gan widths (ngf = ndf = 64, nc 3),
    a 100-dim latent, batch 64 at 32x32 of the example's seeded blob
    images, Normal(0.02), hybridized, SigmoidBinaryCrossEntropyLoss and
    two Trainer("adam", lr 2e-4, beta1 0.5) with the example's alternating
    D and G updates: 3 warm-up and 20 timed steps, counts reset just before
    the timed steps and read just after (two multi flat_adam a step, one
    per Trainer, nothing else); each Trainer's #8 call over its own table
    at 0 ulps (kernel_adam_paths); one step of both nets against the CPU
    within the limit or twice the card's own one-ulp spread (cuDNN
    deterministic). Returns the timed steps' launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    phase = "gluon_dcgan"
    gpu, cpu = mx.gpu(0), mx.cpu()
    batches = gan_batches(4)
    with gpu:
        gen, disc, trainers = gan_setup(mx, gpu)
        paths = (os.path.join(tmp, "gen.params"),
                 os.path.join(tmp, "disc.params"))
        gen.save_parameters(paths[0])
        disc.save_parameters(paths[1])
        data = [(mx.nd.array(z, ctx=gpu), mx.nd.array(r, ctx=gpu))
                for z, r in batches]
        losses = [gan_step(mx, gen, disc, trainers, *data[i % 4], gpu)
                  for i in range(GAN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(GAN_STEPS + 1)]
        reset_launch_counts()
        t0 = time.perf_counter()
        events[0].record()
        for i in range(GAN_STEPS):
            losses.append(gan_step(mx, gen, disc, trainers, *data[i % 4],
                                   gpu))
            events[i + 1].record()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches, variants = launch_counts(), variant_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [(float(d.asscalar()), float(g.asscalar()))
                  for d, g in losses]
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(GAN_STEPS)]
        profile = profile_window(lambda: gan_step(
            mx, gen, disc, trainers, *data[0], gpu))
        sample = gen(mx.nd.array(np.random.RandomState(17).randn(
            16, GAN_LATENT, 1, 1), ctx=gpu)).asnumpy()
    adam_recs = kernel_adam_paths(
        torch.Generator(device="cuda").manual_seed(17),
        {"gluon_dcgan_" + name: trainer_adam_call(tr)
         for name, tr in zip(("generator", "discriminator"), trainers)})
    del gen, disc, trainers, data

    # one step from the saved state on the card and on the CPU, and on the
    # card from the state moved by one ulp (the card's own spread)
    torch.backends.cudnn.deterministic = True
    try:
        one = {}
        for label, ctx in (("card", gpu), ("cpu", cpu), ("nudged", gpu)):
            with ctx:
                g1, d1, tr1 = gan_setup(mx, ctx, paths)
                if label == "nudged":
                    nudge(g1)
                    nudge(d1)
                dl, gl = gan_step(mx, g1, d1, tr1, *[
                    mx.nd.array(a, ctx=ctx) for a in batches[0]], ctx)
                one[label] = ((float(dl.asscalar()), float(gl.asscalar())),
                              {k: p.data().data_torch.float().cpu()
                               for net in (g1, d1) for k, p in
                               net.collect_params().items()})
                del g1, d1, tr1
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, pg), (lc, pc), (_, pn) = one["card"], one["cpu"], one["nudged"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    param_rel = {k: rel_err(pg[k], pc[k]) for k in pc if pc[k].norm() > 0}
    spread = {k: rel_err(pn[k], pg[k]) for k in param_rel}
    param_limit = max(GAN_PARAM_REL, 2.0 * max(spread.values()))

    med = statistics.median(step_ms)
    rec = {"phase": phase,
           "config": "examples/dcgan.py, ngf %d ndf %d nc %d, latent %d, "
                     "batch %d at %dx%d, Normal(0.02), adam lr 2e-4 beta1 "
                     "0.5 x2" % (GAN_NGF, GAN_NDF, GAN_NC, GAN_LATENT,
                                 GAN_BATCH, GAN_IMAGE, GAN_IMAGE),
           "warmup": GAN_WARMUP, "steps": GAN_STEPS,
           "steps_per_s": GAN_STEPS / window_s,
           "steps_per_s_by_median_step": 1e3 / med,
           "step_ms_median": med, "step_ms": step_ms, "window_s": window_s,
           "max_memory_allocated_bytes": peak, "profile_one_step": profile,
           "losses_d_g": losses,
           "launches": {k: c for k, c in launches.items() if c},
           "variants": {"%s/%s" % k: c for k, c in variants.items()},
           "flat_adam_path_calls": {
               label: {k: r[k] for k in (
                   "tensors", "elements", "dtypes", "max_ulps", "ms",
                   "device_ms", "plain_ms", "bound_ms", "bound_by")}
               for label, r in adam_recs.items()},
           "sample_range": [float(sample.min()), float(sample.max())],
           "cpu_one_step_loss_rel": loss_rel,
           "cpu_one_step_param_rel_max": max(param_rel.values()),
           "cpu_one_step_param_rel_worst": dict(sorted(
               param_rel.items(), key=lambda kv: -kv[1])[:5]),
           "one_ulp_weights_param_rel_max": max(spread.values()),
           "one_ulp_weights_param_rel_worst": dict(sorted(
               spread.items(), key=lambda kv: -kv[1])[:5]),
           "param_limit": param_limit,
           "card": card_name_and_limit()}
    emit(rec)
    check(variants == {("flat_adam", "multi"): 2 * GAN_STEPS}
          and sum(launches.values()) == 2 * GAN_STEPS, phase,
          "launches %s (%s), expected two multi flat_adam a step and no "
          "other kernel" % (launches, variants))
    check(bool(np.isfinite(np.array(losses)).all())
          and sample.shape == (16, GAN_NC, GAN_IMAGE, GAN_IMAGE)
          and -1.0 <= sample.min() <= sample.max() <= 1.0, phase,
          "losses %s, sample range %s" % (losses[-1], rec["sample_range"]))
    check(loss_rel <= GAN_LOSS_REL
          and len(param_rel) == len(pc)
          and max(param_rel.values()) <= param_limit, phase,
          "one step vs the CPU: losses %s, parameters %s (limit %s)"
          % (loss_rel, rec["cpu_one_step_param_rel_worst"], param_limit))
    check(profile["device_ms"] > 0, phase, "the profiler saw no device time")
    return launches


# ---------------------------------------------------------------------------
# main path 18: speculative serving, sampling, a replica kill, the watchdog
# ---------------------------------------------------------------------------
SPEC_K = 4
SPEC_REQUESTS, SPEC_BURSTS, SPEC_SYS_LEN = 32, 4, 48
SPEC_DRAFT_LAYERS, SPEC_DRAFT_SEED = 2, 1
SAMPLE_KW = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
SAMPLE_ROWS = 4                 # positions a sampled stream is checked at
SAMPLE_NEAR_TIE = 1e-4          # top-two gap of a perturbed row (logits +
                                # gumbel) under which the card's token may
                                # differ from the CPU's: a one-ulp log
KILL_REQUESTS = 16              # the replica-kill and watchdog traffic:
KILL_SAMPLED = range(1, KILL_REQUESTS, 4)   # every 4th stream sampled
WATCHDOG_REQUESTS, WATCHDOG_DEADLINE_S = 4, 2.0
TRACE_ACCOUNTED = 0.95          # a request's spans cover >= 95% of its wall


def spec_traffic(cfg):
    """bench.py::bench_serve's accelerator traffic: 32 requests, ~2/3
    sharing a 48-token system prompt, max_new_tokens 32 + (i mod 5)."""
    rng = np.random.RandomState(0)
    sys_prompt = rng.randint(1, cfg.vocab_size - 1,
                             size=SPEC_SYS_LEN).tolist()
    out = []
    for i in range(SPEC_REQUESTS):
        tail = rng.randint(1, cfg.vocab_size - 1,
                           size=rng.randint(2, 8)).tolist()
        out.append(((sys_prompt + tail) if i % 3 else tail, 32 + i % 5))
    return out


def spec_request(traffic, i, sampled=(), **kw):
    from mxnet_tpu_torch.serve import Request
    prompt, n = traffic[i]
    if i in sampled:
        kw = dict(SAMPLE_KW, seed=1000 + i, **kw)
    return Request(prompt, max_new_tokens=n, request_id="r%d" % i, **kw)


def spec_server(params, cfg, draft=None, **kw):
    """bench_serve's server (batch 8, 512 KV blocks of 16, prefix sharing
    on), with `draft` = (params, cfg) at spec_k 4, warmed up with two
    throwaway requests before any clock starts."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import InferenceServer, Request
    if draft is not None:
        kw.update(draft_params=draft[0], draft_cfg=draft[1], spec_k=SPEC_K)
    server = InferenceServer(params, cfg, max_batch=8, kv_blocks=512,
                             block_size=16, queue_cap=SPEC_REQUESTS + 4,
                             device="cuda", **kw).warmup()
    for seed in (1, 2):
        server.submit(Request(np.random.RandomState(seed).randint(
            1, cfg.vocab_size - 1, size=6).tolist(), max_new_tokens=4))
    server.run()
    telemetry.reset()
    return server


def serve_bursts(server, traffic, sampled=(), bursts=SPEC_BURSTS):
    """The traffic in `bursts` bursts, each landing at once and drained
    before the next, then two requests that can never fit. Returns
    (handles, wall s, shed, peak bytes)."""
    from mxnet_tpu_torch.serve import Overloaded, Request
    per = -(-len(traffic) // bursts)
    handles = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for w in range(bursts):
        for i in range(w * per, min(len(traffic), (w + 1) * per)):
            handles.append(server.submit(spec_request(traffic, i, sampled)))
        server.run()
    shed = 0
    for _ in range(2):
        try:
            server.submit(Request([1] * 8, max_new_tokens=10000))
        except Overloaded as exc:
            shed += exc.reason == "too_large"
    server.run()
    torch.cuda.synchronize()
    return (handles, time.perf_counter() - t0, shed,
            torch.cuda.max_memory_allocated())


def serve_stats(handles, wall, peak):
    from mxnet_tpu_torch import telemetry
    c = telemetry.snapshot()["counters"]
    ttft = [h.ttft_ms for h in handles]
    tpot = [ms for h in handles for ms in h.tpot_ms]
    tokens = sum(len(h.tokens) for h in handles)
    drafted = c.get("serve.spec.drafted", 0)
    lookups = c.get("serve.prefix.lookups", 0)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "tpot_ms_p50": float(np.percentile(tpot, 50)),
            "tpot_ms_p99": float(np.percentile(tpot, 99)),
            "accept_rate": (c.get("serve.spec.accepted", 0) / drafted
                            if drafted else None),
            "spec_rounds": c.get("serve.spec.rounds", 0),
            "spec_drafted": drafted,
            "spec_accepted": c.get("serve.spec.accepted", 0),
            "spec_rejected": c.get("serve.spec.rejected", 0),
            "spec_discarded": c.get("serve.spec.discarded", 0),
            "decode_steps": c.get("serve.decode_steps", 0),
            "prefix_hit_rate": (c.get("serve.prefix.hits", 0) / lookups
                                if lookups else None),
            "peak_memory_bytes": peak}


def decode_round(server, traffic):
    """One decode round with all 8 slots decoding: its host syncs (torch's
    sync debug mode) and a profiled round (device time, idle share, top
    kernels). The streams are left unfinished; the server is dropped."""
    from mxnet_tpu_torch.serve import Request
    for prompt, _ in traffic[:8]:
        server.submit(Request(prompt, max_new_tokens=256))
    while any(s is None or s.filling for s in server._slots):
        server.step()
    _, syncs = count_syncs(server.step)
    return syncs, profile_window(server.step)


def margins(params, cfg, traffic, outs, sampled=()):
    """Per stream, the top-two margin at each emitted position of the
    fp32 llama_forward logits over prompt + output (greedy rows), or of
    the perturbed row (filtered logits + gumbel noise of the stream's
    seed and position) for sampled streams."""
    from mxnet_tpu_torch.models.llama import llama_forward
    from mxnet_tpu_torch.serve.sampling import _filtered, _uniforms
    out = []
    for i, ((prompt, _), toks) in enumerate(zip(traffic, outs)):
        ctx = torch.tensor([prompt + toks[:-1]], device="cuda")
        logits = llama_forward(params, ctx, cfg)[0, len(prompt) - 1:]
        if i in sampled:
            n = logits.shape[0]
            masked = _filtered(
                logits, torch.full((n,), SAMPLE_KW["temperature"],
                                   device="cuda"),
                torch.full((n,), SAMPLE_KW["top_k"], device="cuda"),
                torch.full((n,), SAMPLE_KW["top_p"], device="cuda"))
            u = _uniforms(np.full(n, 1000 + i),
                          len(prompt) + np.arange(n), logits.shape[1],
                          "cuda")
            logits = masked - torch.log(-torch.log(u))
        top2 = logits.topk(2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).tolist())
    return out


def same_streams(want, got, margin, phase, what):
    """Each stream of `got` has `want`'s length and equals it up to a first
    divergence at a near tie (margin under MARGIN). Returns the number of
    streams that diverged."""
    near_ties = 0
    for s, (a, b, m) in enumerate(zip(want, got, margin)):
        check(len(a) == len(b), phase, "%s: stream %d has %d tokens, the "
              "reference %d" % (what, s, len(b), len(a)))
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            check(m[j] < MARGIN, phase, "%s: stream %d token %d: %d != %d "
                  "(margin %.3g)" % (what, s, j, b[j], a[j], m[j]))
            near_ties += 1
    return near_ties


def per_row_sample(logits, seeds, positions, temperature, top_k, top_p):
    """The port's former draw, kept here as the timing yardstick: one
    torch.Generator per sampled row, seeded by splitmix64 of (seed,
    position), each row drawn in a host loop."""
    from mxnet_tpu_torch.serve.sampling import _filtered
    mask = (1 << 64) - 1

    def draw_seed(seed, position):
        z = (int(seed) & 0xffffffff) << 32 | (int(position) & 0xffffffff)
        z = (z + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return (z ^ (z >> 31)) & mask

    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    rows = torch.nonzero(temperature > 0).flatten().tolist()
    seeds = torch.as_tensor(seeds).tolist()
    positions = torch.as_tensor(positions).tolist()
    masked = _filtered(logits, temperature.to(dev),
                       torch.as_tensor(top_k, dtype=torch.long, device=dev),
                       torch.as_tensor(top_p, dtype=torch.float32,
                                       device=dev))
    out = greedy.clone()
    tiny = torch.finfo(torch.float32).tiny
    for r in rows:
        gen = torch.Generator(device=dev)
        gen.manual_seed(draw_seed(seeds[r], positions[r]))
        u = torch.rand(logits.shape[1], generator=gen, device=dev)
        out[r] = torch.argmax(masked[r] - torch.log(-torch.log(
            u.clamp(min=tiny))))
    return out


def sampling_checks(params, cfg, traffic, card):
    """8 sampled streams served (temperature 0.8, top_k 50, top_p 0.95);
    at the first SAMPLE_ROWS positions of each, the card's uniforms equal
    the CPU's bit for bit and its tokens the CPU's except at near ties;
    one B = 8 sample_tokens call timed beside the former per-row loop."""
    from mxnet_tpu_torch.models.llama import llama_forward
    from mxnet_tpu_torch.serve import sample_tokens
    from mxnet_tpu_torch.serve.sampling import _filtered, _uniforms
    phase = "serve_spec_sampling"
    server = spec_server(params, cfg)
    handles = [server.submit(spec_request(traffic, i, range(8)))
               for i in range(8)]
    server.run()
    outs = [h.result(timeout=0) for h in handles]
    del server
    rows, seeds, positions = [], [], []
    for i, ((prompt, _), toks) in enumerate(zip(traffic, outs)):
        ctx = torch.tensor([prompt + toks[:SAMPLE_ROWS - 1]], device="cuda")
        rows.append(llama_forward(params, ctx, cfg)[0, len(prompt) - 1:])
        seeds += [1000 + i] * SAMPLE_ROWS
        positions += list(range(len(prompt), len(prompt) + SAMPLE_ROWS))
    logits = torch.cat(rows).float()
    n, V = logits.shape
    seeds, positions = np.asarray(seeds), np.asarray(positions)
    u_card = _uniforms(seeds, positions, V, "cuda").cpu().numpy()
    u_cpu = _uniforms(seeds, positions, V, "cpu").numpy()
    bits_equal = bool(np.array_equal(u_card.view(np.uint32),
                                     u_cpu.view(np.uint32)))
    vec = (np.full(n, SAMPLE_KW["temperature"]), np.full(n,
                                                         SAMPLE_KW["top_k"]),
           np.full(n, SAMPLE_KW["top_p"]))
    tok_card = sample_tokens(logits, seeds, positions, *vec).cpu()
    host = logits.cpu()
    tok_cpu = sample_tokens(host, seeds, positions, *vec)
    perturbed = _filtered(
        host, torch.tensor(vec[0], dtype=torch.float32),
        torch.tensor(vec[1]), torch.tensor(vec[2], dtype=torch.float32)) \
        - torch.log(-torch.log(torch.from_numpy(u_cpu)))
    top2 = perturbed.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).numpy()
    differ = (tok_card != tok_cpu).numpy()
    # one B = 8 call (each stream's first row), new draw and former loop
    first = torch.arange(0, n, SAMPLE_ROWS, device="cuda")
    b8 = (logits[first], seeds[::SAMPLE_ROWS], positions[::SAMPLE_ROWS],
          *(v[:8] for v in vec))
    batched_ms = host_ms(lambda: sample_tokens(*b8).cpu(), calls=20)
    loop_ms = host_ms(lambda: per_row_sample(*b8).cpu(), calls=20)
    rec = {"phase": phase, "streams": len(outs),
           "tokens": sum(len(o) for o in outs), "rows_checked": n,
           "vocab": V, "uniform_bits_equal": bits_equal,
           "token_mismatches": int(differ.sum()),
           "token_mismatches_at_near_ties": int((differ
                                                 & (gap < SAMPLE_NEAR_TIE))
                                                .sum()),
           "sample_tokens_b8_ms": batched_ms,
           "former_per_row_loop_b8_ms": loop_ms, "card": card}
    emit(rec)
    check(bits_equal, phase, "the card's uniforms differ from the CPU's")
    check(not (differ & (gap >= SAMPLE_NEAR_TIE)).any(), phase,
          "card and CPU tokens differ away from a near tie: %s"
          % np.flatnonzero(differ & (gap >= SAMPLE_NEAR_TIE)).tolist())
    check(all(len(o) == traffic[i][1] for i, o in enumerate(outs)), phase,
          "a sampled stream fell short")


def replica_kill(p32, cfg32, traffic, baseline, margin, card):
    """ReplicaGroup(replicas=2, max_restarts=0) on the fp32 weights under
    serve.step:error:3, greedy and sampled streams mixed, all submitted
    before the replicas start (so the kill lands mid-stream): one replica
    dies, the survivor finishes every stream, the outputs equal the
    unfaulted run's, the survivor's pool reconciles to 0, and each
    request's trace accounts for >= 95% of its wall clock."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import faults
    from mxnet_tpu_torch.serve import ReplicaGroup
    phase = "serve_spec_replica_kill"
    telemetry.reset()
    group = ReplicaGroup(p32, cfg32, replicas=2, max_restarts=0,
                         max_batch=8, kv_blocks=512, block_size=16,
                         queue_cap=SPEC_REQUESTS, device="cuda").warmup()
    t0 = time.perf_counter()
    with faults.inject("serve.step:error:3"):
        handles = [group.submit(spec_request(traffic, i, KILL_SAMPLED))
                   for i in range(KILL_REQUESTS)]
        group.start()
        outs = [h.result(timeout=300) for h in handles]
        drained = group.drain(timeout=60)
    stopped = group.stop(timeout=60)
    wall = time.perf_counter() - t0
    c = telemetry.snapshot()["counters"]
    traces = {t["request_id"]: t for t in telemetry.request_traces()}
    accounted = [traces[h.id]["accounted_ms"] / traces[h.id]["wall_ms"]
                 for h in handles]
    survivors = [s for s in group.servers if not s.dead]
    rec = {"phase": phase, "requests": len(handles),
           "sampled": len(KILL_SAMPLED), "wall_s": wall,
           "alive_replicas": group.alive_replicas,
           "recoveries": c.get("serve.recoveries", 0),
           "requeued_streams": c.get("serve.requeued_streams", 0),
           "replica_deaths": c.get("serve.replica_deaths", 0),
           "requeues_per_stream": [h.requeues for h in handles],
           "replicas_per_stream": [len(set(traces[h.id]["replicas"]))
                                   for h in handles],
           "trace_accounted_min": min(accounted), "card": card}
    near = same_streams(baseline, outs, margin, phase, "replica kill")
    rec["near_tie_divergences"] = near
    rec["survivor_reconcile"] = (survivors[0].pool.reconcile()
                                 if survivors else None)
    emit(rec)
    check(drained and stopped, phase, "the group did not drain or stop")
    check(group.alive_replicas == 1 and rec["replica_deaths"] == 1, phase,
          "expected one dead replica and one survivor")
    check(rec["recoveries"] >= 1 and rec["requeued_streams"] >= 1, phase,
          "the kill drained no in-flight stream")
    check(rec["survivor_reconcile"] == 0, phase,
          "the survivor's pool needed reconciling")
    check(min(accounted) >= TRACE_ACCOUNTED, phase,
          "a request trace accounts for %.3f of its wall clock"
          % min(accounted))
    check(all(traces[h.id]["outcome"] == "completed" for h in handles),
          phase, "a stream did not complete")


def watchdog_drill(p32, cfg32, traffic, baseline, margin, card):
    """One fp32 server under serve.step:hang:2 with step_deadline_s 2: the
    stall becomes a StallError, then a recovery, and the streams finish
    with the unfaulted run's tokens."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import faults
    phase = "serve_spec_watchdog"
    server = spec_server(p32, cfg32, step_deadline_s=WATCHDOG_DEADLINE_S)
    handles = [server.submit(spec_request(traffic, i, KILL_SAMPLED))
               for i in range(WATCHDOG_REQUESTS)]
    t0 = time.perf_counter()
    with faults.inject("serve.step:hang:2"):
        server.run()
    wall = time.perf_counter() - t0
    outs = [h.result(timeout=0) for h in handles]
    c = telemetry.snapshot()["counters"]
    rec = {"phase": phase, "requests": len(handles), "wall_s": wall,
           "deadline_s": WATCHDOG_DEADLINE_S,
           "stalls": c.get("resilience.stalls.serve.step", 0),
           "recoveries": c.get("serve.recoveries", 0),
           "requeued_streams": c.get("serve.requeued_streams", 0),
           "card": card}
    rec["near_tie_divergences"] = same_streams(
        baseline[:WATCHDOG_REQUESTS], outs, margin, phase, "watchdog")
    emit(rec)
    check(rec["stalls"] == 1 and rec["recoveries"] == 1, phase,
          "the hang did not become one stall and one recovery")
    check(rec["requeued_streams"] >= 1, phase, "the stall drained nothing")


def phase_serve_spec():
    """Main path 18: bench.py::bench_serve's accelerator leg through the
    port. llama_110m bf16 (seeded), the identity draft at spec_k 4, 512 KV
    blocks of 16, batch 8, 32 requests in 4 bursts of 8 (~2/3 sharing a
    48-token system prompt, max_new_tokens 32 + i mod 5) and two
    oversized requests shed; the same traffic with no draft as the
    baseline. Counts reset just before the spec run and read just after
    the baseline: the server's windows run the plain paged attention, so
    no kernel launches. Then a decode round's host syncs and profile, the
    fp32 checks (spec = plain greedy, the identity draft's accept rate,
    a 2-layer draft that disagrees), sampling on the card against the
    CPU, a replica kill and the watchdog drill. Returns the launches."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    phase = "serve_spec"
    card = card_name_and_limit()
    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    traffic = spec_traffic(cfg)
    spec = spec_server(params, cfg, draft=(params, cfg))
    plain = spec_server(params, cfg)
    reset_launch_counts()
    spec_h, spec_wall, spec_shed, spec_peak = serve_bursts(spec, traffic)
    spec_rec = serve_stats(spec_h, spec_wall, spec_peak)
    telemetry.reset()
    plain_h, plain_wall, plain_shed, plain_peak = serve_bursts(plain,
                                                              traffic)
    launches = launch_counts()
    plain_rec = serve_stats(plain_h, plain_wall, plain_peak)
    spec_outs = [h.result(timeout=0) for h in spec_h]
    plain_outs = [h.result(timeout=0) for h in plain_h]
    spec_syncs, spec_prof = decode_round(spec, traffic)
    plain_syncs, plain_prof = decode_round(plain, traffic)
    del spec, plain
    torch.cuda.empty_cache()
    emit({"phase": phase, "spec_k": SPEC_K, "requests": len(traffic),
          "bursts": SPEC_BURSTS, "spec": spec_rec, "baseline": plain_rec,
          "speedup_tokens_per_s": (spec_rec["tokens_per_s"]
                                   / plain_rec["tokens_per_s"]),
          "shed": [spec_shed, plain_shed],
          "bf16_streams_differing": sum(a != b for a, b in
                                        zip(spec_outs, plain_outs)),
          "host_syncs_per_round": {"spec": spec_syncs,
                                   "plain": plain_syncs},
          "profile_round": {"spec": spec_prof, "plain": plain_prof},
          "launches": launches, "card": card})
    for rec, outs in ((spec_rec, spec_outs), (plain_rec, plain_outs)):
        check(all(len(o) == n for o, (_, n) in zip(outs, traffic)), phase,
              "a request fell short")
    check(spec_shed == plain_shed == 2, phase,
          "oversized requests were not shed")
    check(spec_rec["spec_rounds"] > 0 and plain_rec["spec_rounds"] == 0,
          phase, "spec rounds %d / %d" % (spec_rec["spec_rounds"],
                                          plain_rec["spec_rounds"]))
    check(spec_prof["device_ms"] > 0, phase,
          "the profiler saw no device time")

    # fp32 (TF32 off): spec equals plain greedy, the identity draft's
    # accept rate is 1 but at near ties, a 2-layer draft that disagrees
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = to_fp32(params)
    fp32 = {}
    for label, draft in (("plain", None), ("identity", (p32, cfg32))):
        server = spec_server(p32, cfg32, draft=draft)
        hs, wall, _, peak = serve_bursts(server, traffic)
        fp32[label] = ([h.result(timeout=0) for h in hs],
                       serve_stats(hs, wall, peak))
        del server
    dcfg = dataclasses.replace(cfg, n_layers=SPEC_DRAFT_LAYERS)
    dparams = to_fp32(llama_init(torch.Generator(device="cuda").manual_seed(
        SPEC_DRAFT_SEED), dcfg))
    server = spec_server(p32, cfg32, draft=(
        dparams, dataclasses.replace(dcfg, dtype=torch.float32)))
    hs, wall, _, peak = serve_bursts(server, traffic)
    fp32["draft2"] = ([h.result(timeout=0) for h in hs],
                      serve_stats(hs, wall, peak))
    del server, dparams
    torch.cuda.empty_cache()
    base = fp32["plain"][0]
    margin = margins(p32, cfg32, traffic, base)
    near_positions = sum(m < MARGIN for ms in margin for m in ms)
    ident, d2 = fp32["identity"][1], fp32["draft2"][1]
    rec = {"phase": "serve_spec_fp32", "tokens": sum(map(len, base)),
           "near_tie_positions": near_positions,
           "identity_near_tie_divergences": same_streams(
               base, fp32["identity"][0], margin, "serve_spec_fp32",
               "identity draft"),
           "draft2_near_tie_divergences": same_streams(
               base, fp32["draft2"][0], margin, "serve_spec_fp32",
               "2-layer draft"),
           "identity": ident, "draft2": d2, "plain": fp32["plain"][1],
           "bf16_accept_rate": spec_rec["accept_rate"], "card": card}
    emit(rec)
    for label, st in (("identity", ident), ("draft2", d2)):
        check(st["spec_drafted"] == st["spec_accepted"]
              + st["spec_rejected"], "serve_spec_fp32",
              "%s: drafted != accepted + rejected" % label)
    check(ident["spec_rejected"] <= SPEC_K * near_positions,
          "serve_spec_fp32", "identity draft rejected %d drafts, %d near "
          "ties" % (ident["spec_rejected"], near_positions))
    check(d2["accept_rate"] < 0.5, "serve_spec_fp32",
          "the 2-layer draft agreed at %.3f" % d2["accept_rate"])

    sampling_checks(params, cfg, traffic, card)
    torch.cuda.empty_cache()

    # the replica kill and the watchdog against an unfaulted fp32 run of
    # the same mixed greedy/sampled traffic
    kill_traffic = traffic[:KILL_REQUESTS]
    server = spec_server(p32, cfg32)
    hs = [server.submit(spec_request(kill_traffic, i, KILL_SAMPLED))
          for i in range(KILL_REQUESTS)]
    server.run()
    baseline = [h.result(timeout=0) for h in hs]
    del server
    kill_margin = margins(p32, cfg32, kill_traffic, baseline, KILL_SAMPLED)
    replica_kill(p32, cfg32, kill_traffic, baseline, kill_margin, card)
    watchdog_drill(p32, cfg32, kill_traffic, baseline, kill_margin, card)
    del params, p32
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# main path 19: multi-rank communication
# ---------------------------------------------------------------------------
P19_STEPS = 4                   # (a): the first step initializes the store
                                # (registration order in both modes), the
                                # next three are readiness rounds
P19_FUSED_STEPS = 2             # (b)
P19_BERT_STEPS = 2              # (d)
P19_FLEET = 4                   # (d), (e): virtual ranks in one process
P19_BENCH_MB = 64               # (c): allreduce_bench's buffer, fp32
P19_ZERO_REL = 1e-4             # (d) fleet vs world 1, at fp32: per-leaf
                                # ||a - b|| / ||b|| of the weights' change
                                # over the steps; the quarter gradients sum
                                # back exactly, LAMB's norm partials add
                                # in another order
P19_RING = dict(B=2, H=12, Hkv=12, S=4096, D=64)   # llama_110m's heads,
                                # 4 blocks of 1024
P19_RING_TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-2, "grad": 2e-2},
                torch.float32: {"o": 1e-4, "lse": 1e-4, "grad": 1e-4}}
                                # bf16: ||a - b|| / ||b|| (the blocks' o is
                                # rounded to bf16 before the merge, the
                                # dk/dv partials too before they travel);
                                # fp32: max abs error (summation order)
P19_DP_REL = 5e-2               # (a) at world > 1, rank 0 vs the one-card
                                # device store summing the ranks' batches:
                                # ||a - b|| / ||b|| of the trainable
                                # weights' change over the steps, all
                                # leaves together; bf16 gradients summed
                                # in another order and bf16 weights, whose
                                # rounding of a small update flips with
                                # them (GRAD_BF16_REL's scale)
P19_ZERO_KERNELS = ("flat_lamb1", "flat_lamb2")
MULTI_RANK_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "conv_bn_stats", "cbr_train_bwd", "flat_sgd",
                      "flat_lamb1", "flat_lamb2", "segment_sum")
P19_SPARSE_KERNELS = ("segment_sum", "flat_sgd")


class FleetComm:
    """One virtual rank of an in-process fleet on the card: a barrier'd
    mailbox, contributions added in rank order. Serves as a ZeRO exchange
    (reduce_scatter, all_gather, all_reduce) and as ring attention's
    (shift: what the previous rank posted)."""

    def __init__(self, fleet, rank):
        self.fleet, self.rank = fleet, rank
        self.world = fleet["world"]
        self.n = 0

    def _post(self, tag, value):
        fleet = self.fleet
        key = (tag, self.n)
        self.n += 1
        with fleet["lock"]:
            fleet["box"].setdefault(key, {})[self.rank] = value
        fleet["barrier"].wait()
        parts = dict(fleet["box"][key])
        fleet["barrier"].wait()
        return parts

    def _sum(self, parts):
        total = parts[0].clone()
        for r in range(1, self.world):
            total = total + parts[r]
        return total

    def reduce_scatter(self, spec, flat):
        total = self._sum(self._post("rs", flat))
        lo = self.rank * spec.shard
        return total[lo:lo + spec.shard].clone()

    def all_gather(self, spec, shard):
        parts = self._post("ag", shard)
        return torch.cat([parts[r] for r in range(self.world)])

    def all_reduce(self, spec, value):
        return self._sum(self._post("ar", value))

    def shift(self, tensors):
        parts = self._post("ring", [t.clone() for t in tensors])
        got = parts[(self.rank - 1) % self.world]

        class Done:
            def wait(self):
                return got
        return Done()


def run_fleet(world, fn):
    """fn(rank, comm) on `world` threads; re-raise the first error."""
    import threading
    fleet = {"world": world, "lock": threading.Lock(), "box": {},
             "barrier": threading.Barrier(world)}
    errs = []

    def wrap(rank):
        try:
            fn(rank, FleetComm(fleet, rank))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            fleet["barrier"].abort()

    threads = [threading.Thread(target=wrap, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]


def ring_case(B, H, Hkv, S, D, dtype, seed=0):
    """Seeded q, k, v, do on the card and the whole-sequence kernels'
    causal o, lse, dq, dk, dv (#1-#3) on them."""
    from mxnet_tpu_torch.parallel.flash_attention import (_backward_inner,
                                                          _delta,
                                                          _flash_forward)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = randn(B, H, S, D), randn(B, Hkv, S, D), \
        randn(B, Hkv, S, D), randn(B, H, S, D)
    sc = D ** -0.5
    o, lse = _flash_forward(q, k, v, True, sc)
    dq, dk, dv = _backward_inner(q, k, v, lse, _delta(o, do), do, True, sc)
    return (q, k, v, do), (o, lse, dq, dk, dv)


def ring_errors(got, want, dtype):
    """({name: error}, within P19_RING_TOL) of the ring's o, lse, dq, dk,
    dv against the whole-sequence kernels'."""
    tol = P19_RING_TOL[dtype]
    errs, ok = {}, True
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if dtype == torch.float32 or name == "lse":
            err = (g - w).abs().max().item()
        else:
            err = ((g - w).norm() / w.norm()).item()
        limit = tol["grad"] if name.startswith("d") else tol[name]
        errs[name] = err
        ok = ok and err <= limit
    return errs, ok


def ring_fleet_check(B, H, Hkv, S, D, dtype, world=P19_FLEET, seed=0):
    """Ring attention over an in-process fleet of `world` ranks on the card
    (kernels #1-#3 per block), causal, against the whole-sequence kernels:
    o, lse, dq, dk, dv. The ranks call the ring's forward and backward
    passes themselves, past the public `ring_attention` and its
    autograd.Function (`ring_rank_check` drives those over the process
    group): torch runs every CUDA backward of a process on one device
    thread, where the first rank's backward would wait at the ring for
    ranks queued behind it (a rank of a real ring is a process of its
    own). Returns the errors, the ring's wall ms forward + backward, the
    fleet's launches (counts reset just before it and read just after;
    the whole-sequence reference launches before) and {"ok": within
    P19_RING_TOL}."""
    from mxnet_tpu_torch.parallel.ring_attention import (_ring_backward,
                                                         _ring_forward)
    (q, k, v, do), want = ring_case(B, H, Hkv, S, D, dtype, seed)
    sc = D ** -0.5
    c = S // world
    res = [None] * world

    def rank_fn(r, comm):
        sl = slice(r * c, (r + 1) * c)
        qs, ks, vs, dos = (t[:, :, sl].contiguous() for t in (q, k, v, do))
        o, lse = _ring_forward(qs, ks, vs, True, sc, comm)
        dq, dk, dv = _ring_backward(qs, ks, vs, o, lse, dos, True, sc, comm)
        res[r] = (o, lse, dq, dk, dv)

    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    run_fleet(world, rank_fn)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    got = [torch.cat([r[i] for r in res], 2) for i in range(5)]
    errs, ok = ring_errors(got, want, dtype)
    return {"errors": errs, "ok": ok, "wall_ms": wall_ms,
            "launches": launches}


def ring_rank_check(rank, world, B, H, Hkv, S, D, dtype, seed=0):
    """This rank's chunk of the sequence through the public
    `ring_attention` over the world's process group (RingExchange, NCCL)
    and its autograd.Function backward, causal, against its slice of the
    whole-sequence kernels (every rank draws the same seeded tensors).
    Counts reset just before the ring and read just after."""
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    (q, k, v, do), want = ring_case(B, H, Hkv, S, D, dtype, seed)
    c = S // world
    sl = slice(rank * c, (rank + 1) * c)
    qs, ks, vs = (t[:, :, sl].clone().requires_grad_() for t in (q, k, v))
    dos = do[:, :, sl].contiguous()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    o, lse = ring_attention(qs, ks, vs, axis_name=None, causal=True,
                            return_lse=True)
    o.backward(dos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    got = (o.detach(), lse, qs.grad, ks.grad, vs.grad)
    errs, ok = ring_errors(got, [w[:, :, sl] for w in want], dtype)
    return {"errors": errs, "ok": ok, "wall_ms": wall_ms,
            "launches": launches}


def zero_fleet_check(weights, grads, steps, world=P19_FLEET, lr=1e-3,
                     wd=0.01, cap_mb=None):
    """LAMB on the ZeRO updater at world 1 and over an in-process fleet of
    `world` virtual ranks on the card, from the same weights, all in fp32.
    Rank r pushes its own share (2r + 1) / world**2 of the gradients
    (rounded to bf16 first, as path 5's are): the shares differ, so an
    exchange that sends a contribution to the wrong rank or counts one
    rank's share more than once misses world 1, and for a power-of-two
    world each share and each partial sum in rank order is exact in fp32,
    so the shares add back to world 1's gradient bit for bit. Returns
    (per-leaf relative error of the fleet's weight change against world
    1's, the fleet's #9/#10 launches, buckets)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.optimizer.zero import ZeroUpdater
    keys = [str(i) for i in range(len(weights))]
    weights = [w.float() for w in weights]
    grads = [g.to(torch.bfloat16).float() for g in grads]
    scope = engine.bucket_mb_scope(cap_mb) if cap_mb is not None \
        else contextlib.nullcontext()

    def opt():
        return mx.optimizer.create("lamb", learning_rate=lr, wd=wd)

    with scope:
        zu = ZeroUpdater(opt())
        w1 = [mx.nd.NDArray(w.clone()) for w in weights]
        for _ in range(steps):
            zu.step(keys, list(grads), w1)
        outs = [None] * world
        torch.cuda.synchronize()
        reset_launch_counts()

        def rank_fn(r, comm):
            zr = ZeroUpdater(opt(), comm=comm)
            ws = [mx.nd.NDArray(w.clone()) for w in weights]
            share = (2 * r + 1) / world ** 2
            parts = [g * share for g in grads]
            for _ in range(steps):
                zr.step(keys, parts, ws)
            outs[r] = ws

        run_fleet(world, rank_fn)
        torch.cuda.synchronize()
        launches = launch_counts()
    worst = 0.0
    for r in range(world):
        for w0, a, b in zip(weights, outs[r], w1):
            da = a._data.float() - w0.float()
            db = b._data.float() - w0.float()
            den = db.norm().item()
            if den > 0:
                worst = max(worst, ((da - db).norm() / den).item())
    return worst, launches, len(zu.layout)


def p19_resnet(mx, gpu, rank, world, kv, comm_ready=None):
    """P19_STEPS imperative steps of path 4's ResNet-50 through
    Trainer(kvstore=kv, "sgd", lr 0.1, momentum 0.9) on this rank's
    seeded batch of TRAIN_BATCH. Returns (final snapshot, step ms,
    launches, ready counters, the trainable parameters' names)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    net = train_net(0, gpu)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=kv, comm_ready=comm_ready)
    x, y = train_batch(TRAIN_BATCH, RESNET_IMAGE, gpu, seed=rank)
    telemetry.reset()
    torch.cuda.synchronize()
    reset_launch_counts()
    ms = []
    for _ in range(P19_STEPS):
        t0 = time.perf_counter()
        imperative_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    c = telemetry.snapshot()["counters"]
    ready = {k: c.get(k, 0) for k in (
        "comm.ready.rounds", "comm.ready.aborted",
        "comm.ready.flush_during_backward",
        "comm.ready.first_flush_before_backward_end", "comm.bucket.count")}
    snap = snapshot(net)
    names = list(trainable(net))
    del net, trainer
    torch.cuda.empty_cache()
    return snap, ms, launches, ready, names


def snaps_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def trainable(net):
    """{structural name: parameter} of the parameters with a gradient."""
    return {k: p for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def digest(snap, names):
    """sha256 of the named tensors' bytes: ranks compare weights by it."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(names):
        t = snap[k].detach().contiguous().reshape(-1)
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def p19_resnet_summed(mx, gpu, world):
    """The one-card counterpart of (a) at world > 1: P19_STEPS steps of the
    same net and optimizer through the device store, each summing the
    gradients of every rank's batch (seeds 0..world-1, a backward each)
    before one trainer.step(TRAIN_BATCH), as the ranks' all-reduce does.
    Returns (initial, final) {name: tensor} of the trainable weights."""
    net = train_net(0, gpu)
    params = trainable(net)
    init = {k: p.data().data_torch.clone() for k, p in params.items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore="device")
    batches = [train_batch(TRAIN_BATCH, RESNET_IMAGE, gpu, seed=r)
               for r in range(world)]
    for _ in range(P19_STEPS):
        sums = None
        for x, y in batches:
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            grads = [p.grad().data_torch for p in params.values()]
            sums = [g.clone() for g in grads] if sums is None else \
                [a.add_(g) for a, g in zip(sums, grads)]
        for p, a in zip(params.values(), sums):
            p.grad().data_torch.copy_(a)
        trainer.step(TRAIN_BATCH)
    final = {k: p.data().data_torch.clone() for k, p in params.items()}
    del net, trainer, batches, sums
    torch.cuda.empty_cache()
    return init, final


def change_rel_err(init, got, want):
    """||(got - init) - (want - init)|| / ||want - init|| over every
    tensor of `init` together, in fp32."""
    num = den = 0.0
    for k, w0 in init.items():
        da = got[k].float() - w0.float()
        db = want[k].float() - w0.float()
        num += ((da - db) ** 2).sum().item()
        den += (db ** 2).sum().item()
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def p19_bert(mx, gpu, kv):
    """P19_BERT_STEPS of path 5's BERT-base step with LAMB on the ZeRO
    updater through a Trainer on store `kv`. Returns (snapshot, launches,
    buckets, the net's weights and one step's gradients for the fleet,
    the digest of its trainable weights)."""
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    net = bert_net(gpu)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": 1e-3, "wd": 0.01},
                               kvstore=kv, zero=True)
    x, y = bert_batch(BERT_BATCH, gpu)
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(P19_BERT_STEPS):
        bert_step(mx, net, sce, trainer, x, y)
    torch.cuda.synchronize()
    launches = launch_counts()
    snap = snapshot(net)
    buckets = len(trainer._kvstore._updater.layout)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    weights = [p.data()._data.detach().clone() for p in params]
    grads = [p.grad()._data.detach().clone() for p in params]
    sha = digest(snap, trainable(net))
    del net, trainer
    torch.cuda.empty_cache()
    return snap, launches, buckets, weights, grads, sha


def summed_traffic(traffics):
    """Step by step, the rows of every rank's row-sparse gradient summed
    by id in numpy, in rank order: what a dist_sync push of each rank's
    step adds to the table."""
    out = []
    for steps in zip(*traffics):
        ids = np.concatenate([i for i, _ in steps])
        rows = np.concatenate([g for _, g in steps])
        uniq, inv = np.unique(ids, return_inverse=True)
        total = np.zeros((len(uniq), rows.shape[1]), np.float32)
        np.add.at(total, inv, rows)
        out.append((uniq.astype(np.int32), total))
    return out


def multi_rank_worker(out_dir):
    """One rank of main path 19, started by `python -m
    mxnet_tpu_torch.launch` (NCCL, one process a card): (c) the all-reduce
    benchmark, (a) ResNet-50 through a dist_device_sync Trainer in
    registration and readiness order beside the one-card device store, (b)
    FusedTrainStep over a data mesh beside path 4's step, (d) BERT-base
    LAMB on the ZeRO updater over NCCL beside the device store, then the
    in-process fleet on the card, (e) this rank's chunk through the public
    ring_attention over the process group, (f) bench_sparse's row-sparse
    push and pull through a dist_sync store beside a local one. At world >
    1 rank 0 also runs (a)'s steps on the one card with every rank's batch
    summed. Writes rank<r>.json; counts reset before each leg and read
    after it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.parallel import collectives, create_mesh, dist
    dist.initialize()
    rank, world = dist.rank(), dist.num_workers()
    gpu = mx.gpu(dist.local_rank())
    torch.cuda.set_device(dist.local_rank())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rec = {"rank": rank, "world": world, "backend": dist.backend(),
           "card": card_name_and_limit()}
    t_start = time.perf_counter()
    # (c)
    bench = collectives.allreduce_bench(size_mb=P19_BENCH_MB, iters=20)
    rec["allreduce"] = bench
    # (a)
    dev_snap, dev_ms, dev_l, _, _ = p19_resnet(mx, gpu, rank, world,
                                               "device")
    reg_snap, reg_ms, reg_l, reg_c, names = p19_resnet(
        mx, gpu, rank, world, "dist_device_sync", comm_ready=False)
    rdy_snap, rdy_ms, rdy_l, rdy_c, _ = p19_resnet(
        mx, gpu, rank, world, "dist_device_sync", comm_ready=True)
    rec["resnet"] = {
        "steps": P19_STEPS, "batch_per_rank": TRAIN_BATCH,
        "device_ms": dev_ms, "registration_ms": reg_ms, "ready_ms": rdy_ms,
        "registration_launches": reg_l, "ready_launches": rdy_l,
        "device_launches": dev_l, "registration_counters": reg_c,
        "ready_counters": rdy_c,
        "ready_equals_registration": snaps_equal(rdy_snap, reg_snap),
        "registration_equals_device": snaps_equal(reg_snap, dev_snap),
        "ready_equals_device": snaps_equal(rdy_snap, dev_snap),
        "digest": digest(reg_snap, names)}
    del dev_snap, rdy_snap
    if world > 1 and rank == 0:
        init, want = p19_resnet_summed(mx, gpu, world)
        rec["resnet"]["summed_rel_err"] = change_rel_err(init, reg_snap,
                                                         want)
        del init, want
    del reg_snap
    torch.cuda.empty_cache()
    # (b)
    fused = {}
    for name, mesh in (("path4", None), ("mesh", create_mesh(data=world))):
        net = train_net(0, gpu)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        step = mx.gluon.FusedTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), trainer, mesh=mesh)
        x, y = train_batch(TRAIN_BATCH, RESNET_IMAGE, gpu, seed=rank)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = [step(x, y).asnumpy().item()
                  for _ in range(P19_FUSED_STEPS)]
        torch.cuda.synchronize()
        # every parameter, the BatchNorm running statistics included: the
        # data-mesh step writes them from the global batch's statistics
        snap = snapshot(net)
        fused[name] = (snap, losses, launch_counts(), list(snap))
        del net, trainer, step
        torch.cuda.empty_cache()
    rec["fused"] = {"losses": fused["mesh"][1],
                    "path4_losses": fused["path4"][1],
                    "launches": fused["mesh"][2],
                    "equals_path4": snaps_equal(fused["mesh"][0],
                                                fused["path4"][0])
                    and fused["mesh"][1] == fused["path4"][1],
                    "digest": digest(fused["mesh"][0], fused["mesh"][3])}
    del fused
    # (d)
    dev_snap, dev_l, dev_b, _, _, _ = p19_bert(mx, gpu, "device")
    nccl_snap, nccl_l, nccl_b, weights, grads, sha = p19_bert(
        mx, gpu, "dist_device_sync")
    rec["zero"] = {"steps": P19_BERT_STEPS, "buckets": nccl_b,
                   "launches": nccl_l, "device_launches": dev_l,
                   "equals_device": snaps_equal(nccl_snap, dev_snap)
                   and dev_b == nccl_b, "digest": sha}
    del dev_snap, nccl_snap
    torch.cuda.empty_cache()
    if rank == 0:
        worst, fleet_l, fleet_b = zero_fleet_check(weights, grads,
                                                   P19_BERT_STEPS)
        rec["zero"].update({"fleet_world": P19_FLEET,
                            "fleet_rel_err": worst,
                            "fleet_launches": fleet_l,
                            "fleet_buckets": fleet_b})
    del weights, grads
    torch.cuda.empty_cache()
    # (e) the public ring_attention over the process group
    rec["ring"] = {str(dt): ring_rank_check(rank, world, **P19_RING,
                                            dtype=dt)
                   for dt in (torch.bfloat16, torch.float32)}
    torch.cuda.empty_cache()
    # (f) rank r pushes the traffic of seed r (rank 0 bench_sparse's own);
    # the local store pushes every rank's rows of a step summed, and pulls
    # this rank's ids
    traffic = sparse_traffic(seed=rank)
    local_traffic = traffic if world == 1 else summed_traffic(
        [sparse_traffic(seed=r) for r in range(world)])
    pulls = [ids[:256] for ids, _ in traffic]
    tables = {}
    for name, steps in (("dist_sync", traffic), ("local", local_traffic)):
        kv = mx.kv.create(name)
        kv.init(0, mx.nd.zeros((SPARSE_VOCAB, SPARSE_DIM), ctx=gpu))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        pulled = sparse_loop(mx, kv, gpu, steps, pulls=pulls)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        table = mx.nd.zeros((SPARSE_VOCAB, SPARSE_DIM), ctx=gpu)
        kv.pull(0, out=table)
        tables[name] = (table._data.clone(), pulled._values.clone(),
                        launch_counts(), dt)
        del kv, table
    d, lo = tables["dist_sync"], tables["local"]
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in ((d[0], lo[0]), (d[1], lo[1])))
    equal = torch.equal(d[0], lo[0]) and torch.equal(d[1], lo[1])
    rec["sparse"] = {"steps": len(traffic), "launches": d[2],
                     "local_launches": lo[2], "seconds": d[3],
                     "local_seconds": lo[3], "equals_local": equal,
                     "rel_err_local": rel,
                     "ok": equal if world == 1 else rel <= SPARSE_REL}
    del tables
    collectives.barrier()
    rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    dist.shutdown()


def phase_multi_rank():
    """Main path 19: the port's multi-rank layer on the card. The ranks
    (one a card, world = device_count()) run `multi_rank_worker` under the
    port's launcher over NCCL, rendezvousing through a FileStore; their
    counts are reset before each leg and read after it in the rank. Then
    (e) ring attention over an in-process fleet of 4 on this card, counts
    reset just before and read just after. Returns {kernel: launches on
    the path}."""
    from mxnet_tpu_torch.ops import KERNELS
    phase = "multi_rank"
    world = torch.cuda.device_count()
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
               str(world), "--launcher", "local", "--root-uri",
               "file://" + os.path.join(tmp, "store"), "--backend", "nccl",
               "--timeout", "540", sys.executable,
               os.path.abspath(__file__), "--multi-rank-worker", tmp]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=root, env=env, timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, phase,
              "the ranks exited with %s" % run.returncode)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
    launches = {k: 0 for k in KERNELS}
    r0 = ranks[0]
    rn, fu, ze, sp = r0["resnet"], r0["fused"], r0["zero"], r0["sparse"]
    for r in ranks:
        for leg in (r["resnet"]["registration_launches"],
                    r["resnet"]["ready_launches"], r["fused"]["launches"],
                    r["zero"]["launches"], r["sparse"]["launches"],
                    *(x["launches"] for x in r["ring"].values())):
            for k, n in leg.items():
                launches[k] += n
    launches_ = dict(launches)
    for k, n in ze["fleet_launches"].items():
        launches_[k] += n
    # (a)
    steps = P19_STEPS
    check(all(r["resnet"]["ready_equals_registration"] for r in ranks),
          phase, "readiness-order steps differ from registration order")
    if world == 1:
        check(rn["registration_equals_device"] and rn["ready_equals_device"],
              phase, "world-1 NCCL steps differ from the device store's")
    else:
        check(len({r["resnet"]["digest"] for r in ranks}) == 1, phase,
              "(a) the ranks' trainable weights differ")
        check(rn["summed_rel_err"] <= P19_DP_REL, phase,
              "(a) rank 0 is %.3g from the one-card summed batches (limit "
              "%g)" % (rn["summed_rel_err"], P19_DP_REL))
    for mode in ("registration", "ready"):
        got = rn[mode + "_launches"]
        check(got["conv_bn_stats"] == 16 * steps
              and got["cbr_train_bwd"] == 16 * steps
              and got["flat_sgd"] > 0, phase,
              "(a) %s launches %s" % (mode, got))
    check(rn["ready_counters"]["comm.ready.rounds"] == steps - 1, phase,
          "(a) readiness rounds %s" % rn["ready_counters"])
    emit({"phase": phase, "leg": "a_resnet50_dist", "world": world,
          "backend": r0["backend"], "batch_per_rank": TRAIN_BATCH,
          "steps": steps, "step_ms": {m: rn[m + "_ms"] for m in
                                      ("device", "registration", "ready")},
          "median_ms_steps_2_on": {
              m: statistics.median(rn[m + "_ms"][1:])
              for m in ("device", "registration", "ready")},
          "launches": {m: rn[m + "_launches"] for m in
                       ("device", "registration", "ready")},
          "ready_counters": rn["ready_counters"],
          "registration_counters": rn["registration_counters"],
          "bit_equal": {"ready_vs_registration":
                        rn["ready_equals_registration"],
                        "registration_vs_device":
                        rn["registration_equals_device"],
                        "ready_vs_device": rn["ready_equals_device"]},
          "summed_rel_err": rn.get("summed_rel_err"),
          "summed_limit": P19_DP_REL})
    # (b)
    check(fu["launches"]["conv_bn_stats"] == 16 * P19_FUSED_STEPS
          and fu["launches"]["flat_sgd"] == P19_FUSED_STEPS, phase,
          "(b) launches %s" % fu["launches"])
    if world == 1:
        check(fu["equals_path4"], phase,
              "(b) the data-mesh step differs from path 4's")
    check(len({r["fused"]["digest"] for r in ranks}) == 1, phase,
          "(b) the ranks' weights or running statistics differ")
    emit({"phase": phase, "leg": "b_fused_mesh", "world": world,
          "losses": fu["losses"], "launches": fu["launches"],
          "bit_equal_path4": fu["equals_path4"]})
    # (c)
    ab = r0["allreduce"]
    emit({"phase": phase, "leg": "c_allreduce_bench", "world": ab["world"],
          "backend": ab["backend"], "bytes": ab["bytes"],
          "algo_gbps": ab["algo_gbps"], "bus_gbps": ab["bus_gbps"],
          "ms": ab["seconds"] * 1e3, "card": r0["card"],
          "note": ("one rank: the all-reduce is a copy, not BASELINE's "
                   "KVStore all-reduce metric" if ab["world"] == 1
                   else "bus GB/s is BASELINE's metric")})
    # (d)
    check(all(ze["launches"][k] == ze["buckets"] * P19_BERT_STEPS
              for k in P19_ZERO_KERNELS), phase,
          "(d) launches %s for %d buckets" % (ze["launches"], ze["buckets"]))
    if world == 1:
        check(ze["equals_device"], phase,
              "(d) world-1 NCCL ZeRO differs from the device store's")
    check(len({r["zero"]["digest"] for r in ranks}) == 1, phase,
          "(d) the ranks' trainable weights differ")
    check(ze["fleet_rel_err"] <= P19_ZERO_REL, phase,
          "(d) the fleet of %d is %.3g from world 1 (limit %g)"
          % (P19_FLEET, ze["fleet_rel_err"], P19_ZERO_REL))
    check(all(ze["fleet_launches"][k] == P19_FLEET * ze["fleet_buckets"]
              * P19_BERT_STEPS for k in P19_ZERO_KERNELS), phase,
          "(d) fleet launches %s" % ze["fleet_launches"])
    emit({"phase": phase, "leg": "d_zero_bert", "world": world,
          "buckets": ze["buckets"], "launches": ze["launches"],
          "bit_equal_device": ze["equals_device"],
          "fleet_world": P19_FLEET, "fleet_rel_err": ze["fleet_rel_err"],
          "fleet_limit": P19_ZERO_REL,
          "fleet_launches": ze["fleet_launches"]})
    # (f)
    check(sp["launches"]["segment_sum"] > 0, phase,
          "(f) no segment_sum launch: %s" % sp["launches"])
    check(all(r["sparse"]["ok"] for r in ranks), phase,
          "(f) the dist_sync table or pull differs from the local store's "
          "(bit for bit at world 1, within SPARSE_REL above): %s"
          % [r["sparse"]["rel_err_local"] for r in ranks])
    emit({"phase": phase, "leg": "f_sparse_dist", "world": world,
          "steps": sp["steps"], "launches": sp["launches"],
          "local_launches": sp["local_launches"], "seconds": sp["seconds"],
          "local_seconds": sp["local_seconds"],
          "bit_equal_local": sp["equals_local"],
          "rel_err_local": [r["sparse"]["rel_err_local"] for r in ranks]})
    # (e) through the public ring_attention over the process group
    check(all(x["ok"] for r in ranks for x in r["ring"].values()), phase,
          "(e) the ranks' ring_attention outside its tolerances: %s"
          % [r["ring"] for r in ranks])
    check(all(sum(x["launches"][k] for x in r0["ring"].values()) > 0
              for k in TRAIN_KERNELS), phase,
          "(e) process-group ring launches %s" % r0["ring"])
    emit({"phase": phase, "leg": "e_ring_attention_group", "world": world,
          **P19_RING, "causal": True, "results": r0["ring"],
          "max_errors": {dt: {n: max(r["ring"][dt]["errors"][n]
                                     for r in ranks)
                              for n in r0["ring"][dt]["errors"]}
                         for dt in r0["ring"]}})
    # (e) over a fleet of P19_FLEET in this process: each check resets the
    # counts just before its fleet and reads them just after
    ring = {}
    ring_launches = {k: 0 for k in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        ring[str(dtype)] = ring_fleet_check(**P19_RING, dtype=dtype)
        for k, n in ring[str(dtype)]["launches"].items():
            ring_launches[k] += n
    for k, n in ring_launches.items():
        launches[k] += n
        launches_[k] += n
    check(all(r["ok"] for r in ring.values()), phase,
          "(e) ring attention outside its tolerances: %s" % ring)
    check(all(ring_launches[k] > 0 for k in TRAIN_KERNELS), phase,
          "(e) launches %s" % ring_launches)
    emit({"phase": phase, "leg": "e_ring_attention",
          "fleet_world": P19_FLEET, **P19_RING, "causal": True,
          "results": ring, "tolerances": {str(k): v for k, v in
                                          P19_RING_TOL.items()},
          "launches": ring_launches})
    emit({"phase": phase, "world": world, "seconds": wall,
          "worker_seconds": r0["seconds"], "launches": launches_})
    return launches_

# ------------------------------------------------------------ main path 20
P20_MESH = {"fsdp": 2, "model": 2}
P20_WORLD = 4
P20_BATCH, P20_SEQ = 4, 512     # the global batch: B 2 a rank over fsdp=2
P20_STEPS = 3
P20_LR, P20_EPS = 1e-5, 1e-4    # AdamW's early steps move an element by
# about lr * g / (|g| + eps): a larger eps bounds how far a rounding
# difference of a near-zero gradient moves the parameter (lr / eps); at
# 8B widths lr 3e-4 drove the repeated batch's loss from 9.8 to 0.002 in
# two steps, where the loss is a difference of two nearly equal terms
# and its relative error grows past any fp32 bound
P20_LOSS_REL = 1e-5             # fp32 losses, split vs one rank, a step
P20_PARAM_RTOL, P20_PARAM_ATOL = 1e-5, 1e-6   # fp32 gathered parameters
P20_BF16_LOSS_REL = 2e-2        # bf16 losses, split vs one rank
P20_EMBED_STEPS = 20            # bench_sparse's pushes
P20_C1 = dict(N=8, H=28, W=28, C=64)          # a rank's batch
P20_C1_REL = 1e-5               # per-leaf ||mesh - one rank|| / ||one||
P20_FULL_STEPS = 2              # llama3_8b on four cards
P20_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# and the embedding leg's segment_sum, the C1 leg's #5, #6 and its update
P20_PATH_KERNELS = P20_KERNELS + ("segment_sum", "conv_bn_stats",
                                  "cbr_train_bwd", "flat_sgd")


def p20_cfg(name, dtype):
    from mxnet_tpu_torch.models.llama import CONFIGS
    return dataclasses.replace(CONFIGS[name], dtype=dtype)


def p20_params(cfg):
    """The seeded weights every rank and the one-rank run draw alike."""
    from mxnet_tpu_torch.models.llama import llama_init
    return llama_init(torch.Generator(device="cuda").manual_seed(1), cfg)


def p20_tokens(cfg):
    return torch.randint(0, cfg.vocab_size, (P20_BATCH, P20_SEQ + 1),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2), device="cuda")


def p20_step(cfg, params, mesh=None):
    from mxnet_tpu_torch.models.llama import llama_loss
    from mxnet_tpu_torch.parallel import LLAMA_RULES, ShardedTrainStep
    return ShardedTrainStep(lambda p, b: llama_loss(p, b, cfg), params,
                            mesh, rules=LLAMA_RULES if mesh else None,
                            optimizer="adamw", lr=P20_LR, eps=P20_EPS)


def p20_run(step, batch, steps, sync=None):
    """`steps` steps from step.init(): (params, state, losses, step ms,
    launches, variant labels, peak bytes); counts reset just before the
    steps and read just after."""
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    params, state = step.init()
    torch.cuda.synchronize()
    if sync is not None:
        sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    vbefore = variant_counts()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, step_num=i)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    variants = {"%s/%s" % k: n - vbefore.get(k, 0)
                for k, n in variant_counts().items()
                if n != vbefore.get(k, 0)}
    return (params, state, losses, times, launches, variants,
            torch.cuda.max_memory_allocated())


def p20_pushes(seed):
    """bench_sparse's pushes of `seed`, each padded to SPARSE_NNZ ids with
    -1 (padding, dropped by the update) and zero rows: the ranks exchange
    slabs of one size."""
    out = []
    for ids, grads in sparse_traffic(seed=seed)[:P20_EMBED_STEPS]:
        pad = SPARSE_NNZ - len(ids)
        out.append((np.concatenate([ids, np.full(pad, -1, np.int32)]),
                    np.concatenate([grads, np.zeros((pad, SPARSE_DIM),
                                                    np.float32)])))
    return out


def p20_c1(mx, gpu, seed):
    """The conv-BN-ReLU net of the C1 leg and this seed's batch."""
    net = mx.gluon.nn.HybridSequential()
    C = P20_C1["C"]
    for _ in range(2):
        net.add(mx.gluon.contrib.cnn.FusedConvBNReLUTrain(C, in_channels=C))
    net.initialize(ctx=gpu)
    g = torch.Generator(device="cuda").manual_seed(7)
    for prm in net.collect_params().values():
        if prm.name.endswith("weight"):
            prm.set_data(mx.nd.array((torch.randn(
                prm.shape, generator=g, device="cuda") * (9 * C) ** -0.5),
                ctx=gpu))
    shape = (P20_C1["N"], P20_C1["H"], P20_C1["W"], C)
    g = torch.Generator(device="cuda").manual_seed(100 + seed)
    x = torch.randn(shape, generator=g, device="cuda") + 3.0 * (seed % 2)
    y = torch.randn(shape, generator=g, device="cuda")
    return net, x, y


def tp_worker(out_dir):
    """One rank of main path 20, started by `python -m
    mxnet_tpu_torch.launch` (gloo on the one card, or NCCL one a card):
    llama3_8b_dry through ShardedTrainStep(LLAMA_RULES) on mesh fsdp=2,
    model=2 at fp32 and bf16, MeshEmbeddingComm over the ranks, the
    data-mesh FusedTrainStep of a conv-BN-ReLU net, and with four cards
    llama3_8b. Writes tp_rank<r>.json (rank 0 also the gathered fp32
    parameters); counts reset before each leg and read after it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.embedding import MeshEmbeddingComm, ShardedEmbedding
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.parallel import collectives, create_mesh, dist
    dist.initialize()
    rank, world = dist.rank(), dist.num_workers()
    dev = dist.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"rank": rank, "world": world, "backend": dist.backend(),
           "device": str(dev), "cards": torch.cuda.device_count()}
    t_start = time.perf_counter()
    mesh = create_mesh(**P20_MESH)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = p20_cfg("llama3_8b_dry", dtype)
        step = p20_step(cfg, p20_params(cfg), mesh)
        batch = step.shard_batch({"tokens": p20_tokens(cfg)})
        params, _, losses, times, launches, variants, peak = p20_run(
            step, batch, P20_STEPS, collectives.barrier)
        key = str(dtype).split(".")[-1]
        lp = params["layers"]["0"]
        rec[key] = {"losses": losses, "step_ms": times,
                    "launches": launches, "variants": variants,
                    "peak_bytes": peak,
                    "batch_block": list(batch["tokens"].shape),
                    "blocks": {k: list(t.shape) for k, t in (
                        ("wq", lp["attn"]["wq"]), ("wk", lp["attn"]["wk"]),
                        ("wo", lp["attn"]["wo"]), ("w1", lp["mlp"]["w1"]),
                        ("lm_head", params["lm_head"]),
                        ("tok_embeddings", params["tok_embeddings"]))}}
        if dtype == torch.float32:
            full = step.gather(params)
            if rank == 0:
                torch.save({n: t.cpu() for n, t in leaves(full)},
                           os.path.join(out_dir, "tp_params.pt"))
            del full
        del step, params, batch
        torch.cuda.empty_cache()
    # MeshEmbeddingComm over every rank: bench_sparse's traffic
    comm = MeshEmbeddingComm(None, world, rank)
    table = ShardedEmbedding(SPARSE_VOCAB, SPARSE_DIM, comm=comm,
                             optimizer="sgd", learning_rate=0.1, device=dev)
    lookups_at = sparse_traffic(seed=0)[:P20_EMBED_STEPS]
    pushes = p20_pushes(rank)
    collectives.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = []
    for (ids, _), (pids, grads) in zip(lookups_at, pushes):
        rows.append(table.lookup(ids))
        table.apply_grads(pids, grads)
    weight = table.gathered_weight()
    torch.cuda.synchronize()
    rec["embed"] = {"launches": launch_counts(),
                    "seconds": time.perf_counter() - t0,
                    "rows_a_rank": table.rows_per_shard}
    if rank == 0:
        one = ShardedEmbedding(SPARSE_VOCAB, SPARSE_DIM, optimizer="sgd",
                               learning_rate=0.1, device=dev)
        every = [p20_pushes(r) for r in range(world)]
        equal = True
        for s, (ids, _) in enumerate(lookups_at):
            equal = equal and torch.equal(rows[s], one.lookup(ids))
            one.apply_grads(np.concatenate([t[s][0] for t in every]),
                            np.concatenate([t[s][1] for t in every]))
        want = one.gathered_weight()
        rec["embed"].update(
            lookups_bit_equal=bool(equal),
            table_rel_err=((weight - want).abs().max()
                           / want.abs().max()).item())
        del one, want
    del table, rows, weight
    torch.cuda.empty_cache()
    # C1: the data-mesh FusedTrainStep's BatchNorm over the global batch
    gpu = mx.gpu(dev.index or 0)
    with gpu:
        net, x, y = p20_c1(mx, gpu, rank)
        step = mx.gluon.FusedTrainStep(
            net, mx.gluon.loss.L2Loss(), mx.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}),
            mesh=create_mesh(data=world))
        collectives.barrier()
        reset_launch_counts()
        from mxnet_tpu_torch.ops import variant_counts
        vbefore = variant_counts()
        loss = step(mx.nd.array(x, ctx=gpu), mx.nd.array(y, ctx=gpu))
        torch.cuda.synchronize()
        c1_launches = launch_counts()
        c1_variants = {"%s/%s" % k: n - vbefore.get(k, 0)
                       for k, n in variant_counts().items()
                       if n != vbefore.get(k, 0)}
        snap = snapshot(net)
        rec["c1"] = {"launches": c1_launches, "variants": c1_variants,
                     "loss": loss.asnumpy().item(),
                     "digest": digest(snap, list(snap))}
        if rank == 0:
            whole, _, _ = p20_c1(mx, gpu, 0)
            xs, ys = zip(*(p20_c1(mx, gpu, r)[1:] for r in range(world)))
            one = mx.gluon.FusedTrainStep(
                whole, mx.gluon.loss.L2Loss(), mx.gluon.Trainer(
                    whole.collect_params(), "sgd",
                    {"learning_rate": 0.1, "momentum": 0.9}))
            one_loss = one(mx.nd.array(torch.cat(xs), ctx=gpu),
                           mx.nd.array(torch.cat(ys), ctx=gpu))
            want = snapshot(whole)
            rec["c1"].update(
                rel_err={k: rel_err(snap[k], want[k]) for k in want},
                loss_whole=one_loss.asnumpy().item())
        del net, step
    torch.cuda.empty_cache()
    # BASELINE config 5 at full depth, where there are four cards
    if torch.cuda.device_count() >= P20_WORLD:
        cfg = p20_cfg("llama3_8b", torch.bfloat16)
        step = p20_step(cfg, p20_params(cfg), mesh)
        batch = step.shard_batch({"tokens": p20_tokens(cfg)})
        _, _, losses, times, launches, _, peak = p20_run(
            step, batch, P20_FULL_STEPS, collectives.barrier)
        rec["llama3_8b"] = {"losses": losses, "step_ms": times,
                            "launches": launches, "peak_bytes": peak}
        del step, batch
        torch.cuda.empty_cache()
    collectives.barrier()
    rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "tp_rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    dist.shutdown()


def p20_param_excess(got, want):
    """(worst leaf, max over it of |got - want| - (atol + rtol |want|)):
    <= 0 when every element is within the bound."""
    worst, excess = None, -math.inf
    for name, w in leaves(want):
        g = got[name].to(w.device)
        e = ((g.float() - w.float()).abs() - (P20_PARAM_ATOL + P20_PARAM_RTOL
                                              * w.float().abs())).max()
        if e.item() > excess:
            worst, excess = name, e.item()
    return worst, excess


def phase_tensor_parallel():
    """Main path 20: the one-rank runs here, then the four ranks of
    `tp_worker` under the port's launcher (counts reset inside each rank
    before each leg and read after it). Returns {kernel: launches on the
    path}."""
    from mxnet_tpu_torch.ops import KERNELS
    phase = "tensor_parallel"
    base = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = p20_cfg("llama3_8b_dry", dtype)
        step = p20_step(cfg, p20_params(cfg))
        params, _, losses, times, _, _, peak = p20_run(
            step, {"tokens": p20_tokens(cfg)}, P20_STEPS)
        base[dtype] = {"losses": losses, "step_ms": times,
                       "peak_bytes": peak}
        if dtype == torch.float32:
            base_params = params
        del step, params
        torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
               str(P20_WORLD), "--launcher", "local", "--root-uri",
               "file://" + os.path.join(tmp, "store"), "--timeout", "480",
               sys.executable, os.path.abspath(__file__), "--tp-worker",
               tmp]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=root, env=env, timeout=540)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, phase,
              "the ranks exited with %s" % run.returncode)
        ranks = []
        for r in range(P20_WORLD):
            with open(os.path.join(tmp, "tp_rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        split_params = torch.load(os.path.join(tmp, "tp_params.pt"),
                                  map_location="cuda")
    r0 = ranks[0]
    # every record first, then every check: one run shows every leg
    pending = []

    def later(cond, msg):
        pending.append((bool(cond), msg))
    worst, excess = p20_param_excess(split_params, base_params)
    del split_params, base_params
    torch.cuda.empty_cache()
    n = p20_cfg("llama3_8b_dry", torch.float32).n_layers
    expect = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    launches = {k: 0 for k in KERNELS}
    for r in ranks:
        for leg in (r["float32"]["launches"], r["bfloat16"]["launches"],
                    r["embed"]["launches"], r["c1"]["launches"]):
            for k, v in leg.items():
                launches[k] += v
    for key, dtype in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        want_rel = P20_LOSS_REL if key == "float32" else P20_BF16_LOSS_REL
        label = "fma" if key == "float32" else "wgmma"
        emit({"phase": phase, "leg": "llama3_8b_dry_" + key,
              "mesh": P20_MESH, "world": P20_WORLD,
              "backend": r0["backend"], "cards": r0["cards"],
              "tokens": [P20_BATCH, P20_SEQ],
              "batch_block": r0[key]["batch_block"],
              "blocks": r0[key]["blocks"],
              "losses": {r["rank"]: r[key]["losses"] for r in ranks},
              "one_rank_losses": base[dtype]["losses"],
              "loss_limit": want_rel,
              "step_ms": {r["rank"]: r[key]["step_ms"] for r in ranks},
              "one_rank_step_ms": base[dtype]["step_ms"],
              "peak_bytes": {r["rank"]: r[key]["peak_bytes"]
                             for r in ranks},
              "one_rank_peak_bytes": base[dtype]["peak_bytes"],
              "launches_per_step_a_rank": expect,
              "launches": {r["rank"]: r[key]["launches"] for r in ranks},
              "variants": r0[key]["variants"],
              **({"params_worst_leaf": worst, "params_excess": excess,
                  "params_bound": [P20_PARAM_RTOL, P20_PARAM_ATOL]}
                 if key == "float32" else {}),
              "note": ("four ranks share one card over gloo, collectives "
                       "staged through host memory: a correctness run; "
                       "its step time says nothing of NVLink"
                       if r0["cards"] < P20_WORLD else
                       "one rank a card over NCCL")})
        for r in ranks:
            got = r[key]
            per = {k: got["launches"][k] / P20_STEPS for k in P20_KERNELS}
            later(per == expect and all(
                got["launches"][k] == 0 for k in got["launches"]
                if k not in P20_KERNELS),
                "%s rank %d launches a step %s, expected %s"
                % (key, r["rank"], got["launches"], expect))
            other = [v for v in got["variants"]
                     if v.split("/")[0] in P20_KERNELS
                     and not v.split("/")[1].startswith(label)]
            later(not other, "%s rank %d flash launches off %s: %s"
                  % (key, r["rank"], label, got["variants"]))
            rels = [abs(a - b) / abs(b) for a, b in
                    zip(got["losses"], base[dtype]["losses"])]
            later(max(rels) <= want_rel,
                  "%s rank %d losses %s vs one rank %s (limit %g)"
                  % (key, r["rank"], got["losses"], base[dtype]["losses"],
                     want_rel))
    later(excess <= 0.0,
          "fp32 gathered parameters beyond rtol %g + atol %g: %s by %g"
          % (P20_PARAM_RTOL, P20_PARAM_ATOL, worst, excess))
    em = r0["embed"]
    emit({"phase": phase, "leg": "mesh_embedding_comm", "world": P20_WORLD,
          "vocab": SPARSE_VOCAB, "dim": SPARSE_DIM,
          "steps": P20_EMBED_STEPS, "rows_a_rank": em["rows_a_rank"],
          "lookups_bit_equal": em["lookups_bit_equal"],
          "table_rel_err": em["table_rel_err"], "limit": SPARSE_REL,
          "launches": em["launches"], "seconds": em["seconds"]})
    later(em["lookups_bit_equal"] and em["table_rel_err"] <= SPARSE_REL,
          "MeshEmbeddingComm: lookups equal %s, table %.3g from the "
          "world-1 table (limit %g)" % (em["lookups_bit_equal"],
                                        em["table_rel_err"], SPARSE_REL))
    later(all(r["embed"]["launches"].get("segment_sum", 0) > 0
              for r in ranks), "the embedding leg launched no "
          "segment_sum: %s" % em["launches"])
    c1 = r0["c1"]
    emit({"phase": phase, "leg": "c1_global_batchnorm", "world": P20_WORLD,
          "batch_a_rank": P20_C1, "launches": c1["launches"],
          "variants": c1["variants"], "loss": c1["loss"],
          "loss_whole": c1["loss_whole"],
          "max_rel_err": max(c1["rel_err"].values()), "limit": P20_C1_REL})
    later(len({r["c1"]["digest"] for r in ranks}) == 1,
          "C1: the ranks' weights or running statistics differ")
    later(max(c1["rel_err"].values()) <= P20_C1_REL,
          "C1: the mesh step is %s from one rank fed the whole batch "
          "(limit %g)" % (max(c1["rel_err"].items(), key=lambda kv: kv[1]),
                          P20_C1_REL))
    later(all(r["c1"]["launches"].get("conv_bn_stats") == 2
              and r["c1"]["variants"].get("cbr_train_bwd/split_v8+global")
              == 2 and r["c1"]["launches"].get("cbr_train_bwd") == 2
              and r["c1"]["launches"].get("flat_sgd") == 1 for r in ranks),
          "C1 launches %s, variants %s"
          % (c1["launches"], c1["variants"]))
    if "llama3_8b" in r0:
        full = r0["llama3_8b"]
        later(all(np.isfinite(full["losses"])),
              "llama3_8b losses %s" % full["losses"])
        emit({"phase": phase, "leg": "llama3_8b", "mesh": P20_MESH,
              "tokens": [P20_BATCH, P20_SEQ], "losses": full["losses"],
              "step_ms": {r["rank"]: r["llama3_8b"]["step_ms"]
                          for r in ranks},
              "peak_bytes": {r["rank"]: r["llama3_8b"]["peak_bytes"]
                             for r in ranks},
              "launches": full["launches"]})
        for r in ranks:
            for k, v in r["llama3_8b"]["launches"].items():
                launches[k] += v
    emit({"phase": phase, "world": P20_WORLD, "seconds": wall,
          "worker_seconds": r0["seconds"], "launches": launches,
          "card": card_name_and_limit()})
    for cond, msg in pending:
        check(cond, phase, msg)
    return launches


P21_MESH = {"data": 2, "model": 2}
P21_WORLD = 4
P21_BATCH, P21_SEQ = 16, 128    # the global batch: B 8 a rank over data=2
P21_MASK = 0.15                 # the share of MLM prediction sites
P21_STEPS = 3
P21_LR, P21_EPS = 1e-5, 1e-4    # as path 20: eps bounds how far a rounding
                                # difference of a near-zero gradient moves
                                # AdamW's step
P21_LOSS_REL = 1e-5             # fp32 losses, split vs one rank, a step
P21_PARAM_RTOL, P21_PARAM_ATOL = 1e-5, 1e-6   # fp32 gathered parameters
P21_BF16_LOSS_REL = 2e-2        # bf16 losses, split vs one rank
P21_RUN_LAYERS = 2              # leg (b)'s depth: bert_base widths, each
                                # rank's snapshot its blocks (230 MB fp32
                                # with AdamW's moments at 2 layers)
P21_RUN_STEPS, P21_CKPT_EVERY = 8, 2
P21_POLL_S = 0.05               # the maintenance poller's interval
P21_COMMIT_TIMEOUT_S = 10       # the mid-commit run's election timeout
P21_ZERO_BATCH, P21_ZERO_STEPS = 32, 4   # leg (c): batch 32 x seq 128
P21_ZERO_POISON = 2             # the data index whose gradient is poisoned
P21_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# and leg (c)'s LAMB on the ZeRO updater
P21_PATH_KERNELS = P21_KERNELS + ("flat_lamb1", "flat_lamb2")


def p21_cfg(dtype, n_layers=None):
    from mxnet_tpu_torch.models.bert import CONFIGS
    cfg = dataclasses.replace(CONFIGS["bert_base"], dtype=dtype)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def p21_params(cfg):
    """The seeded weights every rank and the one-rank run draw alike."""
    from mxnet_tpu_torch.models.bert import bert_init
    return bert_init(torch.Generator(device="cuda").manual_seed(1), cfg)


def p21_batch(i, cfg):
    """The global batch of data index `i`: tokens, targets and a 15% mask,
    from a seeded generator on the card."""
    g = torch.Generator(device="cuda").manual_seed(100 + i)
    shape = (P21_BATCH, P21_SEQ)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                    device="cuda"),
            "targets": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                     device="cuda"),
            "mask": (torch.rand(shape, generator=g, device="cuda")
                     < P21_MASK).float()}


def p21_step(cfg, params, mesh=None, rules=None):
    from mxnet_tpu_torch.models.bert import bert_mlm_loss
    from mxnet_tpu_torch.parallel import BERT_RULES, ShardedTrainStep
    return ShardedTrainStep(lambda p, b: bert_mlm_loss(p, b, cfg), params,
                            mesh, rules=(rules or BERT_RULES) if mesh
                            else None, optimizer="adamw", lr=P21_LR,
                            eps=P21_EPS)


class P21ModelGathers:
    """Counts the gathers on use over the ``model`` group of `mesh` while
    installed (around `collectives.gather_on_use`)."""

    def __init__(self, mesh):
        from mxnet_tpu_torch.parallel import collectives
        self._coll = collectives
        self._group = mesh.group("model")
        self.n = 0

    def __enter__(self):
        self._orig = self._coll.gather_on_use

        def counted(x, axis_name, dim, summed=True):
            group, world, _ = self._coll.resolve_group(axis_name)
            if world > 1 and group is self._group:
                self.n += 1
            return self._orig(x, axis_name, dim, summed)
        self._coll.gather_on_use = counted
        return self

    def __exit__(self, *exc):
        self._coll.gather_on_use = self._orig


def p21_run(step, cfg, steps, sync=None):
    """`steps` steps from step.init() on data indices 0.. (each rank its
    slice): (params, losses, step ms, launches, variants, peak bytes);
    counts reset just before the steps and read just after."""
    from mxnet_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                     variant_counts)
    params, state = step.init()
    batches = [step.shard_batch(p21_batch(i, cfg)) for i in range(steps)]
    torch.cuda.synchronize()
    if sync is not None:
        sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    vbefore = variant_counts()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batches[i], step_num=i)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    variants = {"%s/%s" % k: n - vbefore.get(k, 0)
                for k, n in variant_counts().items()
                if n != vbefore.get(k, 0)}
    return (params, losses, times, launches, variants,
            torch.cuda.max_memory_allocated())


def p21_digest(step, params):
    """sha256 of the whole leaves (gathered over the mesh: collective)."""
    return digest(dict(leaves(step.gather(params))), [
        n for n, _ in leaves(params)])


def p21_resilient(rank, out_dir):
    """Leg (b) on this rank: the fault-free steps, then three runs of
    ResilientRunner.for_sharded_step under fault plans (every rank's plan
    the same but the mid-commit one's). Returns the leg's record."""
    from mxnet_tpu_torch import resilience as rz
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import collectives, create_mesh
    from mxnet_tpu_torch.resilience import faults
    cfg = p21_cfg(torch.float32, P21_RUN_LAYERS)
    mesh = create_mesh(**P21_MESH)
    batch = lambda i: p21_batch(i, cfg)  # noqa: E731

    def fresh():
        step = p21_step(cfg, p21_params(cfg), mesh)
        return (step,) + step.init()

    def plain(indices):
        step, p, o = fresh()
        losses = []
        for s, i in enumerate(indices):
            p, o, loss = step(p, o, step.shard_batch(batch(i)), s)
            losses.append(loss.item())
        return p21_digest(step, p), losses

    def runner(tag, p_step, p, o, batch_fn=batch, **kw):
        return rz.ResilientRunner.for_sharded_step(
            p_step, p, o, batch_fn, ckpt_dir=os.path.join(
                out_dir, "p21_%s_rank%d" % (tag, rank)),
            ckpt_every=P21_CKPT_EVERY, max_restarts=4, **kw)

    def counts(rep):
        return {k: getattr(rep, k) for k in (
            "restarts", "retries", "steps_executed", "replayed_steps",
            "checkpoints", "proactive_ckpts", "rollbacks",
            "skipped_batches")}

    rec = {}
    clean_digest, clean_losses = plain(range(P21_RUN_STEPS))
    rec["clean"] = {"digest": clean_digest, "losses": clean_losses}
    telemetry.reset()
    # A: a preemption inside step 3 (restore and replay), then a
    # maintenance notice from the poller once data index 5 was fetched (a
    # proactive checkpoint at the next boundary the ranks agree on)
    step, p, o = fresh()
    plan = "train.step:preempt:4;preempt.poll:preempt:1"
    fetched = {"index": -1}

    def poll():
        return rz.preempt.default_poll() if fetched["index"] >= 5 else None

    def noted(i):
        fetched["index"] = max(fetched["index"], i)
        return batch(i)

    listener = rz.PreemptionListener(poll_fn=poll,
                                     poll_interval_s=P21_POLL_S,
                                     sigterm=False)
    collectives.barrier()
    t0 = time.perf_counter()
    with faults.inject(plan):
        run = runner("a", step, p, o, preempt_listener=listener,
                     commit=rz.CommitCoordinator(namespace="p21.a"),
                     batch_fn=noted)
        with listener:
            rep = run.run(P21_RUN_STEPS)
    hist = telemetry.registry.get("ckpt.save_ms").snapshot()
    rec["a"] = {"plan": plan, "counts": counts(rep), "losses": rep.losses,
                "seconds": time.perf_counter() - t0,
                "digest": p21_digest(run.active["step"],
                                     run.holder["params"]),
                "save_ms_p50": hist["p50"], "save_ms_max": hist["max"],
                "restore_ms": rep.recovery_time_s * 1e3
                / max(rep.restarts, 1)}
    del run, step, p, o
    torch.cuda.empty_cache()
    # C: the third save dies mid-commit on rank 1, the other ranks' save
    # election times out; every rank then resumes at the elected step
    step, p, o = fresh()
    plan = "checkpoint.save:preempt:3" if rank == 1 else ""
    err = None
    with faults.inject(plan):
        run = runner("c", step, p, o, commit=rz.CommitCoordinator(
            timeout_s=P21_COMMIT_TIMEOUT_S, namespace="p21.c1"))
        try:
            run.run(P21_RUN_STEPS)
        except rz.RetriableError as exc:
            err = type(exc).__name__
    run = runner("c", run.active["step"], run.holder["params"],
                 run.holder["opt_state"],
                 commit=rz.CommitCoordinator(namespace="p21.c2"))
    rep = run.run(P21_RUN_STEPS, resume=True)
    rec["c"] = {"plan": plan, "error": err,
                "resumed_at": next(i for i, l in enumerate(rep.losses)
                                   if l is not None),
                "losses": rep.losses,
                "digest": p21_digest(run.active["step"],
                                     run.holder["params"])}
    del run, step, p, o
    torch.cuda.empty_cache()
    # B: batch 5 poisoned (NaN in its mask): the loss sentinel trips, the
    # run rolls back to the last committed snapshot and skips the batch
    step, p, o = fresh()
    plan = "train.batch:corrupt:6"
    with faults.inject(plan):
        run = runner("b", step, p, o,
                     commit=rz.CommitCoordinator(namespace="p21.b"))
        rep = run.run(P21_RUN_STEPS)
    indices = [run.data_index(s) for s in range(P21_RUN_STEPS)]
    rec["b"] = {"plan": plan, "counts": counts(rep), "losses": rep.losses,
                "indices": indices,
                "digest": p21_digest(run.active["step"],
                                     run.holder["params"])}
    del run, step, p, o
    torch.cuda.empty_cache()
    rec["b"]["skipped_digest"], rec["b"]["skipped_losses"] = plain(indices)
    return rec


def p21_full_depth_snapshot(rank, mesh, out_dir):
    """One save and one restore of leg (a)'s fp32 step at bert_base's full
    depth, through ResilientRunner.for_sharded_step with a coordinated
    commit: the step-0 snapshot is saved, a preemption in the first step
    restores it, and the step runs again. Returns this rank's save and
    restore ms and the snapshot's bytes on disk."""
    from mxnet_tpu_torch import resilience as rz
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import faults
    cfg = p21_cfg(torch.float32)
    step = p21_step(cfg, p21_params(cfg), mesh)
    p, o = step.init()
    path = os.path.join(out_dir, "p21_full_rank%d" % rank)
    telemetry.reset()
    with faults.inject("train.step:preempt:1"):
        run = rz.ResilientRunner.for_sharded_step(
            step, p, o, lambda i: p21_batch(i, cfg), ckpt_dir=path,
            ckpt_every=1, max_restarts=1,
            commit=rz.CommitCoordinator(namespace="p21.full"))
        rep = run.run(1)
    hist = telemetry.registry.get("ckpt.save_ms").snapshot()
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)
    shutil.rmtree(path)
    return {"layers": cfg.n_layers, "save_ms": hist["max"],
            "saves": hist["count"], "restarts": rep.restarts,
            "restore_ms": rep.recovery_time_s * 1e3,
            "snapshot_bytes": size}


def resilient_worker(out_dir):
    """One rank of main path 21, started by `python -m
    mxnet_tpu_torch.launch` (gloo on the one card, or NCCL one a card):
    (a) bert_base through ShardedTrainStep(BERT_RULES) on mesh data=2,
    model=2 at fp32 and bf16 and beside it the same rules with no leaf
    consumed in place (every split gathered on use), (b) the resilient
    runs at P21_RUN_LAYERS layers under torch.use_deterministic_algorithms.
    Writes p21_rank<r>.json (rank 0 also the gathered fp32 parameters);
    counts reset before each leg and read after it."""
    from mxnet_tpu_torch.parallel import (BERT_RULES, collectives,
                                          create_mesh, dist)
    dist.initialize()
    rank, world = dist.rank(), dist.num_workers()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"rank": rank, "world": world, "backend": dist.backend(),
           "cards": torch.cuda.device_count()}
    t_start = time.perf_counter()
    mesh = create_mesh(**P21_MESH)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = p21_cfg(dtype)
        step = p21_step(cfg, p21_params(cfg), mesh)
        with P21ModelGathers(mesh) as log:
            params, losses, times, launches, variants, peak = p21_run(
                step, cfg, P21_STEPS, collectives.barrier)
        key = str(dtype).split(".")[-1]
        lp = params["layers"]["0"]
        rec[key] = {"losses": losses, "step_ms": times,
                    "launches": launches, "variants": variants,
                    "peak_bytes": peak, "model_gathers": log.n,
                    "blocks": {k: list(t.shape) for k, t in (
                        ("wq", lp["attn"]["wq"]), ("wo", lp["attn"]["wo"]),
                        ("w1", lp["ffn"]["w1"]), ("w2", lp["ffn"]["w2"]),
                        ("bq", lp["attn"]["bq"]),
                        ("word_embed", params["word_embed"]),
                        ("position_embed", params["position_embed"]))}}
        if dtype == torch.float32:
            full = step.gather(params)
            if rank == 0:
                torch.save({n: t.cpu() for n, t in leaves(full)},
                           os.path.join(out_dir, "p21_params.pt"))
            del full
        del step, params
        torch.cuda.empty_cache()
    # the gather-on-use route of the same rules (every model split whole)
    cfg = p21_cfg(torch.float32)
    step = p21_step(cfg, p21_params(cfg), mesh, BERT_RULES.without_local())
    with P21ModelGathers(mesh) as log:
        params, losses, times, launches, _, peak = p21_run(
            step, cfg, P21_STEPS, collectives.barrier)
    rec["gathered"] = {"losses": losses, "step_ms": times,
                       "peak_bytes": peak, "model_gathers": log.n,
                       "launches": launches}
    del step, params
    torch.cuda.empty_cache()
    # (b) at full depth: one save and one restore of (a)'s fp32 step
    rec["full_depth"] = p21_full_depth_snapshot(rank, mesh, out_dir)
    torch.cuda.empty_cache()
    # (b): deterministic kernels only from here (cuBLAS's workspace
    # variable was set before this process started CUDA)
    torch.use_deterministic_algorithms(True)
    os.environ["MXNET_TPU_INTEGRITY"] = "1"
    rec["resilient"] = p21_resilient(rank, out_dir)
    collectives.barrier()
    rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "p21_rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    dist.shutdown()


def p21_zero_leg(tmp):
    """Leg (c), world 1: bert_12_768_12 bf16 with LAMB through
    Trainer(kvstore="device", zero=True) as path 5 runs it, at batch
    P21_ZERO_BATCH, under MXNET_TPU_INTEGRITY=1. The ZeRO state through
    save_zero_state/restore_zero_state; a run of the resilient runner
    whose data index P21_ZERO_POISON has a NaN injected into a gradient
    (zero.bucket trips, rollback, skip) against a clean run over the same
    indices; #9/#10 launches a step; host syncs of one step with the
    sentinel off and on. Returns (record, launches of the clean run)."""
    import copy
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import resilience as rz
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import launch_counts, reset_launch_counts
    from mxnet_tpu_torch.optimizer.zero import ZeroComm, ZeroUpdater
    from mxnet_tpu_torch.parallel import restore_zero_state, save_zero_state
    gpu = mx.gpu(0)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    batches = [bert_batch(P21_ZERO_BATCH, gpu, seed=10 + i)
               for i in range(P21_ZERO_STEPS + 1)]

    def build():
        net = bert_net(gpu)
        return net, lamb_trainer(mx, net, True)

    def one_step(net, trainer, i, poison=False):
        x, y = batches[i]
        with mx.autograd.record():
            loss = sce(net(x)[3], y)
        loss.backward()
        if poison:
            g = next(p for p in net.collect_params().values()
                     if p.grad_req != "null").grad().data_torch
            g.view(-1)[0] = float("nan")
        trainer.step(x.shape[0])
        return loss

    rec = {}
    prev = os.environ.get("MXNET_TPU_INTEGRITY")
    os.environ["MXNET_TPU_INTEGRITY"] = "1"
    try:
        net, trainer = build()
        sfile = os.path.join(tmp, "p21_trainer.states")

        def state_get():
            trainer.save_states(sfile)
            with open(sfile, "rb") as f:
                blob = f.read()
            return {"params": {k: p.data().data_torch.cpu() for k, p in
                               net.collect_params().items()},
                    "opt": blob}

        def state_set(tree):
            for k, p in net.collect_params().items():
                p.data().data_torch.copy_(tree["params"][k])
            trainer._reset_kvstore()
            with open(sfile, "wb") as f:
                f.write(tree["opt"])
            trainer.load_states(sfile)

        run = rz.ResilientRunner(
            lambda i: one_step(net, trainer, i, i == P21_ZERO_POISON),
            state_get, state_set, ckpt_dir=os.path.join(tmp, "p21_zero"),
            ckpt_every=2, max_restarts=2)
        rep = run.run(P21_ZERO_STEPS)
        indices = [run.data_index(s) for s in range(P21_ZERO_STEPS)]
        got = snapshot(net)
        # the ZeRO state through save_zero_state / restore_zero_state
        upd = trainer._kvstore._updater
        path = os.path.join(tmp, "p21_zero_state")
        save_zero_state(path, upd, step=P21_ZERO_STEPS)
        back = restore_zero_state(path, ZeroUpdater(
            copy.deepcopy(upd.optimizer), comm=ZeroComm()))
        a, b = upd.state_payload(), back.state_payload()
        rec["zero_state_bit_equal"] = a["layout"] == b["layout"] and all(
            np.array_equal(arr, b["state"][bk][name])
            for bk, slots in a["state"].items()
            for name, arr in slots.items())
        n_buckets = len(upd.layout)
        del net, trainer, run, upd, back, a, b
        torch.cuda.empty_cache()
        # the clean run over the same indices
        net, trainer = build()
        torch.cuda.synchronize()
        reset_launch_counts()
        for i in indices:
            one_step(net, trainer, i)
        torch.cuda.synchronize()
        launches = launch_counts()
        want = snapshot(net)
        rec["rollback_bit_equal"] = sorted(got) == sorted(want) and all(
            torch.equal(t, want[k]) for k, t in got.items())
        # host syncs and sentinel checks of one step, the sentinel off and
        # on, twice each in turns (the second of each is read: a first
        # step may build host-side caches)
        syncs, checks = {}, {}
        for flag in ("0", "1", "0", "1"):
            os.environ["MXNET_TPU_INTEGRITY"] = flag
            before = telemetry.counter_value("integrity.checks")
            _, syncs[flag] = count_syncs(lambda: one_step(
                net, trainer, P21_ZERO_STEPS))
            checks[flag] = telemetry.counter_value("integrity.checks") \
                - before
        del net, trainer, got, want
        torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("MXNET_TPU_INTEGRITY", None)
        else:
            os.environ["MXNET_TPU_INTEGRITY"] = prev
    rec.update(counts={"rollbacks": rep.rollbacks,
                       "skipped_batches": rep.skipped_batches,
                       "restarts": rep.restarts,
                       "checkpoints": rep.checkpoints},
               indices=indices, buckets=n_buckets, launches=launches,
               syncs_off=syncs["0"], syncs_on=syncs["1"],
               checks_off=checks["0"], checks_on=checks["1"])
    return rec, launches


def phase_resilient_bert():
    """Main path 21: the one-rank runs of leg (a) here, then the four
    ranks of `resilient_worker` under the port's launcher (counts reset
    inside each rank before each leg and read after it), then leg (c)
    here. Returns {kernel: launches on the path}."""
    from mxnet_tpu_torch.ops import KERNELS
    phase = "resilient_bert"
    base = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = p21_cfg(dtype)
        step = p21_step(cfg, p21_params(cfg))
        params, losses, times, _, _, peak = p21_run(step, cfg, P21_STEPS)
        base[dtype] = {"losses": losses, "step_ms": times,
                       "peak_bytes": peak}
        if dtype == torch.float32:
            base_params = params
        del step, params
        torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p21_") as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        # cuBLAS reads it when a rank starts CUDA: leg (b) runs under
        # torch.use_deterministic_algorithms
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
               str(P21_WORLD), "--launcher", "local", "--root-uri",
               "file://" + os.path.join(tmp, "store"), "--timeout", "480",
               sys.executable, os.path.abspath(__file__),
               "--resilient-worker", tmp]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=root, env=env, timeout=540)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, phase,
              "the ranks exited with %s" % run.returncode)
        ranks = []
        for r in range(P21_WORLD):
            with open(os.path.join(tmp, "p21_rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        split_params = torch.load(os.path.join(tmp, "p21_params.pt"),
                                  map_location="cuda")
        zero, zero_launches = p21_zero_leg(tmp)
    r0 = ranks[0]
    pending = []

    def later(cond, msg):
        pending.append((bool(cond), msg))
    worst, excess = p20_param_excess(split_params, base_params)
    del split_params, base_params
    torch.cuda.empty_cache()
    n = p21_cfg(torch.float32).n_layers
    expect = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    launches = {k: 0 for k in KERNELS}
    for r in ranks:
        for leg in (r["float32"]["launches"], r["bfloat16"]["launches"]):
            for k, v in leg.items():
                launches[k] += v
    for k, v in zero_launches.items():
        launches[k] += v
    for key, dtype in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        want_rel = P21_LOSS_REL if key == "float32" else P21_BF16_LOSS_REL
        label = "fma" if key == "float32" else "wgmma"
        emit({"phase": phase, "leg": "a_bert_base_" + key,
              "mesh": P21_MESH, "world": P21_WORLD,
              "backend": r0["backend"], "cards": r0["cards"],
              "tokens": [P21_BATCH, P21_SEQ], "blocks": r0[key]["blocks"],
              "losses": {r["rank"]: r[key]["losses"] for r in ranks},
              "one_rank_losses": base[dtype]["losses"],
              "loss_limit": want_rel,
              "step_ms": {r["rank"]: r[key]["step_ms"] for r in ranks},
              "one_rank_step_ms": base[dtype]["step_ms"],
              "peak_bytes": {r["rank"]: r[key]["peak_bytes"]
                             for r in ranks},
              "one_rank_peak_bytes": base[dtype]["peak_bytes"],
              "model_gathers": {r["rank"]: r[key]["model_gathers"]
                                for r in ranks},
              "launches_per_step_a_rank": expect,
              "variants": r0[key]["variants"],
              **({"params_worst_leaf": worst, "params_excess": excess,
                  "params_bound": [P21_PARAM_RTOL, P21_PARAM_ATOL],
                  "gather_route": {
                      "step_ms": {r["rank"]: r["gathered"]["step_ms"]
                                  for r in ranks},
                      "peak_bytes": {r["rank"]: r["gathered"]["peak_bytes"]
                                     for r in ranks},
                      "model_gathers": r0["gathered"]["model_gathers"],
                      "losses": r0["gathered"]["losses"]}}
                 if key == "float32" else {}),
              "note": ("four ranks share one card over gloo, collectives "
                       "staged through host memory: a correctness run"
                       if r0["cards"] < P21_WORLD else
                       "one rank a card over NCCL")})
        for r in ranks:
            got = r[key]
            per = {k: got["launches"][k] / P21_STEPS for k in P21_KERNELS}
            later(per == expect and all(
                got["launches"][k] == 0 for k in got["launches"]
                if k not in P21_KERNELS),
                "%s rank %d launches a step %s, expected %s"
                % (key, r["rank"], got["launches"], expect))
            other = [v for v in got["variants"]
                     if v.split("/")[0] in P21_KERNELS
                     and not v.split("/")[1].startswith(label)]
            later(not other, "%s rank %d flash launches off %s: %s"
                  % (key, r["rank"], label, got["variants"]))
            later(got["model_gathers"] == 0,
                  "%s rank %d gathered %d leaves over model on use"
                  % (key, r["rank"], got["model_gathers"]))
            rels = [abs(a - b) / abs(b) for a, b in
                    zip(got["losses"], base[dtype]["losses"])]
            later(max(rels) <= want_rel,
                  "%s rank %d losses %s vs one rank %s (limit %g)"
                  % (key, r["rank"], got["losses"], base[dtype]["losses"],
                     want_rel))
    later(excess <= 0.0,
          "fp32 gathered parameters beyond rtol %g + atol %g: %s by %g"
          % (P21_PARAM_RTOL, P21_PARAM_ATOL, worst, excess))
    later(r0["gathered"]["model_gathers"] > 0,
          "the gather-on-use route gathered nothing over model")
    # (b)
    res = [r["resilient"] for r in ranks]
    b0 = res[0]
    emit({"phase": phase, "leg": "b_resilience", "layers": P21_RUN_LAYERS,
          "steps": P21_RUN_STEPS, "ckpt_every": P21_CKPT_EVERY,
          "a": {k: b0["a"][k] for k in ("plan", "counts", "seconds",
                                        "save_ms_p50", "save_ms_max",
                                        "restore_ms")},
          "c": {"plans": [x["c"]["plan"] for x in res],
                "errors": [x["c"]["error"] for x in res],
                "resumed_at": [x["c"]["resumed_at"] for x in res]},
          "b": {k: b0["b"][k] for k in ("plan", "counts", "indices")},
          "clean_losses": b0["clean"]["losses"],
          "full_depth": {r["rank"]: r["full_depth"] for r in ranks}})
    for r in ranks:
        fd = r["full_depth"]
        later(fd["saves"] == 1 and fd["restarts"] == 1,
              "rank %d full-depth snapshot: %d saves, %d restores"
              % (r["rank"], fd["saves"], fd["restarts"]))
    clean = b0["clean"]["digest"]
    for i, x in enumerate(res):
        later(x["clean"]["digest"] == clean,
              "rank %d's fault-free weights differ from rank 0's" % i)
        later(x["a"]["digest"] == clean and x["a"]["losses"]
              == x["clean"]["losses"],
              "rank %d: the replayed run is not bit-equal to the "
              "fault-free one (losses %s vs %s)"
              % (i, x["a"]["losses"], x["clean"]["losses"]))
        ca = x["a"]["counts"]
        later(ca["restarts"] == 2 and ca["proactive_ckpts"] == 1
              and ca["replayed_steps"] == 1 and ca["rollbacks"] == 0,
              "rank %d run A counts %s: expected 2 restarts (the step "
              "preemption and the notice), 1 proactive checkpoint, 1 "
              "replayed step" % (i, ca))
        later(x["c"]["error"] == ("PreemptionError" if i == 1
                                  else "RetriableError"),
              "rank %d mid-commit run ended with %s" % (i, x["c"]["error"]))
        later(x["c"]["resumed_at"] == res[0]["c"]["resumed_at"]
              and x["c"]["digest"] == clean,
              "rank %d resumed at %s (rank 0 at %s), weights equal: %s"
              % (i, x["c"]["resumed_at"], res[0]["c"]["resumed_at"],
                 x["c"]["digest"] == clean))
        cb = x["b"]["counts"]
        later(cb["rollbacks"] == 1 and cb["skipped_batches"] == 1
              and x["b"]["digest"] == x["b"]["skipped_digest"]
              and x["b"]["losses"] == x["b"]["skipped_losses"],
              "rank %d rollback run %s, indices %s, equal to the skipped "
              "run: %s" % (i, cb, x["b"]["indices"], x["b"]["digest"]
                           == x["b"]["skipped_digest"]))
    # (c)
    emit({"phase": phase, "leg": "c_zero_sentinel",
          "batch": [P21_ZERO_BATCH, BERT_SEQ], "steps": P21_ZERO_STEPS,
          **zero})
    later(zero["zero_state_bit_equal"], "ZeRO state round trip differs")
    later(zero["rollback_bit_equal"] and zero["counts"]["rollbacks"] == 1
          and zero["counts"]["skipped_batches"] == 1,
          "ZeRO rollback %s, bit-equal to the skipped run: %s"
          % (zero["counts"], zero["rollback_bit_equal"]))
    later(all(zero["launches"][k] == zero["buckets"] * P21_ZERO_STEPS
              for k in LAMB_KERNELS),
          "LAMB launches %s for %d buckets a step"
          % (zero["launches"], zero["buckets"]))
    # off, the sentinel reads nothing back; on, one check (one host read)
    # a bucket, and no more syncs than that
    later(zero["checks_off"] == 0 and zero["checks_on"] == zero["buckets"]
          and 0 < zero["syncs_on"] - zero["syncs_off"] <= zero["buckets"],
          "a step's sentinel checks %d off, %d on; host syncs %d off, %d "
          "on; %d buckets" % (zero["checks_off"], zero["checks_on"],
                              zero["syncs_off"], zero["syncs_on"],
                              zero["buckets"]))
    emit({"phase": phase, "world": P21_WORLD, "seconds": wall,
          "worker_seconds": r0["seconds"], "launches": launches,
          "card": card_name_and_limit()})
    for cond, msg in pending:
        check(cond, phase, msg)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from mxnet_tpu_torch.models.llama import CONFIGS, llama_init
    from mxnet_tpu_torch.ops import (KERNELS, launch_counts,
                                     reset_launch_counts, variant_counts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = {"flash_fwd": phase_kernel(gen)}
    entries.update(phase_kernel_bwd(gen))

    cfg = CONFIGS["llama_110m"]
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    # main path 1: serving
    reset_launch_counts()
    tokens = phase_forward(params, cfg, gen)
    phase_prefill(params, cfg, tokens)
    serve_once(params, cfg, "serve")
    serve_launches = launch_counts()
    check_path(serve_launches, SERVE_KERNELS, "main_path_serve")
    # bf16 serving: every forward launch (forward, prefill, the server's
    # prefill windows) on the wgmma variant
    check_fwd_wgmma({}, variant_counts(), serve_launches["flash_fwd"],
                    "main_path_serve", "serving")
    vbefore = variant_counts()
    phase_consistency(params, cfg)
    # fp32 serving: every forward launch on the FMA variant
    fma = {key: n - vbefore.get(key, 0)
           for key, n in variant_counts().items()
           if key[0] == "flash_fwd" and n != vbefore.get(key, 0)}
    check(len(fma) == 1 and next(iter(fma))[1].startswith("fma"),
          "consistency", "fp32 flash_fwd launches took %s" % fma)
    del params

    # main path 2: training (counts reset inside, read right after step 6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        cfg, step, batch, tparams, tstate, train_launches = phase_train(
            gen, ckpt)
        check_path(train_launches, TRAIN_KERNELS, "main_path_train")
        phase_checkpoint(step, batch, tparams, tstate, ckpt)
    phase_train_split(cfg, step, batch, tparams, tstate)
    phase_train_profile(step, batch, tparams, tstate)
    del tparams, tstate, step
    torch.cuda.empty_cache()
    phase_train_gqa(gen)
    torch.cuda.empty_cache()

    # main path 3: ResNet-50 Gluon inference (counts reset inside, read
    # right after the one forward)
    entries["conv_bn_relu"] = phase_kernel_cbr(gen)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_") as tmp:
        net, resnet_launches = phase_resnet_infer(gen, tmp)
    phase_resnet_throughput(net, gen)
    del net
    torch.cuda.empty_cache()

    # main path 4: ResNet-50 Gluon training (counts reset inside, read
    # right after the FusedTrainStep steps and after the Adam loop)
    entries.update(phase_kernel_cbr_train(gen))
    entries.update(phase_kernel_opt(gen))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        net, loss_fn, train4_launches = phase_resnet_train(gen, tmp)
    phase_resnet_train_throughput(net, loss_fn)
    del net
    torch.cuda.empty_cache()

    # main path 5: BERT-base pretraining with LAMB on the ZeRO updater
    # (counts reset inside, read right after the 6 steps and around the
    # functional step)
    entries.update(phase_kernel_lamb(gen))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as tmp:
        net, trainer, batch, bert_launches = phase_bert_train(gen, tmp)
    phase_bert_train_throughput(net, trainer, batch)
    del net, trainer
    torch.cuda.empty_cache()

    # main path 6: sparse embeddings (counts reset inside, read right after
    # the 20 pushes and after the 10 DLRM steps)
    entries["segment_sum"] = phase_kernel_segment_sum(gen)
    sparse_launches = phase_sparse_embed()
    check_path(sparse_launches, SPARSE_KERNELS, "main_path_sparse_embed")
    dlrm_launches = phase_dlrm_train(gen)
    check_path(dlrm_launches, SPARSE_KERNELS, "main_path_dlrm_train")
    torch.cuda.empty_cache()

    # the optimizer family on the card; main path 7: BERT-base through
    # Gluon with AdamW and FusedTrainStep (counts reset inside, read right
    # after the timed steps)
    phase_optimizers()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gluon_bert_") as tmp:
        gluon_bert_launches = phase_bert_gluon_train(tmp)
    check_path(gluon_bert_launches, (), "main_path_bert_gluon")
    torch.cuda.empty_cache()

    # main path 8: the factorization machine; main path 9: matrix
    # factorization through Gluon (counts reset inside, read right after
    # the timed steps)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fm_") as tmp:
        fm_launches = phase_gluon_sparse_fm(tmp)
    check_path(fm_launches, SPARSE_KERNELS, "main_path_gluon_sparse_fm")
    torch.cuda.empty_cache()
    mf_launches = phase_gluon_sparse_mf()
    check_path(mf_launches, MF_KERNELS, "main_path_gluon_sparse_mf")
    torch.cuda.empty_cache()

    # main path 10: the Gluon MLP on MNIST; main path 11: ResNet-50 fed by
    # a DataLoader (counts reset inside, read right after the epoch and
    # after each worker count's timed steps)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mnist_") as tmp:
        mlp_launches = phase_gluon_mlp(tmp)
    check_path(mlp_launches, ("flat_sgd",), "main_path_gluon_mlp_mnist")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loader_") as tmp:
        loader_launches = phase_resnet_dataloader(tmp)
    check_path(loader_launches, RESNET_TRAIN_KERNELS,
               "main_path_gluon_data_resnet50")
    torch.cuda.empty_cache()

    # main path 12: ResNet-50 through mx.mod.Module.fit (counts reset inside,
    # read right after the timed batches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_module_") as tmp:
        module_launches = phase_module_resnet50(tmp)
    check_path(module_launches, ("flat_sgd",), "main_path_module_resnet50")
    torch.cuda.empty_cache()

    # main path 13: the Gluon word LM; main path 14: an LSTM
    # BucketingModule through mx.rnn (counts reset inside, read right after
    # the timed steps and batches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_word_lm_") as tmp:
        word_lm_launches = phase_gluon_word_lm(tmp)
    check_path(word_lm_launches, ("flat_sgd",), "main_path_gluon_word_lm")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bucketing_") as tmp:
        bucketing_launches = phase_module_lstm_bucketing(tmp)
    check_path(bucketing_launches, ("flat_sgd",),
               "main_path_module_lstm_bucketing")
    torch.cuda.empty_cache()

    # the op set on the card against the CPU; main path 15: SSD-512 on
    # ResNet-50 (counts reset inside, read right after the timed steps and
    # around one predict-mode forward)
    phase_ops()
    torch.cuda.empty_cache()
    ssd_launches, ssd_infer_launches = phase_ssd_resnet50()
    check_path(ssd_launches, SSD_KERNELS_TRAIN, "main_path_ssd_train")
    check_path(ssd_infer_launches, RESNET_KERNELS, "main_path_ssd_infer")
    torch.cuda.empty_cache()

    # main path 16: Inception-v3 training through Gluon and the zoo's other
    # families; main path 17: the DCGAN (counts reset inside, read right
    # after the timed steps)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        inception_launches = phase_zoo_inception_v3(tmp)
    check_path(inception_launches, ("flat_sgd",), "main_path_zoo_inception_v3")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dcgan_") as tmp:
        dcgan_launches = phase_gluon_dcgan(tmp)
    check_path(dcgan_launches, ("flat_adam",), "main_path_gluon_dcgan")
    torch.cuda.empty_cache()

    # main path 18: speculative serving, sampling, a replica kill and the
    # watchdog (counts reset inside, read right after the spec and
    # baseline runs: no kernel)
    spec_launches = phase_serve_spec()
    check_path(spec_launches, (), "main_path_serve_spec")
    torch.cuda.empty_cache()

    # main path 19: multi-rank communication (counts reset inside each
    # rank before each leg and read after it; around the ring fleet here)
    multi_launches = phase_multi_rank()
    check_path(multi_launches, MULTI_RANK_KERNELS, "main_path_multi_rank")
    torch.cuda.empty_cache()

    # main path 20: tensor and FSDP parallelism (counts reset inside each
    # rank before each leg and read after it)
    tp_launches = phase_tensor_parallel()
    check_path(tp_launches, P20_PATH_KERNELS, "main_path_tensor_parallel")
    torch.cuda.empty_cache()

    # main path 21: native Megatron for BERT and resilient sharded
    # training (counts reset inside each rank before each leg and read
    # after it, and around leg (c)'s clean run)
    resilient_launches = phase_resilient_bert()
    check_path(resilient_launches, P21_PATH_KERNELS,
               "main_path_resilient_bert")

    print(card_name_and_limit(), flush=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = entries[name]
        # launches on the main paths that run the kernel
        launches = serve_launches[name] + train_launches[name] \
            + resnet_launches[name] + train4_launches[name] \
            + bert_launches[name] + sparse_launches[name] \
            + dlrm_launches[name] + gluon_bert_launches[name] \
            + fm_launches[name] + mf_launches[name] \
            + mlp_launches[name] + loader_launches[name] \
            + module_launches[name] + word_lm_launches[name] \
            + bucketing_launches[name] + ssd_launches[name] \
            + ssd_infer_launches[name] + inception_launches[name] \
            + dcgan_launches[name] + spec_launches[name] \
            + multi_launches[name] + tp_launches[name] \
            + resilient_launches[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/" + source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            # the kernel's own device time, where the phase read it
            **({"device_ms": rec["device_ms"]} if "device_ms" in rec
               else {})})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main_multi_rank():
    """`--only multi_rank`: the build and main path 19 alone (for iterating
    on the path; a run with no arguments drives every path)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    launches = phase_multi_rank()
    check_path(launches, MULTI_RANK_KERNELS, "main_path_multi_rank")
    print(card_name_and_limit(), flush=True)


def main_tensor_parallel():
    """`--only tensor_parallel`: the build and main path 20 alone (for
    iterating on the path; a run with no arguments drives every path)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    launches = phase_tensor_parallel()
    check_path(launches, P20_PATH_KERNELS, "main_path_tensor_parallel")
    print(card_name_and_limit(), flush=True)


def main_resilient_bert():
    """`--only resilient_bert`: the build and main path 21 alone (for
    iterating on the path; a run with no arguments drives every path)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    launches = phase_resilient_bert()
    check_path(launches, P21_PATH_KERNELS, "main_path_resilient_bert")
    print(card_name_and_limit(), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--multi-rank-worker":
        multi_rank_worker(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--tp-worker":
        tp_worker(sys.argv[2])
    elif sys.argv[1:] == ["--only", "multi_rank"]:
        main_multi_rank()
    elif len(sys.argv) == 3 and sys.argv[1] == "--resilient-worker":
        resilient_worker(sys.argv[2])
    elif sys.argv[1:] == ["--only", "tensor_parallel"]:
        main_tensor_parallel()
    elif sys.argv[1:] == ["--only", "resilient_bert"]:
        main_resilient_bert()
    else:
        main()
