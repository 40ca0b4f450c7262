#!/usr/bin/env python3
"""Smoke test of deltaconv_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed S] [--parent DIR] [--phase fit|ranks|rest]

(``--phase fit`` runs only the group "training loop, checkpoints and
CLIs", items 36 to 42; ``--phase ranks`` only "training across ranks",
items 43 to 45; ``--phase rest`` only "the rest of the JAX package",
items 46 to 52.)

Run on a machine with a CUDA card and the CUDA toolkit, from any working
directory: the script puts its own directory (the root of a checkout)
first on ``sys.path``. It

1. requires a card and prints its ``nvidia-smi`` name and power limit;
2. builds the seventy-four CUDA kernels from ``deltaconv_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes of the serving paths and the train steps (B=32, N=1024,
   K=20; C = 64, 128, 256 for the neighbour max and sum; the bf16 maxes
   at C = 64 and 128 and 128 -> 256, the bf16 train maxes at C = 64 and
   128, their backward also at 256, the train matmul max at 128 -> 256;
   knn_topk also at N=4096, and at the three model shapes (B, N, K) =
   (32, 1024, 20), (16, 2048, 30), (4, 8192, 20), packed and exact, with
   and without the mean distances, on surface clouds and a tie-heavy
   grid, bit-equal, and its rounds route (``knn_topk_rounds``, K=80);
   segmentation serving's kernels at B=16,
   N=2048, K=30: the bf16 max without winners at C=128, gather_mlp_max
   at conv0, 3 -> 64 -> 64 (the fused kernel), and conv2, 128 -> 256 ->
   256 (mlp_rows, then gather_max_merge, each also held alone); int8
   serving's densify_int8 at both models' shapes (on the clouds' operator
   coefficients, and with half-way quotients and an all-zero cloud; all
   four outputs bit-equal, and across two calls), gather_max_int8 at C =
   64 and 128 (and 128 at the
   segmentation shapes) through both routes (route S, by shape: absmax,
   then the staged max with a quantizing epilogue; route D,
   ``gather_max_int8_direct``, forced), bit-equal, absmax equal to
   ``vector_norm(inf)``, gather_matmul_max_int8 at 128 -> 256; the
   neighbour max's two routes (route S, a cloud's channel slice staged in
   shared memory, by shape; route D, ``_direct``, forced) at every shape
   and width where the model paths run them (f32 at C = 64, 128, 256
   with and without winners, the bf16 step's winners at 64 and 128, bf16
   segmentation serving at 128, the large clouds' f32 forward and bf16
   step), values and winners bit-equal, each timed by CUDA events and in
   device time beside the plain version, the library call and the bound;
   ``[bwd-routes]``: the winner-routed backward's two routes (route S,
   shared-memory f64 sums, by shape; route D, ``_direct``, forced) at the
   f32 step's C = 64, 128, 256, the bf16 step's 64, 128, 256 and the
   large clouds' bf16 step and f32 backward, and the two-map form at
   C=256, bit-equal to the plain version on exact-sum cotangents and
   across two calls, timed the same way with every slice that fits, and
   the int8 max's two routes at its forwards' shapes; ``[affine-routes]``:
   the bf16 eval max (gather_max_affine) at B=32, N=1024 and B=4,
   N=8192, C = 64 with and without the self row and 128, through route S
   (by shape; its affine rows read from device memory) and route D (``gather_max_affine_direct``, forced), on
   the kNN graph and on hard rows (no valid slot, a masked slot 0, ids
   outside the cloud, a NaN), bit-equal to the plain version and across
   two calls, each timed; ``[minmax-routes]``: the neighbour min/max
   (gather_minmax, with winners gather_minmax_win, f32 at C = 64, 128,
   256 and bf16 at 64, 128) at B=32, N=1024 and B=4, N=8192 through
   route S (by shape: the staged min/max) and route D (``_direct``,
   forced), on the kNN graph and on hard rows, values and winners
   bit-equal to the plain version and across two calls, each timed by
   CUDA events and in device time beside the plain version, the library
   call and the bound, and gather_matmul_minmax (128 -> 256) at both
   shapes through the one-product-a-row route and the K-fold route
   (``gather_matmul_minmax_kfold``), bit-equal to each other and on
   exact sums to the plain version, each timed; ``[wls-routes]``: wls at
   B=32, N=1024, K=20,
   B=16, N=2048, K=30 and B=4, N=8192, K=20 and wls_bwd at the first and
   the last, on kNN graphs with a padded cloud, through the split route
   (by shape) and the direct route (``wls_direct``, ``wls_bwd_direct``,
   forced), the forward within 1e-5 of the plain version, each VJP
   plane within 1e-4 x its max, a second call bit-equal, each timed,
   and the split route at every number of warps that holds K edges;
   and the int8 matmul max through its one-product-a-row route and its
   K-fold route (``_kfold``), bit-equal to each other; the
   large-cloud kernels at B=4, N=8192, K=20 on the clouds' own
   coefficients: the gather plan (coef_plan_order, coef_plan_runs) equal
   to its plain builder entry by entry, coef_apply_grad at C = 3, 70,
   192, 256, 301 and coef_apply_div at C = 6, 128, 256, 301, f32 and
   bf16, bit-equal on route A and on the planned route (the _plan
   kernels, where the rows are a multiple of 16 bytes of at least 256),
   each timed on both routes at one forward's widths beside the plain
   version, ``gather`` + ``einsum`` and ``F.embedding_bag``, with the
   rows they gather and the plan's build, scatter_rows at C' = 70,
   256, 512 on component-major rows and on the edge-major view that the
   coefficient VJPs pass (within 1e-5 x max of ``scatter_add_``,
   bit-equal across two calls), its inverse adjacency equal to the plain
   stable ``argsort``, and scatter_rows at C'=9 on the operator build's
   component-major ``[B, 9, K, N]`` rows (B=32, N=1024) read through
   their strides (the wrapper's route) and transposed first by
   ``permute`` + ``contiguous``; the min/max hooks' kernels: gather_minmax and
   gather_minmax_win at f32 C=256 and bf16 C=128, bit-equal,
   gather_minmax_bwd at C=256 with f32 and bf16 cotangents,
   gather_matmul_minmax at 128 -> 256, within one bf16 ulp or the f32
   summation bound of the f64 product; the bf16 matmul maxes,
   gather_matmul_max and gather_matmul_max_win, at conv3 of both models
   that run them, B=32, N=1024 and B=4, N=8192, 128 -> 256, through both
   routes, the one-product-a-row kernels and the K-fold ones
   (``_kfold``), exact sums bit-equal, random inputs held and the two
   routes bit-equal to each other, each timed beside the per-point
   composition ``x @ w`` then the port's max), uniform and masked, and times
   the kernel, the plain
   version and, where
   PyTorch's library calls compute the same function, those calls with
   their set-up (CUDA events around 5 back-to-back calls, median of 30
   such samples; on the uniform graphs, where every slot is valid, the
   neighbour maxes' and sums' library calls are the ``index`` gather with
   ``amax``, ``max`` or ``sum`` over K, after the matmul, quantization or
   before the epilogue as the function has them, and their backward
   ``scatter_add_``); each kernel's bound is the larger of its bytes over
   3.35 TB/s and the operations the function needs over the peak of
   their type (989 TFLOP/s bf16 tensor cores; 33.5 T thread
   instructions/s issued outside them), from this run's shapes;
4. serves 64 uniform and 11 ragged clouds with normals through
   ``InferenceEngine`` on ``DeltaNetClassification(num_classes=40)`` at
   the reference width, weights drawn from a seeded generator with
   randomized BatchNorm statistics, counting each kernel's launches, and
   checks the logits: finite, of the right shape, equal (atol 1e-3, same
   argmax) to the same engine run through the plain versions on the
   card, and a full cloud's logits the same served ragged or uniform;
5. serves the same clouds at the JAX package's production config
   (``knn_method="approx"``, ``precision="bfloat16"``) on the same
   weights, counting launches, and checks the logits: finite, of the
   right shape, the kernel path within 0.01 x max|logit| of the plain
   path on the card, within the JAX package's bf16 bound (0.05 x
   max|logit|) of the port's own f32 engine, the argmax equal wherever
   the reference's top-2 margin exceeds twice the deviation, and a full
   cloud served ragged (exact kNN route) or uniform (knn_topk) within
   that bound; it prints clouds/s and a profile of one call; then
   ``[serve-int8]`` serves the same clouds on the same weights at
   ``precision="int8"`` (bf16 compute on int8 operators, the JAX
   package's int8 serving mode), held the same way, with densify_int8
   once, gather_max_int8 three times and gather_matmul_max_int8 once a
   forward, and ``[applies]`` times one forward's operator applies on the
   int8 operators beside the bf16 ones (and the int8 values widened to
   bf16 in one ``bmm``, exact, for comparison); it times
   the last conv's max in both forms, for eval (``gather_matmul_max``,
   and ``x @ w`` followed by ``gather_max_affine`` at C=256) and for
   training (``gather_matmul_max_win``, and ``x @ w`` rounded to bf16
   followed by ``gather_max_win_bf16`` at C=256), at B=32, N=1024 and
   B=4, N=8192, by CUDA events and in device time; ``[device-times]``
   prints the device time of a 32-cloud bf16 classification forward, a
   bf16 classification step, a 4-cloud large-cloud bf16 forward, a
   large-cloud bf16 step, a large-cloud f32 forward, a 32-cloud f32
   classification forward, the f32 classification step, a 32-cloud int8
   classification forward and 16-cloud bf16 and int8 segmentation
   forwards (each bf16 classification path launches the matmul max's
   one-product-a-row kernel once a call and its K-fold route never, and
   each bf16 forward gather_max_affine three times and its route D never,
   which their phases check);
6. trains the f32 model at the reference recipe (B=32 clouds of
   N=1024, SGD lr 0.1, momentum 0.9, weight decay 1e-4, label smoothing
   0.2, dropout 0.5 from a seeded CUDA generator) for 20 steps on one
   batch of class-conditioned ellipsoids, counting launches: the losses
   must be finite and fall; it times each step and prints a profile of
   one step;
7. takes one step from the same weights through the kernels and through
   the plain versions (dropout 0), uniform and ragged, and compares the
   loss (rtol 1e-5), every gradient and updated parameter (1e-3 x the
   tensor's max) and the running statistics (1e-4 x max), with the
   operators built by the kernels on both sides; with the plain build on
   the plain side it holds the loss and the statistics (winner flips at
   near-ties move single gradients); then the first comparison again
   with the gather-sum cutoff at 0, the route of clouds whose adjacency
   exceeds its budget, counting the streaming kernels' launches;
8. trains the same model at the JAX package's production config
   (``compute_dtype`` and ``operator_dtype`` bf16, ``knn_method=
   "approx"``) at the reference recipe for 20 steps, counting launches:
   the losses must be finite and fall; it prints the median step time,
   training clouds/s and a profile of one step; then one step from the
   same weights through the kernels and through the plain versions
   (same build, dropout 0), uniform and ragged: loss rtol 1e-3, running
   statistics 1e-3 x max, the updated parameters within a relative
   Frobenius deviation of 2e-2 over all tensors, and the kernels' bf16
   gradients no farther (x 1.25) from the f32 step's than the plain
   versions' (winner flips at bf16 near-ties move single entries; the
   gradients' deviations, all tensors, worst tensor and worst element,
   are printed beside the spread of two kernel steps);
9. serves 32 uniform and 8 ragged clouds (1200..2048 points, the last a
   full one) with normals and category ids through ``InferenceEngine``
   on ``DeltaNetSegmentation`` at the ShapeNet config (50 part classes,
   conv channels (64, 128, 256), MLP depth 2, k=30, the categorical
   head; seeded weights, randomized BatchNorm), in f32 (exact kNN) and
   at the production config (approximate kNN, bf16), counting launches
   per forward (in bf16 gather_mlp_max once, at the centralized conv0,
   mlp_rows and gather_max_merge once, at conv2), and checks the per-point
   logits: finite, of the right shapes, trimmed per cloud; f32 within
   atol 1e-3 of the plain path, bf16 within 0.01 x max|logit| of it and
   within 0.05 x max|logit| of the f32 engine, argmaxes equal where
   decisive; a full cloud the same ragged or uniform; it prints clouds/s,
   batch latency and a profile of one call; then ``[serve-seg-int8]``
   at ``precision="int8"``, held as bf16 is (densify_int8 and
   gather_max_int8 once, the MLP maxes as in bf16);
10. times the segmentation config's last conv in both forms: the
    wrapper's (``gather_mlp_max``: ``mlp_rows`` then ``gather_max_merge``)
    and the per-point chain (plain matmuls) followed by
    ``gather_max_affine``;
11. ``[serve-large-bf16]`` and ``[serve-large-f32]``: serves 8 uniform
    clouds of 8192 points and 3 ragged ones (5000..8192, the last a full
    one) through ``InferenceEngine(num_points=8192, batch_size=4)`` on the
    reference-width classifier with ``dense_operators=False`` (the JAX
    package's large-cloud coefficient-operator mode, approximate kNN), at
    ``precision="bfloat16"`` and None, counting launches (4 grad and 4
    div applies a forward, each on the route its width selects, the
    gather plan once, no dense assembly): the kernel path within
    0.01 x max|logit| of the plain path in bf16 (atol 1e-3 in f32), bf16
    within 0.05 x max|logit| of the f32 engine; it prints clouds/s and a
    profile of one call;
12. ``[coef-vs-dense]``: the same weights served with coefficient-form
    and dense operators, f32, B=32, N=1024, within atol 1e-3; then one
    forward's 8 applies in both forms, f32 and bf16, at N = 1024 to 8192
    (the coefficient form with its gather plan and the plan's build, the
    dense form with and without its assembly);
13. ``[train-large]``: trains the large-cloud config (``bench.py
    --mode=large-train``: bf16, coefficient form, approximate kNN, B=4,
    N=8192, SGD lr 0.01, smoothing 0.2, dropout 0.5 from a seeded CUDA
    generator) for 8 steps on one batch of class-conditioned ellipsoids:
    losses finite and falling, 4 + 4 applies (by route as in serving)
    and 6 ``scatter_rows`` a step, each with one ``inverse_adjacency``
    (one more for ``gather_sum_bwd``); it prints the median step time,
    training clouds/s, the peak memory and a profile of one step;
    then one step from the same weights through the kernels and through
    the plain versions (same build, dropout 0), uniform and ragged, held
    as step 8 holds the bf16 step (the parameters' deviation printed, not
    held: a 4-row head BatchNorm), and one step with only the applies on
    the plain route:
    loss and statistics equal, gradients within 2e-2 (the order of the
    scatters' sums: ``scatter_add_``'s atomics against the kernel's fixed
    edge order);
14. ``[kernels]`` at the point-shard shapes: knn_topk_table (exact and
    quantized) at Nq = Nt = 8192, K = 20 and 30, and its repair form
    (2048 row_ids against 65,536 columns), knn_topk_bucketed (exact and
    quantized) at N=65,536, K=20, on surface clouds, uniform, 10% masked
    and 100 units from the origin: ids equal to the plain versions, the
    exact winner sets equal to a chunked ``matmul`` + ``torch.topk``
    (near-tie rows exempt) or, far from the origin, to the exact table
    kNN, and the candidate sweep alone (its ids and scores) equal to its
    plain version; gather_rows and wls of the table-form operator build
    at the bench cloud's shapes; times beside the plain versions, the
    library calls and the bounds;
15. ``[serve-shard-bf16]``: ``InferenceEngine.predict_sharded`` of ONE
    65,536-point cloud at the bench config (``bench.py
    --mode=point-shard``: reference width, ``dense_operators=False``,
    bf16, approximate kNN) on one card: the quantized bucketed kNN once
    a forward and no table kNN, the kernel path within 0.01 x max|logit|
    of the plain path and within 0.05 x max|logit| of the f32 sharded
    engine; 60,000 real points padded to 65,536 with a point mask through
    ``point_sharded_classification`` against the 60,000-point cloud;
    points/s and a profile of one call; ``[serve-shard-f32]``: exact kNN
    (the exact bucketed kNN once a forward, the table kNN once more when
    rows fail its certificate; the branch printed), atol 1e-3 of the
    plain path;
16. ``[serve-shard-seg-f32]`` and ``[serve-shard-seg-bf16]``: the
    ShapeNet model in coefficient form on one 8192-point cloud with a
    category (the table kNN once a forward): f32 within 1e-4 x
    max|logit| of the unsharded forward on the same neighbour graph, on
    6 clouds, the table kNN's winner sets equal to ``matmul`` + ``topk``'s
    but at near-ties, the deviation from ``InferenceEngine.predict``
    printed; bf16 within 0.01 of the plain path; the device time of one
    call;
17. ``[shard-nccl]``: one bench forward through an initialised 1-rank
    ``nccl`` group (a FileStore in a temporary directory), bit-equal to
    ``group=None``;
18. ``[kernels]`` at the segmentation train shapes (B=16, N=2048, K=30,
    64 -> 64): ``edge_delta_mlp`` and its backward's two kernels, uniform
    and masked (``check_edge_mlp_kernels``): the forward within one bf16
    ulp of the plain version or within the f32 summation bound of the
    exact (f64) product, slot 0 bit-equal; phase 1
    (``edge_delta_mlp_bwd``) its edge tensor held the same way, its f64
    self rows, ``dw1`` and the affine's sums within 1e-5 x max, and on
    exact-sum inputs edge tensor and self rows bit-equal; phase 2
    (``edge_delta_mlp_bwd_sum``, over the inverse adjacency of the clamped
    indices) bit-equal to its plain version on the same edge tensor; the
    whole backward's ``dy`` within one bf16 ulp of the largest edge term
    (the f32 sums of ``dh`` in another order), bit-equal across two calls
    (f64 sums, rounded once, no float atomics) and, on exact-sum inputs,
    to the plain version; each kernel and the whole backward timed in
    device time and by CUDA events beside the plain version, the library
    calls (``index`` gather, ``torch.matmul``, ``index_add_``), the bound
    and the backward design's byte floor (``[times] edge MLP``);
19. ``[train-seg-bf16]``: trains ``DeltaNetSegmentation`` at the ShapeNet
    config at ``bench.py``'s seg train config (``bench.py:233-265``: B=16,
    N=2048, bf16, approximate kNN, ``sgd_momentum(0.01)``, smoothing 0,
    dropout 0.5 from a seeded CUDA generator; per-point part labels that
    follow the category and the point's octant) for 20 steps, once with
    ``_EDGE_FUSED_TRAIN`` off (the JAX default: the first conv's edge
    tensor) and once on (``edge_delta_mlp``): losses finite and falling,
    the edge MLP's three kernels once a step each with the switch on and
    never off;
    it prints the median ``seg_train_step_ms``, training clouds/s, peak
    memory and a profile of one step (its device time) for each branch;
    then one step from the same weights through the kernels and through
    the plain versions (same build, dropout 0), uniform and ragged, held
    as ``[train-bf16]`` holds the classification step, each branch; and
    the two branches against each other from the same weights: loss and
    running statistics within the JAX package's 5e-2 (rtol and atol);
20. ``[train-seg-f32]``: 3 f32 steps (exact kNN) timed, then one step
    from the same weights through the kernels and the plain versions
    (same build), uniform and ragged, held as step 7 holds the f32 step;
21. ``[kernels]`` of the operator build's backward and the fused eval
    build: wls_bwd (B=32, N=1024 and B=4, N=8192, K=20, uniform and
    masked; each of the 12 planes within 1e-4 x its max of autograd
    through the plain WLS math), coef_cotangent (the coefficients'
    cotangent of every apply, a sampled product) at the same shapes and
    graphs in both modes at one forward's apply widths (grad C = 3, 70,
    192, 256; div 6, 128, 256), each entry within one f32 ulp of the
    plain version or the f64 summation bound of the two f64 orders, a
    second call bit-equal, the grad mode read through the strides of a
    transposed cotangent bit-equal to its contiguous copy; ``[cotangent]``
    times it at every one of those widths and shapes (CUDA events, device
    time, bound) beside the parent's route for the same function (dense:
    ``torch.matmul`` of the ``[B, 2, N, N]`` operator cotangent, then
    densify_bwd; coefficient form: gather_rows + ``einsum``);
    densify_bwd (bit-equal to
    ``torch.gather``), fused_gather_wls through its split route (by
    shape) and its direct route (``fused_gather_wls_direct``, forced),
    also at B=16, N=2048, K=30 (each within 1e-5 x max of its plain
    version and of ``gather_rows`` + planes + ``wls``, unnormalized, a
    second call bit-equal, one launch of its route a call) and
    knn_topk's mean distances, both bodies (ids equal, distances
    bit-equal), each timed beside its bound and library call;
    ``[fused-routes]``: both routes of fused_gather_wls timed at B=32,
    N=1024, K=20 and B=16, N=2048, K=30 (CUDA events and device time,
    the plain version, the bound, the split route at every number of
    warps that holds K edges); ``[sum-routes]``: the streaming neighbour
    sum at B=4, N=8192 and B=32, N=1024, K=20, C=128, uniform and masked
    kNN graphs, through route S (by shape) and route D
    (``gather_sum_direct``, forced), each bit-equal to the plain version
    and to a second call with one launch of its route a call, timed by
    CUDA events and in device time beside the plain version, the library
    call (``index`` + ``sum``) and the bound, with every slice that
    fits;
22. ``[pos-grad]``: the reference classifier in f32 at B=32, N=1024, 32
    uniform clouds and 11 ragged, eval and train mode (dropout 0):
    ``pos.requires_grad_()``, ``normal.requires_grad_()``, the cross
    entropy of the logits and ``backward()``, through the kernels and
    through the plain versions: on the same build the loss within rtol
    1e-5 and ``pos.grad``, ``normal.grad`` within 1e-3 x max; through the
    plain build the loss held and the gradients' deviation printed (the
    ~1e-6 WLS difference flips neighbour-max winners at near-ties);
    gather_rows, wls_bwd, scatter_rows and inverse_adjacency once a
    forward + backward, coef_cotangent once an apply (8) and densify_bwd
    never: W carries no graph (the plain build
    only on the first batch and mode); the device and host time of forward
    + backward, the backward kernels' share and the peak memory;
23. ``[pos-grad-large]``: the same in coefficient form at B=4, N=8192
    with approximate kNN (gather_rows and wls_bwd once, coef_cotangent 8
    times, densify_bwd never); then ``[densify-vjp]``: ``ops.densify_coefs``
    differentiated alone (B=32, N=1024), densify_bwd once, bit-equal to its
    plain version;
24. ``[serve-fused-build]``: the production bf16 classifier served at
    B=32, N=1024 with its backbone's ``fused_eval_build`` on and off (a
    measurement of the backbone's route; the heads take no switch): the
    fused route through the kernels within 0.01 x max|logit| of the plain
    versions and of the unfused route, argmax equal where decisive;
    knn_topk_mean_dist, fused_gather_wls and densify_bf16 once a forward,
    gather_rows and wls never; the build's and one 32-cloud forward's
    device time on both routes and clouds/s of both;
25. ``[nbr-minmax]``: the neighbour min/max hooks of the operator object
    that the reference classifier builds (k=20, dense f32) for 32 uniform
    clouds of 1024 points and 11 ragged ones: ``gd.nbr_minmax`` at C =
    64, 128, 256 in f32 and 64, 128 in bf16, its gradient at C=256 (f32
    and bf16, cotangents on every row, rows with no valid neighbour
    included), ``gd.nbr_matmul_minmax`` at 128 -> 256, through the
    kernels and the plain versions on the same build (forwards bit-equal,
    the f32 gradient within 1e-5 x max, the bf16 one with integer
    cotangents bit-equal, the matmul form held as in step 3), one launch
    of gather_minmax a call without grad, of gather_minmax_win and
    gather_minmax_bwd each with grad, of gather_matmul_minmax a matmul
    call (the _bf16 bodies for bf16); then the sharded forms
    (``ShardedGradDiv``) on a 1-rank ``nccl`` group against the hooks;
26. ``[knn-rounds]``: ``geometry.knn`` with 80 neighbours (more than the
    selection kernel's 64) on 4 clouds of 1024 points: one launch of
    ``knn_topk_rounds`` and none of ``knn_topk``, ids equal to the plain
    version;
27. ``[matmul-max-kfold]``: one cloud of 10,200 points (above the
    one-product-a-row kernels' 10,038 at C_in = 128 in bf16 and 10,166 in
    int8): gather_matmul_max with the epilogue, gather_matmul_max_train
    forward and backward, gather_matmul_max_int8 and gather_matmul_minmax
    launch ``gather_matmul_max_kfold``, ``gather_matmul_max_win_kfold``,
    ``gather_matmul_max_int8_kfold`` and ``gather_matmul_minmax_kfold``
    once each, exact sums bit-equal to the plain versions;
28. ``[max-direct]``: one cloud of 14,600 points (above route S's
    14,526 and the backward's 14,528): ``ops.gather_max`` on f32 and bf16
    features, without and with grad, ``ops.gather_minmax`` without and
    with grad and ``ops.gather_max_int8`` launch each body's route D
    kernels once and route S never, ``ops.gather_max_affine`` (bf16,
    with and without the self row) ``gather_max_affine_direct`` twice
    and ``ops.gather_sum`` (f32, without and with grad: the streaming
    route) ``gather_sum_direct`` twice, forward and backward bit-equal to
    the plain versions;
29. ``[wls-direct]``: 4 clouds of 1024 points with 48 neighbours (above
    the WLS split route's 40): ``ops.wls`` on planes that require grad
    and its backward launch ``wls_direct`` and ``wls_bwd_direct`` once
    each and the split kernels never, within 1e-5 and 1e-4 x each
    plane's max of the plain versions, and ``ops.fused_gather_wls`` at
    the same K ``fused_gather_wls_direct`` once (within 1e-5 x max);
    every model path above launched none of these direct routes, nor
    ``gather_sum_direct`` (the large-cloud step ``gather_sum`` once a
    step);
30. ``[knn-k10]`` (run right after the first ``[kernels]`` group): the
    normal graph of clouds without normals, K=10: knn_topk at B=32,
    N=1024 (packed and exact, ellipsoids and a tie-heavy grid),
    knn_topk_table at Nq = Nt = 8192 and knn_topk_bucketed at N=65,536
    (exact and quantized, uniform and 10% masked): ids equal to the
    plain versions, the exact bodies' winner sets equal to ``matmul`` +
    ``topk``'s but at near-ties; each timed beside its plain version,
    library call and bound (the bucketed kNN by its candidate sweep, and
    the whole call);
31. ``[fps]``: the port's geodesic FPS library built by ``g++`` from
    ``deltaconv_tpu_torch/cpp`` at first use, and ``GeodesicFPS(1024)``
    (the ScanObjectNN recipe's pre-transform) of one 2048-point cloud:
    1024 distinct points, normals subsampled with them, the same samples
    from the same seed;
32. ``[serve-no-normals]`` and ``[serve-no-normals-bf16]``: the
    ScanObjectNN recipe's classifier (15 classes, conv channels (64, 64,
    64, 128), k=20, lambda 0.01; seeded weights, randomized BatchNorm) on
    64 uniform and 11 ragged clouds WITHOUT normals (frames estimated on
    a 10-NN graph), f32 with exact kNN and bf16 with approximate kNN:
    f32 within atol 1e-3 of the plain path with the argmax equal, bf16
    within 0.01 x max|logit| of it, a full cloud the same ragged or
    uniform, wls once a forward, knn_topk twice a uniform bf16 forward;
    clouds/s, one 32-cloud forward's device time with estimated and with
    given normals, and (f32) the frames alone: device time, device
    launches and host time of a call;
33. ``[vote]``: ``predict_voting``, 3 votes of the default augmentation
    on 32 clouds without normals (the recipe's f32 model), through the
    kernels and the plain versions from one seed: within 3 x 1e-3 and the
    argmax equal, different from 3 single passes; ms a vote;
34. ``[train-no-normals]``: 3 f32 SGD steps of the recipe at B=32,
    N=1024 on batches without normals, uniform and ragged, kernels
    against plain versions from the same weights, held as step 7 holds
    one step (loss, gradients, parameters and statistics on the same
    build; loss and statistics through the plain build, one step);
35. ``[shard-no-normals]``: ``predict_sharded`` of ONE 65,536-point
    cloud without normals at ``[serve-shard-bf16]``'s config: the
    quantized bucketed kNN twice a forward, no table kNN, the kernel path
    within 0.01 x max|logit| of the plain path and within 0.05 of the f32
    sharded engine; host ms a call beside the cloud with its normals;
36. ``[knn-ties]``: the exact kNN's selection (XLA ``top_k``'s answer:
    equal scores lowest index first) at B=32, N=1024, K = 20 and 10 on
    square planar grids, a 9^3 grid with duplicates (both also 10%
    masked) and ellipsoids: ids bit-equal to numpy's stable ``argsort``
    of the card's own scores, copied to the host, and across two calls;
    the route timed beside the parent's ``matmul`` + ``torch.topk``, the
    selection beside ``torch.topk`` and ``torch.topk`` of unique int64
    keys;
37. ``[fit-scanobjectnn]``: ``deltaconv_tpu_torch.experiments.
    train_scanobjectnn.main`` on the card at the recipe's full width
    (15 classes, (64, 64, 64, 128), k=20, lambda 0.01), B=32, N=1024 and
    the CLI defaults (bf16 dense operators under the f32 conv stack,
    exact kNN), on a fixture it writes (64 train and 32 test clouds of
    2048 points: the h5 files where ``h5py`` is installed, else the
    processed cache that the reader writes from them, the recipe's
    geodesic FPS run by the phase): the datasets' builds timed,
    2 epochs (4 steps): gather_rows, wls, densify_bf16, gather_max_win,
    gather_max_bwd and the edge sum's adjacency or gather_sum launched,
    the median host ms of a step (synchronised) beside one step's device
    time; the checkpoint's bytes, its save and restore ms, restored
    bit-equal; 1 epoch, then ``--resume`` to 2 in further ``main`` calls:
    parameters, running statistics, optimizer state, lr and step
    bit-equal to the uninterrupted run, the test accuracy equal;
    ``InferenceEngine.from_checkpoint`` of the run's checkpoints and
    ``warmup``: the warmup's seconds and the first ``predict``'s ms, the
    logits on the 32 test clouds with the eval step's argmax and within
    1e-4 x max|logit| of it;
38. ``[fit-modelnet]``: the same through ``train_modelnet.main`` at the
    reference classification config (40 classes, (64, 64, 128, 256),
    k=20, normals from ``SamplePoints``) on a ModelNet tree of OFF meshes
    it writes (64 train and 32 test closed meshes: icospheres, boxes and
    capped cylinders, stretched and rotated; NormalizeScale,
    SamplePoints(8192), GeodesicFPS(1024) once a mesh);
39. ``[fit-shrec]``: the same through ``train_shrec.main`` at the SHREC
    recipe (30 classes, (32, 32, 32, 32), k=20, B=16, N=2048, 100-epoch
    cosine cut to 2 epochs) on a SHREC zip of OBJ meshes it writes (4
    classes of 12 training meshes, 10 kept by the split, and 2 test
    meshes; NormalizeScale, SamplePoints(16384), GeodesicFPS(2048)), 2
    steps of 16 an epoch; no fresh-process serve;
40. ``[fit-shapenet]``: the same through ``train_shapenet.main`` at the
    ShapeNet recipe (DeltaNetSegmentation, (64, 128, 256), depth 2,
    embedding 1024, the categorical head, k=30, B=16, N=2048, no
    smoothing, per-point steps; the instance mIoU each epoch) on a
    ShapeNet tree it writes (36 trainval and 16 test clouds of 2600
    points with normals over Airplane, Bag and Cap, their part labels;
    NormalizeScale, GeodesicFPS(2048)); gather_rows, wls, densify_bf16,
    gather_max_win and gather_max_bwd launched; the served checkpoint
    with the test clouds' categories held per point (every point's
    argmax); then ``[vote-shapenet]``: ``test_shapenet.main`` on the
    run's checkpoints with ``--num_votes 3``, twice: the same mIoU and
    per-category IoUs, equal to ``evaluate_voting``'s on the restored
    weights, the host ms of a call;
41. ``[fit-shapeseg]``: ``train_shapeseg.main`` at the ShapeSeg recipe
    (8 classes, (128,) x 8, depth 1, embedding 512, Adam with StepLR,
    B=8, N=1024, k=20) on the composite ShapeSeg zip it writes (the
    loader's fixed counts: 214 training meshes, cut 90/10, and 18 test
    meshes; icospheres labelled by octant; NormalizeArea, NormalizeAxes,
    SamplePoints(8192, labels), GeodesicFPS(1024)), 2 epochs of 24 steps
    with a validation and a test pass each: the classifiers' kernels
    launched, host ms a step beside its device time; the best
    validation epoch's state saved as step 0 and restored bit-equal to
    it, its evaluate-only run repeating that epoch's test accuracy;
42. ``[geometry-single]``: at one cloud of N=1024 and one of N=8192
    points (K=20) on a quadratic height field, ``geometry.build_grad_div``
    through ``gather_rows`` and ``wls`` (once each) against the torch math
    on the card, ``normalized`` True and False, within 1e-4 x max|coef|,
    both timed; the de Rham checks of ``tests/geometry/test_grad_div.py``
    on the kernels' operators (N=1024); ``DeltaConv`` of one cloud (f32
    and bf16, eval and train) bit-equal to the batch of one; then
    ``geometry.knn_tiled`` of one 65,536-point cloud (K=20, tiles of
    2048) against ``knn_topk``'s exact body, row-wise sets equal or
    parted only at near-ties, both timed;
43. ``[dp-step]``: the reference ModelNet40 train step (B=32, N=1024,
    K=20, (64, 64, 128, 256), SGD lr 0.1, momentum 0.9, weight decay
    1e-4, smoothing 0.2, dropout 0.5), f32 (exact kNN) and bf16 (bf16
    compute and operators, approximate kNN), data-parallel: (a)
    ``parallel.shard_train_step`` on a 1-rank ``nccl`` group bit-equal to
    ``make_train_step`` over 2 steps with the same generator (a group of
    one rank is None in the port: the one-process step twice, so this
    shows it deterministic; no NCCL collective runs); (b) 2 processes
    sharing the card over ``gloo`` (``parallel.launch.run_ranks``), 16
    clouds a rank, against the one-process step: the ranks bit-equal;
    the loss within rtol 1e-5 (f32) or 1e-3 (bf16), or twice the spread
    of the controls where that is larger; parameters and running
    statistics by ``held_update`` (their distance from the one-process
    step over its move within 1e-2, or twice the largest of 3 controls,
    and never above 0.25; a control is the one-process step on the
    batch's clouds in another order, each dropout mask permuted with
    them: the same function, its sums in another order); the tensors
    holding most of the distance and the entries beyond JAX's
    data-parallel bounds (atol 1e-5 + rtol 1e-4) printed, not held;
    each rank's launches a step (counted from 0 over 3 steps), device
    and host ms a step;
44. ``[shard-train]``: ``parallel.point_sharded_train_step`` at the bench
    config (ONE 65,536-point cloud, reference width, coefficient
    operators, bf16, approximate kNN, SGD 0.01) on a 1-rank ``nccl``
    group: two calls from the same state bit-equal; the f32 form within
    1e-3 (parameters) and 1e-4 (statistics) x max of the unsharded f32
    step on the same graph and operators; the launches, device ms, host
    ms, points/s and peak memory of a step on one rank; then the
    ShapeNet recipe on one 8192-point cloud (f32, exact kNN, dropout
    0.5) on the 2 gloo ranks against its one-process sharded step: the
    ranks bit-equal, the one-process step twice bit-equal, the loss
    within rtol 1e-5 (or twice the controls' spread), the state by
    ``held_update`` with controls on the cloud's points in another
    order, each dropout mask permuted with them; each rank's launches
    and host ms a step;
45. ``[fit-dp]``: ``train_modelnet.main`` for 2 epochs on a written
    ModelNet fixture on the 2 gloo ranks (data parallelism, the CLI's
    defaults, under the group) against the one-process run
    (``--no_data_parallel``): final parameters by ``held_update``
    (controls: the one-process run on every cloud's points in another
    order; exact kNN, so the graphs do not move), the ranks bit-equal,
    rank 0 alone writing checkpoints, 1 epoch then ``--resume`` to 2
    bit-equal to the uninterrupted run;
46. ``[pos-grad-bf16]``: the production classifier (bf16 compute and
    operators, approximate kNN, reference width, dropout 0) in train
    mode at B=32, N=1024, K=20: ``pos`` and ``normal`` require grad, the
    cross entropy, ``backward()``; launches a backward exact
    (``coef_cotangent`` 8, ``wls_bwd`` 1, ``densify_bwd`` 0) and every
    kernel of the path launched; the kernels' gradients bit-equal across
    two calls; against the plain versions on the same build: the loss
    within 1e-3, each gradient within 0.2 by its relative Frobenius
    deviation and its distance to the f32 gradient (the same weights
    through the kernels) within 1.25x the plain versions'; bf16 and f32
    forward + backward in host time, device time and peak memory, and
    the backward's kernels' share (profiler);
47. ``[pos-grad-bf16-large]``: the same in coefficient form at B=4,
    N=8192 (the gather plan's kernels once a forward);
48. ``[features]``: that classifier with ``in_channels=6`` on positions
    and normals, and with ``centralize_first=False``, f32 and bf16: an
    eval forward and 3 ``make_train_step`` steps through the kernels,
    each step also taken from the same weights and optimizer state
    through the plain versions, held as ``[train]`` and ``[train-bf16]``
    hold theirs; each variant's launches;
49. ``[aggr]``: one train-mode ``DeltaConv`` 64 -> 64 at B=32, N=1024,
    K=20, ``aggr`` "mean" and "sum", centralized and not, f32 and bf16:
    the forward bit-equal to the plain versions, the parameters' and
    inputs' gradients within 1e-4 x max (f32) or 1e-2 by relative
    Frobenius deviation (bf16), launches, the forward's device time;
50. ``[study]``: the anisotropic-diffusion study at the notebook's
    settings (20 Perona-Malik steps of a 128 x 128 image, 200 Adam
    iterations, width 16, 16 layers): each network's final L1;
51. ``[convergence]``: ``synthetic_convergence`` at its defaults: the
    training loss falls, the held-out accuracy beats chance;
52. ``[rehearsal]``: the offline rehearsal (a ModelNet10 ``.pt``
    evaluated by ``train_modelnet``, ShapeNet's 2-vote evaluation);
53. with ``--parent DIR`` (another checkout's root, e.g. the parent
    commit unpacked by ``git archive``): ``[coef-applies]`` (one
    forward's eight applies at B=4, N=8192 in device time, with the
    gather plan's build where the package has one), ``[kernel-times]``
    (``ops.gather_max_affine`` and ``ops.densify_coefs_int8`` at their
    model shapes in device time and by CUDA events, with their bounds and
    at the record shapes the plain and library device times;
    ``ops.gather_max_int8`` and ``ops.gather_max_bwd`` at their model
    shapes in device time; ``ops.wls`` at the three forwards' shapes and
    ``ops.wls_bwd`` at the two backwards', in device time and by events,
    with their bounds and the plain versions' device time;
    ``ops.gather_sum_fwd`` at C=128 (B=32, N=1024; B=4, N=8192) and
    ``ops.fused_gather_wls`` (B=32, N=1024, K=20; B=16, N=2048, K=30) in
    device time and by events, with their bounds; ``ops.gather_rows`` at
    the build's [B, 9, K, N] (B=32, N=1024; B=16, N=2048, K=30; B=4,
    N=8192), seg conv0's C=3 and a 4-rank shard's 16,384 rows against the
    65,536-point table, in device time and by events, with their bounds;
    ``ops.gather_minmax`` and ``ops.gather_minmax_win`` at f32 C=256 and
    bf16 C=128 and ``ops.gather_matmul_minmax`` at 128 -> 256, B=32,
    N=1024 and B=4, N=8192, in device time and by events, with their
    bounds) and ``[device-times]`` (with the peak memory of the positions'
    forward + backward) on that checkout's
    package (this script copied
    into its root) and on this tree, in turns: parent, this, this,
    parent, each a process of its own (``--phase compare``).

Any failed phase raises (non-zero exit). The last three lines are a JSON
record of the kernels, the ``nvidia-smi`` line and ``{"ok": true,
"device": ...}``. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from copy import deepcopy
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import deltaconv_tpu_torch  # noqa: E402,F401  (fails here without a checkout)

B, N, K = 32, 1024, 20
NUM_CLASSES = 40
WIDTHS = (64, 128, 256)
BF16_WIDTHS = (64, 128)  # gather_max_affine: conv0/conv1, conv2
MM_IN, MM_OUT = 128, 256  # gather_matmul_max: conv3
TRAIN_BF16_WIDTHS = (64, 128)  # gather_max_win_bf16: conv0/conv1, conv2
BWD_BF16_WIDTHS = (64, 128, 256)  # gather_max_bwd_bf16, conv3 included
KNN_BIG_N = 8200  # knn_topk just above its 8192-point staging tile
# knn_topk at the model shapes (B, N, K): classification, segmentation,
# large clouds; the larger ones timed over fewer samples (the plain exact
# version sweeps a [4, 8192, 8192] score plane K times).
KNN_SHAPES = ((32, 1024, 20), (16, 2048, 30), (4, 8192, 20))
KNN_BIG_REPS = 5
KNN_ROUNDS_K = 80  # above the selection kernel's 64: knn_topk_rounds
KNN_ROUNDS_SHAPES = ((4, 1024), (1, 1500))  # (B, N) of its checks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, an FMA as 2
BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
F64_OPS_PER_S = 34e12  # f64 outside the tensor cores (data sheet), FMA as 2
# Thread instructions issued per second: 4 schedulers x 32 lanes per SM,
# the same 128 lanes x 132 SMs x clock that gives 67 TFLOP/s as FMAs.
# Any instruction (f32 add, integer, compare-select) takes one slot.
ISSUE_PER_S = F32_OPS_PER_S / 2
# knn_topk's work per (query, point) pair that the function needs:
# the score 2 (q.p) - |p|^2 (3 mul, 2 add, x2, sub), the row's min and
# max, the quantization (sub, mul, convert), the key (sub, shift, or)
# and one compare of a single selection pass over the row. INT32 issues
# at half the f32 rate and conversions at an eighth, 4 and 1 a pair: 8
# slots each, below the 16 issued.
KNN_INSTR_PER_PAIR = 7 + 2 + 3 + 3 + 1
BF16_REL = 0.05  # the JAX package's bf16 serving bound, x max|logit|
BF16_PATH_REL = 0.01  # bf16 kernel vs plain path, x max|logit|
REPS = 30
INNER = 5  # calls per timed sample
SPIN_CYCLES = 2_000_000  # ~1 ms: the spin kernel that opens a traced window
PROFILE_CALLS = 2  # calls of a profiled function in one traced window
TRACE_TRIES = 6  # traces of device_ms before a trace with no kernel fails
TRACE_PAUSE_S = 1.0  # between two such traces
LOGIT_ATOL = 1e-3
WLS_ATOL = 1e-5  # FMA contraction and K-sum order
DENSIFY_ATOL = 1e-6  # duplicate columns may sum in another order
SCATTER_RTOL = 1e-5  # x max|dh|: f32 sums in another order (atomics)
TRAIN_LR = 0.1  # 100 x the reference base lr 0.001
TRAIN_STEPS = 20
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-3  # x the tensor's max: gradients and updated parameters
STATS_RTOL = 1e-4  # x max: running statistics
BF16_LOSS_RTOL = 1e-3  # bf16 step, kernels vs plain
BF16_STATS_RTOL = 1e-3  # x max
BF16_PARAM_FROB = 2e-2  # relative Frobenius, all parameters at once
BF16_F32_RATIO = 1.25  # gradients' distance to the f32 step, kernels/plain
MM_WIN_FRAC = 1e-4  # gather_matmul_max_win: share of 1-ulp values, flips
# The bf16 matmul maxes at conv3 of both models that run them: (B, N) of
# classification and of the large clouds (K=20, MM_IN -> MM_OUT); their
# one-product-a-row kernels take one cloud of up to 10,038 points at
# C_in = 128 (ops.gather_matmul_max.mm_slice), the K-fold route above.
MM_SHAPES = ((32, 1024), (4, 8192))
# [matmul-max-kfold]: one cloud above that limit, and above the int8
# form's 10,166.
MM_KFOLD_N = 10200
PATH_WARMUP = 5  # [device-times]: calls before each traced one
# Segmentation serving: the ShapeNet config (experiments/train_shapenet.py,
# bench.py's seg mode): B=16 clouds of N=2048 points, k=30, conv channels
# (64, 128, 256), MLP depth 2, 50 part classes, the categorical head.
SEG_B, SEG_N, SEG_K = 16, 2048, 30
SEG_CLASSES = 50
SEG_UNIFORM, SEG_RAGGED = 32, 7  # clouds: 2 uniform batches, 1 ragged
SEG_MAX_WIDTH = 128  # gather_max_bf16: conv1's MLP output
# gather_mlp_max at conv0 and conv2: (C_in, C_out, centralized)
MLP_CASES = {"conv0": (3, 64, True), "conv2": (128, 256, False)}
MLP_FRAC = 1e-2  # share of best values that may differ from the plain
MLP_REL = 1e-2  # x max|best|: a one-ulp product through the next layer
# int8 serving (bench.py --mode=int8 and --mode=seg-int8): bf16 compute on
# int8 operators; the int8 max at conv0-2 (classification, C = 64, 64,
# 128) and conv1 (segmentation, C = 128), the int8 matmul max at conv3.
INT8_WIDTHS = (64, 128)
# One classification forward's operator applies, (grad widths, div
# widths) at conv channels (64, 64, 128, 256): grad of the positions, then
# of [div v, curl v, x'] (2 C_in + C_out) at conv0-2; div of [v, Jv]
# (2 C_in) at conv0-3.
APPLY_WIDTHS = ((3, 70, 192, 256), (6, 128, 128, 256))
# The large-cloud coefficient-operator configuration (bench.py
# --mode=large-train, bench.py:295-345): the reference width with
# dense_operators=False, bf16 compute, approximate kNN, B=4 clouds of
# N=8192 points, SGD lr 0.01 (sgd_momentum's defaults), smoothing 0.2.
LARGE_B, LARGE_N = 4, 8192
LARGE_LR = 0.01
LARGE_STEPS = 8
LARGE_UNIFORM, LARGE_RAGGED = 8, 3  # served clouds: 2 uniform batches, 1
LARGE_MIN_POINTS = 5000  # the ragged clouds' smallest size
COEF_DIV_WIDTHS = (6, 128, 256)  # coef_apply_div checked at conv0, 1-2, 3
COEF_ODD_C = 301  # and both applies at an odd width (bf16 without pairs)
# The planned route (coef_apply_*_plan) takes rows of a multiple of 16
# bytes and at least this many (ops.coef_apply._PLAN_MIN_ROW_BYTES).
COEF_PLAN_MIN_ROW_BYTES = 256
# scatter_rows checked at the grads' 70 (conv0) and 256 (conv2, and the
# divs' 2 x 128 at conv1-2) and the last div's 512 (conv3).
SCATTER_WIDTHS = (70, 256, 512)
# The operator build's gather VJP scatters component-major [B, 9, K, N]
# rows (pos, x basis, y basis) at B=32, N=1024.
SCATTER_NARROW_C = 9
# Launches on the coefficient-form path: a forward applies 4 grads (the
# positions', conv0-2) and 4 divs (conv0-3); a train step's backward
# scatters the cotangents of the 3 grads and 3 divs whose features
# require grad (not the positions' grad, nor conv0's div of it), each
# after its inverse adjacency, and the neighbour sum's gather_sum_bwd
# takes one more inverse adjacency.
# By route, in f32 and bf16 alike: the grads at C = 3 and 70 and the div
# at 6 take route A, the grads at 192 and 256 and the divs at 128, 128
# and 256 the planned route; the gather plan is built once a forward.
COEF_PER_FORWARD = {"coef_apply_grad": 2, "coef_apply_grad_plan": 2,
                    "coef_apply_div": 1, "coef_apply_div_plan": 3,
                    "coef_plan_order": 1, "coef_plan_runs": 1}
APPLIES_PER_FORWARD = {"coef_apply_grad": 4, "coef_apply_div": 4}
SCATTERS_PER_STEP = 6
# Kernels vs plain applies in one large-cloud step: the gradients'
# relative Frobenius deviation over all tensors (sum order only: the plain
# scatter_add_ adds with atomics in any order).
COEF_GRAD_FROB = 2e-2
# coef-vs-dense: (B, N) of the timed forwards' applies.
CROSSOVER = ((32, 1024), (4, 1024), (4, 2048), (4, 4096), (4, 8192))
CROSSOVER_REPS = 10
# The neighbour max at every shape where the model paths run it: (label,
# B, N, K, dtype, widths, winners): f32 classification forward (conv0-3)
# and step, the bf16 classification step (conv0-2), bf16 segmentation
# serving (conv1), the large-cloud f32 forward (through GradDiv.nbr_max)
# and the large-cloud bf16 step.
MAX_ROUTE_SHAPES = (
    ("f32 cls forward", B, N, K, torch.float32, WIDTHS, False),
    ("f32 cls step", B, N, K, torch.float32, WIDTHS, True),
    ("bf16 cls step", B, N, K, torch.bfloat16, TRAIN_BF16_WIDTHS, True),
    ("bf16 seg forward", SEG_B, SEG_N, SEG_K, torch.bfloat16,
     (SEG_MAX_WIDTH,), False),
    ("large f32 forward", LARGE_B, LARGE_N, K, torch.float32, WIDTHS,
     False),
    ("large bf16 step", LARGE_B, LARGE_N, K, torch.bfloat16,
     TRAIN_BF16_WIDTHS, True))
# (B, N, K, C) of each body's record (route S's and route D's).
MAX_RECORD = {"gather_max": (B, N, K, 256), "gather_max_win": (B, N, K, 256),
              "gather_max_win_bf16": (B, N, K, 128),
              "gather_max_bf16": (SEG_B, SEG_N, SEG_K, SEG_MAX_WIDTH)}
# The winner-routed backward at every shape where the model paths run it:
# (label, B, N, K, cotangent dtype, widths): the f32 classification step
# (conv0-3), the bf16 classification step (conv0-2, and conv3's train
# matmul max), the large-cloud bf16 step and the large-cloud f32
# backward of the positions' gradients.
BWD_ROUTE_SHAPES = (
    ("f32 cls step", B, N, K, torch.float32, WIDTHS),
    ("bf16 cls step", B, N, K, torch.bfloat16, BWD_BF16_WIDTHS),
    ("large bf16 step", LARGE_B, LARGE_N, K, torch.bfloat16,
     BWD_BF16_WIDTHS),
    ("large f32 backward", LARGE_B, LARGE_N, K, torch.float32, WIDTHS))
# The int8 max at the int8 forwards' shapes, bf16 features: classification
# conv0-2 and segmentation conv1.
INT8_ROUTE_SHAPES = (("int8 cls forward", B, N, K, INT8_WIDTHS),
                     ("int8 seg forward", SEG_B, SEG_N, SEG_K,
                      (SEG_MAX_WIDTH,)))
# The bf16 eval max (gather_max_affine) where the model paths run it:
# (label, B, N, K) of the bf16 classification forward and the large-cloud
# bf16 forward, and (C, sub_self) of conv0 (the self row subtracted),
# conv1 and conv2.
AFFINE_SHAPES = (("bf16 cls forward", B, N, K),
                 ("large bf16 forward", LARGE_B, LARGE_N, K))
AFFINE_WIDTHS = ((64, True), (64, False), (128, False))
# [max-direct]: one cloud above route S's 14,526 points (and above the
# backward's route S: more than four ranges of rows).
MAX_DIRECT_N = 14600
MAX_DIRECT_KERNELS = ("gather_max_direct", "gather_max_win_direct",
                      "gather_max_bf16_direct", "gather_max_win_bf16_direct",
                      "gather_minmax_direct", "gather_minmax_bf16_direct",
                      "gather_minmax_win_direct",
                      "gather_minmax_win_bf16_direct",
                      "gather_max_bwd_direct", "gather_max_bwd_bf16_direct",
                      "gather_minmax_bwd_direct",
                      "gather_minmax_bwd_bf16_direct",
                      "gather_max_int8_direct", "gather_max_affine_direct",
                      "gather_sum_direct")
# The WLS kernels where the model paths run them: #3 (wls) at the
# classification, segmentation and large-cloud forwards, #4 (wls_bwd) at
# the two backwards in the positions; [wls-direct]: K above the split
# route's 40 edges, on WLS_DIRECT_B clouds of N points.
WLS_SHAPES = (("cls", B, N, K), ("seg", SEG_B, SEG_N, SEG_K),
              ("large", LARGE_B, LARGE_N, K))
WLS_BWD_SHAPES = ((B, N, K), (LARGE_B, LARGE_N, K))
WLS_DIRECT_K = 48
WLS_DIRECT_B = 4
# The streaming neighbour sum (#19) where it runs: the large-cloud step's
# [y, y^2] table of conv0 (B=4, N=8192, C = 2 x 64) on every large step,
# and the classification shape (its train step's streaming route with the
# adjacency budget at 0); [sum-routes] holds and times both routes there.
SUM_SHAPES = (("large step", LARGE_B, LARGE_N, K), ("cls", B, N, K))
SUM_C = 128
# The fused eval build (#26) at the classification forward's K=20 and the
# segmentation shape's K=30: (label, B, N, K) of its route checks and times.
FUSED_SHAPES = (("cls", B, N, K), ("seg", SEG_B, SEG_N, SEG_K))

# Point-sharded serving of ONE large cloud (bench.py --mode=point-shard,
# bench.py:351-407): 65,536 points, the reference-width classifier in
# coefficient form (dense_operators=False), bf16 and approximate kNN, on
# one card (a group of one rank); the ShapeNet model on one 8192-point
# cloud (the table kNN's range, 4,097..16,383 points).
SHARD_N = 65536
SHARD_TABLE_N = SHARD_SEG_N = 8192
SHARD_REPAIR_ROWS = 2048  # knn_topk_bucketed's repair budget
SHARD_PAD_N = 60000  # the padded run's real points
SHARD_SHIFT = 100.0  # the far cloud's distance from the origin
SHARD_MASK_FRAC = 0.1  # masked share of the masked clouds
SHARD_CALLS = 3  # timed forwards
SHARD_REPS = 5  # CUDA-event samples of the point-shard kernels
SHARD_TIE_REL = 1e-6  # x (1 + |q|^2): near-tie K-th scores
SHARD_SEG_REL = 1e-4  # f32 sharded vs unsharded on one graph, x max|logit|
SHARD_SEG_CLOUDS = 6  # clouds of that check
# The exact sweeps' work per (query, column) pair: the score (mul, 2 fma,
# mul, 2 sub) and one compare-select; the quantized ones do
# KNN_INSTR_PER_PAIR.
TABLE_INSTR = 8
SHARD_BF16_KERNELS = ("knn_topk_bucketed_q", "gather_rows", "wls")
SHARD_F32_KERNELS = ("knn_topk_bucketed", "gather_rows", "wls")

# Segmentation training (bench.py:233-265, the `seg_train_step_ms` config):
# the ShapeNet model at B=16, N=2048, K=30, bf16 compute and operators,
# approximate kNN, sgd_momentum(0.01), smoothing 0; the edge MLP of the
# first conv (3 -> 64 -> 64) at C0 = C1 = 64.
SEG_LR = 0.01
SEG_TRAIN_STEPS = 20
SEG_F32_STEPS = 3
EDGE_C = 64
BRANCH_TOL = 5e-2  # fused vs reference conv0, the JAX package's bound
SEG_TRAIN_KERNELS = ("knn_topk", "gather_rows", "wls", "densify_bf16",
                     "adjacency", "gather_max_win_bf16",
                     "gather_max_bwd_bf16", "edge_delta_mlp",
                     "edge_delta_mlp_bwd", "edge_delta_mlp_bwd_sum",
                     "inverse_adjacency")
# The fused branch's edge MLP kernels: each once a step with the switch on.
EDGE_STEP_KERNELS = ("edge_delta_mlp", "edge_delta_mlp_bwd",
                     "edge_delta_mlp_bwd_sum")
SEG_TRAIN_REF_KERNELS = ("knn_topk", "gather_rows", "wls", "densify_bf16",
                         "gather_max_win_bf16", "gather_max_bwd_bf16")
SEG_TRAIN_F32_KERNELS = ("gather_rows", "wls", "densify", "gather_max_win",
                         "gather_max_bwd")

# Gradients for positions and normals (the operator build's backward,
# wls_bwd and densify_bwd) and the fused eval build (fused_gather_wls,
# knn_topk's mean distances).
WLS_BWD_REL = 1e-4  # x each plane's max: the same VJP in another order
FUSED_REL = 1e-5  # x max: FMA contraction and the K sums' order
POS_GRAD_REL = 1e-3  # x max: pos.grad and normal.grad, kernels vs plain
FUSED_PATH_REL = 1e-2  # x max|logit|: fused vs unfused, kernels vs plain
POS_GRAD_RAGGED = 11  # ragged clouds of the [pos-grad] phase
POS_GRAD_CALLS = 5  # timed forward + backward calls
# f32 operations per edge (an FMA as 2), counted from wls_body.cuh: the
# fit (weights 8, normal equations 66, solve and height sums 70, the
# frame and div row 36) and its VJP (the fit again, then the four reverse
# passes: ~100, ~170, ~160 and ~12).
WLS_FLOPS_PER_EDGE = 180
WLS_BWD_FLOPS_PER_EDGE = 580
# Launches on the paths of this slice: one backward through the dense f32
# build (the gather's VJP scatter_rows once), the coefficient form's (no
# assembly: no densify_bwd; its forward's applies by route and the
# gather plan as in serving), one forward of the fused eval build.
# Every apply, dense or coefficient form, gives its coefficients their
# cotangent by coef_cotangent (4 grads and 4 divs a forward); the dense
# assembly's own VJP, densify_bwd, runs on no model path.
APPLIES_PER_BACKWARD = {"coef_cotangent": 8, "densify_bwd": 0,
                        "gather_rows": 1}
POS_GRAD_PER_BACKWARD = {"wls_bwd": 1, "wls_bwd_direct": 0,
                         "scatter_rows": 1, "inverse_adjacency": 1,
                         **APPLIES_PER_BACKWARD}
POS_GRAD_LARGE_PER_BACKWARD = {"wls_bwd": 1, "wls_bwd_direct": 0,
                               **APPLIES_PER_BACKWARD, **COEF_PER_FORWARD}
# coef_cotangent's record: its mode and width, on the dense shape.
COT_RECORD = ("grad", 256)
# gather_rows (#1) under --parent: (label, B, N, Nt, K, C), the model
# paths' shapes: the operator build's [B, 9, K, N] at the classification,
# segmentation and large-cloud shapes, seg conv0's edge tensor at C=3,
# and a 4-rank shard's rows against the 65,536-point table.
ROWS_SHAPES = (("cls build", B, N, N, K, 9),
               ("seg build", SEG_B, SEG_N, SEG_N, SEG_K, 9),
               ("seg conv0", SEG_B, SEG_N, SEG_N, SEG_K, 3),
               ("large build", LARGE_B, LARGE_N, LARGE_N, K, 9),
               ("shard table", 1, SHARD_N // 4, SHARD_N, K, 9))
MINMAX_C = 256  # gather_minmax (f32), its backward (f32 and bf16)
MINMAX_BF16_C = 128  # the bf16 forward bodies
MINMAX_WIDTHS = (64, 128, 256)  # [nbr-minmax]: the conv widths, f32
MINMAX_BF16_WIDTHS = (64, 128)  # and bf16
MINMAX_RAGGED = 11  # ragged clouds of the [nbr-minmax] phase
# [nbr-minmax]: the hooks' kernels, and launches per hook call: without
# grad gather_minmax once; with grad gather_minmax_win and
# gather_minmax_bwd once each; nbr_matmul_minmax gather_matmul_minmax once
# (the _bf16 bodies for bf16 features).
MINMAX_KERNELS = ("gather_minmax", "gather_minmax_bf16", "gather_minmax_win",
                  "gather_minmax_win_bf16", "gather_minmax_bwd",
                  "gather_minmax_bwd_bf16", "gather_matmul_minmax")
# [minmax-routes]: the min/max's two routes (and the matmul form's) at the
# classification shape of [nbr-minmax] and at the large clouds' (label, B,
# N, K); the _direct routes' and the K-fold route's records at the first.
MINMAX_ROUTE_SHAPES = (("cls", B, N, K), ("large", LARGE_B, LARGE_N, K))
FUSED_PER_FORWARD = {"knn_topk_mean_dist": 1, "fused_gather_wls": 1,
                     "fused_gather_wls_direct": 0, "densify_bf16": 1,
                     "knn_topk": 0, "gather_rows": 0, "wls": 0}
# Clouds without normals: the ScanObjectNN recipe
# (experiments/train_scanobjectnn.py: 15 classes, conv channels (64, 64,
# 64, 128), k=20, lambda 0.01, N=1024, B=32), whose frames the model
# estimates on a NORMAL_K-NN graph (the kNN route of the model's
# knn_method, then torch ops).
RECIPE = {"num_classes": 15, "conv_channels": (64, 64, 64, 128),
          "grad_regularizer": 0.01}
NORMAL_K = 10
NO_NORMALS_KERNELS = {None: ("gather_rows", "wls", "densify", "gather_max"),
                      "bfloat16": ("knn_topk", "gather_rows", "wls",
                                   "densify_bf16", "gather_max_affine")}
NO_NORMALS_TRAIN_KERNELS = ("gather_rows", "wls", "densify", "gather_max_win",
                            "gather_max_bwd", "adjacency")
NO_NORMALS_STEPS = 3
VOTES = 3
# x max|votes|: the least that VOTES augmented passes must move the sum of
# VOTES plain ones (f32 rounding moves it ~1e-7 x).
VOTE_MOVED = 1e-4
FPS_N, FPS_SAMPLES = 2048, 1024  # GeodesicFPS: the recipe's pre-transform
FPS_CHECK = (300, 64)  # points, samples: native against the Python version
FRAMES_HOST_REPS = 20  # host-clock samples of the frames' enqueue
# Training loop and checkpoints: the CLIs' fixtures (FIT_TRAIN / B steps an
# epoch), the kNN tie check's K and its generator's tag.
FIT_EPOCHS = 2
FIT_TRAIN, FIT_TEST = 64, 32
SONN_POINTS = 2048  # a ScanObjectNN object's points before the FPS
MODELNET_KINDS = ("sphere", "box", "cylinder")
FIT_KERNELS = ("gather_rows", "wls", "densify_bf16", "gather_max_win",
               "gather_max_bwd")
# A depth-2 model (ShapeNet's): its centralized conv gathers its edge tensor
# (gather_rows, one a forward beside the build's) and takes that tensor's max
# itself, so its edge statistics need no edge sum.
FIT_KERNELS_DEPTH2 = FIT_KERNELS + ("gather_max",)
SERVE_CKPT_REL = 1e-4  # x max|logit|: the engine against the eval step
# The last four CLIs' fixtures (2 steps an epoch at their batch of 16).
SHREC_KINDS = ("sphere", "box", "cylinder", "sphere")
SHREC_TRAIN, SHREC_TEST = 12, 2  # meshes a class (10 train kept)
SHAPENET_PARTS = {"02691156": (0, 4), "02773838": (4, 2),
                  "02954340": (6, 2)}  # Airplane, Bag, Cap: first part, parts
SHAPENET_TRAIN, SHAPENET_TEST = 36, 16
SHAPENET_RAW_POINTS = 2600  # a raw cloud's points before the FPS to 2048
# [geometry-single]: one cloud's (N, K), the coefficients' bound against
# the torch math (x max|coef|), timing samples, the tiled kNN's shape.
GEO_SHAPES = ((1024, 20), (8192, 20))
GEO_COEF_REL = 1e-4
GEO_REPS = 5
# The de Rham checks: the JAX test's bound on each rule, and how much farther
# from the f64 torch math the kernels' coefficients may lie than the f32
# torch math's (both round the same ill-conditioned fit in f32).
DERHAM_TOL = 1e-2
DERHAM_F32_RATIO = 2.0
GEO_TAG = 27
TILED_N, TILED_K, TILED_TILE = 65536, 20, 2048
TILED_REPS = 3
TIE_ULPS = 8  # knn_tiled against knn_topk: f32 ulps of 2 max|p|^2
CKPT_REPS = 3  # timed saves, restores and later predicts
TIE_KS = (20, 10)
TIE_TAG = 31  # the planar grids' 2/31 steps

KERNEL_META = {
    "gather_rows": ("deltaconv_tpu_torch/csrc/gather_rows.cu",
                    "deltaconv_tpu/ops/gather_rows.py:205"),
    "wls": ("deltaconv_tpu_torch/csrc/wls.cu",
            "deltaconv_tpu/ops/wls_fused.py:162"),
    # The direct route of the WLS forward and its VJP (the earlier
    # kernels, a route by shape above the split route's edges).
    "wls_direct": ("deltaconv_tpu_torch/csrc/wls.cu",
                   "deltaconv_tpu/ops/wls_fused.py:162"),
    "wls_bwd_direct": ("deltaconv_tpu_torch/csrc/wls.cu",
                       "deltaconv_tpu/ops/wls_fused.py:212"),
    "densify": ("deltaconv_tpu_torch/csrc/densify.cu",
                "deltaconv_tpu/ops/densify_op.py:249"),
    "gather_max": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                   "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_max_win": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                       "deltaconv_tpu/ops/gather_max.py:230"),
    # Route D of the neighbour max (the earlier kernel, a route by shape).
    "gather_max_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                          "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_max_win_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                              "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_max_bf16_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                               "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_max_win_bf16_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                                   "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_max_bwd": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                       "deltaconv_tpu/ops/gather_max.py:362"),
    # Route D of the backward (the earlier kernel, a route by shape).
    "gather_max_bwd_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                              "deltaconv_tpu/ops/gather_max.py:362"),
    "gather_max_bwd_bf16_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                                   "deltaconv_tpu/ops/gather_max.py:362"),
    "gather_minmax_bwd_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                                 "deltaconv_tpu/ops/gather_max.py:362"),
    "gather_minmax_bwd_bf16_direct": (
        "deltaconv_tpu_torch/csrc/gather_max.cu",
        "deltaconv_tpu/ops/gather_max.py:362"),
    "adjacency": ("deltaconv_tpu_torch/csrc/gather_sum.cu",
                  "deltaconv_tpu/ops/gather_sum.py:117"),
    "gather_sum": ("deltaconv_tpu_torch/csrc/gather_sum.cu",
                   "deltaconv_tpu/ops/gather_sum.py:201"),
    # Route D of the streaming sum (the earlier kernel, a route by shape).
    "gather_sum_direct": ("deltaconv_tpu_torch/csrc/gather_sum.cu",
                          "deltaconv_tpu/ops/gather_sum.py:201"),
    "gather_sum_bwd": ("deltaconv_tpu_torch/csrc/gather_sum.cu",
                       "deltaconv_tpu/ops/gather_sum.py:255"),
    "knn_topk": ("deltaconv_tpu_torch/csrc/knn_topk.cu",
                 "deltaconv_tpu/ops/knn_topk.py:391"),
    "densify_bf16": ("deltaconv_tpu_torch/csrc/densify.cu",
                     "deltaconv_tpu/ops/densify_op.py:249"),
    "gather_max_affine": ("deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
                          "deltaconv_tpu/ops/gather_max.py:666"),
    # Route D of the bf16 eval max (the earlier kernel, a route by shape).
    "gather_max_affine_direct": (
        "deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
        "deltaconv_tpu/ops/gather_max.py:666"),
    "gather_matmul_max": ("deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
                          "deltaconv_tpu/ops/gather_max.py:756"),
    "gather_matmul_max_kfold": (
        "deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
        "deltaconv_tpu/ops/gather_max.py:756"),
    "gather_max_win_bf16": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                            "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_max_bwd_bf16": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                            "deltaconv_tpu/ops/gather_max.py:362"),
    "gather_matmul_max_win": ("deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
                              "deltaconv_tpu/ops/gather_max.py:865"),
    "gather_matmul_max_win_kfold": (
        "deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
        "deltaconv_tpu/ops/gather_max.py:865"),
    "gather_max_bf16": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                        "deltaconv_tpu/ops/gather_max.py:230"),
    "gather_mlp_max": ("deltaconv_tpu_torch/csrc/gather_mlp_max.cu",
                       "deltaconv_tpu/ops/gather_mlp_max.py:237"),
    "mlp_rows": ("deltaconv_tpu_torch/csrc/gather_mlp_max.cu",
                 "deltaconv_tpu/ops/gather_mlp_max.py:237"),
    "gather_max_merge": ("deltaconv_tpu_torch/csrc/gather_mlp_max.cu",
                         "deltaconv_tpu/ops/gather_mlp_max.py:237"),
    "densify_int8": ("deltaconv_tpu_torch/csrc/densify.cu",
                     "deltaconv_tpu/ops/densify_op.py:180"),
    "gather_max_int8": ("deltaconv_tpu_torch/csrc/gather_max_int8.cu",
                        "deltaconv_tpu/ops/gather_max.py:1016"),
    # The per-cloud |h| maximum that route S of the int8 max quantizes
    # with: part of the redesign of the TPU kernel above.
    "absmax": ("deltaconv_tpu_torch/csrc/gather_max_int8.cu",
               "deltaconv_tpu/ops/gather_max.py:1016"),
    "gather_max_int8_direct": ("deltaconv_tpu_torch/csrc/gather_max_int8.cu",
                               "deltaconv_tpu/ops/gather_max.py:1016"),
    "gather_matmul_max_int8": ("deltaconv_tpu_torch/csrc/gather_max_int8.cu",
                               "deltaconv_tpu/ops/gather_max.py:1092"),
    "gather_matmul_max_int8_kfold": (
        "deltaconv_tpu_torch/csrc/gather_max_int8.cu",
        "deltaconv_tpu/ops/gather_max.py:1092"),
    "coef_apply_grad": ("deltaconv_tpu_torch/csrc/coef_apply.cu",
                        "deltaconv_tpu/ops/coef_apply.py:140"),
    "coef_apply_div": ("deltaconv_tpu_torch/csrc/coef_apply.cu",
                       "deltaconv_tpu/ops/coef_apply.py:173"),
    "coef_apply_grad_plan": ("deltaconv_tpu_torch/csrc/coef_apply.cu",
                             "deltaconv_tpu/ops/coef_apply.py:140"),
    "coef_apply_div_plan": ("deltaconv_tpu_torch/csrc/coef_apply.cu",
                            "deltaconv_tpu/ops/coef_apply.py:173"),
    # The gather plan of the planned applies (built once a forward for
    # both): part of the redesign of the two TPU kernels above.
    "coef_plan_order": ("deltaconv_tpu_torch/csrc/coef_apply.cu",
                        "deltaconv_tpu/ops/coef_apply.py:140"),
    "coef_plan_runs": ("deltaconv_tpu_torch/csrc/coef_apply.cu",
                       "deltaconv_tpu/ops/coef_apply.py:173"),
    "scatter_rows": ("deltaconv_tpu_torch/csrc/gather_rows.cu",
                     "deltaconv_tpu/ops/gather_rows.py:292"),
    "inverse_adjacency": ("deltaconv_tpu_torch/csrc/gather_rows.cu",
                          "deltaconv_tpu/ops/gather_rows.py:292"),
    "knn_topk_table": ("deltaconv_tpu_torch/csrc/knn_table.cu",
                       "deltaconv_tpu/ops/knn_topk.py:326"),
    "knn_topk_table_q": ("deltaconv_tpu_torch/csrc/knn_table.cu",
                         "deltaconv_tpu/ops/knn_topk.py:326"),
    "knn_topk_bucketed": ("deltaconv_tpu_torch/csrc/knn_bucketed.cu",
                          "deltaconv_tpu/ops/knn_bucketed.py:318"),
    "knn_topk_bucketed_q": ("deltaconv_tpu_torch/csrc/knn_bucketed.cu",
                            "deltaconv_tpu/ops/knn_bucketed.py:318"),
    "edge_delta_mlp": ("deltaconv_tpu_torch/csrc/edge_mlp.cu",
                       "deltaconv_tpu/ops/edge_mlp.py:192"),
    "edge_delta_mlp_bwd": ("deltaconv_tpu_torch/csrc/edge_mlp.cu",
                           "deltaconv_tpu/ops/edge_mlp.py:244"),
    # #28's phase 2 (PR 23): the destination-major sum of its edge tensor.
    "edge_delta_mlp_bwd_sum": ("deltaconv_tpu_torch/csrc/edge_mlp.cu",
                               "deltaconv_tpu/ops/edge_mlp.py:244"),
    "wls_bwd": ("deltaconv_tpu_torch/csrc/wls.cu",
                "deltaconv_tpu/ops/wls_fused.py:212"),
    "densify_bwd": ("deltaconv_tpu_torch/csrc/densify.cu",
                    "deltaconv_tpu/ops/densify_op.py:281"),
    # The sampled product that takes #6's place on the model paths (the
    # dense applies' and the coefficient form's coefficient cotangent):
    # its redesign, as absmax is #15's.
    "coef_cotangent": ("deltaconv_tpu_torch/csrc/coef_cotangent.cu",
                       "deltaconv_tpu/ops/densify_op.py:281"),
    "fused_gather_wls": ("deltaconv_tpu_torch/csrc/fused_build.cu",
                         "deltaconv_tpu/ops/fused_build.py:180"),
    # The direct route of the fused build (the earlier kernel, a route by
    # shape above the split route's 40 edges).
    "fused_gather_wls_direct": ("deltaconv_tpu_torch/csrc/fused_build.cu",
                                "deltaconv_tpu/ops/fused_build.py:180"),
    "knn_topk_mean_dist": ("deltaconv_tpu_torch/csrc/knn_topk.cu",
                           "deltaconv_tpu/ops/knn_topk.py:391"),
    "knn_topk_rounds": ("deltaconv_tpu_torch/csrc/knn_topk.cu",
                        "deltaconv_tpu/ops/knn_topk.py:391"),
    "gather_minmax": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                      "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_bf16": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                           "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_win": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                          "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_win_bf16": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                               "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_bwd": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                          "deltaconv_tpu/ops/gather_max.py:362"),
    "gather_minmax_bwd_bf16": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                               "deltaconv_tpu/ops/gather_max.py:362"),
    "gather_matmul_minmax": ("deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
                             "deltaconv_tpu/ops/gather_max.py:792"),
    # Route D of the min/max (the earlier kernel, a route by shape) and the
    # matmul min/max's K-fold route above the rows kernel's limit.
    "gather_minmax_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                             "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_bf16_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                                  "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_win_direct": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                                 "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_minmax_win_bf16_direct": (
        "deltaconv_tpu_torch/csrc/gather_max.cu",
        "deltaconv_tpu/ops/gather_max.py:474"),
    "gather_matmul_minmax_kfold": (
        "deltaconv_tpu_torch/csrc/gather_max_bf16.cu",
        "deltaconv_tpu/ops/gather_max.py:792"),
}
# The port's autograd Functions, whose forward or backward launches a
# kernel outside any aten op (the profiler books it to them).
AUTOGRAD_FUNCTIONS = ("_GatherMax", "_GatherMatmulMax", "_GatherSum",
                      "_GatherRows", "_CoefApplyGrad", "_CoefApplyDiv",
                      "_EdgeDeltaMlp", "_Wls", "_Densify", "_GradApply",
                      "_DivApply", "_GradApplyBackward", "_DivApplyBackward",
                      "_GatherMaxBackward", "_GatherMatmulMaxBackward",
                      "_GatherSumBackward", "_GatherRowsBackward",
                      "_CoefApplyGradBackward", "_CoefApplyDivBackward",
                      "_EdgeDeltaMlpBackward", "_WlsBackward",
                      "_DensifyBackward")
# The path whose launch counts each kernel's record reports.
SERVE_KERNELS = ("gather_rows", "wls", "densify", "gather_max")
BF16_KERNELS = ("knn_topk", "densify_bf16", "gather_max_affine",
                "gather_matmul_max")
TRAIN_KERNELS = ("gather_rows", "wls", "densify", "gather_max_win",
                 "gather_max_bwd", "adjacency")
STREAM_KERNELS = ("gather_sum", "gather_sum_bwd")
TRAIN_BF16_KERNELS = ("knn_topk", "gather_rows", "wls", "densify_bf16",
                      "adjacency", "gather_max_win_bf16",
                      "gather_max_bwd_bf16", "gather_matmul_max_win")
SEG_KERNELS = ("gather_rows", "wls", "densify", "gather_max")
SEG_BF16_KERNELS = ("knn_topk", "gather_rows", "wls", "densify_bf16",
                    "gather_max_bf16", "gather_mlp_max", "mlp_rows",
                    "gather_max_merge")
INT8_KERNELS = ("knn_topk", "gather_rows", "wls", "densify_int8",
                "absmax", "gather_max_int8", "gather_matmul_max_int8")
SEG_INT8_KERNELS = ("knn_topk", "gather_rows", "wls", "densify_int8",
                    "absmax", "gather_max_int8", "gather_mlp_max", "mlp_rows",
                    "gather_max_merge")
COEF_KERNELS = tuple(COEF_PER_FORWARD)
# The gather plan's kernels as the profiler names them.
PLAN_KERNELS = ("plan_sort_kernel", "plan_merge_kernel", "plan_runs_kernel")
LARGE_KERNELS = {  # the large-cloud paths, by precision
    "bfloat16": ("knn_topk", "gather_rows", "wls", *COEF_KERNELS,
                 "gather_max_affine", "gather_matmul_max"),
    None: ("knn_topk", "gather_rows", "wls", *COEF_KERNELS, "gather_max")}
TRAIN_LARGE_KERNELS = ("knn_topk", "gather_rows", "wls", *COEF_KERNELS,
                       "scatter_rows", "inverse_adjacency", "gather_sum",
                       "gather_sum_bwd", "gather_max_win_bf16",
                       "gather_max_bwd_bf16", "gather_matmul_max_win")
# Launches per forward on the int8 paths, as the JAX module code routes
# them: classification conv0-2 the int8 max, conv3 (lane-narrower) the
# int8 matmul max; segmentation conv1 the int8 max, conv0 the fused
# gather_mlp_max (centralized), conv2 mlp_rows and gather_max_merge; bf16
# segmentation the same MLP maxes. absmax: one a route-S int8 max and two
# a densify_int8 (the grad and the div coefficients).
# The operator build's WLS solve: once a forward, on the split route (its
# direct route above 40 edges a point, never on a model path).
WLS_PER_FORWARD = {"wls": 1, "wls_direct": 0}
INT8_PER_FORWARD = {**WLS_PER_FORWARD, "densify_int8": 1, "absmax": 5,
                    "gather_max_int8": 3,
                    "gather_max_int8_direct": 0,
                    "gather_matmul_max_int8": 1}
# The bf16 eval max on the bf16 classification and large-cloud forwards:
# conv0-2, each on route S.
BF16_PER_FORWARD = {**WLS_PER_FORWARD, "gather_max_affine": 3,
                    "gather_max_affine_direct": 0}
SEG_MLP_PER_FORWARD = {"gather_mlp_max": 1, "mlp_rows": 1,
                       "gather_max_merge": 1}
SEG_INT8_PER_FORWARD = {**WLS_PER_FORWARD, "densify_int8": 1, "absmax": 3,
                        "gather_max_int8": 1, "gather_max_int8_direct": 0,
                        **SEG_MLP_PER_FORWARD}
# Width of the record's time: the widest conv for the max, the first
# conv's [y, y^2] (2 x 64) for the sum, as the train step calls them;
# the bf16 max without winners at conv1's width in segmentation serving
# (gather_mlp_max at conv0, mlp_rows and gather_max_merge at conv2: the
# convs where each runs).
RECORD_WIDTH = {"gather_max": 256, "gather_max_win": 256,
                "gather_max_bwd": 256, "gather_sum": 128,
                "gather_sum_direct": SUM_C, "gather_sum_bwd": 128,
                "gather_max_win_bf16": 128,
                "gather_max_bwd_bf16": 256, "gather_max_bf16": SEG_MAX_WIDTH,
                "gather_max_int8": 128,
                "coef_apply_grad": 256, "coef_apply_div": 256,
                "scatter_rows": 512}
RECORD_WIDTH.update(coef_apply_grad_plan=256, coef_apply_div_plan=256)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops=0.0, ops_per_s=F32_OPS_PER_S):
    """``(bound_ms, bound_by)``: the larger of the bytes moved (each
    input read once, each output written once) over the HBM rate and
    the operations over the peak rate of their type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def bf16_ulps(a, b):
    """Per-element distance of two bf16 tensors in bf16 ulps."""
    def ordered(t):
        u = t.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

    return (ordered(a) - ordered(b)).abs()


def bits_equal(a, b) -> bool:
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def raw_equal(a, b) -> bool:
    """The same bits, NaN payloads included (f32 and bf16 viewed as
    integers)."""
    raw = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(raw.get(a.dtype, a.dtype)),
                       b.view(raw.get(b.dtype, b.dtype)))


def random_affine(gen_shape, dev):
    """A BatchNorm eval affine (sign, inv, mean, bias) with slopes of
    both signs."""
    inv = torch.randn(gen_shape, device=dev)
    return (torch.where(inv >= 0, 1.0, -1.0), inv,
            torch.randn(gen_shape, device=dev) * 0.2,
            torch.randn(gen_shape, device=dev) * 0.2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def ellipsoid_clouds(rng, sizes, axes=None):
    """Clouds on axis-aligned ellipsoids with analytic normals; ``axes``
    ``[M, 3]`` (random when None)."""
    clouds, normals = [], []
    for i, n in enumerate(sizes):
        ax = (rng.uniform(0.5, 1.5, 3) if axes is None
              else axes[i]).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        nrm = d / ax
        clouds.append(d * ax)
        normals.append(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    return clouds, normals


def wls_edges(rng, b, n, k, dev, masked=False):
    """The edge planes ``[b, 12, k, n]`` of ``b`` ellipsoid clouds of
    ``n`` points on their kNN graph (``masked``: cloud 0's last 40%
    padded), as the unfused build forms them."""
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    clouds, normals = ellipsoid_clouds(rng, [n] * b)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    pm = None
    if masked:
        pm = torch.ones((b, n), dtype=torch.bool, device=dev)
        pm[0, int(0.6 * n):] = False
    idx, nbr_mask = knn(pos, k, pm)
    if pm is not None:
        nbr_mask = nbr_mask & pm[:, :, None]
    xb, yb = build_tangent_basis(nrm)
    return edge_planes(pos, nrm, xb, yb, idx, nbr_mask,
                       nbr_mask.any(dim=2).to(torch.float32))


def wls_bound(edges, bwd):
    """The least time of ``wls`` (``bwd`` False: the planes read once, g
    and d written once, 180 f32 operations an edge) or ``wls_bwd`` (the
    planes and both cotangents read once, the planes' cotangents written
    once, 580 operations an edge)."""
    b, _, k, n = edges.shape
    planes = edges.numel() * 4
    coefs = 2 * b * 2 * k * n * 4
    if bwd:
        return bound(2 * planes + coefs, float(b) * n * k
                     * WLS_BWD_FLOPS_PER_EDGE)
    return bound(planes + coefs, float(b) * n * k * WLS_FLOPS_PER_EDGE)


def median_ms(fn, reps=REPS) -> float:
    """Median over ``reps`` samples, after warm-up, of the CUDA-event time
    of INNER back-to-back calls of ``fn`` divided by INNER. After the
    first call the card no longer waits for the host to enqueue, so a
    sample reads a call's device time (or its host time, if longer)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a - b).detach().abs().max())


def check(name, ok, detail):
    print(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def graph_cases(rng, dev):
    """Uniform and masked kNN graphs at the serving and train shapes;
    masked: the last 40% of the points of every other cloud are
    padding."""
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn

    clouds, normals = ellipsoid_clouds(rng, [N] * B)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    xb, yb = build_tangent_basis(nrm)
    pmask = torch.ones((B, N), dtype=torch.bool, device=dev)
    pmask[::2, int(0.6 * N):] = False
    cases = {}
    for label, mask in (("uniform", None), ("masked", pmask)):
        idx, nbr_mask = knn(pos, K, mask)
        if mask is not None:
            nbr_mask = nbr_mask & mask[:, :, None]
        cases[label] = (idx, nbr_mask)
    return pos, nrm, xb, yb, cases


def check_bf16_kernels(record, label, pos, idx, nbr_mask, gd, dev):
    """The four kernels of the bf16 serving path against their plain
    versions at the serving shapes: knn_topk (uniform only: it takes no
    mask), densify bf16, gather_max_affine, gather_matmul_max."""
    from deltaconv_tpu_torch import ops

    if label == "uniform":
        for q in (True, False):
            got, want = ops.knn_topk(pos, K, q), ops.knn_topk_plain(pos, K, q)
            err = max_err(got.float(), want.float())
            record("knn_topk", err)
            check(f"knn_topk quantized={q}", torch.equal(got, want),
                  f"{int((got != want).sum())} indices differ")
        big = torch.randn((4, KNN_BIG_N, 3), device=dev)
        for q in (True, False):
            got = ops.knn_topk(big, K, q)
            want = ops.knn_topk_plain(big, K, q)
            check(f"knn_topk N={KNN_BIG_N} quantized={q}",
                  torch.equal(got, want),
                  f"{int((got != want).sum())} indices differ")
        del big, got, want

    gc, dc = gd.grad_coef, gd.div_coef
    wg, wd = ops.densify_coefs(idx, gc, dc, torch.bfloat16)
    wgp, wdp = ops.densify_coefs_plain(idx, gc, dc, torch.bfloat16)
    err = max(max_err(wg.float(), wgp.float()), max_err(wd.float(),
                                                         wdp.float()))
    record("densify_bf16", err)
    check("densify bf16", bits_equal(wg, wgp) and bits_equal(wd, wdp),
          f"max_abs_err {err}")
    del wg, wd, wgp, wdp

    for c in BF16_WIDTHS:
        h = torch.randn((B, N, c), device=dev).to(torch.bfloat16)
        aff = random_affine(c, dev)
        for sub_self in (False, True):
            got = ops.gather_max_affine(h, idx, nbr_mask, aff, sub_self)
            want = ops.gather_max_affine_plain(h, idx, nbr_mask, aff,
                                               sub_self)
            err = max_err(got.float(), want.float())
            record("gather_max_affine", err)
            check(f"gather_max_affine C={c} sub_self={sub_self}",
                  bits_equal(got, want), f"max_abs_err {err}")

    x = torch.randn((B, N, MM_IN), device=dev).to(torch.bfloat16)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    aff = random_affine(MM_OUT, dev)
    raw = ops.gather_matmul_max(x, w, idx, nbr_mask)
    raw_p = ops.gather_matmul_max_plain(x, w, idx, nbr_mask)
    err = max_err(raw.float(), raw_p.float())
    record("gather_matmul_max", err)
    ok, detail = mm_max_held(raw, x, w, idx, nbr_mask)
    check(f"gather_matmul_max {MM_IN}->{MM_OUT}", ok,
          f"{detail}, max_abs_err {err}")
    fused = ops.gather_matmul_max(x, w, idx, nbr_mask, aff)
    fused_p = ops.gather_matmul_max_plain(x, w, idx, nbr_mask, aff)
    replay = ops.bn_lrelu_epilogue(raw.float(), aff,
                                   nbr_mask.any(dim=-1, keepdim=True))
    ulps = bf16_ulps(fused, fused_p)
    check(f"gather_matmul_max {MM_IN}->{MM_OUT} with the epilogue",
          bits_equal(fused, replay),
          f"equal to the epilogue replayed on the kernel's own max; vs the "
          f"plain version {float((ulps > 0).float().mean())} of elements "
          f"differ (a 1-ulp max through the affine), max_abs_err "
          f"{max_err(fused.float(), fused_p.float())}")
    torch.cuda.synchronize()


def check_bf16_train_kernels(record, idx, nbr_mask, dev):
    """The three kernels of the bf16 train step against their plain
    versions at its shapes: gather_max_win_bf16 (values and winners
    bit-equal), gather_max_bwd_bf16 (f64 sums: bit-equal to plain and
    across two calls) and
    gather_matmul_max_win (values within one bf16 ulp on at most
    MM_WIN_FRAC of the elements, winners equal on all but MM_WIN_FRAC,
    and where a winner differs the plain products at the two slots are
    within one ulp: the f32 sums run in another order)."""
    from deltaconv_tpu_torch import ops

    for c in TRAIN_BF16_WIDTHS:
        h = torch.randn((B, N, c), device=dev).to(torch.bfloat16)
        out, win = ops.gather_max_win(h, idx, nbr_mask)
        out_p, win_p = ops.gather_max_win_plain(h, idx, nbr_mask)
        err = max_err(out.float(), out_p.float())
        record("gather_max_win_bf16", err)
        check(f"gather_max_win_bf16 C={c}",
              bits_equal(out, out_p) and torch.equal(win, win_p),
              f"out max_abs_err {err}, winners differ at "
              f"{int((win != win_p).sum())}")
    for c in BWD_BF16_WIDTHS:
        h = torch.randn((B, N, c), device=dev).to(torch.bfloat16)
        g = torch.randn((B, N, c), device=dev).to(torch.bfloat16)
        _, win = ops.gather_max_win_plain(h, idx, nbr_mask)
        dh = ops.gather_max_bwd(idx, win, g, N)
        again = ops.gather_max_bwd(idx, win, g, N)
        dh_p = ops.gather_max_bwd_plain(idx, win, g, N)
        err = max_err(dh, dh_p)
        record("gather_max_bwd_bf16", err)
        check(f"gather_max_bwd_bf16 C={c}",
              torch.equal(dh, dh_p) and torch.equal(dh, again),
              f"max_abs_err {err}, bit-equal to plain and across two calls")

    x = torch.randn((B, N, MM_IN), device=dev).to(torch.bfloat16)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    out, win = ops.gather_matmul_max_win(x, w, idx, nbr_mask)
    out_p, win_p = ops.gather_matmul_max_win_plain(x, w, idx, nbr_mask)
    ulps = bf16_ulps(out, out_p)
    err = max_err(out.float(), out_p.float())
    record("gather_matmul_max_win", err)
    y = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    at = torch.gather(y, 1, torch.gather(idx.long(), 2, win.long()))
    at_p = torch.gather(y, 1, torch.gather(idx.long(), 2, win_p.long()))
    flips = float((win != win_p).float().mean())
    near = int(bf16_ulps(at, at_p).max())
    share = float((ulps > 0).float().mean())
    check(f"gather_matmul_max_win {MM_IN}->{MM_OUT}",
          int(ulps.max()) <= 1 and share <= MM_WIN_FRAC
          and flips <= MM_WIN_FRAC and near <= 1,
          f"values: max {int(ulps.max())} bf16 ulp on {share} of elements; "
          f"winners differ on {flips} of elements, the plain products at "
          f"the two slots within {near} ulp; max_abs_err {err}")
    torch.cuda.synchronize()


def mm_max_held(got, x, w, idx, mask):
    """``(ok, detail)``: a matmul max (bf16 ``got``) held element by
    element within one bf16 ulp of its plain version or, near zero, within
    the f32 summation bound ``C_in * 2^-24 * (|x| @ |w|)`` (the largest
    over the row's valid slots) plus the bf16 rounding (``2^-8 |got|``) of
    the exact max, an f64 product: there one bf16 ulp is finer than two
    f32 sums of the same terms in another order can agree."""
    from deltaconv_tpu_torch import ops

    ulps = bf16_ulps(got, ops.gather_matmul_max_plain(x, w, idx, mask))
    xd, wd = x.double(), w.double()
    exact = ops.gather_max_plain(xd @ wd, idx, mask)
    mag = ops.gather_max_plain(xd.abs() @ wd.abs(), idx, mask)
    gd = got.double()
    near = (gd - exact).abs() <= (x.shape[-1] * 2.0 ** -24 * mag
                                  + 2.0 ** -8 * gd.abs())
    valid = mask.any(dim=-1, keepdim=True).expand_as(got)
    ok = bool((((ulps <= 1) | near) | ~valid).all())
    beyond = int(((ulps > 1) & valid).sum())
    return ok, (f"max {int(ulps[valid].max())} bf16 ulp, "
                f"{float((ulps > 0).float().mean())} of elements differ (f32 "
                f"sum order), {beyond} beyond one ulp; all within one ulp or "
                f"the f32 sum bound of the exact max: {ok}")


def mm_win_held(out, win, win_p, x, w, idx, mask):
    """``(ok, detail)``: the train-form matmul max (bf16 ``out`` and its
    winner slots ``win``) held as :func:`mm_max_held` holds the eval form
    (its values are the bf16-rounded max), winners equal to the plain
    version's ``win_p`` on all but MM_WIN_FRAC of the elements, and where
    one differs the exact (f64) products at the two slots within the f32
    summation bounds of both plus one bf16 ulp of the larger (two f32
    sums in another order may rank them either way)."""
    ok, detail = mm_max_held(out, x, w, idx, mask)
    xd, wd = x.double(), w.double()
    y, mag = xd @ wd, xd.abs() @ wd.abs()

    def at(t, winner):
        return torch.gather(t, 1, torch.gather(idx.long(), 2, winner.long()))

    flip = win != win_p
    a, a_p = at(y, win)[flip], at(y, win_p)[flip]
    tol = (x.shape[-1] * 2.0 ** -24 * (at(mag, win) + at(mag, win_p))[flip]
           + 2.0 ** -7 * torch.maximum(a.abs(), a_p.abs()))
    share = float(flip.float().mean())
    near = bool(((a - a_p).abs() <= tol).all())
    return (ok and share <= MM_WIN_FRAC and near,
            f"values: {detail}; winners differ on {share} of elements, the "
            f"exact products at the two slots within the sum bound: {near}")


def densify_int8_held(record, idx, gc, dc):
    """densify_int8 bit-equal to its plain version in all four outputs,
    planes and scales, and across two calls: on the clouds' operator
    coefficients, and on them with cloud 0's grad scale set to 128 and
    two of its coefficients to +-64 (the quotients +-63.5, half to even)
    and the last cloud's div coefficients zero (the 1e-30 clamp)."""
    from deltaconv_tpu_torch import ops

    hard_g, hard_d = gc.clone(), dc.clone()
    hard_g[0, 0, 0, 0] = 128.0
    hard_g[0, 1, 1:3, 0] = torch.tensor([64.0, -64.0])
    hard_d[-1] = 0.0
    for label, g, d in (("operator coefficients", gc, dc),
                        ("half-way quotients and a zero cloud", hard_g,
                         hard_d)):
        got = ops.densify_coefs_int8(idx, g, d)
        again = ops.densify_coefs_int8(idx, g, d)
        want = ops.densify_coefs_int8_plain(idx, g, d)
        err = max(max_err(a.float(), w.float()) for a, w in zip(got, want))
        record("densify_int8", err)
        ok = all(torch.equal(a, w) and torch.equal(a, r)
                 for a, w, r in zip(got, want, again))
        if g is hard_g:
            ok = (ok and int(got[0][0, 0, 1, idx[0, 1, 1]]) == 64
                  and int(got[0][0, 0, 1, idx[0, 1, 2]]) == -64
                  and not bool(got[1][-1].any()))
        check(f"densify_int8 B={idx.shape[0]} N={idx.shape[1]} K="
              f"{idx.shape[2]}, {label}", ok,
              f"planes and scales equal to plain and across two calls, "
              f"max_abs_err {err}")
        del got, again, want


def check_int8_kernels(record, idx, nbr_mask, gd, dev):
    """The kernels of int8 serving against their plain versions at the
    classification shapes: densify_int8 (planes and scales equal),
    gather_max_int8 at C = 64 and 128, bf16 (the path's) and f32 features,
    through route S (absmax, then the staged max with the quantizing
    epilogue) and route D (``gather_max_int8_direct``), each bit-equal to
    the plain version, absmax equal to ``vector_norm(inf)``,
    gather_matmul_max_int8 at 128 -> 256 (``mm_max_held``, and bit-equal
    where the sums are exact in any order)."""
    from deltaconv_tpu_torch import ops

    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")

    densify_int8_held(record, idx, gd.grad_coef, gd.div_coef)
    for c in INT8_WIDTHS:
        for dt in (torch.bfloat16, torch.float32):
            h = torch.randn((B, N, c), device=dev).to(dt)
            want = ops.gather_max_int8_plain(h, idx, nbr_mask)
            for route, name in ((None, "gather_max_int8"),
                                ((0, 0), "gather_max_int8_direct")):
                got = gm._gather_max_int8(h, idx, nbr_mask, route)
                err = max_err(got.float(), want.float())
                record(name, err)
                check(f"{name} C={c} {str(dt)[6:]}",
                      got.dtype == dt and bits_equal(got, want),
                      f"bit-equal to plain, max_abs_err {err}")
            amax = gm.absmax(h)
            want = gm.absmax_plain(h)
            record("absmax", max_err(amax, want))
            check(f"absmax C={c} {str(dt)[6:]}", torch.equal(amax, want),
                  "equal to vector_norm(inf)")
    xq, _ = ops.int8_quantize(torch.randn((B, N, MM_IN), device=dev))
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    got = ops.gather_matmul_max_int8(xq, w, idx, nbr_mask)
    err = max_err(got.float(), ops.gather_matmul_max_int8_plain(
        xq, w, idx, nbr_mask).float())
    record("gather_matmul_max_int8", err)
    ok, detail = mm_max_held(got, xq, w, idx, nbr_mask)
    check(f"gather_matmul_max_int8 {MM_IN}->{MM_OUT}", ok,
          f"{detail}, max_abs_err {err}")
    we = (torch.randint(-16, 17, (MM_IN, MM_OUT), device=dev) / 16.0).to(
        torch.bfloat16)
    check(f"gather_matmul_max_int8 {MM_IN}->{MM_OUT}, exact sums",
          bits_equal(ops.gather_matmul_max_int8(xq, we, idx, nbr_mask),
                     ops.gather_matmul_max_int8_plain(xq, we, idx, nbr_mask)),
          "bit-equal")
    torch.cuda.synchronize()


def mm_minmax_held(got, x, w, idx, mask):
    """``(ok, detail)``: both outputs of a matmul min/max held by
    :func:`mm_max_held`, the max as it is and the min as the max of
    ``x @ (-w)`` negated (negating bf16 values is exact)."""
    ok_mx, d_mx = mm_max_held(got[0], x, w, idx, mask)
    ok_mn, d_mn = mm_max_held(-got[1], x, -w, idx, mask)
    return ok_mx and ok_mn, f"max: {d_mx}; min: {d_mn}"


def check_minmax_kernels(record, idx, nbr_mask, dev):
    """The kernels of the min/max hooks against their plain versions at
    the classification shapes: gather_minmax and gather_minmax_win at f32
    C=256 and their bf16 bodies at C=128 (values and winners bit-equal: a
    max and a min are exact), gather_minmax_bwd at C=256 with f32 and
    bf16 cotangents (f64 sums: bit-equal to plain and across two calls),
    gather_matmul_minmax
    at 128 -> 256 (``mm_minmax_held``: one bf16 ulp, or the f32
    summation bound of the f64 product)."""
    from deltaconv_tpu_torch import ops

    for c, dt in ((MINMAX_C, torch.float32),
                  (MINMAX_BF16_C, torch.bfloat16)):
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        h = torch.randn((B, N, c), device=dev).to(dt)
        got = ops.gather_minmax(h, idx, nbr_mask)
        want = ops.gather_minmax_plain(h, idx, nbr_mask)
        err = max(max_err(g.float(), w.float()) for g, w in zip(got, want))
        record(f"gather_minmax{sfx}", err)
        check(f"gather_minmax{sfx} C={c}",
              all(bits_equal(g, w) for g, w in zip(got, want)),
              f"max and min bit-equal, max_abs_err {err}")
        got = ops.gather_minmax_win(h, idx, nbr_mask)
        want = ops.gather_minmax_win_plain(h, idx, nbr_mask)
        err = max(max_err(g.float(), w.float()) for g, w in zip(got[:2],
                                                                want[:2]))
        record(f"gather_minmax_win{sfx}", err)
        check(f"gather_minmax_win{sfx} C={c}",
              all(bits_equal(g, w) for g, w in zip(got, want)),
              f"values and winners equal (winners differ at "
              f"{int((got[2] != want[2]).sum() + (got[3] != want[3]).sum())}"
              f"), max_abs_err {err}")
    h = torch.randn((B, N, MINMAX_C), device=dev)
    _, _, wmx, wmn = ops.gather_minmax_win_plain(h, idx, nbr_mask)
    for dt in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        gmx, gmn = (torch.randn((B, N, MINMAX_C), device=dev).to(dt)
                    for _ in range(2))
        dh = ops.gather_minmax_bwd(idx, wmx, gmx, wmn, gmn, N)
        again = ops.gather_minmax_bwd(idx, wmx, gmx, wmn, gmn, N)
        dh_p = ops.gather_minmax_bwd_plain(idx, wmx, gmx, wmn, gmn, N)
        err = max_err(dh, dh_p)
        record(f"gather_minmax_bwd{sfx}", err)
        check(f"gather_minmax_bwd{sfx} C={MINMAX_C}",
              torch.equal(dh, dh_p) and torch.equal(dh, again),
              f"max_abs_err {err}, bit-equal to plain and across two calls")
    x = torch.randn((B, N, MM_IN), device=dev).to(torch.bfloat16)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    got = ops.gather_matmul_minmax(x, w, idx, nbr_mask)
    want = ops.gather_matmul_minmax_plain(x, w, idx, nbr_mask)
    err = max(max_err(g.float(), v.float()) for g, v in zip(got, want))
    record("gather_matmul_minmax", err)
    ok, detail = mm_minmax_held(got, x, w, idx, nbr_mask)
    check(f"gather_matmul_minmax {MM_IN}->{MM_OUT}", ok,
          f"{detail}; max_abs_err {err}")
    torch.cuda.synchronize()


def time_library_calls(res, table, idx, nbr_mask, aff128, x, w, aff256, xq,
                       dev):
    """The library calls of the classification shapes' gathers, maxes and
    sums, set-up included, at each kernel's record width, on the uniform
    graph (every slot valid, so no mask): the ``index`` gather of the K
    neighbour rows (``torch.gather`` for the gather), then ``amax`` (the
    max), ``torch.max`` with its indices (the max with winners; no promised
    tie rule), ``sum``; the bf16 maxes after the bf16 ``matmul`` or the
    int8 quantization and before the epilogue or the dequantization; the
    backward ``scatter_add_`` of the cotangent at its winners or
    neighbours. The exact ones are checked against the kernels."""
    from deltaconv_tpu_torch import ops

    assert bool(nbr_mask.all())
    bidx = torch.arange(B, device=dev)[:, None, None]
    idx_l = idx.long()
    valid = nbr_mask.any(dim=-1, keepdim=True)
    flat = idx_l.reshape(B, N * K, 1)

    def scatter_back(g, to):
        """``scatter_add_`` of g's rows at the neighbours ``to [B, N,
        K']`` (K' = 1 for the winners' rows), into zeros."""
        kk = to.shape[-1]
        src = g.float()[:, :, None, :].expand(B, N, kk, g.shape[-1])
        return torch.zeros((B, N, g.shape[-1]), device=dev).scatter_add_(
            1, to.reshape(B, N * kk, 1).expand(B, N * kk, g.shape[-1]),
            src.reshape(B, N * kk, g.shape[-1]))

    h256 = torch.randn((B, N, 256), device=dev)
    h128f = torch.randn((B, N, 128), device=dev)
    h128 = torch.randn((B, N, 128), device=dev).to(torch.bfloat16)
    g256 = torch.randn((B, N, 256), device=dev)
    g128 = torch.randn((B, N, 128), device=dev)
    g256b = g256.to(torch.bfloat16)
    _, win256 = ops.gather_max_win_plain(h256, idx, nbr_mask)

    def max_bwd(win, g):
        """The winners' rows: each output channel's winner is its own
        neighbour, so the cotangent goes channel by channel."""
        to = torch.gather(idx_l, 2, win.long())  # [B, N, C]
        return torch.zeros((B, N, g.shape[-1]), device=dev).scatter_add_(
            1, to, g.float())

    calls = {
        "gather_rows": (lambda: torch.gather(
            table, 1, flat.expand(B, N * K, table.shape[-1])).view(
                B, N, K, -1).permute(0, 3, 2, 1).contiguous(),
            lambda: ops.gather_rows(table, idx), True),
        "gather_max": (lambda: h256[bidx, idx_l].amax(dim=2),
                       lambda: ops.gather_max(h256, idx, nbr_mask), True),
        "gather_max_win": (lambda: torch.max(h256[bidx, idx_l], dim=2),
                           None, False),
        "gather_max_bwd": (lambda: max_bwd(win256, g256),
                           lambda: ops.gather_max_bwd(idx, win256, g256, N),
                           True),
        "gather_max_bwd_bf16": (lambda: max_bwd(win256, g256b), None, False),
        "gather_max_win_bf16": (lambda: torch.max(h128[bidx, idx_l], dim=2),
                                None, False),
        "gather_sum": (lambda: h128f[bidx, idx_l].sum(dim=2),
                       lambda: ops.gather_sum_fwd(h128f, idx, nbr_mask), True),
        "gather_sum_bwd": (lambda: scatter_back(g128, idx_l),
                           lambda: ops.gather_sum_bwd(idx, nbr_mask, g128),
                           True),
        "gather_max_affine": (lambda: ops.bn_lrelu_epilogue(
            h128[bidx, idx_l].amax(dim=2).float(), aff128, valid), None,
            False),
        "gather_matmul_max": (lambda: ops.bn_lrelu_epilogue(
            torch.matmul(x, w)[bidx, idx_l].amax(dim=2).float(), aff256,
            valid), None, False),
        "gather_matmul_max_win": (lambda: torch.max(
            torch.matmul(x, w)[bidx, idx_l], dim=2), None, False),
        "gather_max_int8": (lambda: int8_library_max(h128, bidx, idx_l),
                            None, False),
        "gather_matmul_max_int8": (lambda: torch.matmul(
            xq.to(torch.bfloat16), w)[bidx, idx_l].amax(dim=2), None, False),
    }
    for name, (lib, kern, exact) in calls.items():
        res[name]["library_ms"] = median_ms(lib)
        if exact:  # the same values, summed in another order at most
            want, got = lib(), kern()
            err = max_err(want, got)
            check(f"{name} library composition",
                  err <= SCATTER_RTOL * float(want.abs().max()),
                  f"max_abs_err {err:.3e} within 1e-5 x max")
        print(f"  {name}: library call {res[name]['library_ms']:.4f} ms")


def densify_int8_library(idx, gc, dc):
    """The library composition of densify_int8 as a function of no
    arguments: the torch quantization, then zero fill, ``scatter_add_``
    in f32 (both operators as the four planes of one ``[B, 4, N, N]``
    tensor; the index and the planes' coefficients made here, outside the
    timed calls), cast to int8."""
    b, n, k = idx.shape
    index4 = idx.long()[:, None].expand(b, 4, n, k)
    coef4 = torch.cat([gc, dc], dim=-1).permute(0, 3, 1, 2).contiguous()

    def run():
        s_g = torch.clamp(gc.abs().amax(dim=(1, 2, 3)), min=1e-30)
        s_d = torch.clamp(dc.abs().amax(dim=(1, 2, 3)), min=1e-30)
        s4 = torch.stack([s_g, s_g, s_d, s_d], dim=1)[:, :, None, None]
        q = torch.clamp(torch.round(coef4 / s4 * 127.0), -127.0, 127.0)
        return torch.zeros((b, 4, n, n), device=idx.device).scatter_add_(
            3, index4, q).to(torch.int8)

    return run


def int8_library_max(h, bidx, idx_l):
    """gather_max_int8 by library calls: the per-cloud quantization, the
    ``index`` gather and ``amax`` of the int8 rows, the dequantization."""
    from deltaconv_tpu_torch import ops

    hq, scale = ops.int8_quantize(h)
    best = hq[bidx, idx_l].amax(dim=2).float()
    return (best * scale[:, None, None]).to(h.dtype)


def time_narrow_scatter(table, idx, card):
    """scatter_rows at the operator build's gather VJP (B=32, N=1024,
    K=20, C'=9 component-major rows, the c stride K * N): read through
    the strides (the wrapper's route), and transposed to edge-major rows
    first (``permute`` + ``contiguous``); the same sums in the same order,
    bit-equal. CUDA events (the host's enqueue time where it is longer)
    and the profiler's device time."""
    from deltaconv_tpu_torch import ops

    g = ops.gather_rows(table, idx)  # [B, 9, K, N]
    assert g.shape[1] == SCATTER_NARROW_C and g.stride(1) != 1
    ways = {"read through the strides": lambda: ops.scatter_rows(g, idx, N),
            "permute + contiguous first":
            lambda: ops.scatter_rows(edge_major(g), idx, N)}
    outs = [fn() for fn in ways.values()]
    check(f"scatter_rows C'={SCATTER_NARROW_C} both ways",
          bits_equal(*outs), "bit-equal")
    for label, fn in ways.items():
        print(f"  scatter_rows C'={SCATTER_NARROW_C} component-major, "
              f"{label}: {median_ms(fn):.4f} ms (events), "
              f"{device_ms(fn):.4f} ms of device time, B={B} N={N} K={K}, "
              f"card: {card}")


def time_minmax_kernels(res, idx, nbr_mask, dev):
    """Times, bounds and library calls of the min/max kernels at the
    uniform classification shapes (every slot valid, so the library calls
    need no mask): the forwards beside an ``index`` gather and
    ``torch.aminmax`` over K (with winners: ``torch.max`` and ``torch.min``
    over K, values and indices, no promised tie rule), the backward beside
    the winners resolved with ``torch.gather`` and two ``scatter_add_``
    into zeros, the matmul form beside a bf16 ``torch.matmul``, the gather
    and ``aminmax``."""
    from deltaconv_tpu_torch import ops

    assert bool(nbr_mask.all())
    bidx = torch.arange(B, device=dev)[:, None, None]
    idx_l = idx.long()

    def library_fwd(h):
        return torch.aminmax(h[bidx, idx_l], dim=2)

    def library_win(h):
        g = h[bidx, idx_l]
        return torch.max(g, dim=2), torch.min(g, dim=2)

    for c, dt in ((MINMAX_C, torch.float32),
                  (MINMAX_BF16_C, torch.bfloat16)):
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        h = torch.randn((B, N, c), device=dev).to(dt)
        outs = ops.gather_minmax_win(h, idx, nbr_mask)
        for name, fk, fp, fl, io in (
                (f"gather_minmax{sfx}",
                 lambda: ops.gather_minmax(h, idx, nbr_mask),
                 lambda: ops.gather_minmax_plain(h, idx, nbr_mask),
                 lambda: library_fwd(h), (h, idx, nbr_mask, *outs[:2])),
                (f"gather_minmax_win{sfx}",
                 lambda: ops.gather_minmax_win(h, idx, nbr_mask),
                 lambda: ops.gather_minmax_win_plain(h, idx, nbr_mask),
                 lambda: library_win(h), (h, idx, nbr_mask, *outs))):
            res[name].update(ms=median_ms(fk), plain_ms=median_ms(fp),
                             library_ms=median_ms(fl), bound=bound(nbytes(*io)))
    h = torch.randn((B, N, MINMAX_C), device=dev)
    _, _, wmx, wmn = ops.gather_minmax_win_plain(h, idx, nbr_mask)
    for dt in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        gmx, gmn = (torch.randn((B, N, MINMAX_C), device=dev).to(dt)
                    for _ in range(2))

        def library_bwd():
            dh = torch.zeros((B, N, MINMAX_C), device=dev)
            dh.scatter_add_(1, torch.gather(idx_l, 2, wmx.long()), gmx.float())
            return dh.scatter_add_(1, torch.gather(idx_l, 2, wmn.long()),
                                   gmn.float())

        res[f"gather_minmax_bwd{sfx}"].update(
            ms=median_ms(lambda: ops.gather_minmax_bwd(idx, wmx, gmx, wmn,
                                                       gmn, N)),
            plain_ms=median_ms(lambda: ops.gather_minmax_bwd_plain(
                idx, wmx, gmx, wmn, gmn, N)),
            library_ms=median_ms(library_bwd),
            bound=bound(nbytes(idx, wmx, gmx, wmn, gmn, h)))
    x = torch.randn((B, N, MM_IN), device=dev).to(torch.bfloat16)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    outs = ops.gather_matmul_minmax(x, w, idx, nbr_mask)
    # One product a row, as gather_matmul_max's bound counts.
    res["gather_matmul_minmax"].update(
        ms=median_ms(lambda: ops.gather_matmul_minmax(x, w, idx, nbr_mask)),
        plain_ms=median_ms(lambda: ops.gather_matmul_minmax_plain(
            x, w, idx, nbr_mask)),
        library_ms=median_ms(
            lambda: torch.aminmax(torch.matmul(x, w)[bidx, idx_l], dim=2)),
        bound=bound(nbytes(x, w, idx, nbr_mask, *outs),
                    2.0 * B * N * MM_IN * MM_OUT, BF16_TC_OPS_PER_S))
    for name in MINMAX_KERNELS:
        r = res[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library call {r['library_ms']:.4f} ms")


def mlp_inputs(c_in, c_out, centralized, dev):
    """Inputs of gather_mlp_max at one conv's widths: bf16 ``x``, the two
    layers' weights (the last sign-folded by the epilogue's signs), the
    intermediate affine, the self slot (the chain of the zero edge, or of
    every point) and the epilogue."""
    from deltaconv_tpu_torch import ops

    x = torch.randn((SEG_B, SEG_N, c_in), device=dev).to(torch.bfloat16)
    epi = random_affine(c_out, dev)
    ws = [torch.randn((c_in, c_out), device=dev) / c_in ** 0.5,
          torch.randn((c_out, c_out), device=dev) / c_out ** 0.5
          * epi[0][None, :]]
    affines = [(torch.randn(c_out, device=dev),
                torch.randn(c_out, device=dev) * 0.2)]
    z0 = (ops.mlp_chain(torch.zeros((1, c_in), device=dev), ws, affines)[0]
          if centralized else ops.mlp_chain(x, ws, affines))
    return x, ws, affines, z0, epi


def seg_graphs(rng, dev):
    """Uniform and masked kNN graphs at the segmentation shapes, each with
    its operator coefficients; masked: the last 40% of the points of every
    other cloud are padding."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn

    clouds, normals = ellipsoid_clouds(rng, [SEG_N] * SEG_B)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    xb, yb = build_tangent_basis(nrm)
    pmask = torch.ones((SEG_B, SEG_N), dtype=torch.bool, device=dev)
    pmask[::2, int(0.6 * SEG_N):] = False
    cases = {}
    for label, mask in (("uniform", None), ("masked", pmask)):
        idx, nbr_mask = knn(pos, SEG_K, mask)
        if mask is not None:
            nbr_mask = nbr_mask & mask[:, :, None]
        gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
        cases[label] = (idx, nbr_mask, gd)
    return cases


def check_seg_kernels(record, idx, nbr_mask, gd, dev):
    """The kernels of bf16 and int8 segmentation serving against their
    plain versions at its shapes: densify_int8 on the clouds' operator
    coefficients (planes and scales equal), gather_max_bf16 and
    gather_max_int8 (values equal) and
    gather_mlp_max at conv0 (the fused kernel) and conv2 (mlp_rows, then
    gather_max_merge): over every slot without the self slot and the
    epilogue, at most MLP_FRAC of the best values differ and by at most
    MLP_REL x max (the tensor cores sum in another order and a one-ulp
    product carries through the next layer); the self-slot merge and the
    epilogue bit-equal to their replay on the kernel's own best values;
    the fused output within MLP_REL x max of the plain; at conv2
    mlp_rows held as the best values are, and gather_max_merge on its
    rows bit-equal to its plain version (k0 = 1 with the self rows, with
    and without the epilogue; k0 = 0 bare)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops.gather_max import NEG

    densify_int8_held(record, idx, gd.grad_coef, gd.div_coef)
    h = torch.randn((SEG_B, SEG_N, SEG_MAX_WIDTH),
                    device=dev).to(torch.bfloat16)
    got = ops.gather_max(h, idx, nbr_mask)
    want = ops.gather_max_plain(h, idx, nbr_mask)
    err = max_err(got.float(), want.float())
    record("gather_max_bf16", err)
    check(f"gather_max_bf16 C={SEG_MAX_WIDTH}",
          torch.equal(got.float(), want.float()), f"max_abs_err {err}")
    got = ops.gather_max_int8(h, idx, nbr_mask)
    want = ops.gather_max_int8_plain(h, idx, nbr_mask)
    err = max_err(got.float(), want.float())
    record("gather_max_int8", err)
    check(f"gather_max_int8 C={SEG_MAX_WIDTH}", bits_equal(got, want),
          f"max_abs_err {err}")
    valid = nbr_mask.any(dim=-1, keepdim=True)
    for conv, (c_in, c_out, cen) in MLP_CASES.items():
        x, ws, aff, z0, epi = mlp_inputs(c_in, c_out, cen, dev)
        args = (x, ws, aff, idx, nbr_mask, cen)
        raw = ops.gather_mlp_max(*args, False)
        raw_p = ops.gather_mlp_max_plain(*args, False)
        live = raw_p > NEG / 2
        share = float((raw != raw_p).float().mean())
        err = max_err(raw[live], raw_p[live])
        tol = MLP_REL * float(raw_p[live].abs().max())
        record("gather_mlp_max", err)
        check(f"gather_mlp_max {conv} {c_in}->{c_out}->{c_out}, every slot",
              torch.equal(raw > NEG / 2, live) and share <= MLP_FRAC
              and err <= tol,
              f"{share} of best values differ, max_abs_err {err} <= {tol}")
        best = ops.gather_mlp_max(*args, True)
        z0b = z0.expand_as(best) if cen else z0
        merged = torch.maximum(best, torch.where(nbr_mask[..., :1], z0b,
                                                 NEG))
        o = (epi[0] * merged - epi[2]) * epi[1] + epi[3]
        o = torch.where(valid, torch.where(o >= 0, o, 0.2 * o), 0.0)
        fused = ops.gather_mlp_max(*args, True, z0, epi)
        fused_p = ops.gather_mlp_max_plain(*args, True, z0, epi)
        ferr = max_err(fused.float(), fused_p.float())
        ftol = MLP_REL * float(fused_p.float().abs().max())
        record("gather_mlp_max", ferr)
        check(f"gather_mlp_max {conv} self slot and epilogue",
              torch.equal(ops.gather_mlp_max(*args, True, z0), merged)
              and bits_equal(fused, o.to(torch.bfloat16)) and ferr <= ftol,
              f"bit-equal to the merge and the epilogue replayed on the "
              f"kernel's own best values; vs the plain version max_abs_err "
              f"{ferr} <= {ftol}")
        if cen:
            continue
        # The two kernels of the route without centralization, each
        # against its plain version on the same inputs.
        rows = ops.mlp_rows(x, ws, aff)
        rows_p = ops.mlp_rows_plain(x, ws, aff)
        share = float((rows != rows_p).float().mean())
        err = max_err(rows.float(), rows_p.float())
        tol = MLP_REL * float(rows_p.float().abs().max())
        record("mlp_rows", err)
        check(f"mlp_rows {conv} {c_in}->{c_out}->{c_out}",
              share <= MLP_FRAC and err <= tol,
              f"{share} of the rows' values differ, max_abs_err {err} <= "
              f"{tol}")
        for k0, z, e in ((1, z0, epi), (1, z0, None), (0, None, None)):
            got = ops.gather_max_merge(rows, idx, nbr_mask, k0, z, e)
            want = ops.gather_max_merge_plain(rows, idx, nbr_mask, k0, z, e)
            err = max_err(got.float(), want.float())
            record("gather_max_merge", err)
            check(f"gather_max_merge {conv} C={c_out} k0={k0} "
                  f"z0={z is not None} epilogue={e is not None}",
                  bits_equal(got, want), f"max_abs_err {err}")
    torch.cuda.synchronize()


def time_seg_kernels(res, idx, nbr_mask, dev, card):
    """Times and bounds of the segmentation kernels at its uniform
    shapes. gather_mlp_max's bound is its function's: the MLP of every
    valid covered edge when centralized (conv0), of every point when not
    (conv2), on the bf16 tensor cores, or its bytes; its library times
    are the composition that gathers first (the MLP of every edge) and,
    at conv2, the one that runs the MLP per point first. The records of
    gather_mlp_max (conv0), mlp_rows and gather_max_merge (conv2) and of
    their library compositions are device time (profiler): the wrapper's
    host work (padding and packing the weights) takes longer than the
    kernels, so CUDA events would time the host. Both are printed."""
    from deltaconv_tpu_torch import ops

    print(f"[times] segmentation shapes B={SEG_B} N={SEG_N} K={SEG_K}, "
          f"card: {card}")
    h = torch.randn((SEG_B, SEG_N, SEG_MAX_WIDTH),
                    device=dev).to(torch.bfloat16)
    r = res["gather_max_bf16"]
    r["ms"] = median_ms(lambda: ops.gather_max(h, idx, nbr_mask))
    r["plain_ms"] = median_ms(lambda: ops.gather_max_plain(h, idx, nbr_mask))
    r["bound"] = bound(nbytes(h, idx, nbr_mask, h))
    # Library calls on the uniform graph (every slot valid): the index
    # gather and amax; for the MLP max also the two bf16 matmuls of every
    # slot but the self slot, their intermediate affine and LeakyReLU, the
    # self slot's row and the epilogue (the JAX gather-then-MLP form).
    assert bool(nbr_mask.all())
    bidx = torch.arange(SEG_B, device=dev)[:, None, None]
    idx_l = idx.long()
    r["library_ms"] = median_ms(lambda: h[bidx, idx_l].amax(dim=2))
    print(f"  gather_max_bf16 C={SEG_MAX_WIDTH}: kernel {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, library call "
          f"{r['library_ms']:.4f} ms")
    edges = float(nbr_mask[..., 1:].sum())
    points = float(SEG_B * SEG_N)
    for conv, (c_in, c_out, cen) in MLP_CASES.items():
        x, ws, aff, z0, epi = mlp_inputs(c_in, c_out, cen, dev)
        km = median_ms(lambda: ops.gather_mlp_max(x, ws, aff, idx, nbr_mask,
                                                  cen, True, z0, epi))
        pm = median_ms(lambda: ops.gather_mlp_max_plain(
            x, ws, aff, idx, nbr_mask, cen, True, z0, epi))
        out = ops.gather_mlp_max(x, ws, aff, idx, nbr_mask, cen, True, z0,
                                 epi)
        # The function's work: the MLP of every covered edge when
        # centralized (its input depends on both ends), else of every
        # point (row j's output is the same for every point gathering it).
        mults = sum(w.shape[0] * w.shape[1] for w in ws)
        flops = 2.0 * (edges if cen else points) * mults
        wb = [w.to(torch.bfloat16) for w in ws]
        bd = bound(nbytes(x, idx, nbr_mask, *wb, *aff[0], z0,
                          torch.stack(epi), out), flops, BF16_TC_OPS_PER_S)
        w0, w1 = wb
        (a, bb), = aff
        sign, inv, mean, bias = epi

        def tail(z):
            """The max over the slots, the self slot, the epilogue."""
            best = torch.maximum(z.amax(dim=2).float(), z0.float())
            return torch.nn.functional.leaky_relu(
                (sign * best - mean) * inv + bias, 0.2)

        def chain(e):
            """The eval MLP by two bf16 matmuls (f32 affine between)."""
            y = torch.nn.functional.leaky_relu(
                torch.matmul(e, w0).float() * a + bb, 0.2)
            return torch.matmul(y.to(torch.bfloat16), w1)

        def k_fold():
            """Per edge: ``index`` gather (minus the point's own row when
            centralized), the chain on every slot but the self slot."""
            e = x[bidx, idx_l[:, :, 1:]]  # [B, N, K - 1, C_in] bf16
            if cen:
                e = (e.float() - x.float()[:, :, None]).to(torch.bfloat16)
            return tail(chain(e))

        lm = median_ms(k_fold)
        call = (lambda: ops.gather_mlp_max(x, ws, aff, idx, nbr_mask, cen,
                                           True, z0, epi))
        kd, ld = device_ms(call, 5), device_ms(k_fold, 5)
        line = (f"  gather_mlp_max {conv} {c_in}->{c_out}->{c_out}: the call "
                f"{km:.4f} ms ({kd:.4f} ms of device time), plain {pm:.4f} "
                f"ms, bound {bd[0]:.4f} ms ({bd[1]}; {flops / 1e9:.2f} GFLOP "
                f"of the function), library (gather, then the MLP of every "
                f"edge) {lm:.4f} ms ({ld:.4f} ms of device time)")
        if cen:
            res["gather_mlp_max"].update(ms=kd, plain_ms=pm, bound=bd,
                                         library_ms=ld)
            print(line, flush=True)
            continue

        def per_point():
            """The MLP once a point, then ``index`` + ``amax``."""
            return tail(chain(x)[bidx, idx_l[:, :, 1:]])

        pp, ppd = median_ms(per_point), device_ms(per_point, 5)
        print(f"{line}, library per point (the MLP, then gather) "
              f"{pp:.4f} ms ({ppd:.4f} ms of device time)", flush=True)
        rows = ops.mlp_rows(x, ws, aff)
        timed = {
            "mlp_rows": (lambda: ops.mlp_rows(x, ws, aff),
                         lambda: ops.mlp_rows_plain(x, ws, aff),
                         lambda: chain(x),
                         bound(nbytes(x, *wb, *aff[0], rows), flops,
                               BF16_TC_OPS_PER_S)),
            "gather_max_merge": (
                lambda: ops.gather_max_merge(rows, idx, nbr_mask, 1, z0,
                                             epi),
                lambda: ops.gather_max_merge_plain(rows, idx, nbr_mask, 1,
                                                   z0, epi),
                lambda: tail(rows[bidx, idx_l[:, :, 1:]]),
                bound(nbytes(rows, idx, nbr_mask, z0, torch.stack(epi),
                             out)))}
        for name, (fk, fp, fl, bd) in timed.items():
            ev, lev = median_ms(fk), median_ms(fl)
            res[name].update(ms=device_ms(fk, 5), plain_ms=median_ms(fp),
                             library_ms=device_ms(fl, 5), bound=bd)
            r = res[name]
            print(f"  {name} {conv}: kernel {r['ms']:.4f} ms of device time "
                  f"({ev:.4f} ms by events), plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']:.4f} ms of device time "
                  f"({lev:.4f} ms by events), bound {bd[0]:.4f} ms "
                  f"({bd[1]})", flush=True)


def edge_inputs(idx, dev):
    """Inputs of the edge MLP at the first conv of the segmentation train
    step (C0 = C1 = EDGE_C): bf16 ``y``, the affine ``(a0, b0)`` with
    slopes of both signs, ``w1`` and the self slot ``z0``."""
    b, n, _ = idx.shape
    y = torch.randn((b, n, EDGE_C), device=dev).to(torch.bfloat16)
    a0 = torch.randn(EDGE_C, device=dev)
    b0 = 0.3 * torch.randn(EDGE_C, device=dev)
    w1 = torch.randn((EDGE_C, EDGE_C), device=dev) / EDGE_C ** 0.5
    lb = torch.where(b0 >= 0, b0, 0.2 * b0)
    z0 = lb.to(torch.bfloat16).float() @ w1.to(torch.bfloat16).float()
    return y, a0, b0, w1, z0


def edge_exact_inputs(idx, dev):
    """Edge MLP inputs whose sums are exact in f32 in any order (``y`` in
    steps of 1/8 up to 4, ``a0`` and ``b0`` in steps of 1/8, ``w1`` in
    steps of 1/16 up to 1, the integer cotangent ``g`` up to 4): the
    kernel's and the plain version's ``dh = g @ w1^T`` agree bit for bit,
    and so do their rounding points."""
    b, n, k = idx.shape

    def steps(shape, top, step):
        return (torch.randint(-top, top + 1, shape, device=dev)
                * step).float()

    return (steps((b, n, EDGE_C), 32, 1 / 8).to(torch.bfloat16),
            steps((EDGE_C,), 16, 1 / 8), steps((EDGE_C,), 8, 1 / 8),
            steps((EDGE_C, EDGE_C), 16, 1 / 16),
            steps((b, k, n, EDGE_C), 4, 1.0).to(torch.bfloat16))


def edge_fwd_held(got, y, a0, b0, w1, z0, idx):
    """``(ok, detail)`` of the edge MLP's forward: slot 0 equal to
    ``bf16(z0)``; every other element within one bf16 ulp of the plain
    version or within the f32 summation bound ``C0 * 2^-24 * (|h| @
    |w1|)`` plus half a bf16 ulp of the exact (f64) product of the same
    bf16 ``h``, as the matmul maxes are held (``mm_max_held``)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops.edge_mlp import _edges, _leaky

    want = ops.edge_mlp_fwd_plain(y, a0, b0, w1, z0, idx)
    slot0 = bits_equal(got[:, 0], want[:, 0])
    _, pre = _edges(y, a0, b0, idx)
    h = _leaky(pre[:, :, 1:]).to(torch.bfloat16).double()
    del pre
    wd = w1.to(torch.bfloat16).double()
    gd = got[:, 1:].permute(0, 2, 1, 3).double()
    far = bf16_ulps(got[:, 1:], want[:, 1:]).permute(0, 2, 1, 3) > 1
    tol = (y.shape[-1] * 2.0 ** -24 * (h.abs() @ wd.abs())
           + 2.0 ** -8 * gd.abs())
    beyond = far & ((gd - h @ wd).abs() > tol)
    n_far, n_beyond = int(far.sum()), int(beyond.sum())
    return slot0 and n_beyond == 0, (
        f"slot 0 bit-equal {slot0}; {n_far} elements beyond one bf16 ulp, "
        f"{n_beyond} of them beyond the f32 summation bound; max_abs_err "
        f"{max_err(got.float(), want.float())}")


def edge_terms_held(e, y, a0, b0, w1, idx, g):
    """``(ok, detail)`` of the backward's edge tensor ``e`` (phase 1,
    ``edge_delta_mlp_bwd``), held as the forward is (:func:`edge_fwd_held`):
    each ``bf16(dy0)`` of slots >= 1 within one bf16 ulp of the plain
    version's, or within the f32 summation bound of ``dh = g @ w1^T``,
    ``C1 * 2^-24 * (|g| @ |w1|^T)`` times ``|dpre / dh| |a0|``, plus one
    bf16 ulp, of the exact (f64) term of the same inputs (where ``dh``
    cancels, its f32 sums in another order move the term by more than an
    ulp of itself)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops.edge_mlp import _edges

    want = ops.edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx, g)[0][:, 1:]
    far = bf16_ulps(e[:, 1:], want) > 1
    n_far = int(far.sum())
    del want
    _, pre = _edges(y, a0, b0, idx)
    scale = (torch.where(pre[:, :, 1:] >= 0, 1.0, 0.2) * a0).double()
    del pre
    g1 = g[:, 1:].double().permute(0, 2, 1, 3)
    wd = w1.to(torch.bfloat16).double()
    exact = ((g1 @ wd.t()) * scale).permute(0, 2, 1, 3)
    mag = ((g1.abs() @ wd.abs().t()) * scale.abs()).permute(0, 2, 1, 3)
    del g1, scale
    got = e[:, 1:].double()
    tol = w1.shape[1] * 2.0 ** -24 * mag + 2.0 ** -8 * got.abs()
    n_beyond = int((far & ((got - exact).abs() > tol)).sum())
    return n_beyond == 0, (f"{n_far} elements beyond one bf16 ulp, "
                           f"{n_beyond} of them beyond the f32 summation "
                           f"bound")


def check_edge_mlp_kernels(record, idx, dev):
    """The edge MLP's three kernels against their plain versions at the
    segmentation train shapes: the forward (``edge_delta_mlp``) by
    :func:`edge_fwd_held` (slot 0 bit-equal); phase 1 of the backward
    (``edge_delta_mlp_bwd``) by :func:`edge_terms_held` for the edge
    tensor, its f64 self rows, ``dw1`` and the affine's sums within
    SCATTER_RTOL x max, and on exact-sum inputs (:func:`edge_exact_inputs`)
    the edge tensor and the self rows bit-equal; phase 2
    (``edge_delta_mlp_bwd_sum``, after the inverse adjacency of the
    clamped indices) bit-equal to its plain version on the plain phase 1's
    outputs (both add the same addends in f64 and round once; slot 0 of
    the edge tensor NaN, never read); the whole backward's ``dy`` within
    one bf16 ulp of the largest edge term of the plain backward's (the f32
    sums of ``dh`` run in another order), bit-equal across two calls, and
    on exact-sum inputs bit-equal to the plain version."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops.edge_mlp import _edges

    y, a0, b0, w1, z0 = edge_inputs(idx, dev)
    out = ops.edge_mlp_fwd(y, a0, b0, w1, z0, idx)
    want = ops.edge_mlp_fwd_plain(y, a0, b0, w1, z0, idx)
    record("edge_delta_mlp", max_err(out.float(), want.float()))
    del want
    ok, detail = edge_fwd_held(out, y, a0, b0, w1, z0, idx)
    check(f"edge_delta_mlp {EDGE_C}->{EDGE_C}", ok, detail)
    del out
    b, n, k = idx.shape
    g = torch.randn((b, k, n, EDGE_C), device=dev).to(torch.bfloat16)

    e, s, dw1, dab = ops.edge_mlp_bwd_edges(y, a0, b0, w1, idx, g)
    e_p, s_p, dw1_p, dab_p = ops.edge_mlp_bwd_edges_plain(y, a0, b0, w1,
                                                          idx, g)
    ok, detail = edge_terms_held(e, y, a0, b0, w1, idx, g)
    errs = [max_err(a, b_) for a, b_ in ((s, s_p), (dw1, dw1_p),
                                         (dab, dab_p))]
    tols = [SCATTER_RTOL * float(t.abs().max()) for t in (s_p, dw1_p, dab_p)]
    record("edge_delta_mlp_bwd", max(max_err(e[:, 1:].float(),
                                             e_p[:, 1:].float()), *errs))
    check("edge_delta_mlp_bwd (phase 1: edge tensor, self rows, partials)",
          ok and all(x <= t for x, t in zip(errs, tols)),
          f"edge tensor: {detail}; self rows {errs[0]} <= {tols[0]}, dw1 "
          f"{errs[1]} <= {tols[1]}, dab {errs[2]} <= {tols[2]}")
    del e, s
    e_p[:, 0] = float("nan")
    dy = ops.edge_mlp_bwd_sum(e_p, s_p, idx)
    dy_w = ops.edge_mlp_bwd_sum_plain(e_p, s_p, idx)
    record("edge_delta_mlp_bwd_sum", max_err(dy, dy_w))
    check("edge_delta_mlp_bwd_sum (phase 2)", bits_equal(dy, dy_w),
          f"bit-equal to the plain version on the same edge tensor and "
          f"self rows, max_abs_err {max_err(dy, dy_w)}")
    del e_p, s_p, dy_w

    dy, dw1, dab = ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)
    dy_p = ops.edge_mlp_bwd_plain(y, a0, b0, w1, idx, g)[0]
    _, pre = _edges(y, a0, b0, idx)
    dh = g[:, 1:].float().permute(0, 2, 1, 3) @ w1.to(
        torch.bfloat16).float().t()
    flip = 2.0 ** -8 * float((dh * torch.where(pre[:, :, 1:] >= 0, 1.0, 0.2)
                              * a0).abs().max())
    del pre, dh
    err = max_err(dy, dy_p)
    check("edge MLP backward dy", err <= flip,
          f"{err} <= {flip} (the f32 sums of dh in another order: one bf16 "
          f"ulp of the largest edge term)")
    again = ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)[0]
    check("edge MLP backward dy, two calls", torch.equal(dy, again),
          "bit-equal (f64 sums, rounded once)")
    ye, a0e, b0e, w1e, ge = edge_exact_inputs(idx, dev)
    e, s, _, _ = ops.edge_mlp_bwd_edges(ye, a0e, b0e, w1e, idx, ge)
    e_p, s_p, _, _ = ops.edge_mlp_bwd_edges_plain(ye, a0e, b0e, w1e, idx,
                                                  ge)
    check("edge_delta_mlp_bwd (phase 1), exact-sum inputs",
          bits_equal(e[:, 1:], e_p[:, 1:]) and torch.equal(s, s_p),
          "edge tensor and self rows bit-equal to the plain version")
    del e, s, e_p, s_p
    dy = ops.edge_mlp_bwd(ye, a0e, b0e, w1e, idx, ge)[0]
    dy_p = ops.edge_mlp_bwd_plain(ye, a0e, b0e, w1e, idx, ge)[0]
    check("edge MLP backward dy, exact-sum inputs", torch.equal(dy, dy_p),
          f"bit-equal to the plain version, max_abs_err {max_err(dy, dy_p)}")
    torch.cuda.synchronize()


def edge_library(y, a0, b0, w1, z0, idx, g):
    """The edge MLP as PyTorch library calls, set-up included: the forward
    (the ``index`` gather of the rows, the elementwise affine, a bf16
    ``torch.matmul``); the backward's phase 1 (the same, the bf16
    products, the edge terms' cast and the sums), its phase 2
    (``index_add_`` of the edge tensor's rows into the negated self rows)
    and the whole backward (``index_add_`` of the edge terms). Timed as a
    yardstick, used nowhere."""
    b, n, c0 = y.shape
    k = idx.shape[-1]
    w1b = w1.to(torch.bfloat16)
    rows = idx.transpose(1, 2)[:, 1:].long()  # [B, K - 1, N]
    bidx = torch.arange(b, device=y.device)[:, None, None]
    flat = (rows + bidx * n).reshape(-1)

    def pre_of():
        y0 = y[bidx, rows].float() - y.float()[:, None]
        return y0, y0 * a0 + b0

    def fwd():
        _, pre = pre_of()
        h = torch.where(pre >= 0, pre, 0.2 * pre).to(torch.bfloat16)
        out = torch.empty((b, k, n, w1.shape[1]), dtype=torch.bfloat16,
                          device=y.device)
        out[:, 0] = z0.to(torch.bfloat16)
        out[:, 1:] = torch.matmul(h, w1b)
        return out

    def terms():
        y0, pre = pre_of()
        h = torch.where(pre >= 0, pre, 0.2 * pre).to(torch.bfloat16)
        g1 = g[:, 1:]
        dpre = torch.matmul(g1, w1b.t()).float() * torch.where(
            pre >= 0, 1.0, 0.2)
        dw1 = torch.matmul(h.reshape(-1, c0).t(), g1.reshape(-1, g1.shape[-1]))
        return (y0, dpre, dpre * a0, dw1, (dpre * y0).sum(dim=(0, 1, 2)),
                dpre.sum(dim=(0, 1, 2)))

    def bwd_edges():
        _, _, dy0, dw1, da0, db0 = terms()
        return (dy0.to(torch.bfloat16), dy0.double().sum(dim=1), dw1, da0,
                db0)

    e_rows, self_rows = bwd_edges()[:2]

    def bwd_sum():
        dy = (-self_rows).reshape(b * n, c0)
        dy.index_add_(0, flat, e_rows.reshape(-1, c0).double())
        return dy.float()

    def bwd():
        _, _, dy0, dw1, da0, db0 = terms()
        dy = torch.zeros((b * n, c0), device=y.device).index_add_(
            0, flat, dy0.to(torch.bfloat16).float().reshape(-1, c0))
        return dy.reshape(b, n, c0) - dy0.sum(dim=1), dw1, da0, db0

    return fwd, bwd_edges, bwd_sum, bwd


def time_edge_mlp_kernels(res, idx, dev, card):
    """Times of the edge MLP at the segmentation train shapes, in device
    time (profiler) and by CUDA events: the forward (#27), the backward's
    phase 1 and phase 2 (the inverse adjacency of the clamped indices and
    the sum) and the whole backward (#28: phase 1, the inverse adjacency,
    phase 2 and the sums of the partials), each beside its plain version,
    the library calls (:func:`edge_library`) and its bound (each input
    read once, each output written once; ``2 E C0 C1`` bf16 tensor-core
    operations in the forward and ``4 E C0 C1`` in phase 1 over the E = B N
    (K - 1) edges); and the backward design's own byte floor (g read, the
    edge tensor written and read, the self rows written and read, dy, idx
    and the adjacency). The parent's kernels are timed by
    ``[kernel-times]`` under ``--parent``."""
    from deltaconv_tpu_torch import ops

    y, a0, b0, w1, z0 = edge_inputs(idx, dev)
    b, n, k = idx.shape
    g = torch.randn((b, k, n, EDGE_C), device=dev).to(torch.bfloat16)
    out = ops.edge_mlp_fwd(y, a0, b0, w1, z0, idx)
    e, s, dw1, dab = ops.edge_mlp_bwd_edges(y, a0, b0, w1, idx, g)
    dy = ops.edge_mlp_bwd_sum(e, s, idx)
    off, lst = ops.inverse_adjacency(idx, n, clamp=True)
    lib_fwd, lib_edges, lib_sum, lib_bwd = edge_library(y, a0, b0, w1, z0,
                                                        idx, g)
    edges = float(b * n * (k - 1))
    ab = torch.stack([a0, b0])
    w1b = w1.to(torch.bfloat16)
    flops = 2.0 * edges * EDGE_C * EDGE_C
    calls = {
        "edge_delta_mlp": (
            lambda: ops.edge_mlp_fwd(y, a0, b0, w1, z0, idx),
            lambda: ops.edge_mlp_fwd_plain(y, a0, b0, w1, z0, idx), lib_fwd,
            bound(nbytes(y, idx, ab, w1b, z0, out), flops,
                  BF16_TC_OPS_PER_S)),
        "edge_delta_mlp_bwd": (
            lambda: ops.edge_mlp_bwd_edges(y, a0, b0, w1, idx, g),
            lambda: ops.edge_mlp_bwd_edges_plain(y, a0, b0, w1, idx, g),
            lib_edges,
            bound(nbytes(y, idx, ab, w1b, g[:, 1:], e[:, 1:], s, dw1, dab),
                  2 * flops, BF16_TC_OPS_PER_S)),
        "edge_delta_mlp_bwd_sum": (
            lambda: ops.edge_mlp_bwd_sum(e, s, idx),
            lambda: ops.edge_mlp_bwd_sum_plain(e, s, idx), lib_sum,
            bound(nbytes(e[:, 1:], s, idx, dy))),
    }
    print(f"[times] edge MLP, B={b} N={n} K={k} {EDGE_C}->{EDGE_C}, device "
          f"time of one call (CUDA events in brackets), card: {card}",
          flush=True)
    for name, (kernel, plain, lib, bd) in calls.items():
        res[name].update(ms=device_ms(kernel, 5), plain_ms=device_ms(plain),
                         library_ms=device_ms(lib), bound=bd)
        r = res[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms [{median_ms(kernel):.4f}]"
              f", plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
              f"{bd[0] / r['ms']:.2f} of it", flush=True)
    def whole():
        return ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)

    split = kernel_split(whole, ("edge_mlp_bwd_edges", "inverse_adjacency",
                                 "edge_mlp_bwd_sum"), 5)
    fn_bound = bound(nbytes(y, idx, ab, w1b, g[:, 1:], dy, dw1, dab),
                     2 * flops, BF16_TC_OPS_PER_S)
    floor = bound(nbytes(g[:, 1:], e[:, 1:], e[:, 1:], s, s, dy, idx, off,
                         lst))
    print(f"  the whole backward (#28): {device_ms(whole, 5):.4f} ms "
          f"[{median_ms(whole):.4f}] (kernels: phase 1 "
          f"{split['edge_mlp_bwd_edges']:.4f}, inverse adjacency "
          f"{split['inverse_adjacency']:.4f}, phase 2 "
          f"{split['edge_mlp_bwd_sum']:.4f}), plain "
          f"{device_ms(lambda: ops.edge_mlp_bwd_plain(y, a0, b0, w1, idx, g)):.4f}"
          f" ms, library {device_ms(lib_bwd):.4f} ms; the function's bound "
          f"{fn_bound[0]:.4f} ms ({fn_bound[1]}), the design's byte floor "
          f"{floor[0]:.4f} ms", flush=True)


def matmul_max_phase(res, rng, dev, card):
    """``[kernels]`` of the bf16 matmul maxes at conv3 of both models that
    run them (MM_SHAPES: B=32, N=1024 and B=4, N=8192; K=20, MM_IN ->
    MM_OUT), on ellipsoid clouds, uniform and masked graphs, through both
    routes: the one-product-a-row kernels (the route by shape) and the
    K-fold kernels (``_kfold``, forced): on exact-sum inputs values,
    winners and the epilogue bit-equal to the plain versions; on random
    inputs the eval form held by :func:`mm_max_held`, its epilogue
    bit-equal to the replay on its own max, the train form by
    :func:`mm_win_held`, and the two routes bit-equal to each other (the
    same tensor-core sums in the same order); each call's launches show
    its route. Then, at each shape, the time of both routes beside the
    per-point composition (``x @ w``, then the port's ``gather_max_affine``
    or ``gather_max_win``), the plain versions and the bounds, by CUDA
    events and in device time (profiler). The records of the ``_kfold``
    routes are at the classification shape. Its clouds come from a
    generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    rng = rng.spawn(1)[0]
    names = ("gather_matmul_max", "gather_matmul_max_win")

    def through(route, x, w, idx, mask, aff):
        """(raw, with the epilogue, out, winners) through ``route`` and
        the launches they made."""
        cs = None if route == "rows" else 0
        reset_launch_counts()
        got = (gm._gather_matmul_max(x, w, idx, mask, None, cs),
               gm._gather_matmul_max(x, w, idx, mask, aff, cs),
               *gm._gather_matmul_max_win(x, w, idx, mask, cs))
        torch.cuda.synchronize()
        counts = launch_counts()
        sfx, other = ("", "_kfold") if route == "rows" else ("_kfold", "")
        check(f"{route} route launches",
              counts[names[0] + sfx] == 2 and counts[names[1] + sfx] == 1
              and counts[names[0] + other] + counts[names[1] + other] == 0,
              f"{ {n: c for n, c in counts.items() if c} }")
        return got

    def same(a, b):
        return bits_equal(a, b) if a.dtype == torch.bfloat16 else \
            torch.equal(a, b)

    timings = {}
    for b, n in MM_SHAPES:
        clouds, _ = ellipsoid_clouds(rng, [n] * b)
        pos = torch.from_numpy(np.stack(clouds)).to(dev)
        pmask = torch.ones((b, n), dtype=torch.bool, device=dev)
        pmask[::2, int(0.6 * n):] = False
        aff = random_affine(MM_OUT, dev)
        for label, pm in (("uniform", None), ("masked", pmask)):
            idx, nbr_mask = knn(pos, K, pm)
            if pm is not None:
                nbr_mask = nbr_mask & pm[:, :, None]
            print(f"[kernels] matmul maxes B={b} N={n} K={K} "
                  f"{MM_IN}->{MM_OUT}, {label}, one-product-a-row slice "
                  f"{gm.mm_slice(b, n, MM_IN, MM_OUT, K, 132)} columns",
                  flush=True)
            xe = (torch.randint(-32, 33, (b, n, MM_IN), device=dev) / 8.0
                  ).to(torch.bfloat16)
            we = (torch.randint(-16, 17, (MM_IN, MM_OUT), device=dev) / 16.0
                  ).to(torch.bfloat16)
            want = (ops.gather_matmul_max_plain(xe, we, idx, nbr_mask),
                    ops.gather_matmul_max_plain(xe, we, idx, nbr_mask, aff),
                    *ops.gather_matmul_max_win_plain(xe, we, idx, nbr_mask))
            for route in ("rows", "kfold"):
                got = through(route, xe, we, idx, nbr_mask, aff)
                check(f"{route} route, exact sums",
                      all(same(g, v) for g, v in zip(got, want)),
                      "max, max with the epilogue, train max and winners "
                      "bit-equal to the plain versions")
            x = torch.randn((b, n, MM_IN), device=dev).to(torch.bfloat16)
            w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8
                 ).to(torch.bfloat16)
            raw_p = ops.gather_matmul_max_plain(x, w, idx, nbr_mask)
            out_p, win_p = ops.gather_matmul_max_win_plain(x, w, idx,
                                                           nbr_mask)
            valid = nbr_mask.any(dim=-1, keepdim=True)
            both = {}
            for route in ("rows", "kfold"):
                raw, fused, out, win = both[route] = through(
                    route, x, w, idx, nbr_mask, aff)
                sfx = "" if route == "rows" else "_kfold"
                record = res[names[0] + sfx]
                record["max_abs_err"] = max(record["max_abs_err"], max_err(
                    raw.float(), raw_p.float()))
                record = res[names[1] + sfx]
                record["max_abs_err"] = max(record["max_abs_err"], max_err(
                    out.float(), out_p.float()))
                ok, detail = mm_max_held(raw, x, w, idx, nbr_mask)
                check(f"{route} route, eval form", ok, detail)
                check(f"{route} route, the epilogue",
                      bits_equal(fused, ops.bn_lrelu_epilogue(
                          raw.float(), aff, valid)),
                      "bit-equal to the epilogue replayed on its own max")
                ok, detail = mm_win_held(out, win, win_p, x, w, idx,
                                         nbr_mask)
                check(f"{route} route, train form", ok, detail)
            check("the two routes, random inputs",
                  all(same(g, v) for g, v in zip(both["rows"],
                                                  both["kfold"])),
                  "max, max with the epilogue, train max and winners "
                  "bit-equal")
            torch.cuda.synchronize()
            if label == "uniform":
                timings[(b, n)] = (x, w, idx, nbr_mask, aff)

    print(f"[times] the bf16 matmul maxes, {MM_IN}->{MM_OUT}, K={K}, per "
          f"call: median of {REPS} CUDA-event samples of {INNER} calls, and "
          f"device time (profiler); card: {card}")
    for (b, n), (x, w, idx, nbr_mask, aff) in timings.items():
        forms = {
            "gather_matmul_max": (
                lambda: gm._gather_matmul_max(x, w, idx, nbr_mask, aff),
                lambda: gm._gather_matmul_max(x, w, idx, nbr_mask, aff, 0),
                lambda: ops.gather_max_affine(torch.matmul(x, w), idx,
                                              nbr_mask, aff),
                lambda: ops.gather_matmul_max_plain(x, w, idx, nbr_mask,
                                                    aff),
                (x, w, idx, nbr_mask, torch.stack(aff),
                 torch.empty((b, n, MM_OUT), dtype=torch.bfloat16,
                             device=dev))),
            "gather_matmul_max_win": (
                lambda: gm._gather_matmul_max_win(x, w, idx, nbr_mask),
                lambda: gm._gather_matmul_max_win(x, w, idx, nbr_mask, 0),
                lambda: ops.gather_max_win(torch.matmul(x, w), idx,
                                           nbr_mask),
                lambda: ops.gather_matmul_max_win_plain(x, w, idx, nbr_mask),
                (x, w, idx, nbr_mask,
                 *ops.gather_matmul_max_win_plain(x, w, idx, nbr_mask))),
        }
        for name, (rows, kfold, composed, plain, io) in forms.items():
            # One product a row: 2 B N C_in C_out operations.
            bd = bound(nbytes(*io), 2.0 * b * n * MM_IN * MM_OUT,
                       BF16_TC_OPS_PER_S)
            t = {label: (median_ms(fn), device_ms(fn, 5)) for label, fn in
                 (("rows", rows), ("kfold", kfold), ("per point", composed))}
            pl = median_ms(plain, 5)
            print(f"  {name} B={b} N={n}: one product a row {t['rows'][0]:.4f}"
                  f" ms ({t['rows'][1]:.4f} ms of device time); K-fold "
                  f"{t['kfold'][0]:.4f} ({t['kfold'][1]:.4f}); x @ w then "
                  f"the port's max {t['per point'][0]:.4f} "
                  f"({t['per point'][1]:.4f}); plain {pl:.4f}; bound "
                  f"{bd[0]:.4f} ms ({bd[1]})", flush=True)
            if (b, n) == (B, N):
                res[name + "_kfold"].update(
                    ms=t["kfold"][0], plain_ms=pl, bound=bd,
                    library_ms=res[name]["library_ms"])


def max_routes_phase(res, rng, dev, card):
    """``[kernels]`` of the neighbour max's two routes at every shape and
    width where the model paths run it (MAX_ROUTE_SHAPES), on ellipsoid
    clouds with a uniform kNN graph: route S (by shape, :func:`max_slice`)
    and route D (``_direct``, forced) bit-equal to the plain version,
    values and winners, each call's launch on its route; then both timed
    by CUDA events and in device time, beside the plain version, the
    library call (``index`` + ``amax``, or ``torch.max`` with winners)
    and the bound (h, idx, mask read once, out and the winners written
    once). Route D is the parent tree's kernel, unchanged. Then the int8
    matmul max at 128 -> 256 through both routes (one product a row, the
    K-fold kernel ``_kfold``), bit-equal to each other, timed the same
    way. The records of the ``_direct`` routes are at their bodies'
    record shapes. Its clouds come from a generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    rng = rng.spawn(1)[0]
    print(f"[times] the neighbour max by route: S (a staged slice, "
          f"by shape) and D (direct, the parent's kernel); per call, "
          f"CUDA events (median of {REPS} samples of {INNER} calls) and "
          f"device time (profiler); card: {card}", flush=True)
    graphs = {}
    for label, b, n, k, dt, widths, winners in MAX_ROUTE_SHAPES:
        if (b, n, k) not in graphs:
            clouds, _ = ellipsoid_clouds(rng, [n] * b)
            pos = torch.from_numpy(np.stack(clouds)).to(dev)
            graphs[(b, n, k)] = knn(pos, k)
        idx, nbr_mask = graphs[(b, n, k)]
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()
        base = "gather_max_win" if winners else "gather_max"
        name = base + ("_bf16" if dt == torch.bfloat16 else "")
        for c in widths:
            h = torch.randn((b, n, c), device=dev).to(dt)
            cs, splits = gm.max_slice(b, n, c, h.element_size(), k, 132,
                                      winners)

            def run(route, h=h, idx=idx, nbr_mask=nbr_mask):
                if winners:
                    return gm._gather_max_win(h, idx, nbr_mask, route)
                return (gm._max(h, idx, nbr_mask, route),)

            want = (ops.gather_max_win_plain(h, idx, nbr_mask) if winners
                    else (ops.gather_max_plain(h, idx, nbr_mask),))
            for route, sfx in ((None, ""), ((0, 0), "_direct")):
                reset_launch_counts()
                got = run(route)
                torch.cuda.synchronize()
                counts = launch_counts()
                check(f"[max-routes] {label} C={c} {name}{sfx}",
                      all(bits_equal(g, v) for g, v in zip(got, want))
                      and counts[name + sfx] == 1
                      and sum(counts.values()) == 1,
                      f"values{' and winners' if winners else ''} "
                      f"bit-equal to plain, launches "
                      f"{ {m: v for m, v in counts.items() if v} }")
                res[name + sfx]["max_abs_err"] = max(
                    res[name + sfx]["max_abs_err"],
                    max_err(got[0].float(), want[0].float()))
            bd = bound(nbytes(h, idx, nbr_mask, *want))
            t = {sfx: (median_ms(lambda: run(route)),
                       device_ms(lambda: run(route), 5))
                 for route, sfx in ((None, "S"), ((0, 0), "D"))}
            pl = median_ms(lambda: (ops.gather_max_win_plain if winners
                                    else ops.gather_max_plain)(
                h, idx, nbr_mask), 5)
            lib = median_ms((lambda: torch.max(h[bidx, idx_l], dim=2))
                            if winners else
                            (lambda: h[bidx, idx_l].amax(dim=2)))
            print(f"  {label} {name} B={b} N={n} K={k} C={c}: route S "
                  f"({cs} channels, {splits} blocks a task) "
                  f"{t['S'][0]:.4f} ms ({t['S'][1]:.4f} ms of device "
                  f"time); route D {t['D'][0]:.4f} ({t['D'][1]:.4f}); "
                  f"plain {pl:.4f}; library {lib:.4f}; bound {bd[0]:.4f} "
                  f"ms ({bd[1]})", flush=True)
            if (b, n, k, c) == MAX_RECORD[name]:
                res[name + "_direct"].update(ms=t["D"][0], plain_ms=pl,
                                             library_ms=lib, bound=bd)
            # Every slice that fits, one block a task and the chooser's
            # split for it: the measurements behind max_slice's rule.
            row, alts = c * h.element_size(), []
            for rb in gm.MAX_ROW_BYTES:
                if gm.max_smem(n, rb) > gm.SMEM_MAX or (
                        rb > 16 and rb // 2 >= row):
                    continue
                most = -(-n // gm.MAX_SPLIT_POINTS)
                fill = max(1, min(132 // (b * -(-row // rb)), most))
                alts += [(rb // h.element_size(), sp)
                         for sp in sorted({1, fill})]
            times = [f"{a} x {sp}: {device_ms(lambda: run((a, sp)), 5):.4f}"
                     for a, sp in alts]
            print("    route S by slice (channels x blocks a task: device "
                  "ms): " + "; ".join(times), flush=True)
            del h, want

    x = torch.randn((B, N, MM_IN), device=dev)
    xq, _ = ops.int8_quantize(x)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    idx, nbr_mask = graphs[(B, N, K)]
    got = {}
    for cs, name in ((None, "gather_matmul_max_int8"),
                     (0, "gather_matmul_max_int8_kfold")):
        reset_launch_counts()
        got[name] = gm._gather_matmul_max_int8(xq, w, idx, nbr_mask, cs)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(f"[max-routes] int8 matmul max route {name}",
              counts[name] == 1 and sum(counts.values()) == 1,
              f"launches { {m: v for m, v in counts.items() if v} }")
    check("[max-routes] int8 matmul max, the two routes",
          bits_equal(*got.values()), "bit-equal (the same tensor-core sums "
          "in the same order)")
    ok, detail = mm_max_held(got["gather_matmul_max_int8_kfold"], xq, w, idx,
                             nbr_mask)
    check("[max-routes] gather_matmul_max_int8_kfold", ok, detail)
    res["gather_matmul_max_int8_kfold"]["max_abs_err"] = max_err(
        got["gather_matmul_max_int8_kfold"].float(),
        ops.gather_matmul_max_int8_plain(xq, w, idx, nbr_mask).float())
    t = {cs: (median_ms(lambda: gm._gather_matmul_max_int8(
        xq, w, idx, nbr_mask, cs)), device_ms(
            lambda: gm._gather_matmul_max_int8(xq, w, idx, nbr_mask, cs), 5))
         for cs in (None, 0)}
    pl = median_ms(lambda: ops.gather_matmul_max_int8_plain(
        xq, w, idx, nbr_mask), 5)
    bd = res["gather_matmul_max_int8"]["bound"]
    print(f"  gather_matmul_max_int8 B={B} N={N} K={K} {MM_IN}->{MM_OUT}: "
          f"one product a row (slice "
          f"{gm.mm_slice(B, N, MM_IN, MM_OUT, K, 132, 1)}) {t[None][0]:.4f} "
          f"ms ({t[None][1]:.4f} ms of device time); K-fold "
          f"{t[0][0]:.4f} ({t[0][1]:.4f}); plain {pl:.4f}; bound "
          f"{bd[0]:.4f} ms ({bd[1]})", flush=True)
    res["gather_matmul_max_int8_kfold"].update(
        ms=t[0][0], plain_ms=pl, bound=bd,
        library_ms=res["gather_matmul_max_int8"]["library_ms"])


def same_values(got, want) -> bool:
    """Bit-equal but where both are NaN (its payload is not held)."""
    nan = torch.isnan(got.float())
    return bool(torch.equal(nan, torch.isnan(want.float()))) and bits_equal(
        torch.where(nan, 0.0, got.float()).to(got.dtype),
        torch.where(nan, 0.0, want.float()).to(want.dtype))


def zero_row_inputs(h, idx, mask):
    """``(h, idx, mask)`` for a plain version where ids outside [0, N)
    gather 0: ``h`` with a zero row appended, those ids pointed at it,
    and a point with no valid slot (its outputs dropped after)."""
    b, n, c = h.shape
    hp = torch.cat([h, torch.zeros((b, 1, c), dtype=h.dtype,
                                   device=h.device)], dim=1)
    ids = torch.where((idx < 0) | (idx >= n), n, idx)
    ids = torch.cat([ids, torch.zeros_like(ids[:, :1])], dim=1)
    valid = torch.cat([mask, torch.zeros_like(mask[:, :1])], dim=1)
    return hp, ids, valid


def affine_want(h, idx, mask, aff, sub_self):
    """``gather_max_affine_plain`` where ids outside [0, N) gather 0 (the
    self row's too; :func:`zero_row_inputs`)."""
    from deltaconv_tpu_torch import ops

    return ops.gather_max_affine_plain(*zero_row_inputs(h, idx, mask), aff,
                                       sub_self)[:, :h.shape[1]]


def affine_routes_phase(res, rng, dev, card):
    """``[affine-routes]``: the bf16 eval max (``gather_max_affine``) at
    the shapes and widths where the bf16 forwards run it (AFFINE_SHAPES,
    AFFINE_WIDTHS), on ellipsoid clouds' kNN graphs and on the same graph
    with hard rows (no valid slot, a masked slot 0, ids outside the cloud
    in slot 0 and in a later slot) and a NaN feature: route S (by shape,
    the affine rows read from device memory) and route D (``gather_max_affine_direct``, forced)
    bit-equal to the plain version (a NaN's payload aside) and across two
    calls, each call's launch on its route; then on the kNN graph each
    timed by CUDA events and in device time beside the plain version, the
    library composition (``index`` + ``amax``, then the epilogue in torch
    ops) and the bound (h, idx, mask, aff read once, out written once).
    Route D is the parent tree's kernel, unchanged. Its clouds come from
    a generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    rng = rng.spawn(1)[0]
    print(f"[times] the bf16 eval max by route: S (the slice staged, the "
          f"affine rows from device memory) and D (direct, the parent's "
          f"kernel); per call, CUDA events (median of {REPS} "
          f"samples of {INNER} calls) and device time (profiler); card: "
          f"{card}", flush=True)
    for label, b, n, k in AFFINE_SHAPES:
        clouds, _ = ellipsoid_clouds(rng, [n] * b)
        idx, nbr_mask = knn(torch.from_numpy(np.stack(clouds)).to(dev), k)
        hidx, hmask = idx.clone(), nbr_mask.clone()
        hmask[0, 4] = False  # no valid slot
        hmask[0, 6, 0] = False  # a masked slot 0: still the self row
        hidx[0, 5, 0] = n + 3  # slot 0 outside the cloud
        hidx[-1, 9, 0], hmask[-1, 9, 0] = -2, False
        hidx[-1, 6, k - 1], hmask[-1, 6, k - 1] = -1, True
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()
        valid = nbr_mask.any(dim=-1, keepdim=True)
        for c, sub_self in AFFINE_WIDTHS:
            h = torch.randn((b, n, c), device=dev).to(torch.bfloat16)
            hard = h.clone()
            hard[-1, 7, c // 2] = float("nan")
            aff = random_affine(c, dev)
            routes = {"S": None, "D": (0, 0)}
            for graph, gi, gmk, hh in (("kNN", idx, nbr_mask, h),
                                       ("hard rows", hidx, hmask, hard)):
                want = affine_want(hh, gi, gmk, aff, sub_self)
                for tag, route in routes.items():
                    name = "gather_max_affine" + ("_direct" if tag == "D"
                                                  else "")
                    reset_launch_counts()
                    got = gm._gather_max_affine(hh, gi, gmk, aff, sub_self,
                                                route)
                    again = gm._gather_max_affine(hh, gi, gmk, aff, sub_self,
                                                  route)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                    check(f"[affine-routes] {label} C={c} sub_self="
                          f"{sub_self} {graph}, route {tag}",
                          same_values(got, want) and bits_equal(got, again)
                          and counts[name] == 2
                          and sum(counts.values()) == 2,
                          f"bit-equal to plain and across two calls, launches "
                          f"{ {m: v for m, v in counts.items() if v} }")
                    if graph == "kNN":
                        res[name]["max_abs_err"] = max(
                            res[name]["max_abs_err"],
                            max_err(got.float(), want.float()))
            t = {tag: (median_ms(lambda: gm._gather_max_affine(
                h, idx, nbr_mask, aff, sub_self, route)), device_ms(
                    lambda: gm._gather_max_affine(h, idx, nbr_mask, aff,
                                                  sub_self, route), 5))
                 for tag, route in routes.items()}
            pl = median_ms(lambda: ops.gather_max_affine_plain(
                h, idx, nbr_mask, aff, sub_self), 5)
            self_rows = h[bidx[:, :, 0], idx_l[..., 0]].float() if sub_self \
                else None
            lib = median_ms(lambda: ops.bn_lrelu_epilogue(
                h[bidx, idx_l].amax(dim=2).float(), aff, valid, self_rows))
            bd = bound(nbytes(h, idx, nbr_mask, torch.stack(aff), h))
            cs, splits = gm.max_slice(b, n, c, 2, k, 132)
            print(f"  {label} B={b} N={n} K={k} C={c} sub_self={sub_self}: "
                  f"route S ({cs} channels, {splits} blocks a task) "
                  f"{t['S'][0]:.4f} ms ({t['S'][1]:.4f} ms of device time); "
                  f"route D {t['D'][0]:.4f} ({t['D'][1]:.4f}); plain "
                  f"{pl:.4f}; library {lib:.4f}; bound {bd[0]:.4f} ms "
                  f"({bd[1]})", flush=True)
            if (b, n, c, sub_self) == (B, N, 128, False):
                res["gather_max_affine_direct"].update(
                    ms=t["D"][0], plain_ms=pl, library_ms=lib, bound=bd)
            del h, hard, want, got, again


def minmax_want(h, idx, mask):
    """``gather_minmax_win_plain`` where ids outside [0, N) gather 0
    (:func:`zero_row_inputs`)."""
    from deltaconv_tpu_torch import ops

    return tuple(o[:, :h.shape[1]] for o in ops.gather_minmax_win_plain(
        *zero_row_inputs(h, idx, mask)))


def minmax_routes_phase(res, rng, dev, card):
    """``[minmax-routes]``: the neighbour min/max (#10) at the widths of
    its hook (f32 C = 64, 128, 256, bf16 64, 128, without and with
    winners) at MINMAX_ROUTE_SHAPES, on ellipsoid clouds' kNN graphs and
    on the same graph with hard rows (no valid slot, a masked slot 0, ids
    outside the cloud in slot 0 and in the last slot, a row whose slots
    all read one row) and a NaN feature: route S (by shape, the staged
    min/max) and route D (``_direct``, forced), values and winners
    bit-equal to the plain version (a NaN's payload aside) and across two
    calls, each call's launch on its route; then on the kNN graph each
    timed by CUDA events and in device time beside the plain version, the
    library call (``index`` + ``aminmax``; with winners ``torch.max`` and
    ``torch.min``) and the bound (h, idx, mask read once, the outputs
    written once). Then the matmul min/max (#13) at 128 -> 256 at both
    shapes through the one-product-a-row route (by shape) and the K-fold
    route (``gather_matmul_minmax_kfold``, forced): held by
    ``mm_minmax_held``, the two routes bit-equal, exact sums bit-equal to
    the plain version, each timed the same way (the library call: a bf16
    ``matmul``, ``index``, ``aminmax``). Route D and the K-fold route are
    the parent tree's kernels. Its clouds come from a generator spawned
    off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    rng = rng.spawn(1)[0]
    print(f"[times] the neighbour min/max by route: S (the staged min/max, "
          f"by shape) and D (direct, the parent's kernel), and the matmul "
          f"min/max by route (one product a row, by shape; K-fold, the "
          f"parent's kernel); per call, CUDA events (median of {REPS} "
          f"samples of {INNER} calls) and device time (profiler); card: "
          f"{card}", flush=True)
    routes = {"S": None, "D": (0, 0)}
    graphs = {}
    for label, b, n, k in MINMAX_ROUTE_SHAPES:
        clouds, _ = ellipsoid_clouds(rng, [n] * b)
        idx, nbr_mask = knn(torch.from_numpy(np.stack(clouds)).to(dev), k)
        graphs[label] = idx, nbr_mask
        hidx, hmask = idx.clone(), nbr_mask.clone()
        hmask[0, 4] = False  # no valid slot
        hmask[0, 6, 0] = False  # a masked slot 0
        hidx[0, 5, 0] = n + 3  # valid, outside the cloud
        hidx[-1, 6, k - 1], hmask[-1, 6, k - 1] = -1, True
        hidx[-1, 8], hmask[-1, 8] = 7, True  # every slot one row: all tie
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()
        for dt, widths in ((torch.float32, MINMAX_WIDTHS),
                           (torch.bfloat16, MINMAX_BF16_WIDTHS)):
            sfx = "_bf16" if dt == torch.bfloat16 else ""
            for c in widths:
                h = torch.randn((b, n, c), device=dev).to(dt)
                hard = h.clone()
                hard[-1, 7, c // 2] = float("nan")
                for winners in (False, True):
                    name = f"gather_minmax{'_win' if winners else ''}{sfx}"
                    n_out = 4 if winners else 2

                    def run(route, hh=h, gi=idx, gmk=nbr_mask,
                            winners=winners):
                        if winners:
                            return gm._gather_minmax_win(hh, gi, gmk, route)
                        return gm._minmax(hh, gi, gmk, route)

                    for graph, gi, gmk, hh in (("kNN", idx, nbr_mask, h),
                                               ("hard rows", hidx, hmask,
                                                hard)):
                        want = minmax_want(hh, gi, gmk)[:n_out]
                        for tag, route in routes.items():
                            kname = name + ("_direct" if tag == "D" else "")
                            reset_launch_counts()
                            got = run(route, hh, gi, gmk)
                            again = run(route, hh, gi, gmk)
                            torch.cuda.synchronize()
                            counts = launch_counts()
                            check(f"[minmax-routes] {label} {kname} C={c} "
                                  f"{graph}, route {tag}",
                                  all(same_values(g, v) for g, v in
                                      zip(got[:2], want[:2]))
                                  and all(torch.equal(g, v) for g, v in
                                          zip(got[2:], want[2:]))
                                  and all(raw_equal(g, a)
                                          for g, a in zip(got, again))
                                  and counts[kname] == 2
                                  and sum(counts.values()) == 2,
                                  f"values{' and winners' if winners else ''}"
                                  f" bit-equal to plain and across two "
                                  f"calls, launches "
                                  f"{ {m: v for m, v in counts.items()
                                       if v} }")
                            if graph == "kNN":
                                res[kname]["max_abs_err"] = max(
                                    res[kname]["max_abs_err"],
                                    *(max_err(g.float(), v.float())
                                      for g, v in zip(got[:2], want[:2])))
                    want = minmax_want(h, idx, nbr_mask)[:n_out]
                    t = {tag: (median_ms(lambda: run(route)),
                               device_ms(lambda: run(route), 5))
                         for tag, route in routes.items()}
                    pl = median_ms(lambda: (
                        ops.gather_minmax_win_plain if winners
                        else ops.gather_minmax_plain)(h, idx, nbr_mask), 5)
                    if winners:
                        def library():
                            g = h[bidx, idx_l]
                            return torch.max(g, dim=2), torch.min(g, dim=2)
                    else:
                        def library():
                            return torch.aminmax(h[bidx, idx_l], dim=2)
                    lib = median_ms(library)
                    bd = bound(nbytes(h, idx, nbr_mask, *want))
                    cs, splits = gm.max_slice(b, n, c, h.element_size(), k,
                                              132, winners)
                    print(f"  {label} {name} B={b} N={n} K={k} C={c}: route "
                          f"S ({cs} channels, {splits} blocks a task) "
                          f"{t['S'][0]:.4f} ms ({t['S'][1]:.4f} ms of device "
                          f"time); route D {t['D'][0]:.4f} ({t['D'][1]:.4f}); "
                          f"plain {pl:.4f}; library {lib:.4f}; bound "
                          f"{bd[0]:.4f} ms ({bd[1]})", flush=True)
                    if (b, n, c) == (B, N, MINMAX_BF16_C if sfx
                                     else MINMAX_C):
                        res[name + "_direct"].update(
                            ms=t["D"][0], plain_ms=pl, library_ms=lib,
                            bound=bd)
                del h, hard

    for label, b, n, k in MINMAX_ROUTE_SHAPES:
        idx, nbr_mask = graphs[label]
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()
        x = torch.randn((b, n, MM_IN), device=dev).to(torch.bfloat16)
        w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
        xe = (torch.randint(-32, 33, (b, n, MM_IN), device=dev) / 8.0
              ).to(torch.bfloat16)
        we = (torch.randint(-16, 17, (MM_IN, MM_OUT), device=dev) / 16.0
              ).to(torch.bfloat16)
        want_e = ops.gather_matmul_minmax_plain(xe, we, idx, nbr_mask)
        got = {}
        for cs, kname in ((None, "gather_matmul_minmax"),
                          (0, "gather_matmul_minmax_kfold")):
            reset_launch_counts()
            got[cs] = gm._gather_matmul_minmax(x, w, idx, nbr_mask, cs)
            again = gm._gather_matmul_minmax(x, w, idx, nbr_mask, cs)
            exact = gm._gather_matmul_minmax(xe, we, idx, nbr_mask, cs)
            torch.cuda.synchronize()
            counts = launch_counts()
            ok, detail = mm_minmax_held(got[cs], x, w, idx, nbr_mask)
            check(f"[minmax-routes] {label} {kname} {MM_IN}->{MM_OUT}",
                  ok and all(bits_equal(g, a) for g, a in zip(got[cs], again))
                  and all(bits_equal(g, v) for g, v in zip(exact, want_e))
                  and counts[kname] == 3 and sum(counts.values()) == 3,
                  f"{detail}; a second call and exact sums bit-equal, "
                  f"launches { {m: v for m, v in counts.items() if v} }")
            res[kname]["max_abs_err"] = max(
                res[kname]["max_abs_err"],
                *(max_err(g.float(), v.float())
                  for g, v in zip(exact, want_e)))
        check(f"[minmax-routes] {label} gather_matmul_minmax, the two routes",
              all(bits_equal(a, kf) for a, kf in zip(got[None], got[0])),
              "bit-equal (the same tensor-core sums in the same order)")
        t = {cs: (median_ms(lambda: gm._gather_matmul_minmax(
            x, w, idx, nbr_mask, cs)), device_ms(
                lambda: gm._gather_matmul_minmax(x, w, idx, nbr_mask, cs), 5))
             for cs in (None, 0)}
        pl = median_ms(lambda: ops.gather_matmul_minmax_plain(
            x, w, idx, nbr_mask), 5)
        lib = median_ms(lambda: torch.aminmax(torch.matmul(x, w)[bidx, idx_l],
                                              dim=2))
        # One product a row, as gather_matmul_max's bound counts.
        bd = bound(nbytes(x, w, idx, nbr_mask, *got[None]),
                   2.0 * b * n * MM_IN * MM_OUT, BF16_TC_OPS_PER_S)
        print(f"  {label} gather_matmul_minmax B={b} N={n} K={k} "
              f"{MM_IN}->{MM_OUT}: one product a row (slice "
              f"{gm.mm_slice(b, n, MM_IN, MM_OUT, k, 132)}) "
              f"{t[None][0]:.4f} ms ({t[None][1]:.4f} ms of device time); "
              f"K-fold {t[0][0]:.4f} ({t[0][1]:.4f}); plain {pl:.4f}; "
              f"library {lib:.4f}; bound {bd[0]:.4f} ms ({bd[1]})",
              flush=True)
        if b == B:
            res["gather_matmul_minmax_kfold"].update(
                ms=t[0][0], plain_ms=pl, library_ms=lib, bound=bd)
        del x, xe


def exact_cotangents(b, n, c, dt, dev):
    """Cotangents on a 1/16 grid below 8 in magnitude: their sums at a
    (row, c) are exact in f32 (and the values in bf16) in any order, so a
    backward in f64 and one in another order give the same bits."""
    return (torch.randint(-127, 128, (b, n, c), device=dev) / 16.0).to(dt)


def bwd_routes_phase(res, rng, dev, card):
    """``[bwd-routes]``: the winner-routed backward's two routes at every
    shape and width where the model paths run it (BWD_ROUTE_SHAPES), on
    ellipsoid clouds with a uniform kNN graph and the plain max's winners:
    route S (by shape, :func:`bwd_slice`: shared-memory f64 sums) and
    route D (``_direct``, forced: global f64 atomics into a scratch)
    bit-equal to the plain version on exact-sum cotangents and to
    themselves in a second call, each call's launch on its route; both
    timed by CUDA events and in device time beside the plain version, the
    library call (``torch.gather`` of the winners' rows + ``scatter_add_``)
    and the bound (idx, winner, g read once, dh written once), then route
    S over every slice and range count that fits (the measurements behind
    ``bwd_slice``). The two-map form at C=MINMAX_C the same way. Then the
    int8 max at its forwards' shapes (INT8_ROUTE_SHAPES): route S (absmax,
    then the staged max with the quantizing epilogue) and route D
    (``gather_max_int8_direct``: the quantization in torch ops, then the
    earlier kernel) bit-equal to the plain version, timed beside it, the
    library call and the bound, and absmax alone (its record in device
    time: its events read its wrapper's host time). Route D of each is the
    parent tree's kernel, unchanged. Its clouds come from a generator
    spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    rng = rng.spawn(1)[0]
    print(f"[times] the winner-routed backward by route: S (shared f64 "
          f"sums, by shape) and D (global f64 atomics, the parent's "
          f"kernel); per call, CUDA events (median of {REPS} samples of "
          f"{INNER} calls) and device time (profiler); card: {card}",
          flush=True)
    graphs = {}

    def graph(b, n, k):
        if (b, n, k) not in graphs:
            clouds, _ = ellipsoid_clouds(rng, [n] * b)
            graphs[(b, n, k)] = knn(
                torch.from_numpy(np.stack(clouds)).to(dev), k)
        return graphs[(b, n, k)]

    def routes(label, name, hook, plain, args, n, lib, bd, record):
        """Checks and times one backward (``hook(*args, n, route)``) on
        both routes; ``record``: this shape fills the ``_direct``
        record."""
        want = plain(*args, n)
        for route, sfx in ((None, ""), ((0, 0), "_direct")):
            reset_launch_counts()
            got = hook(*args, n, route)
            again = hook(*args, n, route)
            torch.cuda.synchronize()
            counts = launch_counts()
            check(f"[bwd-routes] {label} {name}{sfx}",
                  torch.equal(got, want) and torch.equal(again, got)
                  and counts[name + sfx] == 2 and sum(counts.values()) == 2,
                  f"bit-equal to plain and across two calls, launches "
                  f"{ {m: v for m, v in counts.items() if v} }")
            res[name + sfx]["max_abs_err"] = max(
                res[name + sfx]["max_abs_err"], max_err(got, want))
        t = {sfx: (median_ms(lambda: hook(*args, n, route)),
                   device_ms(lambda: hook(*args, n, route), 5))
             for route, sfx in ((None, "S"), ((0, 0), "D"))}
        pl = median_ms(lambda: plain(*args, n), 5)
        lib_ms = median_ms(lib)
        print(f"  {label} {name}: route S {gm.bwd_slice(n, args[2].shape[-1])}"
              f" {t['S'][0]:.4f} ms ({t['S'][1]:.4f} ms of device time); "
              f"route D {t['D'][0]:.4f} ({t['D'][1]:.4f}); plain {pl:.4f}; "
              f"library {lib_ms:.4f}; bound {bd[0]:.4f} ms ({bd[1]})",
              flush=True)
        if record:
            res[name + "_direct"].update(ms=t["D"][0], plain_ms=pl,
                                         library_ms=lib_ms, bound=bd)

    for label, b, n, k, dt, widths in BWD_ROUTE_SHAPES:
        idx, nbr_mask = graph(b, n, k)
        idx_l = idx.long()
        name = "gather_max_bwd" + ("_bf16" if dt == torch.bfloat16 else "")
        for c in widths:
            h = torch.randn((b, n, c), device=dev)
            _, win = ops.gather_max_win_plain(h, idx, nbr_mask)
            g = exact_cotangents(b, n, c, dt, dev)
            args = (idx, win, g)
            bd = bound(nbytes(idx, win, g, h))  # h: dh's f32 bytes

            def lib(b=b, n=n, c=c, idx_l=idx_l, win=win, g=g):
                return torch.zeros((b, n, c), device=dev).scatter_add_(
                    1, torch.gather(idx_l, 2, win.long()), g.float())

            routes(f"{label} B={b} N={n} K={k} C={c}", name,
                   gm._gather_max_bwd, ops.gather_max_bwd_plain, args, n,
                   lib, bd, (b, n, c) == (B, N, 256))
            # Each slice over the fewest ranges that fit, and one more.
            alts = []
            for cs in gm.BWD_SLICES:
                r0 = -(-n // (gm.SMEM_MAX // gm.bwd_smem(1, cs)))
                alts += [(cs, r) for r in (r0, r0 + 1) if r0 <= 4]
            times = []
            for cs, r in alts:
                ms = device_ms(lambda: gm._gather_max_bwd(
                    idx, win, g, n, (cs, -(-n // r))), 5)
                times.append(f"{cs} x {r}: {ms:.4f}")
            print("    route S by slice (channels x ranges: device ms): "
                  + "; ".join(times), flush=True)
            del h, win, g
    idx, nbr_mask = graph(B, N, K)
    idx_l = idx.long()
    h = torch.randn((B, N, MINMAX_C), device=dev)
    _, _, wmx, wmn = ops.gather_minmax_win_plain(h, idx, nbr_mask)
    for dt in (torch.float32, torch.bfloat16):
        gmx, gmn = (exact_cotangents(B, N, MINMAX_C, dt, dev)
                    for _ in range(2))

        def lib(gmx=gmx, gmn=gmn):
            dh = torch.zeros((B, N, MINMAX_C), device=dev)
            dh.scatter_add_(1, torch.gather(idx_l, 2, wmx.long()), gmx.float())
            return dh.scatter_add_(1, torch.gather(idx_l, 2, wmn.long()),
                                   gmn.float())

        name = "gather_minmax_bwd" + ("_bf16" if dt == torch.bfloat16
                                      else "")
        routes(f"two maps B={B} N={N} K={K} C={MINMAX_C}", name,
               gm._gather_minmax_bwd, ops.gather_minmax_bwd_plain,
               (idx, wmx, gmx, wmn, gmn), N, lib,
               bound(nbytes(idx, wmx, gmx, wmn, gmn, h)), True)

    print(f"[times] the int8 max by route: S (absmax, then the staged max "
          f"with the quantizing epilogue) and D (torch quantization, then "
          f"the parent's kernel); card: {card}", flush=True)
    for label, b, n, k, widths in INT8_ROUTE_SHAPES:
        idx, nbr_mask = graph(b, n, k)
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()
        for c in widths:
            h = torch.randn((b, n, c), device=dev).to(torch.bfloat16)
            want = ops.gather_max_int8_plain(h, idx, nbr_mask)
            for route, launched in ((None, ("absmax", "gather_max_int8")),
                                    ((0, 0), ("gather_max_int8_direct",))):
                reset_launch_counts()
                got = gm._gather_max_int8(h, idx, nbr_mask, route)
                torch.cuda.synchronize()
                counts = launch_counts()
                check(f"[bwd-routes] {label} C={c} {launched[-1]}",
                      bits_equal(got, want)
                      and all(counts[m] == 1 for m in launched)
                      and sum(counts.values()) == len(launched),
                      f"bit-equal to plain, launches "
                      f"{ {m: v for m, v in counts.items() if v} }")
                res[launched[-1]]["max_abs_err"] = max(
                    res[launched[-1]]["max_abs_err"],
                    max_err(got.float(), want.float()))
            t = {sfx: (median_ms(lambda: gm._gather_max_int8(
                h, idx, nbr_mask, route)), device_ms(
                    lambda: gm._gather_max_int8(h, idx, nbr_mask, route), 5))
                 for route, sfx in ((None, "S"), ((0, 0), "D"))}
            amax = gm.absmax(h)
            t_abs = (median_ms(lambda: gm.absmax(h)),
                     device_ms(lambda: gm.absmax(h), 5))
            pl = median_ms(lambda: ops.gather_max_int8_plain(
                h, idx, nbr_mask), 5)
            lib_ms = median_ms(lambda: int8_library_max(h, bidx, idx_l))
            bd = bound(nbytes(h, idx, nbr_mask, want))
            print(f"  {label} gather_max_int8 B={b} N={n} K={k} C={c} bf16: "
                  f"route S {gm.max_slice(b, n, c, 2, k, 132)} "
                  f"{t['S'][0]:.4f} ms ({t['S'][1]:.4f} ms of device time; "
                  f"absmax {t_abs[0]:.4f}, {t_abs[1]:.4f}); route D "
                  f"{t['D'][0]:.4f} ({t['D'][1]:.4f}); plain {pl:.4f}; "
                  f"library {lib_ms:.4f}; bound {bd[0]:.4f} ms ({bd[1]})",
                  flush=True)
            if (b, n, k, c) == (B, N, K, 128):
                res["gather_max_int8_direct"].update(
                    ms=t["D"][0], plain_ms=pl, library_ms=lib_ms, bound=bd)
                # In device time: one launch, whose wrapper's host time
                # (~0.04 ms) is all its events read.
                res["absmax"].update(
                    ms=t_abs[1], plain_ms=device_ms(lambda: gm.absmax_plain(
                        h), 5), bound=bound(nbytes(h, amax)),
                    library_ms=device_ms(lambda: torch.linalg.vector_norm(
                        h, float("inf"), dim=(1, 2)), 5))
                print(f"  absmax B={b} N={n} C={c} bf16, device time: kernel "
                      f"{t_abs[1]:.4f} ms, plain "
                      f"{res['absmax']['plain_ms']:.4f}, library "
                      f"{res['absmax']['library_ms']:.4f} (vector_norm of "
                      f"the bf16 features)", flush=True)


def wls_routes_phase(res, rng, dev, card):
    """``[wls-routes]``: the WLS forward (#3) at WLS_SHAPES and its VJP
    (#4) at WLS_BWD_SHAPES on ellipsoid clouds' kNN graphs (cloud 0 40%
    padded), through the split route (by shape, ``wls_split``) and the
    direct route (forced): the forward within WLS_ATOL of the plain
    version, each VJP plane within WLS_BWD_REL x its max, a second call
    bit-equal, each call one launch of its route; then both timed by CUDA
    events and in device time beside the plain version and the bound, and
    the split route at every number of warps that holds K edges (device
    time). The direct route is the parent tree's kernel, unchanged; its
    records are at the classification shape. Its clouds come from a
    generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts

    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    rng = rng.spawn(1)[0]
    print(f"[wls-routes] the WLS forward and VJP by route: split (by "
          f"shape) and direct (the parent's kernels); per call, CUDA events "
          f"(median of {REPS} samples of {INNER} calls) and device time "
          f"(profiler); card: {card}", flush=True)
    for label, b, n, k in WLS_SHAPES:
        edges = wls_edges(rng, b, n, k, dev, masked=True)
        ctg = torch.randn((b, 2, k, n), device=dev)
        ctd = torch.randn((b, 2, k, n), device=dev)
        sides = ((False, True) if (b, n, k) in WLS_BWD_SHAPES
                 else (False,))
        for bwd in sides:
            name = "wls_bwd" if bwd else "wls"

            def run(slices, bwd=bwd, edges=edges, ctg=ctg, ctd=ctd):
                if bwd:
                    return (wf._wls_bwd(edges, ctg, ctd, 1.0, 1e-3,
                                        slices),)
                return wf._wls_kernel(edges, 1.0, 1e-3, slices)

            def plain(bwd=bwd, edges=edges, ctg=ctg, ctd=ctd):
                if bwd:
                    return (ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3),)
                return ops.wls_plain(edges, 1.0, 1e-3)

            want = plain()
            for slices, sfx in ((None, ""), (0, "_direct")):
                reset_launch_counts()
                got = run(slices)
                again = run(slices)
                torch.cuda.synchronize()
                counts = {m: v for m, v in launch_counts().items() if v}
                err = max(max_err(a, w) for a, w in zip(got, want))
                if bwd:
                    rel = _plane_rel(got[0], want[0])
                    ok, what = (rel <= WLS_BWD_REL and bool(
                        torch.isfinite(got[0]).all()),
                        f"worst plane {rel:.3e} x its max <= {WLS_BWD_REL}")
                else:
                    ok, what = (err <= WLS_ATOL,
                                f"max_abs_err {err} <= {WLS_ATOL}")
                same = all(bits_equal(a, r) for a, r in zip(got, again))
                check(f"[wls-routes] {label} {name}{sfx} B={b} N={n} K={k}",
                      ok and same and counts == {name + sfx: 2},
                      f"{what}, a second call bit-equal {same}, launches "
                      f"{counts}")
                res[name + sfx]["max_abs_err"] = max(
                    res[name + sfx]["max_abs_err"], err)
            t = {sfx: (median_ms(lambda: run(slices)),
                       device_ms(lambda: run(slices), 5))
                 for slices, sfx in ((None, "split"), (0, "direct"))}
            pl = device_ms(plain, 2)
            bd = wls_bound(edges, bwd)
            split = wf.wls_split(k)
            print(f"  {label} {name} B={b} N={n} K={k}: split ({split[0]} "
                  f"warps of {split[1]} slots) {t['split'][0]:.4f} ms "
                  f"({t['split'][1]:.4f} ms of device time); direct "
                  f"{t['direct'][0]:.4f} ({t['direct'][1]:.4f}); plain "
                  f"{pl:.4f} (device); bound {bd[0]:.4f} ms ({bd[1]})",
                  flush=True)
            if (b, n, k) == (B, N, K):
                res[name + "_direct"].update(ms=t["direct"][0], plain_ms=pl,
                                             bound=bd)
            times = [f"{s} x {-(-k // s)}: "
                     f"{device_ms(lambda: run(s), 5):.4f}"
                     for s in range(-(-k // wf.WLS_EDGES),
                                    wf.WLS_MAX_SLICES + 1)]
            print("    split by warps (warps x slots: device ms): "
                  + "; ".join(times), flush=True)
        del edges, ctg, ctd


def sum_routes_phase(res, rng, dev, card):
    """``[sum-routes]``: the streaming neighbour sum (#19) at SUM_SHAPES,
    C=SUM_C, on ellipsoid clouds' kNN graphs, uniform and masked (every
    other cloud's last 40% of points padded): route S (by shape,
    ``sum_slice``) and route D (``gather_sum_direct``, forced), each
    bit-equal to ``gather_sum_fwd_plain`` and to a second call, one launch
    of its route a call; then, on the uniform graph, both timed by CUDA
    events and in device time beside the plain version, the library call
    (``index`` + ``sum``) and the bound (h, idx, mask read once, out
    written once). Route D is the parent tree's kernel, unchanged; its
    record is at the classification shape. Its clouds come from a
    generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    gs = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")
    rng = rng.spawn(1)[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[sum-routes] the streaming neighbour sum by route: S (a staged "
          f"slice, by shape) and D (direct, the parent's kernel); per call, "
          f"CUDA events (median of {REPS} samples of {INNER} calls) and "
          f"device time (profiler); card: {card}", flush=True)
    for label, b, n, k in SUM_SHAPES:
        clouds, _ = ellipsoid_clouds(rng, [n] * b)
        pos = torch.from_numpy(np.stack(clouds)).to(dev)
        pmask = torch.ones((b, n), dtype=torch.bool, device=dev)
        pmask[::2, int(0.6 * n):] = False
        h = torch.randn((b, n, SUM_C), device=dev)
        for graph, pm in (("masked", pmask), ("uniform", None)):
            idx, nbr_mask = knn(pos, k, pm)
            if pm is not None:
                nbr_mask = nbr_mask & pm[:, :, None]
            want = ops.gather_sum_fwd_plain(h, idx, nbr_mask)
            for route, sfx in ((None, ""), ((0, 0), "_direct")):
                reset_launch_counts()
                got = gs._gather_sum_fwd(h, idx, nbr_mask, route)
                again = gs._gather_sum_fwd(h, idx, nbr_mask, route)
                torch.cuda.synchronize()
                counts = {m: v for m, v in launch_counts().items() if v}
                same = bits_equal(got, want) and bits_equal(again, got)
                check(f"[sum-routes] {label} {graph} gather_sum{sfx} B={b} "
                      f"N={n} K={k} C={SUM_C}",
                      same and counts == {"gather_sum" + sfx: 2},
                      f"bit-equal to the plain version and across two calls "
                      f"{same}, launches {counts}")
                res["gather_sum" + sfx]["max_abs_err"] = max(
                    res["gather_sum" + sfx]["max_abs_err"],
                    max_err(got, want))
            del want, got, again
        # The uniform graph: every slot valid, the library call's case.
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()

        def run(route, idx=idx, nbr_mask=nbr_mask, h=h):
            return gs._gather_sum_fwd(h, idx, nbr_mask, route)

        def plain(idx=idx, nbr_mask=nbr_mask, h=h):
            return ops.gather_sum_fwd_plain(h, idx, nbr_mask)

        def library(idx_l=idx_l, bidx=bidx, h=h):
            return h[bidx, idx_l].sum(dim=2)

        t = {sfx: (median_ms(lambda: run(route)),
                   device_ms(lambda: run(route), 5))
             for route, sfx in ((None, "S"), ((0, 0), "D"))}
        pl = (median_ms(plain, 5), device_ms(plain, 2))
        lib = (median_ms(library), device_ms(library, 5))
        bd = bound(nbytes(h, idx, nbr_mask, h))
        cs, splits = gs.sum_slice(b, n, SUM_C, k, sms)
        print(f"  {label} gather_sum B={b} N={n} K={k} C={SUM_C}: route S "
              f"({cs} channels, {splits} blocks a task) {t['S'][0]:.4f} ms "
              f"({t['S'][1]:.4f} ms of device time); route D (the parent's "
              f"kernel) {t['D'][0]:.4f} ({t['D'][1]:.4f}); plain "
              f"{pl[0]:.4f} ({pl[1]:.4f}); library {lib[0]:.4f} "
              f"({lib[1]:.4f}); bound {bd[0]:.4f} ms ({bd[1]})", flush=True)
        if (b, n, k, SUM_C) == (B, N, K, RECORD_WIDTH["gather_sum_direct"]):
            res["gather_sum_direct"].update(ms=t["D"][0], plain_ms=pl[0],
                                            library_ms=lib[0], bound=bd)
        # Every slice that fits, one block a task and the chooser's split
        # for it: the measurements behind sum_slice's rule.
        gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
        alts = []
        for rb in gm.MAX_ROW_BYTES:
            if gm.max_smem(n, rb) > gm.SMEM_MAX or (
                    rb > 16 and rb // 2 >= SUM_C * 4):
                continue
            most = -(-n // gm.MAX_SPLIT_POINTS)
            fill = max(1, min(sms // (b * -(-SUM_C * 4 // rb)), most))
            alts += [(rb // 4, sp) for sp in sorted({1, fill})]
        times = [f"{a} x {sp}: {device_ms(lambda: run((a, sp)), 5):.4f}"
                 for a, sp in alts]
        print("    route S by slice (channels x blocks a task: device ms): "
              + "; ".join(times), flush=True)
        # The same bytes of idx and mask, every slot the point itself:
        # consecutive lanes read consecutive rows, no bank conflict.
        ident = torch.arange(n, dtype=torch.int32, device=dev)[
            None, :, None].expand(b, n, k).contiguous()
        t_id = device_ms(lambda: run(None, ident, nbr_mask), 5)
        print(f"    route S on the identity graph (every slot the point "
              f"itself; the kNN graph's bank conflicts gone): {t_id:.4f} "
              f"ms of device time", flush=True)
        del h, pos, idx, nbr_mask, ident


def wls_direct_phase(rng, dev):
    """``[wls-direct]``: WLS_DIRECT_B clouds of N points with
    WLS_DIRECT_K neighbours, above the split route's edges: ``ops.wls``
    on planes that require grad and its backward launch ``wls_direct`` and
    ``wls_bwd_direct`` once each and the split kernels never, the forward
    within WLS_ATOL of the plain version and the planes' cotangents each
    within WLS_BWD_REL x its max; and ``ops.fused_gather_wls`` at the same
    K (its neighbour mask 20% masked, slot 0 kept) launches
    ``fused_gather_wls_direct`` once and the split route never, within
    FUSED_REL x max of its plain version. Its clouds come from generators
    spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import build_tangent_basis

    rng, frng = rng.spawn(2)
    edges = wls_edges(rng, WLS_DIRECT_B, N, WLS_DIRECT_K, dev, masked=True)
    ctg = torch.randn((WLS_DIRECT_B, 2, WLS_DIRECT_K, N), device=dev)
    ctd = torch.randn_like(ctg)
    clouds, normals = ellipsoid_clouds(frng, [N] * WLS_DIRECT_B)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    idx, md = ops.knn_topk(pos, WLS_DIRECT_K, True, return_mean_dist=True)
    fmask = torch.from_numpy(frng.random(idx.shape) > 0.2).to(dev)
    fmask[:, :, 0] = True
    fused_args = (pos, nrm, *build_tangent_basis(nrm), idx, fmask,
                  md.mean(dim=1).contiguous())
    reset_launch_counts()
    e = edges.clone().requires_grad_()
    g, d = ops.wls(e, 1.0, 1e-3)
    torch.autograd.backward((g, d), (ctg, ctd))
    fused = ops.fused_gather_wls(*fused_args)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[wls-direct] launches, K={WLS_DIRECT_K}: "
          f"{ {m: c for m, c in counts.items() if c} }")
    check(f"[wls-direct] K={WLS_DIRECT_K}: the direct route once each, the "
          f"split route never",
          counts["wls_direct"] == 1 and counts["wls_bwd_direct"] == 1
          and counts["wls"] == 0 and counts["wls_bwd"] == 0,
          f"{counts['wls_direct']}, {counts['wls_bwd_direct']}, "
          f"{counts['wls']}, {counts['wls_bwd']}")
    gp, dp = ops.wls_plain(edges, 1.0, 1e-3)
    err = max(max_err(g, gp), max_err(d, dp))
    rel = _plane_rel(e.grad, ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3))
    check(f"[wls-direct] K={WLS_DIRECT_K} against the plain versions",
          err <= WLS_ATOL and rel <= WLS_BWD_REL,
          f"forward max_abs_err {err} <= {WLS_ATOL}, VJP worst plane "
          f"{rel:.3e} x its max <= {WLS_BWD_REL}")
    want = ops.fused_gather_wls_plain(*fused_args)
    rel = max(max_err(a, r) / max(float(r.abs().max()), 1e-30)
              for a, r in zip(fused, want))
    check(f"[wls-direct] K={WLS_DIRECT_K}: fused_gather_wls on the direct "
          f"route once, the split route never, against the plain version",
          counts["fused_gather_wls_direct"] == 1
          and counts["fused_gather_wls"] == 0 and rel <= FUSED_REL,
          f"{counts['fused_gather_wls_direct']}, "
          f"{counts['fused_gather_wls']}, {rel:.3e} x max <= {FUSED_REL}")
    return counts


def max_direct_phase(rng, dev):
    """``[max-direct]``: one cloud of MAX_DIRECT_N points, above route
    S's limits (no slice of 16-byte rows fits a block; the backward's
    sums would need more than two ranges of rows): ``ops.gather_max`` on
    f32 and bf16 features, without grad and with grad (forward and
    backward), ``ops.gather_minmax`` without grad and with grad (forward
    and backward) and ``ops.gather_max_int8`` launch each body's route D
    kernels once and route S never, and
    ``ops.gather_max_affine`` (bf16, with and without the self row)
    ``gather_max_affine_direct`` twice, and ``ops.gather_sum`` (f32) without
    and with grad (the streaming route: above the adjacency budget)
    ``gather_sum_direct`` twice and its route S never, bit-equal to the
    plain versions (the backwards sum in f64: bit-equal too). Its cloud
    comes from a generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    rng = rng.spawn(1)[0]
    clouds, _ = ellipsoid_clouds(rng, [MAX_DIRECT_N])
    idx, nbr_mask = knn(torch.from_numpy(np.stack(clouds)).to(dev), K)
    torch.cuda.synchronize()
    total = dict.fromkeys(MAX_DIRECT_KERNELS, 0)
    for dt in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        h = torch.randn((1, MAX_DIRECT_N, 64), device=dev).to(dt)
        g = torch.randn((1, MAX_DIRECT_N, 64), device=dev).to(dt)
        g2 = torch.randn((1, MAX_DIRECT_N, 64), device=dev).to(dt)
        reset_launch_counts()
        out = ops.gather_max(h, idx, nbr_mask)
        hg = h.clone().requires_grad_()
        out_g = ops.gather_max(hg, idx, nbr_mask)
        out_g.backward(g)
        minmax = ops.gather_minmax(h, idx, nbr_mask)
        hm = h.clone().requires_grad_()
        mx, mn = ops.gather_minmax(hm, idx, nbr_mask)
        torch.autograd.backward((mx, mn), (g, g2))
        q = ops.gather_max_int8(h, idx, nbr_mask)
        aff = random_affine(64, dev)
        eval_max = ([ops.gather_max_affine(h, idx, nbr_mask, aff, sub_self)
                     for sub_self in (False, True)]
                    if dt == torch.bfloat16 else [])
        sums = []
        if dt == torch.float32:
            hs = h.clone().requires_grad_()
            sums = [ops.gather_sum(h, idx, nbr_mask),
                    ops.gather_sum(hs, idx, nbr_mask)]
            sums[1].backward(g)
        torch.cuda.synchronize()
        counts = launch_counts()
        hp = h.clone().requires_grad_()
        want = ops.gather_max_plain(hp, idx, nbr_mask)
        want.backward(g)
        hmp = h.clone().requires_grad_()
        torch.autograd.backward(ops.gather_minmax_plain(hmp, idx, nbr_mask),
                                (g, g2))
        print(f"[max-direct] launches, N={MAX_DIRECT_N} {str(dt)[6:]}: "
              f"{ {n: c for n, c in counts.items() if c} }")
        direct = (f"gather_max{sfx}_direct", f"gather_max_win{sfx}_direct",
                  f"gather_max_bwd{sfx}_direct",
                  f"gather_minmax{sfx}_direct",
                  f"gather_minmax_win{sfx}_direct",
                  f"gather_minmax_bwd{sfx}_direct", "gather_max_int8_direct")
        staged = (f"gather_max{sfx}", f"gather_max_win{sfx}",
                  f"gather_max_bwd{sfx}", f"gather_minmax{sfx}",
                  f"gather_minmax_win{sfx}", f"gather_minmax_bwd{sfx}",
                  "gather_max_int8", "absmax")
        if eval_max:
            direct += ("gather_max_affine_direct",) * 2
            staged += ("gather_max_affine",)
        sums_ok = True
        if sums:
            direct += ("gather_sum_direct",) * 2
            staged += ("gather_sum",)
            hsp = h.clone().requires_grad_()
            ops.gather_sum_plain(hsp, idx, nbr_mask).backward(g)
            want_sum = ops.gather_sum_fwd_plain(h, idx, nbr_mask)
            sums_ok = (bits_equal(sums[0], want_sum)
                       and bits_equal(sums[1].detach(), want_sum)
                       and bits_equal(hs.grad, hsp.grad))
        check(f"[max-direct] {str(dt)[6:]}: route D once each, route S "
              f"never", all(counts[m] == direct.count(m) for m in direct)
              and not any(counts[m] for m in staged),
              f"{[counts[m] for m in direct]}, {[counts[m] for m in staged]}")
        check(f"[max-direct] {str(dt)[6:]}: bit-equal",
              bits_equal(out, want.detach())
              and bits_equal(out_g.detach(), want.detach())
              and bits_equal(hg.grad, hp.grad)
              and bits_equal(hm.grad, hmp.grad)
              and all(bits_equal(a, v) for a, v in zip(
                  minmax + (mx.detach(), mn.detach()),
                  2 * ops.gather_minmax_plain(h, idx, nbr_mask)))
              and bits_equal(q, ops.gather_max_int8_plain(h, idx, nbr_mask))
              and all(bits_equal(got, ops.gather_max_affine_plain(
                  h, idx, nbr_mask, aff, sub_self))
                      for got, sub_self in zip(eval_max, (False, True)))
              and sums_ok,
              "the max forward with and without winners and its backward, "
              "the min/max forward with and without winners and its "
              "backward, the int8 max, the bf16 eval max, the neighbour sum "
              "and its backward")
        for name in MAX_DIRECT_KERNELS:
            total[name] += counts[name]
    return total


def kernel_phase(rng, dev, card):
    """Each kernel against its plain version at the main paths' shapes;
    times, bounds and library-call times at the uniform shapes."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    pos, nrm, xb, yb, cases = graph_cases(rng, dev)
    res = {name: {"max_abs_err": 0.0, "library_ms": None}
           for name in KERNEL_META}

    def record(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    table = torch.cat([pos, xb, yb], dim=-1).contiguous()
    for label, (idx, nbr_mask) in cases.items():
        print(f"[kernels] {label}", flush=True)
        got = ops.gather_rows(table, idx)
        want = ops.gather_rows_plain(table, idx)
        err = max_err(got, want)
        record("gather_rows", err)
        check("gather_rows", torch.equal(got, want), f"max_abs_err {err}")

        pm = nbr_mask.any(dim=2).to(torch.float32)
        edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm,
                            ops.gather_rows_plain)
        g, d = ops.wls(edges, 1.0, 1e-3)
        gp, dp = ops.wls_plain(edges, 1.0, 1e-3)
        err = max(max_err(g, gp), max_err(d, dp))
        scale = float(max(gp.abs().max(), dp.abs().max()))
        same = all(bits_equal(a, r) for a, r in zip(
            ops.wls(edges, 1.0, 1e-3), (g, d)))
        record("wls", err)
        check("wls", err <= WLS_ATOL and same,
              f"max_abs_err {err} <= {WLS_ATOL} (max |coef| {scale}), a "
              f"second call bit-equal {same}")
        gd_k = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
        gd_p = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask,
                                        ops=ops.PLAIN_OPS)
        err = max(max_err(gd_k.grad_coef, gd_p.grad_coef),
                  max_err(gd_k.div_coef, gd_p.div_coef))
        record("wls", err)
        check("wls (normalized operator)", err <= WLS_ATOL,
              f"max_abs_err {err} <= {WLS_ATOL}")

        gc, dc = gd_p.grad_coef, gd_p.div_coef
        wg, wd = ops.densify_coefs(idx, gc, dc)
        wgp, wdp = ops.densify_coefs_plain(idx, gc, dc)
        err = max(max_err(wg, wgp), max_err(wd, wdp))
        record("densify", err)
        check("densify", err <= DENSIFY_ATOL,
              f"max_abs_err {err} <= {DENSIFY_ATOL}")
        del wg, wd, wgp, wdp

        got = ops.adjacency(idx, nbr_mask)
        want = ops.adjacency_plain(idx, nbr_mask)
        err = max_err(got, want)
        record("adjacency", err)
        check("adjacency", torch.equal(got, want), f"max_abs_err {err}")
        del got, want

        for c in WIDTHS:
            h = torch.randn((B, N, c), device=dev)
            got = ops.gather_max(h, idx, nbr_mask)
            want = ops.gather_max_plain(h, idx, nbr_mask)
            err = max_err(got, want)
            record("gather_max", err)
            check(f"gather_max C={c}", torch.equal(got, want),
                  f"max_abs_err {err}")

            out, win = ops.gather_max_win(h, idx, nbr_mask)
            out_p, win_p = ops.gather_max_win_plain(h, idx, nbr_mask)
            err = max_err(out, out_p)
            record("gather_max_win", err)
            check(f"gather_max_win C={c}",
                  torch.equal(out, out_p) and torch.equal(win, win_p),
                  f"out max_abs_err {err}, winners differ at "
                  f"{int((win != win_p).sum())}")

            g = torch.randn((B, N, c), device=dev)
            dh = ops.gather_max_bwd(idx, win_p, g, N)
            again = ops.gather_max_bwd(idx, win_p, g, N)
            dh_p = ops.gather_max_bwd_plain(idx, win_p, g, N)
            err = max_err(dh, dh_p)
            record("gather_max_bwd", err)
            check(f"gather_max_bwd C={c}",
                  torch.equal(dh, dh_p) and torch.equal(dh, again),
                  f"max_abs_err {err}, bit-equal to plain and across two "
                  f"calls")

            got = ops.gather_sum_fwd(h, idx, nbr_mask)
            want = ops.gather_sum_fwd_plain(h, idx, nbr_mask)
            err = max_err(got, want)
            record("gather_sum", err)
            check(f"gather_sum C={c}", torch.equal(got, want),
                  f"max_abs_err {err}")

            dh = ops.gather_sum_bwd(idx, nbr_mask, g)
            dh_p = ops.gather_sum_bwd_plain(idx, nbr_mask, g)
            err = max_err(dh, dh_p)
            record("gather_sum_bwd", err)
            check(f"gather_sum_bwd C={c}", bits_equal(dh, dh_p) and
                  bits_equal(ops.gather_sum_bwd(idx, nbr_mask, g), dh),
                  f"bit-equal to the plain version (f64 sums rounded "
                  f"once) and across two calls, max_abs_err {err}")
        check_bf16_kernels(record, label, pos, idx, nbr_mask, gd_p, dev)
        check_bf16_train_kernels(record, idx, nbr_mask, dev)
        check_int8_kernels(record, idx, nbr_mask, gd_p, dev)
        check_minmax_kernels(record, idx, nbr_mask, dev)
        torch.cuda.synchronize()
    seg_cases = seg_graphs(rng, dev)
    for label, (idx, nbr_mask, seg_gd) in seg_cases.items():
        print(f"[kernels] segmentation shapes B={SEG_B} N={SEG_N} "
              f"K={SEG_K}, {label}", flush=True)
        check_seg_kernels(record, idx, nbr_mask, seg_gd, dev)
        check_edge_mlp_kernels(record, idx, dev)

    # Times, bounds and library calls at the uniform shapes.
    idx, nbr_mask = cases["uniform"]
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm,
                        ops.gather_rows_plain)
    gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
    gc, dc = gd.grad_coef, gd.div_coef
    h128 = torch.randn((B, N, 128), device=dev).to(torch.bfloat16)
    aff128 = random_affine(128, dev)
    x = torch.randn((B, N, MM_IN), device=dev).to(torch.bfloat16)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    aff256 = random_affine(MM_OUT, dev)
    xq, _ = ops.int8_quantize(x)
    timed = {
        "gather_rows": (lambda: ops.gather_rows(table, idx),
                        lambda: ops.gather_rows_plain(table, idx)),
        "wls": (lambda: ops.wls(edges, 1.0, 1e-3),
                lambda: ops.wls_plain(edges, 1.0, 1e-3)),
        "densify": (lambda: ops.densify_coefs(idx, gc, dc),
                    lambda: ops.densify_coefs_plain(idx, gc, dc)),
        "densify_bf16": (
            lambda: ops.densify_coefs(idx, gc, dc, torch.bfloat16),
            lambda: ops.densify_coefs_plain(idx, gc, dc, torch.bfloat16)),
        "adjacency": (lambda: ops.adjacency(idx, nbr_mask),
                      lambda: ops.adjacency_plain(idx, nbr_mask)),
        "knn_topk": (lambda: ops.knn_topk(pos, K, True),
                     lambda: ops.knn_topk_plain(pos, K, True)),
        "gather_max_affine": (
            lambda: ops.gather_max_affine(h128, idx, nbr_mask, aff128),
            lambda: ops.gather_max_affine_plain(h128, idx, nbr_mask,
                                                aff128)),
        "gather_matmul_max": (
            lambda: ops.gather_matmul_max(x, w, idx, nbr_mask, aff256),
            lambda: ops.gather_matmul_max_plain(x, w, idx, nbr_mask,
                                                aff256)),
        "gather_matmul_max_win": (
            lambda: ops.gather_matmul_max_win(x, w, idx, nbr_mask),
            lambda: ops.gather_matmul_max_win_plain(x, w, idx, nbr_mask)),
        "densify_int8": (
            lambda: ops.densify_coefs_int8(idx, gc, dc),
            lambda: ops.densify_coefs_int8_plain(idx, gc, dc)),
        "gather_max_int8": (
            lambda: ops.gather_max_int8(h128, idx, nbr_mask),
            lambda: ops.gather_max_int8_plain(h128, idx, nbr_mask)),
        "gather_matmul_max_int8": (
            lambda: ops.gather_matmul_max_int8(xq, w, idx, nbr_mask),
            lambda: ops.gather_matmul_max_int8_plain(xq, w, idx, nbr_mask)),
    }
    print(f"[times] per call, median of {REPS} CUDA-event samples of "
          f"{INNER} back-to-back calls, B={B} N={N} K={K}, card: {card}")
    for name, (fk, fp) in timed.items():
        res[name]["ms"] = median_ms(fk)
        res[name]["plain_ms"] = median_ms(fp)
        print(f"  {name}: kernel {res[name]['ms']:.4f} ms, "
              f"plain {res[name]['plain_ms']:.4f} ms")
    t_out = ops.gather_rows(table, idx)
    res["gather_rows"]["bound"] = bound(nbytes(table, idx, t_out))
    res["wls"]["bound"] = bound(nbytes(edges, *ops.wls(edges, 1.0, 1e-3)))
    for name, dt in (("densify", torch.float32),
                     ("densify_bf16", torch.bfloat16)):
        res[name]["bound"] = bound(nbytes(
            idx, gc, dc, *ops.densify_coefs(idx, gc, dc, dt)))
    res["adjacency"]["bound"] = bound(nbytes(
        idx, nbr_mask, ops.adjacency(idx, nbr_mask)))
    # The work the function needs, not the kernel's K selection sweeps.
    res["knn_topk"]["bound"] = bound(
        nbytes(pos, ops.knn_topk(pos, K, True)),
        float(B) * N * N * KNN_INSTR_PER_PAIR, ISSUE_PER_S)
    res["gather_max_affine"]["bound"] = bound(nbytes(
        h128, idx, nbr_mask, torch.stack(aff128), h128))
    # Row j's x_j @ w is the same whichever point gathers it, so the
    # function needs one product per row (the kernel does K: the TPU's
    # gather-then-matmul form).
    res["gather_matmul_max"]["bound"] = bound(
        nbytes(x, w, idx, nbr_mask, torch.stack(aff256),
               torch.empty((B, N, MM_OUT), dtype=torch.bfloat16,
                           device=dev)),
        2.0 * B * N * MM_IN * MM_OUT, BF16_TC_OPS_PER_S)
    res["gather_matmul_max_win"]["bound"] = bound(
        nbytes(x, w, idx, nbr_mask,
               *ops.gather_matmul_max_win(x, w, idx, nbr_mask)),
        2.0 * B * N * MM_IN * MM_OUT, BF16_TC_OPS_PER_S)
    # The int8 form: each input read once (the quantized coefficients'
    # per-cloud maxima, and the features' quantization, are part of the
    # function), each output written once.
    res["densify_int8"]["bound"] = bound(nbytes(
        idx, gc, dc, *ops.densify_coefs_int8(idx, gc, dc)))
    res["gather_max_int8"]["bound"] = bound(nbytes(
        h128, idx, nbr_mask, h128))
    res["gather_matmul_max_int8"]["bound"] = bound(
        nbytes(xq, w, idx, nbr_mask,
               ops.gather_matmul_max_int8(xq, w, idx, nbr_mask)),
        2.0 * B * N * MM_IN * MM_OUT, BF16_TC_OPS_PER_S)

    # PyTorch library calls that compute the same function, where there
    # are, each with its set-up timed too: zero fill, scatter_add_ in f32
    # (both operators as the four planes of one [B, 4, N, N] tensor) and,
    # for bf16, the cast; the score plane and topk for the kNN.
    index4 = idx.long()[:, None].expand(B, 4, N, K)
    coef4 = torch.cat([gc, dc], dim=-1).permute(0, 3, 1, 2).contiguous()
    res["densify"]["library_ms"] = median_ms(
        lambda: torch.zeros((B, 4, N, N), device=dev).scatter_add_(
            3, index4, coef4))
    res["densify_bf16"]["library_ms"] = median_ms(
        lambda: torch.zeros((B, 4, N, N), device=dev).scatter_add_(
            3, index4, coef4).to(torch.bfloat16))

    res["densify_int8"]["library_ms"] = median_ms(
        densify_int8_library(idx, gc, dc))
    ones = nbr_mask.float()
    idx_l = idx.long()
    res["adjacency"]["library_ms"] = median_ms(
        lambda: torch.zeros((B, N, N), device=dev).scatter_add_(
            2, idx_l, ones))
    res["knn_topk"]["library_ms"] = median_ms(
        lambda: torch.topk(2.0 * torch.matmul(pos, pos.transpose(1, 2))
                           - (pos * pos).sum(-1)[:, None, :], K, dim=-1))
    for name in ("densify", "densify_bf16", "adjacency", "knn_topk",
                 "densify_int8"):
        print(f"  {name}: library call {res[name]['library_ms']:.4f} ms")
    # Back to back, each adjacency call's events take its launch gap too.
    adj_dev = device_ms(lambda: ops.adjacency(idx, nbr_mask))
    lib_dev = device_ms(lambda: torch.zeros((B, N, N), device=dev)
                        .scatter_add_(2, idx_l, ones))
    print(f"  adjacency: {adj_dev:.4f} ms of device time (profiler), "
          f"library call {lib_dev:.4f} ms")
    h64 = torch.randn((B, N, 64), device=dev).to(torch.bfloat16)
    h128f = h128.float()
    aff64 = random_affine(64, dev)
    others = {
        "knn_topk exact": (lambda: ops.knn_topk(pos, K, False),
                           lambda: ops.knn_topk_plain(pos, K, False)),
        "gather_max_affine C=64 sub_self": (
            lambda: ops.gather_max_affine(h64, idx, nbr_mask, aff64, True),
            lambda: ops.gather_max_affine_plain(h64, idx, nbr_mask, aff64,
                                                True)),
        f"gather_matmul_max {MM_IN}->{MM_OUT} without the epilogue": (
            lambda: ops.gather_matmul_max(x, w, idx, nbr_mask),
            lambda: ops.gather_matmul_max_plain(x, w, idx, nbr_mask)),
        "gather_max_int8 C=64 bf16": (
            lambda: ops.gather_max_int8(h64, idx, nbr_mask),
            lambda: ops.gather_max_int8_plain(h64, idx, nbr_mask)),
        "gather_max_int8 C=128 f32": (
            lambda: ops.gather_max_int8(h128f, idx, nbr_mask),
            lambda: ops.gather_max_int8_plain(h128f, idx, nbr_mask)),
    }
    for label, (fk, fp) in others.items():
        print(f"  {label}: kernel {median_ms(fk):.4f} ms, plain "
              f"{median_ms(fp):.4f} ms")
    print(f"  int8_quantize of [B, N, 128] bf16 (torch ops; inside "
          f"gather_max_int8, before gather_matmul_max_int8): "
          f"{median_ms(lambda: ops.int8_quantize(h128)):.4f} ms")

    for c in WIDTHS:
        h = torch.randn((B, N, c), device=dev)
        g = torch.randn((B, N, c), device=dev)
        _, win = ops.gather_max_win_plain(h, idx, nbr_mask)
        per_width = {
            "gather_max": (lambda: ops.gather_max(h, idx, nbr_mask),
                           lambda: ops.gather_max_plain(h, idx, nbr_mask)),
            "gather_max_win": (
                lambda: ops.gather_max_win(h, idx, nbr_mask),
                lambda: ops.gather_max_win_plain(h, idx, nbr_mask)),
            "gather_max_bwd": (
                lambda: ops.gather_max_bwd(idx, win, g, N),
                lambda: ops.gather_max_bwd_plain(idx, win, g, N)),
            "gather_sum": (
                lambda: ops.gather_sum_fwd(h, idx, nbr_mask),
                lambda: ops.gather_sum_fwd_plain(h, idx, nbr_mask)),
            "gather_sum_bwd": (
                lambda: ops.gather_sum_bwd(idx, nbr_mask, g),
                lambda: ops.gather_sum_bwd_plain(idx, nbr_mask, g)),
        }
        for name, (fk, fp) in per_width.items():
            km, pl = median_ms(fk), median_ms(fp)
            outs = {
                "gather_max": (h, idx, nbr_mask, h),
                "gather_max_win": (h, idx, nbr_mask, h, win),
                "gather_max_bwd": (idx, win, g, h),
                "gather_sum": (h, idx, nbr_mask, h),
                "gather_sum_bwd": (idx, nbr_mask, g, h),
            }[name]  # inputs, then an output-sized tensor
            bd = bound(nbytes(*outs))
            print(f"  {name} C={c}: kernel {km:.4f} ms, plain {pl:.4f} ms, "
                  f"bound {bd[0]:.4f} ms ({bd[1]})")
            if c == RECORD_WIDTH[name]:
                res[name]["ms"], res[name]["plain_ms"] = km, pl
                res[name]["bound"] = bd
    # The bf16 bodies of the train step's neighbour max and its backward.
    for c in BWD_BF16_WIDTHS:
        h = torch.randn((B, N, c), device=dev).to(torch.bfloat16)
        g = torch.randn((B, N, c), device=dev).to(torch.bfloat16)
        out, win = ops.gather_max_win_plain(h, idx, nbr_mask)
        per_width = {"gather_max_bwd_bf16": (
            lambda: ops.gather_max_bwd(idx, win, g, N),
            lambda: ops.gather_max_bwd_plain(idx, win, g, N),
            (idx, win, g, torch.empty((B, N, c), device=dev)))}
        if c in TRAIN_BF16_WIDTHS:
            per_width["gather_max_win_bf16"] = (
                lambda: ops.gather_max_win(h, idx, nbr_mask),
                lambda: ops.gather_max_win_plain(h, idx, nbr_mask),
                (h, idx, nbr_mask, out, win))
        for name, (fk, fp, io) in per_width.items():
            km, pl = median_ms(fk), median_ms(fp)
            print(f"  {name} C={c}: kernel {km:.4f} ms, plain {pl:.4f} ms")
            if c == RECORD_WIDTH[name]:
                res[name]["ms"], res[name]["plain_ms"] = km, pl
                res[name]["bound"] = bound(nbytes(*io))
    time_library_calls(res, table, idx, nbr_mask, aff128, x, w, aff256, xq,
                       dev)
    time_narrow_scatter(table, idx, card)
    time_minmax_kernels(res, idx, nbr_mask, dev)
    time_seg_kernels(res, *seg_cases["uniform"][:2], dev, card)
    time_edge_mlp_kernels(res, seg_cases["uniform"][0], dev, card)
    matmul_max_phase(res, rng, dev, card)
    max_routes_phase(res, rng, dev, card)
    affine_routes_phase(res, rng, dev, card)
    minmax_routes_phase(res, rng, dev, card)
    bwd_routes_phase(res, rng, dev, card)
    wls_routes_phase(res, rng, dev, card)
    del seg_cases, cases
    knn_kernel_phase(res, rng, dev, card)
    coef_kernel_phase(res, rng, dev, card)
    shard_kernel_phase(res, rng, card)
    build_bwd_kernel_phase(res, rng, dev, card)
    sum_routes_phase(res, rng, dev, card)
    print(f"  (the JSON record gives each at its width: {RECORD_WIDTH}, "
          f"gather_max_affine at C=128, gather_matmul_max, "
          f"gather_matmul_max_win, gather_matmul_max_int8 and "
          f"gather_matmul_minmax at {MM_IN}->{MM_OUT}; gather_max_int8 on "
          f"bf16 features; gather_minmax, gather_minmax_win and both "
          f"gather_minmax_bwd bodies at C={MINMAX_C}, the bf16 forwards at "
          f"C={MINMAX_BF16_C}; gather_mlp_max at the segmentation conv0, "
          f"mlp_rows and gather_max_merge at conv2)")
    for name, r in res.items():
        print(f"  {name}: bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"kernel at {r['bound'][0] / r['ms']:.3f} of it")
    return res


def random_model(seed, dev, dropout=0.5, affine=True, knn_method="exact",
                 precision=None, dense_operators=True, **arch):
    """The reference-width classifier with seeded weights and randomized
    BatchNorm statistics and, when ``affine``, scales (both signs) and
    biases; ``precision`` ("bfloat16") sets both dtypes;
    ``dense_operators=False`` is the large-cloud coefficient form (the
    same weights); ``arch``: other constructor arguments (``RECIPE``)."""
    from deltaconv_tpu_torch import DeltaNetClassification
    from deltaconv_tpu_torch.nn import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    arch = {"num_classes": NUM_CLASSES, **arch}
    model = DeltaNetClassification(dropout=dropout, knn_method=knn_method,
                                   dense_operators=dense_operators,
                                   generator=gen, **arch)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                if affine:
                    m.weight.uniform_(-1.5, 1.5, generator=gen)
                    m.bias.normal_(0.0, 0.2, generator=gen)
    model.set_precision(precision, precision)
    return model.to(dev)


def serving_clouds(rng):
    """64 uniform clouds, then 10 ragged ones (600..1023 points) and one
    full cloud, the first of the uniform ones."""
    uni, uni_n = ellipsoid_clouds(rng, [N] * 64)
    sizes = rng.integers(N * 600 // 1024, N, 10).tolist()
    rag, rag_n = ellipsoid_clouds(rng, sizes)
    return uni, uni_n, rag + uni[:1], rag_n + uni_n[:1]


def serve_phase(rng, seed, dev, card):
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    model = random_model(seed, dev)
    engine = InferenceEngine(model, num_points=N, batch_size=B)
    plain = InferenceEngine(model, num_points=N, batch_size=B,
                            ops=PLAIN_OPS)
    uni, uni_n, rag, rag_n = serving_clouds(rng)

    engine.predict(uni[:B], uni_n[:B])  # warm-up: library, cuBLAS
    torch.cuda.synchronize()

    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits_u = engine.predict(uni, uni_n)
        times.append(time.perf_counter() - t0)
    logits_r = engine.predict(rag, rag_n)
    counts = launch_counts()
    print(f"[serve] launches during serving: {counts}")

    print("[serve] checks")
    check("uniform logits", logits_u.shape == (64, NUM_CLASSES)
          and bool(np.isfinite(logits_u).all()), f"shape {logits_u.shape}")
    check("ragged logits", logits_r.shape == (11, NUM_CLASSES)
          and bool(np.isfinite(logits_r).all()), f"shape {logits_r.shape}")
    for name in SERVE_KERNELS:
        check(f"{name} launched", counts[name] > 0,
              f"{counts[name]} launches")
    ref_u = plain.predict(uni, uni_n)
    ref_r = plain.predict(rag, rag_n)
    for label, got, ref in (("uniform", logits_u, ref_u),
                            ("ragged", logits_r, ref_r)):
        err = float(np.abs(got - ref).max())
        same = bool((got.argmax(1) == ref.argmax(1)).all())
        check(f"{label} kernel vs plain", err <= LOGIT_ATOL and same,
              f"max_abs_err {err} <= {LOGIT_ATOL}, argmax equal {same}")
    err = float(np.abs(logits_r[-1] - logits_u[0]).max())
    check("full cloud ragged vs uniform", err <= LOGIT_ATOL,
          f"max_abs_err {err} <= {LOGIT_ATOL}")

    t = float(np.median(times))
    n_batches = 64 // B
    print(f"[serve] 64 uniform clouds (N={N}, batch {B}): median "
          f"{t * 1e3:.3f} ms per call of {n_batches} batches, "
          f"{t * 1e3 / n_batches:.3f} ms per batch, {64 / t:.1f} clouds/s "
          f"(host clock, synchronised), card: {card}")
    return counts


def held_to(label, got, ref, rel, rows="clouds"):
    """Max deviation within ``rel`` x max|ref| and the argmax equal
    wherever the reference's top-2 margin exceeds twice the deviation;
    ``rows`` names what a row of logits belongs to."""
    dev_ = float(np.abs(got - ref).max())
    tol = rel * float(np.abs(ref).max())
    top2 = np.sort(ref, axis=-1)
    decisive = top2[:, -1] - top2[:, -2] > 2 * dev_
    same = bool((got.argmax(1) == ref.argmax(1))[decisive].all())
    check(label, dev_ <= tol and same,
          f"max_abs_err {dev_} <= {tol} ({dev_ / max(tol / rel, 1e-30):.3e} "
          f"x max|logit|), argmax equal on {int(decisive.sum())} of "
          f"{len(ref)} decisive {rows} {same}")


def matmul_max_once(name, counts, calls, what):
    """The bf16 matmul max ``name`` (conv3) launched once a forward or
    step through its one-product-a-row kernel, its K-fold route never."""
    check(f"{name} once a {what}, {name}_kfold never",
          counts[name] == calls and counts[f"{name}_kfold"] == 0,
          f"{counts[name]} and {counts[f'{name}_kfold']} launches in "
          f"{calls} {what}s")


def serve_lowp_phase(clouds, seed, dev, card, precision):
    """The JAX package's production serving configs, approximate kNN on
    the same random weights and clouds: bf16 compute and operators
    (``precision="bfloat16"``, ``[serve-bf16]``) or bf16 compute on int8
    operators (``"int8"``, ``[serve-int8]``)."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    tag = "serve-bf16" if precision == "bfloat16" else "serve-int8"
    path = BF16_KERNELS if precision == "bfloat16" else INT8_KERNELS
    model = random_model(seed, dev, knn_method="approx")
    engine = InferenceEngine(model, num_points=N, batch_size=B,
                             precision=precision)
    plain = InferenceEngine(model, num_points=N, batch_size=B,
                            precision=precision, ops=PLAIN_OPS)
    f32 = InferenceEngine(model, num_points=N, batch_size=B)
    uni, uni_n, rag, rag_n = clouds

    engine.predict(uni[:B], uni_n[:B])  # warm-up: cuBLAS bf16
    engine.predict(rag[:3], rag_n[:3])
    torch.cuda.synchronize()

    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits_u = engine.predict(uni, uni_n)
        times.append(time.perf_counter() - t0)
    logits_r = engine.predict(rag, rag_n)
    counts = launch_counts()
    forwards = 3 * (len(uni) // B) + 1
    print(f"[{tag}] launches during serving ({forwards} forwards): {counts}")
    print(f"[{tag}] launches per forward: " + ", ".join(
        f"{name} {counts[name] / forwards:g}" for name in path))

    print(f"[{tag}] checks")
    check("uniform logits", logits_u.shape == (64, NUM_CLASSES)
          and bool(np.isfinite(logits_u).all()), f"shape {logits_u.shape}")
    check("ragged logits", logits_r.shape == (11, NUM_CLASSES)
          and bool(np.isfinite(logits_r).all()), f"shape {logits_r.shape}")
    for name in path:
        check(f"{name} launched", counts[name] > 0,
              f"{counts[name]} launches")
    per_forward = (INT8_PER_FORWARD if precision == "int8"
                   else BF16_PER_FORWARD)
    for name, per in per_forward.items():
        check(f"{name} {per} a forward", counts[name] == per * forwards,
              f"{counts[name]} launches in {forwards} forwards")
    if precision != "int8":
        matmul_max_once("gather_matmul_max", counts, forwards, "forward")
    for label, cl, normals, got in (("uniform", uni, uni_n, logits_u),
                                    ("ragged", rag, rag_n, logits_r)):
        held_to(f"{label} kernel vs plain path", got,
                plain.predict(cl, normals), BF16_PATH_REL)
        held_to(f"{label} {precision} vs the f32 engine", got,
                f32.predict(cl, normals), BF16_REL)
    held_to("full cloud ragged (exact kNN) vs uniform (knn_topk)",
            logits_r[-1:], logits_u[:1], BF16_REL)

    t = float(np.median(times))
    print(f"[{tag}] 64 uniform clouds (N={N}, batch {B}, "
          f"knn_method=approx, precision={precision}): median "
          f"{t * 1e3:.3f} ms per call of 2 batches, {t * 1e3 / 2:.3f} ms per "
          f"batch, {64 / t:.1f} clouds/s (host clock, synchronised), card: "
          f"{card}")
    profile(tag, "one 64-cloud predict call",
            lambda: engine.predict(uni, uni_n), t * 1e3)
    return counts


def apply_times(clouds, dev, card):
    """One classification forward's operator applies (``APPLY_WIDTHS``)
    on the int8 operators (``torch._int_mm`` a cloud and plane) beside
    the bf16 ones, on the same clouds' operators, and the exact
    alternative for int8 storage: each int8 operator widened to bf16 and
    multiplied by the quantized activations in one ``bmm`` with an f32
    result (a row holds at most K nonzeros, so ``K * 127 * 127 < 2^24``
    and the f32 sums are exact: equal to the int32 ones)."""
    from deltaconv_tpu_torch import KERNEL_OPS, ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
    from deltaconv_tpu_torch.geometry.dense import densify

    pos = torch.from_numpy(np.stack(clouds[0][:B])).to(dev)
    nrm = torch.from_numpy(np.stack(clouds[1][:B])).to(dev)
    idx, nbr_mask = knn(pos, K, None, "approx", ops.knn_topk)
    xb, yb = build_tangent_basis(nrm)
    gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
    gd8 = densify(gd, KERNEL_OPS, torch.int8)
    gd16 = densify(gd, KERNEL_OPS, torch.bfloat16)

    def grad_via_bf16(x):
        xq, sx = ops.int8_quantize(x)
        acc = torch.bmm(gd8.w_grad.flatten(1, 2).to(torch.bfloat16),
                        xq.to(torch.bfloat16), out_dtype=torch.float32)
        out = acc * (gd8.op_scale_grad * sx)[:, None, None]
        return out.view(B, 2, N, -1).transpose(1, 2).to(x.dtype)

    def div_via_bf16(v):
        vq, sv = ops.int8_quantize(v)
        vq = vq.transpose(1, 2).to(torch.bfloat16)
        acc = sum(torch.bmm(gd8.w_div[:, d].to(torch.bfloat16), vq[:, d],
                            out_dtype=torch.float32) for d in (0, 1))
        return (acc * (gd8.op_scale_div * sv)[:, None, None]).to(v.dtype)

    forms = {"int8 (_int_mm a cloud)": (gd8.grad, gd8.div),
             "bf16 (bmm)": (gd16.grad, gd16.div),
             "int8 widened to bf16 (bmm)": (grad_via_bf16, div_via_bf16)}
    grads, divs = APPLY_WIDTHS
    totals = {form: 0.0 for form in forms}
    for c_g, c_d in zip(grads, divs):
        x = torch.randn((B, N, c_g), device=dev).to(torch.bfloat16)
        v = torch.randn((B, N, 2, c_d), device=dev).to(torch.bfloat16)
        check(f"int8 applies widened to bf16 equal the int32 ones, "
              f"C={c_g}/{c_d}",
              bits_equal(grad_via_bf16(x), gd8.grad(x))
              and bits_equal(div_via_bf16(v), gd8.div(v)), "bit-equal")
        line = []
        for form, (g_fn, d_fn) in forms.items():
            tg = median_ms(lambda: g_fn(x))
            td = median_ms(lambda: d_fn(v))
            totals[form] += tg + td
            line.append(f"{form} grad {tg:.4f} div {td:.4f}")
        print(f"  grad C={c_g}, div C={c_d}: " + "; ".join(line) + " ms")
    print(f"[applies] one forward's 4 grad and 4 div applies, B={B} N={N}: "
          + "; ".join(
              f"{form} {t:.4f} ms" for form, t in totals.items())
          + f"; card: {card}")


def random_seg_model(seed, dev, knn_method="exact", dense_operators=True,
                     dropout=0.5, affine=True, precision=None):
    """The ShapeNet segmentation config with seeded weights and
    randomized BatchNorm statistics and, when ``affine``, scales (both
    signs) and biases; ``dense_operators=False``: the coefficient form
    (the same weights); ``precision`` ("bfloat16") sets both dtypes."""
    from deltaconv_tpu_torch import DeltaNetSegmentation
    from deltaconv_tpu_torch.nn import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    model = DeltaNetSegmentation(
        num_classes=SEG_CLASSES, conv_channels=(64, 128, 256), mlp_depth=2,
        categorical_vector=True, num_neighbors=SEG_K, knn_method=knn_method,
        dense_operators=dense_operators, dropout=dropout, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                if affine:
                    m.weight.uniform_(-1.5, 1.5, generator=gen)
                    m.bias.normal_(0.0, 0.2, generator=gen)
    model.set_precision(precision, precision)
    return model.to(dev)


def seg_clouds(rng):
    """SEG_UNIFORM clouds of SEG_N points, then SEG_RAGGED of 1200..2047
    points and the first uniform one again, with category ids."""
    uni, uni_n = ellipsoid_clouds(rng, [SEG_N] * SEG_UNIFORM)
    sizes = rng.integers(SEG_N * 600 // 1024, SEG_N, SEG_RAGGED).tolist()
    rag, rag_n = ellipsoid_clouds(rng, sizes)
    uni_c = rng.integers(0, 16, SEG_UNIFORM).tolist()
    rag_c = rng.integers(0, 16, SEG_RAGGED).tolist() + uni_c[:1]
    return (uni, uni_n, uni_c), (rag + uni[:1], rag_n + uni_n[:1], rag_c)


def held_abs(label, got, ref, atol):
    """Max deviation within ``atol`` and the argmax equal wherever the
    reference's top-2 margin exceeds twice the deviation."""
    dev_ = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)
    decisive = top2[:, -1] - top2[:, -2] > 2 * dev_
    same = bool((got.argmax(1) == ref.argmax(1))[decisive].all())
    check(label, dev_ <= atol and same,
          f"max_abs_err {dev_} <= {atol}, argmax equal on "
          f"{int(decisive.sum())} of {len(ref)} decisive points {same}")


def serve_seg_phase(rng, seed, dev, card, precision):
    """Segmentation serving at the ShapeNet config, with categories: f32
    (exact kNN), the production config (approximate kNN, bf16) or int8
    serving (approximate kNN, bf16 compute on int8 operators)."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    tag = {None: "serve-seg", "bfloat16": "serve-seg-bf16",
           "int8": "serve-seg-int8"}[precision]
    model = random_seg_model(seed, dev, "approx" if precision else "exact")
    kw = dict(num_points=SEG_N, batch_size=SEG_B)
    engine = InferenceEngine(model, precision=precision, **kw)
    plain = InferenceEngine(model, precision=precision, ops=PLAIN_OPS, **kw)
    (uni, uni_n, uni_c), (rag, rag_n, rag_c) = seg_clouds(rng)

    engine.predict(uni[:SEG_B], uni_n[:SEG_B], uni_c[:SEG_B])  # warm-up
    engine.predict(rag[:3], rag_n[:3], rag_c[:3])
    torch.cuda.synchronize()

    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out_u = engine.predict(uni, uni_n, uni_c)
        times.append(time.perf_counter() - t0)
    out_r = engine.predict(rag, rag_n, rag_c)
    counts = launch_counts()
    forwards = 3 * (SEG_UNIFORM // SEG_B) + 1
    path = {None: SEG_KERNELS, "bfloat16": SEG_BF16_KERNELS,
            "int8": SEG_INT8_KERNELS}[precision]
    print(f"[{tag}] launches during serving ({forwards} forwards): {counts}")
    print(f"[{tag}] launches per forward: " + ", ".join(
        f"{name} {counts[name] / forwards:g}" for name in path))

    print(f"[{tag}] checks")
    check("uniform logits", [o.shape for o in out_u]
          == [(SEG_N, SEG_CLASSES)] * SEG_UNIFORM
          and all(np.isfinite(o).all() for o in out_u),
          f"{len(out_u)} clouds of shape {out_u[0].shape}")
    check("ragged logits trimmed", [o.shape for o in out_r]
          == [(len(c), SEG_CLASSES) for c in rag]
          and all(np.isfinite(o).all() for o in out_r),
          f"shapes {[o.shape[0] for o in out_r]}")
    for name in path:
        check(f"{name} launched", counts[name] > 0, f"{counts[name]} launches")
    if precision:
        per_forward = (SEG_INT8_PER_FORWARD if precision == "int8"
                       else SEG_MLP_PER_FORWARD)
        for name, per in per_forward.items():
            check(f"{name} {per} a forward", counts[name] == per * forwards,
                  f"{counts[name]} launches in {forwards} forwards")
        f32 = InferenceEngine(model, **kw)
    for label, clouds, normals, cats, got in (
            ("uniform", uni, uni_n, uni_c, out_u),
            ("ragged", rag, rag_n, rag_c, out_r)):
        got = np.concatenate(got)
        ref = np.concatenate(plain.predict(clouds, normals, cats))
        if precision:
            held_to(f"{label} kernel vs plain path", got, ref, BF16_PATH_REL,
                    "points")
            held_to(f"{label} {precision} vs the f32 engine", got,
                    np.concatenate(f32.predict(clouds, normals, cats)),
                    BF16_REL, "points")
        else:
            held_abs(f"{label} kernel vs plain", got, ref, LOGIT_ATOL)
    if precision:
        held_to("full cloud ragged (exact kNN) vs uniform (knn_topk)",
                out_r[-1], out_u[0], BF16_REL, "points")
    else:
        held_abs("full cloud ragged vs uniform", out_r[-1], out_u[0],
                 LOGIT_ATOL)

    t = float(np.median(times))
    n_batches = SEG_UNIFORM // SEG_B
    print(f"[{tag}] {SEG_UNIFORM} uniform clouds (N={SEG_N}, K={SEG_K}, "
          f"batch {SEG_B}, precision={precision}): median {t * 1e3:.3f} ms "
          f"per call of {n_batches} batches, {t * 1e3 / n_batches:.3f} ms "
          f"per batch, {SEG_UNIFORM / t:.1f} clouds/s (host clock, "
          f"synchronised), card: {card}")
    profile(tag, f"one {SEG_UNIFORM}-cloud predict call",
            lambda: engine.predict(uni, uni_n, uni_c), t * 1e3)
    return counts


def conv2_seg_forms(dev, card):
    """The segmentation config's last conv (128 -> 256 -> 256) in both
    forms: the per-edge MLP and max in one kernel (``gather_mlp_max``,
    the JAX package's TPU choice, K - 1 times the products), and the
    per-point chain (plain matmuls) followed by the bf16 max with the
    epilogue (``gather_max_affine`` on the sign-folded output)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import knn

    c_in, c_out, _ = MLP_CASES["conv2"]
    idx, nbr_mask = knn(torch.randn((SEG_B, SEG_N, 3), device=dev), SEG_K)
    x, ws, aff, z0, epi = mlp_inputs(c_in, c_out, False, dev)
    one = median_ms(lambda: ops.gather_mlp_max(
        x, ws, aff, idx, nbr_mask, False, True, ops.mlp_chain(x, ws, aff),
        epi))
    two = median_ms(lambda: ops.gather_max_affine(
        ops.mlp_chain(x, ws, aff).to(torch.bfloat16), idx, nbr_mask, epi))
    print(f"[conv2-seg] {c_in}->{c_out}->{c_out}, B={SEG_B} N={SEG_N} "
          f"K={SEG_K}: per-point chain + gather_mlp_max {one:.4f} ms; "
          f"per-point chain then gather_max_affine {two:.4f} ms; card: "
          f"{card}")


def conv3_forms(dev, card):
    """The last conv's max in both forms, for eval and training, at the
    shapes of both models that run it (MM_SHAPES): the wrappers
    (``gather_matmul_max`` with the epilogue, ``gather_matmul_max_win``)
    and matmul then gather (``x @ w``, then ``gather_max_affine`` or
    ``gather_max_win`` at C_out), by CUDA events and in device time. It
    calls the public functions only, so that it times another checkout's
    package too (imported from that checkout's root)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import knn

    for b, n in MM_SHAPES:
        pos = torch.randn((b, n, 3), device=dev)
        idx, nbr_mask = knn(pos, K)
        x = torch.randn((b, n, MM_IN), device=dev).to(torch.bfloat16)
        w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
        aff = random_affine(MM_OUT, dev)
        forms = (
            ("eval", "gather_matmul_max",
             lambda: ops.gather_matmul_max(x, w, idx, nbr_mask, aff),
             "gather_max_affine",
             lambda: ops.gather_max_affine(torch.matmul(x, w), idx, nbr_mask,
                                           aff)),
            ("training forward", "gather_matmul_max_win",
             lambda: ops.gather_matmul_max_win(x, w, idx, nbr_mask),
             "gather_max_win_bf16",
             lambda: ops.gather_max_win(torch.matmul(x, w), idx, nbr_mask)))
        for what, one, f_one, two, f_two in forms:
            print(f"[conv3] {what}, {MM_IN}->{MM_OUT}, B={b} N={n} K={K}: "
                  f"{one} {median_ms(f_one):.4f} ms "
                  f"({device_ms(f_one, 5):.4f} ms of device time); x @ w "
                  f"(bf16) then {two} {median_ms(f_two):.4f} ms "
                  f"({device_ms(f_two, 5):.4f}); card: {card}", flush=True)


def path_device_times(seed, dev, card):
    """``[device-times]``: the device time (profiler, :func:`device_ms`)
    of one call of each path that runs a neighbour max, a matmul max or
    the coefficient applies: a 32-cloud bf16 classification forward
    (``InferenceEngine.predict``, approximate kNN; then the same engine
    with its backbone's ``fused_eval_build`` on), the bf16
    classification train step (reference recipe), a 4-cloud large-cloud
    bf16 forward (N=8192, coefficient form), the large-cloud bf16 step,
    the large-cloud f32 forward, a 32-cloud f32 classification forward
    (exact kNN), the f32 classification step (reference recipe), a
    32-cloud int8 classification forward (approximate kNN), the bf16
    segmentation train step (bench.py's seg train config) with conv0 on
    each branch (``_EDGE_FUSED_TRAIN`` on: the edge MLP; off: the edge
    tensor) with its peak memory, 16-cloud bf16 and int8 segmentation
    forwards (approximate kNN, categories), and
    an f32 eval forward + backward in the positions and normals of 32
    classification clouds (dense) and of 4 large clouds (coefficient
    form, approximate kNN), each after PATH_WARMUP calls. Public functions
    only, as :func:`conv3_forms`."""
    from deltaconv_tpu_torch import InferenceEngine
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    rng = np.random.default_rng(seed + 15)
    times, peaks = {}, {}

    def forward(label, engine, *inputs):
        for _ in range(PATH_WARMUP):
            engine.predict(*inputs)
        times[label] = device_ms(lambda: engine.predict(*inputs))

    for label, b, n, lr, dense in (("classification", B, N, TRAIN_LR, True),
                                   ("large-cloud", LARGE_B, LARGE_N,
                                    LARGE_LR, False)):
        model = random_model(seed, dev, knn_method="approx",
                             dense_operators=dense)
        engine = InferenceEngine(model, num_points=n, batch_size=b,
                                 precision="bfloat16")
        clouds, normals = ellipsoid_clouds(rng, [n] * b)
        for _ in range(PATH_WARMUP):
            engine.predict(clouds, normals)
        times[f"{label} bf16 forward ({b} clouds)"] = device_ms(
            lambda: engine.predict(clouds, normals))
        if dense:  # the same engine with its backbone's fused eval build
            engine.model.deltanet_base.fused_eval_build = True
            for _ in range(PATH_WARMUP):
                engine.predict(clouds, normals)
            times[f"{label} bf16 forward, fused eval build ({b} clouds)"] = (
                device_ms(lambda: engine.predict(clouds, normals)))
        del engine, model
        batch = train_batch(rng, dev, [n] * b, n)
        model = random_model(seed, dev, affine=False, knn_method="approx",
                             precision="bfloat16", dense_operators=dense)
        state = create_train_state(model, sgd_momentum(lr))
        step = make_train_step(model, smoothing=0.2)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(PATH_WARMUP):
            step(state, batch, gen)
        times[f"{label} bf16 step"] = device_ms(
            lambda: step(state, batch, gen))
        del state, step, model, batch
    model = random_model(seed, dev, knn_method="approx",
                         dense_operators=False)
    engine = InferenceEngine(model, num_points=LARGE_N, batch_size=LARGE_B)
    clouds, normals = ellipsoid_clouds(rng, [LARGE_N] * LARGE_B)
    for _ in range(PATH_WARMUP):
        engine.predict(clouds, normals)
    times[f"large-cloud f32 forward ({LARGE_B} clouds)"] = device_ms(
        lambda: engine.predict(clouds, normals))
    del engine, model
    clouds, normals = ellipsoid_clouds(rng, [N] * B)
    model = random_model(seed, dev)
    forward(f"classification f32 forward ({B} clouds)",
            InferenceEngine(model, num_points=N, batch_size=B), clouds,
            normals)
    model = random_model(seed, dev, knn_method="approx")
    forward(f"classification int8 forward ({B} clouds)",
            InferenceEngine(model, num_points=N, batch_size=B,
                            precision="int8"), clouds, normals)
    batch = train_batch(rng, dev, [N] * B)
    model = random_model(seed, dev, affine=False)
    state = create_train_state(model, sgd_momentum(TRAIN_LR))
    step = make_train_step(model, smoothing=0.2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(PATH_WARMUP):
        step(state, batch, gen)
    times["classification f32 step"] = device_ms(
        lambda: step(state, batch, gen))
    del state, step, model, batch
    # The bf16 segmentation step, conv0 on each branch (the edge MLP,
    # #27 + #28, with _EDGE_FUSED_TRAIN; its edge tensor without), with its
    # peak memory.
    dc = importlib.import_module("deltaconv_tpu_torch.nn.deltaconv")
    batch = seg_train_batch(rng, dev, [SEG_N] * SEG_B)
    try:
        for fused in (True, False):
            dc._EDGE_FUSED_TRAIN = fused
            model = random_seg_model(seed, dev, "approx", affine=False,
                                     precision="bfloat16")
            state = create_train_state(model, sgd_momentum(SEG_LR))
            step = make_train_step(model, smoothing=0.0, per_point=True)
            gen = torch.Generator(device=dev).manual_seed(seed)
            for _ in range(PATH_WARMUP):
                step(state, batch, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            step(state, batch, gen)
            torch.cuda.synchronize()
            what = (f"segmentation bf16 step, conv0 "
                    f"{'fused' if fused else 'reference'} ({SEG_B} clouds)")
            peaks[what] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            times[what] = device_ms(lambda: step(state, batch, gen))
            del state, step, model
    finally:
        dc._EDGE_FUSED_TRAIN = False
    del batch
    model = random_seg_model(seed, dev, "approx")
    (uni, uni_n, uni_c), _ = seg_clouds(rng)
    for precision in ("bfloat16", "int8"):
        forward(f"segmentation {precision[:4]} forward ({SEG_B} clouds)",
                InferenceEngine(model, num_points=SEG_N, batch_size=SEG_B,
                                precision=precision),
                uni[:SEG_B], uni_n[:SEG_B], uni_c[:SEG_B])
    del model
    # Forward + backward in the positions and normals (eval mode, f32), as
    # [pos-grad] and [pos-grad-large] run them.
    for label, b, n, config in (
            ("classification", B, N, {}),
            ("large-cloud", LARGE_B, LARGE_N,
             {"dense_operators": False, "knn_method": "approx"})):
        batch = train_batch(rng, dev, [n] * b, n)
        model = random_model(seed, dev, dropout=0.0, **config).eval()

        def fwd_bwd(model=model, batch=batch):
            p = batch["pos"].clone().requires_grad_()
            q = batch["normal"].clone().requires_grad_()
            torch.nn.functional.cross_entropy(
                model(p, q), batch["label"]).backward()

        for _ in range(PATH_WARMUP):
            fwd_bwd()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        what = (f"{label} f32 forward + backward in the positions ({b} "
                f"clouds)")
        times[what] = device_ms(fwd_bwd)
        peaks[what] = peak
        del model, batch
    print("[device-times] device time of one call (profiler): " + "; ".join(
        f"{label} {ms:.3f} ms" + (f" (peak {peaks[label]:.3f} GiB)"
                                  if label in peaks else "")
        for label, ms in times.items()) + f"; card: {card}", flush=True)


def edge_mlp_times(idx, dev):
    """``[kernel-times]`` parts of the edge MLP at the segmentation train
    shape (64 -> 64): ``ops.edge_mlp_fwd`` (#27) and ``ops.edge_mlp_bwd``
    (#28, the whole backward), each in device time and by CUDA events,
    with its bound. Public functions only (both trees have them)."""
    from deltaconv_tpu_torch import ops

    y, a0, b0, w1, z0 = edge_inputs(idx, dev)
    b, n, k = idx.shape
    g = torch.randn((b, k, n, EDGE_C), device=dev).to(torch.bfloat16)
    edges = float(b * n * (k - 1))
    ab, w1b = torch.stack([a0, b0]), w1.to(torch.bfloat16)

    def fwd():
        return ops.edge_mlp_fwd(y, a0, b0, w1, z0, idx)

    def bwd():
        return ops.edge_mlp_bwd(y, a0, b0, w1, idx, g)

    flops = 2.0 * edges * EDGE_C * EDGE_C
    bounds = (bound(nbytes(y, idx, ab, w1b, z0, fwd()), flops,
                    BF16_TC_OPS_PER_S)[0],
              bound(nbytes(y, idx, ab, w1b, g[:, 1:], *bwd()), 2 * flops,
                    BF16_TC_OPS_PER_S)[0])
    return [f"{name} B={b} N={n} K={k} {EDGE_C}->{EDGE_C} "
            f"{device_ms(fn, 5):.4f} (events {median_ms(fn):.4f}; bound "
            f"{bd:.4f})"
            for name, fn, bd in (("edge_delta_mlp", fwd, bounds[0]),
                                 ("edge_delta_mlp_bwd (whole backward)", bwd,
                                  bounds[1]))]


def kernel_times(seed, dev, card):
    """``[kernel-times]``: the device time (profiler, :func:`device_ms`)
    of one call of the redesigned kernels' public wrappers at the shapes
    where the model paths run them, and for those of this slice also
    their time by CUDA events (:func:`median_ms`): ``ops.gather_max_affine``
    (B=32, N=1024 and B=4, N=8192, C = 64 with the self row, 64, 128),
    ``ops.densify_coefs_int8`` (the whole call, scales included, on the
    clouds' operator coefficients at B=32, N=1024, K=20 and B=16, N=2048,
    K=30), each with its bound, and at the record shapes (C=128; the
    classification shape) the plain version's and the library
    composition's device time; ``ops.gather_max_int8`` on bf16 features
    (B=32, N=1024, C = 64, 128; B=16, N=2048, C=128) and
    ``ops.gather_max_bwd`` (B=32, N=1024, f32 and bf16 cotangents at C =
    64, 128, 256; B=4, N=8192, bf16 at C = 64, 128, 256), on uniform kNN
    graphs and the plain max's winners; ``ops.gather_sum_fwd`` at C=SUM_C
    (B=32, N=1024; B=4, N=8192) and ``ops.fused_gather_wls`` (B=32,
    N=1024, K=20; B=16, N=2048, K=30), each also by events, with its
    bound; ``ops.gather_minmax`` and ``ops.gather_minmax_win`` (f32 C=256,
    bf16 C=128) and ``ops.gather_matmul_minmax`` (128 -> 256) at B=32,
    N=1024 and B=4, N=8192, each also by events, with its bound; the edge
    MLP at B=16, N=2048, K=30 (:func:`edge_mlp_times`);
    ``ops.wls`` at the three
    forwards' shapes (B=32, N=1024, K=20; B=16, N=2048, K=30; B=4, N=8192,
    K=20) and ``ops.wls_bwd`` at the backwards' (B=32, N=1024 and B=4,
    N=8192), each also by events, with its bound and the plain version's
    device time. Public functions only, as :func:`path_device_times`, so
    that the line times another checkout's kernels."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    rng = np.random.default_rng(seed + 16)
    parts = []
    for b, n, k, int8_widths, bwd, dense in (
            (B, N, K, INT8_WIDTHS, ((torch.float32, WIDTHS),
                                    (torch.bfloat16, BWD_BF16_WIDTHS)),
             True),
            (SEG_B, SEG_N, SEG_K, (SEG_MAX_WIDTH,), (), True),
            (LARGE_B, LARGE_N, K, (), ((torch.bfloat16,
                                        BWD_BF16_WIDTHS),), False)):
        clouds, normals = ellipsoid_clouds(rng, [n] * b)
        pos = torch.from_numpy(np.stack(clouds)).to(dev)
        idx, nbr_mask = knn(pos, k)
        bidx = torch.arange(b, device=dev)[:, None, None]
        idx_l = idx.long()
        valid = nbr_mask.any(dim=-1, keepdim=True)
        for c, sub_self in (AFFINE_WIDTHS if k == K else ()):
            h = torch.randn((b, n, c), device=dev).to(torch.bfloat16)
            aff = random_affine(c, dev)

            def call(h=h, aff=aff, sub_self=sub_self):
                return ops.gather_max_affine(h, idx, nbr_mask, aff, sub_self)

            bd = bound(nbytes(h, idx, nbr_mask, torch.stack(aff), h))[0]
            line = (f"gather_max_affine B={b} N={n} C={c} sub_self="
                    f"{sub_self} {device_ms(call, 5):.4f} (events "
                    f"{median_ms(call):.4f}; bound {bd:.4f}")
            if (b, c) == (B, 128):
                pl = device_ms(lambda: ops.gather_max_affine_plain(
                    h, idx, nbr_mask, aff), 5)
                lib = device_ms(lambda: ops.bn_lrelu_epilogue(
                    h[bidx, idx_l].amax(dim=2).float(), aff, valid), 5)
                line += f"; plain {pl:.4f}; library {lib:.4f}"
            parts.append(line + ")")
        if dense:
            nrm = torch.from_numpy(np.stack(normals)).to(dev)
            gd = ops.build_grad_div_fused(pos, nrm, *build_tangent_basis(nrm),
                                          idx, nbr_mask)
            gc, dc = gd.grad_coef, gd.div_coef

            def call(gc=gd.grad_coef, dc=gd.div_coef):
                return ops.densify_coefs_int8(idx, gc, dc)

            bd = bound(nbytes(idx, gd.grad_coef, gd.div_coef, *call()))[0]
            line = (f"densify_int8 B={b} N={n} K={k} {device_ms(call, 5):.4f}"
                    f" (events {median_ms(call):.4f}; bound {bd:.4f}")
            if b == B:
                pl = device_ms(lambda: ops.densify_coefs_int8_plain(
                    idx, gd.grad_coef, gd.div_coef), 3)
                lib = device_ms(densify_int8_library(idx, gd.grad_coef,
                                                     gd.div_coef), 3)
                line += f"; plain {pl:.4f}; library {lib:.4f}"
            parts.append(line + ")")
            del gd
        for c in int8_widths:
            h = torch.randn((b, n, c), device=dev).to(torch.bfloat16)
            ms = device_ms(lambda: ops.gather_max_int8(h, idx, nbr_mask), 5)
            parts.append(f"gather_max_int8 B={b} N={n} C={c} bf16 {ms:.4f}")
        if k == K:
            h = torch.randn((b, n, SUM_C), device=dev)

            def call(h=h):
                return ops.gather_sum_fwd(h, idx, nbr_mask)

            bd = bound(nbytes(h, idx, nbr_mask, h))[0]
            parts.append(f"gather_sum B={b} N={n} C={SUM_C} "
                         f"{device_ms(call, 5):.4f} (events "
                         f"{median_ms(call):.4f}; bound {bd:.4f})")
        if dense:
            nrm = torch.from_numpy(np.stack(normals)).to(dev)
            _, md = ops.knn_topk(pos, k, True, return_mean_dist=True)
            fused = (pos, nrm, *build_tangent_basis(nrm), idx, nbr_mask,
                     md.mean(dim=1).contiguous())

            def call(fused=fused):
                return ops.fused_gather_wls(*fused)

            bd = bound(nbytes(*fused, *call()),
                       float(b) * n * k * WLS_FLOPS_PER_EDGE)[0]
            parts.append(f"fused_gather_wls B={b} N={n} K={k} "
                         f"{device_ms(call, 5):.4f} (events "
                         f"{median_ms(call):.4f}; bound {bd:.4f})")
        if k == K:
            parts += minmax_times(b, n, idx, nbr_mask, dev)
        for dt, widths in bwd:
            for c in widths:
                h = torch.randn((b, n, c), device=dev)
                _, win = ops.gather_max_win_plain(h, idx, nbr_mask)
                g = torch.randn((b, n, c), device=dev).to(dt)
                ms = device_ms(lambda: ops.gather_max_bwd(idx, win, g, n), 5)
                parts.append(f"gather_max_bwd B={b} N={n} C={c} "
                             f"{str(dt)[6:]} {ms:.4f}")
        nrm = torch.from_numpy(np.stack(normals)).to(dev)
        edges = edge_planes(pos, nrm, *build_tangent_basis(nrm), idx,
                            nbr_mask, nbr_mask.any(dim=2).to(torch.float32))
        ctg = torch.randn((b, 2, k, n), device=dev)
        ctd = torch.randn((b, 2, k, n), device=dev)
        calls = [("wls", lambda: ops.wls(edges, 1.0, 1e-3),
                  lambda: ops.wls_plain(edges, 1.0, 1e-3), False)]
        if (b, n, k) in WLS_BWD_SHAPES:
            calls.append((
                "wls_bwd", lambda: ops.wls_bwd(edges, ctg, ctd, 1.0, 1e-3),
                lambda: ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3), True))
        for name, call, plain, is_bwd in calls:
            parts.append(
                f"{name} B={b} N={n} K={k} {device_ms(call, 5):.4f} (events "
                f"{median_ms(call):.4f}; bound "
                f"{wls_bound(edges, is_bwd)[0]:.4f}; plain "
                f"{device_ms(plain, 2):.4f})")
        del edges, ctg, ctd
        if (b, n, k) == (SEG_B, SEG_N, SEG_K):
            parts += edge_mlp_times(idx, dev)
    parts += gather_rows_times(rng, dev)
    print("[kernel-times] device ms of one call (profiler): "
          + "; ".join(parts) + f"; card: {card}", flush=True)


def minmax_times(b, n, idx, nbr_mask, dev):
    """``[kernel-times]`` entries of the min/max hooks' kernels on one kNN
    graph: ``ops.gather_minmax`` and ``ops.gather_minmax_win`` at f32
    C=MINMAX_C and bf16 C=MINMAX_BF16_C, ``ops.gather_matmul_minmax`` at
    MM_IN -> MM_OUT: device time, CUDA events and the bound."""
    from deltaconv_tpu_torch import ops

    parts = []
    for dt, c in ((torch.float32, MINMAX_C), (torch.bfloat16, MINMAX_BF16_C)):
        h = torch.randn((b, n, c), device=dev).to(dt)
        for fn in (ops.gather_minmax, ops.gather_minmax_win):
            def call(fn=fn, h=h):
                return fn(h, idx, nbr_mask)

            bd = bound(nbytes(h, idx, nbr_mask, *call()))[0]
            parts.append(f"{fn.__name__} B={b} N={n} C={c} {str(dt)[6:]} "
                         f"{device_ms(call, 5):.4f} (events "
                         f"{median_ms(call):.4f}; bound {bd:.4f})")
    x = torch.randn((b, n, MM_IN), device=dev).to(torch.bfloat16)
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)

    def call():
        return ops.gather_matmul_minmax(x, w, idx, nbr_mask)

    bd = bound(nbytes(x, w, idx, nbr_mask, *call()),
               2.0 * b * n * MM_IN * MM_OUT, BF16_TC_OPS_PER_S)[0]
    parts.append(f"gather_matmul_minmax B={b} N={n} {MM_IN}->{MM_OUT} "
                 f"{device_ms(call, 5):.4f} (events {median_ms(call):.4f}; "
                 f"bound {bd:.4f})")
    return parts


def rows_inputs(rng, dev):
    """``(label, table, idx)`` at each of ROWS_SHAPES: a kNN graph of
    ellipsoid clouds (the shard's rows from the quantized bucketed kNN of
    a 65,536-point cloud) and a random table."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import knn

    for label, b, n, n_t, k, c in ROWS_SHAPES:
        clouds, _ = ellipsoid_clouds(rng, [n_t] * b)
        pos = torch.from_numpy(np.stack(clouds)).to(dev)
        if n_t == n:
            idx, _ = knn(pos, k)
        else:
            idx = ops.knn_topk_bucketed(pos[0], pos[0], k,
                                        quantized=True)[None, :n]
            idx = idx.contiguous()
        yield label, torch.randn((b, n_t, c), device=dev), idx


def check_rows_shapes(res, rng, dev):
    """gather_rows bit-equal to its plain version at every one of
    ROWS_SHAPES (:func:`rows_inputs`), and a second call too."""
    from deltaconv_tpu_torch import ops

    for label, table, idx in rows_inputs(rng, dev):
        got = ops.gather_rows(table, idx)
        err = max_err(got, ops.gather_rows_plain(table, idx))
        res["gather_rows"]["max_abs_err"] = max(
            res["gather_rows"]["max_abs_err"], err)
        check(f"gather_rows {label} {tuple(table.shape)} K={idx.shape[-1]} "
              f"rows={idx.shape[1]}",
              torch.equal(got, ops.gather_rows_plain(table, idx))
              and bits_equal(ops.gather_rows(table, idx), got),
              f"bit-equal, and a second call, max_abs_err {err}")


def gather_rows_times(rng, dev):
    """``ops.gather_rows`` at ROWS_SHAPES (:func:`rows_inputs`): device
    time, CUDA events and the bound (the table, idx and the output each
    moved once), as ``[kernel-times]`` entries."""
    from deltaconv_tpu_torch import ops

    parts = []
    for label, table, idx in rows_inputs(rng, dev):
        (b, n_t, c), (_, n, k) = table.shape, idx.shape

        def call(table=table, idx=idx):
            return ops.gather_rows(table, idx)

        bd = bound(nbytes(table, idx, call()))[0]
        parts.append(f"gather_rows {label} B={b} N={n} Nt={n_t} K={k} C={c} "
                     f"{device_ms(call, 5):.4f} (events {median_ms(call):.4f}"
                     f"; bound {bd:.4f})")
        del idx, table
    return parts


def matmul_kfold_phase(rng, dev):
    """``[matmul-max-kfold]``: one cloud of MM_KFOLD_N points, above the
    one-product-a-row kernels' limit at C_in = 128 (bf16 and int8 x):
    ``gather_matmul_max`` with the epilogue, ``gather_matmul_max_train``
    (forward and backward), ``gather_matmul_max_int8`` and
    ``gather_matmul_minmax`` launch the K-fold kernels once each and the
    one-product-a-row kernels never; exact-sum weights bit-equal to the
    plain versions. Its cloud comes
    from a generator spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import knn

    rng = rng.spawn(1)[0]
    clouds, _ = ellipsoid_clouds(rng, [MM_KFOLD_N])
    idx, nbr_mask = knn(torch.from_numpy(np.stack(clouds)).to(dev), K)
    x = (torch.randint(-32, 33, (1, MM_KFOLD_N, MM_IN), device=dev) / 8.0
         ).to(torch.bfloat16)
    w = (torch.randint(-16, 17, (MM_IN, MM_OUT), device=dev) / 16.0
         ).to(torch.bfloat16)
    aff = random_affine(MM_OUT, dev)
    xq = torch.randint(-127, 128, (1, MM_KFOLD_N, MM_IN), device=dev,
                       dtype=torch.int8)
    torch.cuda.synchronize()
    reset_launch_counts()
    fused = ops.gather_matmul_max(x, w, idx, nbr_mask, aff)
    xg = x.clone().requires_grad_()
    out = ops.gather_matmul_max_train(xg, w, idx, nbr_mask)
    out.float().sum().backward()
    int8 = ops.gather_matmul_max_int8(xq, w, idx, nbr_mask)
    minmax = ops.gather_matmul_minmax(x, w, idx, nbr_mask)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[matmul-max-kfold] launches, N={MM_KFOLD_N}: "
          f"{ {n: c for n, c in counts.items() if c} }")
    check("[matmul-max-kfold] the K-fold kernels once each, the "
          "one-product-a-row kernels never",
          counts["gather_matmul_max_kfold"] == 1
          and counts["gather_matmul_max_win_kfold"] == 1
          and counts["gather_matmul_max_int8_kfold"] == 1
          and counts["gather_matmul_minmax_kfold"] == 1
          and counts["gather_matmul_max"] + counts["gather_matmul_max_win"]
          + counts["gather_matmul_max_int8"]
          + counts["gather_matmul_minmax"] == 0
          and counts["gather_max_bwd_bf16"] == 1,
          f"{counts['gather_matmul_max_kfold']}, "
          f"{counts['gather_matmul_max_win_kfold']}, "
          f"{counts['gather_matmul_max_int8_kfold']}, "
          f"{counts['gather_matmul_minmax_kfold']}, "
          f"{counts['gather_matmul_max']}, {counts['gather_matmul_max_win']}, "
          f"{counts['gather_matmul_max_int8']}, "
          f"{counts['gather_matmul_minmax']}")
    check("[matmul-max-kfold] exact sums",
          bits_equal(fused, ops.gather_matmul_max_plain(x, w, idx, nbr_mask,
                                                        aff))
          and bits_equal(out.detach(), ops.gather_matmul_max_win_plain(
              x, w, idx, nbr_mask)[0])
          and bits_equal(int8, ops.gather_matmul_max_int8_plain(
              xq, w, idx, nbr_mask))
          and all(bits_equal(a, v) for a, v in zip(
              minmax, ops.gather_matmul_minmax_plain(x, w, idx, nbr_mask))),
          "bit-equal to the plain versions")
    return counts


def train_batch(rng, dev, sizes, n=N):
    """One batch of class-conditioned ellipsoids (the class fixes the
    axes up to 5% noise) of ``n`` points, padded with a point mask when
    ragged."""
    class_axes = np.random.default_rng(1234).uniform(0.4, 1.6,
                                                     (NUM_CLASSES, 3))
    labels = rng.integers(0, NUM_CLASSES, len(sizes))
    axes = class_axes[labels] * rng.uniform(0.95, 1.05, (len(sizes), 3))
    clouds, normals = ellipsoid_clouds(rng, sizes, axes)
    pos = np.zeros((len(sizes), n, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32),
                  (len(sizes), n, 1))
    for i, (c, q) in enumerate(zip(clouds, normals)):
        pos[i, :len(c)], nrm[i, :len(c)] = c, q
    batch = {"pos": torch.from_numpy(pos).to(dev),
             "normal": torch.from_numpy(nrm).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    if min(sizes) < n:
        batch["point_mask"] = torch.from_numpy(
            np.arange(n)[None, :] < np.asarray(sizes)[:, None]).to(dev)
    return batch


def train_once(batch, seed, dev, ops, **config):
    """One step of a fresh model (dropout 0) through ``ops``; ``config``
    (``knn_method``, ``precision``, ``dense_operators``) as
    :func:`random_model`'s."""
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    model = random_model(seed, dev, dropout=0.0, affine=False, **config)
    state = create_train_state(model, sgd_momentum(TRAIN_LR))
    metrics = make_train_step(model, ops=ops)(state, batch, None)
    return float(metrics["loss"]), model


def compare_steps(label, batch, seed, dev, same_build, once=train_once):
    """One step from the same weights through the kernels and through
    the plain versions; raises on disagreement.

    ``same_build``: the plain side builds its operators with the build
    kernels too, so the two steps differ only in this slice's kernels
    (neighbour max with winners, its backward, the neighbour sum) and
    every quantity is held. Otherwise the plain side builds with the
    plain versions, whose operators differ by ~1e-6 (wls): then some
    neighbour-max winners flip at near-ties, which moves single
    gradient entries by a whole cotangent, so only the loss and the
    running statistics (continuous in the inputs) are held and the
    gradient and parameter deviations are printed. ``once``: the step of
    a fresh model (:func:`train_once`, or :func:`seg_train_once`, whose
    first conv gathers its edges with ``gather_rows``: exact, so its plain
    version joins the same build)."""
    from deltaconv_tpu_torch import KERNEL_OPS, PLAIN_OPS
    from deltaconv_tpu_torch.ops import (gather_max_plain, gather_rows_plain,
                                         gather_sum_plain)

    plain = (KERNEL_OPS._replace(gather_max=gather_max_plain,
                                 gather_sum=gather_sum_plain,
                                 gather_rows=gather_rows_plain)
             if same_build else PLAIN_OPS)
    lk, mk = once(batch, seed, dev, KERNEL_OPS)
    lp, mp = once(batch, seed, dev, plain)
    check(f"{label} loss kernel vs plain",
          abs(lk - lp) <= LOSS_RTOL * abs(lp),
          f"{lk} vs {lp}, rel {abs(lk - lp) / abs(lp):.3e} <= {LOSS_RTOL}")
    worst = {"grad": (0.0, ""), "param": (0.0, ""), "stat": (0.0, "")}
    params_p = dict(mp.named_parameters())
    for name, p in mk.named_parameters():
        q = params_p[name]
        for kind, a, b in (("grad", p.grad, q.grad), ("param", p, q)):
            rel = max_err(a, b) / max(float(b.detach().abs().max()), 1e-30)
            worst[kind] = max(worst[kind], (rel, name))
    bufs_p = dict(mp.named_buffers())
    for name, s in mk.named_buffers():
        rel = max_err(s, bufs_p[name]) / max(float(bufs_p[name].abs().max()),
                                             1e-30)
        worst["stat"] = max(worst["stat"], (rel, name))
    for kind, tol in (("grad", PARAM_RTOL), ("param", PARAM_RTOL),
                      ("stat", STATS_RTOL)):
        rel, name = worst[kind]
        detail = f"worst {rel:.3e} x max ({name})"
        if same_build or kind == "stat":
            check(f"{label} {kind}s kernel vs plain", rel <= tol,
                  f"{detail} <= {tol}")
        else:
            print(f"  {label} {kind}s kernel vs plain: {detail} (winner "
                  f"flips from the builds' ~1e-6; not held)")


def profile(tag, what, fn, ref_ms):
    """Device time of one call of ``fn`` by op and by kernel
    (torch.profiler), and its share of ``ref_ms``, the unprofiled median
    (the profiler itself slows the host). The window holds PROFILE_CALLS
    calls; each row is its mean per instance times the instances a call
    runs (as in :func:`device_ms`), so an instance the trace drops leaves
    the row right."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        # A spin kernel opens the traced window (left out of the sums): a
        # kernel at its very start can go unrecorded.
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / PROFILE_CALLS
    ops_, kernels = [], []
    for evt in prof.key_averages():
        if (evt.self_device_time_total > 0 and evt.count
                and "spin_kernel" not in evt.key):
            count = max(1, round(evt.count / PROFILE_CALLS))
            row = (evt.self_device_time_total / evt.count * count, count,
                   evt.key)
            (kernels if evt.device_type == DeviceType.CUDA
             else ops_).append(row)
    total = sum(r[0] for r in kernels)
    # The port's kernels are launched through ctypes, outside any aten
    # op, so they appear only as kernel events (all in an anonymous
    # namespace of their own).
    ours = [r for r in kernels
            if re.match(r"(void )?\(anonymous namespace\)::\w+_kernel\b",
                        r[2])]
    # Inside the port's autograd Functions they are that Function's self
    # time too: list them once, as kernels.
    ops_ = [r for r in ops_ if r[2] not in AUTOGRAD_FUNCTIONS] + ours
    print(f"[{tag}] profile of {what}: {total / 1e3:.3f} ms of device "
          f"time, {total / 1e3 / ref_ms:.3f} of the {ref_ms:.3f} ms "
          f"unprofiled median ({wall * 1e3:.3f} ms profiled); the port's "
          f"kernels {sum(r[0] for r in ours) / 1e3:.3f} ms")
    for title, rows in (("by op (self device time)", ops_),
                        ("by kernel", kernels),
                        ("the port's kernels", ours)):
        print(f"  {title}, top 12:")
        for us, count, key in sorted(rows, reverse=True)[:12]:
            print(f"  {us / 1e3:9.3f} ms {100 * us / max(total, 1e-9):5.1f}%"
                  f" x{count:<4d} {key[:100]}")
    return total, ours


def _deviations(ma, mb):
    """Per tensor and over all tensors at once, the relative Frobenius
    deviation of ``ma``'s gradients and parameters from ``mb``'s, and
    the worst element against its tensor's max."""
    params_b = dict(mb.named_parameters())
    out = {}
    for kind in ("grad", "param"):
        per, num, den, elem = [], 0.0, 0.0, (0.0, "")
        for name, p in ma.named_parameters():
            q = params_b[name]
            a, b = (p.grad, q.grad) if kind == "grad" else (p, q)
            a, b = a.detach().double(), b.detach().double()
            d2, n2 = float(((a - b) ** 2).sum()), float((b ** 2).sum())
            num, den = num + d2, den + n2
            per.append((np.sqrt(d2 / max(n2, 1e-60)), name))
            elem = max(elem, (max_err(a, b) / max(float(b.abs().max()),
                                                  1e-30), name))
        out[kind] = (np.sqrt(num / max(den, 1e-60)), max(per), elem)
    return out


def compare_bf16_steps(label, batch, seed, dev, dense_operators=True,
                       hold_params=True, once=train_once):
    """One bf16 step from the same weights through the kernels and
    through the plain versions of the train step's maxes and sum (and,
    with ``dense_operators=False``, the coefficient-form applies with
    their scatter backward), the operators built by the kernels on both
    sides. They differ by the
    order of f32 sums (the matmul max's products, the backward's
    atomics), which moves a bf16 value by one ulp on a few elements and
    with it a neighbour-max winner at a near-tie and a whole cotangent;
    a gradient that is a cancelling sum (a BatchNorm bias) then moves by
    a large share of its small norm, and all of them together by up to
    5e-2 (relative Frobenius; measured 6.9e-3 uniform, 4.8e-2 ragged).
    So the loss and the running statistics are held elementwise, the
    parameters by their relative Frobenius deviation over all tensors at
    once, and the gradients by their distance to the f32 step's (the
    same weights through the kernels): the kernels' bf16 gradients may
    be at most BF16_F32_RATIO times as far from them, on the mean over
    tensors, as the plain versions' (a misrouted cotangent moves that
    distance; the bf16 step's own rounding does not). The deviations
    over all tensors, of the worst tensor and of the worst element are
    printed beside the spread of two kernel steps (atomics).
    ``hold_params=False`` prints the parameters' deviation without
    holding it: at B=4 the head's 4-row BatchNorm amplifies a winner flip
    to a deviation of about 2e-2 (at N=8192 on an H100 80GB HBM3, 700 W);
    the gradients' distance to the f32 step holds the same update.
    ``once``: :func:`train_once` or :func:`seg_train_once`."""
    from deltaconv_tpu_torch import KERNEL_OPS, PLAIN_OPS

    plain = KERNEL_OPS._replace(
        gather_max=PLAIN_OPS.gather_max, gather_sum=PLAIN_OPS.gather_sum,
        gather_matmul_max_train=PLAIN_OPS.gather_matmul_max_train,
        coef_apply_grad=PLAIN_OPS.coef_apply_grad,
        coef_apply_div=PLAIN_OPS.coef_apply_div,
        edge_delta_mlp=PLAIN_OPS.edge_delta_mlp)
    config = dict(knn_method="approx", dense_operators=dense_operators)
    lk, mk = once(batch, seed, dev, KERNEL_OPS, precision="bfloat16",
                  **config)
    lp, mp = once(batch, seed, dev, plain, precision="bfloat16", **config)
    _, mk2 = once(batch, seed, dev, KERNEL_OPS, precision="bfloat16",
                  **config)
    _, mf = once(batch, seed, dev, KERNEL_OPS, **config)
    dev_k, dev_kk = _deviations(mk, mp), _deviations(mk2, mk)
    for kind in ("grad", "param"):
        (whole, per, elem), (whole_k, per_k, _) = dev_k[kind], dev_kk[kind]
        print(f"  {label} {kind}s kernel vs plain: all tensors {whole:.3e}, "
              f"worst tensor {per[0]:.3e} ({per[1]}), worst element "
              f"{elem[0]:.3e} x max ({elem[1]}); kernel vs kernel: all "
              f"{whole_k:.3e}, worst tensor {per_k[0]:.3e} ({per_k[1]})")
    grads_f = dict(mf.named_parameters())
    norms = {n: float(torch.linalg.norm(p.grad)) for n, p in grads_f.items()}
    # The segmentation step leaves out the tensors whose f32 gradient is
    # rounding noise (below 1e-6 of the largest: the ``lin_global``
    # BatchNorm bias, whose gradient cancels); the classification steps
    # hold every tensor.
    floor = 1e-6 * max(norms.values()) if once is seg_train_once else 0.0
    held = [n for n in grads_f if norms[n] >= floor]
    print(f"  {label} grads left out of the distance to the f32 step: "
          f"{sorted(set(grads_f) - set(held)) or 'none'}")

    def to_f32(m):
        """Mean relative distance to the f32 step's gradients over the
        held tensors."""
        grads = dict(m.named_parameters())
        return float(np.mean([
            float(torch.linalg.norm(grads[n].grad - grads_f[n].grad))
            / max(norms[n], 1e-30) for n in held]))

    far_k, far_p = to_f32(mk), to_f32(mp)
    bufs_p = dict(mp.named_buffers())
    worst = (0.0, "")
    for name, st in mk.named_buffers():
        worst = max(worst, (max_err(st, bufs_p[name]) / max(
            float(bufs_p[name].abs().max()), 1e-30), name))
    check(f"{label} loss kernel vs plain",
          abs(lk - lp) <= BF16_LOSS_RTOL * abs(lp),
          f"{lk} vs {lp}, rel {abs(lk - lp) / abs(lp):.3e} <= "
          f"{BF16_LOSS_RTOL}")
    check(f"{label} stats kernel vs plain", worst[0] <= BF16_STATS_RTOL,
          f"worst {worst[0]:.3e} x max ({worst[1]}) <= {BF16_STATS_RTOL}")
    if hold_params:
        check(f"{label} params kernel vs plain",
              dev_k["param"][0] <= BF16_PARAM_FROB,
              f"relative Frobenius deviation over all tensors "
              f"{dev_k['param'][0]:.3e} <= {BF16_PARAM_FROB}")
    check(f"{label} grads' distance to the f32 step",
          far_k <= BF16_F32_RATIO * far_p,
          f"mean over tensors: kernels {far_k:.3e}, plain {far_p:.3e}, "
          f"ratio {far_k / far_p:.3f} <= {BF16_F32_RATIO}")


def train_bf16_phase(rng, seed, dev, card):
    """The JAX package's production train config: bf16 compute and
    operators, approximate kNN, at the reference recipe."""
    from deltaconv_tpu_torch import launch_counts, reset_launch_counts
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    uniform = train_batch(rng, dev, [N] * B)
    ragged = train_batch(rng, dev, rng.integers(N * 600 // 1024, N + 1,
                                                B).tolist())
    config = dict(knn_method="approx", precision="bfloat16")
    model = random_model(seed, dev, affine=False, **config)
    state = create_train_state(model, sgd_momentum(TRAIN_LR))
    step = make_train_step(model, smoothing=0.2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    warm = random_model(seed + 1, dev, **config)  # warm-up: cuBLAS bf16
    make_train_step(warm)(create_train_state(warm, sgd_momentum(TRAIN_LR)),
                          uniform, torch.Generator(device=dev).manual_seed(1))
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(state, uniform, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    print(f"[train-bf16] launches during {TRAIN_STEPS} steps: {counts}")
    print("[train-bf16] launches per step: " + ", ".join(
        f"{name} {counts[name] / TRAIN_STEPS:g}"
        for name in TRAIN_BF16_KERNELS))
    print(f"[train-bf16] losses: {[round(x, 4) for x in losses]}")
    check("bf16 train losses finite", bool(np.isfinite(losses).all()),
          f"{TRAIN_STEPS} steps")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check("bf16 train loss falls", last < first,
          f"mean of last 5 {last:.4f} < mean of first 5 {first:.4f}")
    check("bf16 parameters stay f32",
          all(p.dtype == torch.float32 for p in model.parameters()),
          "every parameter")
    for name in TRAIN_BF16_KERNELS:
        check(f"{name} launched in bf16 training", counts[name] > 0,
              f"{counts[name]} launches")
    matmul_max_once("gather_matmul_max_win", counts, TRAIN_STEPS, "step")
    t = float(np.median(times))
    print(f"[train-bf16] B={B} N={N} K={K}, reference width, bf16 compute "
          f"and operators, knn_method=approx: median {t * 1e3:.3f} ms per "
          f"train step, {B / t:.1f} training clouds/s (host clock, "
          f"synchronised after each step), card: {card}")
    profile("train-bf16", "one step", lambda: step(state, uniform, gen),
            t * 1e3)

    print("[train-bf16] kernel path vs plain path, one step from the same "
          "weights, dropout 0, same build")
    for label, batch in (("uniform", uniform), ("ragged", ragged)):
        compare_bf16_steps(f"bf16 {label}", batch, seed, dev)
    return counts


def train_phase(rng, seed, dev, card):
    from deltaconv_tpu_torch import launch_counts, reset_launch_counts
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    uniform = train_batch(rng, dev, [N] * B)
    ragged = train_batch(rng, dev, rng.integers(N * 600 // 1024, N + 1,
                                                B).tolist())

    model = random_model(seed, dev, affine=False)  # a fresh model
    state = create_train_state(model, sgd_momentum(TRAIN_LR))
    step = make_train_step(model, smoothing=0.2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    warm = random_model(seed + 1, dev)  # warm-up: cuBLAS, allocator
    make_train_step(warm)(create_train_state(warm, sgd_momentum(TRAIN_LR)),
                          uniform, torch.Generator(device=dev).manual_seed(1))
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(state, uniform, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    print(f"[train] launches during {TRAIN_STEPS} steps: {counts}")
    print(f"[train] losses: {[round(x, 4) for x in losses]}")
    check("train losses finite", bool(np.isfinite(losses).all()),
          f"{TRAIN_STEPS} steps")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check("train loss falls", last < first,
          f"mean of last 5 {last:.4f} < mean of first 5 {first:.4f}")
    for name in TRAIN_KERNELS:
        check(f"{name} launched in training", counts[name] > 0,
              f"{counts[name]} launches")
    t = float(np.median(times))
    print(f"[train] B={B} N={N} K={K}, reference width: median "
          f"{t * 1e3:.3f} ms per train step, {B / t:.1f} training clouds/s "
          f"(host clock, synchronised after each step), card: {card}")
    profile("train", "one step", lambda: step(state, uniform, gen), t * 1e3)

    print("[train] kernel path vs plain path, one step from the same "
          "weights, dropout 0")
    for label, batch in (("uniform", uniform), ("ragged", ragged)):
        compare_steps(f"{label}, same build", batch, seed, dev, True)
        compare_steps(f"{label}, plain build", batch, seed, dev, False)

    gather_sum_mod = importlib.import_module(
        "deltaconv_tpu_torch.ops.gather_sum")
    budget = gather_sum_mod._DENSE_ADJ_MAX_BYTES
    gather_sum_mod._DENSE_ADJ_MAX_BYTES = 0
    try:
        reset_launch_counts()
        compare_steps("ragged, same build, streaming gather-sum route",
                      ragged, seed, dev, True)
        stream = launch_counts()
    finally:
        gather_sum_mod._DENSE_ADJ_MAX_BYTES = budget
    print(f"[train] launches in the streaming-route steps: {stream}")
    for name in STREAM_KERNELS:
        check(f"{name} launched in the streaming route", stream[name] > 0,
              f"{stream[name]} launches")
    check("the streaming sum on route S", stream["gather_sum_direct"] == 0,
          f"gather_sum {stream['gather_sum']}, gather_sum_direct "
          f"{stream['gather_sum_direct']} launches")
    return counts, stream


def large_graphs(rng, dev):
    """Uniform and masked kNN graphs at the large-cloud shapes (B=4,
    N=8192, K=20) as ``(idx, operators, pos, point_mask)``: the clouds'
    own operator coefficients, and the positions and mask that the gather
    plan needs (``ops.coef_plan``); masked: the last 40% of the points of
    every other cloud are padding (their edges carry zero coefficients;
    slots beyond a point's valid neighbours are clamped to self)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn

    clouds, normals = ellipsoid_clouds(rng, [LARGE_N] * LARGE_B)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    xb, yb = build_tangent_basis(nrm)
    pmask = torch.ones((LARGE_B, LARGE_N), dtype=torch.bool, device=dev)
    pmask[::2, int(0.6 * LARGE_N):] = False
    cases = {}
    for label, mask in (("uniform", None), ("masked", pmask)):
        idx, nbr_mask = knn(pos, K, mask)
        if mask is not None:
            nbr_mask = nbr_mask & mask[:, :, None]
        gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
        cases[label] = (idx, gd, pos, mask)
    return cases


def plan_equal(got, want) -> bool:
    return got.run == want.run and all(
        torch.equal(getattr(got, f), getattr(want, f))
        for f in ("order", "run_rows", "run_count", "local_slot"))


def coef_planned(feat) -> bool:
    """Whether the apply of ``feat`` takes the planned route (rows of a
    multiple of 16 bytes, at least COEF_PLAN_MIN_ROW_BYTES)."""
    rb = feat.shape[-1] * feat.element_size()
    return rb % 16 == 0 and rb >= COEF_PLAN_MIN_ROW_BYTES


def check_coef_kernels(record, idx, gd, plan, dev):
    """The kernels of the large-cloud path against their plain versions:
    coef_apply_grad at C = 3, 70, 192, 256, 301 and coef_apply_div at C =
    6, 128, 256, 301, f32 and bf16 features, bit-equal (the same products
    and sums, each rounded, in the same order) on route A and, with the
    plan, on the planned route where the rows allow it (route A
    elsewhere, as the wrapper routes them); scatter_rows at C' = 70,
    256, 512 on component-major and edge-major rows (SCATTER_RTOL x max
    of ``scatter_add_``, bit-equal across two calls); the inverse
    adjacency equal to its plain version."""
    from deltaconv_tpu_torch import ops

    for dt in (torch.float32, torch.bfloat16):
        for name, widths, shape, kern, plain, coef in (
                ("coef_apply_grad", APPLY_WIDTHS[0] + (COEF_ODD_C,),
                 lambda c: (LARGE_B, LARGE_N, c), ops.coef_apply_grad,
                 ops.coef_apply_grad_plain, gd.grad_coef),
                ("coef_apply_div", COEF_DIV_WIDTHS + (COEF_ODD_C,),
                 lambda c: (LARGE_B, LARGE_N, 2, c), ops.coef_apply_div,
                 ops.coef_apply_div_plain, gd.div_coef)):
            for c in widths:
                feat = torch.randn(shape(c), device=dev).to(dt)
                want = plain(feat, coef, idx)
                for route, p in (("", None), ("_plan", plan)):
                    if p is not None and not coef_planned(feat):
                        continue
                    got = kern(feat, coef, idx, p)
                    err = max_err(got.float(), want.float())
                    record(name + route, err)
                    check(f"{name + route} C={c} {str(dt)[6:]}",
                          got.dtype == dt and bits_equal(got, want),
                          f"bit-equal, max_abs_err {err}")
    for c in SCATTER_WIDTHS:
        g = torch.randn((LARGE_B, c, K, LARGE_N), device=dev)
        want = ops.scatter_rows_plain(g, idx, LARGE_N)
        tol = SCATTER_RTOL * float(want.abs().max())
        for layout, rows in (("component-major", g),
                             ("edge-major", edge_major(g))):
            got = ops.scatter_rows(rows, idx, LARGE_N)
            again = ops.scatter_rows(rows, idx, LARGE_N)
            err = max_err(got, want)
            record("scatter_rows", err)
            check(f"scatter_rows C={c} {layout}",
                  err <= tol and bits_equal(got, again),
                  f"max_abs_err {err} <= {tol}, two calls bit-equal")
            del got, again, rows
        del g, want
    got = ops.inverse_adjacency(idx, LARGE_N)
    want = ops.inverse_adjacency_plain(idx, LARGE_N)
    err = max(max_err(a.float(), w.float()) for a, w in zip(got, want))
    record("inverse_adjacency", err)
    check("inverse_adjacency", all(torch.equal(a, w) for a, w in
                                   zip(got, want)),
          f"offsets and lists equal, max_abs_err {err}")
    torch.cuda.synchronize()


def edge_major(g):
    """``g [B, C, K, N]`` as the coefficient VJPs hand it to scatter_rows:
    the same values in edge-major rows ``[B, N, K, C]``, viewed as ``[B,
    C, K, N]``."""
    return g.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)


def inverse_adjacency_library(idx, n_out):
    """The inverse adjacency by library calls: a stable ``torch.sort`` of
    the destination keys and ``searchsorted`` for the offsets."""
    b, n, k = idx.shape
    key = idx.reshape(b, n * k)
    key = torch.where((key >= 0) & (key < n_out), key, n_out)
    keys, order = torch.sort(key, dim=1, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(n_out + 1, device=idx.device,
                           dtype=keys.dtype).expand(b, n_out + 1).contiguous())
    return offsets.int(), torch.where(keys < n_out, order, -1).int()


def embedding_bag_applies(idx, coef_g, coef_d, dtype):
    """The applies as one ``F.embedding_bag(mode="sum")`` call each (the
    library column): grad bags ``(n, d)`` over ``idx[n, :]`` weighted by
    ``coef[n, :, d]`` on the table ``[B N, C]``, straight into ``[B, N,
    2, C]``; div bags of 2K entries over the table viewed ``[B N 2, C]``
    with ids ``2 idx + d``. The ids and weights are made once (as the plan
    is); the weights take the table's dtype, so in bf16 the coefficients
    round to bf16 and the sums are not the kernels'."""
    import torch.nn.functional as F

    b, n, k = idx.shape
    glob = (idx.long() + (torch.arange(b, device=idx.device) * n)[:, None,
                                                                  None])
    g_ids = glob[:, :, None, :].expand(b, n, 2, k).reshape(b * n * 2, k)
    g_w = coef_g.permute(0, 1, 3, 2).reshape(b * n * 2, k).to(dtype)
    d_ids = (2 * glob[..., None] + torch.arange(2, device=idx.device)
             ).reshape(b * n, 2 * k)
    d_w = coef_d.reshape(b * n, 2 * k).to(dtype)

    def grad(x):
        c = x.shape[-1]
        return F.embedding_bag(g_ids, x.reshape(b * n, c), mode="sum",
                               per_sample_weights=g_w).view(b, n, 2, c)

    def div(v):
        c = v.shape[-1]
        return F.embedding_bag(d_ids, v.reshape(b * n * 2, c), mode="sum",
                               per_sample_weights=d_w).view(b, n, c)

    return grad, div


def coef_row_bytes(feat, k=K) -> int:
    """The row bytes that one apply of ``feat`` gathers (K rows a point,
    each rounded up to whole 32-byte sectors, as L2 serves them)."""
    b, n = feat.shape[:2]
    rb = feat[0, 0].numel() * feat.element_size()
    return b * n * k * -(-rb // 32) * 32


def time_coef_kernels(res, idx, gd, plan, pos, dev, card):
    """Times and bounds of the large-cloud kernels at their uniform
    shapes: both applies at every width of a forward, f32 and bf16, on
    route A and (where the rows allow it) the planned route, beside the
    plain versions and two library calls that compute the same function:
    ``torch.gather`` of the K neighbour rows with an ``einsum`` (set-up
    included) and ``F.embedding_bag`` (:func:`embedding_bag_applies`);
    the gather plan's build (its two kernels and the sort between them);
    the scatter on both layouts (the record: edge-major, as the
    coefficient VJPs pass it) and the inverse adjacency alone."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops import coef_apply as ca

    b, n = LARGE_B, LARGE_N
    print(f"[times] large-cloud shapes B={b} N={n} K={K}, card: {card}")
    gc, dc = gd.grad_coef, gd.div_coef
    flat = idx.reshape(b, n * K, 1).long()

    def lib_grad(x):
        rows = torch.gather(x, 1, flat.expand(b, n * K, x.shape[-1]))
        return torch.einsum("bnkd,bnkc->bndc", gc, rows.view(
            b, n, K, -1).float()).to(x.dtype)

    def lib_div(v):
        c2 = 2 * v.shape[-1]
        rows = torch.gather(v.view(b, n, c2), 1, flat.expand(b, n * K, c2))
        return torch.einsum("bnkd,bnkdc->bnc", dc, rows.view(
            b, n, K, 2, -1).float()).to(v.dtype)

    offset = (torch.arange(b, device=dev) * n)[:, None, None]
    flat_rows = (idx.long() + offset).reshape(-1)

    def lib_scatter(g):
        c = g.shape[1]
        rows = g.permute(0, 3, 2, 1).reshape(b * n * K, c)
        out = torch.zeros((b * n, c), device=dev)
        return out.index_add_(0, flat_rows, rows).view(b, n, c)

    from deltaconv_tpu_torch.ops import _lib

    build = median_ms(lambda: ops.coef_plan(pos, idx))
    build_dev = device_ms(lambda: ops.coef_plan(pos, idx))
    print("  gather plan's kernels, device time (profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in kernel_split(
            lambda: ops.coef_plan(pos, idx), PLAN_KERNELS).items()))
    print(f"  gather plan (order, runs): {build:.4f} ms by events, "
          f"{build_dev:.4f} ms of device time; run {plan.run} points, "
          f"{float(plan.run_count.float().mean()):.1f} distinct rows a run "
          f"(max {int(plan.run_count.max())}) of {plan.run * K} edges")
    order = torch.empty((b, n), dtype=torch.int32, device=dev)
    keys = torch.empty((b, -(-n // 1024) * 1024), dtype=torch.int64,
                       device=dev)
    for name, kern, plain, nb in (
            ("coef_plan_order",
             lambda: _lib.launch("coef_plan_order", dev, pos.data_ptr(), 0,
                                 keys.data_ptr(), order.data_ptr(), b, n),
             lambda: torch.sort(ca._morton_codes_plain(pos, None), dim=1,
                                stable=True),
             nbytes(pos, order)),
            ("coef_plan_runs",
             lambda: _lib.launch(
                 "coef_plan_runs", dev, idx.data_ptr(),
                 plan.order.data_ptr(), plan.run_rows.data_ptr(),
                 plan.run_count.data_ptr(), plan.local_slot.data_ptr(), b, n,
                 K, plan.run),
             lambda: ca._plan_runs_plain(idx, plan.order, plan.run),
             nbytes(idx, plan.order, plan.run_rows, plan.run_count,
                    plan.local_slot))):
        km, pm, dm = median_ms(kern), median_ms(plain), device_ms(kern)
        res[name].update(ms=km, plain_ms=pm, bound=bound(nb))
        print(f"  {name}: kernel {km:.4f} ms ({dm:.4f} ms of device time), "
              f"plain {pm:.4f} ms, library none, bound "
              f"{res[name]['bound'][0]:.4f} ms (bytes)")
    totals = {}
    for dt in (torch.bfloat16, torch.float32):
        eb_grad, eb_div = embedding_bag_applies(idx, gc, dc, dt)
        tot = totals.setdefault(str(dt)[6:], {"A": 0.0, "planned": 0.0})
        for name, widths, make, kern, plain, lib_fn, eb, coef in (
                ("coef_apply_grad", APPLY_WIDTHS[0],
                 lambda c: torch.randn((b, n, c), device=dev).to(dt),
                 ops.coef_apply_grad, ops.coef_apply_grad_plain, lib_grad,
                 eb_grad, gc),
                ("coef_apply_div", APPLY_WIDTHS[1],
                 lambda c: torch.randn((b, n, 2, c), device=dev).to(dt),
                 ops.coef_apply_div, ops.coef_apply_div_plain, lib_div,
                 eb_div, dc)):
            for c in widths:
                x = make(c)
                km = median_ms(lambda: kern(x, coef, idx))
                planned = coef_planned(x)
                bm = (median_ms(lambda: kern(x, coef, idx, plan))
                      if planned else None)
                pm = median_ms(lambda: plain(x, coef, idx))
                lm = median_ms(lambda: lib_fn(x))
                em = median_ms(lambda: eb(x))
                out = kern(x, coef, idx)
                # The einsum and embedding_bag sum in another order (and
                # embedding_bag in bf16 rounds the coefficients): a bf16
                # ulp, or f32 rounding, of the output's max; bf16
                # embedding_bag accumulates in bf16: 4 ulps.
                big = float(out.float().abs().max())
                for label, fn, rel in (
                        ("gather + einsum", lib_fn,
                         2.0 ** -7 if dt == torch.bfloat16 else 1e-5),
                        ("embedding_bag", eb,
                         2.0 ** -5 if dt == torch.bfloat16 else 1e-5)):
                    err = max_err(fn(x).float(), out.float())
                    check(f"{name} C={c} {str(dt)[6:]} {label}",
                          err <= rel * big,
                          f"max_abs_err {err:.3e} within {rel:g} x max of "
                          f"the kernel")
                # Each input read once, the output written once; 2 x K
                # products and as many sums an output element (grad: 2 C
                # of them a point, div: C).
                bd = bound(nbytes(x, coef, idx, out),
                           4.0 * b * n * K * c, F32_OPS_PER_S)
                rows = coef_row_bytes(x)
                tot["A"] += km
                tot["planned"] += bm if planned else km
                b_txt = (f"planned {bm:.4f} ms" if planned else
                         "planned: not taken (rows not a multiple of 16 "
                         f"bytes of at least {COEF_PLAN_MIN_ROW_BYTES})")
                print(f"  {name} C={c} {str(dt)[6:]}: route A {km:.4f} ms, "
                      f"{b_txt}, plain {pm:.4f} ms, library gather + "
                      f"einsum {lm:.4f} ms, embedding_bag {em:.4f} ms, "
                      f"bound {bd[0]:.4f} ms ({bd[1]}); rows gathered "
                      f"{rows / 1e6:.1f} MB (route A reads them from L2 "
                      f"at {rows / km / 1e9:.2f} TB/s)", flush=True)
                if dt == torch.bfloat16 and c == RECORD_WIDTH[name]:
                    res[name].update(ms=km, plain_ms=pm, library_ms=em,
                                     bound=bd)
                    res[name + "_plan"].update(ms=bm, plain_ms=pm,
                                               library_ms=em, bound=bd)
                del x, out
    for dt, tot in totals.items():
        print(f"  one forward's eight applies, {dt}: route A {tot['A']:.4f} "
              f"ms; with the plan {tot['planned']:.4f} ms + its build "
              f"{build_dev:.4f} ms (device) = "
              f"{tot['planned'] + build_dev:.4f} ms")
    inv = res["inverse_adjacency"]
    inv.update(ms=median_ms(lambda: ops.inverse_adjacency(idx, n)),
               plain_ms=median_ms(lambda: ops.inverse_adjacency_plain(idx, n)),
               library_ms=median_ms(lambda: inverse_adjacency_library(idx,
                                                                      n)),
               bound=bound(nbytes(idx, *ops.inverse_adjacency(idx, n))))
    check("inverse_adjacency library composition", all(
        torch.equal(a, w) for a, w in zip(inverse_adjacency_library(idx, n),
                                          ops.inverse_adjacency(idx, n))),
        "equal")
    inv_dev = device_ms(lambda: ops.inverse_adjacency(idx, n))
    print(f"  inverse_adjacency: kernel {inv['ms']:.4f} ms ({inv_dev:.4f} ms "
          f"of device time, profiler), plain {inv['plain_ms']:.4f} ms, "
          f"library {inv['library_ms']:.4f} ms, bound {inv['bound'][0]:.4f} "
          f"ms ({inv['bound'][1]})")
    for c in SCATTER_WIDTHS:
        g = torch.randn((b, c, K, n), device=dev)
        for layout, rows in (("component-major", g),
                             ("edge-major", edge_major(g))):
            km = median_ms(lambda: ops.scatter_rows(rows, idx, n))
            pm = median_ms(lambda: ops.scatter_rows_plain(rows, idx, n))
            lm = median_ms(lambda: lib_scatter(rows))
            dm = device_ms(lambda: ops.scatter_rows(rows, idx, n))
            out = ops.scatter_rows(rows, idx, n)
            check(f"scatter_rows C={c} {layout} library composition",
                  max_err(lib_scatter(rows), out)
                  <= SCATTER_RTOL * float(out.abs().max()),
                  "within 1e-5 x max")
            bd = bound(nbytes(g, idx, out), float(g.numel()), ISSUE_PER_S)
            print(f"  scatter_rows C={c} {layout}: kernel {km:.4f} ms "
                  f"({dm:.4f} ms of device time, the inverse adjacency "
                  f"{inv_dev / dm:.3f} of it), plain {pm:.4f} ms, library "
                  f"{lm:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), kernel at "
                  f"{bd[0] / km:.3f} of it, {nbytes(g) / km / 1e6:.1f} GB/s "
                  f"of edge rows")
            if c == RECORD_WIDTH["scatter_rows"] and layout == "edge-major":
                res["scatter_rows"].update(ms=km, plain_ms=pm, library_ms=lm,
                                           bound=bd)
            del out, rows
        del g
    print("  (the JSON record gives the applies at C=256 on bf16 features, "
          "library_ms embedding_bag's; the scatter at C'=512 edge-major, "
          "the inverse adjacency and the plan kernels at these shapes)")


def coef_apply_table(seed, dev, card):
    """``[coef-applies]``: one forward's eight applies (``APPLY_WIDTHS``)
    at B=4, N=8192, K=20 on a surface cloud batch's operators, f32 and
    bf16, each in device time (:func:`device_ms`) through the package's
    public ``ops.coef_apply_grad``/``div``, with the gather plan where
    the package has one (``ops.coef_plan``, and its build; then the
    eight again without it, route A alone). Public
    functions only, as :func:`path_device_times`: copied into another
    checkout's root, it times that checkout's kernels on the same data
    (the seed's)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn

    rng = np.random.default_rng(seed + 16)
    b, n = LARGE_B, LARGE_N
    cl, nm = ellipsoid_clouds(rng, [n] * b)
    pos = torch.from_numpy(np.stack(cl)).to(dev)
    nrm = torch.from_numpy(np.stack(nm)).to(dev)
    idx, nbr_mask = knn(pos, K, None, "approx", ops.knn_topk)
    xb, yb = build_tangent_basis(nrm)
    gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
    plan = ops.coef_plan(pos, idx) if hasattr(ops, "coef_plan") else None
    plan_parts = (kernel_split(lambda: ops.coef_plan(pos, idx),
                               PLAN_KERNELS) if plan else {})
    build = sum(plan_parts.values())
    line = []
    for dt in (torch.bfloat16, torch.float32):
        total = bare = 0.0
        parts = []
        for c_g, c_d in zip(*APPLY_WIDTHS):
            x = torch.randn((b, n, c_g), device=dev).to(dt)
            v = torch.randn((b, n, 2, c_d), device=dev).to(dt)
            args = (plan,) if plan else ()
            tg = device_ms(lambda: ops.coef_apply_grad(x, gd.grad_coef, idx,
                                                       *args), 5)
            td = device_ms(lambda: ops.coef_apply_div(v, gd.div_coef, idx,
                                                      *args), 5)
            parts.append(f"grad C={c_g} {tg:.4f}, div C={c_d} {td:.4f}")
            total += tg + td
            if plan:  # the same applies without the plan: route A
                bare += device_ms(lambda: ops.coef_apply_grad(
                    x, gd.grad_coef, idx), 5)
                bare += device_ms(lambda: ops.coef_apply_div(
                    v, gd.div_coef, idx), 5)
        line.append(f"{str(dt)[6:]}: " + "; ".join(parts)
                    + f"; the eight {total:.4f} + plan {build:.4f} = "
                    f"{total + build:.4f} ms"
                    + (f" (route A alone {bare:.4f} ms)" if plan else ""))
    plan_txt = (" (no gather plan in this package)" if plan is None else
                " (the plan's kernels: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in plan_parts.items()) + ")")
    print(f"[coef-applies] B={b} N={n} K={K}, device time (profiler) of each "
          f"apply{plan_txt}: " + " | ".join(line) + f"; card: {card}",
          flush=True)


def grid_clouds(rng, b, n, dev):
    """``[b, n, 3]`` points of a coarse 9^3 grid (steps of 0.25) with many
    duplicates: equal scores and equal quantized keys abound."""
    return torch.from_numpy((rng.integers(-4, 5, (b, n, 3)) * 0.25).astype(
        np.float32)).to(dev)


def knn_kernel_phase(res, rng, dev, card):
    """``[kernels]`` knn_topk at the model shapes (KNN_SHAPES), packed and
    exact, with and without the mean distances, on ellipsoid clouds and on
    a tie-heavy grid: ids and distances bit-equal to the plain versions;
    knn_topk_rounds (K = KNN_ROUNDS_K) at KNN_ROUNDS_SHAPES, the same way.
    Then each shape's times: kernel, plain version, the library
    composition (``matmul`` + ``topk``) and the bound (the work the
    function needs: KNN_INSTR_PER_PAIR issue slots a pair packed,
    TABLE_INSTR exact); knn_topk_rounds' record at B=4, N=1024. Its clouds
    come from a generator spawned off ``rng``, which leaves ``rng``'s
    draws, and so every other phase's data, as they were."""
    from deltaconv_tpu_torch import ops

    rng = rng.spawn(1)[0]

    def record(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    def held(name, label, pos, k, quantized):
        got = ops.knn_topk(pos, k, quantized)
        idx, md = ops.knn_topk(pos, k, quantized, return_mean_dist=True)
        want = ops.knn_topk_plain(pos, k, quantized)
        _, md_p = ops.knn_topk_plain(pos, k, quantized, True)
        record(name, max_err(got.float(), want.float()))
        record("knn_topk_mean_dist" if name == "knn_topk" else name,
               max_err(md, md_p))
        body = "packed" if quantized else "exact"
        check(f"{name} {label} {body}",
              torch.equal(got, want) and torch.equal(idx, want)
              and torch.equal(md, md_p),
              f"{int((got != want).sum())} ids differ, mean distances "
              f"bit-equal {torch.equal(md, md_p)}")

    for b, n, k in KNN_SHAPES:
        print(f"[kernels] knn_topk B={b} N={n} K={k}", flush=True)
        clouds, _ = ellipsoid_clouds(rng, [n] * b)
        for label, pos in (
                ("ellipsoids", torch.from_numpy(np.stack(clouds)).to(dev)),
                ("grid", grid_clouds(rng, b, n, dev))):
            for quantized in (True, False):
                held("knn_topk", f"B={b} N={n} K={k} {label}", pos, k,
                     quantized)
    for b, n in KNN_ROUNDS_SHAPES:
        print(f"[kernels] knn_topk_rounds B={b} N={n} K={KNN_ROUNDS_K}",
              flush=True)
        gauss = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(
            np.float32)).to(dev)
        for label, pos in (("gaussian", gauss),
                           ("grid", grid_clouds(rng, b, n, dev))):
            for quantized in (True, False):
                held("knn_topk_rounds", f"B={b} N={n} K={KNN_ROUNDS_K} "
                     f"{label}", pos, KNN_ROUNDS_K, quantized)
    torch.cuda.synchronize()

    print(f"[times] knn_topk per call, median of CUDA-event samples of "
          f"{INNER} calls ({REPS} at N={N}, {KNN_BIG_REPS} above), card: "
          f"{card}")
    for b, n, k in KNN_SHAPES:
        clouds, _ = ellipsoid_clouds(rng, [n] * b)
        pos = torch.from_numpy(np.stack(clouds)).to(dev)
        reps = REPS if n <= N else KNN_BIG_REPS
        lib = median_ms(lambda: torch.topk(
            2.0 * torch.matmul(pos, pos.transpose(1, 2))
            - (pos * pos).sum(-1)[:, None, :], k, dim=-1), reps)
        for quantized in (True, False):
            for md in (False, True):
                out = ops.knn_topk(pos, k, quantized, md)
                km = median_ms(lambda: ops.knn_topk(pos, k, quantized, md),
                               reps)
                pl = median_ms(lambda: ops.knn_topk_plain(pos, k, quantized,
                                                          md), reps)
                bd = bound(nbytes(pos, *(out if md else (out,))),
                           float(b) * n * n * (KNN_INSTR_PER_PAIR if quantized
                                               else TABLE_INSTR),
                           ISSUE_PER_S)
                body = "packed" if quantized else "exact"
                print(f"  knn_topk B={b} N={n} K={k} {body}"
                      f"{' mean_dist' if md else ''}: kernel {km:.4f} ms, "
                      f"plain {pl:.4f} ms, library (matmul + topk) "
                      f"{lib:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), kernel "
                      f"at {bd[0] / km:.3f} of it", flush=True)
        del pos
    b, n = KNN_ROUNDS_SHAPES[0]
    pos = torch.from_numpy(np.stack(ellipsoid_clouds(rng, [n] * b)[0])).to(
        dev)
    r = res["knn_topk_rounds"]
    r["ms"] = median_ms(lambda: ops.knn_topk(pos, KNN_ROUNDS_K, True))
    r["plain_ms"] = median_ms(lambda: ops.knn_topk_plain(pos, KNN_ROUNDS_K,
                                                         True))
    r["library_ms"] = median_ms(lambda: torch.topk(
        2.0 * torch.matmul(pos, pos.transpose(1, 2))
        - (pos * pos).sum(-1)[:, None, :], KNN_ROUNDS_K, dim=-1))
    r["bound"] = bound(nbytes(pos, ops.knn_topk(pos, KNN_ROUNDS_K, True)),
                       float(b) * n * n * KNN_INSTR_PER_PAIR, ISSUE_PER_S)
    print(f"  knn_topk_rounds B={b} N={n} K={KNN_ROUNDS_K} packed: kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]})", flush=True)


def knn_rounds_phase(rng, dev):
    """``[knn-rounds]``: ``geometry.knn`` (approximate) with KNN_ROUNDS_K
    neighbours on 4 ellipsoid clouds of N points (from a generator spawned
    off ``rng``): one launch of knn_topk_rounds, none of knn_topk, ids
    equal to the plain version."""
    from deltaconv_tpu_torch import (launch_counts, ops,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.geometry import knn

    rng = rng.spawn(1)[0]

    clouds, _ = ellipsoid_clouds(rng, [N] * 4)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    idx, _ = knn(pos, KNN_ROUNDS_K, None, "approx")
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[knn-rounds] launches of one kNN with k={KNN_ROUNDS_K}: "
          f"{ {n: c for n, c in counts.items() if c} }")
    check("[knn-rounds] knn_topk_rounds once, knn_topk never",
          counts["knn_topk_rounds"] == 1 and counts["knn_topk"] == 0,
          f"{counts['knn_topk_rounds']} and {counts['knn_topk']} launches")
    want = ops.knn_topk_plain(pos, KNN_ROUNDS_K, True)
    check("[knn-rounds] ids equal to the plain version",
          torch.equal(idx, want), f"{int((idx != want).sum())} differ")
    return counts


def coef_kernel_phase(res, rng, dev, card):
    """[kernels] of the large-cloud path: the gather plan's kernels equal
    to the plain builder entry by entry, the applies' and the scatter's
    checks on uniform and masked graphs, then times at the uniform
    shapes."""
    from deltaconv_tpu_torch import ops

    cases = large_graphs(rng, dev)

    def record(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    plans = {}
    for label, (idx, gd, pos, mask) in cases.items():
        print(f"[kernels] large-cloud shapes B={LARGE_B} N={LARGE_N} K={K}, "
              f"{label}", flush=True)
        plan = ops.coef_plan(pos, idx, mask)
        same = plan_equal(plan, ops.coef_plan_plain(pos, idx, mask))
        for name in ("coef_plan_order", "coef_plan_runs"):
            record(name, 0.0 if same else float("inf"))
        check("gather plan", same and plan_equal(
            ops.coef_plan(pos, idx, mask), plan),
              "order, run rows, counts and local slots equal to the plain "
              "builder's and across two calls")
        check_coef_kernels(record, idx, gd, plan, dev)
        plans[label] = plan
    idx, gd, pos, _ = cases["uniform"]
    time_coef_kernels(res, idx, gd, plans["uniform"], pos, dev, card)


def large_clouds(rng):
    """LARGE_UNIFORM clouds of LARGE_N points, then LARGE_RAGGED - 1 of
    LARGE_MIN_POINTS..LARGE_N points and the first uniform one again."""
    uni, uni_n = ellipsoid_clouds(rng, [LARGE_N] * LARGE_UNIFORM)
    sizes = rng.integers(LARGE_MIN_POINTS, LARGE_N,
                         LARGE_RAGGED - 1).tolist()
    rag, rag_n = ellipsoid_clouds(rng, sizes)
    return uni, uni_n, rag + uni[:1], rag_n + uni_n[:1]


def coef_launches_held(counts, calls, what):
    """Each apply launched 4 times a call, each route as its widths
    select it (COEF_PER_FORWARD), the gather plan built once a call."""
    for name, per in COEF_PER_FORWARD.items():
        check(f"{name} {per} a {what}", counts[name] == per * calls,
              f"{counts[name]} launches in {calls} {what}s")
    for name, per in APPLIES_PER_FORWARD.items():
        got = counts[name] + counts[name + "_plan"]
        check(f"{name}, both routes, {per} a {what}", got == per * calls,
              f"{got} launches in {calls} {what}s")


def serve_large_phase(clouds, seed, dev, card, precision):
    """Large-cloud serving: the reference-width classifier in coefficient
    form (``dense_operators=False``, approximate kNN) through
    ``InferenceEngine(num_points=8192, batch_size=4)``, at
    ``precision="bfloat16"`` or None (f32), counting launches (4 grad
    and 4 div applies a forward)."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    tag = "serve-large" + ("-bf16" if precision else "-f32")
    model = random_model(seed, dev, knn_method="approx",
                         dense_operators=False)
    kw = dict(num_points=LARGE_N, batch_size=LARGE_B)
    engine = InferenceEngine(model, precision=precision, **kw)
    plain = InferenceEngine(model, precision=precision, ops=PLAIN_OPS, **kw)
    uni, uni_n, rag, rag_n = clouds

    engine.predict(uni[:LARGE_B], uni_n[:LARGE_B])  # warm-up
    engine.predict(rag, rag_n)
    torch.cuda.synchronize()

    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits_u = engine.predict(uni, uni_n)
        times.append(time.perf_counter() - t0)
    logits_r = engine.predict(rag, rag_n)
    counts = launch_counts()
    forwards = 3 * (LARGE_UNIFORM // LARGE_B) + 1
    path = LARGE_KERNELS[precision]
    print(f"[{tag}] launches during serving ({forwards} forwards): {counts}")
    print(f"[{tag}] launches per forward: " + ", ".join(
        f"{name} {counts[name] / forwards:g}" for name in path))

    print(f"[{tag}] checks")
    check("uniform logits", logits_u.shape == (LARGE_UNIFORM, NUM_CLASSES)
          and bool(np.isfinite(logits_u).all()), f"shape {logits_u.shape}")
    check("ragged logits", logits_r.shape == (LARGE_RAGGED, NUM_CLASSES)
          and bool(np.isfinite(logits_r).all()), f"shape {logits_r.shape}")
    for name in path:
        check(f"{name} launched", counts[name] > 0, f"{counts[name]} launches")
    coef_launches_held(counts, forwards, "forward")
    if precision:
        matmul_max_once("gather_matmul_max", counts, forwards, "forward")
        for name, per in BF16_PER_FORWARD.items():
            check(f"{name} {per} a forward", counts[name] == per * forwards,
                  f"{counts[name]} launches in {forwards} forwards")
    check("no dense assembly", counts["densify"] + counts["densify_bf16"]
          == 0, "densify launched 0 times")
    refs = {}
    for label, cl, normals, got in (("uniform", uni, uni_n, logits_u),
                                    ("ragged", rag, rag_n, logits_r)):
        ref = plain.predict(cl, normals)
        if precision:
            held_to(f"{label} kernel vs plain path", got, ref, BF16_PATH_REL)
            held_to(f"{label} {precision} vs the f32 engine", got,
                    InferenceEngine(model, **kw).predict(cl, normals),
                    BF16_REL)
        else:
            held_abs(f"{label} kernel vs plain", got, ref, LOGIT_ATOL)
        refs[label] = ref
    t = float(np.median(times))
    n_batches = LARGE_UNIFORM // LARGE_B
    print(f"[{tag}] {LARGE_UNIFORM} uniform clouds (N={LARGE_N}, batch "
          f"{LARGE_B}, dense_operators=False, knn_method=approx, precision="
          f"{precision}): median {t * 1e3:.3f} ms per call of {n_batches} "
          f"batches, {t * 1e3 / n_batches:.3f} ms per batch, "
          f"{LARGE_UNIFORM / t:.2f} clouds/s (host clock, synchronised), "
          f"card: {card}")
    profile(tag, f"one {LARGE_UNIFORM}-cloud predict call",
            lambda: engine.predict(uni, uni_n), t * 1e3)
    return counts


def coef_vs_dense_phase(clouds, seed, dev, card):
    """The same weights served with coefficient-form and with dense
    operators, f32, B=32, N=1024: the logits agree (both apply the same
    coefficients); then one forward's 8 applies (``APPLY_WIDTHS``) in
    both forms, f32 and bf16, at N = 1024 .. 8192, the coefficient form
    with its gather plan (and the plan's build, once a forward), the dense
    form with and without its assembly (``densify``), on knn_topk
    graphs. This
    measures the JAX package's TPU choice (dense below about 4k points)
    on the card; it routes nothing."""
    from deltaconv_tpu_torch import KERNEL_OPS, InferenceEngine, ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
    from deltaconv_tpu_torch.geometry.dense import densify

    uni, uni_n = clouds[:2]
    kw = dict(num_points=N, batch_size=B)
    got = InferenceEngine(random_model(seed, dev, dense_operators=False),
                          **kw).predict(uni, uni_n)
    ref = InferenceEngine(random_model(seed, dev), **kw).predict(uni, uni_n)
    held_abs("coefficient form vs dense form, f32", got, ref, LOGIT_ATOL)

    print(f"[coef-vs-dense] one forward's 4 grad and 4 div applies (widths "
          f"{APPLY_WIDTHS}), median of {CROSSOVER_REPS} samples; card: "
          f"{card}")
    rng = np.random.default_rng(seed)
    for b, n in CROSSOVER:
        cl, nm = ellipsoid_clouds(rng, [n] * b)
        pos = torch.from_numpy(np.stack(cl)).to(dev)
        nrm = torch.from_numpy(np.stack(nm)).to(dev)
        idx, nbr_mask = knn(pos, K, None, "approx", ops.knn_topk)
        xb, yb = build_tangent_basis(nrm)
        gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
        plan_ms = median_ms(lambda: ops.coef_plan(pos, idx), CROSSOVER_REPS)
        gd = dataclasses.replace(gd, plan=ops.coef_plan(pos, idx))
        line = []
        for dt in (torch.float32, torch.bfloat16):
            dense_dt = None if dt == torch.float32 else dt
            dgd = densify(gd, KERNEL_OPS, dense_dt)
            build = median_ms(lambda: densify(gd, KERNEL_OPS, dense_dt),
                              CROSSOVER_REPS)
            totals = {"coef": 0.0, "dense": 0.0}
            for c_g, c_d in zip(*APPLY_WIDTHS):
                x = torch.randn((b, n, c_g), device=dev).to(dt)
                v = torch.randn((b, n, 2, c_d), device=dev).to(dt)
                for form, op in (("coef", gd), ("dense", dgd)):
                    totals[form] += median_ms(lambda: op.grad(x),
                                              CROSSOVER_REPS)
                    totals[form] += median_ms(lambda: op.div(v),
                                              CROSSOVER_REPS)
            line.append(f"{str(dt)[6:]} coef {totals['coef']:.4f} (+ plan "
                        f"{plan_ms:.4f} = {totals['coef'] + plan_ms:.4f}), "
                        f"dense "
                        f"{totals['dense']:.4f} (+ densify {build:.4f} = "
                        f"{totals['dense'] + build:.4f})")
            del dgd
        print(f"  B={b} N={n}: " + "; ".join(line) + " ms")


def compare_coef_steps(label, batch, seed, dev):
    """One large-cloud bf16 step through the kernels and through the same
    kernels with only the coefficient-form applies (and so their
    ``scatter_rows`` backward) on the plain route, from the same weights,
    dropout 0: the applies are bit-equal, so the forward is, and the loss
    and the running statistics must be equal; the gradients differ only
    by the order of the scatters' sums (the plain ``scatter_add_`` adds
    with atomics, the kernel in edge order), held to COEF_GRAD_FROB (relative
    Frobenius over all tensors; a one-ulp bf16 cast of a cotangent can
    move a max winner)."""
    from deltaconv_tpu_torch import KERNEL_OPS, PLAIN_OPS

    applies = KERNEL_OPS._replace(coef_apply_grad=PLAIN_OPS.coef_apply_grad,
                                  coef_apply_div=PLAIN_OPS.coef_apply_div)
    config = dict(knn_method="approx", precision="bfloat16",
                  dense_operators=False)
    lk, mk = train_once(batch, seed, dev, KERNEL_OPS, **config)
    lp, mp = train_once(batch, seed, dev, applies, **config)
    bufs_p = dict(mp.named_buffers())
    same = all(torch.equal(b, bufs_p[name]) for name, b in mk.named_buffers())
    check(f"{label} loss and statistics, kernels vs plain applies",
          lk == lp and same, f"loss {lk} vs {lp}, statistics equal {same}")
    whole = _deviations(mk, mp)["grad"][0]
    check(f"{label} grads, kernels vs plain applies", whole <= COEF_GRAD_FROB,
          f"relative Frobenius deviation over all tensors {whole:.3e} <= "
          f"{COEF_GRAD_FROB}")


def train_large_phase(rng, seed, dev, card):
    """The large-cloud train step (bench.py --mode=large-train): bf16
    compute, coefficient-form operators, approximate kNN, B=4, N=8192,
    SGD lr 0.01, smoothing 0.2, dropout 0.5 from a seeded CUDA generator,
    LARGE_STEPS steps on one batch of class-conditioned ellipsoids; then
    kernels vs plain versions from the same weights (dropout 0, same
    build), uniform and ragged, held as the bf16 step of the reference
    recipe is (:func:`compare_bf16_steps`)."""
    from deltaconv_tpu_torch import launch_counts, reset_launch_counts
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    uniform = train_batch(rng, dev, [LARGE_N] * LARGE_B, LARGE_N)
    ragged = train_batch(rng, dev, rng.integers(
        LARGE_MIN_POINTS, LARGE_N + 1, LARGE_B).tolist(), LARGE_N)
    config = dict(knn_method="approx", precision="bfloat16",
                  dense_operators=False)
    model = random_model(seed, dev, affine=False, **config)
    state = create_train_state(model, sgd_momentum(LARGE_LR))
    step = make_train_step(model, smoothing=0.2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    warm = random_model(seed + 1, dev, **config)  # warm-up
    make_train_step(warm)(create_train_state(warm, sgd_momentum(LARGE_LR)),
                          uniform, torch.Generator(device=dev).manual_seed(1))
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(LARGE_STEPS):
        t0 = time.perf_counter()
        metrics = step(state, uniform, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train-large] launches during {LARGE_STEPS} steps: {counts}")
    print("[train-large] launches per step: " + ", ".join(
        f"{name} {counts[name] / LARGE_STEPS:g}"
        for name in TRAIN_LARGE_KERNELS))
    print(f"[train-large] losses: {[round(x, 4) for x in losses]}")
    check("large train losses finite", bool(np.isfinite(losses).all()),
          f"{LARGE_STEPS} steps")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check("large train loss falls", last < first,
          f"mean of last 3 {last:.4f} < mean of first 3 {first:.4f}")
    for name in TRAIN_LARGE_KERNELS:
        check(f"{name} launched in large training", counts[name] > 0,
              f"{counts[name]} launches")
    matmul_max_once("gather_matmul_max_win", counts, LARGE_STEPS, "step")
    coef_launches_held(counts, LARGE_STEPS, "step")
    # conv0's edge moments: one streaming sum a step, on route S.
    per_step = dict(scatter_rows=SCATTERS_PER_STEP,
                    inverse_adjacency=SCATTERS_PER_STEP + 1, gather_sum=1,
                    gather_sum_direct=0)
    for name, per in per_step.items():
        check(f"{name} {per} a step", counts[name] == per * LARGE_STEPS,
              f"{counts[name]} launches in {LARGE_STEPS} steps")
    t = float(np.median(times))
    print(f"[train-large] B={LARGE_B} N={LARGE_N} K={K}, reference width, "
          f"dense_operators=False, bf16, knn_method=approx: median "
          f"{t * 1e3:.3f} ms per train step, {LARGE_B / t:.2f} training "
          f"clouds/s (host clock, synchronised after each step), peak "
          f"{peak:.2f} GiB allocated, card: {card}")
    profile("train-large", "one step", lambda: step(state, uniform, gen),
            t * 1e3)

    print("[train-large] kernel path vs plain path, one step from the same "
          "weights, dropout 0, same build")
    for label, batch in (("uniform", uniform), ("ragged", ragged)):
        compare_coef_steps(f"large {label}", batch, seed, dev)
        compare_bf16_steps(f"large {label}", batch, seed, dev,
                           dense_operators=False, hold_params=False)
    return counts


def seg_train_batch(rng, dev, sizes):
    """One batch of ellipsoid clouds of up to SEG_N points with categories
    and per-point part labels that follow the category and the point's
    octant (learnable from the positions), padded with a point mask when
    ragged."""
    clouds, normals = ellipsoid_clouds(rng, sizes)
    cats = rng.integers(0, 16, len(sizes))
    pos = np.zeros((len(sizes), SEG_N, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32),
                  (len(sizes), SEG_N, 1))
    labels = np.zeros((len(sizes), SEG_N), np.int64)
    for i, (c, q) in enumerate(zip(clouds, normals)):
        pos[i, :len(c)], nrm[i, :len(c)] = c, q
        octant = (c[:, 0] > 0) + 2 * (c[:, 1] > 0) + 4 * (c[:, 2] > 0)
        labels[i, :len(c)] = (3 * cats[i] + octant) % SEG_CLASSES
    batch = {"pos": torch.from_numpy(pos).to(dev),
             "normal": torch.from_numpy(nrm).to(dev),
             "label": torch.from_numpy(labels).to(dev),
             "category": torch.eye(16, device=dev)[
                 torch.from_numpy(cats).to(dev)]}
    if min(sizes) < SEG_N:
        batch["point_mask"] = torch.from_numpy(
            np.arange(SEG_N)[None, :] < np.asarray(sizes)[:, None]).to(dev)
    return batch


def seg_train_once(batch, seed, dev, ops, precision=None, knn_method="exact",
                   dense_operators=True):
    """One per-point step of a fresh segmentation model (dropout 0,
    smoothing 0, lr SEG_LR) through ``ops``; the configuration as
    :func:`random_seg_model`'s."""
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    model = random_seg_model(seed, dev, knn_method, dense_operators,
                             dropout=0.0, affine=False, precision=precision)
    state = create_train_state(model, sgd_momentum(SEG_LR))
    metrics = make_train_step(model, smoothing=0.0, per_point=True,
                              ops=ops)(state, batch, None)
    return float(metrics["loss"]), model


def seg_train_steps(tag, batch, seed, dev, card, steps, **config):
    """``steps`` timed train steps of the bench's seg train config
    (dropout 0.5 from a seeded CUDA generator) after a warm-up model's
    step; returns the launch counts, the losses, the median host time of
    a step and the peak memory, and prints a profile of one more step."""
    from deltaconv_tpu_torch import launch_counts, reset_launch_counts
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    model = random_seg_model(seed, dev, affine=False, **config)
    state = create_train_state(model, sgd_momentum(SEG_LR))
    step = make_train_step(model, smoothing=0.0, per_point=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    warm = random_seg_model(seed + 1, dev, **config)
    make_train_step(warm, smoothing=0.0, per_point=True)(
        create_train_state(warm, sgd_momentum(SEG_LR)), batch,
        torch.Generator(device=dev).manual_seed(1))
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = float(np.median(times))
    print(f"[{tag}] losses: {[round(x, 4) for x in losses]}")
    print(f"[{tag}] B={SEG_B} N={SEG_N} K={SEG_K}, ShapeNet config, "
          f"{config}: median seg_train_step_ms {t * 1e3:.3f}, "
          f"{SEG_B / t:.2f} training clouds/s (host clock, synchronised "
          f"after each step), peak {peak:.2f} GiB allocated, card: {card}")
    profile(tag, "one step", lambda: step(state, batch, gen), t * 1e3)
    return counts, losses


def train_seg_bf16_phase(rng, seed, dev, card):
    """Segmentation training at bench.py's seg train config, the first
    conv on each of its two bf16 branches (``_EDGE_FUSED_TRAIN`` off, the
    JAX default, and on): 20 steps each, kernels vs plain versions, and
    the branches against each other."""
    from deltaconv_tpu_torch import KERNEL_OPS

    dc = importlib.import_module("deltaconv_tpu_torch.nn.deltaconv")
    uniform = seg_train_batch(rng, dev, [SEG_N] * SEG_B)
    ragged = seg_train_batch(rng, dev, rng.integers(
        SEG_N * 600 // 1024, SEG_N + 1, SEG_B).tolist())
    config = dict(knn_method="approx", precision="bfloat16")
    tag = "train-seg-bf16"
    counts = {}
    try:
        for fused in (False, True):
            dc._EDGE_FUSED_TRAIN = fused
            branch = "fused" if fused else "reference"
            print(f"[{tag}] conv0 branch: {branch} (_EDGE_FUSED_TRAIN = "
                  f"{fused})", flush=True)
            counts[fused], losses = seg_train_steps(
                f"{tag} {branch}", uniform, seed, dev, card, SEG_TRAIN_STEPS,
                **config)
            path = SEG_TRAIN_KERNELS if fused else SEG_TRAIN_REF_KERNELS
            c = counts[fused]
            print(f"[{tag} {branch}] launches per step: " + ", ".join(
                f"{name} {c[name] / SEG_TRAIN_STEPS:g}"
                for name in SEG_TRAIN_KERNELS))
            check(f"{branch} losses finite", bool(np.isfinite(losses).all()),
                  f"{SEG_TRAIN_STEPS} steps")
            first, last = (float(np.mean(losses[:5])),
                           float(np.mean(losses[-5:])))
            check(f"{branch} loss falls", last < first,
                  f"mean of last 5 {last:.4f} < mean of first 5 {first:.4f}")
            for name in path:
                check(f"{name} launched", c[name] > 0, f"{c[name]} launches")
            for name in EDGE_STEP_KERNELS:
                per = int(fused)
                check(f"{name} {per} a step", c[name] == per * SEG_TRAIN_STEPS,
                      f"{c[name]} launches in {SEG_TRAIN_STEPS} steps")
        for fused in (False, True):
            dc._EDGE_FUSED_TRAIN = fused
            branch = "fused" if fused else "reference"
            print(f"[{tag} {branch}] kernel path vs plain path, one step from "
                  "the same weights, dropout 0, same build")
            for label, batch in (("uniform", uniform), ("ragged", ragged)):
                compare_bf16_steps(f"seg {branch} {label}", batch, seed, dev,
                                   once=seg_train_once)
        print(f"[{tag}] the two conv0 branches, one step from the same "
              f"weights (kernels, dropout 0)")
        for label, batch in (("uniform", uniform), ("ragged", ragged)):
            runs = {}
            for fused in (False, True):
                dc._EDGE_FUSED_TRAIN = fused
                runs[fused] = seg_train_once(batch, seed, dev, KERNEL_OPS,
                                             **config)
            (lr, mr), (lf, mf) = runs[False], runs[True]
            check(f"{label} loss fused vs reference",
                  abs(lf - lr) <= BRANCH_TOL * abs(lr),
                  f"{lf} vs {lr}, rel {abs(lf - lr) / abs(lr):.3e} <= "
                  f"{BRANCH_TOL}")
            bufs_r = dict(mr.named_buffers())
            worst = (0.0, "")
            for name, b in mf.named_buffers():
                r = bufs_r[name]
                excess = float(((b - r).abs() - BRANCH_TOL * r.abs()).max())
                worst = max(worst, (excess, name))
            check(f"{label} running statistics fused vs reference",
                  worst[0] <= BRANCH_TOL,
                  f"worst |fused - ref| - {BRANCH_TOL} |ref| = {worst[0]:.3e} "
                  f"<= {BRANCH_TOL} ({worst[1]})")
    finally:
        dc._EDGE_FUSED_TRAIN = False
    return counts[True]


def train_seg_f32_phase(rng, seed, dev, card):
    """A few f32 segmentation steps (exact kNN), then kernels vs plain
    versions from the same weights, same build, held as the f32
    classification step is."""
    uniform = seg_train_batch(rng, dev, [SEG_N] * SEG_B)
    ragged = seg_train_batch(rng, dev, rng.integers(
        SEG_N * 600 // 1024, SEG_N + 1, SEG_B).tolist())
    tag = "train-seg-f32"
    counts, losses = seg_train_steps(tag, uniform, seed, dev, card,
                                     SEG_F32_STEPS)
    print(f"[{tag}] launches per step: " + ", ".join(
        f"{name} {counts[name] / SEG_F32_STEPS:g}"
        for name in SEG_TRAIN_F32_KERNELS))
    check("f32 seg losses finite", bool(np.isfinite(losses).all()),
          f"{SEG_F32_STEPS} steps")
    for name in SEG_TRAIN_F32_KERNELS:
        check(f"{name} launched", counts[name] > 0, f"{counts[name]} launches")
    print(f"[{tag}] kernel path vs plain path, one step from the same "
          "weights, dropout 0, same build")
    for label, batch in (("uniform", uniform), ("ragged", ragged)):
        compare_steps(f"seg f32 {label}", batch, seed, dev, True,
                      once=seg_train_once)
    return counts


def knn_library(pos_q, pos_t, k, row_offset=0, point_mask=None,
                row_chunk=1024):
    """The library call of the table kNN: per chunk of query rows, the
    score block by ``torch.matmul`` (full f32) and ``torch.topk`` of K + 1
    columns, the self column pinned, masked ones at -2e30. Returns the K
    ids and the gap between the K-th and (K+1)-th scores."""
    sqt = (pos_t * pos_t).sum(-1)
    cols = torch.arange(pos_t.shape[0], device=pos_t.device)
    ids, gaps = [], []
    for start in range(0, pos_q.shape[0], row_chunk):
        q = pos_q[start:start + row_chunk]
        s = (2.0 * torch.matmul(q, pos_t.T) - (q * q).sum(-1, keepdim=True)
             - sqt)
        rows = row_offset + start + torch.arange(q.shape[0],
                                                 device=q.device)
        s = torch.where(rows[:, None] == cols, 2e30, s)
        if point_mask is not None:
            s = torch.where(point_mask, s, -2e30)
        v, i = torch.topk(s, k + 1, dim=-1)
        ids.append(i[:, :k])
        gaps.append(v[:, k - 1] - v[:, k])
    return torch.cat(ids), torch.cat(gaps)


def same_winner_sets(label, got, pos_q, pos_t, k, row_offset=0,
                     point_mask=None, rows=None):
    """Winner sets of an exact kNN equal to the library call's on the
    query ``rows`` (default all), except on rows whose K-th and (K+1)-th
    library scores lie within SHARD_TIE_REL x (1 + |q|^2) of each other
    (the matmul rounds the scores otherwise than the kernels' elementwise
    FMAs)."""
    lib, gap = knn_library(pos_q, pos_t, k, row_offset, point_mask)
    tie = gap <= SHARD_TIE_REL * (1.0 + (pos_q * pos_q).sum(-1))
    same = (torch.sort(got.long(), 1).values
            == torch.sort(lib, 1).values).all(1)
    held = ~tie if rows is None else ~tie & rows
    bad = int((~same & held).sum())
    check(f"{label}: winner sets vs chunked matmul + topk", bad == 0,
          f"{bad} of {int(held.sum())} rows differ ({int(tie.sum())} "
          f"near-tie rows exempt, {int((~same).sum())} differ in all)")


def shard_cloud(rng, n, masked=False, shift=0.0):
    """One surface cloud on the card (an ellipsoid with its normals); a
    point mask hiding SHARD_MASK_FRAC of it when ``masked``."""
    (pos,), (nrm,) = ellipsoid_clouds(rng, [n])
    pos = torch.from_numpy(pos + np.float32(shift)).cuda()
    pm = None
    if masked:
        pm = torch.from_numpy(rng.random(n) >= SHARD_MASK_FRAC).cuda()
    return pos, torch.from_numpy(nrm).cuda(), pm


def sweep_args(pos, k, quantized):
    """The arguments that ``knn_topk_bucketed`` gives its candidate sweep
    on the uniform cloud ``pos`` (default buckets a query tile)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops import knn_bucketed as kb

    captured = {}

    def spy(*args):
        captured["args"] = args
        return kb._cand_kernel(*args)

    kb._bucketed(pos, pos, k, 0, None, 64, 256, 24 if quantized else 32,
                 quantized, 2048, spy, ops.knn_topk_table)
    return captured["args"]


def sweep_library(args):
    """The candidate sweep's library call: gather the candidate planes,
    score them with one ``bmm``, pin self out, ``torch.topk``."""
    posq, sqq, srow, comb, perm, cand, _, ks, _, _ = args
    nqt = cand.shape[0]
    planes = comb[cand.long()].permute(0, 2, 1, 3).reshape(nqt, 4, -1)
    orig = perm.view(-1, comb.shape[-1])[cand.long()].reshape(nqt, 1, -1)
    q = posq.view(nqt, -1, 3)
    qa = torch.cat([2.0 * q, -torch.ones_like(q[..., :1])], -1)
    s = torch.bmm(qa, planes) - sqq.view(nqt, -1, 1)
    s = torch.where(orig == srow.view(nqt, -1, 1), -3e38, s)
    return torch.topk(s, ks, dim=-1)


def shard_kernel_phase(res, rng, card):
    """[kernels] of the point-sharded path at its shapes: knn_topk_table
    (exact and quantized) at Nq = Nt = 8192 (K=20 and the segmentation
    slice's K=30) and in its repair form (2048 row_ids against 65,536
    columns), knn_topk_bucketed (exact and quantized) at N=65,536, K=20,
    uniform, masked, and 100 units from the origin: ids equal to the
    plain versions; exact winner sets equal to the library call's; the
    table-form build's gather_rows and wls at the bench cloud's shapes.
    Then times, bounds and library times at the uniform shapes."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis
    from deltaconv_tpu_torch.ops import knn_bucketed as kb
    from deltaconv_tpu_torch.ops.wls_fused import build_grad_div_tables

    def record(name, got, want):
        err = float((got.long() - want.long()).abs().max())
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        return err

    print(f"[kernels] point-shard shapes: table Nq = Nt = {SHARD_TABLE_N}, "
          f"repair {SHARD_REPAIR_ROWS} x {SHARD_N}, bucketed N={SHARD_N}",
          flush=True)
    for masked in (False, True):
        pos, _, pm = shard_cloud(rng, SHARD_TABLE_N, masked)
        for quantized in (False, True):
            name = "knn_topk_table_q" if quantized else "knn_topk_table"
            for k in (K, SEG_K):
                got = ops.knn_topk_table(pos, pos, k, 0, pm,
                                         quantized=quantized)
                want = ops.knn_topk_table_plain(pos, pos, k, 0, pm,
                                                quantized=quantized)
                err = record(name, got, want)
                check(f"{name} K={k} masked={masked}",
                      torch.equal(got, want), f"ids equal, max |diff| {err}")
                if not quantized:
                    same_winner_sets(f"{name} K={k} masked={masked}", got,
                                     pos, pos, k, 0, pm)
    pos, _, pm = shard_cloud(rng, SHARD_N, masked=True)
    rows = torch.randperm(SHARD_N, device=pos.device)[:SHARD_REPAIR_ROWS]
    rows = rows.int()
    got = ops.knn_topk_table(pos[rows.long()], pos, K, point_mask=pm,
                             row_ids=rows)
    want = ops.knn_topk_table_plain(pos[rows.long()], pos, K, point_mask=pm,
                                    row_ids=rows)
    err = record("knn_topk_table", got, want)
    check("knn_topk_table repair form", torch.equal(got, want),
          f"ids equal, max |diff| {err}")

    clouds = {"uniform": shard_cloud(rng, SHARD_N),
              "masked": shard_cloud(rng, SHARD_N, masked=True),
              "shifted": shard_cloud(rng, SHARD_N, shift=SHARD_SHIFT)}
    for label, (pos, _, pm) in clouds.items():
        for quantized in (False, True):
            name = "knn_topk_bucketed_q" if quantized else "knn_topk_bucketed"
            got = ops.knn_topk_bucketed(pos, pos, K, 0, pm,
                                        quantized=quantized)
            branch = dict(kb.last_branch)
            want = ops.knn_topk_bucketed_plain(pos, pos, K, 0, pm,
                                               quantized=quantized)
            err = record(name, got, want)
            check(f"{name} {label}", torch.equal(got, want),
                  f"ids equal, max |diff| {err}; exact mode's branch "
                  f"{branch or '-'}")
            if quantized:
                continue
            if label == "shifted":
                # f32 cannot resolve these neighbours: the reference is the
                # exact table kernel's (elementwise) scores, not a matmul.
                full = ops.knn_topk_table(pos, pos, K, point_mask=pm)
                same = (torch.sort(got.long(), 1).values
                        == torch.sort(full.long(), 1).values).all(1)
                check(f"{name} {label}: winner sets vs the exact table kNN",
                      bool(same.all()), f"{int((~same).sum())} rows differ")
            else:
                # A masked query row keeps its own column in slot 0 here
                # (the library's masks it): valid rows only.
                same_winner_sets(f"{name} {label}", got, pos, pos, K, 0, pm,
                                 pm)
    # The table-form build's gather and WLS solve at the bench cloud's
    # shapes ([1, 65536, 9] table, K=20), on its quantized graph.
    pos, nrm, _ = clouds["uniform"]
    idx = ops.knn_topk_bucketed(pos, pos, K, quantized=True)[None]
    xb, yb = build_tangent_basis(nrm)
    table = torch.cat([pos, xb, yb], dim=-1)[None]
    got = ops.gather_rows(table, idx)
    want = ops.gather_rows_plain(table, idx)
    err = max_err(got, want)
    res["gather_rows"]["max_abs_err"] = max(res["gather_rows"]["max_abs_err"],
                                            err)
    check(f"gather_rows [1, {SHARD_N}, 9] K={K}", torch.equal(got, want),
          f"max_abs_err {err}")
    centres = (pos[None], nrm[None], xb[None], yb[None], idx,
               torch.ones(idx.shape, dtype=torch.bool, device=pos.device))
    gd_k = build_grad_div_tables(table, *centres)
    gd_p = build_grad_div_tables(table, *centres, ops=ops.PLAIN_OPS)
    err = max(max_err(gd_k.grad_coef, gd_p.grad_coef),
              max_err(gd_k.div_coef, gd_p.div_coef))
    res["wls"]["max_abs_err"] = max(res["wls"]["max_abs_err"], err)
    check(f"wls, the table-form build at N={SHARD_N}", err <= WLS_ATOL,
          f"max_abs_err {err} <= {WLS_ATOL}")
    torch.cuda.synchronize()

    print(f"[times] point-shard shapes, median of {SHARD_REPS} CUDA-event "
          f"samples of {INNER} calls, card: {card}")
    pos, _, _ = clouds["uniform"]
    tab = pos[:SHARD_TABLE_N].contiguous()
    lib_table = (lambda: knn_library(tab, tab, K))
    lib_ms = median_ms(lib_table, SHARD_REPS)
    for quantized in (False, True):
        name = "knn_topk_table_q" if quantized else "knn_topk_table"
        km = median_ms(lambda: ops.knn_topk_table(tab, tab, K,
                                                  quantized=quantized),
                       SHARD_REPS)
        pm_ = median_ms(lambda: ops.knn_topk_table_plain(
            tab, tab, K, quantized=quantized), SHARD_REPS)
        idx = ops.knn_topk_table(tab, tab, K, quantized=quantized)
        bd = bound(nbytes(tab, tab, idx), float(SHARD_TABLE_N) ** 2
                   * (KNN_INSTR_PER_PAIR if quantized else TABLE_INSTR),
                   ISSUE_PER_S)
        res[name].update(ms=km, plain_ms=pm_, library_ms=lib_ms, bound=bd)
        print(f"  {name} {SHARD_TABLE_N} x {SHARD_TABLE_N} K={K}: kernel "
              f"{km:.4f} ms, plain {pm_:.4f} ms, library {lib_ms:.4f} ms, "
              f"bound {bd[0]:.4f} ms ({bd[1]})")
    q_rows = pos[rows.long()]
    km = median_ms(lambda: ops.knn_topk_table(q_rows, pos, K, row_ids=rows),
                   SHARD_REPS)
    lm = median_ms(lambda: knn_library(q_rows, pos, K), SHARD_REPS)
    print(f"  knn_topk_table repair form {SHARD_REPAIR_ROWS} x {SHARD_N}: "
          f"kernel {km:.4f} ms, library {lm:.4f} ms")
    # The table kNN's two kernels: the (row, tile) selection and the merge
    # of a row's tile lists.
    for label, fn in (
            (f"{SHARD_TABLE_N} x {SHARD_TABLE_N}",
             lambda: ops.knn_topk_table(tab, tab, K)),
            (f"{SHARD_TABLE_N} x {SHARD_TABLE_N} quantized",
             lambda: ops.knn_topk_table(tab, tab, K, quantized=True)),
            (f"repair form {SHARD_REPAIR_ROWS} x {SHARD_N}",
             lambda: ops.knn_topk_table(q_rows, pos, K, row_ids=rows))):
        split = kernel_split(fn, ("knn_table_select_kernel",
                                  "knn_table_merge_kernel"))
        print(f"  knn_topk_table {label}: device time by kernel (profiler) "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in
                          split.items()))

    # The candidate sweep alone, on the inputs the bucketed kNN gives it.
    for quantized in (False, True):
        name = "knn_topk_bucketed_q" if quantized else "knn_topk_bucketed"
        args = sweep_args(pos, K, quantized)
        posq, sqq, srow, comb, perm, cand, box, _, _, _ = args
        ik, sk = kb._cand_kernel(*args)
        ip, sp = kb._cand_plain(*args)
        check(f"{name} candidate sweep alone", torch.equal(ik, ip)
              and torch.equal(sk, sp), f"ids and scores equal "
              f"({int((ik != ip).any(1).sum())} rows differ)")
        km = median_ms(lambda: kb._cand_kernel(*args), SHARD_REPS)
        pm_ = median_ms(lambda: kb._cand_plain(*args), SHARD_REPS)

        lm = median_ms(lambda: sweep_library(args), SHARD_REPS)
        whole = median_ms(lambda: ops.knn_topk_bucketed(
            pos, pos, K, quantized=quantized), SHARD_REPS)
        idx, sc = kb._cand_kernel(*args)
        pairs = float(posq.shape[0]) * cand.shape[1] * comb.shape[-1]
        bd = bound(nbytes(posq, sqq, srow, comb, perm, cand, box, idx, sc),
                   pairs * (KNN_INSTR_PER_PAIR if quantized else
                            TABLE_INSTR), ISSUE_PER_S)
        res[name].update(ms=km, plain_ms=pm_, library_ms=lm, bound=bd)
        print(f"  {name} candidate sweep N={SHARD_N} K={K}, "
              f"m={cand.shape[1]} buckets of {comb.shape[-1]}: kernel "
              f"{km:.4f} ms, plain {pm_:.4f} ms, library (gather + bmm + "
              f"topk) {lm:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}); the "
              f"whole knn_topk_bucketed call {whole:.4f} ms")


def shard_model(seed, dev, precision, knn_method):
    """The bench.py --mode=point-shard model (the reference-width
    classifier, coefficient operators) at ``precision``."""
    model = random_model(seed, dev, knn_method=knn_method,
                         dense_operators=False)
    model.set_precision(precision, precision)
    return model


def serve_shard_phase(rng, seed, dev, card, precision):
    """``InferenceEngine.predict_sharded`` of ONE 65,536-point cloud on one
    card: bf16 with approximate kNN (the bench config: the quantized
    bucketed kNN, once a forward) or f32 with exact kNN (the exact
    bucketed kNN, and the table kNN when rows fail its certificate)."""
    from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)
    from deltaconv_tpu_torch.ops import knn_bucketed as kb
    from deltaconv_tpu_torch.parallel import point_sharded_classification

    tag = "serve-shard-bf16" if precision else "serve-shard-f32"
    knn_method = "approx" if precision else "exact"
    model = shard_model(seed, dev, None, knn_method)
    kw = dict(num_points=SHARD_N, batch_size=1)
    engine = InferenceEngine(model, precision=precision, **kw)
    plain = InferenceEngine(model, precision=precision, ops=PLAIN_OPS, **kw)
    (cloud,), (normal,) = ellipsoid_clouds(rng, [SHARD_N])
    engine.predict_sharded(cloud, normal)  # warm-up
    torch.cuda.synchronize()

    reset_launch_counts()
    times, branches = [], []
    for _ in range(SHARD_CALLS):
        t0 = time.perf_counter()
        got = engine.predict_sharded(cloud, normal)
        times.append(time.perf_counter() - t0)
        branches.append(dict(kb.last_branch))
    counts = launch_counts()
    path = SHARD_BF16_KERNELS if precision else SHARD_F32_KERNELS
    print(f"[{tag}] launches during {SHARD_CALLS} forwards: {counts}")
    print(f"[{tag}] launches per forward: " + ", ".join(
        f"{name} {counts[name] / SHARD_CALLS:g}" for name in path))
    print(f"[{tag}] checks")
    check("logits", got.shape == (NUM_CLASSES,)
          and bool(np.isfinite(got).all()), f"shape {got.shape}")
    for name in path:
        check(f"{name} launched", counts[name] > 0, f"{counts[name]} launches")
    if precision:
        expect = {"knn_topk_bucketed_q": 1, "knn_topk_table": 0,
                  "knn_topk_table_q": 0, "knn_topk_bucketed": 0}
    else:
        print(f"[{tag}] the exact bucketed kNN's certificate: {branches}")
        repairs = sum(b.get("branch") in ("repair", "full")
                      for b in branches)
        expect = {"knn_topk_bucketed": 1, "knn_topk_bucketed_q": 0,
                  "knn_topk_table": repairs / SHARD_CALLS}
    for name, per in expect.items():
        check(f"{name} {per:g} a forward",
              counts[name] == per * SHARD_CALLS,
              f"{counts[name]} launches in {SHARD_CALLS} forwards")
    ref = plain.predict_sharded(cloud, normal)
    if precision:
        held_to("kernel vs plain path", got[None], ref[None], BF16_PATH_REL)
        f32 = InferenceEngine(model, **kw).predict_sharded(cloud, normal)
        held_to(f"{precision} vs the f32 sharded engine", got[None],
                f32[None], BF16_REL)
        # 60,000 real points padded to SHARD_N with a point mask, through
        # point_sharded_classification, against the 60,000-point cloud.
        n = SHARD_PAD_N
        pos = torch.zeros((SHARD_N, 3), device=dev)
        nrm = torch.zeros((SHARD_N, 3), device=dev)
        nrm[:, 2] = 1.0
        pos[:n] = torch.from_numpy(cloud[:n]).to(dev)
        nrm[:n] = torch.from_numpy(normal[:n]).to(dev)
        pm = torch.arange(SHARD_N, device=dev) < n
        with torch.inference_mode():
            padded = point_sharded_classification(
                engine.model, pos, nrm, pm, None, KERNEL_OPS).float().cpu()
        held_to(f"padded ({n} of {SHARD_N} points masked in) vs the "
                f"{n}-point cloud", padded.numpy()[None],
                engine.predict_sharded(cloud[:n], normal[:n])[None],
                BF16_PATH_REL)
    else:
        held_abs("kernel vs plain", got[None], ref[None], LOGIT_ATOL)
    t = float(np.median(times))
    print(f"[{tag}] one cloud of N={SHARD_N} (K={K}, reference width, "
          f"dense_operators=False, knn_method={knn_method}, precision="
          f"{precision}): median {t * 1e3:.3f} ms per predict_sharded call, "
          f"{SHARD_N / t:.0f} points/s (host clock, synchronised), card: "
          f"{card}")
    profile(tag, "one predict_sharded call",
            lambda: engine.predict_sharded(cloud, normal), t * 1e3)
    return counts


def shard_seg_same_graph(label, engine, cloud, normal, cat, got, dev):
    """The f32 sharded segmentation forward's logits ``got`` of one cloud
    held to the unsharded forward of the same model on the same neighbour
    graph (the table kNN's, built by ``build_grad_div_fused`` and passed
    as ``operators``) within SHARD_SEG_REL x max|logit|; the table kNN's
    winner sets held to the library call's except at near-ties
    (``same_winner_sets``); then the deviation from
    ``InferenceEngine.predict``, whose exact kNN (``matmul`` + ``topk``)
    rounds the scores otherwise and so may part from the table kNN at
    near-ties, printed beside the rows whose neighbour sets differ."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn

    model = engine.model
    base = model.deltanet_base
    k = base.num_neighbors
    pos = torch.from_numpy(cloud).to(dev)
    nrm = torch.from_numpy(normal).to(dev)
    onehot = torch.zeros((1, 16), device=dev)
    onehot[0, cat] = 1.0
    with torch.inference_mode():
        idx = ops.knn_topk_table(pos, pos, k)
        xb, yb = build_tangent_basis(nrm[None])
        gd = ops.build_grad_div_fused(
            pos[None], nrm[None], xb, yb, idx[None],
            torch.ones((1,) + tuple(idx.shape), dtype=torch.bool,
                       device=dev),
            base.grad_kernel_width, base.grad_regularizer)
        ref = model(pos[None], nrm[None], None, category=onehot,
                    operators=gd)[0].float().cpu().numpy()
        graph, _ = knn(pos[None], k, None, "exact")
    held_to(f"{label} vs the unsharded forward on the table kNN's graph",
            got, ref, SHARD_SEG_REL, "points")
    same_winner_sets(f"{label} table kNN", idx, pos, pos, k)
    pred = engine.predict([cloud], [normal], [cat])[0]
    moved = (torch.sort(idx.long(), 1).values
             != torch.sort(graph[0].long(), 1).values).any(1)
    print(f"  {label} vs InferenceEngine.predict: max_abs_err "
          f"{float(np.abs(got - pred).max()) / float(np.abs(pred).max()):.3e}"
          f" x max|logit|, argmax equal on "
          f"{int((got.argmax(1) == pred.argmax(1)).sum())} of {len(pred)} "
          f"points; {int(moved.sum())} rows of the table kNN's graph differ "
          f"from predict's kNN", flush=True)


def serve_shard_seg_phase(rng, seed, dev, card, precision):
    """The ShapeNet model in coefficient form, ONE cloud of 8192 points with
    a category through ``predict_sharded`` (the table kNN, once a
    forward): bf16 against the plain path; f32 (exact kNN) against the
    unsharded forward on the same neighbour graph (``shard_seg_same_graph``),
    on this cloud and on SHARD_SEG_CLOUDS - 1 more from a generator
    spawned off ``rng`` (``rng``'s draws stay as they were). The device
    time of one call."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    tag = "serve-shard-seg" + ("-bf16" if precision else "-f32")
    model = random_seg_model(seed, dev, "approx" if precision else "exact",
                             dense_operators=False)
    kw = dict(num_points=SHARD_SEG_N, batch_size=1)
    engine = InferenceEngine(model, precision=precision, **kw)
    (cloud,), (normal,) = ellipsoid_clouds(rng, [SHARD_SEG_N])
    cat = int(rng.integers(0, 16))
    engine.predict_sharded(cloud, normal, cat)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    times = []
    for _ in range(SHARD_CALLS):
        t0 = time.perf_counter()
        got = engine.predict_sharded(cloud, normal, cat)
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    name = "knn_topk_table_q" if precision else "knn_topk_table"
    print(f"[{tag}] launches during {SHARD_CALLS} forwards: {counts}")
    check("per-point logits", got.shape == (SHARD_SEG_N, SEG_CLASSES)
          and bool(np.isfinite(got).all()), f"shape {got.shape}")
    for kernel in (name, "gather_rows", "wls"):
        check(f"{kernel} 1 a forward", counts[kernel] == SHARD_CALLS,
              f"{counts[kernel]} launches in {SHARD_CALLS} forwards")
    if precision:
        ref = InferenceEngine(model, precision=precision, ops=PLAIN_OPS,
                              **kw).predict_sharded(cloud, normal, cat)
        held_to("kernel vs plain path", got, ref, BF16_PATH_REL, "points")
    else:
        shard_seg_same_graph(f"[{tag}] cloud 0", engine, cloud, normal,
                             cat, got, dev)
        more = rng.spawn(1)[0]
        for i in range(1, SHARD_SEG_CLOUDS):
            (c,), (nm,) = ellipsoid_clouds(more, [SHARD_SEG_N])
            ct = int(more.integers(0, 16))
            shard_seg_same_graph(f"[{tag}] cloud {i}", engine, c, nm, ct,
                                 engine.predict_sharded(c, nm, ct), dev)
    t = float(np.median(times))
    dm = device_ms(lambda: engine.predict_sharded(cloud, normal, cat))
    print(f"[{tag}] one cloud of N={SHARD_SEG_N} (K={SEG_K}, ShapeNet "
          f"config, dense_operators=False, precision={precision}): median "
          f"{t * 1e3:.3f} ms per call, {SHARD_SEG_N / t:.0f} points/s (host "
          f"clock, synchronised), {dm:.3f} ms of device time (profiler), "
          f"card: {card}")
    return counts


def shard_nccl_phase(rng, seed, dev):
    """One bench forward through an initialised 1-rank ``nccl`` group (a
    FileStore under a temporary directory: no network) and with
    ``group=None``: the same logits, bit for bit."""
    import tempfile

    import torch.distributed as dist

    from deltaconv_tpu_torch import InferenceEngine

    engine = InferenceEngine(shard_model(seed, dev, None, "approx"),
                             num_points=SHARD_N, batch_size=1,
                             precision="bfloat16")
    (cloud,), (normal,) = ellipsoid_clouds(rng, [SHARD_N])
    alone = engine.predict_sharded(cloud, normal)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1)
        try:
            grouped = engine.predict_sharded(cloud, normal,
                                             group=dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    check("[shard-nccl] 1-rank nccl group vs group=None",
          np.array_equal(alone, grouped),
          f"bit-equal logits, max |diff| {np.abs(alone - grouped).max()}")


def _plane_rel(got, want):
    """The worst of the 12 planes' deviations, each against its plane's
    max."""
    return max(max_err(got[:, p], want[:, p])
               / max(float(want[:, p].abs().max()), 1e-30)
               for p in range(got.shape[1]))


def check_fused_kernels(record, pos, nrm, xb, yb, idx, nbr_mask, label):
    """fused_gather_wls on both routes, the split route (by shape,
    ``wls_split``) and the direct route (``fused_gather_wls_direct``,
    forced): each within FUSED_REL x max of its plain version and of the
    unfused build (``gather_rows`` + planes + ``wls``) with the same
    ``avg``, a second call bit-equal, one launch of its route a call."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    fb = importlib.import_module("deltaconv_tpu_torch.ops.fused_build")
    b, n, k = idx.shape
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm, ops.gather_rows)
    avg = edges[:, 11, 0, 0].contiguous()
    want = ops.fused_gather_wls_plain(pos, nrm, xb, yb, idx, nbr_mask, avg)
    g, d = ops.wls(edges, 1.0, 1e-3)
    s = g.abs().sum(dim=2)
    unfused = (g.transpose(2, 3), d.transpose(2, 3),
               torch.sqrt(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1]))
    del edges
    for slices, sfx in ((None, ""), (0, "_direct")):
        name = "fused_gather_wls" + sfx
        reset_launch_counts()
        got = fb._fused_gather_wls(pos, nrm, xb, yb, idx, nbr_mask, avg,
                                   slices=slices)
        again = fb._fused_gather_wls(pos, nrm, xb, yb, idx, nbr_mask, avg,
                                     slices=slices)
        torch.cuda.synchronize()
        counts = {m: v for m, v in launch_counts().items() if v}
        same = all(bits_equal(a, r) for a, r in zip(got, again))
        record(name, max(max_err(a, r) for a, r in zip(got, want)))
        for what, ref in (("plain", want), ("unfused", unfused)):
            rel = max(max_err(a, r) / max(float(r.abs().max()), 1e-30)
                      for a, r in zip(got, ref))
            check(f"{name} {label} B={b} N={n} K={k} vs {what}",
                  rel <= FUSED_REL and same and counts == {name: 2},
                  f"{rel:.3e} x max <= {FUSED_REL}, a second call bit-equal "
                  f"{same}, launches {counts}")


def cotangent_held(got, feat, ct, idx):
    """``(held, entries that differ, worst ratio)`` of coef_cotangent's
    output against its plain version: each entry within one f32 ulp of
    the plain value or the f64 summation bound ``C 2^-52 sum_c |x_c
    ct_c|`` (the kernel's f64 order against the einsum's), finite."""
    from deltaconv_tpu_torch import ops

    want = ops.coef_cotangent_plain(feat, ct, idx).double()
    scale = ops.coef_cotangent_plain(feat.abs(), ct.abs(), idx).double()
    ulp = torch.nextafter(want.abs().float(), torch.tensor(
        float("inf"), device=want.device)).double() - want.abs()
    tol = ulp + feat.shape[-1] * 2.0 ** -52 * scale
    err = (got.double() - want).abs()
    held = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    return (held, int((got.double() != want).sum()),
            float((err / tol.clamp(min=1e-300)).max()))


def check_cotangent_kernels(record, idx, label, dev):
    """coef_cotangent in both modes at one forward's apply widths on this
    graph (random f32 rows and cotangents): held by
    :func:`cotangent_held`, a second call bit-equal, and the grad mode on
    the transposed view of a ``[B, 2, N, C]`` cotangent (the dense
    grad's, read through its strides) bit-equal to its contiguous copy."""
    from deltaconv_tpu_torch import ops

    b, n, _ = idx.shape
    for mode, widths in zip(("grad", "div"), APPLY_WIDTHS):
        for c in sorted(set(widths)):
            fshape = (b, n, c) if mode == "grad" else (b, n, 2, c)
            feat = torch.randn(fshape, device=dev)
            planes = torch.randn((b, 2, n, c) if mode == "grad"
                                 else (b, n, c), device=dev)
            ct = planes.transpose(1, 2) if mode == "grad" else planes
            got = ops.coef_cotangent(feat, ct, idx)
            held, diff, worst = cotangent_held(got, feat, ct, idx)
            same = bits_equal(ops.coef_cotangent(feat, ct, idx), got)
            if mode == "grad":
                same = same and bits_equal(
                    ops.coef_cotangent(feat, ct.contiguous(), idx), got)
            record("coef_cotangent", max_err(
                got, ops.coef_cotangent_plain(feat, ct, idx)))
            check(f"coef_cotangent {mode} {label} B={b} N={n} C={c}",
                  held and same,
                  f"{diff} of {got.numel()} entries differ from the plain "
                  f"version, worst {worst:.3f} x (one f32 ulp + the f64 "
                  f"summation bound); a second call and the contiguous "
                  f"cotangent bit-equal {same}")
            del feat, planes, ct, got


def check_build_bwd_kernels(record, pos, nrm, xb, yb, idx, nbr_mask, label,
                            dev):
    """wls_bwd against autograd through the plain WLS math (each plane
    within WLS_BWD_REL x its max); coef_cotangent
    (:func:`check_cotangent_kernels`); densify_bwd bit-equal to
    ``torch.gather``; fused_gather_wls on both routes
    (:func:`check_fused_kernels`)."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    b, n, k = idx.shape
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm, ops.gather_rows)
    ctg = torch.randn((b, 2, k, n), device=dev)
    ctd = torch.randn((b, 2, k, n), device=dev)
    got = ops.wls_bwd(edges, ctg, ctd, 1.0, 1e-3)
    want = ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)
    rel = _plane_rel(got, want)
    same = bits_equal(ops.wls_bwd(edges, ctg, ctd, 1.0, 1e-3), got)
    record("wls_bwd", max_err(got, want))
    check(f"wls_bwd {label} B={b} N={n}",
          bool(torch.isfinite(got).all()) and rel <= WLS_BWD_REL and same,
          f"worst plane {rel:.3e} x its max <= {WLS_BWD_REL}, a second "
          f"call bit-equal {same}")
    del edges, ctg, ctd
    check_cotangent_kernels(record, idx, label, dev)
    if n > N:
        return
    dwg = torch.randn((b, 2, n, n), device=dev)
    dwd = torch.randn((b, 2, n, n), device=dev)
    got = ops.densify_bwd(idx, dwg, dwd)
    want = ops.densify_bwd_plain(idx, dwg, dwd)
    err = max(max_err(g, w) for g, w in zip(got, want))
    record("densify_bwd", err)
    check(f"densify_bwd {label}",
          all(torch.equal(g, w) for g, w in zip(got, want)),
          f"bit-equal, max_abs_err {err}")
    del dwg, dwd
    check_fused_kernels(record, pos, nrm, xb, yb, idx, nbr_mask, label)


def build_bwd_kernel_phase(res, rng, dev, card):
    """``[kernels]`` of the operator build's backward and the fused eval
    build: wls_bwd at B=32, N=1024 and B=4, N=8192 (K=20), densify_bwd,
    fused_gather_wls (both routes) and knn_topk's mean distances (both
    bodies) at B=32, N=1024, uniform and masked (the kNN uniform only: it
    takes no mask), and fused_gather_wls's routes at B=16, N=2048, K=30;
    then times, bounds and library calls at the uniform shapes, and both
    routes of fused_gather_wls timed at FUSED_SHAPES (the split route also
    at every number of warps that holds K edges). The K=30 clouds come
    from a generator spawned off ``rng``."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    def record(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    pos, nrm, xb, yb, cases = graph_cases(rng, dev)
    for label, (idx, nbr_mask) in cases.items():
        print(f"[kernels] build backward and fused build, {label}",
              flush=True)
        check_build_bwd_kernels(record, pos, nrm, xb, yb, idx, nbr_mask,
                                label, dev)
    for quantized in (True, False):
        idx, md = ops.knn_topk(pos, K, quantized, return_mean_dist=True)
        idx_p, md_p = ops.knn_topk_plain(pos, K, quantized, True)
        record("knn_topk_mean_dist", max_err(md, md_p))
        check(f"knn_topk mean distances quantized={quantized}",
              torch.equal(idx, idx_p) and torch.equal(md, md_p)
              and torch.equal(idx, ops.knn_topk(pos, K, quantized)),
              f"ids equal, distances bit-equal, max_abs_err "
              f"{max_err(md, md_p)}")
    (lc, ln) = ellipsoid_clouds(rng, [LARGE_N] * LARGE_B)
    lpos = torch.from_numpy(np.stack(lc)).to(dev)
    lnrm = torch.from_numpy(np.stack(ln)).to(dev)
    lxb, lyb = build_tangent_basis(lnrm)
    pmask = torch.ones((LARGE_B, LARGE_N), dtype=torch.bool, device=dev)
    pmask[::2, int(0.6 * LARGE_N):] = False
    for label, mask in (("uniform", None), ("masked", pmask)):
        idx, nbr_mask = knn(lpos, K, mask)
        if mask is not None:
            nbr_mask = nbr_mask & mask[:, :, None]
        else:
            lidx = idx
        check_build_bwd_kernels(record, lpos, lnrm, lxb, lyb, idx, nbr_mask,
                                label, dev)
    del lpos, lnrm, lxb, lyb, pmask
    fused_inputs = {"cls": (pos, nrm, xb, yb)}
    for label, b, n, k in FUSED_SHAPES[1:]:
        sc, sn = ellipsoid_clouds(rng.spawn(1)[0], [n] * b)
        spos = torch.from_numpy(np.stack(sc)).to(dev)
        snrm = torch.from_numpy(np.stack(sn)).to(dev)
        fused_inputs[label] = (spos, snrm, *build_tangent_basis(snrm))
        pmask = torch.ones((b, n), dtype=torch.bool, device=dev)
        pmask[::2, int(0.6 * n):] = False
        for graph, mask in (("uniform", None), ("masked", pmask)):
            print(f"[kernels] fused build, {label} {graph}", flush=True)
            idx, nbr_mask = knn(spos, k, mask)
            if mask is not None:
                nbr_mask = nbr_mask & mask[:, :, None]
            check_fused_kernels(record, *fused_inputs[label], idx, nbr_mask,
                                f"{label} {graph}")

    idx, nbr_mask = cases["uniform"]
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm)
    ctg = torch.randn((B, 2, K, N), device=dev)
    ctd = torch.randn((B, 2, K, N), device=dev)
    dwg = torch.randn((B, 2, N, N), device=dev)
    dwd = torch.randn((B, 2, N, N), device=dev)
    avg = edges[:, 11, 0, 0].contiguous()
    ones = torch.ones_like(nbr_mask)
    timed = {
        "wls_bwd": (lambda: ops.wls_bwd(edges, ctg, ctd, 1.0, 1e-3),
                    lambda: ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)),
        "densify_bwd": (lambda: ops.densify_bwd(idx, dwg, dwd),
                        lambda: ops.densify_bwd_plain(idx, dwg, dwd)),
        "fused_gather_wls": (
            lambda: ops.fused_gather_wls(pos, nrm, xb, yb, idx, ones, avg),
            lambda: ops.fused_gather_wls_plain(pos, nrm, xb, yb, idx, ones,
                                               avg)),
        "knn_topk_mean_dist": (
            lambda: ops.knn_topk(pos, K, True, return_mean_dist=True),
            lambda: ops.knn_topk_plain(pos, K, True, True)),
    }
    print(f"[times] build backward and fused build, B={B} N={N} K={K}, "
          f"card: {card}")
    for name, (fk, fp) in timed.items():
        res[name]["ms"] = median_ms(fk)
        res[name]["plain_ms"] = median_ms(fp)
        print(f"  {name}: kernel {res[name]['ms']:.4f} ms, "
              f"plain {res[name]['plain_ms']:.4f} ms")
    print(f"  knn_topk_mean_dist exact body: kernel "
          f"{median_ms(lambda: ops.knn_topk(pos, K, False, True)):.4f} ms, "
          f"plain {median_ms(lambda: ops.knn_topk_plain(pos, K, False, True)):.4f}"
          f" ms")
    edges_n = B * N * K
    res["wls_bwd"]["bound"] = bound(
        nbytes(edges, ctg, ctd, edges),
        float(edges_n) * WLS_BWD_FLOPS_PER_EDGE)
    # The gather needs the indices, the 4 entries an edge reads, and its
    # outputs (not the whole [B, 2, N, N] cotangents).
    res["densify_bwd"]["bound"] = bound(
        nbytes(idx) + edges_n * 4 * 4 + edges_n * 4 * 4)
    gc, dc, rn = ops.fused_gather_wls(pos, nrm, xb, yb, idx, ones, avg)
    res["fused_gather_wls"]["bound"] = bound(
        nbytes(pos, nrm, xb, yb, idx, ones, avg, gc, dc, rn),
        float(edges_n) * WLS_FLOPS_PER_EDGE)
    res["knn_topk_mean_dist"]["bound"] = bound(
        nbytes(pos, idx, avg.new_empty((B, N))),
        float(B) * N * N * KNN_INSTR_PER_PAIR, ISSUE_PER_S)
    index = idx.long()[:, None].expand(B, 2, N, K)
    res["densify_bwd"]["library_ms"] = median_ms(
        lambda: (torch.gather(dwg, 3, index), torch.gather(dwd, 3, index)))

    def knn_library():
        """Score plane and ``topk``, then the winners' mean distance."""
        sq = (pos * pos).sum(-1)
        s = 2.0 * torch.matmul(pos, pos.transpose(1, 2)) - sq[:, None, :]
        best = torch.topk(s, K, dim=-1).values
        return torch.sqrt(torch.clamp(sq[..., None] - best, min=0.0)).mean(-1)

    res["knn_topk_mean_dist"]["library_ms"] = median_ms(knn_library)
    for name in ("densify_bwd", "knn_topk_mean_dist"):
        print(f"  {name}: library call {res[name]['library_ms']:.4f} ms")
    del dwg, dwd, index
    time_cotangent(res, idx, lidx, dev, card)
    time_fused_routes(res, fused_inputs, dev, card)


def cotangent_bound(feat, ct, idx):
    """coef_cotangent's bound: ``feat``, ``ct``, ``idx`` read once and the
    ``[B, N, K, 2]`` f32 output written once; 2 C f64 FMAs an edge."""
    b, n, k = idx.shape
    c = feat.shape[-1]
    return bound(nbytes(feat, ct, idx) + b * n * k * 2 * 4,
                 4.0 * c * b * n * k, F64_OPS_PER_S)


def time_cotangent(res, idx, lidx, dev, card):
    """``[cotangent]``: coef_cotangent at one forward's apply widths, both
    modes, at the dense path's shape (``idx``: B=32, N=1024) and the
    coefficient form's (``lidx``: B=4, N=8192), contiguous cotangents, the
    points in index order, by CUDA events and in
    device time, beside its bound and the parent's route for the same
    function: on the dense shape the product ``dW = ct @ x^T`` (the
    ``[B, 2, N, N]`` cotangent, ``torch.matmul``) then ``densify_bwd``
    (which gathers two such cotangents, as once a backward it did), on the
    coefficient form's ``gather_rows`` of the f32 rows then the
    ``einsum``. The record (COT_RECORD, dense shape) also takes the plain
    version's time."""
    from deltaconv_tpu_torch import ops

    print(f"[cotangent] coef_cotangent per call: CUDA events (median of "
          f"{REPS} samples of {INNER} calls), device time (profiler), "
          f"bound; the parent's route for the same function; card: {card}",
          flush=True)
    for label, ix in (("dense", idx), ("large", lidx)):
        b, n, k = ix.shape
        for mode, widths in zip(("grad", "div"), APPLY_WIDTHS):
            for c in sorted(set(widths)):
                feat = torch.randn((b, n, c) if mode == "grad"
                                   else (b, n, 2, c), device=dev)
                planes = torch.randn((b, 2, n, c) if mode == "grad"
                                     else (b, n, c), device=dev)
                # Contiguous, as the model paths' cotangents come.
                ct = (planes.transpose(1, 2).contiguous() if mode == "grad"
                      else planes)

                def call(feat=feat, ct=ct, ix=ix):
                    return ops.coef_cotangent(feat, ct, ix)

                ms, dms = median_ms(call), device_ms(call, 5)
                bd = cotangent_bound(feat, ct, ix)
                if label == "dense":
                    parent = dense_cotangent_route(feat, planes, ix, mode)
                else:
                    parent = coef_cotangent_route(feat, ct, ix, mode)
                pms = median_ms(parent, 10)
                print(f"  {label} {mode} B={b} N={n} K={k} C={c}: {ms:.4f} "
                      f"ms ({dms:.4f} device); bound {bd[0]:.4f} ms "
                      f"({bd[1]}), {bd[0] / dms:.2f} of it; parent's route "
                      f"{pms:.4f} ms", flush=True)
                if label == "dense" and (mode, c) == COT_RECORD:
                    res["coef_cotangent"].update(
                        ms=ms, bound=bd, library_ms=pms,
                        plain_ms=median_ms(lambda: ops.coef_cotangent_plain(
                            feat, ct, ix), 5))
                del feat, planes, ct, parent


def dense_cotangent_route(feat, planes, idx, mode):
    """The parent's dense route for coef_cotangent's function: the
    apply's operator cotangent ``[B, 2, N, N]`` by ``torch.matmul`` (grad
    ``ct_e @ x^T``; div ``ct @ v_e^T``), then ``densify_bwd`` of it."""
    from deltaconv_tpu_torch import ops

    if mode == "grad":
        def call():
            dw = torch.matmul(planes, feat.transpose(1, 2)[:, None])
            return ops.densify_bwd(idx, dw, dw)
    else:
        vt = feat.permute(0, 2, 3, 1)  # [B, 2, C, N]

        def call():
            dw = torch.matmul(planes[:, None], vt)
            return ops.densify_bwd(idx, dw, dw)
    return call


def coef_cotangent_route(feat, ct, idx, mode):
    """The parent's coefficient-form route: ``gather_rows`` of the f32
    rows (``[B, C', K, N]``), then the ``einsum`` with the cotangent."""
    from deltaconv_tpu_torch import ops

    b, n, k = idx.shape
    c = feat.shape[-1]
    if mode == "grad":
        return lambda: torch.einsum("bckn,bndc->bnkd",
                                    ops.gather_rows(feat, idx), ct)
    flat = feat.reshape(b, n, 2 * c)
    return lambda: torch.einsum(
        "bdckn,bnc->bnkd", ops.gather_rows(flat, idx).view(b, 2, c, k, n),
        ct)


def time_fused_routes(res, inputs, dev, card):
    """fused_gather_wls on both routes at FUSED_SHAPES (``inputs``: each
    shape's positions, normals and frames), uniform kNN graphs with every
    slot valid: the split route (by shape) and the direct route (the
    parent's kernel), by CUDA events and in device time, beside the plain
    version's device time and the bound; the split route at every number
    of warps that holds K edges (device time). The direct route's record
    is at the classification shape."""
    from deltaconv_tpu_torch import ops

    fb = importlib.import_module("deltaconv_tpu_torch.ops.fused_build")
    wf = importlib.import_module("deltaconv_tpu_torch.ops.wls_fused")
    print(f"[fused-routes] fused_gather_wls by route: split (by shape) and "
          f"direct (the parent's kernel); per call, CUDA events (median of "
          f"{REPS} samples of {INNER} calls) and device time (profiler); "
          f"card: {card}", flush=True)
    for label, b, n, k in FUSED_SHAPES:
        pos, nrm, xb, yb = inputs[label]
        idx, md = ops.knn_topk(pos, k, True, return_mean_dist=True)
        ones = torch.ones(idx.shape, dtype=torch.bool, device=dev)
        args = (pos, nrm, xb, yb, idx, ones, md.mean(dim=1).contiguous())

        def run(slices, args=args):
            return fb._fused_gather_wls(*args, slices=slices)

        t = {sfx: (median_ms(lambda: run(sl)), device_ms(lambda: run(sl), 5))
             for sl, sfx in ((None, "split"), (0, "direct"))}
        pl = device_ms(lambda: ops.fused_gather_wls_plain(*args), 2)
        bd = bound(nbytes(*args, *run(None)),
                   float(b) * n * k * WLS_FLOPS_PER_EDGE)
        split = wf.wls_split(k)
        print(f"  {label} fused_gather_wls B={b} N={n} K={k}: split "
              f"({split[0]} warps of {split[1]} slots) {t['split'][0]:.4f} ms "
              f"({t['split'][1]:.4f} ms of device time); direct "
              f"{t['direct'][0]:.4f} ({t['direct'][1]:.4f}); plain {pl:.4f} "
              f"(device); bound {bd[0]:.4f} ms ({bd[1]})", flush=True)
        times = [f"{s} x {-(-k // s)}: {device_ms(lambda: run(s), 5):.4f}"
                 for s in range(-(-k // wf.WLS_EDGES), wf.WLS_MAX_SLICES + 1)]
        print("    split by warps (warps x slots: device ms): "
              + "; ".join(times), flush=True)
        if (b, n, k) == (B, N, K):
            res["fused_gather_wls_direct"].update(
                ms=t["direct"][0], bound=bd,
                plain_ms=res["fused_gather_wls"]["plain_ms"])


def kernel_split(fn, names, reps=3) -> dict:
    """The device time of one call of ``fn`` spent in each kernel whose
    name contains one of ``names`` (``torch.profiler``, ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.count:
            for name in names:
                if name in evt.key:
                    out[name] += evt.self_device_time_total / reps / 1e3
    return out


def device_ms(fn, reps=3) -> float:
    """The device time of one call of ``fn`` in ``torch.profiler`` over
    ``reps`` calls: for each kernel or copy, its mean time times the
    times a call runs it (its count over ``reps``, rounded), so that an
    instance the trace drops leaves the sum right (traces have dropped
    the first launch of the port's library in a window). A spin kernel
    opens the traced window and is left out of the sum. (CUDA events
    around a call would count the host's gaps: the build's small
    host-to-device copies wait for the stream.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    # A trace that recorded no kernel at all (seen on the card, up to ten
    # in a row for one call) is a failed trace, not a measurement: trace
    # again after a pause, with twice the calls each time, and say so.
    for attempt in range(TRACE_TRIES):
        if attempt:
            time.sleep(TRACE_PAUSE_S)
            torch.cuda.empty_cache()
        calls = reps << attempt
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(evt.self_device_time_total / evt.count
                    * max(1, round(evt.count / calls))
                    for evt in events
                    if evt.device_type == DeviceType.CUDA and evt.count
                    and "spin_kernel" not in evt.key) / 1e3
        if total > 0:
            return total
        device = sum(evt.count for evt in events
                     if evt.device_type == DeviceType.CUDA)
        print(f"  [trace] {calls} calls recorded no device time ({device} "
              f"device events, the spin kernel's included; "
              f"{sum(evt.count for evt in events) - device} host events)",
              flush=True)
    raise RuntimeError(f"device_ms: {TRACE_TRIES} traces recorded no "
                       f"device time")


def _plain_vjp_wls():
    """The wls kernel's forward with the plain version's VJP (autograd
    through ``_wls_math``): the plain side of the same-build comparisons
    builds bit-equal operators and differentiates them with the plain
    versions only."""
    from deltaconv_tpu_torch import ops

    class PlainVjpWls(torch.autograd.Function):
        @staticmethod
        def forward(ctx, edges, kernel_width, regularizer):
            ctx.save_for_backward(edges)
            ctx.params = (kernel_width, regularizer)
            with torch.no_grad():
                return ops.wls(edges.detach(), kernel_width, regularizer)

        @staticmethod
        def backward(ctx, ctg, ctd):
            (edges,) = ctx.saved_tensors
            return ops.wls_bwd_plain(edges, ctg.contiguous(),
                                     ctd.contiguous(), *ctx.params), None, None

    def wls(edges, kernel_width, regularizer):
        if edges.requires_grad and torch.is_grad_enabled():
            return PlainVjpWls.apply(edges, kernel_width, regularizer)
        return ops.wls(edges, kernel_width, regularizer)

    return wls


def pos_grad_once(batch, seed, dev, ops, train, **config):
    """``d loss / d pos`` and ``d loss / d normal`` of the cross entropy of a
    fresh model's logits (dropout 0; in eval mode with randomized
    BatchNorm scales, in train mode on batch statistics as the train
    steps), through ``ops``. Returns the loss, both gradients and the
    model."""
    model = random_model(seed, dev, dropout=0.0, affine=not train, **config)
    model.train(train)
    p = batch["pos"].clone().requires_grad_()
    q = batch["normal"].clone().requires_grad_()
    logits = model(p, q, batch.get("point_mask"), ops=ops)
    loss = torch.nn.functional.cross_entropy(logits, batch["label"])
    loss.backward()
    return float(loss), p.grad, q.grad


@contextlib.contextmanager
def deterministic_torch():
    """PyTorch's deterministic algorithms (its ``scatter_add_`` on the card
    then sums in a fixed order; an op with no deterministic form raises),
    restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def compare_pos_grads(label, batch, seed, dev, train, per_backward,
                      plain_build, **config):
    """One backward through the kernels, then through the plain versions:
    on the same build (the plain side's operators bit-equal, see
    :func:`_plain_vjp_wls`) the loss within LOSS_RTOL and both gradients
    within POS_GRAD_REL x max are held; with ``plain_build``, also
    through the plain build (its WLS forward ~1e-6 away, enough to flip
    neighbour-max winners at near-ties): the loss is held and the
    gradients' deviation printed. Counts the kernel side's launches:
    ``per_backward`` exactly, and returns them.

    Both sides run under :func:`deterministic_torch`, so that in eval
    mode neither side's sums depend on the order of atomics (the
    kernels' max backward sums in f64): the normal gradient of a point
    with a near-duplicate neighbour is a sum of terms ~1/distance that
    cancel, which amplifies the last bits of such sums, and with
    atomics in f32 the large-cloud reading changed from run to run
    (1.3e-4 to 1.1e-3 x max on one batch). The neighbour sum's
    ``gather_sum_bwd`` (train mode) sums in f64 too."""
    from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS, launch_counts,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.ops import (coef_apply_div_plain,
                                         coef_apply_grad_plain,
                                         coef_cotangent_plain,
                                         densify_coefs_plain,
                                         gather_max_plain, gather_rows_plain,
                                         gather_sum_plain)

    same = KERNEL_OPS._replace(
        gather_rows=gather_rows_plain, wls=_plain_vjp_wls(),
        densify_coefs=densify_coefs_plain, gather_max=gather_max_plain,
        gather_sum=gather_sum_plain, coef_apply_grad=coef_apply_grad_plain,
        coef_apply_div=coef_apply_div_plain,
        coef_cotangent=coef_cotangent_plain)
    reset_launch_counts()
    with deterministic_torch():
        lk, gpk, gnk = pos_grad_once(batch, seed, dev, KERNEL_OPS, train,
                                     **config)
    counts = launch_counts()
    for name, per in per_backward.items():
        check(f"{label} {name} {per} a backward", counts[name] == per,
              f"{counts[name]} launches")
    routes = [("same build", same)]
    if plain_build:
        routes.append(("plain build", PLAIN_OPS))
    for route, plain in routes:
        with deterministic_torch():
            lp, gpp, gnp = pos_grad_once(batch, seed, dev, plain, train,
                                         **config)
        check(f"{label} loss kernels vs plain ({route})",
              abs(lk - lp) <= LOSS_RTOL * abs(lp),
              f"{lk} vs {lp}, rel {abs(lk - lp) / abs(lp):.3e} <= "
              f"{LOSS_RTOL}")
        for what, a, b in (("pos.grad", gpk, gpp), ("normal.grad", gnk, gnp)):
            rel = max_err(a, b) / max(float(b.abs().max()), 1e-30)
            finite = bool(torch.isfinite(a).all())
            if route == "same build":
                check(f"{label} {what} kernels vs plain ({route})",
                      finite and rel <= POS_GRAD_REL,
                      f"{rel:.3e} x max <= {POS_GRAD_REL}")
            else:
                check(f"{label} {what} finite", finite, "")
                print(f"  {label} {what} kernels vs plain ({route}): "
                      f"{rel:.3e} x max (winner flips; not held)")
    return counts


def pos_grad_phase(rng, seed, dev, card, large=False):
    """``[pos-grad]``: the reference classifier in f32 (exact kNN, dense
    operators) at B=32, N=1024 on 32 uniform clouds and 11 ragged ones,
    eval and train mode: ``pos.requires_grad_()``, ``normal
    .requires_grad_()``, the cross entropy of the logits, ``backward()``.
    ``[pos-grad-large]`` (``large``): the coefficient form at B=4,
    N=8192 with approximate kNN, 4 uniform clouds and 3 ragged with a full
    one. Held kernels vs plain (:func:`compare_pos_grads`; the plain build
    on the first batch and mode); the device and host time of forward +
    backward, the backward kernels' share (scatter_rows: the gather's and,
    in coefficient form, the applies') and the peak memory."""
    tag = "pos-grad-large" if large else "pos-grad"
    if large:
        b, n = LARGE_B, LARGE_N
        config = dict(dense_operators=False, knn_method="approx")
        per = POS_GRAD_LARGE_PER_BACKWARD
        sizes = rng.integers(LARGE_MIN_POINTS, n, b - 1).tolist() + [n]
    else:
        b, n, config, per = B, N, {}, POS_GRAD_PER_BACKWARD
        sizes = rng.integers(n * 600 // 1024, n, POS_GRAD_RAGGED).tolist()
    uniform = train_batch(rng, dev, [n] * b, n)
    ragged = train_batch(rng, dev, sizes, n)
    counts = None
    for train in (False, True):
        mode = "train" if train else "eval"
        for label, batch in (("uniform", uniform), ("ragged", ragged)):
            print(f"[{tag}] {mode}, {label} ({len(batch['label'])} clouds of "
                  f"up to {n} points)", flush=True)
            c = compare_pos_grads(f"{mode} {label}", batch, seed, dev,
                                  train, per, counts is None, **config)
            counts = c if counts is None else counts
    model = random_model(seed, dev, dropout=0.0, **config).eval()

    def step():
        p = uniform["pos"].clone().requires_grad_()
        q = uniform["normal"].clone().requires_grad_()
        torch.nn.functional.cross_entropy(
            model(p, q), uniform["label"]).backward()
        model.zero_grad(set_to_none=True)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(POS_GRAD_CALLS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    t = float(np.median(times)) * 1e3
    print(f"[{tag}] eval forward + backward of {b} uniform clouds (N={n}, "
          f"K={K}, reference width, f32, {config or 'dense, exact kNN'}): "
          f"median {t:.3f} ms (host clock, synchronised), peak "
          f"{peak:.2f} GiB, card: {card}")
    total, ours = profile(tag, "one eval forward + backward", step, t)
    # Each kernel by the name of its CUDA kernel function in the trace.
    for name, fn in (("wls_bwd", "wls_split_bwd_kernel"),
                     ("coef_cotangent", "cotangent_"),
                     ("gather_rows", "gather_rows_kernel"),
                     ("scatter_rows", "scatter_rows_kernel"),
                     ("inverse_adjacency", "inverse_adjacency_kernel")):
        us = sum(r[0] for r in ours if f"::{fn}" in r[2])
        print(f"[{tag}] {name}: {us / 1e3:.3f} ms, {us / max(total, 1e-9):.4f}"
              f" of the device time, {us / max(sum(r[0] for r in ours), 1e-9):.3f}"
              f" of the port's kernels")
    return counts


def densify_vjp_phase(rng, dev):
    """``[densify-vjp]``: the f32 dense assembly's VJP, which no model path
    runs since the dense applies differentiate their coefficients by
    ``coef_cotangent``: ``ops.densify_coefs`` of the reference
    classifier's operator coefficients (B=32, N=1024, K=20, a kNN graph)
    that require grad, backward with random ``[B, 2, N, N]`` cotangents:
    ``densify`` and ``densify_bwd`` once each, the coefficients' gradients
    bit-equal to ``densify_bwd_plain``. Its clouds come from a generator
    spawned off ``rng``."""
    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn

    (rng,) = rng.spawn(1)
    clouds, normals = ellipsoid_clouds(rng, [N] * B)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    idx, nbr_mask = knn(pos, K)
    gd = ops.build_grad_div_fused(pos, nrm, *build_tangent_basis(nrm), idx,
                                  nbr_mask)
    gc = gd.grad_coef.clone().requires_grad_()
    dc = gd.div_coef.clone().requires_grad_()
    dwg = torch.randn((B, 2, N, N), device=dev)
    dwd = torch.randn((B, 2, N, N), device=dev)
    reset_launch_counts()
    torch.autograd.backward(ops.densify_coefs(idx, gc, dc), (dwg, dwd))
    torch.cuda.synchronize()
    counts = launch_counts()
    check("[densify-vjp] densify and densify_bwd once each",
          counts["densify"] == 1 and counts["densify_bwd"] == 1,
          f"{counts['densify']}, {counts['densify_bwd']}")
    want = ops.densify_bwd_plain(idx, dwg, dwd)
    check("[densify-vjp] the coefficients' gradients against the plain "
          "version", torch.equal(gc.grad, want[0])
          and torch.equal(dc.grad, want[1]), "bit-equal")
    return counts


def serve_fused_build_phase(clouds, seed, dev, card):
    """``[serve-fused-build]``: the production bf16 classifier (approximate
    kNN, bf16 compute and operators) served at B=32, N=1024 with its
    backbone's ``fused_eval_build`` on and off, on the same weights and
    64 uniform clouds (the gate takes no point mask). Held: the fused
    route through the kernels within FUSED_PATH_REL x max|logit| of the
    same route through the plain versions and of the unfused route, the
    argmax equal where decisive; launches per forward as
    FUSED_PER_FORWARD. Prints the build's and one forward's device time
    on both routes and clouds/s of both engines."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine, KERNEL_OPS,
                                     launch_counts, reset_launch_counts)
    from deltaconv_tpu_torch.models import (build_dense_operators_fused,
                                            build_operators)

    model = random_model(seed, dev, knn_method="approx")
    kw = dict(num_points=N, batch_size=B, precision="bfloat16")
    engines = {}
    for fused in (False, True):
        for route, ops in (("kernels", KERNEL_OPS), ("plain", PLAIN_OPS)):
            engine = InferenceEngine(model, ops=ops, **kw)
            # A measurement of the backbone's route: the heads take no
            # fused_eval_build (as in the JAX package), so the switch is
            # set on the served copy's backbone.
            engine.model.deltanet_base.fused_eval_build = fused
            engines[fused, route] = engine
    uni, uni_n = clouds[0], clouds[1]
    for engine in engines.values():
        engine.predict(uni[:B], uni_n[:B])  # warm-up
    torch.cuda.synchronize()
    out, times = {}, {}
    for fused in (False, True):
        reset_launch_counts()
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            out[fused] = engines[fused, "kernels"].predict(uni, uni_n)
            t.append(time.perf_counter() - t0)
        times[fused] = float(np.median(t))
        counts = launch_counts()
        forwards = 3 * (len(uni) // B)
        if fused:
            fused_counts = counts
            print(f"[serve-fused-build] launches ({forwards} forwards, "
                  f"fused): {counts}")
            for name, per in FUSED_PER_FORWARD.items():
                check(f"{name} {per} a forward",
                      counts[name] == per * forwards,
                      f"{counts[name]} launches in {forwards} forwards")
        else:
            check("the unfused route takes no fused build",
                  counts["fused_gather_wls"] == 0
                  and counts["knn_topk_mean_dist"] == 0,
                  f"{counts['fused_gather_wls']} fused_gather_wls launches")
    check("fused logits", out[True].shape == (64, NUM_CLASSES)
          and bool(np.isfinite(out[True]).all()), f"shape {out[True].shape}")
    held_to("fused route, kernels vs plain", out[True],
            engines[True, "plain"].predict(uni, uni_n), FUSED_PATH_REL)
    held_to("fused vs unfused route", out[True], out[False], FUSED_PATH_REL)

    pos = torch.from_numpy(np.stack(uni[:B])).to(dev)
    nrm = torch.from_numpy(np.stack(uni_n[:B])).to(dev)
    build = {
        True: lambda: build_dense_operators_fused(pos, K, nrm),
        False: lambda: build_operators(pos, K, nrm,
                                       operator_dtype="bfloat16",
                                       knn_method="approx")}
    with torch.no_grad():
        gd_f, gd_u = build[True](), build[False]()
        x = torch.randn((B, N, 64), device=dev).to(torch.bfloat16)
        want = gd_u.grad(x).float()
        rel = max_err(gd_f.grad(x).float(), want) / float(want.abs().max())
        check("the fused operators' grad vs the unfused", rel <=
              FUSED_PATH_REL, f"{rel:.3e} x max <= {FUSED_PATH_REL}")
        ms = {f: (device_ms(fn), median_ms(fn)) for f, fn in build.items()}
    print(f"[serve-fused-build] the operator build at B={B}, N={N}, K={K} "
          f"(bf16 operators, approximate kNN), device time (profiler) and "
          f"CUDA-event median of back-to-back calls: fused "
          f"{ms[True][0]:.4f} and {ms[True][1]:.4f} ms (knn_topk with mean "
          f"distances, frames, fused_gather_wls, densify_bf16), unfused "
          f"{ms[False][0]:.4f} and {ms[False][1]:.4f} ms (knn_topk, frames, "
          f"gather_rows, planes, wls, normalization, densify_bf16); card: "
          f"{card}")
    fwd = {f: device_ms(lambda f=f: engines[f, "kernels"].predict(
        uni[:B], uni_n[:B])) for f in (False, True)}
    print(f"[serve-fused-build] one {B}-cloud forward (predict), device time "
          f"(profiler): fused {fwd[True]:.4f} ms, unfused {fwd[False]:.4f} "
          f"ms; card: {card}")
    for fused in (False, True):
        t = times[fused]
        print(f"[serve-fused-build] fused_eval_build={fused}: 64 uniform "
              f"clouds, median {t * 1e3:.3f} ms per call of 2 batches, "
              f"{64 / t:.1f} clouds/s (host clock, synchronised), card: "
              f"{card}")
    profile("serve-fused-build", "one 64-cloud predict call (fused)",
            lambda: engines[True, "kernels"].predict(uni, uni_n),
            times[True] * 1e3)
    return fused_counts


def nbr_minmax_phase(rng, dev, card):
    """``[nbr-minmax]``: the min/max hooks on the operator object that the
    reference classifier builds (``build_operators``: k=20, dense f32) for
    32 uniform clouds of 1024 points and 11 ragged ones (their padded
    points' rows have no valid neighbour): ``gd.nbr_minmax`` at the conv
    widths (f32 64, 128, 256; bf16 64, 128), its gradient at C=256 (f32:
    random cotangents, within SCATTER_RTOL x max; bf16: integer ones, exact
    sums in any order, bit-equal) with cotangents on every row, and
    ``gd.nbr_matmul_minmax`` at 128 -> 256 (``mm_minmax_held``), each
    through the kernels and, on the same build, the plain versions (the
    forwards bit-equal). Counts each call's launches exactly, and the
    phase's. Then the sharded forms on a 1-rank ``nccl`` group (a
    FileStore in a temporary directory) against the unsharded hooks on
    the same cloud's operators: ``nbr_minmax`` bit-equal, the matmul form
    held by ``mm_minmax_held``."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from deltaconv_tpu_torch import (PLAIN_OPS, launch_counts,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.models import build_operators
    from deltaconv_tpu_torch.parallel import (ShardedGradDiv,
                                              point_sharded_operators)

    sizes = rng.integers(N * 600 // 1024, N, MINMAX_RAGGED).tolist()
    batches = (("uniform", train_batch(rng, dev, [N] * B, N)),
               ("ragged", train_batch(rng, dev, sizes, N)))
    w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
    phase = dict.fromkeys(MINMAX_KERNELS, 0)

    def launched(label, want):
        """The launches since the last reset equal ``want``; added to the
        phase's counts."""
        got = {k: v for k, v in launch_counts().items() if v}
        check(f"[nbr-minmax] {label} launches", got == want, f"{got}")
        for name, v in got.items():
            phase[name] += v
        reset_launch_counts()

    gds = {}
    for label, batch in batches:
        print(f"[nbr-minmax] {label} ({len(batch['label'])} clouds of up to "
              f"{N} points)", flush=True)
        gd = gds[label] = build_operators(batch["pos"], K, batch["normal"],
                                          batch.get("point_mask"))
        gp = dataclasses.replace(gd, ops=PLAIN_OPS)
        reset_launch_counts()
        b = gd.nbr_idx.shape[0]
        empty = int((~gd.nbr_mask.any(dim=-1)).sum())
        for dt, widths in ((torch.float32, MINMAX_WIDTHS),
                           (torch.bfloat16, MINMAX_BF16_WIDTHS)):
            sfx = "_bf16" if dt == torch.bfloat16 else ""
            for c in widths:
                h = torch.randn((b, N, c), device=dev).to(dt)
                got = gd.nbr_minmax(h)
                launched(f"{label} nbr_minmax {str(dt)[6:]} C={c}",
                         {f"gather_minmax{sfx}": 1})
                want = gp.nbr_minmax(h)
                check(f"[nbr-minmax] {label} nbr_minmax {str(dt)[6:]} C={c} "
                      f"kernels vs plain",
                      all(bits_equal(g, v) for g, v in zip(got, want)),
                      f"max and min bit-equal ({empty} rows with no valid "
                      f"neighbour)")
            h = torch.randn((b, N, MINMAX_C), device=dev).to(dt)
            if dt == torch.float32:
                cts = torch.randn((2, b, N, MINMAX_C), device=dev)
            else:
                cts = torch.randint(-4, 5, (2, b, N, MINMAX_C),
                                    device=dev).to(dt)
            grads = []
            for op in (gd, gp):
                hg = h.clone().requires_grad_()
                torch.autograd.backward(op.nbr_minmax(hg), (cts[0],
                                                            -2 * cts[1]))
                grads.append(hg.grad)
                if op is gd:
                    launched(f"{label} nbr_minmax gradient {str(dt)[6:]}",
                             {f"gather_minmax_win{sfx}": 1,
                              f"gather_minmax_bwd{sfx}": 1})
            err = max_err(grads[0].float(), grads[1].float())
            tol = (SCATTER_RTOL * float(grads[1].float().abs().max())
                   if dt == torch.float32 else 0.0)
            check(f"[nbr-minmax] {label} gradient {str(dt)[6:]} "
                  f"C={MINMAX_C} kernels vs plain",
                  grads[0].dtype == dt and bool(torch.isfinite(
                      grads[0].float()).all()) and err <= tol,
                  f"max_abs_err {err} <= {tol}")
        x = torch.randn((b, N, MM_IN), device=dev)
        got = gd.nbr_matmul_minmax(x, w)
        launched(f"{label} nbr_matmul_minmax", {"gather_matmul_minmax": 1})
        xb = x.to(torch.bfloat16)
        ok, detail = mm_minmax_held(got, xb, w, gd.nbr_idx, gd.nbr_mask)
        want = gp.nbr_matmul_minmax(x, w)
        check(f"[nbr-minmax] {label} nbr_matmul_minmax {MM_IN}->{MM_OUT}", ok,
              f"{detail}; vs the plain route max_abs_err "
              f"{max(max_err(g.float(), v.float()) for g, v in zip(got, want))}")
    n_b = len(batches)
    want = {"gather_minmax": n_b * len(MINMAX_WIDTHS),
            "gather_minmax_bf16": n_b * len(MINMAX_BF16_WIDTHS),
            "gather_minmax_win": n_b, "gather_minmax_win_bf16": n_b,
            "gather_minmax_bwd": n_b, "gather_minmax_bwd_bf16": n_b,
            "gather_matmul_minmax": n_b}
    check("[nbr-minmax] the hook calls' launches", phase == want,
          f"{phase}")

    gd = gds["uniform"]
    h = torch.randn((B, N, MINMAX_C), device=dev)
    x = torch.randn((B, N, MM_IN), device=dev)
    print(f"[nbr-minmax] per hook call at B={B} N={N} K={K} (uniform, "
          f"CUDA events), card: {card}: nbr_minmax f32 C={MINMAX_C} "
          f"{median_ms(lambda: gd.nbr_minmax(h)):.4f} ms, nbr_matmul_minmax "
          f"f32 x {MM_IN}->{MM_OUT} "
          f"{median_ms(lambda: gd.nbr_matmul_minmax(x, w)):.4f} ms")

    pos, nrm = batches[0][1]["pos"][0], batches[0][1]["normal"][0]
    h1, x1 = h[:1], x[:1].to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1)
        try:
            group = dist.group.WORLD
            local = point_sharded_operators(pos, K, nrm, group=group)
            sgd = ShardedGradDiv(local, group)
            for dt in (torch.float32, torch.bfloat16):
                got = sgd.nbr_minmax(h1.to(dt))
                want = local.nbr_minmax(h1.to(dt))
                check(f"[nbr-minmax] sharded nbr_minmax {str(dt)[6:]} "
                      f"(1-rank nccl) vs the hook",
                      all(g.dtype == dt and bits_equal(g, v)
                          for g, v in zip(got, want)), "bit-equal")
            got = sgd.nbr_matmul_minmax(x1, w)
            ok, detail = mm_minmax_held(got, x1, w, local.nbr_idx,
                                        local.nbr_mask)
            check("[nbr-minmax] sharded nbr_matmul_minmax bf16 (1-rank "
                  "nccl) vs the hook's plain version", ok, detail)
        finally:
            dist.destroy_process_group()
    return phase


# -- clouds without normals -------------------------------------------------------


def knn_k10_phase(res, seed, dev, card):
    """``[knn-k10]``: the three kNN kernels at K = NORMAL_K, the normal
    graph of a cloud without normals: knn_topk (#23) at B=32, N=1024,
    packed and exact, on ellipsoids and on a tie-heavy grid;
    knn_topk_table (#24) at Nq = Nt = 8192 and knn_topk_bucketed (#25) at
    N=65,536, exact and quantized, uniform and 10% masked: ids equal to
    the plain versions, the exact bodies' winner sets equal to the
    library call's (near ties exempt). Then each is timed beside its
    plain version, its library call and its bound, as at K=20 (the
    bucketed kNN by its candidate sweep, and the whole call). Its clouds
    come from a generator of its own."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.ops import knn_bucketed as kb

    rng = np.random.default_rng([seed, NORMAL_K])
    k = NORMAL_K

    def held(name, label, got, want):
        err = float((got.long() - want.long()).abs().max())
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        check(f"[knn-k10] {name} {label}", torch.equal(got, want),
              f"ids equal to the plain version, max |diff| {err}")

    def body(quantized):
        return "packed" if quantized else "exact"

    print(f"[knn-k10] K={k}: knn_topk B={B} N={N}, knn_topk_table "
          f"{SHARD_TABLE_N} x {SHARD_TABLE_N}, knn_topk_bucketed N={SHARD_N}",
          flush=True)
    ell = torch.from_numpy(np.stack(ellipsoid_clouds(rng, [N] * B)[0])).to(
        dev)
    for label, pos in (("ellipsoids", ell),
                       ("grid", grid_clouds(rng, B, N, dev))):
        for quantized in (True, False):
            held("knn_topk", f"{label} {body(quantized)}",
                 ops.knn_topk(pos, k, quantized),
                 ops.knn_topk_plain(pos, k, quantized))
    clouds = {}
    for n, fn, plain, label in (
            (SHARD_TABLE_N, ops.knn_topk_table, ops.knn_topk_table_plain,
             "knn_topk_table"),
            (SHARD_N, ops.knn_topk_bucketed, ops.knn_topk_bucketed_plain,
             "knn_topk_bucketed")):
        bucketed = label == "knn_topk_bucketed"
        for masked in (False, True):
            pos, _, pm = shard_cloud(rng, n, masked)
            clouds[label, masked] = pos
            for quantized in (False, True):
                name = label + ("_q" if quantized else "")
                got = fn(pos, pos, k, 0, pm, quantized=quantized)
                branch = dict(kb.last_branch) if bucketed else {}
                held(name, f"masked={masked}" + (
                    f", exact mode's branch {branch}" if branch else ""),
                    got, plain(pos, pos, k, 0, pm, quantized=quantized))
                if not quantized:
                    # A masked query row keeps its own column in slot 0 in
                    # the bucketed kNN (the library's masks it): valid rows.
                    same_winner_sets(
                        f"[knn-k10] {name} masked={masked}", got, pos, pos,
                        k, 0, pm, pm if bucketed else None)
    torch.cuda.synchronize()

    print(f"[knn-k10] times at K={k}, median of CUDA-event samples of "
          f"{INNER} calls ({REPS} for knn_topk, {SHARD_REPS} above; the "
          f"plain sweep 1), card: {card}")
    lib = median_ms(lambda: torch.topk(
        2.0 * torch.matmul(ell, ell.transpose(1, 2))
        - (ell * ell).sum(-1)[:, None, :], k, dim=-1))
    for quantized in (True, False):
        out = ops.knn_topk(ell, k, quantized)
        km = median_ms(lambda: ops.knn_topk(ell, k, quantized))
        pl = median_ms(lambda: ops.knn_topk_plain(ell, k, quantized))
        bd = bound(nbytes(ell, out), float(B) * N * N * (
            KNN_INSTR_PER_PAIR if quantized else TABLE_INSTR), ISSUE_PER_S)
        print(f"  knn_topk B={B} N={N} K={k} {body(quantized)}: kernel "
              f"{km:.4f} ms, plain {pl:.4f} ms, library (matmul + topk) "
              f"{lib:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), kernel at "
              f"{bd[0] / km:.3f} of it", flush=True)
    tab = clouds["knn_topk_table", False]
    lib = median_ms(lambda: knn_library(tab, tab, k), SHARD_REPS)
    for quantized in (False, True):
        name = "knn_topk_table" + ("_q" if quantized else "")
        out = ops.knn_topk_table(tab, tab, k, quantized=quantized)
        km = median_ms(lambda: ops.knn_topk_table(tab, tab, k,
                                                  quantized=quantized),
                       SHARD_REPS)
        pl = median_ms(lambda: ops.knn_topk_table_plain(
            tab, tab, k, quantized=quantized), SHARD_REPS)
        bd = bound(nbytes(tab, tab, out), float(SHARD_TABLE_N) ** 2 * (
            KNN_INSTR_PER_PAIR if quantized else TABLE_INSTR), ISSUE_PER_S)
        print(f"  {name} {SHARD_TABLE_N} x {SHARD_TABLE_N} K={k}: kernel "
              f"{km:.4f} ms, plain {pl:.4f} ms, library (chunked matmul + "
              f"topk) {lib:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), kernel "
              f"at {bd[0] / km:.3f} of it", flush=True)
    pos = clouds["knn_topk_bucketed", False]
    for quantized in (False, True):
        name = "knn_topk_bucketed" + ("_q" if quantized else "")
        args = sweep_args(pos, k, quantized)
        posq, sqq, srow, comb, perm, cand, box, _, _, _ = args
        km = median_ms(lambda: kb._cand_kernel(*args), SHARD_REPS)
        pl = median_ms(lambda: kb._cand_plain(*args), 1)
        lm = median_ms(lambda: sweep_library(args), SHARD_REPS)
        whole = median_ms(lambda: ops.knn_topk_bucketed(
            pos, pos, k, quantized=quantized), SHARD_REPS)
        idx, sc = kb._cand_kernel(*args)
        pairs = float(posq.shape[0]) * cand.shape[1] * comb.shape[-1]
        bd = bound(nbytes(posq, sqq, srow, comb, perm, cand, box, idx, sc),
                   pairs * (KNN_INSTR_PER_PAIR if quantized else
                            TABLE_INSTR), ISSUE_PER_S)
        print(f"  {name} candidate sweep N={SHARD_N} K={k}, m={cand.shape[1]}"
              f" buckets of {comb.shape[-1]}: kernel {km:.4f} ms, plain "
              f"{pl:.4f} ms, library (gather + bmm + topk) {lm:.4f} ms, bound "
              f"{bd[0]:.4f} ms ({bd[1]}), kernel at {bd[0] / km:.3f} of it; "
              f"the whole knn_topk_bucketed call {whole:.4f} ms", flush=True)
    # What the plain versions' score blocks leave in the caching allocator
    # is released before the serving phases.
    reserved = torch.cuda.memory_reserved() / 2**30
    del args, clouds, ell, tab, pos, posq, sqq, srow, comb, perm, cand, box
    del idx, sc
    torch.cuda.empty_cache()
    print(f"[knn-k10] the caching allocator held {reserved:.2f} GiB, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} after empty_cache",
          flush=True)


def fps_phase(seed, card):
    """``[fps]``: the ScanObjectNN recipe's pre-transform on this machine:
    the port's geodesic FPS library built by ``g++`` from the checkout's
    ``deltaconv_tpu_torch/cpp`` into ``deltaconv_tpu_torch/_build`` (not
    the JAX package's), and ``GeodesicFPS(FPS_SAMPLES)`` of one
    FPS_N-point cloud: FPS_SAMPLES distinct points, the normals
    subsampled with them, the same again from the same seed."""
    from deltaconv_tpu_torch.cpp import build as cpp_build
    from deltaconv_tpu_torch.data import Cloud
    from deltaconv_tpu_torch.transforms import GeodesicFPS

    rng = np.random.default_rng([seed, FPS_N])
    t0 = time.perf_counter()
    lib = cpp_build.load_library()
    built = time.perf_counter() - t0
    check("[fps] the port's library, built from its own source",
          lib is not None and Path(lib._name) == cpp_build._SO,
          f"{None if lib is None else lib._name} in {built:.2f} s")
    (cloud,), (normal,) = ellipsoid_clouds(rng, [FPS_N])
    t0 = time.perf_counter()
    out = GeodesicFPS(FPS_SAMPLES, seed=seed)(Cloud(pos=cloud, normal=normal))
    ms = (time.perf_counter() - t0) * 1e3
    idx = out.sample_idx
    check("[fps] GeodesicFPS subsamples the cloud",
          out.pos.shape == (FPS_SAMPLES, 3)
          and len(np.unique(idx)) == FPS_SAMPLES
          and np.array_equal(out.pos, cloud[idx])
          and np.array_equal(out.normal, normal[idx]),
          f"{out.pos.shape}, {len(np.unique(idx))} distinct points")
    again = GeodesicFPS(FPS_SAMPLES, seed=seed)(Cloud(pos=cloud))
    check("[fps] the same samples from the same seed",
          np.array_equal(again.sample_idx, idx), "sample_idx equal")
    print(f"[fps] GeodesicFPS({FPS_SAMPLES}) of one {FPS_N}-point cloud: "
          f"{ms:.1f} ms (host clock, this machine's CPU); g++ built the "
          f"library in {built:.2f} s; card: {card}")


def kernel_launches(fn, reps=3) -> float:
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches, from ``torch.profiler`` over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and "spin_kernel" not in evt.key) / reps


def frames_costs(tag, pos, forward_ms, card):
    """The frames of 32 clouds without normals alone: ``estimate_basis``
    on their NORMAL_K-NN graph (exact), its device time and share of one
    forward's, its device launches and its host time a call (the enqueue,
    no synchronisation inside)."""
    from deltaconv_tpu_torch.geometry import estimate_basis, knn

    idx, mask = knn(pos, NORMAL_K)

    def frames():
        with torch.inference_mode():
            return estimate_basis(pos, idx, mask, orientation=pos)

    ms = device_ms(frames)
    launches = kernel_launches(frames)
    host = []
    for _ in range(FRAMES_HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    print(f"[{tag}] the frames alone (estimate_basis, B={B}, N={N}, "
          f"K={NORMAL_K}): {ms:.4f} ms of device time, {ms / forward_ms:.3f} "
          f"of the forward's {forward_ms:.3f}; {launches:g} device launches "
          f"a call; host {np.median(host) * 1e3:.3f} ms a call (median of "
          f"{FRAMES_HOST_REPS}); card: {card}")


def serve_no_normals_phase(seed, dev, card, precision):
    """``[serve-no-normals]`` (f32, exact kNN) and
    ``[serve-no-normals-bf16]`` (``precision="bfloat16"``, approximate
    kNN): the ScanObjectNN recipe's model (RECIPE, seeded weights,
    randomized BatchNorm) on 64 uniform and 11 ragged clouds WITHOUT
    normals: finite logits of the right shapes; the kernel path against
    the plain path on the card (f32 atol 1e-3 and the argmax equal; bf16
    within 0.01 x max|logit|, the argmax equal where decisive), a full
    cloud the same served ragged or uniform; the path's kernels
    launched, wls once a forward, knn_topk twice a uniform bf16 forward
    (the K=20 graph and the normal graph) and never otherwise; clouds/s;
    the device time of one 32-cloud forward with estimated normals and
    with the clouds' own; in f32 also the frames alone
    (:func:`frames_costs`)."""
    from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    tag = "serve-no-normals" + ("-bf16" if precision else "")
    knn_method = "approx" if precision else "exact"
    rng = np.random.default_rng([seed, RECIPE["num_classes"]])
    model = random_model(seed, dev, knn_method=knn_method, **RECIPE)
    kw = dict(num_points=N, batch_size=B, precision=precision)
    engine = InferenceEngine(model, **kw)
    plain = InferenceEngine(model, ops=PLAIN_OPS, **kw)
    uni, uni_n, rag, _ = serving_clouds(rng)
    engine.predict(uni[:B])  # warm-up
    engine.predict(rag[:3])
    torch.cuda.synchronize()

    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits_u = engine.predict(uni)
        times.append(time.perf_counter() - t0)
    logits_r = engine.predict(rag)
    counts = launch_counts()
    uniform = 3 * (len(uni) // B)
    print(f"[{tag}] launches during serving ({uniform} uniform forwards, 1 "
          f"ragged): { {n: c for n, c in counts.items() if c} }")
    print(f"[{tag}] checks")
    classes = RECIPE["num_classes"]
    check("uniform logits", logits_u.shape == (64, classes)
          and bool(np.isfinite(logits_u).all()), f"shape {logits_u.shape}")
    check("ragged logits", logits_r.shape == (11, classes)
          and bool(np.isfinite(logits_r).all()), f"shape {logits_r.shape}")
    for name in NO_NORMALS_KERNELS[precision]:
        check(f"{name} launched", counts[name] > 0, f"{counts[name]} launches")
    per = 2 if precision else 0
    check(f"knn_topk {per} a uniform forward, 0 a ragged one",
          counts["knn_topk"] == per * uniform,
          f"{counts['knn_topk']} launches in {uniform} uniform forwards")
    check("wls once a forward", counts["wls"] == uniform + 1,
          f"{counts['wls']} launches in {uniform + 1} forwards")
    for label, cl, got in (("uniform", uni, logits_u),
                           ("ragged", rag, logits_r)):
        ref = plain.predict(cl)
        if precision:
            held_to(f"{label} kernel vs plain path", got, ref, BF16_PATH_REL)
        else:
            err = float(np.abs(got - ref).max())
            same = bool((got.argmax(1) == ref.argmax(1)).all())
            check(f"{label} kernel vs plain path", err <= LOGIT_ATOL and same,
                  f"max_abs_err {err} <= {LOGIT_ATOL}, argmax equal {same}")
    if precision:
        held_to("full cloud ragged (exact kNN) vs uniform (knn_topk)",
                logits_r[-1:], logits_u[:1], BF16_REL)
    else:
        err = float(np.abs(logits_r[-1] - logits_u[0]).max())
        check("full cloud ragged vs uniform", err <= LOGIT_ATOL,
              f"max_abs_err {err} <= {LOGIT_ATOL}")
    t = float(np.median(times))
    print(f"[{tag}] 64 uniform clouds without normals (N={N}, batch {B}, "
          f"knn_method={knn_method}, precision={precision}): median "
          f"{t * 1e3:.3f} ms per call of 2 batches, {64 / t:.1f} clouds/s "
          f"(host clock, synchronised), card: {card}")

    pos = torch.from_numpy(np.stack(uni[:B])).to(dev)
    nrm = torch.from_numpy(np.stack(uni_n[:B])).to(dev)

    def forward(normal):
        with torch.inference_mode():
            return engine.model(pos, normal, None, ops=KERNEL_OPS)

    est = device_ms(lambda: forward(None))
    given = device_ms(lambda: forward(nrm))
    print(f"[{tag}] one {B}-cloud forward's device time: estimated normals "
          f"{est:.3f} ms, the clouds' own normals {given:.3f} ms "
          f"(+{est - given:.3f}); card: {card}")
    if precision is None:
        frames_costs(tag, pos, est, card)
    return counts


def vote_phase(seed, dev, card):
    """``[vote]``: ``InferenceEngine.predict_voting`` of the recipe's f32
    model (exact kNN), VOTES votes of the default augmentation
    (RandomScale 4/5..5/4, then RandomTranslateGlobal 0.1) on 32 clouds
    without normals, through the kernels and through the plain versions
    from one seed, hence the same draws (the generator is on the card and
    only the augmentation draws from it): finite, within VOTES x 1e-3 and
    the argmax equal; wls once a vote; the votes differ from VOTES
    single passes by more than VOTE_MOVED x max|votes| (the augmentation
    ran); host ms a vote."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    rng = np.random.default_rng([seed, VOTES])
    model = random_model(seed, dev, **RECIPE)
    engine = InferenceEngine(model, num_points=N, batch_size=B)
    plain = InferenceEngine(model, num_points=N, batch_size=B,
                            ops=PLAIN_OPS)
    clouds, _ = ellipsoid_clouds(rng, [N] * B)
    engine.predict_voting(clouds, num_votes=1, seed=seed)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.predict_voting(clouds, num_votes=VOTES, seed=seed)
    t = time.perf_counter() - t0
    counts = launch_counts()
    print("[vote] checks")
    check("votes", got.shape == (B, RECIPE["num_classes"])
          and bool(np.isfinite(got).all()), f"shape {got.shape}")
    check("wls once a vote", counts["wls"] == VOTES,
          f"{counts['wls']} launches in {VOTES} votes")
    want = plain.predict_voting(clouds, num_votes=VOTES, seed=seed)
    err = float(np.abs(got - want).max())
    same = bool((got.argmax(1) == want.argmax(1)).all())
    check("kernel vs plain path, the same draws",
          err <= VOTES * LOGIT_ATOL and same,
          f"max_abs_err {err} <= {VOTES * LOGIT_ATOL}, argmax equal {same}")
    moved = float(np.abs(got - VOTES * engine.predict(clouds)).max())
    floor = VOTE_MOVED * float(np.abs(got).max())
    check("the augmentation moved the logits", moved > floor,
          f"max |votes - {VOTES} x predict| {moved} > {floor}")
    print(f"[vote] {VOTES} votes on {B} clouds without normals: "
          f"{t * 1e3:.3f} ms a call, {t * 1e3 / VOTES:.3f} ms a vote (host "
          f"clock, synchronised), card: {card}")
    return counts


def recipe_steps(batch, seed, dev, ops, steps=NO_NORMALS_STEPS):
    """``steps`` steps of a fresh recipe model (dropout 0) through ``ops``:
    the last loss and the model (:func:`compare_steps`' ``once``)."""
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    model = random_model(seed, dev, dropout=0.0, affine=False, **RECIPE)
    state = create_train_state(model, sgd_momentum(TRAIN_LR))
    step = make_train_step(model, ops=ops)
    losses = [float(step(state, batch, None)["loss"]) for _ in range(steps)]
    check("[train-no-normals] losses finite", bool(np.isfinite(losses).all()),
          f"{losses}")
    return losses[-1], model


def train_no_normals_phase(seed, dev, card):
    """``[train-no-normals]``: NO_NORMALS_STEPS f32 SGD steps of the
    recipe's model (exact kNN) at B=32, N=1024 on batches without
    ``normal``, uniform and ragged, through the kernels and through the
    plain versions from the same weights, held as :func:`compare_steps`
    holds a step: on the same build the loss, every gradient and
    parameter and the running statistics after the last step; through
    the plain build (uniform, one step) the loss and the statistics. The
    kernels' steps launch the f32 step's kernels."""
    from deltaconv_tpu_torch import (KERNEL_OPS, launch_counts,
                                     reset_launch_counts)

    rng = np.random.default_rng([seed, NO_NORMALS_STEPS])
    batches = {}
    for label, sizes in (("uniform", [N] * B), ("ragged", rng.integers(
            N * 600 // 1024, N + 1, B).tolist())):
        batch = train_batch(rng, dev, sizes)
        del batch["normal"]
        batch["label"] = batch["label"] % RECIPE["num_classes"]
        batches[label] = batch
    recipe_steps(batches["uniform"], seed + 1, dev, KERNEL_OPS)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    recipe_steps(batches["uniform"], seed, dev, KERNEL_OPS)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[train-no-normals] launches in {NO_NORMALS_STEPS} steps: "
          f"{ {n: c for n, c in counts.items() if c} }")
    for name in NO_NORMALS_TRAIN_KERNELS:
        check(f"[train-no-normals] {name} launched", counts[name] > 0,
              f"{counts[name]} launches")
    print(f"[train-no-normals] {NO_NORMALS_STEPS} steps of a fresh model, "
          f"B={B} N={N}: {t * 1e3:.3f} ms with the model's set-up (host "
          f"clock, synchronised), card: {card}")
    for label, batch in batches.items():
        compare_steps(f"[train-no-normals] {label}, same build", batch, seed,
                      dev, True, once=recipe_steps)
    # Through the plain build, one step, as compare_steps holds it: the
    # builds' ~1e-6 flips neighbour-max winners, and later steps carry
    # the flips into the loss (2.1e-4 rel at step 3 on an H100).
    compare_steps("[train-no-normals] uniform, plain build, one step",
                  batches["uniform"], seed, dev, False,
                  once=functools.partial(recipe_steps, steps=1))
    return counts


def shard_no_normals_phase(seed, dev, card):
    """``[shard-no-normals]``: ``predict_sharded`` of ONE 65,536-point
    cloud WITHOUT normals at ``[serve-shard-bf16]``'s config (reference
    width, coefficient operators, bf16, approximate kNN) on one card: the
    quantized bucketed kNN twice a forward (the K=20 graph and the normal
    graph) and no table kNN; the kernel path within 0.01 x max|logit| of
    the plain path and within 0.05 x max|logit| of the f32 sharded
    engine; host ms a call beside the same cloud with its normals."""
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    rng = np.random.default_rng([seed, SHARD_N])
    model = shard_model(seed, dev, None, "approx")
    kw = dict(num_points=SHARD_N, batch_size=1)
    engine = InferenceEngine(model, precision="bfloat16", **kw)
    plain = InferenceEngine(model, precision="bfloat16", ops=PLAIN_OPS, **kw)
    (cloud,), (normal,) = ellipsoid_clouds(rng, [SHARD_N])
    engine.predict_sharded(cloud)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    times = []
    for _ in range(SHARD_CALLS):
        t0 = time.perf_counter()
        got = engine.predict_sharded(cloud)
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    print(f"[shard-no-normals] launches during {SHARD_CALLS} forwards: "
          f"{ {n: c for n, c in counts.items() if c} }")
    print("[shard-no-normals] checks")
    check("logits", got.shape == (NUM_CLASSES,)
          and bool(np.isfinite(got).all()), f"shape {got.shape}")
    for name in SHARD_BF16_KERNELS:
        check(f"{name} launched", counts[name] > 0, f"{counts[name]} launches")
    for name, per in (("knn_topk_bucketed_q", 2), ("knn_topk_bucketed", 0),
                      ("knn_topk_table", 0), ("knn_topk_table_q", 0)):
        check(f"{name} {per} a forward", counts[name] == per * SHARD_CALLS,
              f"{counts[name]} launches in {SHARD_CALLS} forwards")
    held_to("kernel vs plain path", got[None],
            plain.predict_sharded(cloud)[None], BF16_PATH_REL)
    held_to("bfloat16 vs the f32 sharded engine", got[None],
            InferenceEngine(model, **kw).predict_sharded(cloud)[None],
            BF16_REL)
    t = float(np.median(times))
    given = []
    for _ in range(SHARD_CALLS):
        t0 = time.perf_counter()
        engine.predict_sharded(cloud, normal)
        given.append(time.perf_counter() - t0)
    print(f"[shard-no-normals] one cloud of N={SHARD_N} without normals "
          f"(bf16, knn_method=approx): median {t * 1e3:.3f} ms per "
          f"predict_sharded call against {np.median(given) * 1e3:.3f} ms "
          f"with its normals (host clock, synchronised), card: {card}")
    return counts


# -- training loop and checkpoints ---------------------------------------------


def _sortable(scores):
    """f32 scores' bits as int64 keys in XLA's total order (-0.0 below
    +0.0)."""
    bits = scores.view(np.int32)
    return np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).astype(np.int64)


def unique_key_top_k(s, k):
    """The other exact form of XLA's ``top_k`` (timed in ``[knn-ties]``
    beside the port's stable sort): ``torch.topk`` of unique int64 keys,
    the score's ordered bits above the complemented column."""
    m = s.shape[-1]
    bits = s.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(m - 1, -1, -1, device=s.device, dtype=torch.int64)
    top = torch.topk((key << 32) | col, k, dim=-1).values
    return (m - 1) - (top & 0xFFFFFFFF)


def planar_grids(b, n, dev):
    """``[b, n, 3]`` square grids (n a square: 32 x 32 at N=1024) in the
    plane z = 0, steps of 2 / (side - 1) (so one-ulp near-ties beside the
    exact ones), each cloud's points in another order."""
    side = int(round(n ** 0.5))
    assert side * side == n
    h = np.float32(2.0 / (side - 1))
    u, v = np.meshgrid(np.arange(side, dtype=np.float32) * h - 1.0,
                       np.arange(side, dtype=np.float32) * h - 1.0)
    grid = np.stack([u.ravel(), v.ravel(), np.zeros(n, np.float32)], -1)
    rng = np.random.default_rng(b)
    return torch.from_numpy(np.stack([grid[rng.permutation(n)]
                                      for _ in range(b)])).to(dev)


def knn_ties_phase(seed, dev, card):
    """``[knn-ties]``: the exact kNN's selection (``geometry.knn.top_k``:
    XLA ``top_k``'s answer, equal scores lowest index first) at B=32,
    N=1024, K = 20 and 10, on square planar grids, on a tie-heavy 9^3
    grid with duplicates and on ellipsoids, uniform and (the grids) 10%
    masked: the ids bit-equal to the rule computed on the host from the
    same f32 scores copied off the card (numpy's stable ``argsort`` of
    the negated keys, masked slots clamped to self as the route does)
    and across two calls. Then the route timed beside the parent's
    ``matmul`` + ``torch.topk``, and the selection alone beside
    ``torch.topk`` and ``torch.topk`` of unique int64 keys (the other
    exact form)."""
    from deltaconv_tpu_torch.geometry import knn
    from deltaconv_tpu_torch.geometry.knn import exact_scores, top_k

    rng = np.random.default_rng([seed, TIE_TAG])
    ell = torch.from_numpy(np.stack(ellipsoid_clouds(rng, [N] * B)[0])).to(
        dev)
    pm = torch.from_numpy(rng.random((B, N)) >= SHARD_MASK_FRAC).to(dev)
    cases = (("planar grids", planar_grids(B, N, dev), None),
             ("planar grids, masked", planar_grids(B, N, dev), pm),
             ("9^3 grid", grid_clouds(rng, B, N, dev), None),
             ("9^3 grid, masked", grid_clouds(rng, B, N, dev), pm),
             ("ellipsoids", ell, None))
    print(f"[knn-ties] exact kNN ids against the host's stable sort of the "
          f"card's scores, B={B} N={N} K={TIE_KS}", flush=True)
    for label, pos, mask in cases:
        order = np.argsort(-_sortable(exact_scores(pos, mask).cpu().numpy()),
                           axis=-1, kind="stable")
        valid = (None if mask is None else
                 np.take_along_axis(mask.cpu().numpy()[:, None, :], order[
                     ..., :max(TIE_KS)], axis=-1))
        for k in TIE_KS:
            want = order[..., :k]
            if valid is not None:
                want = np.where(valid[..., :k], want,
                                np.arange(N)[None, :, None])
            got = knn(pos, k, mask)[0]
            again = knn(pos, k, mask)[0]
            diff = int((got.cpu().numpy() != want).any(-1).sum())
            check(f"[knn-ties] {label} K={k}",
                  diff == 0 and torch.equal(got, again),
                  f"{diff} rows differ from the stable sort, two calls "
                  f"equal {torch.equal(got, again)}")
        del order, valid
    torch.cuda.synchronize()
    sq = (ell * ell).sum(-1)
    scores = exact_scores(ell)
    print(f"[knn-ties] times on ellipsoids, median of {REPS} CUDA-event "
          f"samples of {INNER} calls; card: {card}")
    for k in TIE_KS:
        route = median_ms(lambda: knn(ell, k))
        parent = median_ms(lambda: torch.topk(
            2.0 * torch.matmul(ell, ell.transpose(1, 2)) - sq[:, None, :],
            k, dim=-1))
        sel = median_ms(lambda: top_k(scores, k))
        sel_topk = median_ms(lambda: torch.topk(scores, k, dim=-1))
        sel_keys = median_ms(lambda: unique_key_top_k(scores, k))
        print(f"  K={k}: the exact route (scores + XLA-order selection) "
              f"{route:.4f} ms, the parent's matmul + topk {parent:.4f} ms "
              f"(+{route - parent:.4f}); the selection alone (stable sort "
              f"of the ordered bits) {sel:.4f} ms, torch.topk {sel_topk:.4f}"
              f" ms, torch.topk of unique int64 keys {sel_keys:.4f} ms; "
              f"card: {card}", flush=True)
    del scores
    torch.cuda.empty_cache()


def write_scanobjectnn(root, rng, args) -> str:
    """A ScanObjectNN fixture of FIT_TRAIN and FIT_TEST clouds of
    SONN_POINTS points on ellipsoids, 15 classes: the h5 files of the
    ``main_split_nobg`` layout (the keys of
    ``tests/training/test_cli_smoke.py``) where ``h5py`` is installed;
    else (the reader needs ``h5py``) the processed cache that
    ``ScanObjectNN.process`` writes from them, the CLI's
    ``GeodesicFPS`` pre-transform run here as ``process`` runs it.
    Returns which."""
    import importlib.util

    from deltaconv_tpu_torch.data import Cloud, CloudDataset, ScanObjectNN
    from deltaconv_tpu_torch.transforms import GeodesicFPS

    splits = {}
    for split, count in (("train", FIT_TRAIN), ("test", FIT_TEST)):
        splits[split] = (np.stack(ellipsoid_clouds(
            rng, [SONN_POINTS] * count)[0]).astype(np.float32),
            rng.integers(0, RECIPE["num_classes"], count))
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        raw = Path(root) / "raw" / "main_split_nobg"
        raw.mkdir(parents=True)
        for split, fn in zip(("train", "test"),
                             ScanObjectNN.raw_file_dict[None]):
            with h5py.File(raw / fn, "w") as f:
                f["data"], f["label"] = splits[split]
        return "h5 files (main_split_nobg)"
    pre = GeodesicFPS(args.num_points, seed=args.seed)
    for split, (data, labels) in splits.items():
        CloudDataset._save(
            str(Path(root) / "processed" / f"scanobjectnn_nobg_vanilla_"
                f"{split}.npz"),
            [pre(Cloud(pos=p, y=np.int64(y))) for p, y in zip(data, labels)])
    return ("the processed cache (no h5py here: GeodesicFPS run by the "
            "phase as ScanObjectNN.process runs it)")


def _icosphere():
    """The unit icosphere subdivided twice: ``(verts [162, 3], faces
    [320, 3])``."""
    t = (1.0 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    v = [np.asarray(p, float) / np.linalg.norm(p) for p in v]
    for _ in range(2):
        mid, nf = {}, []

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = v[a] + v[b]
                v.append(p / np.linalg.norm(p))
                mid[key] = len(v) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    return np.asarray(v), np.asarray(f)


def _closed_mesh(kind, rng):
    """A closed triangle mesh ``(verts [V, 3], faces [F, 3])`` of one
    category: an icosphere (subdivided twice), a box (each face 4 x 4
    squares) or a capped cylinder (32 sides, 8 rings), randomly stretched
    and rotated."""
    if kind == "sphere":
        verts, faces = _icosphere()
    elif kind == "box":
        s = 4
        verts, faces, index = [], [], {}

        def vid(p):
            key = tuple(np.round(p, 6))
            if key not in index:
                index[key] = len(verts)
                verts.append(p)
            return index[key]

        for axis in range(3):
            for sign in (-1.0, 1.0):
                u_ax, v_ax = [a for a in range(3) if a != axis]
                for i in range(s):
                    for j in range(s):
                        quad = []
                        for di, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
                            p = np.zeros(3)
                            p[axis] = sign
                            p[u_ax] = -1 + 2 * (i + di) / s
                            p[v_ax] = -1 + 2 * (j + dj) / s
                            quad.append(vid(p))
                        a, b, c, d = quad if sign > 0 else quad[::-1]
                        faces += [(a, b, c), (a, c, d)]
        verts, faces = np.asarray(verts), np.asarray(faces)
    else:  # cylinder
        sides, rings = 32, 8
        ang = np.arange(sides) * 2 * np.pi / sides
        verts = [np.array([np.cos(a), np.sin(a), -1 + 2 * r / rings])
                 for r in range(rings + 1) for a in ang]
        verts += [np.array([0.0, 0.0, -1.0]), np.array([0.0, 0.0, 1.0])]
        faces = []
        for r in range(rings):
            for i in range(sides):
                a, b = r * sides + i, r * sides + (i + 1) % sides
                faces += [(a, b, b + sides), (a, b + sides, a + sides)]
        bottom, top = len(verts) - 2, len(verts) - 1
        for i in range(sides):
            faces.append((bottom, (i + 1) % sides, i))
            faces.append((top, rings * sides + i,
                          rings * sides + (i + 1) % sides))
        verts, faces = np.asarray(verts), np.asarray(faces)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return (verts * rng.uniform(0.5, 1.5, 3)) @ q, faces


def write_modelnet(root, rng, args) -> str:
    """A ModelNet raw tree of OFF meshes: MODELNET_KINDS categories,
    FIT_TRAIN and FIT_TEST closed meshes in turn over them, and the
    extraction marker (so nothing is downloaded). Returns what it
    wrote."""
    del args
    raw = Path(root) / "raw"
    for split, count in (("train", FIT_TRAIN), ("test", FIT_TEST)):
        for i in range(count):
            kind = MODELNET_KINDS[i % len(MODELNET_KINDS)]
            d = raw / kind / split
            d.mkdir(parents=True, exist_ok=True)
            v, f = _closed_mesh(kind, rng)
            with open(d / f"{kind}_{i:04d}.off", "w") as fh:
                fh.write(f"OFF\n{len(v)} {len(f)} 0\n")
                fh.writelines(" ".join(f"{c:.6f}" for c in p) + "\n"
                              for p in v)
                fh.writelines("3 " + " ".join(map(str, t)) + "\n"
                              for t in f)
    (raw / ".extracted").touch()
    return (f"{FIT_TRAIN + FIT_TEST} OFF meshes of {len(MODELNET_KINDS)} "
            "categories")


def _states_bit_equal(a, b) -> str:
    """'' when two train states hold the same bits (model, optimizer
    state, lr, step), else the first difference."""
    for key, value in a.model.state_dict().items():
        if not raw_equal(value, b.model.state_dict()[key]):
            return f"model {key}"
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sa["param_groups"] != sb["param_groups"]:
        return "param_groups"
    for i, entry in sa["state"].items():
        for name, value in entry.items():
            if not raw_equal(torch.as_tensor(value),
                             torch.as_tensor(sb["state"][i][name])):
                return f"optimizer state {i} {name}"
    if a.step != b.step:
        return f"step {a.step} != {b.step}"
    return ""


@contextlib.contextmanager
def timed_fit_steps(times):
    """Wraps the train step that ``training.loop.fit`` builds: each call's
    host time, synchronised, goes to ``times``."""
    from deltaconv_tpu_torch.training import loop

    make = loop.make_train_step

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(state, batch, generator):
            t0 = time.perf_counter()
            out = step(state, batch, generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            timed.last = (state, batch)
            return out

        timed_make.step = timed
        return timed

    loop.make_train_step = timed_make
    try:
        yield timed_make
    finally:
        loop.make_train_step = make


def cold_serve(spec):
    """``--cold-serve``: in a fresh process (the kernel library built on
    disk but not loaded), ``InferenceEngine.from_checkpoint`` of the
    run's checkpoints, ``warmup`` if ``spec["warmup"]``, then the first
    ``predict`` of the test clouds; prints one JSON line of host times."""
    from deltaconv_tpu_torch import InferenceEngine

    cli = importlib.import_module(
        f"deltaconv_tpu_torch.experiments.{spec['cli']}")
    args = cli.build_parser().parse_args(spec["argv"])
    _, test_ds, num_classes = cli_datasets(cli, args)
    clouds = [c.pos for c in test_ds]
    normals = ([c.normal for c in test_ds]
               if test_ds[0].normal is not None else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.init()
    t0 = time.perf_counter()
    engine = InferenceEngine.from_checkpoint(
        cli_model(cli, args, num_classes), spec["checkpoint"],
        num_points=args.num_points, batch_size=args.batch_size)
    out = {"from_checkpoint_s": time.perf_counter() - t0, "warmup_s": None}
    if spec["warmup"]:
        t0 = time.perf_counter()
        engine.warmup(has_normal=normals is not None)
        out["warmup_s"] = time.perf_counter() - t0
    for key in ("first_ms", "second_ms"):
        t0 = time.perf_counter()
        engine.predict(clouds, normals)
        out[key] = (time.perf_counter() - t0) * 1e3
    print("[cold-serve] " + json.dumps(out), flush=True)


def cli_datasets(cli, args):
    """``(train, test, num_classes)`` of a CLI: ``build_datasets_and_
    classes`` where it has one (ShapeNet), else ``build_datasets``' two
    splits and None (the model's own)."""
    if hasattr(cli, "build_datasets_and_classes"):
        return cli.build_datasets_and_classes(args)
    train, test = cli.build_datasets(args)
    return train, test, None


def cli_model(cli, args, num_classes):
    """The CLI's model: ``shapenet_model(args, num_classes)`` (ShapeNet)
    or ``build_model(args)``."""
    if hasattr(cli, "shapenet_model"):
        return cli.shapenet_model(args, num_classes)
    return cli.build_model(args)


def fit_phase(tag, cli, write, seed, dev, card, kernels=FIT_KERNELS,
              edges="sum", cold=True, after=None):
    """``[fit-<dataset>]``: the port's CLI ``main`` on the card at its
    recipe's full width and its parser defaults (bf16 dense operators
    under the f32 conv stack, exact kNN) on a fixture ``write`` puts in a
    temporary directory: the dataset built (first, then from its cache),
    FIT_EPOCHS epochs of 2 steps (``kernels`` launched, and the edge
    aggregation of the model's centralized conv: ``edges="sum"``, the
    edge sum's adjacency or gather_sum; ``"gather"``, a depth-2 conv's
    edge tensor, gather_rows twice a forward, once for the build and once
    for the edges; host ms a step beside one step's device time), the checkpoint's bytes and save and
    restore ms, then 1 epoch and ``--resume`` to FIT_EPOCHS in further
    ``main`` calls, bit-equal to the uninterrupted run; then
    ``InferenceEngine.from_checkpoint`` and ``warmup`` of the run's
    checkpoints (warmup s, the first ``predict``'s ms), its logits on the
    test clouds (with their categories, per point for a segmentation
    CLI) with the eval step's argmax and within SERVE_CKPT_REL x
    max|logit| of it; with ``cold`` the same served by fresh processes
    (``--cold-serve``, without and with ``warmup``); ``after(args, base,
    checkpoints)`` runs before the temporary directory goes. Returns the
    fit's launch counts."""
    import copy
    import tempfile

    from deltaconv_tpu_torch import (InferenceEngine, launch_counts,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.data import BatchLoader
    from deltaconv_tpu_torch.training import (make_eval_step,
                                              make_train_step, restore_any,
                                              restore_checkpoint,
                                              save_checkpoint)

    rng = np.random.default_rng([seed, FIT_EPOCHS, len(tag)])
    tmp = tempfile.mkdtemp(prefix="fit-")
    try:
        root = Path(tmp) / "data"
        base = ["--data_root", str(root), "--seed", str(seed + 1)]
        args = cli.build_parser().parse_args(base)
        defaults = (f"{args.operator_dtype} operators, {args.knn_method} "
                    f"kNN, k={args.k}, lr {args.lr} x 100, B="
                    f"{args.batch_size}, N={args.num_points}")
        t0 = time.perf_counter()
        wrote = write(root, rng, args)
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_ds, test_ds, num_classes = cli_datasets(cli, args)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_ds, test_ds, num_classes = cli_datasets(cli, args)
        cached = time.perf_counter() - t0
        print(f"[{tag}] fixture: {wrote}, written in {written:.2f} s; "
              f"{len(train_ds)} train and {len(test_ds)} test clouds; the "
              f"datasets' first build {first:.2f} s, then {cached:.3f} s "
              f"from their cache (host clock); {defaults}; card: {card}",
              flush=True)

        times = []
        reset_launch_counts()
        with timed_fit_steps(times) as made:
            full, scalars = cli.main(base + ["--epochs", str(FIT_EPOCHS),
                                             "--logdir", f"{tmp}/full"])
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"[{tag}] launches in {FIT_EPOCHS} epochs with their evals: "
              f"{ {n: c for n, c in counts.items() if c} }")
        for name in kernels:
            check(f"[{tag}] {name} launched", counts[name] > 0,
                  f"{counts[name]} launches")
        if edges == "sum":
            check(f"[{tag}] the edge sum's adjacency or gather_sum launched",
                  counts["adjacency"] + counts["gather_sum"] > 0,
                  f"adjacency {counts['adjacency']}, gather_sum "
                  f"{counts['gather_sum']}")
        else:
            check(f"[{tag}] the depth-2 conv's edge gathers: gather_rows "
                  f"twice a build (wls)",
                  counts["gather_rows"] == 2 * counts["wls"] > 0,
                  f"gather_rows {counts['gather_rows']}, wls "
                  f"{counts['wls']}")
        steps = len(times)
        per_epoch = len(train_ds) // args.batch_size
        check(f"[{tag}] {steps} steps of {FIT_EPOCHS} epochs",
              full.step == steps == FIT_EPOCHS * per_epoch == 2 * FIT_EPOCHS,
              f"state.step {full.step}, {per_epoch} steps an epoch")
        state, batch = made.step.last
        per_point = batch["label"].dim() == 2
        scratch = copy.deepcopy(state)
        step = make_train_step(scratch.model, smoothing=cli.RECIPE[
            "smoothing"], per_point=per_point)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dev_ms = device_ms(lambda: step(scratch, batch, gen))
        del scratch
        print(f"[{tag}] fit: median {np.median(times[1:]) * 1e3:.3f} ms a "
              f"step on the host clock (synchronised; {steps} steps, the "
              f"first {times[0] * 1e3:.1f} ms left out) against "
              f"{dev_ms:.3f} ms of device time a step; {scalars}; card: "
              f"{card}", flush=True)

        ckpt = Path(tmp) / "ckpt"
        save_ms, restore_ms = [], []
        for _ in range(CKPT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save_checkpoint(str(ckpt), full)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            target = copy.deepcopy(full)
            t0 = time.perf_counter()
            restore_checkpoint(str(ckpt), target)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        size = (Path(path) / "checkpoint.pt").stat().st_size
        check(f"[{tag}] the checkpoint restores bit-equal",
              _states_bit_equal(full, target) == "", "model, optimizer, "
              "lr and step")
        del target
        print(f"[{tag}] checkpoint: {size} bytes (model, optimizer, "
              f"scheduler, step), save {np.median(save_ms):.2f} ms, restore "
              f"{np.median(restore_ms):.2f} ms (medians of {CKPT_REPS}, host "
              f"clock, synchronised, a warm local disk); card: {card}",
              flush=True)

        part = f"{tmp}/part"
        cli.main(base + ["--epochs", "1", "--logdir", part])
        (run,) = list(Path(part, "runs").glob("*/*"))
        resumed, again = cli.main(base + ["--epochs", str(FIT_EPOCHS),
                                          "--logdir", part,
                                          "--resume", str(run)])
        diff = _states_bit_equal(full, resumed)
        check(f"[{tag}] 1 epoch, then --resume to {FIT_EPOCHS}: bit-equal "
              f"to the uninterrupted run", diff == "" and again == scalars,
              f"first difference: {diff or 'none'}; {again} and {scalars}")

        ckpts = Path(tmp) / "full" / "runs"
        (ckpts,) = list(ckpts.glob("*/*/checkpoints"))
        model = cli_model(cli, args, num_classes)
        t0 = time.perf_counter()
        engine = InferenceEngine.from_checkpoint(
            model, str(ckpts), num_points=args.num_points,
            batch_size=args.batch_size)
        loaded = time.perf_counter() - t0
        has_normal = test_ds[0].normal is not None
        categories = ([c.category for c in test_ds]
                      if test_ds[0].category is not None else None)
        t0 = time.perf_counter()
        engine.warmup(has_normal=has_normal,
                      has_category=categories is not None)
        warm = time.perf_counter() - t0
        clouds = [c.pos for c in test_ds]
        normals = [c.normal for c in test_ds] if has_normal else None
        t0 = time.perf_counter()
        got = engine.predict(clouds, normals, categories)
        first_ms = (time.perf_counter() - t0) * 1e3
        later = []
        for _ in range(CKPT_REPS):
            t0 = time.perf_counter()
            engine.predict(clouds, normals, categories)
            later.append((time.perf_counter() - t0) * 1e3)
        got = np.stack(got) if per_point else got
        target = copy.deepcopy(full)
        restore_any(str(ckpts), target)
        evaluate = make_eval_step(target.model, per_point=per_point)
        loader = BatchLoader(test_ds, args.batch_size, drop_last=False)
        want = np.concatenate([evaluate(target, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()
            if k != "label"}).float().cpu().numpy() for b in loader])
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        check(f"[{tag}] the served checkpoint against the eval step",
              got.shape == want.shape and bool(np.isfinite(got).all())
              and err <= SERVE_CKPT_REL * scale
              and bool((got.argmax(-1) == want.argmax(-1)).all()),
              f"max |diff| {err} <= {SERVE_CKPT_REL} x {scale}, argmax "
              f"equal on {len(clouds)} clouds"
              + (" at every point" if per_point else ""))
        print(f"[{tag}] in this process: from_checkpoint {loaded * 1e3:.1f}"
              f" ms, warmup {warm:.3f} s (the kernels were loaded at [build]"
              f" and every variant ran in the fits), then the first predict "
              f"of {len(clouds)} clouds {first_ms:.3f} ms, later ones "
              f"{np.median(later):.3f} ms (host clock, synchronised); card: "
              f"{card}", flush=True)
        for warmup in ((False, True) if cold else ()):
            spec = {"cli": cli.__name__.rsplit(".", 1)[1], "argv": base,
                    "checkpoint": str(ckpts), "warmup": warmup}
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--cold-serve", json.dumps(spec)], capture_output=True,
                text=True, timeout=600)
            lines = [line for line in run.stdout.splitlines()
                     if line.startswith("[cold-serve] ")]
            check(f"[{tag}] a fresh process serves the checkpoint "
                  f"(warmup {warmup})", run.returncode == 0 and lines,
                  f"exit {run.returncode}{run.stderr[-2000:]}")
            cold_times = json.loads(lines[0][len("[cold-serve] "):])
            print(f"[{tag}] a fresh process (the kernel library built on "
                  f"disk, not loaded): from_checkpoint "
                  f"{cold_times['from_checkpoint_s'] * 1e3:.1f} ms, " + (
                      f"warmup {cold_times['warmup_s']:.3f} s, " if warmup
                      else "no warmup, ") + f"the first predict "
                  f"{cold_times['first_ms']:.3f} ms, the second "
                  f"{cold_times['second_ms']:.3f} ms (host clock, "
                  f"synchronised); card: {card}", flush=True)
        if after is not None:
            after(args, base, ckpts)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _obj_text(v, f) -> str:
    return "".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v) + "".join(
        f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)


def _ply_text(v, f) -> bytes:
    head = ["ply", "format ascii 1.0", f"element vertex {len(v)}",
            "property float x", "property float y", "property float z",
            f"element face {len(f)}",
            "property list uchar int vertex_indices", "end_header"]
    return "\n".join(head + [" ".join(f"{c:.6f}" for c in p) for p in v]
                     + ["3 " + " ".join(map(str, t)) for t in f]).encode() \
        + b"\n"


def write_shrec(root, rng, args) -> str:
    """A SHREC zip (``raw/shrec_16.zip`` in the ``shrec_16/<class>/<split>``
    layout of OBJ meshes): the first len(SHREC_KINDS) classes of
    ``SHREC.class_names``, SHREC_TRAIN training meshes each (10 kept by
    ``--split_seed``: 2 steps of 16 an epoch) and SHREC_TEST test
    meshes, closed meshes of one kind a class, stretched and rotated
    (the CLI's NormalizeScale, SamplePoints(16384), GeodesicFPS(2048) run
    on them). Returns what it wrote."""
    import zipfile

    from deltaconv_tpu_torch.data import SHREC

    del args
    raw = Path(root) / "raw"
    raw.mkdir(parents=True)
    with zipfile.ZipFile(raw / "shrec_16.zip", "w") as z:
        for name, kind in zip(SHREC.class_names, SHREC_KINDS):
            for split, count in (("train", SHREC_TRAIN),
                                 ("test", SHREC_TEST)):
                for i in range(count):
                    z.writestr(f"shrec_16/{name}/{split}/T{i}.obj",
                               _obj_text(*_closed_mesh(kind, rng)))
    return (f"{len(SHREC_KINDS) * (SHREC_TRAIN + SHREC_TEST)} OBJ meshes of "
            f"{len(SHREC_KINDS)} classes in a zip")


def write_shapenet(root, rng, args) -> str:
    """A ShapeNet tree (``raw/<category id>/<name>.txt`` rows ``x y z nx ny
    nz part``, the train/val/test lists, the extraction marker):
    SHAPENET_TRAIN trainval (train and val) and SHAPENET_TEST test clouds
    of SHAPENET_RAW_POINTS points in turn over the categories of
    SHAPENET_PARTS, on stretched ellipsoids with their normals, the part
    labels of the category by the signs of the coordinates (the CLI's
    NormalizeScale and GeodesicFPS(2048) run on them). Returns what it
    wrote."""
    del args
    raw = Path(root) / "raw"
    cats = list(SHAPENET_PARTS)
    names = []
    total = SHAPENET_TRAIN + SHAPENET_TEST
    clouds, normals = ellipsoid_clouds(rng, [SHAPENET_RAW_POINTS] * total)
    for i, (p, nrm) in enumerate(zip(clouds, normals)):
        cid = cats[i % len(cats)]
        first, count = SHAPENET_PARTS[cid]
        part = first + ((p[:, 0] > 0).astype(int) + 2 * (p[:, 1] > 0)) % count
        (raw / cid).mkdir(parents=True, exist_ok=True)
        np.savetxt(raw / cid / f"m{i:04d}.txt",
                   np.concatenate([p, nrm, part[:, None]], 1), fmt="%.6f")
        names.append(f"shape_data/{cid}/m{i:04d}")
    split_dir = raw / "train_test_split"
    split_dir.mkdir()
    n_val = SHAPENET_TRAIN // 4
    for split, sel in (("train", names[:SHAPENET_TRAIN - n_val]),
                       ("val", names[SHAPENET_TRAIN - n_val:SHAPENET_TRAIN]),
                       ("test", names[SHAPENET_TRAIN:])):
        with open(split_dir / f"shuffled_{split}_file_list.json", "w") as f:
            json.dump(sel, f)
    (raw / ".extracted").touch()
    return (f"{total} text clouds of {SHAPENET_RAW_POINTS} points with "
            f"normals over {len(cats)} categories")


def write_shapeseg(root, rng, args) -> str:
    """``raw/shapeseg.zip`` in the composite layout that
    ``ShapeSeg.process`` reads, with its fixed member counts (Adobe 41,
    FAUST 100, MIT 2 and SCAPE 71 training meshes, SHREC 18 test meshes):
    icospheres (162 vertices), stretched and rotated, as ASCII PLY (OBJ
    for MIT), labelled by the octant of the unrotated sphere (per-vertex
    ``.pt`` blobs, one shared by FAUST's and one by SCAPE's meshes; MIT's
    per-edge ``.eseg`` in MeshCNN's edge order, 1-based). The CLI's
    NormalizeArea, NormalizeAxes, SamplePoints(8192, labels) and
    GeodesicFPS(1024) run on them. Returns what it wrote."""
    import io
    import zipfile

    del args
    sphere, faces = _icosphere()
    octant = ((sphere[:, 0] > 0) + 2 * (sphere[:, 1] > 0)
              + 4 * (sphere[:, 2] > 0)).astype(np.int64)

    def mesh():
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        return (sphere * rng.uniform(0.5, 1.5, 3)) @ q

    def pt(arr):
        buf = io.BytesIO()
        torch.save(torch.as_tensor(arr), buf)
        return buf.getvalue()

    def inner(entries):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            for name, payload in entries:
                z.writestr(name, payload)
        return buf.getvalue()

    seen, edges = set(), []
    for a, b, c in faces:  # MeshCNN's edge order
        for e in ((a, b), (b, c), (a, c)):
            key = (min(e), max(e))
            if key not in seen:
                seen.add(key)
                edges.append(key)
    eseg = "\n".join(str(octant[a] + 1) for a, _ in edges) + "\n"
    adobe = [e for i in range(41) for e in (
        (f"meshes/{i}.ply", _ply_text(mesh(), faces)),
        (f"segs/{i}.pt", pt(octant)))]
    faust = [(f"meshes/tr_reg_{i:03d}.ply", _ply_text(mesh(), faces))
             for i in range(100)] + [("segs/faust_seg.pt", pt(octant))]
    mit = [e for name in ("crane0", "march10") for e in (
        (f"meshes/{name}.obj", _obj_text(mesh(), faces)),
        (f"segs/{name}.eseg", eseg))]
    scape = [(f"meshes/{i}.ply", _ply_text(mesh(), faces))
             for i in range(71)] + [("segs/scape_seg.pt", pt(octant))]
    shrec = [e for i in range(18) for e in (
        (f"meshes/{i}.ply", _ply_text(mesh(), faces)),
        (f"segs/{i}.pt", pt(octant)))]
    raw = Path(root) / "raw"
    raw.mkdir(parents=True)
    with zipfile.ZipFile(raw / "shapeseg.zip", "w") as z:
        for name, entries in (("Adobe/raw/adobe.zip", adobe),
                              ("FAUST/raw/faust.zip", faust),
                              ("MIT/raw/mit.zip", mit),
                              ("SCAPE/raw/scape.zip", scape),
                              ("SHREC/raw/shrec.zip", shrec)):
            z.writestr("ShapeSeg/" + name, inner(entries))
    return "the composite zip of 214 training and 18 test icosphere meshes"


def vote_shapenet_phase(args, base, ckpts, card):
    """``[vote-shapenet]``: ``test_shapenet.main`` on ``[fit-shapenet]``'s
    checkpoints with ``--num_votes`` VOTES, twice: the instance mIoU (and
    every category's IoU) the same across the calls and equal to
    ``evaluate_voting``'s on the restored weights (the same generator
    draws), the kernels launched; the host time of a call."""
    from deltaconv_tpu_torch import launch_counts, reset_launch_counts
    from deltaconv_tpu_torch.data import BatchLoader
    from deltaconv_tpu_torch.experiments import test_shapenet, train_shapenet
    from deltaconv_tpu_torch.training import (create_train_state,
                                              evaluate_voting, restore_any,
                                              sgd_momentum)

    argv = base + ["--checkpoint", str(ckpts), "--num_votes", str(VOTES)]
    results, times = [], []
    for _ in range(2):
        reset_launch_counts()
        t0 = time.perf_counter()
        _, scalars = test_shapenet.main(argv)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        results.append(scalars)
    counts = launch_counts()
    print("[vote-shapenet] checks")
    for name in ("gather_rows", "wls", "densify_bf16", "gather_max"):
        check(f"{name} launched", counts[name] > 0, f"{counts[name]}")
    check("two calls give the same scores", results[0] == results[1],
          f"{results[0]}")
    _, test_ds, num_classes = train_shapenet.build_datasets_and_classes(args)
    model = train_shapenet.shapenet_model(args, num_classes)
    target = restore_any(str(ckpts), create_train_state(
        model, sgd_momentum(0.1)), params_only=True)
    want, _ = evaluate_voting(model, target, BatchLoader(
        test_ds, args.batch_size, shuffle=False, drop_last=False),
        train_shapenet.augment, num_votes=VOTES, seed=args.seed)
    check("the CLI's mIoU is evaluate_voting's on the restored weights",
          results[0]["test mIoU"] == want,
          f"{results[0]['test mIoU']} and {want}")
    print(f"[vote-shapenet] {VOTES} votes on {len(test_ds)} test clouds "
          f"(B={args.batch_size}, N={args.num_points}): "
          f"{np.median(times) * 1e3:.1f} ms a call of the CLI's main "
          f"(host clock, synchronised; {[round(t * 1e3, 1) for t in times]}"
          f", the datasets from their cache and the checkpoint's restore "
          f"included); card: {card}", flush=True)
    return counts


def fit_shapeseg_phase(seed, dev, card):
    """``[fit-shapeseg]``: ``train_shapeseg.main`` on the card at the
    recipe's full width (8 classes, (128,) x 8, depth 1, embedding 512)
    and its defaults (B=8, N=1024, k=20, Adam lr 0.005 with StepLR, bf16
    dense operators under the f32 stack, exact kNN) on the archive
    :func:`write_shapeseg` writes: the datasets' builds timed, FIT_EPOCHS
    epochs (the archive's fixed member counts give 192 training clouds,
    24 steps an epoch) with a validation and a test pass each, the
    kernels launched, host ms a step beside one step's device time;
    every best validation epoch saves its state as step 0 of the run's
    checkpoints, which restores bit-equal (model, optimizer state, lr,
    step) to the state at the last best epoch, and the evaluate-only
    ``--checkpoint`` run of it repeats that epoch's test accuracy.
    Returns the fit's launch counts."""
    import copy
    import tempfile

    from deltaconv_tpu_torch import (launch_counts, reset_launch_counts,
                                     training)
    from deltaconv_tpu_torch.experiments import train_shapeseg as cli
    from deltaconv_tpu_torch.training import (make_train_step,
                                              restore_checkpoint)

    tag = "fit-shapeseg"
    rng = np.random.default_rng([seed, FIT_EPOCHS, len(tag)])
    tmp = tempfile.mkdtemp(prefix="fit-")
    save = training.save_checkpoint
    saved = []

    def recording_save(ckpt_dir, state, step=None):
        saved.append(copy.deepcopy(state))
        return save(ckpt_dir, state, step=step)

    try:
        root = Path(tmp) / "data"
        base = ["--data_root", str(root), "--seed", str(seed + 1)]
        args = cli.build_parser().parse_args(base)
        t0 = time.perf_counter()
        wrote = write_shapeseg(root, rng, args)
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_ds, val_ds, test_ds = cli.build_datasets(args)
        first = time.perf_counter() - t0
        print(f"[{tag}] fixture: {wrote}, written in {written:.2f} s; "
              f"{len(train_ds)} train, {len(val_ds)} validation and "
              f"{len(test_ds)} test clouds, built in {first:.2f} s (host "
              f"clock); {args.operator_dtype} operators, {args.knn_method} "
              f"kNN, k={args.k}, Adam lr {args.lr}, B={args.batch_size}, "
              f"N={args.num_points}; card: {card}", flush=True)
        times = []
        reset_launch_counts()
        training.save_checkpoint = recording_save
        with timed_fit_steps(times) as made:
            full, best = cli.main(base + ["--epochs", str(FIT_EPOCHS),
                                          "--logdir", f"{tmp}/full"])
        training.save_checkpoint = save
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"[{tag}] launches in {FIT_EPOCHS} epochs with their evals: "
              f"{ {n: c for n, c in counts.items() if c} }")
        for name in FIT_KERNELS:
            check(f"[{tag}] {name} launched", counts[name] > 0,
                  f"{counts[name]} launches")
        check(f"[{tag}] the edge sum's adjacency or gather_sum launched",
              counts["adjacency"] + counts["gather_sum"] > 0,
              f"adjacency {counts['adjacency']}, gather_sum "
              f"{counts['gather_sum']}")
        per_epoch = len(train_ds) // args.batch_size
        check(f"[{tag}] {len(times)} steps of {FIT_EPOCHS} epochs",
              full.step == len(times) == FIT_EPOCHS * per_epoch,
              f"state.step {full.step}, {per_epoch} steps an epoch")
        state, batch = made.step.last
        scratch = copy.deepcopy(state)
        step = make_train_step(scratch.model, smoothing=cli.RECIPE[
            "smoothing"], per_point=True)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dev_ms = device_ms(lambda: step(scratch, batch, gen))
        del scratch
        print(f"[{tag}] fit: median {np.median(times[1:]) * 1e3:.3f} ms a "
              f"step on the host clock (synchronised; {len(times)} steps, "
              f"the first {times[0] * 1e3:.1f} ms left out) against "
              f"{dev_ms:.3f} ms of device time a step; best {best}; card: "
              f"{card}", flush=True)

        (ckpts,) = list((Path(tmp) / "full" / "runs").glob(
            "*/*/checkpoints"))
        check(f"[{tag}] the best epochs saved step 0 only",
              sorted(p.name for p in ckpts.iterdir()) == ["step_0"]
              and len(saved) >= 1, f"{len(saved)} saves")
        target = copy.deepcopy(full)
        t0 = time.perf_counter()
        restore_checkpoint(str(ckpts), target, step=0)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        size = (ckpts / "step_0" / "checkpoint.pt").stat().st_size
        print(f"[{tag}] the best epoch's checkpoint: {size} bytes (model, "
              f"optimizer, scheduler, step), restored in {restore_ms:.2f} "
              f"ms (host clock, synchronised, a warm local disk); card: "
              f"{card}", flush=True)
        diff = _states_bit_equal(saved[-1], target)
        check(f"[{tag}] the best checkpoint restores the best epoch's state",
              diff == "", f"first difference: {diff or 'none'}")
        _, again = cli.main(base + ["--checkpoint", str(ckpts)])
        check(f"[{tag}] the evaluate-only run repeats the best test "
              f"accuracy", again["test accuracy"] == best["test accuracy"],
              f"{again['test accuracy']} and {best['test accuracy']}")
        return counts
    finally:
        training.save_checkpoint = save
        shutil.rmtree(tmp, ignore_errors=True)


def host_ms(fn, reps) -> float:
    """The median host ms of ``reps`` synchronised calls of ``fn`` after
    one (for calls long enough that the launch cost is noise)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _height_field(rng, n):
    """One cloud ``[n, 3]`` on a random quadratic height field over
    [-1, 1]^2 with its analytic frames and heights (the de Rham fixture
    of ``tests/geometry/test_grad_div.py``): ``(pos, normal, x_basis,
    y_basis, f)`` f32 numpy."""
    uv = (rng.random((n, 2)) * 2 - 1).astype(np.float32)
    c = rng.random(6).astype(np.float32)
    u, v = uv[:, 0], uv[:, 1]
    f = (c[0] + c[1] * u + c[2] * v + c[3] * u * u + c[4] * u * v
         + c[5] * v * v)[:, None]
    dfdx = np.stack([np.ones_like(u), np.zeros_like(u),
                     c[1] + 2 * c[3] * u + c[4] * v], 1)
    dfdy = np.stack([np.zeros_like(u), np.ones_like(u),
                     c[2] + c[4] * u + 2 * c[5] * v], 1)
    normal = np.cross(dfdx, dfdy)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    x_basis = dfdx / np.linalg.norm(dfdx, axis=1, keepdims=True)
    y_basis = np.cross(normal, x_basis)
    return tuple(a.astype(np.float32) for a in (
        np.concatenate([uv, f], 1), normal, x_basis, y_basis, f))


def _derham_rules(gd, pos, nrm, x_an, y_an, f):
    """The values of ``tests/geometry/test_grad_div.py``'s de Rham checks
    on the operators ``gd`` (anything with ``grad`` and ``div``) of one
    height-field cloud with its analytic frames ``x_an, y_an`` and
    heights ``f``; each rule holds when its value is within DERHAM_TOL."""
    from deltaconv_tpu_torch.geometry import J, curl, laplacian

    ones = torch.ones((pos.shape[0], 1), dtype=pos.dtype, device=pos.device)
    gx = gd.grad(pos[:, :1])
    gf = gd.grad(f)
    mc = laplacian(pos, gd)
    sq = (curl(gx, gd).square(), gd.div(J(gx)).square())
    return {
        "max |grad 1|": float(gd.grad(ones).abs().max()),
        "mean |lap 1|": float(laplacian(ones, gd).abs().mean()),
        "curl grad x": float(max(sq[0].mean(), sq[0].median())),
        "div J grad x": float(max(sq[1].mean(), sq[1].median())),
        "grad f - the frames' z": float(torch.maximum(
            (gf[:, 0, 0] - x_an[:, 2]).abs().max(),
            (gf[:, 1, 0] - y_an[:, 2]).abs().max())),
        "lap pos off -normal": float(
            (-(mc * nrm).sum(1) - mc.norm(dim=1)).abs().max())}


class _GatheredApplies:
    """``grad``/``div`` of a :class:`GradDiv`'s coefficients as gathers and
    einsums in their own dtype (the f64 torch math's operators, which no
    kernel applies)."""

    def __init__(self, gd):
        self.gd, self.idx = gd, gd.nbr_idx.long()

    def grad(self, x):
        return torch.einsum("nkd,nkc->ndc", self.gd.grad_coef, x[self.idx])

    def div(self, v):
        return torch.einsum("nkd,nkdc->nc", self.gd.div_coef, v[self.idx])


def _derham_phase(pos, nrm, x_an, y_an, f, idx, mask, n, k, first, card):
    """The de Rham checks at one shape, on three builds of the operators
    (regularizer 1e-8, unnormalized): the kernels' (``build_grad_div``),
    the torch math's in f32 and in f64 (``_tables_math``). The kernels'
    coefficients lie at most DERHAM_F32_RATIO times as far from the f64
    math's as the f32 math's do (relative Frobenius distance); the
    kernels' operators pass every rule the f32 math's pass, and at the
    ``first`` shape every rule. Where the f32 math fails a rule the line
    says whether the f64 math fails it too (the fixture: a rule that
    does not hold on this cloud at all) or not (f32 rounding of the
    fit)."""
    from deltaconv_tpu_torch.geometry import build_grad_div
    from deltaconv_tpu_torch.geometry import grad_div as gdm

    kw = {"regularizer": 1e-8, "normalized": False}
    kern = build_grad_div(pos, nrm, x_an, y_an, idx, mask, **kw)
    m32 = gdm._tables_math(pos, x_an, y_an, pos, nrm, x_an, y_an, idx, mask,
                           **kw)
    p64, n64, x64, y64, f64 = (a.double() for a in (pos, nrm, x_an, y_an, f))
    m64 = gdm._tables_math(p64, x64, y64, p64, n64, x64, y64, idx, mask,
                           **kw)
    dist = {}
    for name, gd in (("kernels", kern), ("f32 math", m32)):
        dist[name] = max(float((a.double() - b).norm() / b.norm()) for a, b in
                         ((gd.grad_coef, m64.grad_coef),
                          (gd.div_coef, m64.div_coef)))
    rules = {"kernels": _derham_rules(kern, pos, nrm, x_an, y_an, f),
             "f32 math": _derham_rules(m32, pos, nrm, x_an, y_an, f),
             "f64 math": _derham_rules(_GatheredApplies(m64), p64, n64, x64,
                                       y64, f64)}
    ok = {side: {r: v <= DERHAM_TOL for r, v in vals.items()}
          for side, vals in rules.items()}
    held = [r for r in ok["kernels"]
            if ok["kernels"][r] or not (first or ok["f32 math"][r])]
    edge = float((pos[idx[:, 1:].long()] - pos[:, None]).norm(dim=-1).mean())
    check(f"[geometry-single] N={n}, K={k}: de Rham on the kernels' "
          f"operators" + (", every rule" if first else ", every rule the "
                          "f32 torch math's pass"),
          len(held) == len(ok["kernels"])
          and dist["kernels"] <= DERHAM_F32_RATIO * dist["f32 math"],
          "; ".join(
              f"{r}: kernels {rules['kernels'][r]:.3g}, f32 math "
              f"{rules['f32 math'][r]:.3g}, f64 math {rules['f64 math'][r]:.3g}"
              + ("" if ok["f32 math"][r] else
                 " (> the bound in f64 too: the fixture)" if not
                 ok["f64 math"][r] else " (f32 rounding: f64 holds)")
              for r in rules["kernels"])
          + f" (bound {DERHAM_TOL}); coefficients' distance from the f64 "
          f"math: kernels {dist['kernels']:.3g} <= {DERHAM_F32_RATIO} x f32 "
          f"math {dist['f32 math']:.3g}; mean edge length {edge:.4g}; card: "
          f"{card}")


def geometry_single_phase(seed, dev, card):
    """``[geometry-single]``: the single-cloud geometry on the card. At
    one cloud of N points and K neighbours for each (N, K) of GEO_SHAPES
    (a quadratic height field with its analytic frames):
    ``geometry.build_grad_div`` through its kernels (``gather_rows`` and
    ``wls`` once each a build) against the torch math on the same
    tensors (``_tables_math``), ``normalized`` True and False, the same
    indices and coefficients within GEO_COEF_REL x max|coef|, both timed;
    the de Rham checks of ``tests/geometry/test_grad_div.py`` on the
    kernels' operators beside the torch math's in f32 and f64
    (:func:`_derham_phase`); ``DeltaConv``
    (eval and train, f32 and bf16) on the operators of the cloud
    (``build_operators`` on ``[N, 3]``) bit-equal to the batched call at
    B=1. Then ``geometry.knn_tiled`` of one TILED_N-point cloud against
    the exact body of ``knn_topk`` (``quantized=False``): each row's ids
    the same as sets, or, on the rows where they part, the same sorted
    squared distances (in f64) within TIE_ULPS f32 ulps of the scores'
    scale, 2 max|p|^2 (near-ties: the two round ``|q|^2 + |p|^2 - 2 q.p``
    their own ways); both timed, and the tile's selection both ways
    (``top_k``'s stable sort and its int64 ``select``), the same ids.
    Returns the phase's launch counts."""
    from collections import Counter

    from deltaconv_tpu_torch import launch_counts, ops, reset_launch_counts
    from deltaconv_tpu_torch.geometry import (build_grad_div,
                                              build_tangent_basis, knn,
                                              knn_tiled)
    from deltaconv_tpu_torch.geometry import grad_div as gdm
    from deltaconv_tpu_torch.geometry.knn import squared_norms, top_k
    from deltaconv_tpu_torch.models import build_operators
    from deltaconv_tpu_torch.nn import DeltaConv

    rng = np.random.default_rng([seed, GEO_TAG])
    total = Counter()

    def t(a):
        return torch.from_numpy(a).to(dev)

    for n, k in GEO_SHAPES:
        pos, nrm, x_an, y_an, f = (t(a) for a in _height_field(rng, n))
        xb, yb = build_tangent_basis(nrm)
        idx, mask = knn(pos, k)
        for normalized in (True, False):
            reset_launch_counts()
            got = build_grad_div(pos, nrm, xb, yb, idx, mask,
                                 normalized=normalized)
            torch.cuda.synchronize()
            counts = launch_counts()
            total.update(counts)
            want = gdm._tables_math(pos, xb, yb, pos, nrm, xb, yb, idx, mask,
                                    normalized=normalized)
            errs = [float((a - b).abs().max() / b.abs().max()) for a, b in (
                (got.grad_coef, want.grad_coef),
                (got.div_coef, want.div_coef))]
            ms = median_ms(lambda: build_grad_div(
                pos, nrm, xb, yb, idx, mask, normalized=normalized),
                reps=GEO_REPS)
            math_ms = median_ms(lambda: gdm._tables_math(
                pos, xb, yb, pos, nrm, xb, yb, idx, mask,
                normalized=normalized), reps=GEO_REPS)
            check(f"[geometry-single] N={n}, K={k}, normalized "
                  f"{normalized}: the kernels' build against the torch math",
                  counts["gather_rows"] == 1 and counts["wls"] == 1
                  and got.single and torch.equal(got.nbr_idx, want.nbr_idx)
                  and torch.equal(got.nbr_mask, want.nbr_mask)
                  and max(errs) <= GEO_COEF_REL,
                  f"gather_rows {counts['gather_rows']}, wls "
                  f"{counts['wls']} launches; max |diff| / max|coef| grad "
                  f"{errs[0]:.3g}, div {errs[1]:.3g} <= {GEO_COEF_REL}; "
                  f"{ms:.4f} ms a build against the torch math's "
                  f"{math_ms:.4f} (CUDA events); card: {card}")

        _derham_phase(pos, nrm, x_an, y_an, f, idx, mask, n, k,
                      (n, k) == GEO_SHAPES[0], card)

        bad = []
        for dtype in (None, torch.bfloat16):
            single = build_operators(pos, k, nrm, operator_dtype=dtype)
            batch = single.batched()
            for train in (False, True):
                x = torch.randn((n, 3), device=dev)
                v = single.grad(x)
                outs = []
                for g, xx, vv in ((single, x, v), (batch, x[None], v[None])):
                    torch.manual_seed(seed)
                    conv = DeltaConv(3, 64, centralized=True,
                                     dtype=dtype).to(dev)
                    conv.train(train)
                    with torch.no_grad():
                        outs.append(conv(xx, vv, g))
                (xs, vs), (xb1, vb1) = outs
                if not (raw_equal(xs, xb1[0]) and raw_equal(vs, vb1[0])):
                    bad.append(f"{dtype} train={train}")
        check(f"[geometry-single] N={n}, K={k}: DeltaConv of one cloud "
              f"bit-equal to the batch of one", not bad,
              f"differ: {bad or 'none'}")

    pos = t(_height_field(rng, TILED_N)[0])
    reset_launch_counts()
    ids, tmask = knn_tiled(pos, TILED_K, tile=TILED_TILE)
    want = ops.knn_topk(pos[None], TILED_K, quantized=False)[0]
    torch.cuda.synchronize()
    total.update(launch_counts())
    same = torch.equal(torch.sort(ids, 1).values, torch.sort(want, 1).values)
    rows = (torch.sort(ids, 1).values != torch.sort(want, 1).values).any(1)
    p = pos.double()
    d_got, d_want = (torch.sort((p[i[rows].long()] - p[rows][:, None]).square(
    ).sum(-1), 1).values for i in (ids, want))
    tol = TIE_ULPS * 2.0 ** -23 * 2 * float(p.square().sum(1).max())
    ties = bool(((d_got - d_want).abs() <= tol).all())
    tiled_ms, topk_ms = (host_ms(fn, TILED_REPS) for fn in (
        lambda: knn_tiled(pos, TILED_K, tile=TILED_TILE),
        lambda: ops.knn_topk(pos[None], TILED_K, quantized=False)))
    check(f"[geometry-single] knn_tiled at N={TILED_N}, K={TILED_K}, tiles "
          f"of {TILED_TILE} against knn_topk's exact body",
          bool(tmask.all()) and (same or ties),
          f"{int(rows.sum())} of {TILED_N} rows part as sets, all at "
          f"near-ties (squared distances within {tol:.3g}): {ties}; knn_tiled {tiled_ms:.3f} ms, knn_topk (exact) "
          f"{topk_ms:.3f} ms (host clock, synchronised, median of "
          f"{TILED_REPS} after one); card: {card}")

    sq = squared_norms(pos)
    neg = -(sq[:TILED_TILE, None] + sq[None, :]
            - 2.0 * torch.matmul(pos[:TILED_TILE], pos.T))
    sel = [top_k(neg, TILED_K, select=s)[1] for s in (False, True)]
    sort_ms, select_ms = (median_ms(
        lambda s=s: top_k(neg, TILED_K, select=s), reps=GEO_REPS)
        for s in (False, True))
    check(f"[geometry-single] one tile's selection, {TILED_TILE} x "
          f"{TILED_N} scores, top {TILED_K}: top_k's int64 select against "
          f"its stable sort", torch.equal(*sel),
          f"the same ids; sort {sort_ms:.3f} ms, select {select_ms:.3f} ms "
          f"(CUDA events); card: {card}")
    return total


# -- training across ranks -------------------------------------------------------

# JAX's own data-parallel bounds (tests/training/test_parallel.py): the
# loss to rtol 1e-5, parameters and running statistics to atol 1e-5 +
# rtol 1e-4; tests/test_torch_train.py's for the sharded f32 step against
# the unsharded one: parameters 1e-3 and statistics 1e-4 x the tensor's
# max.
DP_LOSS_RTOL, DP_ATOL, DP_RTOL = 1e-5, 1e-5, 1e-4
# A bf16 step's loss against another order of its sums: a quarter of a
# bf16 ulp.
DP_BF16_LOSS_RTOL = 1e-3
SHARD_PARAM_REL, SHARD_STATS_REL = 1e-3, 1e-4
RANKS = 2  # processes sharing the one card over gloo
RANKS_TIMEOUT = 600  # s: the spawned ranks' whole job
RANK_REPS = 3  # timed steps a rank
SHARD_TRAIN_LR = 0.01  # bench.py's point_shard_train_points_per_sec
DP_CONFIGS = {"f32": {}, "bf16": dict(knn_method="approx",
                                      precision="bfloat16")}
# The 2-rank runs against one process (held_update): the parameters' (and
# the running statistics') distance from the one-process run over that
# run's own move, ||got - want|| / ||want - start||. A control is the
# one-process run on the same inputs in another order along the split
# axis (the batch's clouds, or one cloud's points), every dropout mask
# permuted with them and the graph unchanged: the same function with its
# sums in another order. The distance is held within UPDATE_REL, or
# CONTROL_FACTOR times the largest of CONTROLS controls where that is
# larger, and never above UPDATE_CAP: a gradient scaled by 3/4 or 5/4 or
# worse (a pmean left out or done twice, a rank's rows dropped from a
# sum) moves the parameters at least that far from the one-process step.
UPDATE_REL = 1e-2
CONTROL_FACTOR = 2.0
UPDATE_CAP = 0.25
CONTROLS = 3


@contextlib.contextmanager
def nccl_group():
    """A 1-rank ``nccl`` group on a FileStore in a temporary directory (no
    network), destroyed on exit."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def permuted_masks(perm, dim):
    """Every train-mode ``Dropout`` of a one-process step draws its mask
    as the port's does, then takes it in the order ``perm`` along ``dim``
    (0: the batch's clouds, 1: one cloud's points), so a step on inputs
    permuted by ``perm`` along that axis drops each cloud's (point's)
    entries as the step on the inputs in their own order does."""
    from deltaconv_tpu_torch.nn import dropout

    forward = dropout.Dropout.forward

    def permuted(self, x, generator=None, full_shape=None, offset=0):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        keep = keep.index_select(dim, perm)
        return torch.where(keep, x / keep_prob, 0.0)

    dropout.Dropout.forward = permuted
    try:
        yield
    finally:
        dropout.Dropout.forward = forward


def state_bits(model) -> dict:
    """The model's ``state_dict`` on the host."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def bits_equal_states(a: dict, b: dict) -> str:
    """'' when two ``state_bits`` hold the same bits, else the first key
    that differs."""
    for key, value in a.items():
        if not raw_equal(value, b[key]):
            return key
    return ""


def _kind(key):
    return "stat" if ".running_" in key else "param"


def update_dist(got: dict, want: dict, start: dict) -> dict:
    """``||got - want|| / ||want - start||`` over the parameters and over
    the running statistics (``{"param": .., "stat": ..}``)."""
    num, den = {"param": 0.0, "stat": 0.0}, {"param": 0.0, "stat": 0.0}
    for key, w in want.items():
        if not w.is_floating_point():
            continue
        num[_kind(key)] += float(((got[key] - w).double() ** 2).sum())
        den[_kind(key)] += float(((w - start[key]).double() ** 2).sum())
    return {k: (num[k] / max(den[k], 1e-300)) ** 0.5 for k in num}


def largest_tensors(got: dict, want: dict, start: dict, count=4) -> str:
    """The parameter tensors that hold most of ``||got - want||^2``: each
    with its share of it and its own distance over its own move."""
    rows, total = [], 0.0
    for key, w in want.items():
        if not w.is_floating_point() or _kind(key) == "stat":
            continue
        d = float(((got[key] - w).double() ** 2).sum())
        m = float(((w - start[key]).double() ** 2).sum())
        total += d
        rows.append((d, key, (d / max(m, 1e-300)) ** 0.5))
    rows.sort(reverse=True)
    return "; ".join(f"{key} {d / max(total, 1e-300):.1%} of it ({own:.3e} "
                     f"of its move)" for d, key, own in rows[:count])


def jax_bounds_beyond(got: dict, want: dict) -> str:
    """How ``got`` stands to JAX's data-parallel bounds (atol 1e-5 + rtol
    1e-4) of ``want``: the entries beyond them and the worst excess."""
    worst, where, beyond, total = -np.inf, "", 0, 0
    for key, w in want.items():
        if not w.is_floating_point():
            continue
        excess = ((got[key].float() - w.float()).abs()
                  - (DP_ATOL + DP_RTOL * w.float().abs()))
        beyond += int((excess > 0).sum())
        total += excess.numel()
        if float(excess.max()) > worst:
            worst, where = float(excess.max()), key
    return (f"{beyond} of {total} entries beyond JAX's data-parallel bounds, "
            f"worst excess {worst:.3e} ({where})")


def held_update(label, got: dict, want: dict, start: dict, controls):
    """``got`` (a 2-rank run's state bits) against ``want`` (one
    process's from the same ``start``): the parameters' and the running
    statistics' distance (:func:`update_dist`) within UPDATE_REL, or
    CONTROL_FACTOR times the largest of ``controls``' (the one-process
    run with its sums in another order) where that is larger, and within
    UPDATE_CAP; then the tensors that hold most of the distance and the
    entries beyond JAX's data-parallel bounds (a reading)."""
    dist = update_dist(got, want, start)
    for kind in ("param", "stat"):
        ctrl = max(update_dist(c, want, start)[kind] for c in controls)
        bound = min(UPDATE_CAP, max(UPDATE_REL, CONTROL_FACTOR * ctrl))
        check(f"{label}: {kind}s", dist[kind] <= bound,
              f"{dist[kind]:.3e} of the one-process move <= {bound:.3e} "
              f"(the {len(controls)} one-process runs in another order: up "
              f"to {ctrl:.3e})")
    print(f"  {label}: most of the distance in "
          f"{largest_tensors(got, want, start)}", flush=True)
    print(f"  {label}: {jax_bounds_beyond(got, want)}", flush=True)


def held_loss(label, got: float, want: float, controls, rtol):
    """A 2-rank run's loss against one process's: within ``rtol``, or
    CONTROL_FACTOR times the controls' largest distance where that is
    larger."""
    spread = max(abs(c - want) for c in controls)
    bound = max(rtol * abs(want), CONTROL_FACTOR * spread)
    check(label, abs(got - want) <= bound,
          f"{got} vs {want}, |diff| {abs(got - want):.3e} <= {bound:.3e} "
          f"(rtol {rtol:g}, or twice the {len(controls)} one-process runs "
          f"in another order: up to {spread:.3e})")


def held_rel(label, got: dict, want: dict):
    """Parameters within 1e-3 and running statistics within 1e-4 x each
    tensor's max of ``want`` (tests/test_torch_train.py's bounds)."""
    worst = {"param": (0.0, ""), "stat": (0.0, "")}
    for key, w in want.items():
        if not w.is_floating_point():
            continue
        rel = float((got[key] - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)
        worst[_kind(key)] = max(worst[_kind(key)], (rel, key))
    for kind, tol in (("param", SHARD_PARAM_REL), ("stat", SHARD_STATS_REL)):
        rel, key = worst[kind]
        check(f"{label}: {kind}s", rel <= tol,
              f"worst {rel:.3e} x max ({key}) <= {tol}")


def launches_a_step(run) -> dict:
    """The launch counts of one call of ``run`` (the mean of RANK_REPS
    calls, counted from 0)."""
    from deltaconv_tpu_torch import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(RANK_REPS):
        run()
    torch.cuda.synchronize()
    return {k: v / RANK_REPS for k, v in launch_counts().items() if v}


def dp_model(seed, dev, config):
    """The reference ModelNet40 classifier (dropout 0.5) of
    ``[dp-step]``, seeded weights; ``config``: ``DP_CONFIGS``'."""
    return random_model(seed, dev, affine=False, **config)


def dp_step(model, group):
    """``(state, step)``: the reference recipe's SGD (lr 0.1, momentum
    0.9, weight decay 1e-4, smoothing 0.2), data-parallel over ``group``
    through ``shard_train_step`` (None: one process)."""
    from deltaconv_tpu_torch.parallel import shard_train_step
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    state = create_train_state(model, sgd_momentum(TRAIN_LR, 0.9, 1e-4),
                               device=next(model.parameters()).device)
    return state, shard_train_step(make_train_step(model, smoothing=0.2,
                                                   group=group))


def step_times(step, state, batch, gen):
    """``(device ms, host ms)`` of one step: the profiler's device time
    over RANK_REPS steps, and the median host clock of RANK_REPS
    synchronised steps."""
    return (device_ms(lambda: step(state, batch, gen), RANK_REPS),
            host_ms(lambda: step(state, batch, gen), RANK_REPS))


def rank_dp_case(group, case, dev):
    """A spawned rank's ``[dp-step]`` case: one step of the global batch's
    rows it holds (compared), its launches a step (counted from 0 over
    RANK_REPS steps), then its timed steps."""
    model = dp_model(case["seed"], dev, case["config"])
    state, step = dp_step(model, group)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in case["batch"].items()}
    gen = torch.Generator(device=dev).manual_seed(case["seed"])
    loss = float(step(state, batch, gen)["loss"])
    bits = state_bits(model)
    counts = launches_a_step(lambda: step(state, batch, gen))
    return loss, bits, step_times(step, state, batch, gen), counts


def shard_seg_model(seed, dev):
    """The ShapeNet recipe in coefficient form, f32, exact kNN, dropout
    0.5 (the recipe's)."""
    return random_seg_model(seed, dev, "exact", dense_operators=False)


def shard_seg_case(seed, dev, group, case, perm=None, timed=True):
    """``(loss, state bits, host ms, launches a step)``: one point-sharded
    segmentation step (:func:`shard_seg_model`, lr SEG_LR) of this rank's
    rows of ``case``'s cloud (``group=None``: the whole cloud in one
    process; ``perm``: its points in that order, the dropout masks
    permuted with them), then (``timed``) its launches a step and host
    ms (else None for both)."""
    from deltaconv_tpu_torch.parallel import (pad_cloud,
                                              point_sharded_train_step,
                                              shard_rows)
    from deltaconv_tpu_torch.training import create_train_state, sgd_momentum

    model = shard_seg_model(seed, dev)
    state = create_train_state(model, sgd_momentum(SEG_LR), device=dev)
    step = point_sharded_train_step(model, group, per_point=True)
    order = slice(None) if perm is None else perm
    pos, nrm, mask = pad_cloud(
        torch.from_numpy(case["pos"][order]).to(dev), RANKS,
        torch.from_numpy(case["normal"][order]).to(dev))
    rows = [shard_rows(t, group) for t in (
        pos, nrm, torch.from_numpy(case["label"][order]).to(dev), mask)]
    cat = torch.zeros(16, device=dev)
    cat[case["category"]] = 1.0
    gen = torch.Generator(device=dev).manual_seed(seed)

    def once():
        return step(state, rows[0], rows[1], rows[2], gen,
                    point_mask=rows[3], category=cat)

    masks = (contextlib.nullcontext() if perm is None else permuted_masks(
        torch.from_numpy(perm).to(dev), 1))
    with masks:
        loss = float(once()["loss"])
    bits = state_bits(model)
    if not timed:
        return loss, bits, None, None
    return loss, bits, host_ms(once, RANK_REPS), launches_a_step(once)


def rank_fit_case(group, case, dev):
    """A spawned rank's ``[fit-dp]``: ``train_modelnet.main`` for
    FIT_EPOCHS epochs, then 1 epoch and ``--resume`` to FIT_EPOCHS, each
    under the group; the checkpoint writes this rank made."""
    from deltaconv_tpu_torch.experiments import train_modelnet
    from deltaconv_tpu_torch.training import loop

    writes = []
    save = loop.save_checkpoint

    def counted(ckpt_dir, state, step=None):
        writes.append(step)
        return save(ckpt_dir, state, step)

    loop.save_checkpoint = counted
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            full, _ = train_modelnet.main(
                case["argv"] + ["--epochs", str(FIT_EPOCHS), "--logdir",
                                case["logs"] + "/full"])
            train_modelnet.main(case["argv"] + [
                "--epochs", "1", "--logdir", case["logs"] + "/part"])
            runs = sorted(Path(case["logs"], "part", "runs").glob("*/*"))
            resumed, _ = train_modelnet.main(
                case["argv"] + ["--epochs", str(FIT_EPOCHS), "--logdir",
                                case["logs"] + "/part", "--resume",
                                str(runs[-1])])
    finally:
        loop.save_checkpoint = save
    return {"full": state_bits(full.model),
            "resumed": state_bits(resumed.model), "writes": writes,
            "step": full.step}


def ranks_job(group, job):
    """The spawned ranks' job: every case of ``[dp-step]`` (b),
    ``[shard-train]``'s segmentation and ``[fit-dp]`` on the parent's
    card (``job["device"]``)."""
    dev = torch.device(job["device"])
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, case in job["cases"].items():
        if name.startswith("dp-"):
            out[name] = rank_dp_case(group, case, dev)
        elif name == "shard-seg":
            out[name] = shard_seg_case(case["seed"], dev, group, case)
        else:
            out[name] = rank_fit_case(group, case, dev)
    return out


def dp_step_nccl(seed, dev, card, batch, config, tag):
    """``[dp-step]`` (a): ``shard_train_step`` on a 1-rank ``nccl`` group
    against ``make_train_step``, 2 steps from the same weights with the
    same generator: losses and every parameter and statistic bit-equal.
    A group of one rank is None in the port, so this runs the one-process
    step twice: it shows the step deterministic and the 1-rank group
    accepted, and no NCCL collective runs (one card holds one NCCL
    rank). Returns ``{"loss", "bits", "times", "start", "controls"}``:
    the one-process step's loss and state bits after one step, its
    (device ms, host ms) a step, the weights it started from, and the
    losses and bits of CONTROLS one-process steps on the batch's clouds
    in another order, each dropout mask permuted with them (the
    controls of :func:`held_update`)."""
    controls = []
    for i in range(CONTROLS):
        perm = torch.from_numpy(np.random.default_rng([seed, 29, i])
                                .permutation(B)).to(dev)
        model = dp_model(seed, dev, config)
        start = state_bits(model)
        state, step = dp_step(model, None)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with permuted_masks(perm, 0):
            loss = float(step(state, {k: v[perm] for k, v in batch.items()},
                              gen)["loss"])
        controls.append((loss, state_bits(model)))
        del model, state, step
    out = {}
    for label, grouped in (("one process", False), ("nccl", True)):
        model = dp_model(seed, dev, config)
        ctx = nccl_group() if grouped else contextlib.nullcontext()
        with ctx as group:
            state, step = dp_step(model, group)
            gen = torch.Generator(device=dev).manual_seed(seed)
            losses = [float(step(state, batch, gen)["loss"])]
            first = state_bits(model)
            losses.append(float(step(state, batch, gen)["loss"]))
            out[label] = losses, state_bits(model)
            if not grouped:
                one = {"loss": losses[0], "bits": first, "start": start,
                       "controls": controls,
                       "times": step_times(step, state, batch, gen)}
    (la, sa), (lb, sb) = out["one process"], out["nccl"]
    check(f"[dp-step] {tag}: shard_train_step on a 1-rank nccl group vs "
          f"make_train_step, 2 steps (the one-process step twice)",
          la == lb and bits_equal_states(sa, sb) == "", f"losses {la} vs "
          f"{lb}; first differing tensor: {bits_equal_states(sa, sb) or 'none'}")
    return one


def shard_train_nccl(seed, dev, card, cloud, normal, label):
    """``[shard-train]`` on a 1-rank ``nccl`` group at the bench config
    (ONE 65,536-point cloud, reference width, coefficient operators,
    bf16, approximate kNN, SGD 0.01, dropout 0.5): two calls from the
    same state bit-equal; the f32 form held to the unsharded f32 step
    on the same one-cloud batch and the same graph (the sharded build's
    operators, with their gather plan, passed as ``operators``); the
    launches, device ms, host ms, points/s and peak memory of a bf16
    step on one rank (the group of one rank is None: the sharded
    operators and their gathers' backward run, no collective). Returns
    its launch counts a step."""
    import dataclasses

    from deltaconv_tpu_torch import KERNEL_OPS
    from deltaconv_tpu_torch.parallel import (point_sharded_operators,
                                              point_sharded_train_step)
    from deltaconv_tpu_torch.training import (create_train_state,
                                              sgd_momentum,
                                              smooth_cross_entropy)

    pos = torch.from_numpy(cloud).to(dev)
    nrm = torch.from_numpy(normal).to(dev)
    lab = torch.tensor(label, device=dev)

    def sharded(precision, group):
        model = shard_model(seed, dev, precision, "approx")
        state = create_train_state(model, sgd_momentum(SHARD_TRAIN_LR),
                                   device=dev)
        step = point_sharded_train_step(model, group)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return model, state, lambda: step(state, pos, nrm, lab, gen)

    with nccl_group() as group:
        runs = []
        for _ in range(2):
            model, _, once = sharded("bfloat16", group)
            runs.append((float(once()["loss"]), state_bits(model)))
        (la, sa), (lb, sb) = runs
        check("[shard-train] bf16: two calls from the same state",
              la == lb and bits_equal_states(sa, sb) == "",
              f"losses {la} vs {lb}; first differing tensor: "
              f"{bits_equal_states(sa, sb) or 'none'}")
        model, state, once = sharded("bfloat16", group)
        once()
        counts = launches_a_step(once)
        torch.cuda.reset_peak_memory_stats()
        host = host_ms(once, RANK_REPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dev_ms = device_ms(once, RANK_REPS)
        print(f"[shard-train] bf16, one cloud of N={SHARD_N} on one rank: "
              f"launches per point-sharded step: {counts}; device "
              f"{dev_ms:.3f} ms, host {host:.3f} ms a step, "
              f"{SHARD_N / host * 1e3:.0f} points/s, peak {peak:.3f} GiB; "
              f"card: {card}", flush=True)
        for name in ("knn_topk_bucketed_q", "gather_rows",
                     "inverse_adjacency", "scatter_rows", "wls"):
            check(f"[shard-train] {name} launched", counts.get(name, 0) > 0,
                  f"{counts.get(name, 0)} a step")
        del model, state, once
        torch.cuda.empty_cache()

        model, _, once = sharded(None, group)
        loss_s = float(once()["loss"])
        got = state_bits(model)
    del model
    # The unsharded f32 step on the same graph and operators.
    model = shard_model(seed, dev, None, "approx")
    state = create_train_state(model, sgd_momentum(SHARD_TRAIN_LR),
                               device=dev)
    with torch.no_grad():
        gd = point_sharded_operators(pos, K, nrm, knn_method="approx")
        gd = dataclasses.replace(gd, plan=KERNEL_OPS.coef_plan(
            pos[None], gd.nbr_idx, None))
    model.train()
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = model(pos[None], nrm[None], generator=gen, operators=gd)
    loss_u = smooth_cross_entropy(logits, lab.reshape(1), 0.2)
    state.optimizer.zero_grad(set_to_none=True)
    loss_u.backward()
    state.optimizer.step()
    state.scheduler.step()
    loss_u = float(loss_u.detach())
    check("[shard-train] f32 sharded vs unsharded step: loss",
          abs(loss_s - loss_u) <= DP_LOSS_RTOL * abs(loss_u),
          f"{loss_s} vs {loss_u}")
    held_rel("[shard-train] f32 sharded vs unsharded step", got,
             state_bits(model))
    return counts


class _Reordered:
    """A dataset whose clouds' points come in another order (a fixed
    permutation of each cloud, from ``seed`` and its index)."""

    def __init__(self, dataset, seed):
        self.dataset, self.seed = dataset, seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        c = self.dataset[i]
        perm = np.random.default_rng([*self.seed, i]).permutation(len(c.pos))
        return dataclasses.replace(c, pos=c.pos[perm], normal=c.normal[perm])


@contextlib.contextmanager
def reordered_points(cli, seed):
    """``cli.build_datasets`` giving :class:`_Reordered` datasets."""
    build = cli.build_datasets
    cli.build_datasets = lambda args: tuple(
        _Reordered(d, seed) for d in build(args))
    try:
        yield
    finally:
        cli.build_datasets = build


def ranks_phases(seed, dev, card):
    """``[dp-step]``, ``[shard-train]`` and ``[fit-dp]``: training across
    ranks, on a 1-rank ``nccl`` group and on RANKS processes sharing the
    card over ``gloo`` (``parallel.launch.run_ranks``, one spawn for every
    multi-process case). Returns the launch counts a step of each gloo
    rank's data-parallel steps (f32, bf16) and point-sharded segmentation
    step, and of the one-rank point-sharded bf16 step, by tag."""
    import tempfile

    from deltaconv_tpu_torch.experiments import train_modelnet
    from deltaconv_tpu_torch.experiments.common import finish_args
    from deltaconv_tpu_torch.parallel.launch import run_ranks

    rng = np.random.default_rng([seed, 28])
    cpu = train_batch(rng, "cpu", [N] * B)
    batch = {k: v.to(dev) for k, v in cpu.items()}
    job, ones, counts = {}, {}, {}
    for tag, config in DP_CONFIGS.items():
        ones[tag] = dp_step_nccl(seed, dev, card, batch, config, tag)
        job[f"dp-{tag}"] = dict(seed=seed, config=config, batch={
            k: v.numpy() for k, v in cpu.items()})

    (cloud,), (normal,) = ellipsoid_clouds(rng, [SHARD_N])
    counts["shard-train"] = shard_train_nccl(
        seed, dev, card, cloud, normal, int(rng.integers(0, NUM_CLASSES)))
    (seg_cloud,), (seg_normal,) = ellipsoid_clouds(rng, [SHARD_SEG_N])
    job["shard-seg"] = dict(
        seed=seed, pos=seg_cloud, normal=seg_normal,
        label=rng.integers(0, SEG_CLASSES, SHARD_SEG_N),
        category=int(rng.integers(0, 16)))

    tmp = tempfile.mkdtemp(prefix="fit-dp-")
    try:
        root = Path(tmp) / "data"
        argv = ["--data_root", str(root), "--seed", str(seed + 1)]
        args = train_modelnet.build_parser().parse_args(
            argv + ["--no_data_parallel"])
        write_modelnet(root, np.random.default_rng([seed, 28, 1]), args)
        t0 = time.perf_counter()
        train_modelnet.build_datasets(finish_args(args, "modelnet40",
                                                  "ModelNet40"))
        built = time.perf_counter() - t0
        job["fit"] = dict(argv=argv, logs=f"{tmp}/ranks")
        t0 = time.perf_counter()
        ranks = run_ranks(ranks_job, RANKS, {"device": str(dev),
                                             "cases": job},
                          timeout=RANKS_TIMEOUT, threads=0)
        spawn_s = time.perf_counter() - t0
        one_argv = argv + ["--epochs", str(FIT_EPOCHS), "--no_data_parallel"]
        with contextlib.redirect_stdout(io.StringIO()):
            one_fit, _ = train_modelnet.main(one_argv + ["--logdir",
                                                         f"{tmp}/one"])
            one_fit = state_bits(one_fit.model)
            fit_controls = []
            for i in range(CONTROLS):
                with reordered_points(train_modelnet, [seed, 31, i]):
                    ctrl, _ = train_modelnet.main(
                        one_argv + ["--logdir", f"{tmp}/control{i}"])
                fit_controls.append(state_bits(ctrl.model))
        fit_start = state_bits(train_modelnet.build_model(args).to(dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[ranks] {RANKS} gloo ranks on one card ran every multi-process "
          f"case in {spawn_s:.1f} s (host clock, spawn included; the "
          f"ModelNet fixture's datasets built before in {built:.1f} s)",
          flush=True)

    for tag in DP_CONFIGS:
        name = f"dp-{tag}"
        (l0, s0, t0_, c0), (l1, s1, t1_, _) = ranks[0][name], ranks[1][name]
        check(f"[dp-step] {tag}: the {RANKS} ranks bit-equal",
              l0 == l1 and bits_equal_states(s0, s1) == "",
              f"losses {l0} vs {l1}; first differing tensor: "
              f"{bits_equal_states(s0, s1) or 'none'}")
        one = ones[tag]
        loss1, times1 = one["loss"], one["times"]
        held_loss(f"[dp-step] {tag}: {RANKS} gloo ranks vs one process: loss",
                  l0, loss1, [c[0] for c in one["controls"]],
                  DP_BF16_LOSS_RTOL if tag == "bf16" else DP_LOSS_RTOL)
        held_update(f"[dp-step] {tag}: {RANKS} gloo ranks vs one process",
                    s0, one["bits"], one["start"],
                    [c[1] for c in one["controls"]])
        counts[name] = c0
        print(f"[dp-step] {tag}: B={B} ({B // RANKS} clouds a rank), N={N}, "
              f"K={K}: launches per data-parallel step on rank 0 of "
              f"{RANKS} gloo ranks: {c0}; device ms / host ms a step, rank 0 "
              f"{t0_[0]:.3f} / {t0_[1]:.3f}, rank 1 {t1_[0]:.3f} / "
              f"{t1_[1]:.3f} ({RANKS} gloo processes sharing the card) "
              f"against one process {times1[0]:.3f} / {times1[1]:.3f}; "
              f"card: {card}", flush=True)

    (l0, s0, h0, c0), (l1, s1, h1, _) = (ranks[0]["shard-seg"],
                                         ranks[1]["shard-seg"])
    check("[shard-train] segmentation: the ranks bit-equal",
          l0 == l1 and bits_equal_states(s0, s1) == "",
          f"losses {l0} vs {l1}")
    lone, sone, hone, _ = shard_seg_case(seed, dev, None, job["shard-seg"])
    again = shard_seg_case(seed, dev, None, job["shard-seg"], timed=False)
    check("[shard-train] segmentation: the one-process step twice",
          again[0] == lone and bits_equal_states(again[1], sone) == "",
          f"losses {lone} vs {again[0]}; first differing tensor: "
          f"{bits_equal_states(again[1], sone) or 'none'}")
    seg_start = state_bits(shard_seg_model(seed, dev))
    seg_controls = [shard_seg_case(
        seed, dev, None, job["shard-seg"], np.random.default_rng(
            [seed, 30, i]).permutation(SHARD_SEG_N), timed=False)[:2]
        for i in range(CONTROLS)]
    held_loss(f"[shard-train] segmentation, {RANKS} gloo ranks vs one "
              f"process: loss", l0, lone, [c[0] for c in seg_controls],
              DP_LOSS_RTOL)
    held_update(f"[shard-train] segmentation, {RANKS} gloo ranks vs one "
                f"process", s0, sone, seg_start, [c[1] for c in seg_controls])
    counts["shard-seg"] = c0
    print(f"[shard-train] ShapeNet recipe, one cloud of N={SHARD_SEG_N} "
          f"(f32, exact kNN, dropout 0.5): launches per point-sharded step "
          f"on rank 0 of {RANKS} gloo ranks: {c0}; host ms a step, rank 0 "
          f"{h0:.3f}, rank 1 {h1:.3f} ({RANKS} gloo processes sharing the "
          f"card) against {hone:.3f} in one process; card: {card}",
          flush=True)

    r0, r1 = ranks[0]["fit"], ranks[1]["fit"]
    held_update(f"[fit-dp] train_modelnet.main, {FIT_EPOCHS} epochs on "
                f"{RANKS} gloo ranks vs one process", r0["full"], one_fit,
                fit_start, fit_controls)
    check("[fit-dp] the ranks bit-equal",
          bits_equal_states(r0["full"], r1["full"]) == "",
          bits_equal_states(r0["full"], r1["full"]) or "every tensor")
    check("[fit-dp] a resume bit-equal to the uninterrupted run",
          bits_equal_states(r0["full"], r0["resumed"]) == "",
          bits_equal_states(r0["full"], r0["resumed"]) or "every tensor")
    check("[fit-dp] rank 0 alone writes checkpoints",
          len(r0["writes"]) > 0 and r1["writes"] == [],
          f"rank 0 wrote steps {r0['writes']}, rank 1 {r1['writes']}")
    return counts


def fit_phases(seed, dev, card):
    """The group "training loop and checkpoints": ``[knn-ties]``, then
    ``[fit-scanobjectnn]``, ``[fit-modelnet]``, ``[fit-shrec]``,
    ``[fit-shapenet]`` with ``[vote-shapenet]`` on its checkpoints,
    ``[fit-shapeseg]``, and ``[geometry-single]``; returns each phase's
    launch counts by its tag."""
    from deltaconv_tpu_torch.experiments import (train_modelnet,
                                                 train_scanobjectnn,
                                                 train_shapenet,
                                                 train_shrec)

    knn_ties_phase(seed, dev, card)
    out = {
        "fit-scanobjectnn": fit_phase("fit-scanobjectnn", train_scanobjectnn,
                                      write_scanobjectnn, seed, dev, card),
        "fit-modelnet": fit_phase("fit-modelnet", train_modelnet,
                                  write_modelnet, seed, dev, card),
        "fit-shrec": fit_phase("fit-shrec", train_shrec, write_shrec, seed,
                               dev, card, cold=False)}
    votes = {}

    def vote(args, base, ckpts):
        votes["vote-shapenet"] = vote_shapenet_phase(args, base, ckpts, card)

    out["fit-shapenet"] = fit_phase(
        "fit-shapenet", train_shapenet, write_shapenet, seed, dev, card,
        kernels=FIT_KERNELS_DEPTH2, edges="gather", cold=False, after=vote)
    out.update(votes)
    out["fit-shapeseg"] = fit_shapeseg_phase(seed, dev, card)
    out["geometry-single"] = geometry_single_phase(seed, dev, card)
    return out


# The rest of the JAX package (the port's last slice): bf16 gradients for
# positions and normals, the backbone's features / in_channels /
# centralize_first, DeltaConv's aggr, and the three experiments.
REST_TAG = 29  # the group's data: np.random.default_rng([seed, REST_TAG, i])
# [pos-grad-bf16]: one train-mode backward of the production bf16
# classifier (approximate kNN) in the positions and normals launches, as
# the f32 one, coef_cotangent once an apply (4 grads and 4 divs), wls_bwd
# once and no densify_bwd; the bf16 train maxes' kernels, the edge
# moments' adjacency (dense) or gather_sum (coefficient form, streaming),
# and the gather's scatter_rows besides.
POS_GRAD_BF16_PER_BACKWARD = {"coef_cotangent": 8, "densify_bwd": 0,
                              "wls_bwd": 1, "wls_bwd_direct": 0}
POS_GRAD_BF16_KERNELS = {
    True: ("knn_topk", "gather_rows", "wls", "densify_bf16", "adjacency",
           "gather_max_win_bf16", "gather_max_bwd_bf16",
           "gather_matmul_max_win", "scatter_rows", "inverse_adjacency"),
    False: ("knn_topk", "gather_rows", "wls", *COEF_KERNELS, "gather_sum",
            "gather_sum_bwd", "gather_max_win_bf16", "gather_max_bwd_bf16",
            "gather_matmul_max_win", "scatter_rows", "inverse_adjacency")}
# Kernels vs plain versions on one build, bf16: the forward is the same
# function but not the same bits (the matmul max's and the applies' f32
# sums in another order round a few bf16 values the other way), so
# neighbour-max winners flip at near-ties and move whole cotangents, as
# in the bf16 train steps: the loss is held at BF16_LOSS_RTOL, each
# gradient by its relative Frobenius deviation from the plain one, and
# its distance to the f32 gradient (the same weights through the
# kernels) at most BF16_F32_RATIO times the plain versions'.
POS_GRAD_BF16_FROB = 0.2  # measured up to 8.0e-2 on an H100 at 700 W
# [features]: 3 train steps, kernels vs plain versions.
FEATURE_STEPS = 3
# [aggr]: DeltaConv 64 -> 64 at B=32, N=1024, K=20. Kernels vs plain
# versions on the same operators: the forward is bit-equal (the gather
# and the counts are exact); the backward's scatter sums in another
# order, f32 within AGGR_REL x max, bf16 (the sums rounded to bf16, a few
# values one ulp apart) by the relative Frobenius deviation AGGR_FROB.
AGGR_C = 64
AGGR_REL = 1e-4
AGGR_FROB = 1e-2
AGGR_KERNELS = {True: ("gather_rows", "scatter_rows", "inverse_adjacency"),
                False: ("adjacency",)}


def pos_grad_bf16_once(batch, seed, dev, ops, precision, **config):
    """The loss and ``d loss / d pos``, ``d loss / d normal`` of a fresh
    train-mode classifier (dropout 0, batch statistics) through ``ops``
    (:func:`pos_grad_once` at ``precision``)."""
    model = random_model(seed, dev, dropout=0.0, affine=False,
                         precision=precision, **config).train()
    p = batch["pos"].clone().requires_grad_()
    q = batch["normal"].clone().requires_grad_()
    loss = torch.nn.functional.cross_entropy(
        model(p, q, batch.get("point_mask"), ops=ops), batch["label"])
    loss.backward()
    return float(loss.detach()), p.grad, q.grad


def frob(a, b) -> float:
    """Relative Frobenius deviation of ``a`` from ``b``."""
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)),
                                                 1e-300))


def pos_grad_bf16_phase(seed, dev, card, large=False):
    """``[pos-grad-bf16]``: the production classifier (bf16 compute and
    operators, approximate kNN, reference width, dropout 0) in train mode
    at B=32, N=1024, K=20, dense: ``pos`` and ``normal`` require grad, the
    cross entropy, ``backward()``. ``[pos-grad-bf16-large]`` (``large``):
    the coefficient form at B=4, N=8192. Held: the launches (per
    backward, and every kernel of the path), the kernels' gradients
    bit-equal across two calls, and kernels against the plain versions on
    the same build (the build's kernels with the plain VJPs of
    :func:`compare_pos_grads`, and the plain applies, maxes and sum): the
    loss, each gradient's relative Frobenius deviation and its distance to
    the f32 gradient (see POS_GRAD_BF16_FROB). Prints forward + backward
    device and host time and the peak memory, bf16 beside f32 on the same
    weights and clouds. Both sides run under :func:`deterministic_torch`,
    as ``[pos-grad]``'s."""
    from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS, launch_counts,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.ops import (densify_coefs_plain,
                                         gather_rows_plain)

    tag = "pos-grad-bf16-large" if large else "pos-grad-bf16"
    rng = np.random.default_rng([seed, REST_TAG, int(large)])
    b, n = (LARGE_B, LARGE_N) if large else (B, N)
    config = dict(knn_method="approx", dense_operators=not large)
    per = dict(POS_GRAD_BF16_PER_BACKWARD, **(COEF_PER_FORWARD if large
                                               else {}))
    batch = train_batch(rng, dev, [n] * b, n)
    print(f"[{tag}] {b} uniform clouds of {n} points, "
          f"{'coefficient form' if large else 'dense bf16 operators'}, "
          f"train mode", flush=True)
    reset_launch_counts()
    with deterministic_torch():
        lk, gpk, gnk = pos_grad_bf16_once(batch, seed, dev, KERNEL_OPS,
                                          "bfloat16", **config)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[{tag}] launches in one forward + backward: "
          f"{ {k: v for k, v in counts.items() if v} }")
    for name, want in per.items():
        check(f"[{tag}] {name} {want} a backward", counts[name] == want,
              f"{counts[name]} launches")
    for name in POS_GRAD_BF16_KERNELS[not large]:
        check(f"[{tag}] {name} launched", counts[name] > 0,
              f"{counts[name]} launches")
    check(f"[{tag}] gradients finite", bool(torch.isfinite(gpk).all())
          and bool(torch.isfinite(gnk).all()), "pos.grad and normal.grad")
    with deterministic_torch():
        lk2, gpk2, gnk2 = pos_grad_bf16_once(batch, seed, dev, KERNEL_OPS,
                                             "bfloat16", **config)
    check(f"[{tag}] two calls through the kernels", lk == lk2
          and torch.equal(gpk, gpk2) and torch.equal(gnk, gnk2),
          "loss and both gradients bit-equal")
    same = KERNEL_OPS._replace(
        gather_rows=gather_rows_plain, wls=_plain_vjp_wls(),
        densify_coefs=densify_coefs_plain, gather_max=PLAIN_OPS.gather_max,
        gather_sum=PLAIN_OPS.gather_sum,
        gather_matmul_max_train=PLAIN_OPS.gather_matmul_max_train,
        coef_apply_grad=PLAIN_OPS.coef_apply_grad,
        coef_apply_div=PLAIN_OPS.coef_apply_div,
        coef_cotangent=PLAIN_OPS.coef_cotangent)
    with deterministic_torch():
        lp, gpp, gnp = pos_grad_bf16_once(batch, seed, dev, same, "bfloat16",
                                          **config)
        lf, gpf, gnf = pos_grad_bf16_once(batch, seed, dev, KERNEL_OPS, None,
                                          **config)
    check(f"[{tag}] loss kernels vs plain", abs(lk - lp) <= BF16_LOSS_RTOL
          * abs(lp), f"{lk} vs {lp}, rel {abs(lk - lp) / abs(lp):.3e} <= "
          f"{BF16_LOSS_RTOL} (f32 loss {lf})")
    for what, gk, gp, gf in (("pos.grad", gpk, gpp, gpf),
                             ("normal.grad", gnk, gnp, gnf)):
        dev_kp, far_k, far_p = frob(gk, gp), frob(gk, gf), frob(gp, gf)
        check(f"[{tag}] {what} kernels vs plain", dev_kp <= POS_GRAD_BF16_FROB,
              f"relative Frobenius deviation {dev_kp:.3e} <= "
              f"{POS_GRAD_BF16_FROB}; elementwise {max_err(gk, gp) / max(float(gp.abs().max()), 1e-30):.3e} x max")
        check(f"[{tag}] {what} distance to the f32 gradient",
              far_k <= BF16_F32_RATIO * far_p,
              f"kernels {far_k:.3e}, plain {far_p:.3e}, ratio "
              f"{far_k / max(far_p, 1e-30):.3f} <= {BF16_F32_RATIO}")

    for precision in (None, "bfloat16"):
        model = random_model(seed, dev, dropout=0.0, affine=False,
                             precision=precision, **config).train()

        def step():
            p = batch["pos"].clone().requires_grad_()
            q = batch["normal"].clone().requires_grad_()
            torch.nn.functional.cross_entropy(
                model(p, q), batch["label"]).backward()
            model.zero_grad(set_to_none=True)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(POS_GRAD_CALLS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        t = float(np.median(times)) * 1e3
        print(f"[{tag}] {precision or 'float32'}: train-mode forward + "
              f"backward in the positions and normals of {b} clouds (N={n},"
              f" K={K}, reference width, approximate kNN): median "
              f"{t:.3f} ms (host clock, synchronised), {device_ms(step):.3f}"
              f" ms of device time (profiler), peak {peak:.3f} GiB; card: "
              f"{card}", flush=True)
    total, ours = profile(tag, "one bf16 train-mode forward + backward", step,
                          t)
    # The backward's kernels by the names of their CUDA functions.
    for name, fn in (("coef_cotangent", "cotangent_"),
                     ("wls_bwd", "wls_split_bwd_kernel"),
                     ("scatter_rows", "scatter_rows_kernel"),
                     ("inverse_adjacency", "inverse_adjacency_kernel")):
        us = sum(r[0] for r in ours if f"::{fn}" in r[2])
        print(f"[{tag}] {name}: {us / 1e3:.4f} ms in one bf16 forward + "
              f"backward ({counts[name]} launches), {us / max(total, 1e-9):.4f}"
              f" of its device time")
    return counts


def features_phase(seed, dev, card):
    """``[features]``: the reference classifier (B=32, N=1024, K=20,
    dropout 0) with ``in_channels=6`` on features = positions | normals,
    and with ``centralize_first=False`` on the positions, in f32 (exact
    kNN) and bf16 (bf16 compute and operators, approximate kNN): an eval
    forward, then FEATURE_STEPS ``make_train_step`` steps through the
    kernels, each step also taken from the same weights and optimizer
    state through the plain versions (the build's kernels on both sides;
    the maxes, sums, gathers and applies plain): the eval logits at
    LOGIT_ATOL (f32) or BF16_PATH_REL x max|logit| (bf16), each step's
    loss at LOSS_RTOL (f32) or BF16_LOSS_RTOL (bf16), the parameters
    after it at PARAM_RTOL x max (f32) or by BF16_PARAM_FROB (bf16), the
    running statistics at STATS_RTOL or BF16_STATS_RTOL x max. (A bf16
    trajectory of its own through the plain versions parts from the
    kernels' by the order of f32 sums, amplified each step at lr 0.1:
    its loss read 1.7e-3 apart at step 2 on an H100 at 700 W.) Each
    variant's launches counted from 0 over its kernel route; the first
    conv's width and centralization checked."""
    from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS, launch_counts,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_eval_step,
                                              make_train_step, sgd_momentum)

    rng = np.random.default_rng([seed, REST_TAG, 2])
    batch = train_batch(rng, dev, [N] * B, N)
    feats = torch.cat([batch["pos"], batch["normal"]], dim=-1)
    plain = KERNEL_OPS._replace(
        gather_max=PLAIN_OPS.gather_max, gather_sum=PLAIN_OPS.gather_sum,
        gather_rows=PLAIN_OPS.gather_rows,
        gather_matmul_max_train=PLAIN_OPS.gather_matmul_max_train,
        gather_max_affine=PLAIN_OPS.gather_max_affine,
        gather_matmul_max=PLAIN_OPS.gather_matmul_max)
    out = {}
    for variant, arch, data in (
            ("in_channels=6", dict(in_channels=6), dict(batch, features=feats)),
            ("centralize_first=False", dict(centralize_first=False), batch)):
        for precision in (None, "bfloat16"):
            label = f"[features] {variant}, {precision or 'float32'}"
            config = dict(arch, precision=precision,
                          knn_method="approx" if precision else "exact")
            models = {r: random_model(seed, dev, dropout=0.0, affine=False,
                                      **config) for r in ("kernels", "plain")}
            mk, mp = models["kernels"], models["plain"]
            conv0 = mk.deltanet_base.convs[0]
            check(f"{label} conv0", conv0.s_mlp[0][0].in_features
                  == 4 * arch.get("in_channels", 3) and conv0.centralized
                  == arch.get("centralize_first", True),
                  f"s_mlp in {conv0.s_mlp[0][0].in_features}, centralized "
                  f"{conv0.centralized}")
            reset_launch_counts()
            lk = make_eval_step(mk)(None, data).float().cpu().numpy()
            torch.cuda.synchronize()
            counts = launch_counts()
            lp = make_eval_step(mp, ops=plain)(
                None, data).float().cpu().numpy()
            if precision:
                held_to(f"{label} eval logits kernels vs plain", lk, lp,
                        BF16_PATH_REL)
            else:
                err = float(np.abs(lk - lp).max())
                check(f"{label} eval logits kernels vs plain",
                      err <= LOGIT_ATOL, f"max_abs_err {err} <= {LOGIT_ATOL}")
            sk = create_train_state(mk, sgd_momentum(TRAIN_LR))
            sp = create_train_state(mp, sgd_momentum(TRAIN_LR))
            step_k = make_train_step(mk)
            step_p = make_train_step(mp, ops=plain)
            losses = []
            for i in range(FEATURE_STEPS):
                mp.load_state_dict(mk.state_dict())
                # A copy: the loaded state would share the momentum
                # buffers, which the kernels' step then updates in place.
                sp.optimizer.load_state_dict(deepcopy(
                    sk.optimizer.state_dict()))
                reset_launch_counts()
                a = float(step_k(sk, data, None)["loss"])
                torch.cuda.synchronize()
                counts = {k: counts[k] + v for k, v in launch_counts().items()}
                b_ = float(step_p(sp, data, None)["loss"])
                losses.append(a)
                rtol = BF16_LOSS_RTOL if precision else LOSS_RTOL
                check(f"{label} step {i} loss kernels vs plain",
                      np.isfinite(a) and abs(a - b_) <= rtol * abs(b_),
                      f"{a} vs {b_}, rel {abs(a - b_) / abs(b_):.3e} <= "
                      f"{rtol}")
                stats_p = dict(mp.named_buffers())
                worst = max((max_err(s, stats_p[k]) / max(float(
                    stats_p[k].abs().max()), 1e-30), k)
                    for k, s in mk.named_buffers())
                tol = BF16_STATS_RTOL if precision else STATS_RTOL
                check(f"{label} step {i} stats kernels vs plain",
                      worst[0] <= tol,
                      f"worst {worst[0]:.3e} x max ({worst[1]}) <= {tol}")
                devs = _deviations(mk, mp)["param"]
                if precision:
                    check(f"{label} step {i} params kernels vs plain",
                          devs[0] <= BF16_PARAM_FROB,
                          f"relative Frobenius deviation over all tensors "
                          f"{devs[0]:.3e} <= {BF16_PARAM_FROB}")
                else:
                    check(f"{label} step {i} params kernels vs plain",
                          devs[2][0] <= PARAM_RTOL,
                          f"worst {devs[2][0]:.3e} x max ({devs[2][1]}) <= "
                          f"{PARAM_RTOL}")
            out[f"{variant}, {precision}"] = counts
            print(f"{label}: launches in the eval forward and "
                  f"{FEATURE_STEPS} steps: "
                  f"{ {k: v for k, v in counts.items() if v} }")
            path = TRAIN_BF16_KERNELS if precision else TRAIN_KERNELS
            # The edge moments' counts belong to the centralized conv0.
            for name in (k for k in path if conv0.centralized
                         or k != "adjacency"):
                check(f"{label} {name} launched", counts[name] > 0,
                      f"{counts[name]} launches")
            print(f"{label}: losses {[round(x, 5) for x in losses]}; card: "
                  f"{card}", flush=True)
    return out


def aggr_phase(seed, dev, card):
    """``[aggr]``: one train-mode ``DeltaConv`` 64 -> 64 at B=32, N=1024,
    K=20 with ``aggr`` "mean" and "sum", centralized (the edge rows
    through ``gather_rows``, backward ``scatter_rows``) and not (the
    neighbour sum: at this size its differentiated route is the
    ``adjacency`` counts and their products, the streaming
    ``gather_sum``/``gather_sum_bwd`` above 256 MB of counts), f32 and
    bf16 (bf16 operators and compute), on the operators of 32 clouds:
    forward and backward (the parameters' and both inputs' gradients of
    a random projection of the outputs) through the kernels against the
    plain versions on the same operators (AGGR_REL, AGGR_FROB); each
    variant's launches from 0; the forward's device time."""
    from deltaconv_tpu_torch import (PLAIN_OPS, launch_counts,
                                     reset_launch_counts)
    from deltaconv_tpu_torch.models import build_operators
    from deltaconv_tpu_torch.nn import DeltaConv

    rng = np.random.default_rng([seed, REST_TAG, 3])
    batch = train_batch(rng, dev, [N] * B, N)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn((B, N, AGGR_C), generator=gen, device=dev)
    v0 = torch.randn((B, N, 2, AGGR_C), generator=gen, device=dev)
    ct_x = torch.randn((B, N, AGGR_C), generator=gen, device=dev)
    ct_v = torch.randn((B, N, 2, AGGR_C), generator=gen, device=dev)
    out = {}
    for precision in (None, torch.bfloat16):
        gd = build_operators(batch["pos"], K, batch["normal"],
                             operator_dtype=precision)
        routes = {"kernels": gd,
                  "plain": dataclasses.replace(gd, ops=PLAIN_OPS)}
        for centralized in (True, False):
            for aggr in ("mean", "sum"):
                label = (f"[aggr] {aggr}, {'centralized' if centralized else 'per point'},"
                         f" {'bf16' if precision else 'f32'}")
                conv = DeltaConv(AGGR_C, AGGR_C, centralized=centralized,
                                 aggr=aggr, dtype=precision,
                                 ).to(dev).train()
                state = {k: v.clone() for k, v in conv.state_dict().items()}
                res = {}
                for route, g in routes.items():
                    conv.load_state_dict(state)
                    conv.zero_grad(set_to_none=True)
                    x = x0.to(precision or torch.float32).clone()
                    v = v0.to(precision or torch.float32).clone()
                    x.requires_grad_()
                    v.requires_grad_()
                    if route == "kernels":
                        reset_launch_counts()
                    xo, vo = conv(x, v, g)
                    ((xo.float() * ct_x).sum()
                     + (vo.float() * ct_v).sum()).backward()
                    if route == "kernels":
                        torch.cuda.synchronize()
                        out[label] = launch_counts()
                    res[route] = [xo, vo, x.grad, v.grad] + [
                        p.grad.clone() for p in conv.parameters()]
                counts = out[label]
                print(f"{label}: launches in one forward + backward: "
                      f"{ {k: v for k, v in counts.items() if v} }")
                for name in AGGR_KERNELS[centralized]:
                    check(f"{label} {name} launched", counts[name] > 0,
                          f"{counts[name]} launches")
                k_, p_ = res["kernels"], res["plain"]
                check(f"{label} forward kernels vs plain",
                      torch.equal(k_[0], p_[0]) and torch.equal(k_[1], p_[1]),
                      "x' and v' bit-equal")
                if precision:
                    worst = max(frob(a, b_) for a, b_ in zip(k_[2:], p_[2:]))
                    check(f"{label} gradients kernels vs plain",
                          worst <= AGGR_FROB,
                          f"worst relative Frobenius deviation {worst:.3e} "
                          f"<= {AGGR_FROB}")
                else:
                    worst = max(max_err(a, b_) / max(float(b_.abs().max()),
                                                     1e-30)
                                for a, b_ in zip(k_[2:], p_[2:]))
                    check(f"{label} gradients kernels vs plain",
                          worst <= AGGR_REL,
                          f"worst {worst:.3e} x max <= {AGGR_REL}")
                x = x0.to(precision or torch.float32)
                v = v0.to(precision or torch.float32)
                with torch.no_grad():
                    ms = device_ms(lambda: conv(x, v, gd))
                print(f"{label}: train-mode forward {ms:.4f} ms of device "
                      f"time; card: {card}", flush=True)
    return out


def study_phase(card):
    """``[study]``: the anisotropic-diffusion study
    (``experiments.anisotropic_diffusion.run_study.main``) at the
    notebook's settings (20 Perona-Malik steps of the 128 x 128 test
    image, 200 Adam iterations, width 16, 16 layers) on the card: each
    architecture's final L1 (finite) and the seconds it took."""
    from deltaconv_tpu_torch.experiments.anisotropic_diffusion import \
        run_study

    t0 = time.perf_counter()
    results = run_study.main(["--device", "cuda"])
    took = time.perf_counter() - t0
    for name, l1 in results:
        check(f"[study] {name} final L1 finite", bool(np.isfinite(l1)),
              f"{l1:.6f}")
    print(f"[study] final L1: " + ", ".join(
        f"{name} {l1:.6f}" for name, l1 in results)
        + f"; {took:.1f} s for the six networks; card: {card}", flush=True)


def convergence_phase(card):
    """``[convergence]``: ``experiments.synthetic_convergence`` at its
    defaults on the card (the reference classifier on 64 synthetic
    training clouds of 128 points, 60 epochs unless the held-out accuracy
    reaches 0.99): the final JSON line, the mean training loss of the
    last epoch below the first's and the best held-out accuracy above
    chance (0.25)."""
    import tempfile

    from deltaconv_tpu_torch.experiments import synthetic_convergence

    with tempfile.TemporaryDirectory() as logdir:
        args = synthetic_convergence.build_args(["--logdir", logdir])
        t0 = time.perf_counter()
        best, hit, _ = synthetic_convergence.run(args)
        took = time.perf_counter() - t0
        rows = [json.loads(line) for line in
                (Path(logdir) / "metrics.jsonl").read_text().splitlines()]
    loss = [r["value"] for r in rows if r["tag"] == "training loss"]
    check("[convergence] the training loss falls", loss[-1] < loss[0],
          f"{loss[0]:.4f} -> {loss[-1]:.4f} over {len(loss)} epochs")
    check("[convergence] held-out accuracy above chance", best > 0.25,
          f"best {best:.4f}, target reached at epoch {hit}")
    print(f"[convergence] {len(loss)} epochs in {took:.1f} s; card: {card}",
          flush=True)


def rehearsal_phase(card):
    """``[rehearsal]``: ``experiments.offline_rehearsal`` on the card: a
    ModelNet10 fixture and a release-layout ``.pt`` evaluated by
    ``train_modelnet.main(["--checkpoint", ...])``, a ShapeNet fixture by
    ``test_shapenet``'s 2-vote evaluation; exit 0."""
    from deltaconv_tpu_torch.experiments import offline_rehearsal

    t0 = time.perf_counter()
    rc = offline_rehearsal.main(["--device", "cuda"])
    check("[rehearsal] offline rehearsal", rc == 0,
          f"exit {rc} in {time.perf_counter() - t0:.1f} s; card: {card}")


def rest_counts(rest):
    """``(label, launch counts)`` of every counted run of
    :func:`rest_phases`: a phase's own, or each variant's of
    ``[features]`` and ``[aggr]``."""
    out = []
    for tag, counts in rest.items():
        if counts is None:
            continue
        if "wls" in counts:
            out.append((tag, counts))
        else:
            out.extend((f"{tag} {label}", c) for label, c in counts.items())
    return out


def rest_phases(seed, dev, card):
    """The group "the rest of the JAX package": ``[pos-grad-bf16]``,
    ``[pos-grad-bf16-large]``, ``[features]``, ``[aggr]``, ``[study]``,
    ``[convergence]``, ``[rehearsal]``; returns each phase's launch counts
    by its tag (the experiments' are not counted) and prints each
    phase's seconds."""
    out, took = {}, []
    for tag, fn in (
            ("pos-grad-bf16", lambda: pos_grad_bf16_phase(seed, dev, card)),
            ("pos-grad-bf16-large",
             lambda: pos_grad_bf16_phase(seed, dev, card, large=True)),
            ("features", lambda: features_phase(seed, dev, card)),
            ("aggr", lambda: aggr_phase(seed, dev, card)),
            ("study", lambda: study_phase(card)),
            ("convergence", lambda: convergence_phase(card)),
            ("rehearsal", lambda: rehearsal_phase(card))):
        t0 = time.perf_counter()
        out[tag] = fn()
        took.append(f"{tag} {time.perf_counter() - t0:.1f}")
    print("[rest] seconds per phase: " + ", ".join(took), flush=True)
    return out


def compare_phases(seed, dev, card):
    """The phases that time one tree against another in one call: the
    coefficient applies (:func:`coef_apply_table`), the redesigned
    kernels (:func:`kernel_times`) and the paths' device times
    (:func:`path_device_times`)."""
    coef_apply_table(seed, dev, card)
    kernel_times(seed, dev, card)
    path_device_times(seed, dev, card)


def parent_phase(parent, seed, card):
    """``[parent]``: :func:`compare_phases` on the checkout at ``parent``
    (this script copied into its root as ``chip_smoke_this.py``, which
    imports that checkout's package and builds its kernels) and on this
    tree, in turns: parent, this, this, parent; each run is a process of
    its own (``--phase compare``), so both sides start from the same
    state; the lines are printed with ``parent`` or ``this`` in front."""
    copy = Path(parent).resolve() / "chip_smoke_this.py"
    shutil.copy(Path(__file__).resolve(), copy)

    def run(tag, script):
        torch.cuda.empty_cache()
        out = subprocess.run(
            [sys.executable, str(script), "--phase", "compare", "--seed",
             str(seed)], capture_output=True, text=True, timeout=900)
        check(f"[parent] {tag} tree's phases", out.returncode == 0,
              f"exit {out.returncode}{out.stderr[-2000:]}")
        for line in out.stdout.splitlines():
            if line.startswith(("[coef-applies]", "[kernel-times]",
                                "[device-times]")):
                print(f"{tag} {line}", flush=True)

    print(f"[parent] {parent}: parent, this tree, this tree, parent; card: "
          f"{card}", flush=True)
    for tag, script in (("parent", copy), ("this", Path(__file__).resolve()),
                        ("this", Path(__file__).resolve()), ("parent", copy)):
        run(tag, script)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", default=None,
                        help="root of another checkout (the parent commit) "
                        "to time in turns with this tree at the end")
    parser.add_argument("--phase", choices=("compare", "fit", "ranks",
                                            "rest"),
                        default=None,
                        help="run only these phases (no record): the "
                        "timed comparisons, the training loop and "
                        "checkpoints group, training across ranks, or the "
                        "rest of the JAX package")
    parser.add_argument("--cold-serve", default=None, metavar="JSON",
                        help="(used by [fit-*]) serve a run's checkpoint "
                        "in this fresh process and print its times")
    args = parser.parse_args()
    if args.cold_serve is not None:
        cold_serve(json.loads(args.cold_serve))
        return

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA card")
    from deltaconv_tpu_torch import ops

    if args.phase is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ops.library()
        phases = {"compare": compare_phases, "fit": fit_phases,
                  "ranks": ranks_phases, "rest": rest_phases}[args.phase]
        phases(args.seed, torch.device("cuda", 0), card_line())
        return

    # Strict f32 everywhere: TF32 would reorder kNN neighbours and move
    # the logits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    ops.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    marks = [("build", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    res = kernel_phase(rng, dev, card)
    check_rows_shapes(res, rng.spawn(1)[0], dev)
    knn_k10_phase(res, args.seed, dev, card)
    mark("kernels")
    serve = serve_phase(rng, args.seed, dev, card)
    clouds = serving_clouds(rng)  # the same for bf16 and int8 serving
    serve_bf16 = serve_lowp_phase(clouds, args.seed, dev, card, "bfloat16")
    serve_int8 = serve_lowp_phase(clouds, args.seed, dev, card, "int8")
    apply_times(clouds, dev, card)
    conv3_forms(dev, card)
    mark("serving")
    path_device_times(args.seed, dev, card)
    mark("device times")
    train, stream = train_phase(rng, args.seed, dev, card)
    train_bf16 = train_bf16_phase(rng, args.seed, dev, card)
    mark("training")
    seg = serve_seg_phase(rng, args.seed, dev, card, None)
    seg_bf16 = serve_seg_phase(rng, args.seed, dev, card, "bfloat16")
    seg_int8 = serve_seg_phase(rng, args.seed, dev, card, "int8")
    conv2_seg_forms(dev, card)
    mark("segmentation serving")
    large = large_clouds(rng)
    serve_large = serve_large_phase(large, args.seed, dev, card, "bfloat16")
    serve_large_f32 = serve_large_phase(large, args.seed, dev, card, None)
    coef_vs_dense_phase(clouds, args.seed, dev, card)
    train_large = train_large_phase(rng, args.seed, dev, card)
    mark("large clouds")
    shard_bf16 = serve_shard_phase(rng, args.seed, dev, card, "bfloat16")
    shard_f32 = serve_shard_phase(rng, args.seed, dev, card, None)
    shard_seg = serve_shard_seg_phase(rng, args.seed, dev, card, None)
    shard_seg_bf16 = serve_shard_seg_phase(rng, args.seed, dev, card,
                                           "bfloat16")
    shard_nccl_phase(rng, args.seed, dev)
    mark("point sharding")
    seg_train = train_seg_bf16_phase(rng, args.seed, dev, card)
    seg_train_f32 = train_seg_f32_phase(rng, args.seed, dev, card)
    mark("segmentation training")
    pos_grad = pos_grad_phase(rng, args.seed, dev, card)
    pos_grad_phase(rng, args.seed, dev, card, large=True)
    densify_vjp = densify_vjp_phase(rng, dev)
    mark("positions' gradients")
    fused_build = serve_fused_build_phase(clouds, args.seed, dev, card)
    mark("fused eval build")
    minmax = nbr_minmax_phase(rng, dev, card)
    mark("min/max hooks")
    rounds = knn_rounds_phase(rng, dev)
    mark("kNN rounds route")
    kfold = matmul_kfold_phase(rng, dev)
    mark("matmul max K-fold route")
    direct = max_direct_phase(rng, dev)
    mark("neighbour max route D")
    wls_direct = wls_direct_phase(rng, dev)
    mark("WLS direct route")
    fps_phase(args.seed, card)
    no_normals = serve_no_normals_phase(args.seed, dev, card, None)
    no_normals_bf16 = serve_no_normals_phase(args.seed, dev, card,
                                             "bfloat16")
    vote = vote_phase(args.seed, dev, card)
    train_no_normals = train_no_normals_phase(args.seed, dev, card)
    shard_no_normals = shard_no_normals_phase(args.seed, dev, card)
    mark("clouds without normals")
    fits = fit_phases(args.seed, dev, card)
    mark("training loop, checkpoints and CLIs")
    ranks_phases(args.seed, dev, card)
    mark("training across ranks")
    rest = rest_phases(args.seed, dev, card)
    mark("the rest of the JAX package")
    if args.parent:
        parent_phase(args.parent, args.seed, card)
        mark("parent tree")
    print("[time] seconds per group of phases: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))
    for label, counts in (
            ("serve", serve), ("serve-bf16", serve_bf16),
            ("serve-int8", serve_int8), ("train", train),
            ("train streaming", stream), ("train-bf16", train_bf16),
            ("serve-seg", seg), ("serve-seg-bf16", seg_bf16),
            ("serve-seg-int8", seg_int8), ("serve-large-bf16", serve_large),
            ("serve-large-f32", serve_large_f32),
            ("train-large", train_large), ("serve-shard-bf16", shard_bf16),
            ("serve-shard-f32", shard_f32), ("serve-shard-seg-f32", shard_seg),
            ("serve-shard-seg-bf16", shard_seg_bf16),
            ("train-seg-bf16", seg_train), ("train-seg-f32", seg_train_f32),
            ("pos-grad", pos_grad), ("serve-fused-build", fused_build),
            ("serve-no-normals", no_normals),
            ("serve-no-normals-bf16", no_normals_bf16), ("vote", vote),
            ("train-no-normals", train_no_normals),
            ("shard-no-normals", shard_no_normals), *fits.items(),
            *rest_counts(rest)):
        check(f"[{label}] the WLS and fused-build direct routes and the "
              f"sum's route D never",
              counts["wls_direct"] == 0 and counts["wls_bwd_direct"] == 0
              and counts["fused_gather_wls_direct"] == 0
              and counts["gather_sum_direct"] == 0,
              f"wls_direct {counts['wls_direct']}, wls_bwd_direct "
              f"{counts['wls_bwd_direct']}, fused_gather_wls_direct "
              f"{counts['fused_gather_wls_direct']}, gather_sum_direct "
              f"{counts['gather_sum_direct']}")

    def launches(name):
        for path, counts in ((SERVE_KERNELS, serve),
                             (BF16_KERNELS, serve_bf16),
                             (TRAIN_KERNELS, train),
                             (STREAM_KERNELS, stream),
                             (TRAIN_BF16_KERNELS, train_bf16),
                             (SEG_KERNELS, seg),
                             (SEG_BF16_KERNELS, seg_bf16),
                             (INT8_KERNELS, serve_int8),
                             (SEG_INT8_KERNELS, seg_int8),
                             (LARGE_KERNELS["bfloat16"], serve_large),
                             (LARGE_KERNELS[None], serve_large_f32),
                             (TRAIN_LARGE_KERNELS, train_large),
                             (SHARD_BF16_KERNELS, shard_bf16),
                             (SHARD_F32_KERNELS, shard_f32),
                             (("knn_topk_table",), shard_seg),
                             (("knn_topk_table_q",), shard_seg_bf16),
                             (SEG_TRAIN_KERNELS, seg_train),
                             (SEG_TRAIN_F32_KERNELS, seg_train_f32),
                             (("wls_bwd", "coef_cotangent"), pos_grad),
                             (("densify_bwd",), densify_vjp),
                             (("knn_topk_mean_dist", "fused_gather_wls"),
                              fused_build),
                             (MINMAX_KERNELS, minmax),
                             (("knn_topk_rounds",), rounds),
                             (("gather_matmul_max_kfold",
                               "gather_matmul_max_win_kfold",
                               "gather_matmul_max_int8_kfold",
                               "gather_matmul_minmax_kfold"), kfold),
                             (MAX_DIRECT_KERNELS, direct),
                             (("wls_direct", "wls_bwd_direct",
                               "fused_gather_wls_direct"), wls_direct)):
            if name in path:
                return counts[name]
        raise KeyError(name)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches(name),
         "max_abs_err": res[name]["max_abs_err"],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound"][0],
         "bound_by": res[name]["bound"][1],
         "library_ms": res[name]["library_ms"]}
        for name, (src, rep) in KERNEL_META.items()]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
